// ELL SIR-aggregation kernels for Hopper (sm_90a), with a plain C interface
// bound from Python through ctypes (sir_gcn_tpu_torch/ops/cuda/kernels.py).
//
// A plan lays the incoming edges of each key out as a contiguous run of
// slots: row r owns slots [row_ptr[r], row_ptr[r+1]) and reads its key's
// row through row_key[r]. Each kernel walks every row of every bucket of a
// plan in one launch and gathers node rows by index itself, so no [S, H]
// slot table is ever written.
//
//   ell_act_reduce   rows[r]  = sum_s scale[s] * act(eq[row_key[r]] + ek[slot_src[s]])
//   ell_act_reduce2  the same, plus srows[r] = sum_s scale[s] * act'(z)
//   ell_src_bwd      out[r]   = sum_s act'(eq[slot_dst[s]] + ek[row_key[r]])
//                                     * scale[s] * g[slot_dst[s]]
//
// The edge-term forms (``*_edge``) add an edge table e [E_pad, H] in
// sorted-edge order, read by index through the plan's slot_edge: the
// key-side value of a forward slot is ek[slot_src[s]] + e[slot_edge[s]], the
// dst-side value of a backward slot eq[slot_dst[s]] + e[slot_edge[s]], each
// added in f32 and rounded to the edge type (add_cast). ell_src_bwd_edge
// also writes each slot's g_z (rounded to the edge type, stored in f32) into
// row slot_edge[s] of the per-edge cotangent g_e; each valid edge has one src
// slot, so no two slots write one row, and the wrapper zeroes the rows that
// no slot writes (padding edges, zero-scale slots).
//
// They replace the Pallas kernels bucket_bcast_act_reduce (#1),
// bucket_bcast_act_reduce2 (#2) and bucket_src_bwd (#4; with its per-slot
// g_z output in the edge-term form, followed by the take of _edge_cotangent)
// of sir_gcn_tpu/ops/pallas/kernels.py and sir_gcn_tpu/ops/ell.py.
//
// Bound: device-memory bytes at 3.35 TB/s; a few flops per gathered value
// are far below the card's f32 rate. Counted once, the node tables, index
// streams and outputs of the ogbn-arxiv plan (H = 96, bf16 edges, 2.65M
// slots) are 185 MB for #1, 250 MB for #2 and 218 MB for #4. The rows the
// slots gather are far more: 192 bytes a slot, 510 MB, for #1 and #2, and
// twice that for #4. #1 and #2 gather from ek, 32.5 MB, which the 50 MB L2
// can hold; #4 gathers from eq and g, 65 MB together, which it cannot. A
// random gather of whole rows from HBM runs near HBM's rate (3.1 TB/s in
// sir_gcn_tpu_torch/tools/gather_dma.py with a 174 MB table), so #4's rows
// would take 0.33 ms if all came from there. With the rows in L2, the work
// in the SM is the limit: a slot costs its gathers, the widening to f32 and
// five f32 operations a value, and at C = 12 a quarter of the lanes idle.
//
// Design, the vector path (H * sizeof(T) a multiple of 16 and every table
// 16-byte aligned): a row of H values of T is C = H * sizeof(T) / 16 chunks
// of 16 bytes (12 at H = 96 in bf16). Warp w of the W resident ones takes
// rows w, w + W, ... (a persistent grid), and loads the next row's slot
// range and first 32 slot indices and scales while it works on this one, so
// a row waits only on its own gathers. Its lanes form G = 32 / C groups of
// C lanes (wider rows take passes of 32 chunks); lane (g, c) holds chunk c.
// The indices and scales, read 32 at a time with one coalesced load, pass
// round by shuffles; group g takes slots g, g + G, ... of them and issues
// kInflight 16-byte gathers before it uses any, so G * kInflight rows are
// in flight a warp (16 for #4 at arxiv, 8 for #1 and #2). Each lane sums
// its slots in slot order in f32; at the end of the row the groups' sums
// are added in group order by shuffles, and group 0 writes the row with
// 16-byte stores (#4-edge each slot's g_z the same way). The once-per-row
// f32 operand is read as 16-byte chunks. The order of every sum is fixed by
// the layout, so a launch gives bitwise the same output every time (no
// atomics). At C = 12, 8 lanes of 32 are idle.
//
// The scalar path (any H, any alignment) is the first design: one warp per
// row, lane l keeping features f0 + 32 j + l in registers and walking the
// row's slots one at a time with 2- or 4-byte loads. The entry chooses the
// path from H and the pointers; ell_layout reports the choice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxFeatPerLane = 4;
constexpr unsigned kFull = 0xffffffffu;
// 16-byte gathers a lane issues before it uses any: the forward kernels,
// the backward and the backward with an edge term (whose three gathers a
// slot need the registers of three)
constexpr int kInflightFwd = 4;
constexpr int kInflightBwd = 8;
constexpr int kInflightBwdEdge = 4;

// Activation ids, as registered in sir_gcn_tpu_torch/ops/ell.py.
enum { ACT_LEAKY_RELU = 0, ACT_TANH = 1, ACT_GELU = 4 };

// False for every id: the static_assert of an activation id that has no
// branch in act_fn, act_grad or act_both fails the build.
template <int ACT>
constexpr bool kNoBranch = false;

// erf-GELU as jax.nn.gelu(approximate=False) computes it, z * Phi(z) with
// Phi(z) = 0.5 * erfc(-z / sqrt(2)) (no cancellation for z << 0), and
// gelu'(z) = Phi(z) + z * exp(-z^2 / 2) / sqrt(2 pi).
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float gelu_cdf(float z) {
  return 0.5f * erfcf(-z * kSqrtHalf);
}

__device__ __forceinline__ float gelu_pdf_term(float z) {
  return z * (expf(-0.5f * z * z) * kInvSqrt2Pi);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and widened back: bf16 rounds to nearest even, as
// astype(bf16) does.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// a + b added in f32 and carried in T (ell.py's add_cast).
template <typename T>
__device__ __forceinline__ float add_cast(T a, T b) {
  return round_to<T>(to_f32(a) + to_f32(b));
}

template <int ACT>
__device__ __forceinline__ float act_fn(float z, float slope) {
  if constexpr (ACT == ACT_LEAKY_RELU) {
    return z >= 0.f ? z : slope * z;
  } else if constexpr (ACT == ACT_TANH) {
    return tanhf(z);
  } else if constexpr (ACT == ACT_GELU) {
    return z * gelu_cdf(z);
  } else {
    static_assert(kNoBranch<ACT>, "an activation id without a branch");
    return 0.f;
  }
}

// act'(z); leaky_relu'(0) = 1, matching where(z >= 0, z, slope * z).
template <int ACT>
__device__ __forceinline__ float act_grad(float z, float slope) {
  if constexpr (ACT == ACT_LEAKY_RELU) {
    return z >= 0.f ? 1.f : slope;
  } else if constexpr (ACT == ACT_TANH) {
    const float t = tanhf(z);
    return (1.f + t) * (1.f - t);
  } else if constexpr (ACT == ACT_GELU) {
    return gelu_cdf(z) + gelu_pdf_term(z);
  } else {
    static_assert(kNoBranch<ACT>, "an activation id without a branch");
    return 0.f;
  }
}

// act(z) and act'(z) together: tanh evaluated once, GELU's erfc and exp
// once each; leaky_relu(z) as z * act'(z), which rounds as slope * z does.
template <int ACT>
__device__ __forceinline__ void act_both(float z, float slope, float& a,
                                         float& d) {
  if constexpr (ACT == ACT_LEAKY_RELU) {
    d = act_grad<ACT>(z, slope);
    a = z * d;
  } else if constexpr (ACT == ACT_TANH) {
    a = tanhf(z);
    d = (1.f + a) * (1.f - a);
  } else if constexpr (ACT == ACT_GELU) {
    const float cdf = gelu_cdf(z);
    a = z * cdf;
    d = cdf + gelu_pdf_term(z);
  } else {
    static_assert(kNoBranch<ACT>, "an activation id without a branch");
  }
}

// ---------------------------------------------------------------------
// The scalar path
// ---------------------------------------------------------------------

template <int ACT, bool EMIT_S, bool EDGE, int NF, typename TK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
act_reduce_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
                  const TK* __restrict__ e, const int* __restrict__ slot_src,
                  const int* __restrict__ slot_edge,
                  const float* __restrict__ scale,
                  const int* __restrict__ row_key,
                  const int* __restrict__ row_ptr, int R, int H, float slope,
                  float* __restrict__ rows, float* __restrict__ srows) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp leaves together
  const int s0 = row_ptr[r];
  const int s1 = row_ptr[r + 1];
  const float* eq_row = eq + (int64_t)row_key[r] * H;
  for (int f0 = 0; f0 < H; f0 += 32 * NF) {
    float q[NF], acc[NF], sacc[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + j * 32 + lane;
      q[j] = f < H ? eq_row[f] : 0.f;
      acc[j] = 0.f;
      sacc[j] = 0.f;
    }
    for (int base = s0; base < s1; base += 32) {
      const int mine = base + lane;
      const int my_src = mine < s1 ? slot_src[mine] : 0;
      const int my_edge = EDGE && mine < s1 ? slot_edge[mine] : 0;
      const float my_sc = mine < s1 ? scale[mine] : 0.f;
      const int n = min(32, s1 - base);
      for (int k = 0; k < n; ++k) {
        const int src = __shfl_sync(kFull, my_src, k);
        const int edge = EDGE ? __shfl_sync(kFull, my_edge, k) : 0;
        const float sc = __shfl_sync(kFull, my_sc, k);
        const TK* ek_row = ek + (int64_t)src * H;
        const TK* e_row = e + (int64_t)edge * H;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = f0 + j * 32 + lane;
          if (f < H) {
            const float kv =
                EDGE ? add_cast(ek_row[f], e_row[f]) : to_f32(ek_row[f]);
            const float z = kv + q[j];
            acc[j] += act_fn<ACT>(z, slope) * sc;
            if (EMIT_S) sacc[j] += act_grad<ACT>(z, slope) * sc;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + j * 32 + lane;
      if (f < H) {
        rows[(int64_t)r * H + f] = acc[j];
        if (EMIT_S) srows[(int64_t)r * H + f] = sacc[j];
      }
    }
  }
}

template <int ACT, bool EDGE, int NF, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
src_bwd_kernel(const T* __restrict__ eq, const T* __restrict__ g,
               const T* __restrict__ e, const float* __restrict__ ek,
               const int* __restrict__ slot_dst,
               const int* __restrict__ slot_edge,
               const float* __restrict__ scale,
               const int* __restrict__ row_key,
               const int* __restrict__ row_ptr, int R, int H, float slope,
               float* __restrict__ out, float* __restrict__ g_e) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;
  const int s0 = row_ptr[r];
  const int s1 = row_ptr[r + 1];
  const float* ek_row = ek + (int64_t)row_key[r] * H;
  for (int f0 = 0; f0 < H; f0 += 32 * NF) {
    float kv[NF], acc[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + j * 32 + lane;
      kv[j] = f < H ? ek_row[f] : 0.f;
      acc[j] = 0.f;
    }
    for (int base = s0; base < s1; base += 32) {
      const int mine = base + lane;
      const int my_dst = mine < s1 ? slot_dst[mine] : 0;
      const int my_edge = EDGE && mine < s1 ? slot_edge[mine] : 0;
      const float my_sc = mine < s1 ? scale[mine] : 0.f;
      const int n = min(32, s1 - base);
      for (int k = 0; k < n; ++k) {
        const int dst = __shfl_sync(kFull, my_dst, k);
        const int edge = EDGE ? __shfl_sync(kFull, my_edge, k) : 0;
        const float sc = __shfl_sync(kFull, my_sc, k);
        const T* eq_row = eq + (int64_t)dst * H;
        const T* g_row = g + (int64_t)dst * H;
        const T* e_row = e + (int64_t)edge * H;
        // a zero-scale slot (padding, or an edge the scales mask) writes
        // no g_e row: its g_z is 0, and the row stays the wrapper's 0
        const bool write = EDGE && sc != 0.f;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = f0 + j * 32 + lane;
          if (f < H) {
            const float qv =
                EDGE ? add_cast(eq_row[f], e_row[f]) : to_f32(eq_row[f]);
            const float z = qv + kv[j];
            const float gz = act_grad<ACT>(z, slope) * (to_f32(g_row[f]) * sc);
            acc[j] += gz;
            if (write) g_e[(int64_t)edge * H + f] = round_to<T>(gz);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + j * 32 + lane;
      if (f < H) out[(int64_t)r * H + f] = acc[j];
    }
  }
}

// ---------------------------------------------------------------------
// The vector path: 16-byte chunks, G groups of C lanes, kInflight gathers
// in flight a lane
// ---------------------------------------------------------------------

// 16 bytes of T widened to f32.
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 value is the top half of its f32 value
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// N f32 values (N a multiple of 4) as float4s.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
    f[i] = t.x;
    f[i + 1] = t.y;
    f[i + 2] = t.z;
    f[i + 3] = t.w;
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float* f) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

// A lane's place in one pass over at most 32 of a row's chunks: the pass
// has cp chunks, G = 32 / cp groups of cp lanes; lane = grp * cp + chunk.
// Lanes past G * cp are idle (they still take part in every shuffle).
struct Layout {
  int cp, G, grp, chunk;
  bool active;
  __device__ __forceinline__ Layout(int chunks_left, int lane) {
    cp = chunks_left < 32 ? chunks_left : 32;
    G = 32 / cp;
    grp = lane / cp;
    chunk = lane - grp * cp;
    active = grp < G;
  }
  // Adds the other groups' acc into group 0's, in group order.
  template <int N>
  __device__ __forceinline__ void combine(float* acc) const {
    for (int gg = 1; gg < G; ++gg) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float t = __shfl_sync(kFull, acc[j], gg * cp + chunk);
        if (grp == 0) acc[j] += t;
      }
    }
  }
};

// A row's slot range and key, and one lane's slot of a run of 32: what a
// warp loads ahead of the row it works on.
struct Head {
  int s0, s1, key;
};
struct Slot {
  int node, edge;
  float sc;
};

__device__ __forceinline__ Head load_head(const int* __restrict__ row_ptr,
                                          const int* __restrict__ row_key,
                                          int r, int R) {
  Head h{0, 0, 0};
  if (r < R) {
    h.s0 = __ldg(row_ptr + r);
    h.s1 = __ldg(row_ptr + r + 1);
    h.key = __ldg(row_key + r);
  }
  return h;
}

// Slot base + lane of a row ending at s1 (zeros past it).
template <bool EDGE>
__device__ __forceinline__ Slot load_slot(const int* __restrict__ slot_node,
                                          const int* __restrict__ slot_edge,
                                          const float* __restrict__ scale,
                                          int base, int s1, int lane) {
  Slot d{0, 0, 0.f};
  const int mine = base + lane;
  if (mine < s1) {
    d.node = __ldg(slot_node + mine);
    if (EDGE) d.edge = __ldg(slot_edge + mine);
    d.sc = __ldg(scale + mine);
  }
  return d;
}

// The vector kernels are persistent: warp w of W takes rows w, w + W, ...
// and loads the next row's first 32 slots and the header of the row after
// it while it works on this one, so a row waits only on its own gathers.
template <int ACT, bool EMIT_S, bool EDGE, typename TK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
act_reduce_vec_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
                      const TK* __restrict__ e,
                      const int* __restrict__ slot_src,
                      const int* __restrict__ slot_edge,
                      const float* __restrict__ scale,
                      const int* __restrict__ row_key,
                      const int* __restrict__ row_ptr, int R, int H,
                      float slope, float* __restrict__ rows,
                      float* __restrict__ srows) {
  constexpr int EPV = Vec<TK>::N;
  constexpr int U = kInflightFwd;
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * kWarpsPerBlock;
  int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int C = H / EPV;
  Head h = load_head(row_ptr, row_key, r, R);
  Head hn = load_head(row_ptr, row_key, r + W, R);
  Slot first = load_slot<EDGE>(slot_src, slot_edge, scale, h.s0, h.s1, lane);
  for (; r < R; r += W) {  // r is the same in every lane
    const Slot first_n =
        load_slot<EDGE>(slot_src, slot_edge, scale, hn.s0, hn.s1, lane);
    const Head hnn = load_head(row_ptr, row_key, r + 2 * W, R);
    const float* eq_row = eq + (int64_t)h.key * H;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const Layout L(C - c0, lane);
      const int f = (c0 + L.chunk) * EPV;  // the lane's first feature
      float q[EPV], acc[EPV], sacc[EPV];
      load_f32<EPV>(eq_row + f, q);
#pragma unroll
      for (int j = 0; j < EPV; ++j) acc[j] = sacc[j] = 0.f;
      for (int base = h.s0; base < h.s1; base += 32) {
        const Slot mine = base == h.s0 ? first
            : load_slot<EDGE>(slot_src, slot_edge, scale, base, h.s1, lane);
        const int n = min(32, h.s1 - base);
        for (int k0 = 0; k0 < n; k0 += L.G * U) {
          uint4 v[U], ve[U];
          float w[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int k = k0 + u * L.G + L.grp;  // the slot, within the 32
            ok[u] = L.active && k < n;
            const int src = __shfl_sync(kFull, mine.node, k & 31);
            w[u] = __shfl_sync(kFull, mine.sc, k & 31);
            v[u] = ok[u] ? load16(ek + (int64_t)src * H + f)
                         : make_uint4(0, 0, 0, 0);
            if (EDGE) {
              const int edge = __shfl_sync(kFull, mine.edge, k & 31);
              ve[u] = ok[u] ? load16(e + (int64_t)edge * H + f)
                            : make_uint4(0, 0, 0, 0);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            float kv[EPV], ev[EPV];
            Vec<TK>::widen(v[u], kv);
            if (EDGE) Vec<TK>::widen(ve[u], ev);
#pragma unroll
            for (int j = 0; j < EPV; ++j) {
              const float z =
                  (EDGE ? round_to<TK>(kv[j] + ev[j]) : kv[j]) + q[j];
              if (EMIT_S) {
                float a, d;
                act_both<ACT>(z, slope, a, d);
                acc[j] += a * w[u];
                sacc[j] += d * w[u];
              } else {
                acc[j] += act_fn<ACT>(z, slope) * w[u];
              }
            }
          }
        }
      }
      L.combine<EPV>(acc);
      if (EMIT_S) L.combine<EPV>(sacc);
      if (L.grp == 0) {
        store_f32<EPV>(rows + (int64_t)r * H + f, acc);
        if (EMIT_S) store_f32<EPV>(srows + (int64_t)r * H + f, sacc);
      }
    }
    h = hn;
    hn = hnn;
    first = first_n;
  }
}

template <int ACT, bool EDGE, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
src_bwd_vec_kernel(const T* __restrict__ eq, const T* __restrict__ g,
                   const T* __restrict__ e, const float* __restrict__ ek,
                   const int* __restrict__ slot_dst,
                   const int* __restrict__ slot_edge,
                   const float* __restrict__ scale,
                   const int* __restrict__ row_key,
                   const int* __restrict__ row_ptr, int R, int H, float slope,
                   float* __restrict__ out, float* __restrict__ g_e) {
  constexpr int EPV = Vec<T>::N;
  constexpr int U = EDGE ? kInflightBwdEdge : kInflightBwd;
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * kWarpsPerBlock;
  int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int C = H / EPV;
  Head h = load_head(row_ptr, row_key, r, R);
  Head hn = load_head(row_ptr, row_key, r + W, R);
  Slot first = load_slot<EDGE>(slot_dst, slot_edge, scale, h.s0, h.s1, lane);
  for (; r < R; r += W) {
    const Slot first_n =
        load_slot<EDGE>(slot_dst, slot_edge, scale, hn.s0, hn.s1, lane);
    const Head hnn = load_head(row_ptr, row_key, r + 2 * W, R);
    const float* ek_row = ek + (int64_t)h.key * H;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const Layout L(C - c0, lane);
      const int f = (c0 + L.chunk) * EPV;
      float kv[EPV], acc[EPV];
      load_f32<EPV>(ek_row + f, kv);
#pragma unroll
      for (int j = 0; j < EPV; ++j) acc[j] = 0.f;
      for (int base = h.s0; base < h.s1; base += 32) {
        const Slot mine = base == h.s0 ? first
            : load_slot<EDGE>(slot_dst, slot_edge, scale, base, h.s1, lane);
        const int n = min(32, h.s1 - base);
        for (int k0 = 0; k0 < n; k0 += L.G * U) {
          uint4 vq[U], vg[U], ve[U];
          float w[U];
          int edge[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int k = k0 + u * L.G + L.grp;
            ok[u] = L.active && k < n;
            const int dst = __shfl_sync(kFull, mine.node, k & 31);
            w[u] = __shfl_sync(kFull, mine.sc, k & 31);
            const int64_t at = (int64_t)dst * H + f;
            vq[u] = ok[u] ? load16(eq + at) : make_uint4(0, 0, 0, 0);
            vg[u] = ok[u] ? load16(g + at) : make_uint4(0, 0, 0, 0);
            if (EDGE) {
              edge[u] = __shfl_sync(kFull, mine.edge, k & 31);
              ve[u] = ok[u] ? load16(e + (int64_t)edge[u] * H + f)
                            : make_uint4(0, 0, 0, 0);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            float qv[EPV], gv[EPV], ev[EPV], gz[EPV];
            Vec<T>::widen(vq[u], qv);
            Vec<T>::widen(vg[u], gv);
            if (EDGE) Vec<T>::widen(ve[u], ev);
#pragma unroll
            for (int j = 0; j < EPV; ++j) {
              const float z =
                  (EDGE ? round_to<T>(qv[j] + ev[j]) : qv[j]) + kv[j];
              gz[j] = act_grad<ACT>(z, slope) * (gv[j] * w[u]);
              acc[j] += gz[j];
            }
            // a zero-scale slot writes no g_e row (see the scalar path)
            if (EDGE && w[u] != 0.f) {
#pragma unroll
              for (int j = 0; j < EPV; ++j) gz[j] = round_to<T>(gz[j]);
              store_f32<EPV>(g_e + (int64_t)edge[u] * H + f, gz);
            }
          }
        }
      }
      L.combine<EPV>(acc);
      if (L.grp == 0) store_f32<EPV>(out + (int64_t)r * H + f, acc);
    }
    h = hn;
    hn = hnn;
    first = first_n;
  }
}

// ---------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------

enum { FAMILY_FWD = 0, FAMILY_BWD = 1, FAMILY_BWD_EDGE = 2 };

int inflight(int family) {
  return family == FAMILY_FWD ? kInflightFwd
         : family == FAMILY_BWD ? kInflightBwd
                                : kInflightBwdEdge;
}

// The vector path's layout for rows of H values of `bytes` bytes, with the
// tables and outputs at ptrs (null ones unused), packed as
// C << 16 | G << 8 | kInflight (G of the first pass of 32 chunks); 0 where
// the launch takes the scalar path.
int vec_layout(int family, int H, int bytes, const void* const* ptrs,
               int n) {
  if (H <= 0 || (H * bytes) % 16) return 0;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return 0;
  const int C = H * bytes / 16;
  const int G = 32 / (C < 32 ? C : 32);
  return C << 16 | G << 8 | inflight(family);
}

int feat_per_lane(int H) {
  const int nf = (H + 31) / 32;
  return nf < kMaxFeatPerLane ? nf : kMaxFeatPerLane;
}

dim3 grid_for(int R) { return dim3((R + kWarpsPerBlock - 1) / kWarpsPerBlock); }

// A persistent kernel's grid: as many blocks as are resident on the card at
// once, at most one warp a row. per_sm caches the kernel's resident blocks
// an SM (-1 before the first query).
template <typename Kernel>
dim3 persistent_grid(Kernel kernel, int R, int& per_sm) {
  if (per_sm < 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, kernel, kWarpsPerBlock * 32, 0) != 0)
    per_sm = 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const dim3 all = grid_for(R);
  const unsigned most = (unsigned)(sms * per_sm);
  return dim3(most > 0 && most < all.x ? most : all.x);
}

template <int ACT, bool EMIT_S, bool EDGE, typename TK>
int launch_act_reduce(const void* eq, const void* ek, const void* e,
                      const void* slot_src, const void* slot_edge,
                      const void* scale, const void* row_key,
                      const void* row_ptr, int R, int H, float slope,
                      void* rows, void* srows, cudaStream_t st) {
  const void* tables[] = {eq, ek, e, rows, srows};
  if (vec_layout(FAMILY_FWD, H, sizeof(TK), tables, 5)) {
    const auto kernel = act_reduce_vec_kernel<ACT, EMIT_S, EDGE, TK>;
    static int per_sm = -1;
    kernel<<<persistent_grid(kernel, R, per_sm), kWarpsPerBlock * 32, 0,
             st>>>(
            (const float*)eq, (const TK*)ek, (const TK*)e,
            (const int*)slot_src, (const int*)slot_edge, (const float*)scale,
            (const int*)row_key, (const int*)row_ptr, R, H, slope,
            (float*)rows, (float*)srows);
    return (int)cudaGetLastError();
  }
#define SIR_ACT_REDUCE(NF)                                                   \
  act_reduce_kernel<ACT, EMIT_S, EDGE, NF, TK>                               \
      <<<grid_for(R), kWarpsPerBlock * 32, 0, st>>>(                         \
          (const float*)eq, (const TK*)ek, (const TK*)e, (const int*)slot_src, \
          (const int*)slot_edge, (const float*)scale, (const int*)row_key,   \
          (const int*)row_ptr, R, H, slope, (float*)rows, (float*)srows)
  switch (feat_per_lane(H)) {
    case 1: SIR_ACT_REDUCE(1); break;
    case 2: SIR_ACT_REDUCE(2); break;
    case 3: SIR_ACT_REDUCE(3); break;
    default: SIR_ACT_REDUCE(4); break;
  }
#undef SIR_ACT_REDUCE
  return (int)cudaGetLastError();
}

template <int ACT, bool EDGE, typename T>
int launch_src_bwd(const void* eq, const void* g, const void* e,
                   const void* ek, const void* slot_dst, const void* slot_edge,
                   const void* scale, const void* row_key, const void* row_ptr,
                   int R, int H, float slope, void* out, void* g_e,
                   cudaStream_t st) {
  const void* tables[] = {eq, g, e, ek, out, g_e};
  if (vec_layout(EDGE ? FAMILY_BWD_EDGE : FAMILY_BWD, H, sizeof(T), tables,
                 6)) {
    const auto kernel = src_bwd_vec_kernel<ACT, EDGE, T>;
    static int per_sm = -1;
    kernel<<<persistent_grid(kernel, R, per_sm), kWarpsPerBlock * 32, 0,
             st>>>(
            (const T*)eq, (const T*)g, (const T*)e, (const float*)ek,
            (const int*)slot_dst, (const int*)slot_edge, (const float*)scale,
            (const int*)row_key, (const int*)row_ptr, R, H, slope,
            (float*)out, (float*)g_e);
    return (int)cudaGetLastError();
  }
#define SIR_SRC_BWD(NF)                                                      \
  src_bwd_kernel<ACT, EDGE, NF, T>                                           \
      <<<grid_for(R), kWarpsPerBlock * 32, 0, st>>>(                         \
          (const T*)eq, (const T*)g, (const T*)e, (const float*)ek,          \
          (const int*)slot_dst, (const int*)slot_edge, (const float*)scale,  \
          (const int*)row_key, (const int*)row_ptr, R, H, slope,             \
          (float*)out, (float*)g_e)
  switch (feat_per_lane(H)) {
    case 1: SIR_SRC_BWD(1); break;
    case 2: SIR_SRC_BWD(2); break;
    case 3: SIR_SRC_BWD(3); break;
    default: SIR_SRC_BWD(4); break;
  }
#undef SIR_SRC_BWD
  return (int)cudaGetLastError();
}

template <bool EMIT_S, bool EDGE>
int act_reduce_entry(const void* eq, const void* ek, const void* e,
                     int ek_bf16, const void* slot_src, const void* slot_edge,
                     const void* scale, const void* row_key,
                     const void* row_ptr, int R, int H, int act, float slope,
                     void* rows, void* srows, void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SIR_ARGS eq, ek, e, slot_src, slot_edge, scale, row_key, row_ptr, R, H, slope, rows, srows, st
  if (act == ACT_LEAKY_RELU)
    return ek_bf16
        ? launch_act_reduce<ACT_LEAKY_RELU, EMIT_S, EDGE, __nv_bfloat16>(SIR_ARGS)
        : launch_act_reduce<ACT_LEAKY_RELU, EMIT_S, EDGE, float>(SIR_ARGS);
  if (act == ACT_TANH)
    return ek_bf16
        ? launch_act_reduce<ACT_TANH, EMIT_S, EDGE, __nv_bfloat16>(SIR_ARGS)
        : launch_act_reduce<ACT_TANH, EMIT_S, EDGE, float>(SIR_ARGS);
  if (act == ACT_GELU)
    return ek_bf16
        ? launch_act_reduce<ACT_GELU, EMIT_S, EDGE, __nv_bfloat16>(SIR_ARGS)
        : launch_act_reduce<ACT_GELU, EMIT_S, EDGE, float>(SIR_ARGS);
#undef SIR_ARGS
  return (int)cudaErrorInvalidValue;
}

template <bool EDGE>
int src_bwd_entry(const void* eq, const void* g, const void* e, int bf16,
                  const void* ek, const void* slot_dst, const void* slot_edge,
                  const void* scale, const void* row_key, const void* row_ptr,
                  int R, int H, int act, float slope, void* out, void* g_e,
                  void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SIR_ARGS eq, g, e, ek, slot_dst, slot_edge, scale, row_key, row_ptr, R, H, slope, out, g_e, st
  if (act == ACT_LEAKY_RELU)
    return bf16 ? launch_src_bwd<ACT_LEAKY_RELU, EDGE, __nv_bfloat16>(SIR_ARGS)
                : launch_src_bwd<ACT_LEAKY_RELU, EDGE, float>(SIR_ARGS);
  if (act == ACT_TANH)
    return bf16 ? launch_src_bwd<ACT_TANH, EDGE, __nv_bfloat16>(SIR_ARGS)
                : launch_src_bwd<ACT_TANH, EDGE, float>(SIR_ARGS);
  if (act == ACT_GELU)
    return bf16 ? launch_src_bwd<ACT_GELU, EDGE, __nv_bfloat16>(SIR_ARGS)
                : launch_src_bwd<ACT_GELU, EDGE, float>(SIR_ARGS);
#undef SIR_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted). Pointers are device pointers; eq and the
// outputs are f32, the index arrays int32, the scales f32.

int ell_act_reduce(const void* eq, const void* ek, int ek_bf16,
                   const void* slot_src, const void* scale,
                   const void* row_key, const void* row_ptr, int R, int H,
                   int act, float slope, void* rows, void* stream) {
  return act_reduce_entry<false, false>(eq, ek, nullptr, ek_bf16, slot_src,
                                        nullptr, scale, row_key, row_ptr, R,
                                        H, act, slope, rows, nullptr, stream);
}

int ell_act_reduce2(const void* eq, const void* ek, int ek_bf16,
                    const void* slot_src, const void* scale,
                    const void* row_key, const void* row_ptr, int R, int H,
                    int act, float slope, void* rows, void* srows,
                    void* stream) {
  return act_reduce_entry<true, false>(eq, ek, nullptr, ek_bf16, slot_src,
                                       nullptr, scale, row_key, row_ptr, R, H,
                                       act, slope, rows, srows, stream);
}

// ek and e share one type (f32, or bf16 when ek_bf16 != 0).
int ell_act_reduce_edge(const void* eq, const void* ek, const void* e,
                        int ek_bf16, const void* slot_src,
                        const void* slot_edge, const void* scale,
                        const void* row_key, const void* row_ptr, int R, int H,
                        int act, float slope, void* rows, void* stream) {
  return act_reduce_entry<false, true>(eq, ek, e, ek_bf16, slot_src,
                                       slot_edge, scale, row_key, row_ptr, R,
                                       H, act, slope, rows, nullptr, stream);
}

int ell_act_reduce2_edge(const void* eq, const void* ek, const void* e,
                         int ek_bf16, const void* slot_src,
                         const void* slot_edge, const void* scale,
                         const void* row_key, const void* row_ptr, int R,
                         int H, int act, float slope, void* rows, void* srows,
                         void* stream) {
  return act_reduce_entry<true, true>(eq, ek, e, ek_bf16, slot_src, slot_edge,
                                      scale, row_key, row_ptr, R, H, act,
                                      slope, rows, srows, stream);
}

// eq and g share one type (f32, or bf16 when bf16 != 0); ek is f32.
int ell_src_bwd(const void* eq, const void* g, int bf16, const void* ek,
                const void* slot_dst, const void* scale, const void* row_key,
                const void* row_ptr, int R, int H, int act, float slope,
                void* out, void* stream) {
  return src_bwd_entry<false>(eq, g, nullptr, bf16, ek, slot_dst, nullptr,
                              scale, row_key, row_ptr, R, H, act, slope, out,
                              nullptr, stream);
}

// eq, g and e share one type (f32, or bf16 when bf16 != 0); ek and g_e
// [E_pad, H] are f32, g_e zeroed by the caller.
int ell_src_bwd_edge(const void* eq, const void* g, const void* e, int bf16,
                     const void* ek, const void* slot_dst,
                     const void* slot_edge, const void* scale,
                     const void* row_key, const void* row_ptr, int R, int H,
                     int act, float slope, void* out, void* g_e,
                     void* stream) {
  return src_bwd_entry<true>(eq, g, e, bf16, ek, slot_dst, slot_edge, scale,
                             row_key, row_ptr, R, H, act, slope, out, g_e,
                             stream);
}

// Launches nothing: the path a launch of the forward (family 0: #1, #2 and
// their edge forms) or backward (family 1: #4; 2: #4-edge) family takes for
// rows of H values in bf16 (bf16 != 0) or f32, with the tables and outputs
// p0..p5 it is given (null ones unused). Returns C << 16 | G << 8 | U for
// the vector path (C 16-byte chunks a row, G groups a warp, U gathers in
// flight a lane), 0 for the scalar path.
int ell_layout(int family, int H, int bf16, const void* p0, const void* p1,
               const void* p2, const void* p3, const void* p4,
               const void* p5) {
  const void* ptrs[] = {p0, p1, p2, p3, p4, p5};
  return vec_layout(family, H, bf16 ? 2 : 4, ptrs, 6);
}

const char* ell_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
