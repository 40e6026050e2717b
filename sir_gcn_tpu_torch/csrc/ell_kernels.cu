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
// They replace the Pallas kernels bucket_bcast_act_reduce,
// bucket_bcast_act_reduce2 and bucket_src_bwd (with its per-slot g_z output
// in the edge-term form, followed by the take of _edge_cotangent) of
// sir_gcn_tpu/ops/pallas/kernels.py and sir_gcn_tpu/ops/ell.py.
//
// Bound: device-memory bytes. Every slot costs one random H-wide row read
// from a node table (two with an edge term) and a few flops per feature, far
// below the card's compute rate. Design: one warp per row, 8 rows per block;
// the lanes load 32 slot indices and scales at a time with one coalesced
// read and pass them round with warp shuffles, and each lane keeps NF
// features of the row (NF * 32 >= H up to H = 128; wider rows take several
// passes) in registers, so the gathered rows are read once, coalesced across
// lanes, and each output row is written once. All sums are f32, in slot
// order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxFeatPerLane = 4;
constexpr unsigned kFull = 0xffffffffu;

// Activation ids, as registered in sir_gcn_tpu_torch/ops/ell.py.
enum { ACT_LEAKY_RELU = 0, ACT_TANH = 1 };

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
  if (ACT == ACT_LEAKY_RELU) return z >= 0.f ? z : slope * z;
  return tanhf(z);
}

// act'(z); leaky_relu'(0) = 1, matching where(z >= 0, z, slope * z).
template <int ACT>
__device__ __forceinline__ float act_grad(float z, float slope) {
  if (ACT == ACT_LEAKY_RELU) return z >= 0.f ? 1.f : slope;
  const float t = tanhf(z);
  return (1.f + t) * (1.f - t);
}

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

int feat_per_lane(int H) {
  const int nf = (H + 31) / 32;
  return nf < kMaxFeatPerLane ? nf : kMaxFeatPerLane;
}

dim3 grid_for(int R) { return dim3((R + kWarpsPerBlock - 1) / kWarpsPerBlock); }

template <int ACT, bool EMIT_S, bool EDGE, typename TK>
int launch_act_reduce(const void* eq, const void* ek, const void* e,
                      const void* slot_src, const void* slot_edge,
                      const void* scale, const void* row_key,
                      const void* row_ptr, int R, int H, float slope,
                      void* rows, void* srows, cudaStream_t st) {
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

const char* ell_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
