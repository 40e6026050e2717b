// Max-aggregation ELL kernels for Hopper (sm_90a), with a plain C interface
// bound from Python through ctypes (sir_gcn_tpu_torch/ops/cuda/kernels.py).
//
// The max aggregation applies W_R [H, O] per slot before the reduce:
//
//   m[s, o]   = sum_h act(eq[row_key[r]] + ek[slot_src[s]])[h] * W[h, o]
//   rows[r,o] = max over the valid slots s of row r of m[s, o]
//
//   ell_max_fwd        rows (the f32 min where a row has no valid slot)
//   ell_max_wincount   counts[r, o] = #valid s with m[s, o] == key_max[key, o]
//   ell_max_bwd        g_m = win * gsc[key]; g_W = sum_s a^T g_m;
//                      g_z = act'(z) * (g_m W^T) per slot; geq_rows = sum_s g_z
//   ell_scaled_reduce  out[r] = sum_s scale[s] * values[slot_idx[s]]
//
// They replace the Pallas kernels bucket_max_gemm_fwd, bucket_max_wincount,
// bucket_max_gemm_bwd and bucket_scaled_reduce of
// sir_gcn_tpu/ops/pallas/kernels.py. As in ell_kernels.cu, one launch walks
// every row of a plan through row_ptr and gathers node rows by index, so no
// [S, H] slot table is read: ek rows, and the key-level max and cotangent
// rows, are read by index; ell_scaled_reduce reads g_z through the
// src-slot -> dst-slot map instead of a permuted copy.
//
// Bound: operations. Each slot costs 2*H*O flops for m (three times that in
// the backward: m, g_W and g_a), against 2-4 bytes per feature read, so the
// f32 rate of the card bounds the max kernels; ell_scaled_reduce is bound
// by bytes. Design: one warp per row, 8 rows per block. W is staged in
// shared memory when it fits (row stride padded to an odd count, so that
// lanes reading a column and lanes reading a row both avoid bank
// conflicts); otherwise it is read from device memory. A warp carries
// kG = 4 slots at a time: their activations sit in shared memory as
// [H][4], one float4 per h, and each lane accumulates m for 4 slots and
// up to 4 of the O columns (32 * NJ columns per pass, more passes above
// O = 128), reusing each W value 4 times.
//
// Exact ties: wincount and the backward test m == key_max for equality, so
// the three kernels compute m bit for bit alike: the same slot_products()
// with explicit __fmaf_rn in increasing h from 0. A 1-ulp difference would
// zero every count and the gradient with it.
//
// g_W: the backward's blocks are persistent and walk row tiles in a fixed
// order. Each block accumulates its share of g_W (in shared memory when it
// fits, else in its own slice of the scratch) and writes one partial; a
// second kernel sums the partials in block order. No atomics, so g_W is the
// same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // rows per block, one warp each
constexpr int kG = 4;        // slots a warp carries at once (one float4)
constexpr int kMaxNJ = 4;    // output columns per lane and pass
// dynamic shared memory a block may use: the card's 232,448 bytes less
// room for the static arrays
constexpr int kMaxSmem = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

// Activation ids, as registered in sir_gcn_tpu_torch/ops/ell.py.
enum { ACT_LEAKY_RELU = 0, ACT_TANH = 1 };
enum { MODE_MAX = 0, MODE_COUNT = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as astype(bf16)
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

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Row stride of W in shared memory: odd, so that 32 lanes reading one
// column (rows h..h+31) hit 32 banks.
__host__ __device__ __forceinline__ int w_stride(int O) {
  return (O % 2 == 0) ? O + 1 : O;
}

// The activations of up to kG slots, a_s[h * kG + g] = act(z), and
// optionally d_s = act'(z); slots g >= n get 0. src is lane g's slot node.
template <int ACT, typename TK>
__device__ __forceinline__ void load_group(const float* __restrict__ eq_row,
                                           const TK* __restrict__ ek,
                                           int my_src, int n, int H,
                                           float slope, int lane, float* a_s,
                                           float* d_s) {
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int src = __shfl_sync(kFull, my_src, g);
    const TK* ek_row = ek + (int64_t)src * H;
    for (int h = lane; h < H; h += 32) {
      float a = 0.f, d = 0.f;
      if (g < n) {
        const float z = to_f32(ek_row[h]) + eq_row[h];
        a = act_fn<ACT>(z, slope);
        if (d_s != nullptr) d = act_grad<ACT>(z, slope);
      }
      a_s[h * kG + g] = a;
      if (d_s != nullptr) d_s[h * kG + g] = d;
    }
  }
  __syncwarp();
}

// m[g][j] = sum_h a_s[h][g] * W[h][col_j], col_j = oc + 32 j + lane
// (clamped to O - 1; the caller drops columns past O), one fused
// multiply-add per h in increasing h from 0. Every kernel that needs m
// calls this, so m is rounded bit for bit alike in all of them.
template <int NJ>
__device__ __forceinline__ void slot_products(const float* a_s,
                                              const float* wp, int ldw,
                                              int H, int O, int oc, int lane,
                                              float m[kG][NJ]) {
  int col[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    col[j] = min(oc + 32 * j + lane, O - 1);
#pragma unroll
    for (int g = 0; g < kG; ++g) m[g][j] = 0.f;
  }
  for (int h = 0; h < H; ++h) {
    const float4 a = *reinterpret_cast<const float4*>(a_s + h * kG);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float w = wp[h * ldw + col[j]];
      m[0][j] = __fmaf_rn(a.x, w, m[0][j]);
      m[1][j] = __fmaf_rn(a.y, w, m[1][j]);
      m[2][j] = __fmaf_rn(a.z, w, m[2][j]);
      m[3][j] = __fmaf_rn(a.w, w, m[3][j]);
    }
  }
}

// Stage W [H, O] into shared memory at row stride ldw (whole block).
__device__ __forceinline__ void stage_w(const float* __restrict__ w, int H,
                                        int O, int ldw, float* w_s) {
  for (int i = threadIdx.x; i < H * O; i += blockDim.x) {
    const int h = i / O;
    w_s[h * ldw + (i - h * O)] = w[i];
  }
}

// MODE_MAX: out[r, o] = max over valid slots of m (the f32 min if none).
// MODE_COUNT: out[r, o] = #valid slots with m == key_max[row_key[r], o].
template <int ACT, int MODE, int NJ, bool WSMEM, typename TK>
__global__ void __launch_bounds__(kWarps * 32)
max_fwd_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
               const int* __restrict__ slot_src,
               const float* __restrict__ scale,
               const int* __restrict__ row_key,
               const int* __restrict__ row_ptr, const float* __restrict__ w,
               const float* __restrict__ key_max, int R, int H, int O,
               float slope, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ldw = WSMEM ? w_stride(O) : O;
  const float* wp = w;
  int off = 0;
  if (WSMEM) {
    stage_w(w, H, O, ldw, smem);
    __syncthreads();
    wp = smem;
    off = round4(H * ldw);
  }
  float* a_s = smem + off + warp * H * kG;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // the whole warp leaves, after the block's barrier
  const int key = row_key[r];
  const int s0 = row_ptr[r], s1 = row_ptr[r + 1];
  const float* eq_row = eq + (int64_t)key * H;
  for (int oc = 0; oc < O; oc += 32 * NJ) {
    float acc[NJ], ref[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j] = MODE == MODE_MAX ? -FLT_MAX : 0.f;
      if (MODE == MODE_COUNT)
        ref[j] = key_max[(int64_t)key * O + min(oc + 32 * j + lane, O - 1)];
    }
    for (int base = s0; base < s1; base += kG) {
      const int n = min(kG, s1 - base);
      const int my_src = lane < n ? slot_src[base + lane] : 0;
      const float my_sc = lane < n ? scale[base + lane] : 0.f;
      load_group<ACT, TK>(eq_row, ek, my_src, n, H, slope, lane, a_s,
                          nullptr);
      float m[kG][NJ];
      slot_products<NJ>(a_s, wp, ldw, H, O, oc, lane, m);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const bool valid = __shfl_sync(kFull, my_sc, g) > 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (MODE == MODE_MAX) {
            if (valid && m[g][j] > acc[j]) acc[j] = m[g][j];
          } else if (valid && m[g][j] == ref[j]) {
            acc[j] += 1.f;
          }
        }
      }
      __syncwarp();  // a_s is rewritten by the next group
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = oc + 32 * j + lane;
      if (o < O) out[(int64_t)r * O + o] = acc[j];
    }
  }
}

// Per-warp shared buffers of the backward, in floats.
__host__ __device__ __forceinline__ int bwd_warp_floats(int H, int O) {
  return 2 * H * kG + O * kG + round4(H);
}

// The backward (see the header). Persistent blocks walk row tiles of
// kWarps rows in a fixed order, one group of kG slots per warp per step,
// all warps of a block in step: after each step the block adds
// a^T g_m of its kWarps * kG slots to its g_W partial. BIG = false keeps W
// and the partial in shared memory; BIG = true reads W from device memory
// and accumulates into the block's own slice of gw_part.
template <int ACT, int NJ, bool BIG, typename TK>
__global__ void __launch_bounds__(kWarps * 32)
max_bwd_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
               const int* __restrict__ slot_src,
               const float* __restrict__ scale,
               const int* __restrict__ row_key,
               const int* __restrict__ row_ptr, const float* __restrict__ w,
               const float* __restrict__ key_max,
               const float* __restrict__ gsc, int R, int H, int O,
               float slope, float* __restrict__ geq_rows,
               TK* __restrict__ gz, float* __restrict__ gw_part) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int groups_s[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int HO = H * O;
  const int ldw = BIG ? O : w_stride(O);
  const float* wp = w;
  float* gw_acc = gw_part + (int64_t)blockIdx.x * HO;
  int off = 0;
  if (!BIG) {
    stage_w(w, H, O, ldw, smem);
    wp = smem;
    off = round4(H * ldw);
    gw_acc = smem + off;
    off += round4(HO);
  }
  for (int e = threadIdx.x; e < HO; e += blockDim.x) gw_acc[e] = 0.f;
  const int per_warp = bwd_warp_floats(H, O);
  float* base_s = smem + off;
  float* a_s = base_s + warp * per_warp;
  float* d_s = a_s + H * kG;
  float* gm_s = d_s + H * kG;
  float* geq_s = gm_s + O * kG;

  const int ntiles = (R + kWarps - 1) / kWarps;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r = tile * kWarps + warp;
    int s0 = 0, s1 = 0, key = 0;
    if (r < R) {
      s0 = row_ptr[r];
      s1 = row_ptr[r + 1];
      key = row_key[r];
    }
    if (lane == 0) groups_s[warp] = (s1 - s0 + kG - 1) / kG;
    for (int h = lane; h < H; h += 32) geq_s[h] = 0.f;
    __syncthreads();  // groups_s, W and the zeroed partial are ready
    int ngroups = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) ngroups = max(ngroups, groups_s[v]);
    const float* eq_row = eq + (int64_t)key * H;
    const float* gsc_row = gsc + (int64_t)key * O;
    const float* max_row = key_max + (int64_t)key * O;

    for (int it = 0; it < ngroups; ++it) {
      const int base = s0 + it * kG;
      const int n = max(0, min(kG, s1 - base));
      const int my_src = lane < n ? slot_src[base + lane] : 0;
      const float my_sc = lane < n ? scale[base + lane] : 0.f;
      load_group<ACT, TK>(eq_row, ek, my_src, n, H, slope, lane, a_s, d_s);
      // g_m = win * gsc, into gm_s[o][g]
      for (int oc = 0; oc < O; oc += 32 * NJ) {
        float m[kG][NJ];
        slot_products<NJ>(a_s, wp, ldw, H, O, oc, lane, m);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int o = oc + 32 * j + lane;
          const int oo = min(o, O - 1);
          const float ref = max_row[oo], gv = gsc_row[oo];
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            const bool valid = __shfl_sync(kFull, my_sc, g) > 0.f;
            if (o < O) gm_s[o * kG + g] = (valid && m[g][j] == ref) ? gv : 0.f;
          }
        }
      }
      __syncwarp();
      // g_a = g_m W^T and g_z = act'(z) * g_a, lanes over h
      if (n > 0) {
        for (int h = lane; h < H; h += 32) {
          float ga[kG] = {0.f, 0.f, 0.f, 0.f};
          for (int o = 0; o < O; ++o) {
            const float wv = wp[h * ldw + o];
            const float4 gm = *reinterpret_cast<const float4*>(gm_s + o * kG);
            ga[0] = __fmaf_rn(gm.x, wv, ga[0]);
            ga[1] = __fmaf_rn(gm.y, wv, ga[1]);
            ga[2] = __fmaf_rn(gm.z, wv, ga[2]);
            ga[3] = __fmaf_rn(gm.w, wv, ga[3]);
          }
          float sum = geq_s[h];
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g < n) {
              const float v = d_s[h * kG + g] * ga[g];
              store(gz + (int64_t)(base + g) * H + h, v);
              sum += v;
            }
          }
          geq_s[h] = sum;
        }
      }
      __syncthreads();  // every warp's a_s and gm_s are ready
      // g_W += a^T g_m over the block's kWarps * kG slots
      for (int e = threadIdx.x; e < HO; e += blockDim.x) {
        const int h = e / O, o = e - h * O;
        float acc = gw_acc[e];
#pragma unroll
        for (int v = 0; v < kWarps; ++v) {
          const float* av = base_s + v * per_warp;
          const float4 a = *reinterpret_cast<const float4*>(av + h * kG);
          const float4 gm =
              *reinterpret_cast<const float4*>(av + 2 * H * kG + o * kG);
          acc = __fmaf_rn(a.x, gm.x, acc);
          acc = __fmaf_rn(a.y, gm.y, acc);
          acc = __fmaf_rn(a.z, gm.z, acc);
          acc = __fmaf_rn(a.w, gm.w, acc);
        }
        gw_acc[e] = acc;
      }
      __syncthreads();  // before the next group rewrites a_s and gm_s
    }
    if (r < R)
      for (int h = lane; h < H; h += 32)
        geq_rows[(int64_t)r * H + h] = geq_s[h];
    __syncthreads();  // groups_s and geq_s are rewritten by the next tile
  }
  if (!BIG) {
    float* dst = gw_part + (int64_t)blockIdx.x * HO;
    for (int e = threadIdx.x; e < HO; e += blockDim.x) dst[e] = gw_acc[e];
  }
}

// out[i] = sum over p in order of part[p, i].
__global__ void sum_partials_kernel(const float* __restrict__ part, int P,
                                    int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(int64_t)p * n + i];
  out[i] = s;
}

// out[r] = sum over row r's slots of scale[s] * values[slot_idx[s]], f32.
// A slot with scale 0 (padding) is skipped, so the row its index points at
// is never read.
template <int NF, typename TV>
__global__ void __launch_bounds__(kWarps * 32)
scaled_reduce_kernel(const TV* __restrict__ values,
                     const int* __restrict__ slot_idx,
                     const float* __restrict__ scale,
                     const int* __restrict__ row_ptr, int R, int H,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int s0 = row_ptr[r], s1 = row_ptr[r + 1];
  for (int f0 = 0; f0 < H; f0 += 32 * NF) {
    float acc[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) acc[j] = 0.f;
    for (int base = s0; base < s1; base += 32) {
      const int mine = base + lane;
      const int my_idx = mine < s1 ? slot_idx[mine] : 0;
      const float my_sc = mine < s1 ? scale[mine] : 0.f;
      const int n = min(32, s1 - base);
      for (int k = 0; k < n; ++k) {
        const int idx = __shfl_sync(kFull, my_idx, k);
        const float sc = __shfl_sync(kFull, my_sc, k);
        if (sc == 0.f) continue;  // warp-uniform
        const TV* row = values + (int64_t)idx * H;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = f0 + j * 32 + lane;
          if (f < H) acc[j] += to_f32(row[f]) * sc;
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

int cols_per_lane(int O) {
  const int nj = (O + 31) / 32;
  return nj < kMaxNJ ? nj : kMaxNJ;
}

dim3 grid_for(int R) { return dim3((R + kWarps - 1) / kWarps); }

size_t fwd_smem(int H, int O, bool wsmem) {
  return sizeof(float) *
         ((wsmem ? round4(H * w_stride(O)) : 0) + (size_t)kWarps * H * kG);
}

size_t bwd_smem(int H, int O, bool big) {
  size_t f = (size_t)kWarps * bwd_warp_floats(H, O);
  if (!big) f += round4(H * w_stride(O)) + round4(H * O);
  return sizeof(float) * f;
}

// Set a kernel's dynamic shared memory and launch it; returns the error.
template <typename K, typename... Args>
int launch(K kernel, dim3 grid, size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWarps * 32, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int ACT, int MODE, typename TK>
int fwd_entry(const void* eq, const void* ek, const void* slot_src,
              const void* scale, const void* row_key, const void* row_ptr,
              const void* w, const void* key_max, int R, int H, int O,
              float slope, void* out, cudaStream_t st) {
  const bool wsmem = fwd_smem(H, O, true) <= (size_t)kMaxSmem;
  const size_t smem = fwd_smem(H, O, wsmem);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
#define SIR_MAX_FWD(NJ, WS)                                                 \
  launch(max_fwd_kernel<ACT, MODE, NJ, WS, TK>, grid_for(R), smem, st,      \
         (const float*)eq, (const TK*)ek, (const int*)slot_src,             \
         (const float*)scale, (const int*)row_key, (const int*)row_ptr,     \
         (const float*)w, (const float*)key_max, R, H, O, slope, (float*)out)
#define SIR_MAX_FWD_NJ(NJ) \
  return wsmem ? SIR_MAX_FWD(NJ, true) : SIR_MAX_FWD(NJ, false)
  switch (cols_per_lane(O)) {
    case 1: SIR_MAX_FWD_NJ(1);
    case 2: SIR_MAX_FWD_NJ(2);
    case 3: SIR_MAX_FWD_NJ(3);
    default: SIR_MAX_FWD_NJ(4);
  }
#undef SIR_MAX_FWD_NJ
#undef SIR_MAX_FWD
}

template <int MODE>
int fwd_dispatch(const void* eq, const void* ek, int ek_bf16,
                 const void* slot_src, const void* scale, const void* row_key,
                 const void* row_ptr, const void* w, const void* key_max,
                 int R, int H, int O, int act, float slope, void* out,
                 void* stream) {
  if (R <= 0 || H <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SIR_ARGS eq, ek, slot_src, scale, row_key, row_ptr, w, key_max, R, H, O, slope, out, st
  if (act == ACT_LEAKY_RELU)
    return ek_bf16 ? fwd_entry<ACT_LEAKY_RELU, MODE, __nv_bfloat16>(SIR_ARGS)
                   : fwd_entry<ACT_LEAKY_RELU, MODE, float>(SIR_ARGS);
  if (act == ACT_TANH)
    return ek_bf16 ? fwd_entry<ACT_TANH, MODE, __nv_bfloat16>(SIR_ARGS)
                   : fwd_entry<ACT_TANH, MODE, float>(SIR_ARGS);
#undef SIR_ARGS
  return (int)cudaErrorInvalidValue;
}

template <int ACT, typename TK>
struct Bwd {
  // The kernel instance for (O, big), so that the grid size and the launch
  // see the same one.
  static const void* pick(int O, bool big) {
#define SIR_PICK(NJ) \
  return big ? (const void*)max_bwd_kernel<ACT, NJ, true, TK> \
             : (const void*)max_bwd_kernel<ACT, NJ, false, TK>
    switch (cols_per_lane(O)) {
      case 1: SIR_PICK(1);
      case 2: SIR_PICK(2);
      case 3: SIR_PICK(3);
      default: SIR_PICK(4);
    }
#undef SIR_PICK
  }
};

bool bwd_big(int H, int O) { return bwd_smem(H, O, false) > (size_t)kMaxSmem; }

const void* bwd_kernel(int act, int bf16, int O, bool big) {
  if (act == ACT_LEAKY_RELU)
    return bf16 ? Bwd<ACT_LEAKY_RELU, __nv_bfloat16>::pick(O, big)
                : Bwd<ACT_LEAKY_RELU, float>::pick(O, big);
  if (act == ACT_TANH)
    return bf16 ? Bwd<ACT_TANH, __nv_bfloat16>::pick(O, big)
                : Bwd<ACT_TANH, float>::pick(O, big);
  return nullptr;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns a CUDA error code (0 when
// the launch was accepted). Pointers are device pointers; eq, W, key_max,
// gsc and the f32 outputs are f32, the index arrays int32, the scales f32;
// ek (and g_z) is bf16 when ek_bf16 != 0, else f32.

int ell_max_fwd(const void* eq, const void* ek, int ek_bf16,
                const void* slot_src, const void* scale, const void* row_key,
                const void* row_ptr, const void* w, int R, int H, int O,
                int act, float slope, void* out, void* stream) {
  return fwd_dispatch<MODE_MAX>(eq, ek, ek_bf16, slot_src, scale, row_key,
                                row_ptr, w, nullptr, R, H, O, act, slope, out,
                                stream);
}

int ell_max_wincount(const void* eq, const void* ek, int ek_bf16,
                     const void* slot_src, const void* scale,
                     const void* row_key, const void* row_ptr, const void* w,
                     const void* key_max, int R, int H, int O, int act,
                     float slope, void* out, void* stream) {
  return fwd_dispatch<MODE_COUNT>(eq, ek, ek_bf16, slot_src, scale, row_key,
                                  row_ptr, w, key_max, R, H, O, act, slope,
                                  out, stream);
}

// The number of blocks ell_max_bwd launches (its g_W scratch holds one
// [H, O] partial per block), or -1 for widths it cannot take.
int ell_max_bwd_blocks(int R, int H, int O, int act, int ek_bf16) {
  if (R <= 0 || H <= 0 || O <= 0) return -1;
  const bool big = bwd_big(H, O);
  const size_t smem = bwd_smem(H, O, big);
  const void* k = bwd_kernel(act, ek_bf16, O, big);
  if (k == nullptr || smem > (size_t)kMaxSmem) return -1;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kWarps * 32,
                                                    smem) != cudaSuccess)
    return -1;
  const int tiles = (R + kWarps - 1) / kWarps;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  return tiles < blocks ? tiles : blocks;
}

// gw_part holds `blocks` (from ell_max_bwd_blocks) partials of [H, O].
int ell_max_bwd(const void* eq, const void* ek, int ek_bf16,
                const void* slot_src, const void* scale, const void* row_key,
                const void* row_ptr, const void* w, const void* key_max,
                const void* gsc, int R, int H, int O, int act, float slope,
                int blocks, void* geq_rows, void* gz, void* gw_part, void* gw,
                void* stream) {
  if (R <= 0 || H <= 0 || O <= 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool big = bwd_big(H, O);
  const size_t smem = bwd_smem(H, O, big);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* k = bwd_kernel(act, ek_bf16, O, big);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&eq,      (void*)&ek,      (void*)&slot_src,
                  (void*)&scale,   (void*)&row_key, (void*)&row_ptr,
                  (void*)&w,       (void*)&key_max, (void*)&gsc,
                  (void*)&R,       (void*)&H,       (void*)&O,
                  (void*)&slope,   (void*)&geq_rows, (void*)&gz,
                  (void*)&gw_part};
  e = cudaLaunchKernel(k, dim3(blocks), dim3(kWarps * 32), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  const int n = H * O;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)gw_part, blocks, n, (float*)gw);
  return (int)cudaGetLastError();
}

// values [*, H] is bf16 when values_bf16 != 0, else f32.
int ell_scaled_reduce(const void* values, int values_bf16,
                      const void* slot_idx, const void* scale,
                      const void* row_ptr, int R, int H, void* out,
                      void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SIR_REDUCE(NF, T)                                                    \
  scaled_reduce_kernel<NF, T><<<grid_for(R), kWarps * 32, 0, st>>>(          \
      (const T*)values, (const int*)slot_idx, (const float*)scale,           \
      (const int*)row_ptr, R, H, (float*)out)
#define SIR_REDUCE_T(T)                  \
  switch (cols_per_lane(H)) {            \
    case 1: SIR_REDUCE(1, T); break;     \
    case 2: SIR_REDUCE(2, T); break;     \
    case 3: SIR_REDUCE(3, T); break;     \
    default: SIR_REDUCE(4, T); break;    \
  }
  if (values_bf16) {
    SIR_REDUCE_T(__nv_bfloat16)
  } else {
    SIR_REDUCE_T(float)
  }
#undef SIR_REDUCE_T
#undef SIR_REDUCE
  return (int)cudaGetLastError();
}

const char* ell_max_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
