// Fused-edge ELL kernels for Hopper (sm_90a), with a plain C interface bound
// from Python through ctypes (sir_gcn_tpu_torch/ops/cuda/kernels.py).
//
// SIREConv's edge projection folded into the aggregate: a slot's edge term
// is e_h = sum_d e_basis[slot_edge[s], d] * W_E[d, h], computed in the
// kernel from the narrow basis [E_pad, De] and W_E [De, H], so no [S, H] or
// [E_pad, H] edge table is read or written.
//
//   ell_edge_act_reduce2  z = eq[row_key[r]] + (ek[slot_src[s]] + e_h)
//                         rows[r]  = sum_s scale[s] * act(z)
//                         srows[r] = sum_s scale[s] * act'(z)
//   ell_edge_src_bwd      z = ek[row_key[r]] + (eq[slot_dst[s]] + e_h)
//                         g_z = act'(z) * scale[s] * g[slot_dst[s]]
//                         out[r] = sum_s g_z;  g_WE[d, h] = sum_s egr_d * g_z_h
//
// They replace the Pallas kernels bucket_edge_act_reduce2 and
// bucket_edge_src_bwd of sir_gcn_tpu/ops/pallas/kernels.py. The basis, W_E
// and the projection stay f32 and are never rounded; only ek (forward), eq
// and g (backward) come in the edge type.
//
// Bound: operations at the arxiv width (H = 96, De = 16): the projection
// costs 2 * De flops per slot and feature (twice that in the backward, for
// g_WE), against 2-4 bytes per feature read. Design: one warp per row, 8
// rows per block, as ell_kernels.cu; the slots' indices and scales are read
// 32 at a time and passed round by shuffles, and a slot with scale 0
// (padding) is skipped whole, so it reads nothing and contributes exactly 0.
// W_E sits in shared memory; the lanes load a slot's basis row (De values)
// with one coalesced read and broadcast it by shuffles, and each lane forms
// e_h for its own features (lanes striding h, so the shared reads of W_E
// hit 32 banks).
//
// g_WE: the backward's blocks are persistent; each warp walks its rows in
// a fixed order and adds egr_d * g_z into its own [De, H] partial in shared
// memory (each lane owns its features' columns, so no two lanes write one
// address). At the end a block sums its warps' partials in warp order into
// one partial per block, and a second kernel sums those in block order. No
// atomics, so g_WE is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // rows per block, one warp each
constexpr int kMaxFeatPerLane = 4;  // features per lane and pass
// dynamic shared memory a block may use: the card's 232,448 bytes less
// room for the static arrays
constexpr int kMaxSmem = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

// Activation ids, as registered in sir_gcn_tpu_torch/ops/ell.py.
enum { ACT_LEAKY_RELU = 0, ACT_TANH = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// e_h[j] = sum_d basis[d] * w_s[d, f0 + j * 32 + lane] for the lane's
// features, summed in increasing d; basis is one slot's [De] row.
template <int NF>
__device__ __forceinline__ void edge_term(const float* __restrict__ basis,
                                          const float* w_s, int De, int H,
                                          int f0, int lane, float* eh) {
#pragma unroll
  for (int j = 0; j < NF; ++j) eh[j] = 0.f;
  for (int d0 = 0; d0 < De; d0 += 32) {
    const float mine = d0 + lane < De ? basis[d0 + lane] : 0.f;
    const int nd = min(32, De - d0);
    for (int k = 0; k < nd; ++k) {
      const float b = __shfl_sync(kFull, mine, k);
      const float* w_row = w_s + (d0 + k) * H;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int f = f0 + j * 32 + lane;
        if (f < H) eh[j] = fmaf(b, w_row[f], eh[j]);
      }
    }
  }
}

template <int ACT, int NF, typename TK>
__global__ void __launch_bounds__(kWarps * 32)
edge_act_reduce_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
                       const float* __restrict__ e_basis,
                       const float* __restrict__ w_e,
                       const int* __restrict__ slot_src,
                       const int* __restrict__ slot_edge,
                       const float* __restrict__ scale,
                       const int* __restrict__ row_key,
                       const int* __restrict__ row_ptr, int R, int H, int De,
                       float slope, float* __restrict__ rows,
                       float* __restrict__ srows) {
  extern __shared__ float w_s[];  // [De, H]
  for (int i = threadIdx.x; i < De * H; i += blockDim.x) w_s[i] = w_e[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp leaves together
  const int s0 = row_ptr[r];
  const int s1 = row_ptr[r + 1];
  const float* eq_row = eq + (int64_t)row_key[r] * H;
  for (int f0 = 0; f0 < H; f0 += 32 * NF) {
    float q[NF], acc[NF], sacc[NF], eh[NF];
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
      const int my_edge = mine < s1 ? slot_edge[mine] : 0;
      const float my_sc = mine < s1 ? scale[mine] : 0.f;
      const int n = min(32, s1 - base);
      for (int k = 0; k < n; ++k) {
        const int src = __shfl_sync(kFull, my_src, k);
        const int edge = __shfl_sync(kFull, my_edge, k);
        const float sc = __shfl_sync(kFull, my_sc, k);
        if (sc == 0.f) continue;  // warp-uniform
        edge_term<NF>(e_basis + (int64_t)edge * De, w_s, De, H, f0, lane, eh);
        const TK* ek_row = ek + (int64_t)src * H;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = f0 + j * 32 + lane;
          if (f < H) {
            const float z = (to_f32(ek_row[f]) + eh[j]) + q[j];
            acc[j] += act_fn<ACT>(z, slope) * sc;
            sacc[j] += act_grad<ACT>(z, slope) * sc;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + j * 32 + lane;
      if (f < H) {
        rows[(int64_t)r * H + f] = acc[j];
        srows[(int64_t)r * H + f] = sacc[j];
      }
    }
  }
}

template <int ACT, int NF, typename T>
__global__ void __launch_bounds__(kWarps * 32)
edge_src_bwd_kernel(const T* __restrict__ eq, const T* __restrict__ g,
                    const float* __restrict__ ek,
                    const float* __restrict__ e_basis,
                    const float* __restrict__ w_e,
                    const int* __restrict__ slot_dst,
                    const int* __restrict__ slot_edge,
                    const float* __restrict__ scale,
                    const int* __restrict__ row_key,
                    const int* __restrict__ row_ptr, int R, int H, int De,
                    float slope, float* __restrict__ out,
                    float* __restrict__ gwe_part) {
  extern __shared__ float smem[];
  const int n_w = De * H;
  float* w_s = smem;                               // [De, H]
  const int warp = threadIdx.x >> 5;
  float* part_s = smem + n_w;                      // [kWarps, De, H]
  float* part_w = part_s + (int64_t)warp * n_w;
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) w_s[i] = w_e[i];
  for (int i = threadIdx.x; i < kWarps * n_w; i += blockDim.x) part_s[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // no early return: every warp reaches the block's final barrier
  for (int r = blockIdx.x * kWarps + warp; r < R; r += gridDim.x * kWarps) {
    const int s0 = row_ptr[r];
    const int s1 = row_ptr[r + 1];
    const float* ek_row = ek + (int64_t)row_key[r] * H;
    for (int f0 = 0; f0 < H; f0 += 32 * NF) {
      float kv[NF], acc[NF], eh[NF];
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int f = f0 + j * 32 + lane;
        kv[j] = f < H ? ek_row[f] : 0.f;
        acc[j] = 0.f;
      }
      for (int base = s0; base < s1; base += 32) {
        const int mine = base + lane;
        const int my_dst = mine < s1 ? slot_dst[mine] : 0;
        const int my_edge = mine < s1 ? slot_edge[mine] : 0;
        const float my_sc = mine < s1 ? scale[mine] : 0.f;
        const int n = min(32, s1 - base);
        for (int k = 0; k < n; ++k) {
          const int dst = __shfl_sync(kFull, my_dst, k);
          const int edge = __shfl_sync(kFull, my_edge, k);
          const float sc = __shfl_sync(kFull, my_sc, k);
          if (sc == 0.f) continue;  // warp-uniform
          const float* basis = e_basis + (int64_t)edge * De;
          edge_term<NF>(basis, w_s, De, H, f0, lane, eh);
          const T* eq_row = eq + (int64_t)dst * H;
          const T* g_row = g + (int64_t)dst * H;
          float gz[NF];
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            const int f = f0 + j * 32 + lane;
            gz[j] = 0.f;
            if (f < H) {
              const float z = (to_f32(eq_row[f]) + eh[j]) + kv[j];
              gz[j] = act_grad<ACT>(z, slope) * (to_f32(g_row[f]) * sc);
              acc[j] += gz[j];
            }
          }
          // g_WE[d, f] += egr_d * g_z[f], each lane on its own columns
          for (int d0 = 0; d0 < De; d0 += 32) {
            const float my_b = d0 + lane < De ? basis[d0 + lane] : 0.f;
            const int nd = min(32, De - d0);
            for (int kd = 0; kd < nd; ++kd) {
              const float b = __shfl_sync(kFull, my_b, kd);
              float* p_row = part_w + (d0 + kd) * H;
#pragma unroll
              for (int j = 0; j < NF; ++j) {
                const int f = f0 + j * 32 + lane;
                if (f < H) p_row[f] = fmaf(b, gz[j], p_row[f]);
              }
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
  __syncthreads();
  float* dst = gwe_part + (int64_t)blockIdx.x * n_w;
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part_s[(int64_t)w * n_w + i];
    dst[i] = s;
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

int feat_per_lane(int H) {
  const int nf = (H + 31) / 32;
  return nf < kMaxFeatPerLane ? nf : kMaxFeatPerLane;
}

size_t fwd_smem(int H, int De) { return sizeof(float) * (size_t)De * H; }

size_t bwd_smem(int H, int De) {
  return sizeof(float) * (size_t)(1 + kWarps) * De * H;
}

// The kernel instance for (act, edge type, H), so that the occupancy query
// and the launch see the same one.
template <int ACT, typename T>
const void* pick_fwd(int H) {
  switch (feat_per_lane(H)) {
    case 1: return (const void*)edge_act_reduce_kernel<ACT, 1, T>;
    case 2: return (const void*)edge_act_reduce_kernel<ACT, 2, T>;
    case 3: return (const void*)edge_act_reduce_kernel<ACT, 3, T>;
    default: return (const void*)edge_act_reduce_kernel<ACT, 4, T>;
  }
}

template <int ACT, typename T>
const void* pick_bwd(int H) {
  switch (feat_per_lane(H)) {
    case 1: return (const void*)edge_src_bwd_kernel<ACT, 1, T>;
    case 2: return (const void*)edge_src_bwd_kernel<ACT, 2, T>;
    case 3: return (const void*)edge_src_bwd_kernel<ACT, 3, T>;
    default: return (const void*)edge_src_bwd_kernel<ACT, 4, T>;
  }
}

const void* fwd_kernel(int act, int bf16, int H) {
  if (act == ACT_LEAKY_RELU)
    return bf16 ? pick_fwd<ACT_LEAKY_RELU, __nv_bfloat16>(H)
                : pick_fwd<ACT_LEAKY_RELU, float>(H);
  if (act == ACT_TANH)
    return bf16 ? pick_fwd<ACT_TANH, __nv_bfloat16>(H)
                : pick_fwd<ACT_TANH, float>(H);
  return nullptr;
}

const void* bwd_kernel(int act, int bf16, int H) {
  if (act == ACT_LEAKY_RELU)
    return bf16 ? pick_bwd<ACT_LEAKY_RELU, __nv_bfloat16>(H)
                : pick_bwd<ACT_LEAKY_RELU, float>(H);
  if (act == ACT_TANH)
    return bf16 ? pick_bwd<ACT_TANH, __nv_bfloat16>(H)
                : pick_bwd<ACT_TANH, float>(H);
  return nullptr;
}

// Set the kernel's dynamic shared memory and launch it; returns the error.
int launch(const void* k, int blocks, size_t smem, void** args,
           cudaStream_t st) {
  if (k == nullptr || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernel(k, dim3(blocks), dim3(kWarps * 32), args, smem, st);
  return (int)e;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns a CUDA error code (0 when
// the launch was accepted). Pointers are device pointers; eq (forward),
// ek (backward), e_basis, w_e and the outputs are f32, the index arrays
// int32, the scales f32. ek (forward) and eq and g (backward) are bf16 when
// bf16 != 0, else f32.

int ell_edge_act_reduce2(const void* eq, const void* ek, int bf16,
                         const void* e_basis, const void* w_e,
                         const void* slot_src, const void* slot_edge,
                         const void* scale, const void* row_key,
                         const void* row_ptr, int R, int H, int De, int act,
                         float slope, void* rows, void* srows, void* stream) {
  if (R <= 0 || H <= 0 || De <= 0) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&eq,      (void*)&ek,        (void*)&e_basis,
                  (void*)&w_e,     (void*)&slot_src,  (void*)&slot_edge,
                  (void*)&scale,   (void*)&row_key,   (void*)&row_ptr,
                  (void*)&R,       (void*)&H,         (void*)&De,
                  (void*)&slope,   (void*)&rows,      (void*)&srows};
  return launch(fwd_kernel(act, bf16, H), (R + kWarps - 1) / kWarps,
                fwd_smem(H, De), args, (cudaStream_t)stream);
}

// The number of blocks ell_edge_src_bwd launches (its g_WE scratch holds
// one [De, H] partial per block), or -1 for widths it cannot take.
int ell_edge_src_bwd_blocks(int R, int H, int De, int act, int bf16) {
  if (R <= 0 || H <= 0 || De <= 0) return -1;
  const size_t smem = bwd_smem(H, De);
  const void* k = bwd_kernel(act, bf16, H);
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

// gwe_part holds `blocks` (from ell_edge_src_bwd_blocks) partials of
// [De, H]; gwe [De, H] is their sum.
int ell_edge_src_bwd(const void* eq, const void* g, int bf16, const void* ek,
                     const void* e_basis, const void* w_e,
                     const void* slot_dst, const void* slot_edge,
                     const void* scale, const void* row_key,
                     const void* row_ptr, int R, int H, int De, int act,
                     float slope, int blocks, void* out, void* gwe_part,
                     void* gwe, void* stream) {
  if (R <= 0 || H <= 0 || De <= 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  void* args[] = {(void*)&eq,        (void*)&g,        (void*)&ek,
                  (void*)&e_basis,   (void*)&w_e,      (void*)&slot_dst,
                  (void*)&slot_edge, (void*)&scale,    (void*)&row_key,
                  (void*)&row_ptr,   (void*)&R,        (void*)&H,
                  (void*)&De,        (void*)&slope,    (void*)&out,
                  (void*)&gwe_part};
  const int code =
      launch(bwd_kernel(act, bf16, H), blocks, bwd_smem(H, De), args, st);
  if (code != 0) return code;
  const int n = De * H;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)gwe_part, blocks, n, (float*)gwe);
  return (int)cudaGetLastError();
}

const char* ell_edge_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
