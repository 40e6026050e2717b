// ELL kernels of the general sigma route for Hopper (sm_90a), with a plain C
// interface bound from Python through ctypes
// (sir_gcn_tpu_torch/ops/cuda/kernels.py).
//
// A row-wise sigma couples the H features of one slot (its Jacobian is not
// diagonal), so the elementwise route's derivative mass does not exist for
// it and every backward needs a full vector-Jacobian product (vjp). The
// kernels here take any sigma of the registry: leaky_relu and tanh
// elementwise, centered_relu (relu(z - alpha * mean_H(z))) and softmax over
// H row-wise. As in ell_kernels.cu, row r owns slots [row_ptr[r],
// row_ptr[r+1]) and reads its key's row through row_key[r]; node rows are
// gathered by index inside the kernels, all buckets in one launch.
//
//   ell_act_reduce_rowwise  rows[r] = sum_s scale[s] * act(z_s),
//                           z_s = eq[row_key[r]] + ek[slot_src[s]]
//   ell_geq_reduce          rows[r] = sum_s vjp(act, z_s)(scale[s] * g[row_key[r]])
//   ell_act_reduce_bwd      the same, plus each slot's
//                           g_slots[s] = vjp(act, z_s)(scale[s] * g[row_key[r]])
//   ell_src_bwd_rowwise     out[r] = sum_s vjp(act, z_s)(scale[s] * g[slot_dst[s]]),
//                           z_s = eq[slot_dst[s]] + ek[row_key[r]]
//   ell_src_bwd_fused       the same, eq and g read as the two halves of one
//                           [N, 2H] node table
//
// They replace the Pallas kernels bucket_bcast_act_reduce on the general
// route, bucket_geq_reduce, bucket_bcast_act_reduce_bwd, bucket_src_bwd with
// a full vjp, and bucket_src_bwd_fused (sir_gcn_tpu/ops/pallas/kernels.py,
// driven by sir_gcn_tpu/ops/ell.py make_ell_sir_aggregate_pallas).
//
// Bound: device-memory bytes, as for the linear kernels: each slot costs one
// random H-wide row read (an H-wide g_slots row write besides in
// ell_act_reduce_bwd) and some ten flops per feature. Design: one warp per
// row, 8 rows per block; the lanes load 32 slot indices and scales at a
// time and pass them round with warp shuffles. A row-wise sigma needs a
// slot's whole row at once: each lane keeps NF = 1, 2, 3, 4 or 8 features
// (NF * 32 >= H, so H <= 256) in registers, and a slot costs one warp
// reduction (__shfl_xor_sync) for the centered relu's mean (two in its vjp)
// and two for softmax's max and sum (three in its vjp). An elementwise sigma
// walks the features in chunks of up to 128, so any H is taken. A slot with
// scale 0 is skipped whole (the test is warp-uniform): it contributes exactly
// 0, and ell_act_reduce_bwd writes its g_slots row as 0. All sums are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// Activation ids, as registered in sir_gcn_tpu_torch/ops/ell.py.
enum {
  ACT_LEAKY_RELU = 0,
  ACT_TANH = 1,
  ACT_CENTERED_RELU = 2,
  ACT_SOFTMAX = 3
};

template <int ACT>
struct Rowwise {
  static constexpr bool value = ACT == ACT_CENTERED_RELU || ACT == ACT_SOFTMAX;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// f32 to T, bf16 rounded to nearest even as astype(bf16) does.
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Butterfly reductions: every lane ends with the same value, bit for bit
// (each step adds the same two partials in every lane of a group).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// sum over the features of a row a lane holds (ok[j]: feature j is < H),
// then over the warp
template <int NF>
__device__ __forceinline__ float row_sum(const float (&x)[NF],
                                         const bool (&ok)[NF]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NF; ++j)
    if (ok[j]) s += x[j];
  return warp_sum(s);
}

template <int ACT>
__device__ __forceinline__ float act_fn(float z, float p) {
  if (ACT == ACT_LEAKY_RELU) return z >= 0.f ? z : p * z;
  return tanhf(z);
}

// act'(z); leaky_relu'(0) = 1, matching where(z >= 0, z, slope * z).
template <int ACT>
__device__ __forceinline__ float act_grad(float z, float p) {
  if (ACT == ACT_LEAKY_RELU) return z >= 0.f ? 1.f : p;
  const float t = tanhf(z);
  return (1.f + t) * (1.f - t);
}

// softmax over the row: y = exp(z - max z) / sum exp(z - max z)
template <int NF>
__device__ __forceinline__ void softmax_row(const float (&z)[NF],
                                            const bool (&ok)[NF],
                                            float (&y)[NF]) {
  float mx = __int_as_float((int)0xff800000u);  // -inf
#pragma unroll
  for (int j = 0; j < NF; ++j)
    if (ok[j]) mx = fmaxf(mx, z[j]);
  mx = warp_max(mx);
#pragma unroll
  for (int j = 0; j < NF; ++j) y[j] = ok[j] ? expf(z[j] - mx) : 0.f;
  const float s = row_sum(y, ok);
#pragma unroll
  for (int j = 0; j < NF; ++j) y[j] = y[j] / s;
}

// y = act(z) over the features a lane holds of one slot (a chunk of the
// row for an elementwise act, the whole row for a row-wise one).
template <int ACT, int NF>
__device__ __forceinline__ void act_row(const float (&z)[NF],
                                        const bool (&ok)[NF], int H, float p,
                                        float (&y)[NF]) {
  if (ACT == ACT_CENTERED_RELU) {
    const float c = p * (row_sum(z, ok) / (float)H);
#pragma unroll
    for (int j = 0; j < NF; ++j) y[j] = fmaxf(z[j] - c, 0.f);
  } else if (ACT == ACT_SOFTMAX) {
    softmax_row(z, ok, y);
  } else {
#pragma unroll
    for (int j = 0; j < NF; ++j) y[j] = act_fn<ACT>(z[j], p);
  }
}

// g_z = vjp(act, z)(g_m), g_m zero on the features past H. centered relu:
// d = g_m where m = z - c > 0 (relu'(0) = 0, as jax.nn.relu), then
// g_z = d - alpha * sum(d) / H; softmax: g_z = y * (g_m - sum(g_m * y)).
template <int ACT, int NF>
__device__ __forceinline__ void vjp_row(const float (&z)[NF],
                                        const float (&gm)[NF],
                                        const bool (&ok)[NF], int H, float p,
                                        float (&gz)[NF]) {
  if (ACT == ACT_CENTERED_RELU) {
    const float c = p * (row_sum(z, ok) / (float)H);
    float d[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) d[j] = z[j] - c > 0.f ? gm[j] : 0.f;
    const float sd = p * (row_sum(d, ok) / (float)H);
#pragma unroll
    for (int j = 0; j < NF; ++j) gz[j] = d[j] - sd;
  } else if (ACT == ACT_SOFTMAX) {
    float y[NF], gy[NF];
    softmax_row(z, ok, y);
#pragma unroll
    for (int j = 0; j < NF; ++j) gy[j] = gm[j] * y[j];
    const float dot = row_sum(gy, ok);
#pragma unroll
    for (int j = 0; j < NF; ++j) gz[j] = y[j] * (gm[j] - dot);
  } else {
#pragma unroll
    for (int j = 0; j < NF; ++j) gz[j] = act_grad<ACT>(z[j], p) * gm[j];
  }
}

template <int ACT, int NF, typename TK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
act_reduce_rw_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
                     const int* __restrict__ slot_src,
                     const float* __restrict__ scale,
                     const int* __restrict__ row_key,
                     const int* __restrict__ row_ptr, int R, int H, float p,
                     float* __restrict__ rows) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp leaves together
  const int s0 = row_ptr[r];
  const int s1 = row_ptr[r + 1];
  const float* eq_row = eq + (int64_t)row_key[r] * H;
  for (int f0 = 0; f0 < H; f0 += 32 * NF) {
    float q[NF], acc[NF];
    bool ok[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + j * 32 + lane;
      ok[j] = f < H;
      q[j] = ok[j] ? eq_row[f] : 0.f;
      acc[j] = 0.f;
    }
    for (int base = s0; base < s1; base += 32) {
      const int mine = base + lane;
      const int my_src = mine < s1 ? slot_src[mine] : 0;
      const float my_sc = mine < s1 ? scale[mine] : 0.f;
      const int n = min(32, s1 - base);
      for (int k = 0; k < n; ++k) {
        const int src = __shfl_sync(kFull, my_src, k);
        const float sc = __shfl_sync(kFull, my_sc, k);
        if (sc == 0.f) continue;  // warp-uniform
        const TK* ek_row = ek + (int64_t)src * H;
        float z[NF], y[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j)
          z[j] = ok[j] ? to_f32(ek_row[f0 + j * 32 + lane]) + q[j] : 0.f;
        act_row<ACT, NF>(z, ok, H, p, y);
#pragma unroll
        for (int j = 0; j < NF; ++j) acc[j] += y[j] * sc;
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (ok[j]) rows[(int64_t)r * H + f0 + j * 32 + lane] = acc[j];
  }
}

// The dst-major backward: g_eq rows (ell_geq_reduce), and with EMIT each
// slot's g_z in TG (ell_act_reduce_bwd). g [N, H] f32 is the cotangent of
// the aggregate, read through row_key.
template <int ACT, int NF, typename TK, typename TG, bool EMIT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
geq_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
           const float* __restrict__ g, const int* __restrict__ slot_src,
           const float* __restrict__ scale, const int* __restrict__ row_key,
           const int* __restrict__ row_ptr, int R, int H, float p,
           float* __restrict__ geq_rows, TG* __restrict__ g_slots) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;
  const int s0 = row_ptr[r];
  const int s1 = row_ptr[r + 1];
  const int64_t key = row_key[r];
  const float* eq_row = eq + key * H;
  const float* g_row = g + key * H;
  for (int f0 = 0; f0 < H; f0 += 32 * NF) {
    float q[NF], gr[NF], acc[NF];
    bool ok[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + j * 32 + lane;
      ok[j] = f < H;
      q[j] = ok[j] ? eq_row[f] : 0.f;
      gr[j] = ok[j] ? g_row[f] : 0.f;
      acc[j] = 0.f;
    }
    for (int base = s0; base < s1; base += 32) {
      const int mine = base + lane;
      const int my_src = mine < s1 ? slot_src[mine] : 0;
      const float my_sc = mine < s1 ? scale[mine] : 0.f;
      const int n = min(32, s1 - base);
      for (int k = 0; k < n; ++k) {
        const int src = __shfl_sync(kFull, my_src, k);
        const float sc = __shfl_sync(kFull, my_sc, k);
        TG* gs_row = g_slots + (int64_t)(base + k) * H + f0 + lane;
        if (sc == 0.f) {  // warp-uniform; g_z is 0
          if (EMIT) {
#pragma unroll
            for (int j = 0; j < NF; ++j)
              if (ok[j]) gs_row[j * 32] = from_f32<TG>(0.f);
          }
          continue;
        }
        const TK* ek_row = ek + (int64_t)src * H;
        float z[NF], gm[NF], gz[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          z[j] = ok[j] ? to_f32(ek_row[f0 + j * 32 + lane]) + q[j] : 0.f;
          gm[j] = gr[j] * sc;
        }
        vjp_row<ACT, NF>(z, gm, ok, H, p, gz);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          acc[j] += gz[j];
          if (EMIT && ok[j]) gs_row[j * 32] = from_f32<TG>(gz[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (ok[j]) geq_rows[(int64_t)r * H + f0 + j * 32 + lane] = acc[j];
  }
}

// The src-major backward with a full vjp. FUSED: eq is the [N, 2H] table
// whose row holds eq in [0, H) and g in [H, 2H), and g is unused.
template <int ACT, int NF, typename T, bool FUSED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
src_bwd_rw_kernel(const T* __restrict__ eq, const T* __restrict__ g,
                  const float* __restrict__ ek,
                  const int* __restrict__ slot_dst,
                  const float* __restrict__ scale,
                  const int* __restrict__ row_key,
                  const int* __restrict__ row_ptr, int R, int H, float p,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;
  const int s0 = row_ptr[r];
  const int s1 = row_ptr[r + 1];
  const float* ek_row = ek + (int64_t)row_key[r] * H;
  const int64_t stride = FUSED ? 2 * (int64_t)H : (int64_t)H;
  for (int f0 = 0; f0 < H; f0 += 32 * NF) {
    float kv[NF], acc[NF];
    bool ok[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + j * 32 + lane;
      ok[j] = f < H;
      kv[j] = ok[j] ? ek_row[f] : 0.f;
      acc[j] = 0.f;
    }
    for (int base = s0; base < s1; base += 32) {
      const int mine = base + lane;
      const int my_dst = mine < s1 ? slot_dst[mine] : 0;
      const float my_sc = mine < s1 ? scale[mine] : 0.f;
      const int n = min(32, s1 - base);
      for (int k = 0; k < n; ++k) {
        const int dst = __shfl_sync(kFull, my_dst, k);
        const float sc = __shfl_sync(kFull, my_sc, k);
        if (sc == 0.f) continue;  // warp-uniform
        const T* eq_row = eq + (int64_t)dst * stride;
        const T* g_row = FUSED ? eq_row + H : g + (int64_t)dst * H;
        float z[NF], gm[NF], gz[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = f0 + j * 32 + lane;
          z[j] = ok[j] ? to_f32(eq_row[f]) + kv[j] : 0.f;
          gm[j] = ok[j] ? to_f32(g_row[f]) * sc : 0.f;
        }
        vjp_row<ACT, NF>(z, gm, ok, H, p, gz);
#pragma unroll
        for (int j = 0; j < NF; ++j) acc[j] += gz[j];
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (ok[j]) out[(int64_t)r * H + f0 + j * 32 + lane] = acc[j];
  }
}

// Features a lane holds: a row-wise act takes the whole row in one pass
// (1, 2, 3, 4 or 8; 0 past H = 256), an elementwise act chunks of up to 128.
template <int ACT>
int feat_per_lane(int H) {
  const int nf = (H + 31) / 32;
  if (!Rowwise<ACT>::value) return nf < 4 ? nf : 4;
  if (nf <= 4) return nf;
  return nf <= 8 ? 8 : 0;
}

dim3 grid_for(int R) { return dim3((R + kWarpsPerBlock - 1) / kWarpsPerBlock); }

// LAUNCH(NF) for the NF that H needs; NF = 8 is built for row-wise acts only.
#define SIR_NF_SWITCH(ACT, H, LAUNCH)                  \
  switch (feat_per_lane<ACT>(H)) {                     \
    case 1: LAUNCH(1); break;                          \
    case 2: LAUNCH(2); break;                          \
    case 3: LAUNCH(3); break;                          \
    case 4: LAUNCH(4); break;                          \
    case 8:                                            \
      if constexpr (Rowwise<ACT>::value) {             \
        LAUNCH(8);                                     \
        break;                                         \
      }                                                \
      return (int)cudaErrorInvalidValue;               \
    default: return (int)cudaErrorInvalidValue;        \
  }

// CALL(ACT) for the runtime activation id.
#define SIR_ACT_SWITCH(act, CALL)                                  \
  switch (act) {                                                   \
    case ACT_LEAKY_RELU: return CALL(ACT_LEAKY_RELU);              \
    case ACT_TANH: return CALL(ACT_TANH);                          \
    case ACT_CENTERED_RELU: return CALL(ACT_CENTERED_RELU);        \
    case ACT_SOFTMAX: return CALL(ACT_SOFTMAX);                    \
    default: return (int)cudaErrorInvalidValue;                    \
  }

template <int ACT, typename TK>
int launch_act_reduce(const void* eq, const void* ek, const void* slot_src,
                      const void* scale, const void* row_key,
                      const void* row_ptr, int R, int H, float p, void* rows,
                      cudaStream_t st) {
#define SIR_LAUNCH(NF)                                                       \
  act_reduce_rw_kernel<ACT, NF, TK>                                          \
      <<<grid_for(R), kWarpsPerBlock * 32, 0, st>>>(                         \
          (const float*)eq, (const TK*)ek, (const int*)slot_src,             \
          (const float*)scale, (const int*)row_key, (const int*)row_ptr, R,  \
          H, p, (float*)rows)
  SIR_NF_SWITCH(ACT, H, SIR_LAUNCH)
#undef SIR_LAUNCH
  return (int)cudaGetLastError();
}

template <int ACT, typename TK, typename TG, bool EMIT>
int launch_geq(const void* eq, const void* ek, const void* g,
               const void* slot_src, const void* scale, const void* row_key,
               const void* row_ptr, int R, int H, float p, void* geq_rows,
               void* g_slots, cudaStream_t st) {
#define SIR_LAUNCH(NF)                                                       \
  geq_kernel<ACT, NF, TK, TG, EMIT>                                          \
      <<<grid_for(R), kWarpsPerBlock * 32, 0, st>>>(                         \
          (const float*)eq, (const TK*)ek, (const float*)g,                  \
          (const int*)slot_src, (const float*)scale, (const int*)row_key,    \
          (const int*)row_ptr, R, H, p, (float*)geq_rows, (TG*)g_slots)
  SIR_NF_SWITCH(ACT, H, SIR_LAUNCH)
#undef SIR_LAUNCH
  return (int)cudaGetLastError();
}

template <int ACT, typename T, bool FUSED>
int launch_src_bwd(const void* eq, const void* g, const void* ek,
                   const void* slot_dst, const void* scale,
                   const void* row_key, const void* row_ptr, int R, int H,
                   float p, void* out, cudaStream_t st) {
#define SIR_LAUNCH(NF)                                                       \
  src_bwd_rw_kernel<ACT, NF, T, FUSED>                                       \
      <<<grid_for(R), kWarpsPerBlock * 32, 0, st>>>(                         \
          (const T*)eq, (const T*)g, (const float*)ek, (const int*)slot_dst, \
          (const float*)scale, (const int*)row_key, (const int*)row_ptr, R,  \
          H, p, (float*)out)
  SIR_NF_SWITCH(ACT, H, SIR_LAUNCH)
#undef SIR_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted), or cudaErrorInvalidValue for an unknown act or a
// row-wise act with H > 256. Pointers are device pointers; eq, g (but in
// ell_src_bwd_*) and the row outputs are f32, the index arrays int32, the
// scales f32; `p` is the act's parameter (leaky_relu's slope, the centered
// relu's alpha).

// ek is f32, or bf16 when ek_bf16 != 0.
int ell_act_reduce_rowwise(const void* eq, const void* ek, int ek_bf16,
                           const void* slot_src, const void* scale,
                           const void* row_key, const void* row_ptr, int R,
                           int H, int act, float p, void* rows,
                           void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SIR_ARGS eq, ek, slot_src, scale, row_key, row_ptr, R, H, p, rows, st
#define SIR_CALL(A)                                              \
  (ek_bf16 ? launch_act_reduce<A, __nv_bfloat16>(SIR_ARGS)       \
           : launch_act_reduce<A, float>(SIR_ARGS))
  SIR_ACT_SWITCH(act, SIR_CALL)
#undef SIR_CALL
#undef SIR_ARGS
}

// ek is f32, or bf16 when ek_bf16 != 0; g [N, H] f32.
int ell_geq_reduce(const void* eq, const void* ek, int ek_bf16,
                   const void* g, const void* slot_src, const void* scale,
                   const void* row_key, const void* row_ptr, int R, int H,
                   int act, float p, void* geq_rows, void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SIR_ARGS \
  eq, ek, g, slot_src, scale, row_key, row_ptr, R, H, p, geq_rows, nullptr, st
#define SIR_CALL(A)                                                       \
  (ek_bf16 ? launch_geq<A, __nv_bfloat16, float, false>(SIR_ARGS)         \
           : launch_geq<A, float, float, false>(SIR_ARGS))
  SIR_ACT_SWITCH(act, SIR_CALL)
#undef SIR_CALL
#undef SIR_ARGS
}

// ell_geq_reduce plus g_slots [S, H], f32, or bf16 when gz_bf16 != 0.
int ell_act_reduce_bwd(const void* eq, const void* ek, int ek_bf16,
                       const void* g, const void* slot_src,
                       const void* scale, const void* row_key,
                       const void* row_ptr, int R, int H, int act, float p,
                       int gz_bf16, void* geq_rows, void* g_slots,
                       void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SIR_ARGS \
  eq, ek, g, slot_src, scale, row_key, row_ptr, R, H, p, geq_rows, g_slots, st
#define SIR_CALL(A)                                                          \
  (ek_bf16 ? (gz_bf16 ? launch_geq<A, __nv_bfloat16, __nv_bfloat16, true>(   \
                            SIR_ARGS)                                        \
                      : launch_geq<A, __nv_bfloat16, float, true>(SIR_ARGS)) \
           : (gz_bf16 ? launch_geq<A, float, __nv_bfloat16, true>(SIR_ARGS)  \
                      : launch_geq<A, float, float, true>(SIR_ARGS)))
  SIR_ACT_SWITCH(act, SIR_CALL)
#undef SIR_CALL
#undef SIR_ARGS
}

// eq and g share one type (f32, or bf16 when bf16 != 0); ek is f32.
int ell_src_bwd_rowwise(const void* eq, const void* g, int bf16,
                        const void* ek, const void* slot_dst,
                        const void* scale, const void* row_key,
                        const void* row_ptr, int R, int H, int act, float p,
                        void* out, void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SIR_ARGS eq, g, ek, slot_dst, scale, row_key, row_ptr, R, H, p, out, st
#define SIR_CALL(A)                                                   \
  (bf16 ? launch_src_bwd<A, __nv_bfloat16, false>(SIR_ARGS)           \
        : launch_src_bwd<A, float, false>(SIR_ARGS))
  SIR_ACT_SWITCH(act, SIR_CALL)
#undef SIR_CALL
#undef SIR_ARGS
}

// both [N, 2H] (eq | g) is f32, or bf16 when bf16 != 0; ek [N, H] f32.
int ell_src_bwd_fused(const void* both, int bf16, const void* ek,
                      const void* slot_dst, const void* scale,
                      const void* row_key, const void* row_ptr, int R, int H,
                      int act, float p, void* out, void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SIR_ARGS \
  both, nullptr, ek, slot_dst, scale, row_key, row_ptr, R, H, p, out, st
#define SIR_CALL(A)                                                   \
  (bf16 ? launch_src_bwd<A, __nv_bfloat16, true>(SIR_ARGS)            \
        : launch_src_bwd<A, float, true>(SIR_ARGS))
  SIR_ACT_SWITCH(act, SIR_CALL)
#undef SIR_CALL
#undef SIR_ARGS
}

const char* ell_general_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
