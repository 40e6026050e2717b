// ELL kernels of the general sigma route for Hopper (sm_90a), with a plain C
// interface bound from Python through ctypes
// (sir_gcn_tpu_torch/ops/cuda/kernels.py).
//
// A row-wise sigma couples the H features of one slot (its Jacobian is not
// diagonal), so the elementwise route's derivative mass does not exist for
// it and every backward needs a full vector-Jacobian product (vjp). The
// kernels here take any sigma of the registry: leaky_relu, tanh and
// erf-GELU elementwise, centered_relu (relu(z - alpha * mean_H(z))) and
// softmax over H row-wise, at any H. As in ell_kernels.cu, row r owns slots
// [row_ptr[r], row_ptr[r+1]) and reads its key's row through row_key[r];
// node rows are gathered by index inside the kernels, all buckets in one
// launch.
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
// The edge-term forms of the first three (``*_edge``) add an edge table e
// [E_pad, H] in sorted-edge order, of the gathered table's type, read by
// index through the plan's slot_edge: the key side of a forward slot is
// add_cast(ek[slot_src[s]], e[slot_edge[s]]), the dst side of a backward
// slot add_cast(eq[slot_dst[s]], e[slot_edge[s]]), added in f32 and rounded
// to the gathered type, as ell_kernels.cu's edge forms round it.
// ell_src_bwd_rowwise_edge also writes each slot's g_z (rounded to eq's
// type, stored in f32) into row slot_edge[s] of the per-edge cotangent g_e;
// each valid edge has one src slot, so no two slots write one row, and the
// wrapper zeroes the rows no slot writes (padding edges, zero-scale slots).
//
// They replace the Pallas kernels bucket_bcast_act_reduce on the general
// route, bucket_geq_reduce, bucket_bcast_act_reduce_bwd, bucket_src_bwd with
// a full vjp (its per-slot g_z output, taken through _edge_cotangent, in
// the edge form), and bucket_src_bwd_fused (sir_gcn_tpu/ops/pallas/
// kernels.py, driven by sir_gcn_tpu/ops/ell.py
// make_ell_sir_aggregate_pallas, with_edge or not).
//
// Bound: device-memory bytes, as for the linear kernels: each slot costs one
// random H-wide row read (two in ell_src_bwd_rowwise, one 2H-wide row in
// ell_src_bwd_fused, an H-wide g_slots row write besides in
// ell_act_reduce_bwd) and some ten flops per feature.
//
// The first design (where the lane-group path below cannot go: H past
// 256 in #6 and past 512 in #1r, #3, #4r and #5, rows that are not
// whole 16-byte chunks, a table off 16-byte alignment, an elementwise sigma
// but in #5, #6's g_slots in another type than ek): one warp per row, 8
// rows per block; the lanes load 32 slot
// indices (and edge ids) and scales at a time and pass them round with
// warp shuffles. A row-wise sigma needs a slot's whole row at once: up to
// H = 512 each lane keeps NF = 1, 2, 3, 4, 8 or 16 features (NF * 32 >= H)
// in registers, and a slot costs one warp reduction (__shfl_xor_sync) for
// the centered relu's mean (two in its vjp) and two for softmax's max and
// sum (three in its vjp). An elementwise sigma walks the features in
// chunks of up to 128, so any H is taken. Past H = 256 a row-wise sigma
// the lane-group path does not take goes to the wide path: up to 512 the
// row in registers as above (16 features a lane; #6, and #1r, #3, #4r
// and #5 on rows that are not whole 16-byte chunks), and past 512 the
// features are walked in chunks of 256 (8 a lane), and for each chunk a
// slot's statistics (the mean; the max and the sum; the vjps' second sum
// or dot) come from passes over its whole row, lane j taking features j,
// j + 32, ..., each value read again from memory (the L1 or the L2 holds
// the rows just read) and recomputed as the chunk computes it; then the
// chunk's values are formed from them. It has no ceiling in H: a row costs
// ceil(H / 256) times (one to three passes plus one) reads of the slot's
// rows. (At H = 512 in bf16 on an H100 the passes took 27.4 ms for #4r at
// the arxiv plan, PERF.md.) A slot with scale 0 is skipped whole (the test
// is warp-uniform): it contributes exactly 0, and ell_act_reduce_bwd writes
// its g_slots row as 0. All sums are f32. The slots of a row are walked one
// at a time, each an exposed gather latency and a chain of dependent
// shuffles.
//
// The lane-group path (group_kernel), one template for five kernels, each a
// compile-time mode: ell_act_reduce_rowwise (#1r, the forward, a row-wise
// sigma), ell_geq_reduce (#3) and ell_src_bwd_rowwise (#4r) for a row-wise
// sigma, each also in its edge form (a compile-time flag: the slot's edge
// row gathered beside its node row, by 16-byte chunks too, and #4r's g_z
// stored into g_e by 16-byte stores from the group's chunks),
// ell_src_bwd_fused (#5) for any sigma (an elementwise one's vjp,
// act'(z) * g_m, needs no reduction), and ell_act_reduce_bwd (#6, #3's
// walk plus a g_slots row stored a slot) for a row-wise sigma. It takes
// rows whose H *
// sizeof(T) is a multiple of 16 (so #5's second half starts 16-byte
// aligned too) with every table 16-byte aligned (T the gathered type), up
// to H = 256, and in #1r, #3, #4r (and their edge forms) and #5 up to H =
// 512: a
// gathered row is C = H * sizeof(T) / 16 chunks of 16 bytes (12 at H = 96
// in bf16, 24 in f32; 64 and 128 at 512). A group of GW lanes (a power of
// two) holds one slot's whole row, lane j of a group chunks j, j + GW, ...,
// so a warp works on G = 32 / GW slots at once, each group on its own. GW
// is the narrowest power of two that leaves a lane at most 4 chunks and
// group_max_values values of a row: 16 in the vjps (at H = 96 groups of 8
// lanes, 2 chunks a lane in bf16 with 4 of 16 chunk places idle, 3 in f32
// with every lane busy) and in the forward's edge form, which gathers a
// second row a slot, 24 in the forward, which holds no cotangent row
// (in bf16 groups of 4 lanes, 3 chunks each, every lane busy). Past H =
// 256 the group is the whole warp (G = 1; in #1r's bf16 form from 392):
// at 512 in bf16 2 chunks and 16 values a lane, at 512 in f32 4 chunks and
// 16 values, the footprints of H = 96 in bf16 and of H = 256 in f32; the
// shapes with the most rows in flight run uncapped on 8 warps an SM
// (group_min_blocks); the key rows take 4 KB of
// shared memory a warp at 512, #3's two 8 KB (64 KB a block, past the 48
// KB a launch has unless the kernel's limit is raised, which
// launch_group_k does before its occupancy query and launch). The
// row-wise reductions are a pairwise tree over the lane's values followed
// by an xor butterfly over the group (lanes past the row hold values that
// add 0 to a sum and -inf to a max; every lane of a group ends with the
// same bits). Every lane runs every slot of its group: a zero-scale slot,
// or a group past the row's last slot, runs with scale 0 and adds exactly
// 0 (for finite inputs), so no shuffle sits under a branch that some
// groups skip; at G = 1 a zero-scale slot issues no gather (its values are
// then 0 and the key row's, which keeps every sum finite), so a padding
// slot costs no row read, as in the first design. The scale
// multiplies each slot's vjp, which is linear in its cotangent, or its
// act(z) in the forward; the centered relu's mean
// is a sum times 1 / H, softmax takes __expf (a few ulp) and one
// reciprocal a slot, tanh' one __expf and one fast division, and erf-GELU'
// the elementwise kernels' form (see group_act_grad).
//
// The kernels are persistent (warp w of W takes rows w, w + W, ...) and walk a
// warp's slots as a stream of batches of one slot a group (two need registers
// that spill under the cap of 128 a thread that keeps 16 warps an SM, or,
// uncapped, halve the warps; at G = 1 one batch is one slot, the next slot's
// rows in flight while one is worked): the gathers of the next batch, of this
// row or the next, are issued before the current batch is worked, the group
// width is a template parameter (its butterflies unrolled; only the widths and
// chunk counts group_layout gives are built), the next row's slot range, key
// and first 32 slot indices and scales are loaded a row ahead, and its f32 key
// rows (eq for #1r; eq and g for #3; ek for #4r and #5) are copied into the
// warp's shared memory by cp.async when its first batch is issued; #6 stores
// each slot's g_z row from the group's chunks by 16-byte evict-first stores
// (st.global.cs). Each group sums its slots in slot order in f32; at the end of
// the row the groups' sums are added by an xor butterfly over the groups in
// reduce-scatter form (RowEnd), a fixed order (with one group no butterfly),
// and each lane stores the part of the row it ends with. No atomics: two
// launches give the same bits; #6's rows are #3's bits (the same walk and row
// end).
// ell_general_layout reports the path a launch takes.
//
// What bounds each at the arxiv plan (H = 96, bf16): #4r gathers two bf16
// rows a slot from eq and g, and #5 one 384-byte row of [eq | g], 65 MB of
// tables either way, more than the 50 MB L2, so their floor is HBM's rate
// for random rows (on an H100 SXM at 700 W, #5 with leaky_relu reads its
// 1,020 MB of rows at some 3.1 TB/s); #3 and #1r gather ek, 32.5 MB, which the L2 holds, and are
// held by the SM's instruction issue and the gathers' latency at 16 warps
// an SM: per row a key-row copy and the row end's butterfly, per batch
// the cursor's bookkeeping, besides the slots' arithmetic. #6 is #3's walk
// plus 510 MB of bf16 g_slots written (0.152 ms at 3.35 TB/s); on an H100
// the stream adds its own time to the walk's rather than hide under it
// (0.30 ms without the stores, 0.35 with stores the L2 absorbs, 0.46 with
// the real ones; L2 policies and one bulk copy a batch did not help,
// PERF.md). At H = 512 every node table passes the L2 (173 MB in bf16), so
// #1r and #4r read each valid slot's rows from device memory: their floor
// is those rows, the key rows and the output once at HBM's rate (about
// 0.98 and 1.74 ms in bf16 at the arxiv plan, 1.08 for #3), and with one
// slot a warp in flight, 16 warps an SM (8 for the shapes that run
// uncapped), they take 1.09-1.24 times it in bf16 on an H100 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The build compiles this file in five parts at once (ops/cuda/build.py),
// part k with -DSIR_GENERAL_PART=k keeping only its C entries and so only
// the kernels they launch: 0 #1r and its edge form, 1 #3 and its edge
// form, 2 #6, 3 #4r and its edge form, 4 #5 and the layout queries. Built
// as one file (without the macro), it keeps every entry.
#ifdef SIR_GENERAL_PART
#define SIR_IN_PART(k) (SIR_GENERAL_PART == (k))
#else
#define SIR_IN_PART(k) 1
#endif

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
// The lane-group path: the values of a gathered row a lane holds at most
// (the group is made just wide enough; the vjps, and the forward, which
// holds no cotangent row), the slots a group has in flight in a batch, and
// the blocks an SM must fit (the register cap of __launch_bounds__).
constexpr int kMaxValuesPerLane = 16;
constexpr int kMaxValuesPerLaneFwd = 24;
constexpr int kGroupInflight = 1;
constexpr int kGroupMinBlocks = 2;

// Activation ids, as registered in sir_gcn_tpu_torch/ops/ell.py.
enum {
  ACT_LEAKY_RELU = 0,
  ACT_TANH = 1,
  ACT_CENTERED_RELU = 2,
  ACT_SOFTMAX = 3,
  ACT_GELU = 4
};

template <int ACT>
struct Rowwise {
  static constexpr bool value = ACT == ACT_CENTERED_RELU || ACT == ACT_SOFTMAX;
};

// The lane-group path takes rows up to kRowMax, and in #1r, #3, #4r (and
// their edge forms) and #5 up to kRowRegMax on groups of up to 32 lanes; a
// row-wise act past what the lane-group path takes goes to the wide path of
// the first design: the row in a warp's registers up to kRowRegMax, passes
// over it past.
constexpr int kRowMax = 256;
constexpr int kRowRegMax = 512;

// erf-GELU as ell_kernels.cu computes it (jax.nn.gelu(approximate=False)):
// z * Phi(z) with Phi(z) = 0.5 * erfc(-z / sqrt(2)), and gelu'(z) = Phi(z)
// + z * exp(-z^2 / 2) / sqrt(2 pi).
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

// Feature f of a gathered row widened to f32, with the slot's edge row added
// in f32 and rounded to T (ell.py's add_cast) where there is one (e_row not
// null).
template <typename T>
__device__ __forceinline__ float gathered(const T* row, const T* e_row,
                                          int f) {
  return e_row != nullptr ? round_to<T>(to_f32(row[f]) + to_f32(e_row[f]))
                          : to_f32(row[f]);
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

// False for every id: the static_assert of an elementwise activation id
// that has no branch in act_fn, act_grad or group_act_grad fails the build
// (the row-wise ids take act_row, vjp_row and vjp_group's own branches).
template <int ACT>
constexpr bool kNoBranch = false;

template <int ACT>
__device__ __forceinline__ float act_fn(float z, float p) {
  if constexpr (ACT == ACT_LEAKY_RELU) {
    return z >= 0.f ? z : p * z;
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
__device__ __forceinline__ float act_grad(float z, float p) {
  if constexpr (ACT == ACT_LEAKY_RELU) {
    return z >= 0.f ? 1.f : p;
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
  if constexpr (ACT == ACT_CENTERED_RELU) {
    const float c = p * (row_sum(z, ok) / (float)H);
#pragma unroll
    for (int j = 0; j < NF; ++j) y[j] = fmaxf(z[j] - c, 0.f);
  } else if constexpr (ACT == ACT_SOFTMAX) {
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
  if constexpr (ACT == ACT_CENTERED_RELU) {
    const float c = p * (row_sum(z, ok) / (float)H);
    float d[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) d[j] = z[j] - c > 0.f ? gm[j] : 0.f;
    const float sd = p * (row_sum(d, ok) / (float)H);
#pragma unroll
    for (int j = 0; j < NF; ++j) gz[j] = d[j] - sd;
  } else if constexpr (ACT == ACT_SOFTMAX) {
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

// The wide path's statistics of one slot's row (a row-wise act past
// kRowMax): a is centered_relu's shift c = alpha * mean(z), or softmax's
// max; b softmax's sum of exp(z - max); c the vjps' second statistic,
// centered_relu's alpha * mean(d) (d = g_m where z - c > 0) or softmax's
// dot(g_m, y). zf(f) and gf(f) give z and g_m at feature f of the row; lane
// j takes features j, j + 32, ..., and every lane ends with the same bits.
struct RowStats {
  float a, b, c;
};

template <int ACT, bool VJP, typename ZF, typename GF>
__device__ __forceinline__ RowStats wide_stats(int H, float p, int lane,
                                               ZF zf, GF gf) {
  RowStats st{0.f, 1.f, 0.f};
  if constexpr (ACT == ACT_CENTERED_RELU) {
    float s = 0.f;
    for (int f = lane; f < H; f += 32) s += zf(f);
    st.a = p * (warp_sum(s) / (float)H);
    if constexpr (VJP) {
      float d = 0.f;
      for (int f = lane; f < H; f += 32)
        if (zf(f) - st.a > 0.f) d += gf(f);
      st.c = p * (warp_sum(d) / (float)H);
    }
  } else if constexpr (ACT == ACT_SOFTMAX) {
    float mx = __int_as_float((int)0xff800000u);  // -inf
    for (int f = lane; f < H; f += 32) mx = fmaxf(mx, zf(f));
    st.a = warp_max(mx);
    float s = 0.f;
    for (int f = lane; f < H; f += 32) s += expf(zf(f) - st.a);
    st.b = warp_sum(s);
    if constexpr (VJP) {
      float dot = 0.f;
      for (int f = lane; f < H; f += 32)
        dot += gf(f) * (expf(zf(f) - st.a) / st.b);
      st.c = warp_sum(dot);
    }
  } else {
    static_assert(kNoBranch<ACT>, "the wide path is for a row-wise act");
  }
  return st;
}

// act(z) and vjp(act, z)(g_m) at one feature on the wide path, from the
// row's statistics, as act_row and vjp_row form them.
template <int ACT>
__device__ __forceinline__ float wide_act(float z, const RowStats& st) {
  if constexpr (ACT == ACT_CENTERED_RELU) return fmaxf(z - st.a, 0.f);
  return expf(z - st.a) / st.b;
}

template <int ACT>
__device__ __forceinline__ float wide_vjp(float z, float gm,
                                          const RowStats& st) {
  if constexpr (ACT == ACT_CENTERED_RELU)
    return (z - st.a > 0.f ? gm : 0.f) - st.c;
  const float y = expf(z - st.a) / st.b;
  return y * (gm - st.c);
}

// The forward. e, slot_edge: the edge form's (null without an edge term).
// WIDE: the wide path (NF = 8 features a lane a chunk).
template <int ACT, int NF, bool WIDE, typename TK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
act_reduce_rw_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
                     const TK* __restrict__ e,
                     const int* __restrict__ slot_src,
                     const int* __restrict__ slot_edge,
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
      const int my_edge = e != nullptr && mine < s1 ? slot_edge[mine] : 0;
      const float my_sc = mine < s1 ? scale[mine] : 0.f;
      const int n = min(32, s1 - base);
      for (int k = 0; k < n; ++k) {
        const int src = __shfl_sync(kFull, my_src, k);
        const float sc = __shfl_sync(kFull, my_sc, k);
        const int edge = e != nullptr ? __shfl_sync(kFull, my_edge, k) : 0;
        if (sc == 0.f) continue;  // warp-uniform
        const TK* ek_row = ek + (int64_t)src * H;
        const TK* e_row = e != nullptr ? e + (int64_t)edge * H : nullptr;
        float z[NF], y[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j)
          z[j] = ok[j] ? gathered(ek_row, e_row, f0 + j * 32 + lane) + q[j]
                       : 0.f;
        if constexpr (WIDE) {
          const RowStats st = wide_stats<ACT, false>(
              H, p, lane,
              [&](int f) { return gathered(ek_row, e_row, f) + eq_row[f]; },
              [](int) { return 0.f; });
#pragma unroll
          for (int j = 0; j < NF; ++j) y[j] = wide_act<ACT>(z[j], st);
        } else {
          act_row<ACT, NF>(z, ok, H, p, y);
        }
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
// the aggregate, read through row_key. e, slot_edge as in the forward.
template <int ACT, int NF, bool WIDE, typename TK, typename TG, bool EMIT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
geq_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
           const TK* __restrict__ e, const float* __restrict__ g,
           const int* __restrict__ slot_src,
           const int* __restrict__ slot_edge,
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
      const int my_edge = e != nullptr && mine < s1 ? slot_edge[mine] : 0;
      const float my_sc = mine < s1 ? scale[mine] : 0.f;
      const int n = min(32, s1 - base);
      for (int k = 0; k < n; ++k) {
        const int src = __shfl_sync(kFull, my_src, k);
        const float sc = __shfl_sync(kFull, my_sc, k);
        const int edge = e != nullptr ? __shfl_sync(kFull, my_edge, k) : 0;
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
        const TK* e_row = e != nullptr ? e + (int64_t)edge * H : nullptr;
        float z[NF], gm[NF], gz[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          z[j] = ok[j] ? gathered(ek_row, e_row, f0 + j * 32 + lane) + q[j]
                       : 0.f;
          gm[j] = gr[j] * sc;
        }
        if constexpr (WIDE) {
          const RowStats st = wide_stats<ACT, true>(
              H, p, lane,
              [&](int f) { return gathered(ek_row, e_row, f) + eq_row[f]; },
              [&](int f) { return g_row[f] * sc; });
#pragma unroll
          for (int j = 0; j < NF; ++j) gz[j] = wide_vjp<ACT>(z[j], gm[j], st);
        } else {
          vjp_row<ACT, NF>(z, gm, ok, H, p, gz);
        }
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
// whose row holds eq in [0, H) and g in [H, 2H), and g is unused. e,
// slot_edge as in the forward (the dst side's edge row); with them each
// slot's g_z, rounded to T, goes into row slot_edge[s] of g_e.
template <int ACT, int NF, bool WIDE, typename T, bool FUSED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
src_bwd_rw_kernel(const T* __restrict__ eq, const T* __restrict__ g,
                  const T* __restrict__ e, const float* __restrict__ ek,
                  const int* __restrict__ slot_dst,
                  const int* __restrict__ slot_edge,
                  const float* __restrict__ scale,
                  const int* __restrict__ row_key,
                  const int* __restrict__ row_ptr, int R, int H, float p,
                  float* __restrict__ out, float* __restrict__ g_e) {
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
      const int my_edge = e != nullptr && mine < s1 ? slot_edge[mine] : 0;
      const float my_sc = mine < s1 ? scale[mine] : 0.f;
      const int n = min(32, s1 - base);
      for (int k = 0; k < n; ++k) {
        const int dst = __shfl_sync(kFull, my_dst, k);
        const float sc = __shfl_sync(kFull, my_sc, k);
        const int edge = e != nullptr ? __shfl_sync(kFull, my_edge, k) : 0;
        // a zero-scale slot writes no g_e row: its g_z is 0, and the row
        // stays the wrapper's 0
        if (sc == 0.f) continue;  // warp-uniform
        const T* eq_row = eq + (int64_t)dst * stride;
        const T* g_row = FUSED ? eq_row + H : g + (int64_t)dst * H;
        const T* e_row = e != nullptr ? e + (int64_t)edge * H : nullptr;
        float z[NF], gm[NF], gz[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = f0 + j * 32 + lane;
          z[j] = ok[j] ? gathered(eq_row, e_row, f) + kv[j] : 0.f;
          gm[j] = ok[j] ? to_f32(g_row[f]) * sc : 0.f;
        }
        if constexpr (WIDE) {
          const RowStats st = wide_stats<ACT, true>(
              H, p, lane,
              [&](int f) { return gathered(eq_row, e_row, f) + ek_row[f]; },
              [&](int f) { return to_f32(g_row[f]) * sc; });
#pragma unroll
          for (int j = 0; j < NF; ++j) gz[j] = wide_vjp<ACT>(z[j], gm[j], st);
        } else {
          vjp_row<ACT, NF>(z, gm, ok, H, p, gz);
        }
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          acc[j] += gz[j];
          if (e_row != nullptr && ok[j])
            g_e[(int64_t)edge * H + f0 + j * 32 + lane] = round_to<T>(gz[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (ok[j]) out[(int64_t)r * H + f0 + j * 32 + lane] = acc[j];
  }
}

// ---------------------------------------------------------------------
// The lane-group path of #3 and #4r
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

// A row's slot range and key, and one lane's slot of a run of 32: what a
// warp loads ahead of the row it works on.
struct Head {
  int s0, s1, key;
};
struct Slot {
  int node, edge;  // edge: the edge forms' sorted-edge id
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

// Slot base + lane of a row ending at s1 (zeros past it), with its edge id
// in the edge forms (EDGE).
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

// Butterflies over the aligned groups of GW lanes (a power of two): every
// lane of a group ends with the same bits.
template <int GW>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = GW / 2; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int GW>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = GW / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A pairwise tree over a lane's NV values: a chain of log2 NV operations,
// not NV.
template <int NV>
__device__ __forceinline__ float tree_sum(const float (&x)[NV]) {
  float t[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) t[j] = x[j];
#pragma unroll
  for (int w = 1; w < NV; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < NV; j += 2 * w) t[j] += t[j + w];
  }
  return t[0];
}

template <int NV>
__device__ __forceinline__ float tree_max(const float (&x)[NV]) {
  float t[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) t[j] = x[j];
#pragma unroll
  for (int w = 1; w < NV; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < NV; j += 2 * w) t[j] = fmaxf(t[j], t[j + w]);
  }
  return t[0];
}

// act'(z) of an elementwise act on the lane-group path. tanh'(z) =
// 1 / cosh(z)^2 = 4 e / (1 + e)^2 with e = exp(-2 |z|) in (0, 1]: one
// __expf and one fast division, no cancellation (a relative error of a few
// ulp of e, some 1e-6 at |z| = 5), where tanhf and (1 + t)(1 - t) take a
// branch and some twenty instructions; leaky_relu and erf-GELU as act_grad
// (erf-GELU's the elementwise kernels' form).
template <int ACT>
__device__ __forceinline__ float group_act_grad(float z, float p) {
  if constexpr (ACT == ACT_LEAKY_RELU || ACT == ACT_GELU) {
    return act_grad<ACT>(z, p);
  } else if constexpr (ACT == ACT_TANH) {
    const float e = __expf(-2.f * fabsf(z));
    const float d = 1.f + e;
    return __fdividef(4.f * e, d * d);
  } else {
    static_assert(kNoBranch<ACT>, "an activation id without a branch");
    return 0.f;
  }
}

// v = vjp(act, z)(gs) for one slot whose row is spread over a group of GW
// lanes: gs is the slot's cotangent before its scale (the vjp is linear in
// it, so the scale multiplies v instead). inv_h = 1 / H. A lane's values
// past the row hold z = 0 (centered_relu, an elementwise act) or -inf
// (softmax) and gs = 0, so that they add nothing to a sum or a max.
// Straight-line code: the slots a lane has in flight interleave.
template <int ACT, int GW, int NV>
__device__ __forceinline__ void vjp_group(const float (&z)[NV],
                                          const float (&gs)[NV], float inv_h,
                                          float p, float (&v)[NV]) {
  if constexpr (!Rowwise<ACT>::value) {  // g_z = act'(z) * g_m
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] = group_act_grad<ACT>(z[j], p) * gs[j];
  } else if constexpr (ACT == ACT_CENTERED_RELU) {
    // d = g_m where z - c > 0 (relu'(0) = 0), g_z = d - alpha * mean(d)
    const float c = p * (group_sum<GW>(tree_sum(z)) * inv_h);
    float d[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) d[j] = z[j] > c ? gs[j] : 0.f;
    const float sd = p * (group_sum<GW>(tree_sum(d)) * inv_h);
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] = d[j] - sd;
  } else {  // ACT_SOFTMAX: g_z = y * (g_m - sum(g_m * y))
    const float mx = group_max<GW>(tree_max(z));
    float y[NV], gy[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) y[j] = __expf(z[j] - mx);
    const float inv_s = __frcp_rn(group_sum<GW>(tree_sum(y)));
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      y[j] *= inv_s;
      gy[j] = gs[j] * y[j];
    }
    const float dot = group_sum<GW>(tree_sum(gy));
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] = y[j] * (gs[j] - dot);
  }
}

// acc += w * vjp(act, z)(gs), vjp_group's v scaled by the slot's scale w.
template <int ACT, int GW, int NV>
__device__ __forceinline__ void add_vjp_group(const float (&z)[NV],
                                              const float (&gs)[NV],
                                              float w, float inv_h, float p,
                                              float (&acc)[NV]) {
  float v[NV];
  vjp_group<ACT, GW, NV>(z, gs, inv_h, p, v);
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = fmaf(w, v[j], acc[j]);
}

// acc += w * act(z) for one slot whose row is spread over a group of GW
// lanes (the forward of a row-wise act), with add_vjp_group's conventions:
// centered_relu takes one butterfly (the mean), softmax two (the max, then
// the sum). A value past the row adds act(z) to an accumulator that is
// never stored, and nothing to a sum or a max.
template <int ACT, int GW, int NV>
__device__ __forceinline__ void add_act_group(const float (&z)[NV], float w,
                                              float inv_h, float p,
                                              float (&acc)[NV]) {
  if (ACT == ACT_CENTERED_RELU) {
    const float c = p * (group_sum<GW>(tree_sum(z)) * inv_h);
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = fmaf(w, fmaxf(z[j] - c, 0.f), acc[j]);
  } else {  // ACT_SOFTMAX: y = exp(z - max z) / sum exp(z - max z)
    const float mx = group_max<GW>(tree_max(z));
    float y[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) y[j] = __expf(z[j] - mx);
    const float inv_s = __frcp_rn(group_sum<GW>(tree_sum(y)));
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = fmaf(w, y[j] * inv_s, acc[j]);
  }
}

// The lane-group kernels, by what a slot gathers (T, by slot_idx), the
// f32 key rows of its row (by row_key) and what it adds; MODE is also the
// kernel's id in ell_general_layout.
enum {
  MODE_GEQ = 0,    // #3:  a = ek; ka = eq, kg = g; vjp(act, z)(scale * g_r)
  MODE_SRC = 1,    // #4r: a = eq, ga = g; ka = ek; vjp(act, z)(scale * g_b)
  MODE_FWD = 2,    // #1r: a = ek; ka = eq; scale * act(z)
  MODE_FUSED = 3,  // #5:  #4r with a = both, ga = both + H, rows 2H apart
  MODE_EMIT = 4,   // #6:  #3, and each slot's scale * vjp into g_slots
};

// The values of a gathered row a lane holds at most, by mode and whether
// it is an edge form (the forward's gathers a second row a slot).
constexpr int group_max_values(int mode, bool edge) {
  return mode == MODE_FWD && !edge ? kMaxValuesPerLaneFwd : kMaxValuesPerLane;
}

// The widest row the lane-group path takes in a mode: kRowRegMax in #1r,
// #3, #4r and #5 (full-warp groups, G = 1, past kRowMax; #3's two f32 key
// rows take 64 KB of a block's dynamic shared memory at 512, set by
// launch_group_k; #5 gathers #4r's two rows as the halves of one [N, 2H]
// row, so its instances are #4r's, rows 2H apart), kRowMax in #6 (which
// also stores a g_slots row a slot).
constexpr int group_row_max(int mode) {
  return mode == MODE_EMIT ? kRowMax : kRowRegMax;
}

// The blocks an SM a lane-group kernel asks room for (__launch_bounds__):
// kGroupMinBlocks, 16 warps under a cap of 128 registers a thread, or 1
// (8 warps, no cap) for a full-warp shape whose two batches of gathered
// rows take 48 registers a lane or more (#4r·e; #4r, #5, #1r·e and #3·e with
// K = 3 or 4 f32 chunks): under the cap #1r's and #4r's spill 116-572
// bytes, and at H = 512 on an H100 they ran 1.1-1.9x faster
// uncapped, where the others tied or lost up to 1.2x. #3 with K = 4 f32
// chunks and #3·e in bf16 spill 36 and 68-96 bytes under the cap and still
// ran 1.14-1.21x faster there than uncapped (PERF.md).
constexpr int group_min_blocks(int gw, int k, int mode, bool edge) {
  const int rows = 1 + (mode == MODE_SRC || mode == MODE_FUSED) + edge;
  return gw == 32 && 2 * k * 4 * rows >= 48 ? 1 : kGroupMinBlocks;
}

// Whether the lane-group path takes `act` in `mode`: a row-wise act in
// every mode; an elementwise one (its vjp, act'(z) * g_m, needs no
// reduction) in #5 only (#6's lane path ran within 1.3% of its first
// design under leaky_relu and tanh on an H100, PERF.md).
constexpr bool group_takes(int mode, int act) {
  return act == ACT_CENTERED_RELU || act == ACT_SOFTMAX ||
         (mode == MODE_FUSED && (act == ACT_LEAKY_RELU || act == ACT_TANH ||
                                 act == ACT_GELU));
}

// Whether a mode takes `act` past kRowMax, on groups of the whole warp,
// for gathered values of `bytes` bytes: as group_takes, but #5 in f32
// under leaky_relu or tanh keeps the first design's passes of 128 columns,
// which ran 2.4-2.8% faster than the groups at H = 512 on an H100, where
// in bf16 the groups won 1.11x and under erf-GELU 1.9x in both types
// (PERF.md).
constexpr bool group_wide_takes(int mode, int act, int bytes) {
  return group_takes(mode, act) &&
         !(mode == MODE_FUSED && bytes == 4 &&
           (act == ACT_LEAKY_RELU || act == ACT_TANH));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 16 bytes written once, evict-first in L1 and L2 (st.global.cs): #6's
// [S, H] g_slots stream.
__device__ __forceinline__ void store16_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Vec<T>::N f32 values narrowed to T (bf16 rounded to nearest even, as
// astype(bf16)), 16 bytes.
__device__ __forceinline__ uint4 narrow16(const float* f, __nv_bfloat16*) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 narrow16(const float* f, float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// The end of a row on the lane-group path: the G groups' partial rows (a
// lane's L live values v, the first of them its value `base` of NV) added
// over the groups and stored, by an xor butterfly over the groups in
// reduce-scatter form. In the round of offset O a lane keeps the half of
// its live values that its lane bit O picks, adds the partner's partials
// of them and passes the other half on, so a round moves half the values
// of the one before; a round with an odd count adds them all, and of the
// groups that then hold the same values only those with the bit clear
// (none in DUP) store them. Each sum adds the same two partials in the same
// order as a plain all-reduce butterfly (mine + the partner's), so the
// row's bits are the all-reduce's. A lane's value j is feature (gl + GW (j /
// EPV)) EPV + j % EPV of the row, gl its place in its group, stored where
// that chunk is below C.
template <int L, int O, int DUP, int GW, int EPV>
struct RowEnd {
  static __device__ __forceinline__ void run(const float (&v)[L], int base,
                                             int lane, int C,
                                             float* __restrict__ out_row) {
    if constexpr (O < 32 && L % 2 == 0) {
      constexpr int h = L / 2;
      const bool hi = lane & O;
      float w[h];
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = hi ? v[i] : v[h + i];
        const float keep = hi ? v[h + i] : v[i];
        w[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      RowEnd<h, 2 * O, DUP, GW, EPV>::run(w, base + (hi ? h : 0), lane, C,
                                          out_row);
    } else if constexpr (O < 32) {
      float w[L];
#pragma unroll
      for (int i = 0; i < L; ++i)
        w[i] = v[i] + __shfl_xor_sync(kFull, v[i], O);
      RowEnd<L, 2 * O, DUP | O, GW, EPV>::run(w, base, lane, C, out_row);
    } else {
      if (lane & DUP) return;
      const int gl = lane & (GW - 1);
      constexpr int STEP = L % 4 == 0 ? 4 : 1;  // float4 stores where whole
#pragma unroll
      for (int i = 0; i < L; i += STEP) {
        const int j = base + i, c = gl + GW * (j / EPV);
        if (c >= C) continue;
        float* at = out_row + c * EPV + j % EPV;
        if constexpr (STEP == 4)
          *reinterpret_cast<float4*>(at) =
              make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
        else
          *at = v[i];
      }
    }
  }
};

// out[r] = sum_s of a slot's term at z_s = a[slot_idx[s]] + ka[row_key[r]]
// (MODE above): the vjp modes add vjp(act, z_s)(g_m), g_m = scale[s] times
// the gathered ga row (#4r, #5) or the key's kg row (#3); the forward adds
// scale[s] * act(z_s). MODE_EMIT walks as MODE_GEQ and also stores each
// slot's scale[s] * vjp(act, z_s)(g_r) into g_slots[s] (T, the gathered
// type), 16 bytes at a time from the group's chunks, evict-first; a
// zero-scale slot's row is +0 by a select. GW is the group width and K the
// chunks a lane, from group_layout; the block's dynamic shared memory holds
// 2 * KEYS * H floats a warp. EDGE (MODE_FWD, MODE_GEQ, MODE_SRC): each
// slot also gathers its edge row e[slot_edge[s]] (T, rows H apart) and the
// gathered value is add_cast(a, e); MODE_SRC then stores each slot's
// scale[s] * vjp rounded to T into row slot_edge[s] of g_e (f32), 16 bytes
// at a time, where the scale is not 0. Every mode is fixed at compile time:
// no branch on it is left in the loop.
//
// A warp walks its rows' slots as a stream of batches: a batch is up to
// G * U slots of one run of 32 of a row (U a group), and a row has at least
// one (an empty row one with no live slot, so that its zero row is
// written). The gathers of the next batch, of this row or the next, are
// issued before the current batch is worked, and the next row's key rows
// are copied into the warp's shared memory by cp.async when its first batch
// is issued: a warp always has a batch of gathers in flight.
template <int ACT, typename T, int GW, int K, int MODE, bool EDGE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  group_min_blocks(GW, K, MODE, EDGE))
group_kernel(const T* __restrict__ a, const T* __restrict__ ga,
             const float* __restrict__ ka, const float* __restrict__ kg,
             const T* __restrict__ e, const int* __restrict__ slot_idx,
             const int* __restrict__ slot_edge,
             const float* __restrict__ scale,
             const int* __restrict__ row_key,
             const int* __restrict__ row_ptr, int R, int H, float p,
             float* __restrict__ out, T* __restrict__ g_slots,
             float* __restrict__ g_e) {
  static_assert(!EDGE || MODE == MODE_FWD || MODE == MODE_GEQ ||
                    MODE == MODE_SRC,
                "an edge form of #1r, #3 or #4r only");
  constexpr int EPV = Vec<T>::N;
  constexpr int NV = K * EPV;
  constexpr int U = kGroupInflight;
  constexpr bool GATHER_G = MODE == MODE_SRC || MODE == MODE_FUSED;
  constexpr bool EMIT = MODE == MODE_EMIT;
  // f32 key rows a row
  constexpr int KEYS = MODE == MODE_GEQ || EMIT ? 2 : 1;
  extern __shared__ float4 group_smem[];
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * kWarpsPerBlock;
  const int r0 = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r0 >= R) return;  // the whole warp leaves together
  // two buffers of key rows a warp, by the parity of the row's place among
  // the warp's rows: the next row's copy never lands in the rows in use
  float* kbufs = reinterpret_cast<float*>(group_smem) +
                 (threadIdx.x >> 5) * 2 * KEYS * H;
  constexpr int G = 32 / GW;
  const int C = H / EPV;
  const int grp = lane / GW;
  const float inv_h = 1.f / (float)H;
  // the gathered rows' stride: H, or 2H in the [N, 2H] table
  const int64_t stride = MODE == MODE_FUSED ? 2 * (int64_t)H : (int64_t)H;
  // past the row: 0 (centered_relu, an elementwise act) or -inf (softmax)
  // in z
  const float pad = ACT == ACT_SOFTMAX ? __int_as_float((int)0xff800000u)
                                       : 0.f;
  // the lane's chunks gl + GW * k and their first features
  bool ok[K];
  int f[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (lane & (GW - 1)) + GW * k;
    ok[k] = c < C;
    f[k] = ok[k] ? c * EPV : 0;
  }

  // The load cursor: row lr with head lh, the run of 32 slots at lbase (the
  // lane's slot of it in lmine), the batch at lk0 of the run; and the next
  // row's head and first run, loaded a row ahead.
  int lr = r0, lord = 0;  // lord: the row's place among the warp's rows
  Head lh = load_head(row_ptr, row_key, lr, R);
  int lbase = lh.s0, lk0 = 0;
  Slot lmine = load_slot<EDGE>(slot_idx, slot_edge, scale, lbase, lh.s1, lane);
  Head hn = load_head(row_ptr, row_key, lr + W, R);
  Slot first_n =
      load_slot<EDGE>(slot_idx, slot_edge, scale, hn.s0, hn.s1, lane);

  struct Batch {
    uint4 va[U][K], vg[U][K], ve[U][K];  // ve: EDGE's edge rows
    float w[U];
    int edge[U];   // EDGE: the slots' edge ids
    int s0, live;  // EMIT: the batch's first slot and its slots in the row
    int row, kb;   // kb: the buffer of the row's key rows
    bool first, last;
  };
  // issue the gathers of the batch at the cursor, and with a row's first
  // batch the cp.async of its f32 key rows into buffer b.kb ([KEYS][H]);
  // one cp.async group a batch
  auto issue = [&](Batch& b) {
    const int n = min(32, lh.s1 - lbase);
    b.row = lr;
    b.kb = lord & 1;
    if (EMIT) {  // slots lk0 + j, j < live, of the run: consecutive
      b.s0 = lbase + lk0;
      b.live = max(0, min(G * U, n - lk0));
    }
    b.first = lbase == lh.s0 && lk0 == 0;
    b.last = lk0 + G * U >= n && lbase + 32 >= lh.s1;
    if (b.first) {
      const int q = H / 4;  // 16-byte chunks of a key row
      float* kbuf = kbufs + b.kb * KEYS * H;
      for (int c = lane; c < KEYS * q; c += 32) {
        const float* src = c < q ? ka + (int64_t)lh.key * H + 4 * c
                                 : kg + (int64_t)lh.key * H + 4 * (c - q);
        cp_async16(kbuf + 4 * c, src);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lk0 + u * G + grp;  // the group's slot, within the run
      const int node = __shfl_sync(kFull, lmine.node, k & 31);
      const float sc = __shfl_sync(kFull, lmine.sc, k & 31);
      // a zero-scale slot adds exactly 0 whatever its rows hold: at G = 1
      // it gathers nothing (a warp-uniform skip of a whole row's read)
      const bool live = k < n && (G > 1 || sc != 0.f);
      b.w[u] = live ? sc : 0.f;
      const int64_t at = (int64_t)node * stride;
      int64_t eat = 0;
      if constexpr (EDGE) {
        b.edge[u] = __shfl_sync(kFull, lmine.edge, k & 31);
        eat = (int64_t)b.edge[u] * H;
      }
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const bool ld = live && ok[c];
        b.va[u][c] = ld ? load16(a + at + f[c]) : make_uint4(0, 0, 0, 0);
        if (GATHER_G)
          b.vg[u][c] = ld ? load16(ga + at + f[c]) : make_uint4(0, 0, 0, 0);
        if (EDGE)
          b.ve[u][c] = ld ? load16(e + eat + f[c]) : make_uint4(0, 0, 0, 0);
      }
    }
  };
  // move the cursor to the next batch; false past the warp's last row
  auto advance = [&]() -> bool {
    lk0 += G * U;
    if (lk0 < min(32, lh.s1 - lbase)) return true;
    lk0 = 0;
    lbase += 32;
    if (lbase < lh.s1) {
      lmine = load_slot<EDGE>(slot_idx, slot_edge, scale, lbase, lh.s1, lane);
      return true;
    }
    lr += W;
    ++lord;
    if (lr >= R) return false;
    lh = hn;
    lbase = lh.s0;
    lmine = first_n;
    hn = load_head(row_ptr, row_key, lr + W, R);
    first_n = load_slot<EDGE>(slot_idx, slot_edge, scale, hn.s0, hn.s1, lane);
    return true;
  };

  float kv[NV], kgv[NV], acc[NV];
  bool more;
  // work batch cur with nxt's gathers in flight; false after the last
  // batch
  auto step = [&](Batch& cur, Batch& nxt) -> bool {
    if (cur.first) {  // its key rows: wait for the copy, read, release
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();
      const float* kbuf = kbufs + cur.kb * KEYS * H;
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < EPV; j += 4) {
          const float4 t = ok[k] ? *reinterpret_cast<const float4*>(
                                       kbuf + f[k] + j)
                                 : make_float4(pad, pad, pad, pad);
          kv[k * EPV + j] = t.x;
          kv[k * EPV + j + 1] = t.y;
          kv[k * EPV + j + 2] = t.z;
          kv[k * EPV + j + 3] = t.w;
          if (KEYS == 2) {
            const float4 v = ok[k] ? *reinterpret_cast<const float4*>(
                                         kbuf + H + f[k] + j)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
            kgv[k * EPV + j] = v.x;
            kgv[k * EPV + j + 1] = v.y;
            kgv[k * EPV + j + 2] = v.z;
            kgv[k * EPV + j + 3] = v.w;
          }
        }
      }
      __syncwarp();  // every lane has read kbuf before it is copied into
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[j] = 0.f;
    }
    const bool issued = more;
    if (more) {
      issue(nxt);
      more = advance();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float z[NV], gs[NV];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        Vec<T>::widen(cur.va[u][c], z + c * EPV);
        if (GATHER_G) Vec<T>::widen(cur.vg[u][c], gs + c * EPV);
      }
      if constexpr (EDGE) {  // add_cast(a, e); chunks past the row: 0
        float ev[NV];
#pragma unroll
        for (int c = 0; c < K; ++c) Vec<T>::widen(cur.ve[u][c], ev + c * EPV);
#pragma unroll
        for (int j = 0; j < NV; ++j) z[j] = round_to<T>(z[j] + ev[j]);
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        z[j] += kv[j];
        if (KEYS == 2) gs[j] = kgv[j];
      }
      if constexpr (MODE == MODE_FWD) {
        add_act_group<ACT, GW, NV>(z, cur.w[u], inv_h, p, acc);
      } else if constexpr (MODE == MODE_SRC && EDGE) {
        // the row's sum as add_vjp_group adds it, and the slot's scaled
        // vjp rounded to T into its g_e row; a zero-scale slot, or a group
        // past the row's last slot (w = 0), writes none
        float v[NV];
        vjp_group<ACT, GW, NV>(z, gs, inv_h, p, v);
        const float w = cur.w[u];
#pragma unroll
        for (int j = 0; j < NV; ++j) acc[j] = fmaf(w, v[j], acc[j]);
        if (w != 0.f) {
          float* ge_row = g_e + (int64_t)cur.edge[u] * H;
#pragma unroll
          for (int c = 0; c < K; ++c) {
            if (!ok[c]) continue;
#pragma unroll
            for (int i = 0; i < EPV; i += 4) {
              const int j = c * EPV + i;
              *reinterpret_cast<float4*>(ge_row + f[c] + i) = make_float4(
                  round_to<T>(w * v[j]), round_to<T>(w * v[j + 1]),
                  round_to<T>(w * v[j + 2]), round_to<T>(w * v[j + 3]));
            }
          }
        }
      } else if constexpr (EMIT) {
        // the row's sum as MODE_GEQ adds it, and the slot's scaled vjp
        float v[NV];
        vjp_group<ACT, GW, NV>(z, gs, inv_h, p, v);
        const float w = cur.w[u];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          acc[j] = fmaf(w, v[j], acc[j]);
          v[j] = w == 0.f ? 0.f : w * v[j];
        }
        const int j = u * G + grp;  // the slot's place in the batch
        if (j < cur.live) {
          T* gs_row = g_slots + (int64_t)(cur.s0 + j) * H;
#pragma unroll
          for (int c = 0; c < K; ++c)
            if (ok[c])
              store16_stream(gs_row + f[c],
                             narrow16(v + c * EPV, (T*)nullptr));
        }
      } else {
        add_vjp_group<ACT, GW, NV>(z, gs, cur.w[u], inv_h, p, acc);
      }
    }
    if (cur.last)  // the groups' sums, added over the groups and stored
      RowEnd<NV, GW, 0, GW, EPV>::run(acc, 0, lane, C,
                                      out + (int64_t)cur.row * H);
    return issued;
  };

  Batch A, B;
  issue(A);
  more = advance();
  while (step(A, B) && step(B, A)) {
  }
}

// Features a lane holds: a row-wise act takes the whole row in one pass
// (1, 2, 3, 4, 8 or 16; 0 past kRowRegMax: the wide path's passes, 8 a
// chunk), an elementwise act chunks of up to 128.
template <int ACT>
int feat_per_lane(int H) {
  const int nf = (H + 31) / 32;
  if (!Rowwise<ACT>::value) return nf < 4 ? nf : 4;
  if (nf <= 4) return nf;
  if (nf <= 8) return 8;
  return H <= kRowRegMax ? 16 : 0;
}

dim3 grid_for(int R) { return dim3((R + kWarpsPerBlock - 1) / kWarpsPerBlock); }

// LAUNCH(NF, WIDE) for the NF that H needs; NF = 8 and 16 and the wide
// path's passes are built for row-wise acts only.
#define SIR_NF_SWITCH(ACT, H, LAUNCH)                  \
  switch (feat_per_lane<ACT>(H)) {                     \
    case 1: LAUNCH(1, false); break;                   \
    case 2: LAUNCH(2, false); break;                   \
    case 3: LAUNCH(3, false); break;                   \
    case 4: LAUNCH(4, false); break;                   \
    case 8:                                            \
      if constexpr (Rowwise<ACT>::value) {             \
        LAUNCH(8, false);                              \
        break;                                         \
      }                                                \
      return (int)cudaErrorInvalidValue;               \
    case 16:                                           \
      if constexpr (Rowwise<ACT>::value) {             \
        LAUNCH(16, false);                             \
        break;                                         \
      }                                                \
      return (int)cudaErrorInvalidValue;               \
    case 0:                                            \
      if constexpr (Rowwise<ACT>::value) {             \
        LAUNCH(8, true);                               \
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
    case ACT_GELU: return CALL(ACT_GELU);                          \
    default: return (int)cudaErrorInvalidValue;                    \
  }

#if SIR_IN_PART(4)
// Whether a launch under the act act_id at width H takes the wide path.
bool wide_path(int act_id, int H) {
  return (act_id == ACT_CENTERED_RELU || act_id == ACT_SOFTMAX) &&
         H > kRowMax;
}

// ell_general_layout's code for the wide path: bit 30, the features a lane
// holds in bits 16-23 and the chunks a row is walked in in bits 0-15 (one
// up to kRowRegMax, the row in registers; past it chunks of 256 features,
// the statistics from passes).
int wide_code(int H) {
  if (H <= kRowRegMax) return 1 << 30 | 16 << 16 | 1;
  return 1 << 30 | 8 << 16 | (H + 32 * 8 - 1) / (32 * 8);
}
#endif

// The lane-group path's layout for a launch of `kernel` (a MODE; `edge`: its
// edge form) under the act act_id, rows of H values of `bytes` bytes, with
// the tables and outputs at ptrs (null ones unused), packed as C << 16 | GW
// << 8 | U; 0 where the launch takes the first design: an act group_takes
// does not take in the mode (past kRowMax group_wide_takes), H * bytes not
// a multiple of 16 (so also #5's second half off 16 bytes from the first),
// a table off 16-byte alignment, or H past group_row_max(kernel). GW is
// the narrowest power of two that leaves a lane at most 4 chunks and
// group_max_values(kernel, edge) values of a row: up to 16 lanes to H =
// 256, 32 (one slot a warp) past it, in #1r, #3, #4r and #5 only (C <= 128
// chunks, K <= 4). #3's two f32 key rows take
// 64 KB of a block's dynamic shared memory, which launch_group_k allows.
int group_layout(int kernel, int act_id, int H, int bytes, bool edge,
                 const void* const* ptrs, int n) {
  if (kernel < MODE_GEQ || kernel > MODE_EMIT) return 0;
  if (!group_takes(kernel, act_id)) return 0;
  if (H <= 0 || H > group_row_max(kernel) || (H * bytes) % 16) return 0;
  if (H > kRowMax && !group_wide_takes(kernel, act_id, bytes)) return 0;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return 0;
  const int C = H * bytes / 16, per_chunk = 16 / bytes;
  const int most = group_max_values(kernel, edge);
  auto fits = [&](int gw) {  // launch_group takes K <= 4, GW <= 32
    const int K = (C + gw - 1) / gw;
    return K * per_chunk <= most && K <= 4;
  };
  int gw = 1;
  while (gw < 32 && !fits(gw)) gw <<= 1;
  if (!fits(gw)) return 0;
  return C << 16 | gw << 8 | kGroupInflight;
}

#if SIR_IN_PART(4)
// The path of a launch: the lane-group layout, else the wide path's code for
// a row-wise act past kRowMax, else 0 (the first design).
int general_layout(int kernel, int act_id, int H, int bytes, bool edge,
                   const void* const* ptrs, int n) {
  const int layout = group_layout(kernel, act_id, H, bytes, edge, ptrs, n);
  if (layout) return layout;
  return wide_path(act_id, H) ? wide_code(H) : 0;
}
#endif

// A persistent kernel's grid: as many blocks as are resident on the card at
// once, at most one warp a row. per_sm caches the kernel's resident blocks
// an SM (-1 before the first query), asked with the most dynamic shared
// memory a block of it takes (smem_max bytes).
template <typename Kernel>
dim3 persistent_grid(Kernel kernel, int R, size_t smem_max, int& per_sm) {
  if (per_sm < 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, kernel, kWarpsPerBlock * 32, smem_max) != 0)
    per_sm = 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const dim3 all = grid_for(R);
  const unsigned most = (unsigned)(sms * per_sm);
  return dim3(most > 0 && most < all.x ? most : all.x);
}

// A launch's arguments as the entries take them, by their role in the
// lane-group kernel: a, the gathered table (ek for #1r, #3, #6; eq for
// #4r; the [N, 2H] table for #5) and ga, the gathered cotangent (g for
// #4r, the table's second half for #5); ka, the f32 key rows (eq for #1r,
// #3, #6; ek for #4r, #5) and kg, the f32 key cotangent (g for #3, #6); e
// and slot_edge, the edge forms' (null otherwise); out, the f32 [R, H]
// rows; g_slots, #6's [S, H]; g_e, #4r's edge form's f32 [E_pad, H].
struct Args {
  const void *a, *ga, *ka, *kg, *e, *slot_idx, *slot_edge, *scale, *row_key,
      *row_ptr;
  int R, H;
  float p;
  void *out, *g_slots, *g_e;
  cudaStream_t st;
};

// A block's dynamic shared memory without cudaFuncSetAttribute.
constexpr size_t kDefaultSmem = 48 * 1024;

template <int ACT, typename T, int GW, int K, int MODE, bool EDGE>
int launch_group_k(const Args& x) {
  const auto kernel = group_kernel<ACT, T, GW, K, MODE, EDGE>;
  constexpr size_t row_bytes =
      2 * (MODE == MODE_GEQ || MODE == MODE_EMIT ? 2 : 1) * sizeof(float);
  // the widest row of the instance's mode (#3's groups narrower than the
  // warp take rows up to kRowMax only)
  constexpr int row_max =
      MODE == MODE_GEQ && GW < 32 ? kRowMax : group_row_max(MODE);
  constexpr size_t smem_max = kWarpsPerBlock * row_bytes * row_max;
  const size_t smem = kWarpsPerBlock * row_bytes * x.H;
  // past 48 KB (#3 on full-warp groups) the launch and the occupancy query
  // need the kernel's limit raised first: else the query reports no block
  // and the launch is refused
  if (smem_max > kDefaultSmem) {
    const cudaError_t code = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (code != cudaSuccess) return (int)code;
  }
  static int per_sm = -1;
  kernel<<<persistent_grid(kernel, x.R, smem_max, per_sm),
           kWarpsPerBlock * 32, smem, x.st>>>(
      (const T*)x.a, (const T*)x.ga, (const float*)x.ka, (const float*)x.kg,
      (const T*)x.e, (const int*)x.slot_idx, (const int*)x.slot_edge,
      (const float*)x.scale, (const int*)x.row_key, (const int*)x.row_ptr,
      x.R, x.H, x.p, (float*)x.out, (T*)x.g_slots, (float*)x.g_e);
  return (int)cudaGetLastError();
}

// The K chunks a lane that group_layout can give a group of GW lanes in
// MODE (EDGE: its edge form): at most 4 chunks and group_max_values(MODE,
// EDGE) values a lane, for GW > 1 more than the half-width group takes (a
// row of GW K chunks needs 2K chunks a lane there), and a row of more than
// GW (K - 1) chunks within group_row_max(MODE). Only these are built.
template <typename T, int GW, int K, int MODE, bool EDGE>
constexpr bool group_shape() {
  constexpr int per_chunk = Vec<T>::N, most = group_max_values(MODE, EDGE);
  return K * per_chunk <= most && K <= 4 &&
         (GW == 1 || 2 * K * per_chunk > most || 2 * K > 4) &&
         GW * (K - 1) * per_chunk < group_row_max(MODE);
}

template <int ACT, typename T, int GW, int MODE, bool EDGE>
int launch_group_gw(int K, const Args& x) {
#define SIR_CASE(KK)                                                      \
  case KK:                                                                \
    if constexpr (group_shape<T, GW, KK, MODE, EDGE>())                   \
      return launch_group_k<ACT, T, GW, KK, MODE, EDGE>(x);               \
    break;
  switch (K) {
    SIR_CASE(1)
    SIR_CASE(2)
    SIR_CASE(3)
    SIR_CASE(4)
  }
#undef SIR_CASE
  return (int)cudaErrorInvalidValue;
}

// The lane-group kernel for `layout` (from group_layout, not 0).
template <int ACT, typename T, int MODE, bool EDGE>
int launch_group_t(int layout, const Args& x) {
  const int C = layout >> 16, gw = (layout >> 8) & 0xff;
  const int K = (C + gw - 1) / gw;
  switch (gw) {
    case 1: return launch_group_gw<ACT, T, 1, MODE, EDGE>(K, x);
    case 2: return launch_group_gw<ACT, T, 2, MODE, EDGE>(K, x);
    case 4: return launch_group_gw<ACT, T, 4, MODE, EDGE>(K, x);
    case 8: return launch_group_gw<ACT, T, 8, MODE, EDGE>(K, x);
    case 16: return launch_group_gw<ACT, T, 16, MODE, EDGE>(K, x);
    case 32:  // one slot a warp: #1r, #3, #4r and #5 past kRowMax
      if constexpr (group_row_max(MODE) > kRowMax &&
                    group_wide_takes(MODE, ACT, (int)sizeof(T)))
        return launch_group_gw<ACT, T, 32, MODE, EDGE>(K, x);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// The lane-group kernel of MODE (EDGE: its edge form) for the act id and
// the gathered type (bf16 when bf16 != 0, else f32); an elementwise act is
// built only where group_takes it.
template <int MODE, bool EDGE>
int launch_group(int act, int bf16, int layout, const Args& x) {
#define SIR_CALL(A)                                                  \
  (bf16 ? launch_group_t<A, __nv_bfloat16, MODE, EDGE>(layout, x)    \
        : launch_group_t<A, float, MODE, EDGE>(layout, x))
  switch (act) {
    case ACT_CENTERED_RELU: return SIR_CALL(ACT_CENTERED_RELU);
    case ACT_SOFTMAX: return SIR_CALL(ACT_SOFTMAX);
    case ACT_LEAKY_RELU:
      if constexpr (group_takes(MODE, ACT_LEAKY_RELU))
        return SIR_CALL(ACT_LEAKY_RELU);
      break;
    case ACT_TANH:
      if constexpr (group_takes(MODE, ACT_TANH)) return SIR_CALL(ACT_TANH);
      break;
    case ACT_GELU:
      if constexpr (group_takes(MODE, ACT_GELU)) return SIR_CALL(ACT_GELU);
      break;
  }
#undef SIR_CALL
  return (int)cudaErrorInvalidValue;
}

template <int ACT, typename TK>
int launch_act_reduce(const Args& x) {
#define SIR_LAUNCH(NF, WIDE)                                                 \
  act_reduce_rw_kernel<ACT, NF, WIDE, TK>                                    \
      <<<grid_for(x.R), kWarpsPerBlock * 32, 0, x.st>>>(                     \
          (const float*)x.ka, (const TK*)x.a, (const TK*)x.e,                \
          (const int*)x.slot_idx, (const int*)x.slot_edge,                   \
          (const float*)x.scale, (const int*)x.row_key,                      \
          (const int*)x.row_ptr, x.R, x.H, x.p, (float*)x.out)
  SIR_NF_SWITCH(ACT, x.H, SIR_LAUNCH)
#undef SIR_LAUNCH
  return (int)cudaGetLastError();
}

template <int ACT, typename TK, typename TG, bool EMIT>
int launch_geq(const Args& x) {
#define SIR_LAUNCH(NF, WIDE)                                                 \
  geq_kernel<ACT, NF, WIDE, TK, TG, EMIT>                                    \
      <<<grid_for(x.R), kWarpsPerBlock * 32, 0, x.st>>>(                     \
          (const float*)x.ka, (const TK*)x.a, (const TK*)x.e,                \
          (const float*)x.kg, (const int*)x.slot_idx,                        \
          (const int*)x.slot_edge, (const float*)x.scale,                    \
          (const int*)x.row_key, (const int*)x.row_ptr, x.R, x.H, x.p,       \
          (float*)x.out, (TG*)x.g_slots)
  SIR_NF_SWITCH(ACT, x.H, SIR_LAUNCH)
#undef SIR_LAUNCH
  return (int)cudaGetLastError();
}

template <int ACT, typename T, bool FUSED>
int launch_src_bwd(const Args& x) {
#define SIR_LAUNCH(NF, WIDE)                                                 \
  src_bwd_rw_kernel<ACT, NF, WIDE, T, FUSED>                                 \
      <<<grid_for(x.R), kWarpsPerBlock * 32, 0, x.st>>>(                     \
          (const T*)x.a, (const T*)x.ga, (const T*)x.e, (const float*)x.ka,  \
          (const int*)x.slot_idx, (const int*)x.slot_edge,                   \
          (const float*)x.scale, (const int*)x.row_key,                      \
          (const int*)x.row_ptr, x.R, x.H, x.p, (float*)x.out,               \
          (float*)x.g_e)
  SIR_NF_SWITCH(ACT, x.H, SIR_LAUNCH)
#undef SIR_LAUNCH
  return (int)cudaGetLastError();
}

#if SIR_IN_PART(4)
// The second half of a row of the [N, 2H] table at `both`: H values of
// `bytes` bytes in.
const void* second_half(const void* both, int H, int bytes) {
  return reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(both) +
                                       (uintptr_t)H * bytes);
}
#endif

#if SIR_IN_PART(0)
// #1r and its edge form (x.e not null); ek (x.a) and e are f32, or bf16
// when bf16 != 0.
int act_reduce_entry(const Args& x, int bf16, int act) {
  if (x.R <= 0 || x.H <= 0) return (int)cudaErrorInvalidValue;
  const bool edge = x.e != nullptr;
  const void* tables[] = {x.ka, x.a, x.e, x.out};
  const int layout =
      group_layout(MODE_FWD, act, x.H, bf16 ? 2 : 4, edge, tables, 4);
  if (layout)
    return edge ? launch_group<MODE_FWD, true>(act, bf16, layout, x)
                : launch_group<MODE_FWD, false>(act, bf16, layout, x);
#define SIR_CALL(A)                                            \
  (bf16 ? launch_act_reduce<A, __nv_bfloat16>(x)               \
        : launch_act_reduce<A, float>(x))
  SIR_ACT_SWITCH(act, SIR_CALL)
#undef SIR_CALL
}

#endif

#if SIR_IN_PART(1)
// #3 and its edge form; as act_reduce_entry, with g (x.kg) f32.
int geq_entry(const Args& x, int bf16, int act) {
  if (x.R <= 0 || x.H <= 0) return (int)cudaErrorInvalidValue;
  const bool edge = x.e != nullptr;
  const void* tables[] = {x.ka, x.a, x.e, x.kg, x.out};
  const int layout =
      group_layout(MODE_GEQ, act, x.H, bf16 ? 2 : 4, edge, tables, 5);
  if (layout)
    return edge ? launch_group<MODE_GEQ, true>(act, bf16, layout, x)
                : launch_group<MODE_GEQ, false>(act, bf16, layout, x);
#define SIR_CALL(A)                                                  \
  (bf16 ? launch_geq<A, __nv_bfloat16, float, false>(x)              \
        : launch_geq<A, float, float, false>(x))
  SIR_ACT_SWITCH(act, SIR_CALL)
#undef SIR_CALL
}

#endif

#if SIR_IN_PART(3)
// #4r and its edge form; eq (x.a), g (x.ga) and e share one type (f32, or
// bf16 when bf16 != 0); ek (x.ka) and g_e are f32, g_e zeroed.
int src_bwd_entry(const Args& x, int bf16, int act) {
  if (x.R <= 0 || x.H <= 0) return (int)cudaErrorInvalidValue;
  const bool edge = x.e != nullptr;
  const void* tables[] = {x.a, x.ga, x.e, x.ka, x.out, x.g_e};
  const int layout =
      group_layout(MODE_SRC, act, x.H, bf16 ? 2 : 4, edge, tables, 6);
  if (layout)
    return edge ? launch_group<MODE_SRC, true>(act, bf16, layout, x)
                : launch_group<MODE_SRC, false>(act, bf16, layout, x);
#define SIR_CALL(A)                                                   \
  (bf16 ? launch_src_bwd<A, __nv_bfloat16, false>(x)                  \
        : launch_src_bwd<A, float, false>(x))
  SIR_ACT_SWITCH(act, SIR_CALL)
#undef SIR_CALL
}

#endif

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted), or cudaErrorInvalidValue for an unknown act.
// Pointers are device pointers; eq, g (but in ell_src_bwd_*) and the row
// outputs are f32, the index arrays int32, the scales f32; `p` is the act's
// parameter (leaky_relu's slope, the centered relu's alpha). The edge forms
// take e [E_pad, H] in the gathered table's type and slot_edge [S] int32.

#if SIR_IN_PART(0)
// ek is f32, or bf16 when ek_bf16 != 0.
int ell_act_reduce_rowwise(const void* eq, const void* ek, int ek_bf16,
                           const void* slot_src, const void* scale,
                           const void* row_key, const void* row_ptr, int R,
                           int H, int act, float p, void* rows,
                           void* stream) {
  return act_reduce_entry(
      Args{ek, nullptr, eq, nullptr, nullptr, slot_src, nullptr, scale,
           row_key, row_ptr, R, H, p, rows, nullptr, nullptr,
           (cudaStream_t)stream},
      ek_bf16, act);
}

int ell_act_reduce_rowwise_edge(const void* eq, const void* ek,
                                const void* e, int ek_bf16,
                                const void* slot_src, const void* slot_edge,
                                const void* scale, const void* row_key,
                                const void* row_ptr, int R, int H, int act,
                                float p, void* rows, void* stream) {
  if (e == nullptr || slot_edge == nullptr) return (int)cudaErrorInvalidValue;
  return act_reduce_entry(
      Args{ek, nullptr, eq, nullptr, e, slot_src, slot_edge, scale, row_key,
           row_ptr, R, H, p, rows, nullptr, nullptr, (cudaStream_t)stream},
      ek_bf16, act);
}

#endif

#if SIR_IN_PART(1)
// ek is f32, or bf16 when ek_bf16 != 0; g [N, H] f32.
int ell_geq_reduce(const void* eq, const void* ek, int ek_bf16,
                   const void* g, const void* slot_src, const void* scale,
                   const void* row_key, const void* row_ptr, int R, int H,
                   int act, float p, void* geq_rows, void* stream) {
  return geq_entry(
      Args{ek, nullptr, eq, g, nullptr, slot_src, nullptr, scale, row_key,
           row_ptr, R, H, p, geq_rows, nullptr, nullptr,
           (cudaStream_t)stream},
      ek_bf16, act);
}

int ell_geq_reduce_edge(const void* eq, const void* ek, const void* e,
                        int ek_bf16, const void* g, const void* slot_src,
                        const void* slot_edge, const void* scale,
                        const void* row_key, const void* row_ptr, int R,
                        int H, int act, float p, void* geq_rows,
                        void* stream) {
  if (e == nullptr || slot_edge == nullptr) return (int)cudaErrorInvalidValue;
  return geq_entry(
      Args{ek, nullptr, eq, g, e, slot_src, slot_edge, scale, row_key,
           row_ptr, R, H, p, geq_rows, nullptr, nullptr,
           (cudaStream_t)stream},
      ek_bf16, act);
}

#endif

#if SIR_IN_PART(2)
// ell_geq_reduce plus g_slots [S, H], f32, or bf16 when gz_bf16 != 0; the
// lane-group path only where g_slots has ek's type.
int ell_act_reduce_bwd(const void* eq, const void* ek, int ek_bf16,
                       const void* g, const void* slot_src,
                       const void* scale, const void* row_key,
                       const void* row_ptr, int R, int H, int act, float p,
                       int gz_bf16, void* geq_rows, void* g_slots,
                       void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Args x{ek, nullptr, eq, g, nullptr, slot_src, nullptr, scale,
               row_key, row_ptr, R, H, p, geq_rows, g_slots, nullptr,
               (cudaStream_t)stream};
  const void* tables[] = {eq, ek, g, g_slots, geq_rows};
  const int layout =
      !ek_bf16 == !gz_bf16
          ? group_layout(MODE_EMIT, act, H, ek_bf16 ? 2 : 4, false, tables, 5)
          : 0;
  if (layout) return launch_group<MODE_EMIT, false>(act, ek_bf16, layout, x);
#define SIR_CALL(A)                                                          \
  (ek_bf16 ? (gz_bf16 ? launch_geq<A, __nv_bfloat16, __nv_bfloat16, true>(x) \
                      : launch_geq<A, __nv_bfloat16, float, true>(x))        \
           : (gz_bf16 ? launch_geq<A, float, __nv_bfloat16, true>(x)         \
                      : launch_geq<A, float, float, true>(x)))
  SIR_ACT_SWITCH(act, SIR_CALL)
#undef SIR_CALL
}

#endif

#if SIR_IN_PART(3)
// eq and g share one type (f32, or bf16 when bf16 != 0); ek is f32.
int ell_src_bwd_rowwise(const void* eq, const void* g, int bf16,
                        const void* ek, const void* slot_dst,
                        const void* scale, const void* row_key,
                        const void* row_ptr, int R, int H, int act, float p,
                        void* out, void* stream) {
  return src_bwd_entry(
      Args{eq, g, ek, nullptr, nullptr, slot_dst, nullptr, scale, row_key,
           row_ptr, R, H, p, out, nullptr, nullptr, (cudaStream_t)stream},
      bf16, act);
}

// eq, g and e share one type; g_e [E_pad, H] f32, zeroed by the caller.
int ell_src_bwd_rowwise_edge(const void* eq, const void* g, const void* e,
                             int bf16, const void* ek, const void* slot_dst,
                             const void* slot_edge, const void* scale,
                             const void* row_key, const void* row_ptr, int R,
                             int H, int act, float p, void* out, void* g_e,
                             void* stream) {
  if (e == nullptr || slot_edge == nullptr || g_e == nullptr)
    return (int)cudaErrorInvalidValue;
  return src_bwd_entry(
      Args{eq, g, ek, nullptr, e, slot_dst, slot_edge, scale, row_key,
           row_ptr, R, H, p, out, nullptr, g_e, (cudaStream_t)stream},
      bf16, act);
}

#endif

#if SIR_IN_PART(4)
// both [N, 2H] (eq | g) is f32, or bf16 when bf16 != 0; ek [N, H] f32.
int ell_src_bwd_fused(const void* both, int bf16, const void* ek,
                      const void* slot_dst, const void* scale,
                      const void* row_key, const void* row_ptr, int R, int H,
                      int act, float p, void* out, void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const void* g = second_half(both, H, bf16 ? 2 : 4);
  const Args x{both, g, ek, nullptr, nullptr, slot_dst, nullptr, scale,
               row_key, row_ptr, R, H, p, out, nullptr, nullptr,
               (cudaStream_t)stream};
  const void* tables[] = {both, g, ek, out};
  const int layout =
      group_layout(MODE_FUSED, act, H, bf16 ? 2 : 4, false, tables, 4);
  if (layout) return launch_group<MODE_FUSED, false>(act, bf16, layout, x);
#define SIR_CALL(A)                                                   \
  (bf16 ? launch_src_bwd<A, __nv_bfloat16, true>(x)                   \
        : launch_src_bwd<A, float, true>(x))
  SIR_ACT_SWITCH(act, SIR_CALL)
#undef SIR_CALL
}

// Launches nothing: the path a launch of `kernel` (0 ell_geq_reduce, 1
// ell_src_bwd_rowwise, 2 ell_act_reduce_rowwise, 3 ell_src_bwd_fused, 4
// ell_act_reduce_bwd with g_slots in the gathered type; mixed types take
// the first design) takes for rows of H values, the gathered table in bf16
// (bf16 != 0) or f32, the act id `act` and the tables and outputs p0..p4 it
// is given (null ones unused; for ell_src_bwd_fused p0 is the [N, 2H]
// table, whose second half is checked too, as the entry does). Returns C
// << 16 | GW << 8 | U for the lane-group path (C 16-byte chunks a row,
// groups of GW lanes, U slots in flight a group), 1 << 30 | F << 16 | n
// for the wide path (a row-wise act past H = 256: F features a lane, n
// chunks a row; see wide_code), 0 for the first design.
int ell_general_layout(int kernel, int H, int bf16, int act, const void* p0,
                       const void* p1, const void* p2, const void* p3,
                       const void* p4) {
  const int bytes = bf16 ? 2 : 4;
  const void* ptrs[] = {p0, p1, p2, p3, p4, second_half(p0, H, bytes)};
  return general_layout(kernel, act, H, bytes, false, ptrs,
                        kernel == MODE_FUSED ? 6 : 5);
}

// ell_general_layout for the edge forms (0 ell_geq_reduce_edge, 1
// ell_src_bwd_rowwise_edge, 2 ell_act_reduce_rowwise_edge; -1 for another
// kernel), with up to six tables and outputs (their e and, for #4r, g_e
// among them).
int ell_general_edge_layout(int kernel, int H, int bf16, int act,
                            const void* p0, const void* p1, const void* p2,
                            const void* p3, const void* p4, const void* p5) {
  if (kernel != MODE_GEQ && kernel != MODE_SRC && kernel != MODE_FWD)
    return -1;
  const void* ptrs[] = {p0, p1, p2, p3, p4, p5};
  return general_layout(kernel, act, H, bf16 ? 2 : 4, true, ptrs, 6);
}

const char* ell_general_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif

}  // extern "C"
