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
// g_WE), against 2-4 bytes per feature read. The four paths below walk a
// row's slots in order, skip a slot with scale 0 (padding) whole, so that it
// reads nothing and contributes exactly 0, and form e_h for a lane's feature
// f as fmaf(b_d, W_E[d, f], e_h) in increasing d from 0. Each row's sums are
// therefore the same bits on every path. The entries choose the path from H
// and De; ell_edge_layout reports the choice.
//
// The register path (H <= 128, De <= 16, and in the backward NF * DB <= 48;
// NF = ceil(H / 32) features a lane, DB = 8 or 16 basis values a slot held):
// what the shared path does on the shared-memory pipe, a slot at a time (the
// broadcast of the basis by De shuffles and De * NF reads of W_E, and in the
// backward De * NF reads and writes of the g_WE partial), it does in
// registers. Lane l of a warp owns features l, l + 32, ... of the whole row
// and keeps their W_E columns, DB x NF values (0 past De and H), loaded once.
// The warps of a persistent grid walk rows gw, gw + nw, ... (as the shared
// backward) in chunks of at most 32 slots; the next chunk's slot indices and
// scales are loaded while this one is worked on, and the slot ranges and
// keys of 32 rows at a time. At a chunk's start each lane copies its slot's
// basis row into the warp's ring in shared memory with cp.async (16 bytes at
// a time where De % 4 == 0 and the basis is 16-byte aligned, else 4; the
// ring's values past De stay 0), and the node rows of the first U slots are
// loaded; slot k + U's node rows are loaded as slot k's are taken, so U
// slots' gathers are in flight while one is computed. A slot reads its basis
// row from the ring by broadcast, DB / 4 16-byte reads, and forms e_h from
// registers (the padded d >= De add exactly 0). The backward adds b_d * g_z
// into the warp's g_WE partial, also in registers (each lane owns its
// features' columns); at the end the block sums its warps' partials in warp
// order through shared memory, and a second kernel sums the blocks' partials
// in block order. No atomics, so g_WE is the same from launch to launch; it
// depends on the grid, and so differs from the shared path's in rounding.
// Registers set the occupancy: the forward is held to 128 a thread (16
// warps an SM), the backward, with W_E and g_WE both held, takes about 168
// (12 warps), and with tanh or erf-GELU keeps one slot in flight instead
// of two. A
// deeper pipeline (two rings, the next chunk's basis rows, row values and
// first node rows in flight during this chunk) measured slower on an H100:
// it costs registers and instructions a slot for latency that these warps
// already hide.
//
// Past kRegMaxH columns (De <= 16 still) #7 keeps the register path on
// blocks of 128 columns (edge_act_reduce_cols_kernel): the grid's column
// block is its fastest index, so that the blocks of the same rows run side
// by side and share the rows' slot ids, scales, basis rows and eq rows in
// the L2; lane l owns the block's features 4 l .. 4 l + 3 and their W_E
// columns (DB x 4 registers), so that a slot's ek values are one 8-byte
// (bf16) or 16-byte (f32) load a lane. The walk, the basis ring and the
// slots in flight are the register kernel's, and each feature's sums are
// formed as on every path. On the shared-memory loop (the first design at
// H = 512, De = 16) a slot cost each pass of 128 columns 16 shuffles and
// 64 shared loads a lane beside its 64 fmaf: the shared-memory pipe issues
// a quarter of the FMA pipes' rate, so that loop ran near a quarter of the
// FMA rate; here a slot costs four 16-byte broadcasts from the ring. What
// bounds it now is latency at 12-16 warps an SM (W_E's 64 registers a lane
// beside the slots in flight; cols_inflight): at H = 512, De = 16 on an
// H100 it took 2.57 ms in bf16, 44% of its no-L2-reuse estimate, and f32
// rows, twice the bytes, as long (PERF.md).
//
// The shared-memory path (the other shapes whose tables fit a block's
// shared memory: W_E, and in the backward the 8 warps' g_WE partials, De *
// H f32 each) is the first design: one warp per row, 8 rows per block, as
// ell_kernels.cu; the slots' indices and scales are read 32 at a time and
// passed round by shuffles. W_E sits in shared memory; the lanes load a
// slot's basis row (De values) with one coalesced read and broadcast it by
// shuffles, and each lane forms e_h for its own features (lanes striding h,
// so the shared reads of W_E hit 32 banks). Rows wider than 4 features a
// lane take passes. The backward's blocks are persistent; each warp walks
// its rows in a fixed order and adds egr_d * g_z into its own [De, H]
// partial in shared memory, summed as on the register path.
//
// The columns path (every shape whose tables do not fit) runs the same
// kernels on chunks of columns. The route takes only an elementwise sigma,
// so feature f of a slot needs only column f of W_E, and column f of g_WE
// only g_z[., f]: a block takes the columns c0 .. c0 + Hc - 1 of its rows
// (grid.y runs over the chunks), with W_E[:, c0:c0 + Hc] and, in the
// backward, its warps' partials [8, De, Hc] in shared memory. Hc is a
// multiple of 32 of at most 128 (one pass of 4 features a lane), the widest
// whose tables fit, spread evenly over the chunks H needs; at De = 16 the
// backward takes 128 columns in 72 KiB, three blocks an SM. Where not even
// 32 columns fit (De > 1808 in the forward, De > 200 in the backward), the
// block reads W_E from device memory and each warp keeps its partial in a
// row of the g_WE scratch in device memory (the L2 holds the rows in use),
// which the second kernel sums with the others; the backward's grid is then
// held to 256 MiB of scratch. Each feature's sums are formed as on the
// shared path, so rows, srows and the g_ek rows are its bits, and g_WE is
// summed per warp, per block and over blocks (or per warp and over warps)
// in a fixed order, the same from launch to launch. A slot costs each
// chunk De shuffles and De * NF shared reads for e_h, and as many
// shuffles, reads and writes again for g_WE: the shared-memory pipe bounds
// these kernels, not bytes or flops (#8 at H = 512, De = 16 ran at about
// an eighth of its operations bound on an H100, some 768 shared-memory
// warp instructions a slot), so #7 and #8 take them only where De > 16.
//
// The tiles path (#8 on the columns path's shapes with De <= 16, as at H =
// 512, De = 16) takes both products off the shared-memory pipe. A block
// takes 128 columns of its rows (grid.y over the chunks), lane l the four
// consecutive features 4 l .. 4 l + 3 and their W_E columns, De padded to
// 8 or 16 times 4 values in registers: e_h is formed in registers by the
// same fmaf chain in d as on the columns path, so the g_ek rows are that
// path's bits. A warp walks its rows' slots as a stream of batches (8
// slots in bf16, 4 in f32): the next batch's live slots' eq and g chunks
// and basis rows are copied by cp.async into the warp's other stage in
// shared memory (4 KB of rows), and a row's f32 ek values loaded, across
// row ends, before the current batch is worked. Each live slot's g_z
// values go into the next row of the warp's g_z tile of 16 slots in
// shared memory (one 16-byte store a lane); a full tile (its slots from
// any rows: g_WE does not care about rows) adds egr^T g_z to the warp's
// g_WE sums, [16, 128] as m16n8k8 accumulators in shared memory, on the
// tensor cores: each product the three-pass TF32 split of
// ell_max_kernels.cu (f32 accuracy), summed from zero a k step and added
// in f32. A slot then costs some twenty shared-memory wavefronts a chunk,
// not some 190. The block sums its warps' g_WE in warp order and
// sum_partials_kernel the blocks' in block order, as on the columns path;
// g_WE moves within f32 rounding of the columns path's. What bounds it now
// is latency at 8 warps an SM (some 185 registers a thread, W_E's columns
// 64 of them, and 217 KiB of shared memory a block): at the arxiv plan in
// bf16 it takes about four times its no-L2-reuse estimate on an H100,
// spent in the walk (e_h's 64 fmaf a slot and chunk) and the tile products
// (PERF.md). Deeper pipelines (four stages of 4 slots), two slots worked
// at once and the g_WE sums in registers measured slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWarps = 8;           // rows per block, one warp each
constexpr int kMaxFeatPerLane = 4;  // features per lane and pass
// dynamic shared memory a block may use: the card's 232,448 bytes less
// room for the static arrays
constexpr int kMaxSmem = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;
// The columns path: the widest chunk (one pass of a warp), and the g_WE
// scratch the backward's grid is held to where the partials stay in device
// memory.
constexpr int kMaxChunk = 32 * kMaxFeatPerLane;
constexpr size_t kDeviceScratch = size_t(256) << 20;

// The register path: warps a block, the widest row and basis it holds, the
// cap on DB * NF in the backward (W_E's and g_WE's registers), and the
// slots whose node rows are in flight in the forward and the backward.
constexpr int kRegWarps = 4;
constexpr int kRegMaxH = 32 * kMaxFeatPerLane;
constexpr int kRegMaxDe = 16;
constexpr int kRegMaxBwd = 48;
constexpr int kRegInflightFwd = 4;
constexpr int kRegInflightBwd = 2;

// Activation ids, as registered in sir_gcn_tpu_torch/ops/ell.py.
enum { ACT_LEAKY_RELU = 0, ACT_TANH = 1, ACT_GELU = 4 };

// The backward's slots in flight on the register path: the longer
// derivatives of tanh and erf-GELU leave registers for one.
__host__ __device__ constexpr int inflight_bwd(int act) {
  return act == ACT_TANH || act == ACT_GELU ? 1 : kRegInflightBwd;
}

// False for every id: the static_assert of an activation id that has no
// branch in act_grad or act_both fails the build.
template <int ACT>
constexpr bool kNoBranch = false;

// erf-GELU as jax.nn.gelu(approximate=False) computes it, z * Phi(z) with
// Phi(z) = 0.5 * erfc(-z / sqrt(2)), and gelu'(z) = Phi(z) + z * exp(-z^2
// / 2) / sqrt(2 pi).
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float gelu_cdf(float z) {
  return 0.5f * erfcf(-z * kSqrtHalf);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
    return gelu_cdf(z) + z * (expf(-0.5f * z * z) * kInvSqrt2Pi);
  } else {
    static_assert(kNoBranch<ACT>, "an activation id without a branch");
    return 0.f;
  }
}

// act(z) and act'(z) together: tanh evaluated once, erf-GELU's erfc once;
// leaky_relu(z) as z * act'(z), which rounds as slope * z does.
template <int ACT>
__device__ __forceinline__ void act_both(float z, float slope, float& a,
                                         float& d) {
  if constexpr (ACT == ACT_LEAKY_RELU) {
    d = z >= 0.f ? 1.f : slope;
    a = z * d;
  } else if constexpr (ACT == ACT_TANH) {
    a = tanhf(z);
    d = (1.f + a) * (1.f - a);
  } else if constexpr (ACT == ACT_GELU) {
    const float cdf = gelu_cdf(z);
    a = z * cdf;
    d = cdf + z * (expf(-0.5f * z * z) * kInvSqrt2Pi);
  } else {
    static_assert(kNoBranch<ACT>, "an activation id without a branch");
  }
}

// ---------------------------------------------------------------------
// The shared-memory path and the columns path
// ---------------------------------------------------------------------

// Where a kernel of the shared-memory loop keeps its tables: all of W_E
// (and #8's partials) in shared memory (the shared path), a chunk of its
// columns there (the columns path), or in device memory (the columns path
// where not even 32 columns fit). A template parameter, so that the shared
// path's instances do the first design's arithmetic and no more.
enum { LOOP_SHARED = 0, LOOP_COLUMNS = 1, LOOP_DEVICE = 2 };

// e_h[j] = sum_d basis[d] * w[d * ldw + f0 + j * 32 + lane] for the lane's
// features below nf, summed in increasing d; basis is one slot's [De] row,
// w the block's columns of W_E (rows ldw apart).
template <int NF>
__device__ __forceinline__ void edge_term(const float* __restrict__ basis,
                                          const float* w, int ldw, int De,
                                          int nf, int f0, int lane,
                                          float* eh) {
#pragma unroll
  for (int j = 0; j < NF; ++j) eh[j] = 0.f;
  for (int d0 = 0; d0 < De; d0 += 32) {
    const float mine = d0 + lane < De ? basis[d0 + lane] : 0.f;
    const int nd = min(32, De - d0);
    for (int k = 0; k < nd; ++k) {
      const float b = __shfl_sync(kFull, mine, k);
      const float* w_row = w + (d0 + k) * ldw;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int f = f0 + j * 32 + lane;
        if (f < nf) eh[j] = fmaf(b, w_row[f], eh[j]);
      }
    }
  }
}

// W_E into w_s: whole on the shared path, else its columns c0 .. c0 + nf -
// 1 as [De, Hc] (0 past nf).
template <int WHERE>
__device__ __forceinline__ void load_w(const float* __restrict__ w_e, int H,
                                       int De, int c0, int Hc, int nf,
                                       float* w_s) {
  if constexpr (WHERE == LOOP_SHARED) {
    for (int i = threadIdx.x; i < De * H; i += blockDim.x) w_s[i] = w_e[i];
  } else {
    for (int i = threadIdx.x; i < De * Hc; i += blockDim.x) {
      const int d = i / Hc, f = i - d * Hc;
      w_s[i] = f < nf ? w_e[(int64_t)d * H + c0 + f] : 0.f;
    }
  }
}

// A block takes rows blockIdx.x * 8 .. + 7 and, on the columns path, the
// columns c0 = blockIdx.y * Hc .. c0 + Hc - 1 (all H on the shared path).
template <int ACT, int NF, int WHERE, typename TK>
__global__ void __launch_bounds__(kWarps * 32)
edge_act_reduce_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
                       const float* __restrict__ e_basis,
                       const float* __restrict__ w_e,
                       const int* __restrict__ slot_src,
                       const int* __restrict__ slot_edge,
                       const float* __restrict__ scale,
                       const int* __restrict__ row_key,
                       const int* __restrict__ row_ptr, int R, int H, int De,
                       int Hc, float slope, float* __restrict__ rows,
                       float* __restrict__ srows) {
  constexpr bool COLS = WHERE != LOOP_SHARED, DEV = WHERE == LOOP_DEVICE;
  extern __shared__ float w_s[];  // [De, H], or [De, Hc] on the columns path
  const int c0 = COLS ? blockIdx.y * Hc : 0;
  const int nf = COLS ? min(Hc, H - c0) : H;  // the block's columns
  if constexpr (!DEV) {
    load_w<WHERE>(w_e, H, De, c0, Hc, nf, w_s);
    __syncthreads();
  }
  const float* w = DEV ? w_e + c0 : w_s;
  const int ldw = WHERE == LOOP_COLUMNS ? Hc : H;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp leaves together
  const int s0 = row_ptr[r];
  const int s1 = row_ptr[r + 1];
  const float* eq_row = eq + (int64_t)row_key[r] * H + c0;
  for (int f0 = 0; f0 < nf; f0 += 32 * NF) {
    float q[NF], acc[NF], sacc[NF], eh[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + j * 32 + lane;
      q[j] = f < nf ? eq_row[f] : 0.f;
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
        edge_term<NF>(e_basis + (int64_t)edge * De, w, ldw, De, nf, f0, lane,
                      eh);
        const TK* ek_row = ek + (int64_t)src * H + c0;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = f0 + j * 32 + lane;
          if (f < nf) {
            const float z = (to_f32(ek_row[f]) + eh[j]) + q[j];
            float a, d;
            act_both<ACT>(z, slope, a, d);
            acc[j] += a * sc;
            sacc[j] += d * sc;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = f0 + j * 32 + lane;
      if (f < nf) {
        rows[(int64_t)r * H + c0 + f] = acc[j];
        srows[(int64_t)r * H + c0 + f] = sacc[j];
      }
    }
  }
}

// A persistent grid: block (x, y) walks rows x * 8 + warp, then + 8 *
// gridDim.x, on the columns c0 = y * Hc .. c0 + Hc - 1 (all H on the
// shared path). Without LOOP_DEVICE, W_E's columns and the warps' g_WE
// partials [8, De, columns] sit in shared memory and the block writes
// their sum, in warp order, to its row x of gwe_part [gridDim.x, De, H];
// with it, W_E is read from device memory and warp w's partial is row x *
// 8 + w of gwe_part [gridDim.x * 8, De, H], each lane adding into the
// columns it owns.
template <int ACT, int NF, int WHERE, typename T>
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
                    int Hc, float slope, float* __restrict__ out,
                    float* __restrict__ gwe_part) {
  constexpr bool COLS = WHERE != LOOP_SHARED, DEV = WHERE == LOOP_DEVICE;
  extern __shared__ float smem[];
  const int c0 = COLS ? blockIdx.y * Hc : 0;
  const int nf = COLS ? min(Hc, H - c0) : H;  // the block's columns
  const int hc = COLS ? Hc : H;  // the width of its shared tables
  const int n_w = De * hc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* w_s = smem;           // [De, hc]
  float* part_s = smem + n_w;  // [kWarps, De, hc]
  float* part_w =
      DEV ? gwe_part + ((int64_t)blockIdx.x * kWarps + warp) * De * H + c0
          : part_s + (int64_t)warp * n_w;
  const int ldp = DEV ? H : hc;
  if constexpr (DEV) {
    // each lane clears the columns it adds into below (f = lane mod 32)
    for (int d = 0; d < De; ++d)
      for (int f = lane; f < nf; f += 32) part_w[(int64_t)d * H + f] = 0.f;
  } else {
    load_w<WHERE>(w_e, H, De, c0, Hc, nf, w_s);
    for (int i = threadIdx.x; i < kWarps * n_w; i += blockDim.x)
      part_s[i] = 0.f;
    __syncthreads();
  }
  const float* w = DEV ? w_e + c0 : w_s;
  const int ldw = DEV ? H : hc;
  // no early return: every warp reaches the block's final barrier
  for (int r = blockIdx.x * kWarps + warp; r < R; r += gridDim.x * kWarps) {
    const int s0 = row_ptr[r];
    const int s1 = row_ptr[r + 1];
    const float* ek_row = ek + (int64_t)row_key[r] * H + c0;
    for (int f0 = 0; f0 < nf; f0 += 32 * NF) {
      float kv[NF], acc[NF], eh[NF];
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int f = f0 + j * 32 + lane;
        kv[j] = f < nf ? ek_row[f] : 0.f;
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
          edge_term<NF>(basis, w, ldw, De, nf, f0, lane, eh);
          const T* eq_row = eq + (int64_t)dst * H + c0;
          const T* g_row = g + (int64_t)dst * H + c0;
          float gz[NF];
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            const int f = f0 + j * 32 + lane;
            gz[j] = 0.f;
            if (f < nf) {
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
              float* p_row = part_w + (DEV ? (int64_t)(d0 + kd) * ldp
                                           : (int64_t)((d0 + kd) * ldp));
#pragma unroll
              for (int j = 0; j < NF; ++j) {
                const int f = f0 + j * 32 + lane;
                if (f < nf) p_row[f] = fmaf(b, gz[j], p_row[f]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int f = f0 + j * 32 + lane;
        if (f < nf) out[(int64_t)r * H + c0 + f] = acc[j];
      }
    }
  }
  if constexpr (!DEV) {
    __syncthreads();
    float* dst = gwe_part + (int64_t)blockIdx.x * De * H + c0;
    for (int i = threadIdx.x; i < n_w; i += blockDim.x) {
      const int d = COLS ? i / hc : 0, f = COLS ? i - d * hc : i;
      if (COLS && f >= nf) continue;
      float s = 0.f;
      for (int v = 0; v < kWarps; ++v) s += part_s[(int64_t)v * n_w + i];
      dst[COLS ? d * H + f : i] = s;
    }
  }
}

// ---------------------------------------------------------------------
// The register path
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// The slot range and key of the warp's rows k0 .. k0 + 31 in its walk, lane
// l holding row gw + (k0 + l) * nw (an empty range past R).
struct RowGroup {
  int k0, s0, s1, key;
};

__device__ __forceinline__ void load_rows(RowGroup& g, int k0,
                                          const int* __restrict__ row_ptr,
                                          const int* __restrict__ row_key,
                                          int R, int gw, int nw, int lane) {
  const int64_t r = gw + (int64_t)(k0 + lane) * nw;
  const bool in = r < R;
  g.k0 = k0;
  g.s0 = in ? row_ptr[r] : 0;
  g.s1 = in ? row_ptr[r + 1] : 0;
  g.key = in ? row_key[r] : 0;
}

// Slots s .. min(s + 32, s1) - 1 of the warp's k-th row, whose key is key;
// first when they start the row.
struct Chunk {
  int k, s, s1, key;
  bool first;
};

// The first chunk of the warp's k-th row; the next 32 rows' ranges are
// loaded when k leaves the group (the branch is the warp's).
__device__ __forceinline__ Chunk row_chunk(int k, RowGroup& g,
                                           const int* __restrict__ row_ptr,
                                           const int* __restrict__ row_key,
                                           int R, int gw, int nw, int lane) {
  if (k - g.k0 >= 32) load_rows(g, k, row_ptr, row_key, R, gw, nw, lane);
  const int i = k - g.k0;
  return Chunk{k, __shfl_sync(kFull, g.s0, i), __shfl_sync(kFull, g.s1, i),
               __shfl_sync(kFull, g.key, i), true};
}

// Step c to the next chunk of the warp's walk; false past its last row.
__device__ __forceinline__ bool next_chunk(Chunk& c, RowGroup& g,
                                           const int* __restrict__ row_ptr,
                                           const int* __restrict__ row_key,
                                           int R, int gw, int nw, int lane) {
  if (c.s + 32 < c.s1) {
    c.s += 32;
    c.first = false;
    return true;
  }
  if (gw + (int64_t)(c.k + 1) * nw >= R) return false;
  c = row_chunk(c.k + 1, g, row_ptr, row_key, R, gw, nw, lane);
  return true;
}

// Lane l's slot of a chunk: the node it gathers, its edge and scale (0
// past the row).
struct Slots {
  int node, edge;
  float sc;
};

__device__ __forceinline__ Slots load_slots(const Chunk& c,
                                            const int* __restrict__ slot_node,
                                            const int* __restrict__ slot_edge,
                                            const float* __restrict__ scale,
                                            int lane) {
  const int s = c.s + lane;
  Slots t{0, 0, 0.f};
  if (s < c.s1) {
    t.node = slot_node[s];
    t.edge = slot_edge[s];
    t.sc = scale[s];
  }
  return t;
}

// Lane l copies its slot's basis row into row l of the warp's ring [32, DB]
// (when `mine`), and commits the copies as one group.
template <int DB>
__device__ __forceinline__ void copy_basis(const float* __restrict__ e_basis,
                                           int De, int vec, const Slots& t,
                                           bool mine, float* ring, int lane) {
  if (mine) {
    const float* src = e_basis + (int64_t)t.edge * De;
    float* dst = ring + lane * DB;
    if (vec) {
      for (int d = 0; d < De; d += 4) cp_async16(dst + d, src + d);
    } else {
      for (int d = 0; d < De; ++d) cp_async4(dst + d, src + d);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this lane's copies and make the warp's visible to every lane.
__device__ __forceinline__ void ring_ready() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Row k of the ring, read by every lane at one address (a broadcast).
template <int DB>
__device__ __forceinline__ void ring_row(const float* ring, int k, float* b) {
  const float4* row = reinterpret_cast<const float4*>(ring + k * DB);
#pragma unroll
  for (int i = 0; i < DB / 4; ++i) {
    const float4 v = row[i];
    b[4 * i] = v.x;
    b[4 * i + 1] = v.y;
    b[4 * i + 2] = v.z;
    b[4 * i + 3] = v.w;
  }
}

// The lane's W_E columns, 0 past De and H.
template <int NF, int DB>
__device__ __forceinline__ void load_w(const float* __restrict__ w_e, int H,
                                       int De, int lane, float (&w)[DB][NF]) {
#pragma unroll
  for (int d = 0; d < DB; ++d) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = j * 32 + lane;
      w[d][j] = d < De && f < H ? w_e[d * H + f] : 0.f;
    }
  }
}

// e_h[j] = sum_d b[d] * w[d][j], in increasing d as edge_term sums.
template <int NF, int DB>
__device__ __forceinline__ void project(const float* b,
                                        const float (&w)[DB][NF], float* eh) {
#pragma unroll
  for (int j = 0; j < NF; ++j) eh[j] = 0.f;
#pragma unroll
  for (int d = 0; d < DB; ++d) {
#pragma unroll
    for (int j = 0; j < NF; ++j) eh[j] = fmaf(b[d], w[d][j], eh[j]);
  }
}

// The lane's features of row `node` of an [N, H] table.
template <int NF, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ tbl, int node,
                                         int H, int lane, T (&v)[NF]) {
  const T* row = tbl + (int64_t)node * H;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = j * 32 + lane;
    if (f < H) v[j] = row[f];
  }
}

template <int ACT, int NF, int DB, typename TK>
__global__ void __launch_bounds__(kRegWarps * 32, 4)
edge_act_reduce_reg_kernel(const float* __restrict__ eq,
                           const TK* __restrict__ ek,
                           const float* __restrict__ e_basis,
                           const float* __restrict__ w_e,
                           const int* __restrict__ slot_src,
                           const int* __restrict__ slot_edge,
                           const float* __restrict__ scale,
                           const int* __restrict__ row_key,
                           const int* __restrict__ row_ptr, int R, int H,
                           int De, float slope, int vec,
                           float* __restrict__ rows,
                           float* __restrict__ srows) {
  constexpr int U = kRegInflightFwd;
  extern __shared__ __align__(16) float reg_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kRegWarps + warp;
  const int nw = gridDim.x * kRegWarps;
  if (gw >= R) return;  // the whole warp leaves together
  float* ring = reg_smem + warp * 32 * DB;  // [32, DB], 0 past De
  for (int i = lane; i < 32 * DB; i += 32) ring[i] = 0.f;
  float w[DB][NF];
  load_w<NF, DB>(w_e, H, De, lane, w);
  RowGroup grp;
  load_rows(grp, 0, row_ptr, row_key, R, gw, nw, lane);
  Chunk c = row_chunk(0, grp, row_ptr, row_key, R, gw, nw, lane);
  Slots cur = load_slots(c, slot_src, slot_edge, scale, lane);
  float q[NF], acc[NF], sacc[NF];
  TK buf[U][NF] = {};  // node rows in flight, slot k in buf[k % U]
  float bsc[U];        // their scales, 0 for a slot that loads nothing
  for (;;) {
    Chunk nc = c;
    const bool more = next_chunk(nc, grp, row_ptr, row_key, R, gw, nw, lane);
    const Slots nxt = more ? load_slots(nc, slot_src, slot_edge, scale, lane)
                           : Slots{0, 0, 0.f};
    const int n = min(32, c.s1 - c.s);
    if (c.first) {
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int f = j * 32 + lane;
        q[j] = f < H ? eq[(int64_t)c.key * H + f] : 0.f;
        acc[j] = 0.f;
        sacc[j] = 0.f;
      }
    }
    __syncwarp();  // every lane is done with the ring's last chunk
    copy_basis<DB>(e_basis, De, vec, cur, lane < n && cur.sc != 0.f, ring,
                   lane);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int src = __shfl_sync(kFull, cur.node, u);
      const float sc = __shfl_sync(kFull, cur.sc, u);
      bsc[u] = u < n ? sc : 0.f;
      if (bsc[u] != 0.f) load_row<NF>(ek, src, H, lane, buf[u]);
    }
    ring_ready();
    for (int k0 = 0; k0 < n; k0 += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u;
        const float sc = bsc[u];
        float kv[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) kv[j] = to_f32(buf[u][j]);
        // slot k + U's row goes in flight before slot k is computed
        const int kn = k + U;
        const int src_n = __shfl_sync(kFull, cur.node, kn & 31);
        const float sc_n = __shfl_sync(kFull, cur.sc, kn & 31);
        bsc[u] = kn < n ? sc_n : 0.f;
        if (bsc[u] != 0.f) load_row<NF>(ek, src_n, H, lane, buf[u]);
        if (sc == 0.f) continue;  // warp-uniform
        float b[DB], eh[NF];
        ring_row<DB>(ring, k, b);
        project<NF, DB>(b, w, eh);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = j * 32 + lane;
          if (f < H) {
            const float z = (kv[j] + eh[j]) + q[j];
            float a, d;
            act_both<ACT>(z, slope, a, d);
            acc[j] += a * sc;
            sacc[j] += d * sc;
          }
        }
      }
    }
    if (c.s + 32 >= c.s1) {  // the row's last chunk
      const int64_t r = gw + (int64_t)c.k * nw;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int f = j * 32 + lane;
        if (f < H) {
          rows[r * H + f] = acc[j];
          srows[r * H + f] = sacc[j];
        }
      }
    }
    if (!more) break;
    c = nc;
    cur = nxt;
  }
}

// Four consecutive values of a gathered ek row, as loaded: one 16-byte
// (f32) or 8-byte (bf16) load where vec, else four loads, each masked by
// ok; widened to f32 where the slot is worked, so that the load stays in
// flight until then. A bf16 value is the top half of its f32 value.
template <typename T>
struct Gather4;
template <>
struct Gather4<float> {
  float v[4];
  __device__ __forceinline__ void load(const float* p, int vec,
                                       const bool (&ok)[4]) {
    if (vec) {
      const float4 t = ok[0] ? __ldg(reinterpret_cast<const float4*>(p))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = ok[i] ? __ldg(p + i) : 0.f;
    }
  }
  __device__ __forceinline__ void widen(float (&f)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = v[i];
  }
};
template <>
struct Gather4<__nv_bfloat16> {
  uint32_t lo, hi;  // values 0, 1 and 2, 3, the first of each in the low half
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int vec,
                                       const bool (&ok)[4]) {
    if (vec) {
      const uint2 t = ok[0] ? __ldg(reinterpret_cast<const uint2*>(p))
                            : make_uint2(0u, 0u);
      lo = t.x;
      hi = t.y;
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = ok[i] ? __ldg(s + i) : 0u;
      lo = u[0] | u[1] << 16;
      hi = u[2] | u[3] << 16;
    }
  }
  __device__ __forceinline__ void widen(float (&f)[4]) const {
    f[0] = __uint_as_float(lo << 16);
    f[1] = __uint_as_float(lo & 0xffff0000u);
    f[2] = __uint_as_float(hi << 16);
    f[3] = __uint_as_float(hi & 0xffff0000u);
  }
};

// The blocks-of-columns kernel's slots in flight and the blocks an SM it
// asks room for, by the basis values a slot held (DB) and the bytes of an
// ek value: with 16 basis values (64 of W_E's registers) in bf16 two slots
// under the cap of 128 registers (16 warps an SM, no spill), in f32 four
// slots uncapped (12 warps, 163 registers); else four slots under the cap.
// At H = 512 on an H100 (PERF.md) four slots in bf16 spilled 44-68 bytes
// under the cap and ran 1.19x slower (1.12x uncapped), in f32 192 bytes
// and 1.44x (two slots capped 1.50x); eight slots lost 1.05-1.39x; with
// DB = 8 the cap ran 1.00-1.13x faster than none.
__host__ __device__ constexpr int cols_inflight(int db, int bytes) {
  return db == 16 && bytes == 2 ? 2 : 4;
}

__host__ __device__ constexpr int cols_min_blocks(int db, int bytes) {
  return db == 16 && bytes == 4 ? 3 : 4;
}

// #7 on the register path past kRegMaxH columns. Block x takes the columns
// c0 = (x mod C) * 128 .. c0 + 127 (kMaxChunk; fewer in the last of the C
// blocks of a row) of the rows of row walker x / C: its warp w walks rows
// (x / C) * kRegWarps + w, then + kRegWarps * gridDim.x / C, as the
// register kernel walks them. Lane l owns the features c0 + 4 l .. c0 + 4 l
// + 3 (ok: within H) and their W_E columns, DB x 4 values in registers (0
// past De and H); a slot's ek values are one load (Gather4: 16 or 8 bytes
// where rvec) with cols_inflight slots in flight, its basis row four (or
// two) 16-byte broadcasts from the warp's ring, and e_h the register
// kernel's project: the same fmaf chain in d, z = (ek + e_h) + eq and the
// row's sums in slot order, so rows and srows are every path's bits.
template <int ACT, int DB, typename TK>
__global__ void __launch_bounds__(kRegWarps * 32,
                                  cols_min_blocks(DB, (int)sizeof(TK)))
edge_act_reduce_cols_kernel(const float* __restrict__ eq,
                            const TK* __restrict__ ek,
                            const float* __restrict__ e_basis,
                            const float* __restrict__ w_e,
                            const int* __restrict__ slot_src,
                            const int* __restrict__ slot_edge,
                            const float* __restrict__ scale,
                            const int* __restrict__ row_key,
                            const int* __restrict__ row_ptr, int R, int H,
                            int De, float slope, int vec, int rvec,
                            float* __restrict__ rows,
                            float* __restrict__ srows) {
  constexpr int U = cols_inflight(DB, (int)sizeof(TK));
  extern __shared__ __align__(16) float reg_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = (H + kMaxChunk - 1) / kMaxChunk;
  const int f0 = (int)(blockIdx.x % chunks) * kMaxChunk + 4 * lane;
  const int gw = (int)(blockIdx.x / chunks) * kRegWarps + warp;
  const int nw = (int)(gridDim.x / chunks) * kRegWarps;
  if (gw >= R) return;  // the whole warp leaves together
  bool ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ok[i] = f0 + i < H;
  float* ring = reg_smem + warp * 32 * DB;  // [32, DB], 0 past De
  for (int i = lane; i < 32 * DB; i += 32) ring[i] = 0.f;
  float w[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[d][i] = d < De && ok[i] ? w_e[(int64_t)d * H + f0 + i] : 0.f;
  }
  const TK* ek_lane = ek + f0;  // the lane's values of node 0's row
  RowGroup grp;
  load_rows(grp, 0, row_ptr, row_key, R, gw, nw, lane);
  Chunk c = row_chunk(0, grp, row_ptr, row_key, R, gw, nw, lane);
  Slots cur = load_slots(c, slot_src, slot_edge, scale, lane);
  float q[4], acc[4], sacc[4];
  Gather4<TK> buf[U] = {};  // ek values in flight, slot k in buf[k % U]
  float bsc[U];             // their scales, 0 for a slot that loads nothing
  for (;;) {
    Chunk nc = c;
    const bool more = next_chunk(nc, grp, row_ptr, row_key, R, gw, nw, lane);
    const Slots nxt = more ? load_slots(nc, slot_src, slot_edge, scale, lane)
                           : Slots{0, 0, 0.f};
    const int n = min(32, c.s1 - c.s);
    if (c.first) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q[i] = ok[i] ? eq[(int64_t)c.key * H + f0 + i] : 0.f;
        acc[i] = 0.f;
        sacc[i] = 0.f;
      }
    }
    __syncwarp();  // every lane is done with the ring's last chunk
    copy_basis<DB>(e_basis, De, vec, cur, lane < n && cur.sc != 0.f, ring,
                   lane);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int src = __shfl_sync(kFull, cur.node, u);
      const float sc = __shfl_sync(kFull, cur.sc, u);
      bsc[u] = u < n ? sc : 0.f;
      if (bsc[u] != 0.f) buf[u].load(ek_lane + (int64_t)src * H, rvec, ok);
    }
    ring_ready();
    for (int k0 = 0; k0 < n; k0 += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u;
        const float sc = bsc[u];
        float kv[4];
        buf[u].widen(kv);
        // slot k + U's values go in flight before slot k is computed
        const int kn = k + U;
        const int src_n = __shfl_sync(kFull, cur.node, kn & 31);
        const float sc_n = __shfl_sync(kFull, cur.sc, kn & 31);
        bsc[u] = kn < n ? sc_n : 0.f;
        if (bsc[u] != 0.f)
          buf[u].load(ek_lane + (int64_t)src_n * H, rvec, ok);
        if (sc == 0.f) continue;  // warp-uniform
        float b[DB], eh[4];
        ring_row<DB>(ring, k, b);
        project<4, DB>(b, w, eh);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (ok[i]) {
            const float z = (kv[i] + eh[i]) + q[i];
            float a, d;
            act_both<ACT>(z, slope, a, d);
            acc[i] += a * sc;
            sacc[i] += d * sc;
          }
        }
      }
    }
    if (c.s + 32 >= c.s1) {  // the row's last chunk
      const int64_t r = gw + (int64_t)c.k * nw;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ok[i]) {
          rows[r * H + f0 + i] = acc[i];
          srows[r * H + f0 + i] = sacc[i];
        }
      }
    }
    if (!more) break;
    c = nc;
    cur = nxt;
  }
}

template <int ACT, int NF, int DB, typename T>
__global__ void __launch_bounds__(kRegWarps * 32, 3)
edge_src_bwd_reg_kernel(const T* __restrict__ eq, const T* __restrict__ g,
                        const float* __restrict__ ek,
                        const float* __restrict__ e_basis,
                        const float* __restrict__ w_e,
                        const int* __restrict__ slot_dst,
                        const int* __restrict__ slot_edge,
                        const float* __restrict__ scale,
                        const int* __restrict__ row_key,
                        const int* __restrict__ row_ptr, int R, int H, int De,
                        float slope, int vec, float* __restrict__ out,
                        float* __restrict__ gwe_part) {
  constexpr int U = inflight_bwd(ACT);
  extern __shared__ __align__(16) float reg_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kRegWarps + warp;
  const int nw = gridDim.x * kRegWarps;
  float* ring = reg_smem + warp * 32 * DB;  // [32, DB], 0 past De
  for (int i = lane; i < 32 * DB; i += 32) ring[i] = 0.f;
  float w[DB][NF];
  load_w<NF, DB>(w_e, H, De, lane, w);
  float part[DB][NF];  // the warp's g_WE partial, the lane's columns
#pragma unroll
  for (int d = 0; d < DB; ++d) {
#pragma unroll
    for (int j = 0; j < NF; ++j) part[d][j] = 0.f;
  }
  // no early return: every warp reaches the block's barriers
  if (gw < R) {
    RowGroup grp;
    load_rows(grp, 0, row_ptr, row_key, R, gw, nw, lane);
    Chunk c = row_chunk(0, grp, row_ptr, row_key, R, gw, nw, lane);
    Slots cur = load_slots(c, slot_dst, slot_edge, scale, lane);
    float kv[NF], acc[NF];
    T qb[U][NF] = {}, gb[U][NF] = {};  // eq and g rows in flight
    float bsc[U];
    for (;;) {
      Chunk nc = c;
      const bool more =
          next_chunk(nc, grp, row_ptr, row_key, R, gw, nw, lane);
      const Slots nxt = more
                            ? load_slots(nc, slot_dst, slot_edge, scale, lane)
                            : Slots{0, 0, 0.f};
      const int n = min(32, c.s1 - c.s);
      if (c.first) {
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = j * 32 + lane;
          kv[j] = f < H ? ek[(int64_t)c.key * H + f] : 0.f;
          acc[j] = 0.f;
        }
      }
      __syncwarp();  // every lane is done with the ring's last chunk
      copy_basis<DB>(e_basis, De, vec, cur, lane < n && cur.sc != 0.f, ring,
                     lane);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int dst = __shfl_sync(kFull, cur.node, u);
        const float sc = __shfl_sync(kFull, cur.sc, u);
        bsc[u] = u < n ? sc : 0.f;
        if (bsc[u] != 0.f) {
          load_row<NF>(eq, dst, H, lane, qb[u]);
          load_row<NF>(g, dst, H, lane, gb[u]);
        }
      }
      ring_ready();
      for (int k0 = 0; k0 < n; k0 += U) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = k0 + u;
          const float sc = bsc[u];
          float qv[NF], gv[NF];
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            qv[j] = to_f32(qb[u][j]);
            gv[j] = to_f32(gb[u][j]);
          }
          const int kn = k + U;
          const int dst_n = __shfl_sync(kFull, cur.node, kn & 31);
          const float sc_n = __shfl_sync(kFull, cur.sc, kn & 31);
          bsc[u] = kn < n ? sc_n : 0.f;
          if (bsc[u] != 0.f) {
            load_row<NF>(eq, dst_n, H, lane, qb[u]);
            load_row<NF>(g, dst_n, H, lane, gb[u]);
          }
          if (sc == 0.f) continue;  // warp-uniform
          float b[DB], eh[NF], gz[NF];
          ring_row<DB>(ring, k, b);
          project<NF, DB>(b, w, eh);
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            const int f = j * 32 + lane;
            gz[j] = 0.f;
            if (f < H) {
              const float z = (qv[j] + eh[j]) + kv[j];
              gz[j] = act_grad<ACT>(z, slope) * (gv[j] * sc);
              acc[j] += gz[j];
            }
          }
          // g_WE[d, f] += egr_d * g_z[f]; the padded d add exactly 0
#pragma unroll
          for (int d = 0; d < DB; ++d) {
#pragma unroll
            for (int j = 0; j < NF; ++j)
              part[d][j] = fmaf(b[d], gz[j], part[d][j]);
          }
        }
      }
      if (c.s + 32 >= c.s1) {  // the row's last chunk
        const int64_t r = gw + (int64_t)c.k * nw;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = j * 32 + lane;
          if (f < H) out[r * H + f] = acc[j];
        }
      }
      if (!more) break;
      c = nc;
      cur = nxt;
    }
  }
  __syncthreads();  // every ring is done: its memory takes the partials
  const int n_w = De * H;
  float* part_s = reg_smem;  // [kRegWarps, De, H]
#pragma unroll
  for (int d = 0; d < DB; ++d) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = j * 32 + lane;
      if (d < De && f < H) part_s[warp * n_w + d * H + f] = part[d][j];
    }
  }
  __syncthreads();
  float* dst = gwe_part + (int64_t)blockIdx.x * n_w;
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < kRegWarps; ++v) s += part_s[v * n_w + i];
    dst[i] = s;
  }
}

// out[i] = sum over p in order of part[p, i].
__global__ void sum_partials_kernel(const float* __restrict__ part, int P,
                                    int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int p = 0; p < P; ++p) s += part[(int64_t)p * n + i];
  out[i] = s;
}

// ---------------------------------------------------------------------
// The tiles path: #8 on the columns path's shapes with De <= 16
// ---------------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// an integer add and a mask (ell_max_kernels.cu's tf32_rna).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo as two TF32 values, each rounded to nearest (ties away).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));  // x - hi is exact
}

// d += a b for one m16n8k8 TF32 tile (f32 accumulators).
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tiles path: the valid slots a g_WE tile (the products' K); the g_z
// tile's row stride in floats (a multiple of 4, 8 mod 32: its fragment
// reads hit 32 banks); the most slots a batch; a stage of a batch in
// floats: its live slots' gathered rows, 4 KB (the eq and g chunks of 8
// slots of bf16 or 4 of f32), then their basis rows [8, 16] (0 past De)
// and scales [8]; and the slots a batch, by the gathered type.
constexpr int kTileSlots = 16;
constexpr int kTileLdz = kMaxChunk + 8;
constexpr int kStageSlots = 8;
constexpr int kStageRowFloats = 1024;
constexpr int kStageBasis = kStageRowFloats;
constexpr int kStageScales = kStageBasis + kStageSlots * 16;
constexpr int kStageFloats = kStageScales + kStageSlots;

template <typename T>
__host__ __device__ constexpr int tile_inflight() {
  return kStageRowFloats * (int)sizeof(float) /
         (2 * kMaxChunk * (int)sizeof(T));
}

// The g_z tile's basis rows' stride in floats for DB basis values a slot
// (rows 16-byte aligned, its fragment reads on 32 banks).
__host__ __device__ constexpr int tile_ldb(int db) { return db == 16 ? 24 : 8; }

// Floats of the warp's g_WE sums [MT][NT][32] float4 (MT = kMaxChunk / 16
// feature tiles, NT = DB / 8 basis tiles).
__host__ __device__ constexpr int tile_acc_floats(int db) {
  return kMaxChunk / 16 * (db / 8) * 32 * 4;
}

// Floats of a warp's shared memory: two stages, its g_z tile [16,
// kTileLdz], the tile's basis rows [16, tile_ldb(DB)] and its g_WE sums
// (27,712 bytes at DB = 16: eight warps take 221,696 of a block's 227 KiB).
__host__ __device__ constexpr int tile_warp_floats(int db) {
  return 2 * kStageFloats + kTileSlots * kTileLdz + kTileSlots * tile_ldb(db) +
         tile_acc_floats(db);
}

// Four consecutive f32 values of a row (ek), as loaded (VEC: one 16-byte
// load, the four values all in or all past the row; else four loads, each
// masked) and widened where they are used, so that the load stays in
// flight until its batch is worked.
template <bool VEC>
struct Raw4;
template <>
struct Raw4<true> {
  uint4 u;
  __device__ __forceinline__ void load(const float* p, const bool (&ok)[4]) {
    u = ok[0] ? __ldg(reinterpret_cast<const uint4*>(p))
              : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void widen(float (&f)[4]) const {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Raw4<false> {
  float v[4];
  __device__ __forceinline__ void load(const float* p, const bool (&ok)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = ok[i] ? p[i] : 0.f;
  }
  __device__ __forceinline__ void widen(float (&f)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = v[i];
  }
};

// Four consecutive values of a staged row in shared memory (8 or 16 bytes
// at p), widened to f32; a bf16 value is the top half of its f32 value.
__device__ __forceinline__ void staged4(const __nv_bfloat16* p,
                                        float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void staged4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// acc += the tile's g_WE^T: for the chunk's features f (M, kMaxChunk / 16
// tiles of 16) and basis values d (N, DB / 8 tiles of 8), sum over the
// tile's 16 slots s (K, two steps of 8) of g_z[s, f] * egr[s, d]. zt is the
// warp's g_z tile [16, kTileLdz], eb the tile's 16 basis rows (tile_ldb(DB)
// apart, 0 past De), acc the warp's sums in shared memory as m16n8k8
// accumulators, a float4 a lane a (m, n) tile ([MT][NT][32] float4). Each
// product is the three-pass TF32 split (a_lo b_hi, a_hi b_lo, a_hi b_hi)
// of ell_max_kernels.cu, summed from zero a k step and added to acc in
// f32: the tensor core's own adder rounds with a bias, so no accumulator
// of it takes more than one step.
template <int DB>
__device__ __forceinline__ void tile_products(const float* zt,
                                              const float* eb, int lane,
                                              float4* acc) {
  constexpr int NT = DB / 8, LDB = tile_ldb(DB);
  const int gi = lane >> 2, ti = lane & 3;
  uint32_t bh[2][NT][2], bl[2][NT][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* b = eb + (ks * 8 + ti) * LDB + n * 8 + gi;
      split(b[0], bh[ks][n][0], bl[ks][n][0]);
      split(b[4 * LDB], bh[ks][n][1], bl[ks][n][1]);
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxChunk / 16; ++m) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // A = g_z^T [f, s]: (gi, ti), (gi + 8, ti), (gi, ti + 4), (gi + 8,
      // ti + 4)
      const float* a = zt + (ks * 8 + ti) * kTileLdz + m * 16 + gi;
      uint32_t ah[4], al[4];
      split(a[0], ah[0], al[0]);
      split(a[8], ah[1], al[1]);
      split(a[4 * kTileLdz], ah[2], al[2]);
      split(a[4 * kTileLdz + 8], ah[3], al[3]);
      float part[NT][4] = {};
#pragma unroll
      for (int n = 0; n < NT; ++n) mma(part[n], al, bh[ks][n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma(part[n], ah, bl[ks][n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma(part[n], ah, bh[ks][n]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float4& c = acc[(m * NT + n) * 32 + lane];
        c.x = __fadd_rn(c.x, part[n][0]);
        c.y = __fadd_rn(c.y, part[n][1]);
        c.z = __fadd_rn(c.z, part[n][2]);
        c.w = __fadd_rn(c.w, part[n][3]);
      }
    }
  }
}

// A row's slot range and key, and one lane's slot of a run of 32: what a
// warp loads ahead of the row it works on (ell_general_kernels.cu's).
struct Head {
  int s0, s1, key;
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

__device__ __forceinline__ Slots load_slot(const int* __restrict__ slot_node,
                                           const int* __restrict__ slot_edge,
                                           const float* __restrict__ scale,
                                           int base, int s1, int lane) {
  Slots d{0, 0, 0.f};
  const int mine = base + lane;
  if (mine < s1) {
    d.node = __ldg(slot_node + mine);
    d.edge = __ldg(slot_edge + mine);
    d.sc = __ldg(scale + mine);
  }
  return d;
}

// #8 on the tiles path. A block (x, y) takes the columns c0 = y * 128 ..
// c0 + 127 (kMaxChunk; fewer in the last chunk) of rows x * 8 + warp, then
// + 8 * gridDim.x: lane l owns the chunk's features 4 l .. 4 l + 3 and
// their W_E columns, DB x 4 values in registers (0 past De and H). A warp
// walks its rows' slots as a stream of batches of up to U slots of one run
// of 32 of a row (a row has at least one, an empty row one with no live
// slot). The next batch is issued, across row ends, before the current one
// is worked: its live slots' eq and g chunks copied into the warp's other
// stage in shared memory by cp.async (VEC: rows of whole 16-byte chunks,
// the tables 16-byte aligned; else by plain loads and stores) with their
// basis rows and scales, packed into the stage's first places, and on a
// row's first batch the row's ek values into registers (4 KB of rows a
// warp in flight). A slot with scale 0 gathers nothing and adds
// nothing. A live slot forms e_h = sum_d b_d W_E[d, f] by fmaf in
// increasing d, its z and g_z as the columns path does (so the g_ek rows
// are that path's bits), adds g_z to the row's sums and stores it, with
// its basis row, as the next row of the warp's g_z tile; a full tile of 16
// live slots (of any rows) goes into the warp's g_WE sums (in shared
// memory: in registers they spilled) on the tensor cores (tile_products),
// and the last, part-full one with its other rows 0. At the end the block
// sums its warps' g_WE in warp order into its row x of gwe_part
// [gridDim.x, De, H], which sum_partials_kernel sums in block order: no
// atomics, the same bits from launch to launch.
template <int ACT, int DB, bool VEC, typename T>
__global__ void __launch_bounds__(kWarps * 32, 1)
edge_src_bwd_tiles_kernel(const T* __restrict__ eq, const T* __restrict__ g,
                          const float* __restrict__ ek,
                          const float* __restrict__ e_basis,
                          const float* __restrict__ w_e,
                          const int* __restrict__ slot_dst,
                          const int* __restrict__ slot_edge,
                          const float* __restrict__ scale,
                          const int* __restrict__ row_key,
                          const int* __restrict__ row_ptr, int R, int H,
                          int De, float slope, int bvec,
                          float* __restrict__ out,
                          float* __restrict__ gwe_part) {
  constexpr int U = tile_inflight<T>(), LDB = tile_ldb(DB);
  constexpr int MT = kMaxChunk / 16, NT = DB / 8;
  constexpr int EPC = 16 / (int)sizeof(T);  // values a 16-byte chunk
  constexpr int CPR = kMaxChunk / EPC;      // chunks a staged row
  extern __shared__ __align__(16) float tile_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * kMaxChunk;
  const int nf = min(kMaxChunk, H - c0);  // the block's columns
  const int f0 = 4 * lane;                // the lane's first of them
  bool ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ok[i] = f0 + i < nf;
  // [2][kStageFloats]: a stage's rows [U][2][kMaxChunk] (T; eq, then g),
  // basis rows and scales; then the g_z tile, its basis rows and the
  // warp's g_WE sums
  float* stages = tile_smem + warp * tile_warp_floats(DB);
  float* zt = stages + 2 * kStageFloats;  // [16, kTileLdz]
  float* et = zt + kTileSlots * kTileLdz;  // [16, LDB]
  float4* accs = reinterpret_cast<float4*>(et + kTileSlots * LDB);
  for (int i = lane; i < kStageSlots * 16; i += 32) {
    stages[kStageBasis + i] = 0.f;  // the basis values past De stay 0
    stages[kStageFloats + kStageBasis + i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < MT * NT; ++i)
    accs[i * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();  // the zeros land before any lane's copy into a stage
  float w[DB][4];
#pragma unroll
  for (int d = 0; d < DB; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[d][i] = d < De && ok[i] ? w_e[(int64_t)d * H + c0 + f0 + i] : 0.f;
  }
  const int W = gridDim.x * kWarps;
  const int r0 = blockIdx.x * kWarps + warp;
  // no early return: every warp reaches the block's barriers
  if (r0 < R) {
    // The load cursor: row lr with head lh, the run of 32 slots at lbase
    // (the lane's slot of it in lmine), the batch at lk0 of the run; and
    // the next row's head and first run, loaded a row ahead. worked counts
    // the live slots worked: a live slot's row of the g_z tile is its
    // count mod 16.
    int lr = r0;
    Head lh = load_head(row_ptr, row_key, lr, R);
    int lbase = lh.s0, lk0 = 0;
    Slots lmine = load_slot(slot_dst, slot_edge, scale, lbase, lh.s1, lane);
    Head hn = load_head(row_ptr, row_key, lr + W, R);
    Slots first_n = load_slot(slot_dst, slot_edge, scale, hn.s0, hn.s1, lane);
    int worked = 0;

    struct Batch {
      float* stage;     // its live slots' rows and scales in shared memory
      Raw4<VEC> kr;     // a row's first batch: its ek values
      int row, live;    // live: its live slots, in the stage's first places
      bool first, last;
    };
    auto issue = [&](Batch& b) {
      const int n = min(32, lh.s1 - lbase);
      b.row = lr;
      b.first = lbase == lh.s0 && lk0 == 0;
      b.last = lk0 + U >= n && lbase + 32 >= lh.s1;
      if (b.first) b.kr.load(ek + (int64_t)lh.key * H + c0 + f0, ok);
      T* rows = reinterpret_cast<T*>(b.stage);
      __syncwarp();  // every lane is done with the stage's last batch
      b.live = 0;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int k = lk0 + j;  // within the run
        const int node = __shfl_sync(kFull, lmine.node, k & 31);
        const int edge = __shfl_sync(kFull, lmine.edge, k & 31);
        const float sc = __shfl_sync(kFull, lmine.sc, k & 31);
        if (k >= n || sc == 0.f) continue;  // warp-uniform: not live
        const int u = b.live++;  // its place in the stage
        if (lane == 0) b.stage[kStageScales + u] = sc;
        float* dst = b.stage + kStageBasis + u * 16;
        const float* src = e_basis + (int64_t)edge * De;
        if (bvec) {
          if (4 * lane < De) cp_async16(dst + 4 * lane, src + 4 * lane);
        } else {
          if (lane < De) cp_async4(dst + lane, src + lane);
        }
        const int64_t at = (int64_t)node * H + c0;
        T* row = rows + u * 2 * kMaxChunk;
        if constexpr (VEC) {
          // 16-byte chunks of eq's and g's chunk of the row, 2 CPR of them
#pragma unroll
          for (int c = lane; c < 2 * CPR; c += 32) {
            const int t = c / CPR, ch = c - t * CPR;
            if (ch * EPC < nf)
              cp_async16(reinterpret_cast<float*>(row + t * kMaxChunk +
                                                  ch * EPC),
                         reinterpret_cast<const float*>((t ? g : eq) + at +
                                                        ch * EPC));
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (ok[i]) {
              row[f0 + i] = eq[at + f0 + i];
              row[kMaxChunk + f0 + i] = g[at + f0 + i];
            }
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // move the cursor to the next batch; false past the warp's last row
    auto advance = [&]() -> bool {
      lk0 += U;
      if (lk0 < min(32, lh.s1 - lbase)) return true;
      lk0 = 0;
      lbase += 32;
      if (lbase < lh.s1) {
        lmine = load_slot(slot_dst, slot_edge, scale, lbase, lh.s1, lane);
        return true;
      }
      lr += W;
      if (lr >= R) return false;
      lh = hn;
      lbase = lh.s0;
      lmine = first_n;
      hn = load_head(row_ptr, row_key, lr + W, R);
      first_n = load_slot(slot_dst, slot_edge, scale, hn.s0, hn.s1, lane);
      return true;
    };

    float kv[4], oacc[4];
    bool more;
    // work batch cur with nxt's gathers in flight; false after the last
    auto step = [&](Batch& cur, Batch& nxt) -> bool {
      const bool issued_nxt = more;
      if (more) {
        issue(nxt);
        more = advance();
      }
      // cur's rows and basis rows have landed (nxt's may be in flight)
      if (issued_nxt)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();
      if (cur.first) {
        cur.kr.widen(kv);
#pragma unroll
        for (int i = 0; i < 4; ++i) oacc[i] = 0.f;
      }
      const T* rows = reinterpret_cast<const T*>(cur.stage);
#pragma unroll 1
      for (int u = 0; u < cur.live; ++u) {
        const float sc = cur.stage[kStageScales + u];
        const int p = worked & (kTileSlots - 1);  // its row of the tile
        ++worked;
        const float4* brow =
            reinterpret_cast<const float4*>(cur.stage + kStageBasis + u * 16);
        float b[DB];
#pragma unroll
        for (int i = 0; i < DB / 4; ++i) {
          const float4 v = brow[i];
          b[4 * i] = v.x;
          b[4 * i + 1] = v.y;
          b[4 * i + 2] = v.z;
          b[4 * i + 3] = v.w;
        }
        float eh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int d = 0; d < DB; ++d) {
#pragma unroll
          for (int i = 0; i < 4; ++i) eh[i] = fmaf(b[d], w[d][i], eh[i]);
        }
        float qv[4], gv[4], gz[4];
        staged4(rows + u * 2 * kMaxChunk + f0, qv);
        staged4(rows + u * 2 * kMaxChunk + kMaxChunk + f0, gv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gz[i] = 0.f;
          if (ok[i]) {
            const float z = (qv[i] + eh[i]) + kv[i];
            gz[i] = act_grad<ACT>(z, slope) * (gv[i] * sc);
            oacc[i] += gz[i];
          }
        }
        *reinterpret_cast<float4*>(zt + p * kTileLdz + f0) =
            make_float4(gz[0], gz[1], gz[2], gz[3]);
        if (lane < DB / 4)
          *reinterpret_cast<float4*>(et + p * LDB + 4 * lane) = brow[lane];
        if (p == kTileSlots - 1) {  // a full tile
          __syncwarp();
          tile_products<DB>(zt, et, lane, accs);
          __syncwarp();  // every lane has read the tile and its basis rows
        }
      }
      if (cur.last) {
        float* o = out + (int64_t)cur.row * H + c0 + f0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (ok[i]) o[i] = oacc[i];
      }
      return issued_nxt;
    };

    Batch A, B;
    A.stage = stages;
    B.stage = stages + kStageFloats;
    issue(A);
    more = advance();
    while (step(A, B) && step(B, A)) {
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    const int p0 = worked & (kTileSlots - 1);
    if (p0 != 0) {  // the part-full last tile, its other rows 0
      __syncwarp();
      for (int i = lane; i < (kTileSlots - p0) * kTileLdz; i += 32)
        zt[p0 * kTileLdz + i] = 0.f;
      for (int i = lane; i < (kTileSlots - p0) * LDB; i += 32)
        et[p0 * LDB + i] = 0.f;
      __syncwarp();
      tile_products<DB>(zt, et, lane, accs);
    }
  }
  float4 acc[MT * NT];  // the lane's sums, before the block's memory is reused
#pragma unroll
  for (int i = 0; i < MT * NT; ++i) acc[i] = accs[i * 32 + lane];
  // the warps' sums [kWarps, De, kMaxChunk] in the warps' memory, added in
  // warp order
  __syncthreads();
  float* part_s = tile_smem;
  const int gi = lane >> 2, ti = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = m * 16 + gi + (e >= 2 ? 8 : 0);
        const int d = n * 8 + 2 * ti + (e & 1);
        const float4 c = acc[m * NT + n];
        const float v = e == 0 ? c.x : e == 1 ? c.y : e == 2 ? c.z : c.w;
        if (d < De) part_s[(warp * De + d) * kMaxChunk + f] = v;
      }
  __syncthreads();
  float* dst = gwe_part + (int64_t)blockIdx.x * De * H + c0;
  for (int i = threadIdx.x; i < De * kMaxChunk; i += blockDim.x) {
    const int d = i / kMaxChunk, f = i - d * kMaxChunk;
    if (f >= nf) continue;
    float s = 0.f;
    for (int v = 0; v < kWarps; ++v)
      s += part_s[(v * De + d) * kMaxChunk + f];
    dst[(int64_t)d * H + f] = s;
  }
}

// ---------------------------------------------------------------------
// Host side: a launch's path, kernel instance and grid
// ---------------------------------------------------------------------

// Features a lane: the whole row on the register path, a pass's on the
// shared and columns paths (of a chunk of `cols` columns).
int feat_per_lane(int cols) {
  const int nf = (cols + 31) / 32;
  return nf < kMaxFeatPerLane ? nf : kMaxFeatPerLane;
}

// The basis values a register-path kernel holds a slot: De padded to 8 or 16.
int basis_width(int De) { return De <= 8 ? 8 : 16; }

bool fwd_on_registers(int H, int De) {
  return H <= kRegMaxH && De <= kRegMaxDe;
}

// #7 on the register path past kRegMaxH: blocks of kMaxChunk columns.
bool fwd_on_reg_blocks(int H, int De) {
  return H > kRegMaxH && De <= kRegMaxDe;
}

bool bwd_on_registers(int H, int De) {
  return fwd_on_registers(H, De) &&
         feat_per_lane(H) * basis_width(De) <= kRegMaxBwd;
}

// Path codes of ell_edge_layout.
enum { PATH_SHARED = 1, PATH_REGISTERS = 2, PATH_COLUMNS = 3, PATH_TILES = 4 };

// How a kernel of the shared-memory loop runs a width: its path (shared
// or columns), the columns a block takes (H on the shared path), where its
// tables sit (LOOP_*), and the block's dynamic shared memory. `tables` is
// the [De, columns] f32 tables a block holds: 1 (W_E) in #7, 1 + kWarps
// (the warps' partials besides) in #8.
struct Loop {
  int path, chunk, where;
  size_t smem;
  bool device() const { return where == LOOP_DEVICE; }
};

Loop loop_shape(int H, int De, int tables) {
  const size_t col = sizeof(float) * (size_t)tables * De;  // bytes a column
  if (col * H <= (size_t)kMaxSmem)
    return {PATH_SHARED, H, LOOP_SHARED, col * H};
  const size_t fit = (size_t)kMaxSmem / col / 32 * 32;
  const bool device = fit < 32;
  const int most = device || fit > (size_t)kMaxChunk ? kMaxChunk : (int)fit;
  const int chunks = (H + most - 1) / most;
  const int chunk = ((H + chunks - 1) / chunks + 31) / 32 * 32;
  return {PATH_COLUMNS, chunk, device ? LOOP_DEVICE : LOOP_COLUMNS,
          device ? 0 : col * chunk};
}

Loop fwd_loop(int H, int De) { return loop_shape(H, De, 1); }
Loop bwd_loop(int H, int De) { return loop_shape(H, De, 1 + kWarps); }

size_t fwd_smem(int H, int De) {
  if (fwd_on_registers(H, De) || fwd_on_reg_blocks(H, De))
    return sizeof(float) * kRegWarps * 32 * basis_width(De);
  return fwd_loop(H, De).smem;
}

// #8 on the tiles path: the backward's shapes past a block's shared memory
// (the columns path) with a basis of at most kRegMaxDe values.
bool bwd_on_tiles(int H, int De) {
  return !bwd_on_registers(H, De) && De <= kRegMaxDe &&
         bwd_loop(H, De).path == PATH_COLUMNS;
}

// A tiles-path block's shared memory: its warps' g_z tiles and basis rings,
// which at the end hold the warps' [De, kMaxChunk] g_WE sums.
size_t tiles_smem(int De) {
  const size_t walk = (size_t)kWarps * tile_warp_floats(basis_width(De));
  const size_t sums = (size_t)kWarps * De * kMaxChunk;
  return sizeof(float) * (walk > sums ? walk : sums);
}

size_t bwd_smem(int H, int De) {
  if (bwd_on_tiles(H, De)) return tiles_smem(De);
  if (bwd_on_registers(H, De)) {
    const size_t ring = (size_t)kRegWarps * 32 * basis_width(De);
    const size_t parts = (size_t)kRegWarps * De * H;
    return sizeof(float) * (ring > parts ? ring : parts);
  }
  return bwd_loop(H, De).smem;
}

int fwd_path(int H, int De) {
  return fwd_on_registers(H, De) || fwd_on_reg_blocks(H, De)
             ? PATH_REGISTERS
             : fwd_loop(H, De).path;
}

int bwd_path(int H, int De) {
  if (bwd_on_tiles(H, De)) return PATH_TILES;
  return bwd_on_registers(H, De) ? PATH_REGISTERS : bwd_loop(H, De).path;
}

#define EDGE_REG_CASE(KERNEL, NF, DB) \
  if (nf == NF && db == DB) return (const void*)KERNEL<ACT, NF, DB, T>;

#define EDGE_LOOP_CASES(KERNEL, WHERE)                        \
  switch (nf) {                                               \
    case 1: return (const void*)KERNEL<ACT, 1, WHERE, T>;     \
    case 2: return (const void*)KERNEL<ACT, 2, WHERE, T>;     \
    case 3: return (const void*)KERNEL<ACT, 3, WHERE, T>;     \
    default: return (const void*)KERNEL<ACT, 4, WHERE, T>;    \
  }

// The loop kernel for its tables' place and a chunk's features a lane.
template <int ACT, typename T>
const void* fwd_loop_kernel(const Loop& s) {
  const int nf = feat_per_lane(s.chunk);
  if (s.where == LOOP_SHARED)
    EDGE_LOOP_CASES(edge_act_reduce_kernel, LOOP_SHARED)
  if (s.where == LOOP_COLUMNS)
    EDGE_LOOP_CASES(edge_act_reduce_kernel, LOOP_COLUMNS)
  EDGE_LOOP_CASES(edge_act_reduce_kernel, LOOP_DEVICE)
}

template <int ACT, typename T>
const void* bwd_loop_kernel(const Loop& s) {
  const int nf = feat_per_lane(s.chunk);
  if (s.where == LOOP_SHARED)
    EDGE_LOOP_CASES(edge_src_bwd_kernel, LOOP_SHARED)
  if (s.where == LOOP_COLUMNS)
    EDGE_LOOP_CASES(edge_src_bwd_kernel, LOOP_COLUMNS)
  EDGE_LOOP_CASES(edge_src_bwd_kernel, LOOP_DEVICE)
}

// The kernel instance for (act, edge type, H, De), so that the occupancy
// query and the launch see the same one.
template <int ACT, typename T>
const void* pick_fwd(int H, int De) {
  const int nf = feat_per_lane(H), db = basis_width(De);
  if (fwd_on_reg_blocks(H, De))
    return db == 8 ? (const void*)edge_act_reduce_cols_kernel<ACT, 8, T>
                   : (const void*)edge_act_reduce_cols_kernel<ACT, 16, T>;
  if (fwd_on_registers(H, De)) {
    EDGE_REG_CASE(edge_act_reduce_reg_kernel, 1, 8)
    EDGE_REG_CASE(edge_act_reduce_reg_kernel, 2, 8)
    EDGE_REG_CASE(edge_act_reduce_reg_kernel, 3, 8)
    EDGE_REG_CASE(edge_act_reduce_reg_kernel, 4, 8)
    EDGE_REG_CASE(edge_act_reduce_reg_kernel, 1, 16)
    EDGE_REG_CASE(edge_act_reduce_reg_kernel, 2, 16)
    EDGE_REG_CASE(edge_act_reduce_reg_kernel, 3, 16)
    EDGE_REG_CASE(edge_act_reduce_reg_kernel, 4, 16)
    return nullptr;
  }
  return fwd_loop_kernel<ACT, T>(fwd_loop(H, De));
}

// The tiles kernel for a basis width and whether the rows take 8- or
// 16-byte loads (vec: H a multiple of 4, eq, g and ek 16-byte aligned).
template <int ACT, typename T>
const void* pick_tiles(int De, bool vec) {
  if (basis_width(De) == 8)
    return vec ? (const void*)edge_src_bwd_tiles_kernel<ACT, 8, true, T>
               : (const void*)edge_src_bwd_tiles_kernel<ACT, 8, false, T>;
  return vec ? (const void*)edge_src_bwd_tiles_kernel<ACT, 16, true, T>
             : (const void*)edge_src_bwd_tiles_kernel<ACT, 16, false, T>;
}

// The backward's kernel instance; on the tiles path the one that loads
// rows 16 (or 8) bytes at a time where vec.
template <int ACT, typename T>
const void* pick_bwd(int H, int De, bool vec) {
  const int nf = feat_per_lane(H), db = basis_width(De);
  if (bwd_on_tiles(H, De)) return pick_tiles<ACT, T>(De, vec);
  if (bwd_on_registers(H, De)) {
    EDGE_REG_CASE(edge_src_bwd_reg_kernel, 1, 8)
    EDGE_REG_CASE(edge_src_bwd_reg_kernel, 2, 8)
    EDGE_REG_CASE(edge_src_bwd_reg_kernel, 3, 8)
    EDGE_REG_CASE(edge_src_bwd_reg_kernel, 4, 8)
    EDGE_REG_CASE(edge_src_bwd_reg_kernel, 1, 16)
    EDGE_REG_CASE(edge_src_bwd_reg_kernel, 2, 16)
    EDGE_REG_CASE(edge_src_bwd_reg_kernel, 3, 16)
    return nullptr;
  }
  return bwd_loop_kernel<ACT, T>(bwd_loop(H, De));
}

#undef EDGE_REG_CASE
#undef EDGE_LOOP_CASES

const void* fwd_kernel(int act, int bf16, int H, int De) {
  if (act == ACT_LEAKY_RELU)
    return bf16 ? pick_fwd<ACT_LEAKY_RELU, __nv_bfloat16>(H, De)
                : pick_fwd<ACT_LEAKY_RELU, float>(H, De);
  if (act == ACT_TANH)
    return bf16 ? pick_fwd<ACT_TANH, __nv_bfloat16>(H, De)
                : pick_fwd<ACT_TANH, float>(H, De);
  if (act == ACT_GELU)
    return bf16 ? pick_fwd<ACT_GELU, __nv_bfloat16>(H, De)
                : pick_fwd<ACT_GELU, float>(H, De);
  return nullptr;
}

const void* bwd_kernel(int act, int bf16, int H, int De, bool vec = true) {
  if (act == ACT_LEAKY_RELU)
    return bf16 ? pick_bwd<ACT_LEAKY_RELU, __nv_bfloat16>(H, De, vec)
                : pick_bwd<ACT_LEAKY_RELU, float>(H, De, vec);
  if (act == ACT_TANH)
    return bf16 ? pick_bwd<ACT_TANH, __nv_bfloat16>(H, De, vec)
                : pick_bwd<ACT_TANH, float>(H, De, vec);
  if (act == ACT_GELU)
    return bf16 ? pick_bwd<ACT_GELU, __nv_bfloat16>(H, De, vec)
                : pick_bwd<ACT_GELU, float>(H, De, vec);
  return nullptr;
}

// Set the kernel's dynamic shared memory limit to smem; returns the error.
int allow_smem(const void* k, size_t smem) {
  if (k == nullptr || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The blocks of a persistent grid of `k` (threads a block, smem bytes):
// the card's SMs times the blocks an SM holds, at most `tiles`; -1 on an
// error. The occupancy of a (device, kernel, smem) is asked once.
int persistent_blocks(const void* k, int threads, size_t smem, int tiles) {
  struct Entry {
    int dev;
    const void* k;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int cached = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int full = -1;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < cached; ++i)
      if (cache[i].dev == dev && cache[i].k == k && cache[i].smem == smem)
        full = cache[i].blocks;
  }
  if (full < 0) {
    int sms = 0, per_sm = 0;
    if (allow_smem(k, smem) != 0 ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                      smem) != cudaSuccess)
      return -1;
    full = sms * (per_sm > 0 ? per_sm : 1);
    std::lock_guard<std::mutex> lock(mu);
    if (cached < 64) cache[cached++] = Entry{dev, k, smem, full};
  }
  return tiles < full ? tiles : full;
}

// The g_WE partials #8 writes on the shared-memory loop (one a block, or
// with the partials in device memory one a warp) and on the tiles path
// (one a block): a persistent grid of row walks, its resident blocks
// shared among the chunks of columns, and with the partials in device
// memory at most kDeviceScratch of them; -1 on an error.
int bwd_loop_parts(const void* k, int R, int H, int De) {
  const bool on_tiles = bwd_on_tiles(H, De);
  const Loop s = bwd_loop(H, De);
  const int chunk = on_tiles ? kMaxChunk : s.chunk;
  const int chunks = (H + chunk - 1) / chunk;
  const int full = persistent_blocks(k, kWarps * 32, bwd_smem(H, De),
                                     1 << 30);
  if (full <= 0) return -1;
  int64_t gx = full / chunks > 1 ? full / chunks : 1;
  const int64_t tiles = (R + kWarps - 1) / kWarps;
  gx = gx < tiles ? gx : tiles;
  if (on_tiles || !s.device()) return (int)gx;
  const int64_t fit =
      (int64_t)(kDeviceScratch / (sizeof(float) * kWarps * (size_t)De * H));
  gx = gx < fit ? gx : (fit > 1 ? fit : 1);
  return (int)gx * kWarps;
}

// Set the kernel's dynamic shared memory and launch it; returns the error.
int launch(const void* k, dim3 grid, int threads, size_t smem, void** args,
           cudaStream_t st) {
  const int code = allow_smem(k, smem);
  if (code != 0) return code;
  return (int)cudaLaunchKernel(k, grid, dim3(threads), args, smem, st);
}

// 16-byte basis copies: each row starts on a 16-byte boundary.
int basis_vec(const void* e_basis, int De) {
  return De % 4 == 0 && ((uintptr_t)e_basis & 15) == 0;
}

// The register path's 16-byte (f32) or 8-byte (bf16) ek loads past
// kRegMaxH: every row of ek is whole 4-value groups and starts on such a
// boundary.
int gather_vec(const void* ek, int H, int bf16) {
  return H % 4 == 0 && ((uintptr_t)ek & (bf16 ? 7 : 15)) == 0;
}

// The tiles path's 16-byte copies and loads: every row of eq and g is
// whole 16-byte chunks and every row of them and of ek starts on a
// 16-byte boundary.
bool rows_vec(const void* eq, const void* g, const void* ek, int H,
              int bf16) {
  return H % (bf16 ? 8 : 4) == 0 &&
         (((uintptr_t)eq | (uintptr_t)g | (uintptr_t)ek) & 15) == 0;
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
  const cudaStream_t st = (cudaStream_t)stream;
  const void* k = fwd_kernel(act, bf16, H, De);
  const size_t smem = fwd_smem(H, De);
  if (fwd_on_reg_blocks(H, De)) {
    // a persistent grid of row walkers, each C blocks of columns side by
    // side (the column block the fastest index)
    const int vec = basis_vec(e_basis, De), rvec = gather_vec(ek, H, bf16);
    const int threads = kRegWarps * 32;
    const int chunks = (H + kMaxChunk - 1) / kMaxChunk;
    const int full = persistent_blocks(k, threads, smem, 1 << 30);
    if (full <= 0) return (int)cudaErrorInvalidValue;
    const int64_t walks = (R + kRegWarps - 1) / kRegWarps;
    int64_t gx = full / chunks > 1 ? full / chunks : 1;
    gx = gx < walks ? gx : walks;
    void* args[] = {(void*)&eq,       (void*)&ek,        (void*)&e_basis,
                    (void*)&w_e,      (void*)&slot_src,  (void*)&slot_edge,
                    (void*)&scale,    (void*)&row_key,   (void*)&row_ptr,
                    (void*)&R,        (void*)&H,         (void*)&De,
                    (void*)&slope,    (void*)&vec,       (void*)&rvec,
                    (void*)&rows,     (void*)&srows};
    return launch(k, dim3((unsigned)(gx * chunks)), threads, smem, args, st);
  }
  if (fwd_on_registers(H, De)) {
    const int vec = basis_vec(e_basis, De);
    const int threads = kRegWarps * 32;
    const int blocks = persistent_blocks(
        k, threads, smem, (R + kRegWarps - 1) / kRegWarps);
    if (blocks <= 0) return (int)cudaErrorInvalidValue;
    void* args[] = {(void*)&eq,       (void*)&ek,        (void*)&e_basis,
                    (void*)&w_e,      (void*)&slot_src,  (void*)&slot_edge,
                    (void*)&scale,    (void*)&row_key,   (void*)&row_ptr,
                    (void*)&R,        (void*)&H,         (void*)&De,
                    (void*)&slope,    (void*)&vec,       (void*)&rows,
                    (void*)&srows};
    return launch(k, dim3(blocks), threads, smem, args, st);
  }
  int hc = fwd_loop(H, De).chunk;
  void* args[] = {(void*)&eq,      (void*)&ek,        (void*)&e_basis,
                  (void*)&w_e,     (void*)&slot_src,  (void*)&slot_edge,
                  (void*)&scale,   (void*)&row_key,   (void*)&row_ptr,
                  (void*)&R,       (void*)&H,         (void*)&De,
                  (void*)&hc,      (void*)&slope,     (void*)&rows,
                  (void*)&srows};
  return launch(k, dim3((R + kWarps - 1) / kWarps, (H + hc - 1) / hc),
                kWarps * 32, smem, args, st);
}

// The number of [De, H] g_WE partials ell_edge_src_bwd writes (the rows of
// its scratch: one a block, or one a warp where the columns path keeps them
// in device memory), or -1 for arguments it cannot take.
int ell_edge_src_bwd_blocks(int R, int H, int De, int act, int bf16) {
  if (R <= 0 || H <= 0 || De <= 0) return -1;
  const void* k = bwd_kernel(act, bf16, H, De);
  if (k == nullptr) return -1;
  if (bwd_on_registers(H, De))
    return persistent_blocks(k, kRegWarps * 32, bwd_smem(H, De),
                             (R + kRegWarps - 1) / kRegWarps);
  // on the tiles path the grid of the instance with 16-byte loads, which
  // the other (rows off 16 bytes) runs on as well
  return bwd_loop_parts(k, R, H, De);
}

// gwe_part holds `parts` (from ell_edge_src_bwd_blocks) partials of
// [De, H]; gwe [De, H] is their sum, in order.
int ell_edge_src_bwd(const void* eq, const void* g, int bf16, const void* ek,
                     const void* e_basis, const void* w_e,
                     const void* slot_dst, const void* slot_edge,
                     const void* scale, const void* row_key,
                     const void* row_ptr, int R, int H, int De, int act,
                     float slope, int parts, void* out, void* gwe_part,
                     void* gwe, void* stream) {
  if (R <= 0 || H <= 0 || De <= 0 || parts <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const void* k = bwd_kernel(act, bf16, H, De, rows_vec(eq, g, ek, H, bf16));
  const size_t smem = bwd_smem(H, De);
  int code;
  if (bwd_on_tiles(H, De)) {
    const int bvec = basis_vec(e_basis, De);
    void* args[] = {(void*)&eq,        (void*)&g,         (void*)&ek,
                    (void*)&e_basis,   (void*)&w_e,       (void*)&slot_dst,
                    (void*)&slot_edge, (void*)&scale,     (void*)&row_key,
                    (void*)&row_ptr,   (void*)&R,         (void*)&H,
                    (void*)&De,        (void*)&slope,     (void*)&bvec,
                    (void*)&out,       (void*)&gwe_part};
    code = launch(k, dim3(parts, (H + kMaxChunk - 1) / kMaxChunk),
                  kWarps * 32, smem, args, st);
  } else if (bwd_on_registers(H, De)) {
    const int vec = basis_vec(e_basis, De);
    void* args[] = {(void*)&eq,        (void*)&g,         (void*)&ek,
                    (void*)&e_basis,   (void*)&w_e,       (void*)&slot_dst,
                    (void*)&slot_edge, (void*)&scale,     (void*)&row_key,
                    (void*)&row_ptr,   (void*)&R,         (void*)&H,
                    (void*)&De,        (void*)&slope,     (void*)&vec,
                    (void*)&out,       (void*)&gwe_part};
    code = launch(k, dim3(parts), kRegWarps * 32, smem, args, st);
  } else {
    const Loop s = bwd_loop(H, De);
    if (s.device() && parts % kWarps != 0)
      return (int)cudaErrorInvalidValue;
    int hc = s.chunk;
    void* args[] = {(void*)&eq,        (void*)&g,        (void*)&ek,
                    (void*)&e_basis,   (void*)&w_e,      (void*)&slot_dst,
                    (void*)&slot_edge, (void*)&scale,    (void*)&row_key,
                    (void*)&row_ptr,   (void*)&R,        (void*)&H,
                    (void*)&De,        (void*)&hc,       (void*)&slope,
                    (void*)&out,       (void*)&gwe_part};
    const int gx = s.device() ? parts / kWarps : parts;
    code = launch(k, dim3(gx, (H + hc - 1) / hc), kWarps * 32, smem, args,
                  st);
  }
  if (code != 0) return code;
  const int n = De * H;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)gwe_part, parts, n, (float*)gwe);
  return (int)cudaGetLastError();
}

// How the two kernels run rows of width H with a basis of width De, as the
// entries above decide: bits 0-1 the forward's path and 2-3 with 36 the
// backward's (1 the shared-memory loop, 2 registers, 3 columns, 4 tiles:
// bits 2-3 hold its low two bits, bit 36 its third), 4-6 the features a
// lane of the row (a pass's on the shared path; the columns path's are its
// chunk / 32, the tiles path's 4), 7-11 the basis values a register-path or
// tiles-path kernel holds a slot (0 when none takes either path), 12-15
// and 16-19 the slots whose node rows are in flight (forward, backward; 1
// on the shared and columns paths, and on the register path in the
// backward with tanh or erf-GELU; the tiles path's batch; #7's
// cols_inflight past kRegMaxH), 20-23 and 24-27
// the warps a block, 28-30 and 31-33 the columns a block takes / 32 on the
// columns and tiles paths and on #7's register path past kRegMaxH (its
// blocks of kMaxChunk columns) (forward, backward; 0 on the others), 34 and 35
// whether the columns path keeps W_E (and #8's partials) in device memory
// (forward, backward). -1 for a width that is not positive or an unknown
// activation.
long long ell_edge_layout(int H, int De, int act, int bf16) {
  if (H <= 0 || De <= 0 || fwd_kernel(act, bf16 != 0, 1, 1) == nullptr)
    return -1;
  const int fp = fwd_path(H, De), bp = bwd_path(H, De);
  const bool fr = fp == PATH_REGISTERS, br = bp == PATH_REGISTERS;
  const bool fc = fp == PATH_COLUMNS, bc = bp == PATH_COLUMNS;
  const bool bt = bp == PATH_TILES;
  const Loop fl = fwd_loop(H, De), bl = bwd_loop(H, De);
  const int db = fr || br || bt ? basis_width(De) : 0;
  const int uf = fwd_on_reg_blocks(H, De)
                     ? cols_inflight(basis_width(De), bf16 ? 2 : 4)
                 : fr ? kRegInflightFwd
                      : 1;
  const int ub = br   ? inflight_bwd(act)
                 : bt ? (bf16 ? tile_inflight<__nv_bfloat16>()
                              : tile_inflight<float>())
                      : 1;
  const int fchunk = fc ? fl.chunk : fwd_on_reg_blocks(H, De) ? kMaxChunk : 0;
  const int bchunk = bc ? bl.chunk : bt ? kMaxChunk : 0;
  const long long code =
      fp | (bp & 3) << 2 | feat_per_lane(H) << 4 | db << 7 | uf << 12 |
      ub << 16 | (fr ? kRegWarps : kWarps) << 20 |
      (br ? kRegWarps : kWarps) << 24;
  return code | (long long)(fchunk / 32) << 28 |
         (long long)(bchunk / 32) << 31 | (long long)(fc && fl.device()) << 34 |
         (long long)(bc && bl.device()) << 35 | (long long)(bp >> 2) << 36;
}

const char* ell_edge_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
