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
//                      g_z = vjp(act, z)(g_m W^T) per slot;
//                      geq_rows = sum_s g_z
//   ell_scaled_reduce  out[r] = sum_s scale[s] * values[slot_idx[s]]
//
// act is any sigma of the registry: leaky_relu, tanh and erf-GELU
// elementwise, centered_relu (relu(z - alpha mean_H(z))) and softmax over
// H row-wise. The edge-term forms of the first three (``*_edge``) add an
// edge table e [E_pad, H] in sorted-edge order, of ek's type, read by index
// through the plan's slot_edge: the key side of slot s is
// add_cast(ek[slot_src[s]], e[slot_edge[s]]), added in f32 and rounded to
// ek's type, as the JAX route's ekg + e.astype(ekg.dtype) rounds it. The
// per-edge cotangent is the caller's: g_z (in ek's type) read through the
// edge -> dst-slot map.
//
// They replace the Pallas kernels bucket_max_gemm_fwd, bucket_max_wincount,
// bucket_max_gemm_bwd and bucket_scaled_reduce of
// sir_gcn_tpu/ops/pallas/kernels.py, with or without the with_edge inputs
// of make_ell_sir_aggregate_max_pallas. One launch walks every row of a plan
// through row_ptr and gathers node rows by index, so no [S, H] slot table is
// read: ek rows, and the key-level max and cotangent rows, are read by
// index; ell_scaled_reduce reads g_z through the src-slot -> dst-slot map
// instead of a permuted copy.
//
// Bound: tensor-core operations. Each slot costs 2*H*O flops for m (three
// times that in the backward: m, g_a and g_W) against 2-4 bytes per
// feature read. The products must be as accurate as f32 (ties, win counts
// and the card-vs-CPU checks hold m to about 1e-6 of its size), and one TF32
// pass keeps 11 bits, so every product is split in three passes:
//
//   x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi)
//   A B ~ A_lo B_hi + A_hi B_lo + A_hi B_hi     (A_lo B_lo, ~2^-22, dropped)
//
// on mma.sync.m16n8k8 TF32 tensor cores with f32 accumulators: 3x the f32
// flops at the dense TF32 rate. Design:
//
// - Slot tiles over the ragged rows. Each warp takes a contiguous share of
//   the rows (those that start in its share of the slots) and walks its
//   slots in tiles of 16 in order, so that a tile is full whatever the
//   budgets (10-20 slots a row at ogbn-arxiv): a row that a tile's edge
//   cuts, up to budget 256 on hub graphs, carries its partial result (max,
//   count or row sum) in shared memory from one tile to the next. The
//   activations of a tile are staged once in shared memory (16-byte
//   gathers where the row width allows, the edge row beside the ek row in
//   the edge forms), padding and invalid slots as 0, masked by scale > 0.
// - A row-wise sigma: the tile's z [16, Hp] is staged first, then
//   rowwise_act() takes each valid slot's statistic over its H features
//   (not the padding up to Hp) and applies sigma in place: lanes 2i and
//   2i + 1 hold slot i, each walking its half of the features in
//   increasing h, and one xor shuffle joins the halves. The three kernels
//   call it alike, so a (and m, and the win counts) has the same bits in
//   each. #11 writes g_a itself where the elementwise forms write
//   act'(z) g_a, and rowwise_vjp() forms g_z from it and a (relu's gate is
//   a > 0, softmax's y is a) with the same lane pairs. A tile holds its
//   16 slots' whole rows, so every width the elementwise forms take (a
//   16-slot tile of Hp floats and a W chunk of 8 columns in a forward
//   block's shared memory, the backward's three [16, Hp] buffers) the
//   row-wise forms take too.
// - slot_products(): m of a 16-slot tile for up to 12 column tiles of 8,
//   in k steps of 8 in increasing h, three passes per step in one order.
//   The three kernels call it alike, so a slot's m has the same bits in
//   each of them, whatever its place in a tile, the tile's other slots or
//   the columns chunk: each output element is its own dot product in the
//   tensor core. H is padded to a multiple of 8 (16 for O in the backward)
//   with zeros, which add nothing.
// - W in shared memory, row stride = 8 mod 32 words, which makes the B
//   fragment loads of m (rows h, column o) and of g_a (W^T, column pairs)
//   free of bank conflicts. The forward keeps W split (hi and lo arrays,
//   chunks of at most 96 columns per block in grid.y); the backward keeps
//   W in f32 and splits as it loads, to leave room for its tiles, or reads
//   it from device memory when it is too large (the same values, so the
//   same bits).
// - #9 and #10: the tile's m goes to shared memory; lanes over o take the
//   max, or count m == key_max, over each row's valid slots in order.
// - #11: m, then g_m = win * gsc in shared memory, g_a = g_m W^T on the
//   tensor cores (m's accumulator layout read back as g_m's A fragments,
//   the k order of each step permuted to pairs), g_z = act'(z) g_a stored
//   per slot and summed per row in slot order. g_W^T = g_m^T a is a third
//   product with the slots as k: persistent blocks walk tiles with all
//   warps in step, and after each step every warp adds its share of g_W
//   tiles over the block's tiles, in registers for the whole walk when its
//   share fits (3 x 3 tiles of 16 x 8), else in the block's own slice of
//   the scratch. Each block writes one partial and a second kernel sums
//   the partials in block order: no atomics, so the same inputs give the
//   same bits on every run.
// - The tensor core's own adder rounds with a bias (g_W's sums over
//   thousands of slots drifted by 8e-5 of their size on the card), so each
//   k step of every product (each block step of g_W) is summed from zero
//   and added to the running sum by an f32 add that rounds to nearest.
//
// --fmad=false (ops/cuda/build.py) keeps nvcc from fusing the activation's
// arithmetic differently in different kernels. The edge forms and the
// forms without an edge term are separate instances (EDGE), so the
// kernels without one carry no edge gather.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;      // ell_scaled_reduce: rows per block
constexpr int kFwdWarps = 16;  // most warps of a forward block
constexpr int kBwdWarps = 8;   // most warps of a backward block
constexpr int kNT = 12;        // column tiles of 8 a warp carries at once
constexpr int kGW = 3;         // g_W tiles a warp keeps per dim in registers
constexpr int kFwdCols = 96;   // most W columns a forward block stages
constexpr int kMaxNJ = 4;      // ell_scaled_reduce: columns per lane
// dynamic shared memory a block may use: the card's 232,448 bytes less
// room for the static arrays
constexpr int kMaxSmem = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

// Activation ids, as registered in sir_gcn_tpu_torch/ops/ell.py, and
// ACT_ROWWISE, the one template both row-wise ids build (the id itself is
// read at run time from the launch configuration: their kernels differ
// only in rowwise_act and rowwise_vjp, once a tile).
enum {
  ACT_LEAKY_RELU = 0,
  ACT_TANH = 1,
  ACT_CENTERED_RELU = 2,
  ACT_SOFTMAX = 3,
  ACT_GELU = 4,
  ACT_ROWWISE = 16
};
// Whether sigma couples a row's features (its Jacobian is not diagonal).
template <int ACT>
constexpr bool kRowwise = ACT == ACT_ROWWISE;
enum { MODE_MAX = 0, MODE_COUNT = 1 };
// where slot_products reads W: split in shared memory, f32 in shared
// memory, f32 in device memory
enum { W_SPLIT = 0, W_SMEM = 1, W_GLOBAL = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}
// k + e added in f32 and rounded to TK (nearest even): the key side of a
// slot with its edge row.
template <typename TK>
__device__ __forceinline__ float add_cast(float k, float e) {
  const float s = __fadd_rn(k, e);
  if constexpr (sizeof(TK) == 2) return __bfloat162float(__float2bfloat16(s));
  return s;
}

// False for every id: the static_assert of an activation id that has no
// branch in act_both fails the build.
template <int ACT>
constexpr bool kNoBranch = false;

// erf-GELU as jax.nn.gelu(approximate=False) computes it, z * Phi(z) with
// Phi(z) = 0.5 * erfc(-z / sqrt(2)), and gelu'(z) = Phi(z) + z * exp(-z^2
// / 2) / sqrt(2 pi).
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

// a = act(z) and, with WITH_D, d = act'(z); leaky_relu'(0) = 1, matching
// where(z >= 0, z, slope * z). a is the same bits with and without d: the
// products of #9, #10 and #11 must agree exactly.
template <int ACT, bool WITH_D>
__device__ __forceinline__ void act_both(float z, float slope, float& a,
                                         float& d) {
  if constexpr (ACT == ACT_LEAKY_RELU) {
    a = z >= 0.f ? z : slope * z;
    if (WITH_D) d = z >= 0.f ? 1.f : slope;
  } else if constexpr (ACT == ACT_TANH) {
    a = tanhf(z);
    if (WITH_D) d = (1.f + a) * (1.f - a);
  } else if constexpr (ACT == ACT_GELU) {
    const float cdf = 0.5f * erfcf(-z * kSqrtHalf);
    a = z * cdf;
    if (WITH_D) d = cdf + z * (expf(-0.5f * z * z) * kInvSqrt2Pi);
  } else {
    static_assert(kNoBranch<ACT>, "an activation id without a branch");
  }
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}
// the least stride >= x that is r mod 32 words
__host__ __device__ __forceinline__ int stride_mod32(int x, int r) {
  return x + ((r - x % 32) + 32) % 32;
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// cvt.rna.tf32.f32 for finite x, done as an integer add of half the 13
// dropped bits to the magnitude's bit pattern and a mask, which run at the
// full integer rate where the conversion runs at a fraction of it (the
// split is most of #11's instructions).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo as two TF32 values, each rounded to nearest (ties away).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));  // x - hi is exact
}

// d += a b for one m16n8k8 TF32 tile (f32 accumulators). Not volatile:
// the compiler may interleave independent tiles' products.
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three passes of the split into each accumulator, small terms first:
// d += a_lo b_hi, then a_hi b_lo, then a_hi b_hi. Every product here
// keeps this order per accumulator; across up to kGroup tiles each pass is
// issued for all of them before the next, so that no product waits on the
// one before it.
constexpr int kGroup = 4;

__device__ __forceinline__ void mma3(float (*d)[4], const uint32_t ah[4],
                                     const uint32_t al[4],
                                     const uint32_t (*bh)[2],
                                     const uint32_t (*bl)[2], int n) {
#pragma unroll
  for (int q = 0; q < kGroup; ++q)
    if (q < n) mma(d[q], al, bh[q]);
#pragma unroll
  for (int q = 0; q < kGroup; ++q)
    if (q < n) mma(d[q], ah, bl[q]);
#pragma unroll
  for (int q = 0; q < kGroup; ++q)
    if (q < n) mma(d[q], ah, bh[q]);
}

// acc[q] += one k step's a b for n (<= kGroup) tiles of B, the three
// passes summed from zero apart (mma3) and added in f32: the tensor core's
// own adder rounds with a bias (on the card g_W's sums over thousands of
// slots drifted by 8e-5 of their size), so no accumulator of it takes more
// than one step's three passes.
__device__ __forceinline__ void add_step(float (*acc)[4],
                                         const uint32_t ah[4],
                                         const uint32_t al[4],
                                         const uint32_t (*bh)[2],
                                         const uint32_t (*bl)[2], int n) {
  float part[kGroup][4] = {};
  mma3(part, ah, al, bh, bl, n);
#pragma unroll
  for (int q = 0; q < kGroup; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (q < n) acc[q][e] = __fadd_rn(acc[q][e], part[q][e]);
}

// ----------------------------------------------------------------------
// Slot tiles
// ----------------------------------------------------------------------

// A warp's tile: 16 consecutive slots (fewer at the end of its share) and
// the rows they hold, a row cut by the tile's edges included. Uniform
// fields first; then per lane j < nrows row j's local slots [rlo, rhi) and
// key, and per lane i < n slot i's source node, edge (the edge forms) and
// key. Row 0 may have begun in the warp's last tile (carry_in), the last
// row may go on in the next (!last); the rows between lie whole in the
// tile.
struct Tile {
  int s0, n, r0, nrows;
  bool carry_in, last;
  unsigned vmask;  // bit i: slot i is valid (scale > 0)
  int rlo, rhi, rkey;
  int ssrc, sedge, skey;
};

// Whether row j of the tile began in the warp's last tile (its reduce
// starts from the carry), and whether it ends in this one (it writes its
// row; else it leaves its partial in the carry).
__device__ __forceinline__ bool row_carried(const Tile& t, int j) {
  return j == 0 && t.carry_in;
}
__device__ __forceinline__ bool row_ends(const Tile& t, int j) {
  return j < t.nrows - 1 || t.last;
}

// The first i in [0, n) with a[i] >= v, or n; a is non-decreasing. Each
// round the warp probes 32 points.
__device__ int lower_bound_warp(const int* __restrict__ a, int n,
                                long long v, int lane) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + lane * step;
    const bool ge = idx >= hi || (long long)a[idx] >= v;
    const unsigned m = __ballot_sync(kFull, ge);
    const int f = m ? __ffs(m) - 1 : 32;
    if (f == 0) {
      hi = lo;
    } else {
      const int lo2 = lo + (f - 1) * step + 1;
      hi = min(hi, lo + f * step);
      lo = lo2;
    }
  }
  return lo;
}

// Rows [r, r_end) of warp gw of nw, those that start in the warp's share
// [S gw / nw, S (gw + 1) / nw) of the S slots, and their slots [s, s_end).
__device__ void warp_rows(const int* __restrict__ row_ptr, int R, int gw,
                          int nw, int lane, int& r, int& r_end, int& s,
                          int& s_end) {
  const long long S = row_ptr[R];
  r = min(R, lower_bound_warp(row_ptr, R + 1, S * gw / nw, lane));
  r_end = gw == nw - 1
              ? R
              : min(R, lower_bound_warp(row_ptr, R + 1, S * (gw + 1) / nw,
                                        lane));
  s = row_ptr[r];
  s_end = row_ptr[r_end];
}

// What a tile starting at slot s of row r reads of the plan, loaded by
// load_meta as soon as the warp's previous tile is cut, so that the loads
// are in flight during that tile's work: per lane j <= 16 row r + j's
// start, per lane j < 16 its key, per lane i < 16 slot s + i's source,
// edge (where slot_edge is given) and scale.
struct Meta {
  int p, rk, src, edge;
  float sc;
};

__device__ __forceinline__ Meta load_meta(const int* __restrict__ row_ptr,
                                          const int* __restrict__ row_key,
                                          const int* __restrict__ slot_src,
                                          const int* __restrict__ slot_edge,
                                          const float* __restrict__ scale,
                                          int r, int s, int r_end, int s_end,
                                          int lane) {
  Meta m;
  m.p = lane <= 16 && r + lane <= r_end ? row_ptr[r + lane] : 0;
  m.rk = lane < 16 && r + lane < r_end ? row_key[r + lane] : 0;
  const bool sl = lane < 16 && s + lane < s_end;
  m.src = sl ? slot_src[s + lane] : 0;
  m.edge = sl && slot_edge != nullptr ? slot_edge[s + lane] : 0;
  m.sc = sl ? scale[s + lane] : 0.f;
  return m;
}

// The warp's next tile from slot s of row r (rows [r, r_end) own slots up
// to s_end), from m = load_meta(.., r, s, ..); false when its rows are
// done. A tile holds at most 16 rows: where more start in its window (rows
// of 0 slots), it ends at row 16.
__device__ bool next_tile(const Meta& m, int& r, int& s, int r_end,
                          int s_end, Tile& t, int lane) {
  if (r >= r_end) return false;
  const int p = m.p;  // lane j: row r + j's start
  const int pn = __shfl_down_sync(kFull, p, 1);
  // rows r + j, j >= 1, that start in the window [s, s + 16): a prefix
  const unsigned w = __ballot_sync(
      kFull, lane >= 1 && lane <= 16 && r + lane < r_end && p < s + 16);
  const int c = __popc(w);
  const int k = 1 + min(c, 15);
  int n = min(16, s_end - s);
  if (c == 16) n = min(n, __shfl_sync(kFull, p, 16) - s);
  t.s0 = s;
  t.n = n;
  t.r0 = r;
  t.nrows = k;
  t.carry_in = __shfl_sync(kFull, p, 0) < s;
  t.last = __shfl_sync(kFull, p, k) <= s + n;
  t.rlo = max(p - s, 0);
  t.rhi = min(pn - s, n);
  s += n;
  r += t.last ? k : k - 1;
  t.rkey = lane < t.nrows ? m.rk : 0;
  // slot i's row: the last row that starts at or before i
  int my_row = 0;
  for (int j = 1; j < t.nrows; ++j)
    my_row += lane >= __shfl_sync(kFull, t.rlo, j);
  t.skey = __shfl_sync(kFull, t.rkey, my_row & 31);
  const bool sl = lane < t.n;
  t.ssrc = sl ? m.src : 0;
  t.sedge = sl ? m.edge : 0;
  t.vmask = __ballot_sync(kFull, sl && m.sc > 0.f);
  return true;
}

__device__ __forceinline__ bool slot_valid(const Tile& t, int i) {
  return (t.vmask >> i) & 1u;
}

// Rows of a key-indexed [N, O] table that a tile's epilogue reads: those
// of its first kPre rows are copied into shared memory (cp.async, no
// registers) before the tile's product, so that the copy overlaps it;
// any further row is read from device memory where it is used.
constexpr int kPre = 2;

__device__ __forceinline__ void prefetch_rows(const float* __restrict__ tbl,
                                              const Tile& t, int O, int oc0,
                                              int ncol, float* buf, int ld,
                                              int lane) {
  for (int j = 0; j < min(t.nrows, kPre); ++j) {
    const int key = __shfl_sync(kFull, t.rkey, j);
    const float* src = tbl + (int64_t)key * O + oc0;
    for (int o = lane; o < ncol; o += 32) {
      const unsigned dst =
          (unsigned)__cvta_generic_to_shared(buf + j * ld + o);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(src + o));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's copies; the caller then syncs the warp.
__device__ __forceinline__ void prefetch_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Row j's value at column o of a table prefetched into buf [kPre][ld].
__device__ __forceinline__ float row_value(const float* __restrict__ tbl,
                                           int j, int key, int O, int oc0,
                                           int o, const float* buf, int ld) {
  return j < kPre ? buf[j * ld + o] : tbl[(int64_t)key * O + oc0 + o];
}

// A row-wise sigma over the H features of each slot of a tile, in place:
// a_s holds z on entry and act(z) on return (0 for an invalid slot; the
// padding h >= H is left as it is, 0). Lanes 2i and 2i + 1 take slot i,
// features half, half + 2, ... (half = lane & 1) in increasing h; one xor
// shuffle joins the two halves' sums or maxima (an f32 add commutes, so
// both lanes hold the same bits). The statistic is formed alike wherever
// the slot sits in a tile: #9, #10 and #11 give a the same bits.
//   centered_relu: c = alpha * (sum / H); a = relu(z - c), 0 where z - c
//                  <= 0 (jax.nn.relu)
//   softmax:       a = exp(z - max) / sum of exp(z - max)
__device__ __forceinline__ void rowwise_act(float* a_s, int lda,
                                            const Tile& t, int H, int act,
                                            float param, int lane) {
  const int half = lane & 1;
  const bool ok = slot_valid(t, lane >> 1);
  float* row = a_s + (lane >> 1) * lda;
  if (act == ACT_CENTERED_RELU) {
    float s = 0.f;
    if (ok)
      for (int h = half; h < H; h += 2) s = __fadd_rn(s, row[h]);
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 1));
    const float c = __fmul_rn(param, __fdiv_rn(s, (float)H));
    for (int h = half; h < H; h += 2) {
      const float v = __fsub_rn(row[h], c);
      row[h] = ok && v > 0.f ? v : 0.f;
    }
  } else {  // ACT_SOFTMAX
    float mx = -FLT_MAX;
    if (ok)
      for (int h = half; h < H; h += 2) mx = fmaxf(mx, row[h]);
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    float s = 0.f;
    for (int h = half; h < H; h += 2) {
      const float e = ok ? expf(__fsub_rn(row[h], mx)) : 0.f;
      row[h] = e;
      s = __fadd_rn(s, e);
    }
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 1));
    for (int h = half; h < H; h += 2)
      row[h] = ok ? __fdiv_rn(row[h], s) : 0.f;
  }
}

// g_z = vjp(act, z)(g_a) of a row-wise sigma for the slots of a tile, in
// place of g_a in g_s, from a = act(z) in a_s, with rowwise_act's lanes
// and order. An invalid slot has a = 0 and g_a = 0, and gets g_z = 0.
//   centered_relu: d = g_a where a > 0 (relu'(0) = 0), g_z = d - alpha *
//                  (sum of d / H)
//   softmax:       g_z = a * (g_a - sum of a * g_a)
__device__ __forceinline__ void rowwise_vjp(const float* a_s, float* g_s,
                                            int lda, int H, int act,
                                            float param, int lane) {
  const int half = lane & 1;
  const float* a = a_s + (lane >> 1) * lda;
  float* g = g_s + (lane >> 1) * lda;
  float s = 0.f;
  const bool relu = act == ACT_CENTERED_RELU;  // else ACT_SOFTMAX
  for (int h = half; h < H; h += 2)
    s = __fadd_rn(s, relu ? (a[h] > 0.f ? g[h] : 0.f)
                          : __fmul_rn(a[h], g[h]));
  s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 1));
  if (relu) {
    const float c = __fmul_rn(param, __fdiv_rn(s, (float)H));
    for (int h = half; h < H; h += 2)
      g[h] = __fsub_rn(a[h] > 0.f ? g[h] : 0.f, c);
  } else {
    for (int h = half; h < H; h += 2)
      g[h] = __fmul_rn(a[h], __fsub_rn(g[h], s));
  }
}

// Stage a tile's activations: a_s[i * lda + h] = act(z) (and d_s = act'(z)
// with WITH_D, an elementwise sigma only) for slots i < 16 and h < Hp, 0
// for padding, invalid slots and h >= H; z = eq[key] + ek[src], with EDGE
// z = eq[key] + add_cast(ek[src], e[edge]). VEC gathers 16 bytes a lane
// (H a multiple of 8 for bf16 or 4 for f32, 16-byte aligned tables); else
// one feature a lane. Each lane issues U gathers before it uses one. A
// row-wise sigma (ACT_ROWWISE, act its id) stages z and then applies
// rowwise_act.
template <int ACT, typename TK, bool VEC, bool WITH_D, bool EDGE>
__device__ __forceinline__ void stage_tile(const float* __restrict__ eq,
                                           const TK* __restrict__ ek,
                                           const TK* __restrict__ e,
                                           const Tile& t, int H, int Hp,
                                           int act, float slope, float* a_s,
                                           int lda, float* d_s, int lane) {
  static_assert(!(WITH_D && kRowwise<ACT>),
                "a row-wise sigma has no elementwise derivative");
  constexpr int E = VEC ? 16 / (int)sizeof(TK) : 1;
  constexpr int U = VEC ? 6 : 8;  // H = 96 in bf16: one round a tile
  const int nch = H / E;
  const int total = 16 * nch;
  for (int base = 0; base < total; base += 32 * U) {
    float z[U][E];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + u * 32 + lane;
      const int i = c / nch, ch = c - (c / nch) * nch;
      const int src = __shfl_sync(kFull, t.ssrc, i & 15);
      const int key = __shfl_sync(kFull, t.skey, i & 15);
      const int edge = EDGE ? __shfl_sync(kFull, t.sedge, i & 15) : 0;
      ok[u] = c < total && slot_valid(t, i & 15);
      if (ok[u]) {
        const TK* kp = ek + (int64_t)src * H + ch * E;
        const TK* ep = EDGE ? e + (int64_t)edge * H + ch * E : nullptr;
        const float* qp = eq + (int64_t)key * H + ch * E;
        if (VEC) {
          float kf[E];
          if (sizeof(TK) == 2) {
            const uint4 raw = *reinterpret_cast<const uint4*>(kp);
            const __nv_bfloat16* b =
                reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
            for (int x = 0; x < E; ++x) kf[x] = to_f32(b[x]);
            if (EDGE) {
              const uint4 eraw = *reinterpret_cast<const uint4*>(ep);
              const __nv_bfloat16* eb =
                  reinterpret_cast<const __nv_bfloat16*>(&eraw);
#pragma unroll
              for (int x = 0; x < E; ++x)
                kf[x] = add_cast<TK>(kf[x], to_f32(eb[x]));
            }
          } else {
            const float4 raw = *reinterpret_cast<const float4*>(kp);
            kf[0] = raw.x;
            kf[1 % E] = raw.y;
            kf[2 % E] = raw.z;
            kf[3 % E] = raw.w;
            if (EDGE) {
              const float4 er = *reinterpret_cast<const float4*>(ep);
              kf[0] = add_cast<TK>(kf[0], er.x);
              kf[1 % E] = add_cast<TK>(kf[1 % E], er.y);
              kf[2 % E] = add_cast<TK>(kf[2 % E], er.z);
              kf[3 % E] = add_cast<TK>(kf[3 % E], er.w);
            }
          }
#pragma unroll
          for (int x = 0; x < E; x += 4) {
            const float4 q = *reinterpret_cast<const float4*>(qp + x);
            z[u][x] = kf[x] + q.x;
            z[u][(x + 1) % E] = kf[(x + 1) % E] + q.y;
            z[u][(x + 2) % E] = kf[(x + 2) % E] + q.z;
            z[u][(x + 3) % E] = kf[(x + 3) % E] + q.w;
          }
        } else {
          float kf = to_f32(kp[0]);
          if (EDGE) kf = add_cast<TK>(kf, to_f32(ep[0]));
          z[u][0] = kf + qp[0];
        }
      } else {
#pragma unroll
        for (int x = 0; x < E; ++x) z[u][x] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + u * 32 + lane;
      if (c < total) {
        const int i = c / nch, ch = c - (c / nch) * nch;
        float av[E], dv[E];
#pragma unroll
        for (int x = 0; x < E; ++x) {
          av[x] = dv[x] = 0.f;
          if constexpr (kRowwise<ACT>) {
            av[x] = z[u][x];  // 0 for an invalid slot; sigma comes after
          } else {
            if (ok[u]) act_both<ACT, WITH_D>(z[u][x], slope, av[x], dv[x]);
          }
        }
        // 16-byte stores (lda is a multiple of 4): a lane's E features
        // at once, not E lanes on one bank
#pragma unroll
        for (int x = 0; x < E; x += (VEC ? 4 : 1)) {
          float* pa = a_s + i * lda + ch * E + x;
          float* pd = d_s + i * lda + ch * E + x;
          if (VEC) {
            *reinterpret_cast<float4*>(pa) =
                make_float4(av[x], av[(x + 1) % E], av[(x + 2) % E],
                            av[(x + 3) % E]);
            if (WITH_D)
              *reinterpret_cast<float4*>(pd) =
                  make_float4(dv[x], dv[(x + 1) % E], dv[(x + 2) % E],
                              dv[(x + 3) % E]);
          } else {
            *pa = av[x];
            if (WITH_D) *pd = dv[x];
          }
        }
      }
    }
  }
  const int pad = Hp - H;
  for (int c = lane; c < 16 * pad; c += 32) {
    const int i = c / pad, h = H + c - (c / pad) * pad;
    a_s[i * lda + h] = 0.f;
    if (WITH_D) d_s[i * lda + h] = 0.f;
  }
  if constexpr (kRowwise<ACT>) {
    __syncwarp();  // every lane's z is staged
    rowwise_act(a_s, lda, t, H, act, slope, lane);
  }
}

// ----------------------------------------------------------------------
// The products
// ----------------------------------------------------------------------

// One W value as its TF32 split, from where WS says: W_SPLIT reads the hi
// and lo arrays (stride ldw), W_SMEM and W_GLOBAL read W and split it
// (W_GLOBAL: W [H, O] in device memory, 0 outside it). Every source gives
// the same pair for the same W value.
template <int WS>
__device__ __forceinline__ void load_w(const float* wh, const float* wl,
                                       int ldw, int h, int o, int H, int O,
                                       uint32_t& hi, uint32_t& lo) {
  if (WS == W_SPLIT) {
    hi = __float_as_uint(wh[h * ldw + o]);
    lo = __float_as_uint(wl[h * ldw + o]);
  } else if (WS == W_SMEM) {
    split(wh[h * ldw + o], hi, lo);
  } else {
    split(h < H && o < O ? __ldg(wh + (int64_t)h * O + o) : 0.f, hi, lo);
  }
}

// m = a W for a 16-slot tile, column tiles nt0 .. nt0 + nt - 1 (nt <= kNT)
// of 8: acc[j] is tile j's m16n8 accumulator fragment. a_s [16][lda] f32,
// k steps of 8 over h < Hp in increasing order, each step added by
// add_step. THE product of every kernel here: a slot's m has the same bits
// wherever it is computed.
template <int WS>
__device__ __forceinline__ void slot_products(const float* a_s, int lda,
                                              const float* wh,
                                              const float* wl, int ldw,
                                              int H, int O, int Hp, int nt0,
                                              int nt, float acc[kNT][4],
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k0 = 0; k0 < Hp; k0 += 8) {
    uint32_t ah[4], al[4];
    split(a_s[g * lda + k0 + t], ah[0], al[0]);
    split(a_s[(g + 8) * lda + k0 + t], ah[1], al[1]);
    split(a_s[g * lda + k0 + t + 4], ah[2], al[2]);
    split(a_s[(g + 8) * lda + k0 + t + 4], ah[3], al[3]);
#pragma unroll
    for (int j0 = 0; j0 < kNT; j0 += kGroup) {
      uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (j0 + q < nt) {
          const int o = (nt0 + j0 + q) * 8 + g;
          load_w<WS>(wh, wl, ldw, k0 + t, o, H, O, bh[q][0], bl[q][0]);
          load_w<WS>(wh, wl, ldw, k0 + t + 4, o, H, O, bh[q][1], bl[q][1]);
        }
      }
      add_step(acc + j0, ah, al, bh, bl, nt - j0);
    }
  }
}

// Store accumulator fragments of column tiles nt0 .. nt0 + nt - 1 as rows
// of dst [16][ld].
__device__ __forceinline__ void store_frags(const float acc[kNT][4], int nt0,
                                            int nt, float* dst, int ld,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j < nt) {
      const int c = (nt0 + j) * 8 + 2 * t;
      *reinterpret_cast<float2*>(dst + g * ld + c) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(dst + (g + 8) * ld + c) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// g_a = g_m W^T for a 16-slot tile, h tiles nt0 .. nt0 + nt - 1 of 8, k
// over o < Op in steps of 8. Each step's k order is permuted to pairs
// (o = 2t, 2t + 1 for the fragment's t, t + 4), so that the A fragment is
// one float2 of g_m's row and the B fragment one float2 of W's row h.
template <bool WSMEM>
__device__ __forceinline__ void grad_products(const float* gm_s, int ldg,
                                              const float* w, int ldw, int H,
                                              int O, int Op, int nt0, int nt,
                                              float acc[kNT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k0 = 0; k0 < Op; k0 += 8) {
    const int o = k0 + 2 * t;
    const float2 top = *reinterpret_cast<const float2*>(gm_s + g * ldg + o);
    const float2 bot =
        *reinterpret_cast<const float2*>(gm_s + (g + 8) * ldg + o);
    uint32_t ah[4], al[4];
    split(top.x, ah[0], al[0]);
    split(bot.x, ah[1], al[1]);
    split(top.y, ah[2], al[2]);
    split(bot.y, ah[3], al[3]);
#pragma unroll
    for (int j0 = 0; j0 < kNT; j0 += kGroup) {
      uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (j0 + q < nt) {
          const int h = (nt0 + j0 + q) * 8 + g;
          float2 wv;
          if (WSMEM) {
            wv = *reinterpret_cast<const float2*>(w + h * ldw + o);
          } else {
            const bool hin = h < H;
            const float* wr = w + (int64_t)h * O;
            wv.x = hin && o < O ? __ldg(wr + o) : 0.f;
            wv.y = hin && o + 1 < O ? __ldg(wr + o + 1) : 0.f;
          }
          split(wv.x, bh[q][0], bl[q][0]);
          split(wv.y, bh[q][1], bl[q][1]);
        }
      }
      add_step(acc + j0, ah, al, bh, bl, nt - j0);
    }
  }
}

// ----------------------------------------------------------------------
// Launch configurations
// ----------------------------------------------------------------------

// The forward's: H padded to Hp, W split in shared memory in chunks of oc
// columns (grid.y = nchunks), `warps` warps a block, each with a tile
// buffer of 16 rows (a at stride lda, then m at stride ldm), a carry of oc
// floats and kPre prefetched key_max rows (#10).
struct FwdCfg {
  int Hp, oc, nchunks, ldw, lda, ldm, per_warp, warps;
  int act;  // the activation id (ACT_ROWWISE's kernels read it)
  size_t smem;
};

bool fwd_config(int H, int O, FwdCfg& c) {
  c.Hp = round8(H);
  for (c.oc = std::min(kFwdCols, round8(O)); c.oc >= 8; c.oc -= 8) {
    c.ldw = stride_mod32(c.oc, 8);
    c.lda = stride_mod32(c.Hp, 4);
    c.ldm = stride_mod32(c.oc, 8);
    c.per_warp = 16 * std::max(c.lda, c.ldm) + (1 + kPre) * round4(c.oc);
    const size_t wbytes = sizeof(float) * 2 * (size_t)c.Hp * c.ldw;
    const size_t pw = sizeof(float) * (size_t)c.per_warp;
    if (wbytes + pw <= (size_t)kMaxSmem) {
      c.warps = (int)std::min((size_t)kFwdWarps,
                              ((size_t)kMaxSmem - wbytes) / pw);
      c.nchunks = (O + c.oc - 1) / c.oc;
      c.smem = wbytes + pw * c.warps;
      return true;
    }
  }
  return false;
}

// The backward's: H padded to Hp, O to Op (a multiple of 16, the g_W^T
// tiles' rows); per warp a_s and d_s [16][lda], gm_s [16][ldg], a carry
// of Hp floats and kPre prefetched rows of key_max and of gsc; W f32 in
// shared memory at stride ldw (w_smem) or read from device memory. g_W^T's
// Mt x Nt tiles of 16 x 8 over a wm x wn grid of warps, each warp at most
// im x jn of them, kept in registers for the walk when im, jn <= kGW
// (resident).
struct BwdCfg {
  int Hp, Op, lda, ldg, ldw, per_warp, warps, w_smem, Mt, Nt, wm, wn, im,
      jn, resident;
  int act;  // the activation id (ACT_ROWWISE's kernels read it)
  size_t smem;
};

bool bwd_config(int H, int O, BwdCfg& c) {
  c.Hp = round8(H);
  c.Op = round16(O);
  c.lda = stride_mod32(c.Hp, 8);
  c.ldg = stride_mod32(c.Op, 8);
  c.ldw = stride_mod32(c.Op, 8);
  c.per_warp = 2 * 16 * c.lda + 16 * c.ldg + round4(c.Hp) +
               2 * kPre * round4(c.Op);
  const size_t pw = sizeof(float) * (size_t)c.per_warp;
  const size_t wbytes = sizeof(float) * (size_t)c.Hp * c.ldw;
  c.w_smem = wbytes + 4 * pw <= (size_t)kMaxSmem;
  const size_t room = (size_t)kMaxSmem - (c.w_smem ? wbytes : 0);
  c.warps = (int)std::min((size_t)kBwdWarps, room / pw);
  if (c.warps < 1) return false;
  c.smem = (c.w_smem ? wbytes : 0) + pw * c.warps;
  c.Mt = c.Op / 16;
  c.Nt = c.Hp / 8;
  // the fewest tiles a warp, a grid whose share stays in registers first
  int best = -1;
  for (int wm = 1; wm <= c.warps; ++wm) {
    if (c.warps % wm) continue;
    const int wn = c.warps / wm;
    const int im = (c.Mt + wm - 1) / wm, jn = (c.Nt + wn - 1) / wn;
    const int cost = im * jn + (im > kGW || jn > kGW ? 1 << 20 : 0);
    if (best < 0 || cost < best) {
      best = cost;
      c.wm = wm;
      c.wn = wn;
      c.im = im;
      c.jn = jn;
    }
  }
  c.resident = c.im <= kGW && c.jn <= kGW;
  return true;
}

// ----------------------------------------------------------------------
// #9 and #10
// ----------------------------------------------------------------------

// MODE_MAX: out[r, o] = max over valid slots of m (the f32 min if none).
// MODE_COUNT: out[r, o] = #valid slots with m == key_max[row_key[r], o].
// Blocks of grid.y chunk c take columns [c oc, c oc + oc); every block
// walks its warps' shares of the rows.
template <int ACT, int MODE, bool VEC, bool EDGE, typename TK>
__global__ void __launch_bounds__(kFwdWarps * 32)
max_fwd_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
               const TK* __restrict__ e, const int* __restrict__ slot_src,
               const int* __restrict__ slot_edge,
               const float* __restrict__ scale,
               const int* __restrict__ row_key,
               const int* __restrict__ row_ptr, const float* __restrict__ w,
               const float* __restrict__ key_max, int R, int H, int O,
               float slope, float* __restrict__ out, FwdCfg c) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int oc0 = blockIdx.y * c.oc;
  const int ocn = min(c.oc, O - oc0), nt = (ocn + 7) / 8;
  float* wh = smem;
  float* wl = wh + c.Hp * c.ldw;
  for (int e = threadIdx.x; e < c.Hp * c.ldw; e += blockDim.x) {
    const int h = e / c.ldw, o = e - (e / c.ldw) * c.ldw;
    uint32_t hi, lo;
    split(h < H && o < ocn ? w[(int64_t)h * O + oc0 + o] : 0.f, hi, lo);
    wh[e] = __uint_as_float(hi);
    wl[e] = __uint_as_float(lo);
  }
  float* buf = wl + c.Hp * c.ldw + warp * c.per_warp;
  float* carry = buf + 16 * max(c.lda, c.ldm);
  float* pre = carry + round4(c.oc);
  __syncthreads();

  int r, r_end, s, s_end;
  warp_rows(row_ptr, R, blockIdx.x * warps + warp, gridDim.x * warps, lane,
            r, r_end, s, s_end);
  const int* sedge = EDGE ? slot_edge : nullptr;
  Tile t;
  Meta meta = load_meta(row_ptr, row_key, slot_src, sedge, scale, r, s,
                        r_end, s_end, lane);
  while (next_tile(meta, r, s, r_end, s_end, t, lane)) {
    meta =  // the next tile's, in flight during this one
        load_meta(row_ptr, row_key, slot_src, sedge, scale, r, s, r_end,
                  s_end, lane);
    if (MODE == MODE_COUNT)
      prefetch_rows(key_max, t, O, oc0, ocn, pre, round4(c.oc), lane);
    stage_tile<ACT, TK, VEC, false, EDGE>(eq, ek, e, t, H, c.Hp, c.act,
                                          slope, buf, c.lda, nullptr, lane);
    __syncwarp();
    float acc[kNT][4];
    slot_products<W_SPLIT>(buf, c.lda, wh, wl, c.ldw, H, O, c.Hp, 0, nt, acc,
                           lane);
    __syncwarp();  // a is read; m takes its place
    store_frags(acc, 0, nt, buf, c.ldm, lane);
    if (MODE == MODE_COUNT) prefetch_wait();
    __syncwarp();
    for (int j = 0; j < t.nrows; ++j) {
      const int lo = __shfl_sync(kFull, t.rlo, j);
      const int hi = __shfl_sync(kFull, t.rhi, j);
      const int key = __shfl_sync(kFull, t.rkey, j);
      for (int o = lane; o < ocn; o += 32) {
        float v;
        if (MODE == MODE_MAX) {
          v = row_carried(t, j) ? carry[o] : -FLT_MAX;
          for (int i = lo; i < hi; ++i) {
            const float m = buf[i * c.ldm + o];
            if (slot_valid(t, i) && m > v) v = m;
          }
        } else {
          const float ref =
              row_value(key_max, j, key, O, oc0, o, pre, round4(c.oc));
          v = row_carried(t, j) ? carry[o] : 0.f;
          for (int i = lo; i < hi; ++i)
            if (slot_valid(t, i) && buf[i * c.ldm + o] == ref) v += 1.f;
        }
        if (row_ends(t, j))
          out[(int64_t)(t.r0 + j) * O + oc0 + o] = v;
        else
          carry[o] = v;
      }
    }
    __syncwarp();  // buf and carry are rewritten by the next tile
  }
}

// ----------------------------------------------------------------------
// #11
// ----------------------------------------------------------------------

// g_W^T tiles (i, j) of this warp's register block (ib, jb): rows o of
// tile mi = wm + c.wm (ib + i), columns h of tile ni = wn + c.wn (jb + j),
// += g_m^T a over the slots of every warp's tile of the step, summed apart
// and added in f32 (see add_step).
__device__ __forceinline__ void gw_block(float acc[kGW][kGW][4],
                                         const BwdCfg& c, const float* base,
                                         const int* tile_n, int warps,
                                         int wm, int wn, int ib, int jb,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  float part[kGW][kGW][4] = {};  // this step's sums (see add_step)
  for (int v = 0; v < warps; ++v) {
    const int nv = tile_n[v];
    if (nv == 0) continue;
    const float* av = base + v * c.per_warp;
    const float* gv = av + 2 * 16 * c.lda;
    for (int k0 = 0; k0 < nv; k0 += 8) {
      uint32_t ah[kGW][4], al[kGW][4], bh[kGW][2], bl[kGW][2];
#pragma unroll
      for (int i = 0; i < kGW; ++i) {
        const int mi = wm + c.wm * (ib + i);
        if (mi < c.Mt) {
          const int o = 16 * mi + g;
          split(gv[(k0 + t) * c.ldg + o], ah[i][0], al[i][0]);
          split(gv[(k0 + t) * c.ldg + o + 8], ah[i][1], al[i][1]);
          split(gv[(k0 + t + 4) * c.ldg + o], ah[i][2], al[i][2]);
          split(gv[(k0 + t + 4) * c.ldg + o + 8], ah[i][3], al[i][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kGW; ++j) {
        const int ni = wn + c.wn * (jb + j);
        if (ni < c.Nt) {
          const int h = 8 * ni + g;
          split(av[(k0 + t) * c.lda + h], bh[j][0], bl[j][0]);
          split(av[(k0 + t + 4) * c.lda + h], bh[j][1], bl[j][1]);
        }
      }
      // each pass for all the warp's tiles before the next pass
      bool in[kGW][kGW];
#pragma unroll
      for (int i = 0; i < kGW; ++i)
#pragma unroll
        for (int j = 0; j < kGW; ++j)
          in[i][j] = wm + c.wm * (ib + i) < c.Mt && wn + c.wn * (jb + j) < c.Nt;
#pragma unroll
      for (int i = 0; i < kGW; ++i)
#pragma unroll
        for (int j = 0; j < kGW; ++j)
          if (in[i][j]) mma(part[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < kGW; ++i)
#pragma unroll
        for (int j = 0; j < kGW; ++j)
          if (in[i][j]) mma(part[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < kGW; ++i)
#pragma unroll
        for (int j = 0; j < kGW; ++j)
          if (in[i][j]) mma(part[i][j], ah[i], bh[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kGW; ++i)
#pragma unroll
    for (int j = 0; j < kGW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
}

// Move a register block of g_W^T between registers and the [H, O] slice
// (load: 0 outside H x O; store: skip outside).
template <bool LOAD>
__device__ __forceinline__ void gw_io(float acc[kGW][kGW][4], const BwdCfg& c,
                                      float* slice, int H, int O, int wm,
                                      int wn, int ib, int jb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kGW; ++i)
#pragma unroll
    for (int j = 0; j < kGW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 16 * (wm + c.wm * (ib + i)) + g + (e >> 1) * 8;
        const int h = 8 * (wn + c.wn * (jb + j)) + 2 * t + (e & 1);
        const bool in = o < O && h < H && wm + c.wm * (ib + i) < c.Mt &&
                        wn + c.wn * (jb + j) < c.Nt;
        if (LOAD)
          acc[i][j][e] = in ? slice[(int64_t)h * O + o] : 0.f;
        else if (in)
          slice[(int64_t)h * O + o] = acc[i][j][e];
      }
}

// The backward (see the header). Persistent blocks; each warp walks the
// tiles of its share of the rows, all warps of a block in step, and after
// each step the block adds g_m^T a of its tiles to its g_W partial.
template <int ACT, bool VEC, bool WSMEM, bool EDGE, typename TK>
__global__ void __launch_bounds__(kBwdWarps * 32)
max_bwd_kernel(const float* __restrict__ eq, const TK* __restrict__ ek,
               const TK* __restrict__ e, const int* __restrict__ slot_src,
               const int* __restrict__ slot_edge,
               const float* __restrict__ scale,
               const int* __restrict__ row_key,
               const int* __restrict__ row_ptr, const float* __restrict__ w,
               const float* __restrict__ key_max,
               const float* __restrict__ gsc, int R, int H, int O,
               float slope, float* __restrict__ geq_rows,
               TK* __restrict__ gz, float* __restrict__ gw_part, BwdCfg c) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int tile_n[kBwdWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const float* wp = w;
  int ldw = O;
  float* base = smem;
  if (WSMEM) {
    for (int e = threadIdx.x; e < c.Hp * c.ldw; e += blockDim.x) {
      const int h = e / c.ldw, o = e - (e / c.ldw) * c.ldw;
      smem[e] = h < H && o < O ? w[(int64_t)h * O + o] : 0.f;
    }
    wp = smem;
    ldw = c.ldw;
    base = smem + c.Hp * c.ldw;
  }
  float* a_s = base + warp * c.per_warp;
  float* d_s = a_s + 16 * c.lda;
  float* gm_s = d_s + 16 * c.lda;
  float* carry = gm_s + 16 * c.ldg;
  const int ldp = round4(c.Op);
  float* pre_max = carry + round4(c.Hp);
  float* pre_gsc = pre_max + kPre * ldp;
  float* slice = gw_part + (int64_t)blockIdx.x * H * O;
  if (!c.resident)
    for (int e = threadIdx.x; e < H * O; e += blockDim.x) slice[e] = 0.f;
  const int wm = warp % c.wm, wn = warp / c.wm;
  float gacc[kGW][kGW][4];
#pragma unroll
  for (int i = 0; i < kGW; ++i)
#pragma unroll
    for (int j = 0; j < kGW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[i][j][e] = 0.f;
  __syncthreads();  // W is staged, the slice zeroed

  int r, r_end, s, s_end;
  warp_rows(row_ptr, R, blockIdx.x * warps + warp, gridDim.x * warps, lane,
            r, r_end, s, s_end);
  const int* sedge = EDGE ? slot_edge : nullptr;
  Tile t;
  Meta meta = load_meta(row_ptr, row_key, slot_src, sedge, scale, r, s,
                        r_end, s_end, lane);
  for (;;) {
    const bool have = next_tile(meta, r, s, r_end, s_end, t, lane);
    if (!__syncthreads_or(have)) break;
    if (have)  // the next tile's, in flight during this one
      meta = load_meta(row_ptr, row_key, slot_src, sedge, scale, r, s, r_end,
                       s_end, lane);
    if (lane == 0) tile_n[warp] = have ? t.n : 0;
    if (have) {
      prefetch_rows(key_max, t, O, 0, O, pre_max, ldp, lane);
      prefetch_rows(gsc, t, O, 0, O, pre_gsc, ldp, lane);
      // d_s: act'(z) for an elementwise sigma; a row-wise one's vjp
      // reads a and g_a
      stage_tile<ACT, TK, VEC, !kRowwise<ACT>, EDGE>(
          eq, ek, e, t, H, c.Hp, c.act, slope, a_s, c.lda, d_s, lane);
      __syncwarp();
      // m, into gm_s
      for (int nt0 = 0; nt0 < c.Op / 8; nt0 += kNT) {
        float acc[kNT][4];
        const int nt = min(kNT, c.Op / 8 - nt0);
        slot_products<WSMEM ? W_SMEM : W_GLOBAL>(a_s, c.lda, wp, nullptr, ldw,
                                                 H, O, c.Hp, nt0, nt, acc,
                                                 lane);
        store_frags(acc, nt0, nt, gm_s, c.ldg, lane);
      }
      prefetch_wait();
      __syncwarp();
      // g_m = win * gsc in place; 0 for o >= O and padding slots
      for (int j = 0; j < t.nrows; ++j) {
        const int lo = __shfl_sync(kFull, t.rlo, j);
        const int hi = __shfl_sync(kFull, t.rhi, j);
        const int key = __shfl_sync(kFull, t.rkey, j);
        for (int o = lane; o < c.Op; o += 32) {
          const bool oin = o < O;
          const float ref =
              oin ? row_value(key_max, j, key, O, 0, o, pre_max, ldp) : 0.f;
          const float gv =
              oin ? row_value(gsc, j, key, O, 0, o, pre_gsc, ldp) : 0.f;
          for (int i = lo; i < hi; ++i) {
            float* p = gm_s + i * c.ldg + o;
            *p = oin && slot_valid(t, i) && *p == ref ? gv : 0.f;
          }
        }
      }
      for (int e = t.n * c.Op + lane; e < 16 * c.Op; e += 32) {
        const int i = e / c.Op;
        gm_s[i * c.ldg + e - i * c.Op] = 0.f;
      }
      __syncwarp();
      // g_a = g_m W^T; g_z = act'(z) g_a in place of d_s, or for a
      // row-wise sigma g_a into d_s and then g_z = vjp(act, z)(g_a)
      {
        const int g = lane >> 2, tq = lane & 3;
        for (int nt0 = 0; nt0 < c.Hp / 8; nt0 += kNT) {
          float acc[kNT][4];
          const int nt = min(kNT, c.Hp / 8 - nt0);
          grad_products<WSMEM>(gm_s, c.ldg, wp, ldw, H, O, c.Op, nt0, nt, acc,
                               lane);
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (j < nt) {
              const int h = (nt0 + j) * 8 + 2 * tq;
              float2* p0 = reinterpret_cast<float2*>(d_s + g * c.lda + h);
              float2* p1 = reinterpret_cast<float2*>(d_s + (g + 8) * c.lda + h);
              if constexpr (kRowwise<ACT>) {
                *p0 = make_float2(acc[j][0], acc[j][1]);
                *p1 = make_float2(acc[j][2], acc[j][3]);
              } else {
                const float2 d0 = *p0, d1 = *p1;
                *p0 = make_float2(d0.x * acc[j][0], d0.y * acc[j][1]);
                *p1 = make_float2(d1.x * acc[j][2], d1.y * acc[j][3]);
              }
            }
          }
        }
      }
      __syncwarp();
      if constexpr (kRowwise<ACT>) {
        rowwise_vjp(a_s, d_s, c.lda, H, c.act, slope, lane);
        __syncwarp();
      }
      // g_z out; per row, the sum over its slots in order
      for (int j = 0; j < t.nrows; ++j) {
        const int lo = __shfl_sync(kFull, t.rlo, j);
        const int hi = __shfl_sync(kFull, t.rhi, j);
        for (int h = lane; h < H; h += 32) {
          float sum = row_carried(t, j) ? carry[h] : 0.f;
          for (int i = lo; i < hi; ++i) {
            const float v = d_s[i * c.lda + h];
            store(gz + (int64_t)(t.s0 + i) * H + h, v);
            sum += v;
          }
          if (row_ends(t, j))
            geq_rows[(int64_t)(t.r0 + j) * H + h] = sum;
          else
            carry[h] = sum;
        }
      }
    }
    __syncthreads();  // every warp's a_s, gm_s and tile_n are ready
    if (c.resident) {
      gw_block(gacc, c, base, tile_n, warps, wm, wn, 0, 0, lane);
    } else {
      for (int ib = 0; ib < c.im; ib += kGW)
        for (int jb = 0; jb < c.jn; jb += kGW) {
          float acc[kGW][kGW][4];
          gw_io<true>(acc, c, slice, H, O, wm, wn, ib, jb, lane);
          gw_block(acc, c, base, tile_n, warps, wm, wn, ib, jb, lane);
          gw_io<false>(acc, c, slice, H, O, wm, wn, ib, jb, lane);
        }
    }
    __syncthreads();  // before the next tile rewrites a_s, gm_s and tile_n
  }
  if (c.resident) gw_io<false>(gacc, c, slice, H, O, wm, wn, 0, 0, lane);
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

// Whether the gathers of a kernel may be 16 bytes a lane: rows of whole
// 16-byte chunks, tables that start on 16 bytes (e, the edge table, may be
// null).
bool vec_ok(const void* eq, const void* ek, const void* e, int ek_bf16,
            int H) {
  const int n = ek_bf16 ? 8 : 4;
  return H % n == 0 &&
         ((uintptr_t)eq | (uintptr_t)ek | (uintptr_t)e) % 16 == 0;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return sms;
}

// The arguments of #9 and #10: tables, slot arrays, W, key_max (#10) and
// widths; e and slot_edge null without an edge term.
struct FwdArgs {
  const void *eq, *ek, *e, *slot_src, *slot_edge, *scale, *row_key, *row_ptr,
      *w, *key_max;
  int R, H, O, act;
  float slope;
  void* out;
};

template <int ACT, int MODE, bool VEC, bool EDGE, typename TK>
int fwd_launch(const FwdArgs& a, cudaStream_t st, const FwdCfg& c) {
  auto kernel = max_fwd_kernel<ACT, MODE, VEC, EDGE, TK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    c.warps * 32, c.smem);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // as many blocks as the card holds at once, split over the chunks, and
  // no more warps than rows
  int bx = std::max(1, sms * std::max(per_sm, 1) / c.nchunks);
  bx = std::min(bx, (a.R + c.warps - 1) / c.warps);
  kernel<<<dim3(bx, c.nchunks), c.warps * 32, c.smem, st>>>(
      (const float*)a.eq, (const TK*)a.ek, (const TK*)a.e,
      (const int*)a.slot_src, (const int*)a.slot_edge, (const float*)a.scale,
      (const int*)a.row_key, (const int*)a.row_ptr, (const float*)a.w,
      (const float*)a.key_max, a.R, a.H, a.O, a.slope, (float*)a.out, c);
  return (int)cudaGetLastError();
}

template <int ACT, int MODE, bool EDGE, typename TK>
int fwd_entry(const FwdArgs& a, cudaStream_t st) {
  FwdCfg c;
  if (!fwd_config(a.H, a.O, c)) return (int)cudaErrorInvalidValue;
  c.act = a.act;
  if (vec_ok(a.eq, a.ek, a.e, sizeof(TK) == 2, a.H))
    return fwd_launch<ACT, MODE, true, EDGE, TK>(a, st, c);
  return fwd_launch<ACT, MODE, false, EDGE, TK>(a, st, c);
}

template <int ACT, int MODE>
int fwd_act(const FwdArgs& a, int ek_bf16, cudaStream_t st) {
  const bool edge = a.e != nullptr;
  if (ek_bf16)
    return edge ? fwd_entry<ACT, MODE, true, __nv_bfloat16>(a, st)
                : fwd_entry<ACT, MODE, false, __nv_bfloat16>(a, st);
  return edge ? fwd_entry<ACT, MODE, true, float>(a, st)
              : fwd_entry<ACT, MODE, false, float>(a, st);
}

template <int MODE>
int fwd_dispatch(const FwdArgs& a, int ek_bf16, void* stream) {
  if (a.R <= 0 || a.H <= 0 || a.O <= 0 ||
      (a.e == nullptr) != (a.slot_edge == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.act) {
    case ACT_LEAKY_RELU: return fwd_act<ACT_LEAKY_RELU, MODE>(a, ek_bf16, st);
    case ACT_TANH: return fwd_act<ACT_TANH, MODE>(a, ek_bf16, st);
    case ACT_CENTERED_RELU:
    case ACT_SOFTMAX: return fwd_act<ACT_ROWWISE, MODE>(a, ek_bf16, st);
    case ACT_GELU: return fwd_act<ACT_GELU, MODE>(a, ek_bf16, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int ACT, bool EDGE, typename TK>
const void* bwd_pick(bool vec, bool wsmem) {
  if (vec)
    return wsmem ? (const void*)max_bwd_kernel<ACT, true, true, EDGE, TK>
                 : (const void*)max_bwd_kernel<ACT, true, false, EDGE, TK>;
  return wsmem ? (const void*)max_bwd_kernel<ACT, false, true, EDGE, TK>
               : (const void*)max_bwd_kernel<ACT, false, false, EDGE, TK>;
}

template <int ACT>
const void* bwd_act(int bf16, bool edge, bool vec, bool wsmem) {
  if (bf16)
    return edge ? bwd_pick<ACT, true, __nv_bfloat16>(vec, wsmem)
                : bwd_pick<ACT, false, __nv_bfloat16>(vec, wsmem);
  return edge ? bwd_pick<ACT, true, float>(vec, wsmem)
              : bwd_pick<ACT, false, float>(vec, wsmem);
}

const void* bwd_kernel(int act, int bf16, bool edge, bool vec, bool wsmem) {
  switch (act) {
    case ACT_LEAKY_RELU:
      return bwd_act<ACT_LEAKY_RELU>(bf16, edge, vec, wsmem);
    case ACT_TANH: return bwd_act<ACT_TANH>(bf16, edge, vec, wsmem);
    case ACT_CENTERED_RELU:
    case ACT_SOFTMAX: return bwd_act<ACT_ROWWISE>(bf16, edge, vec, wsmem);
    case ACT_GELU: return bwd_act<ACT_GELU>(bf16, edge, vec, wsmem);
  }
  return nullptr;
}

int bwd_blocks(int R, int H, int O, int act, int ek_bf16, bool edge) {
  BwdCfg c;
  if (R <= 0 || H <= 0 || O <= 0 || !bwd_config(H, O, c)) return -1;
  const void* k = bwd_kernel(act, ek_bf16, edge, true, c.w_smem);
  if (k == nullptr) return -1;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)c.smem) != cudaSuccess)
    return -1;
  int per_sm = 0;
  const int sms = sm_count();
  if (sms <= 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, c.warps * 32,
                                                    c.smem) != cudaSuccess)
    return -1;
  const int need = (R + c.warps - 1) / c.warps;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  return need < blocks ? need : blocks;
}

int bwd_launch(const void* eq, const void* ek, const void* e, int ek_bf16,
               const void* slot_src, const void* slot_edge,
               const void* scale, const void* row_key, const void* row_ptr,
               const void* w, const void* key_max, const void* gsc, int R,
               int H, int O, int act, float slope, int blocks,
               void* geq_rows, void* gz, void* gw_part, void* gw,
               void* stream) {
  BwdCfg c;
  if (R <= 0 || H <= 0 || O <= 0 || blocks <= 0 || !bwd_config(H, O, c) ||
      (e == nullptr) != (slot_edge == nullptr))
    return (int)cudaErrorInvalidValue;
  c.act = act;
  cudaStream_t st = (cudaStream_t)stream;
  const void* k = bwd_kernel(act, ek_bf16, e != nullptr,
                             vec_ok(eq, ek, e, ek_bf16, H), c.w_smem);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&eq,       (void*)&ek,       (void*)&e,
                  (void*)&slot_src, (void*)&slot_edge, (void*)&scale,
                  (void*)&row_key,  (void*)&row_ptr,  (void*)&w,
                  (void*)&key_max,  (void*)&gsc,      (void*)&R,
                  (void*)&H,        (void*)&O,        (void*)&slope,
                  (void*)&geq_rows, (void*)&gz,       (void*)&gw_part,
                  (void*)&c};
  err = cudaLaunchKernel(k, dim3(blocks), dim3(c.warps * 32), args, c.smem,
                         st);
  if (err != cudaSuccess) return (int)err;
  const int n = H * O;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)gw_part, blocks, n, (float*)gw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns a CUDA error code (0 when
// the launch was accepted). Pointers are device pointers; eq, W, key_max,
// gsc and the f32 outputs are f32, the index arrays int32, the scales f32;
// ek (and g_z, and e in the edge forms) is bf16 when ek_bf16 != 0, else
// f32. act is a registry id (0 leaky_relu, 1 tanh, 2 centered_relu, 3
// softmax, 4 erf-GELU), slope its parameter.

int ell_max_fwd(const void* eq, const void* ek, int ek_bf16,
                const void* slot_src, const void* scale, const void* row_key,
                const void* row_ptr, const void* w, int R, int H, int O,
                int act, float slope, void* out, void* stream) {
  const FwdArgs a{eq, ek, nullptr, slot_src, nullptr, scale, row_key,
                  row_ptr, w, nullptr, R, H, O, act, slope, out};
  return fwd_dispatch<MODE_MAX>(a, ek_bf16, stream);
}

int ell_max_wincount(const void* eq, const void* ek, int ek_bf16,
                     const void* slot_src, const void* scale,
                     const void* row_key, const void* row_ptr, const void* w,
                     const void* key_max, int R, int H, int O, int act,
                     float slope, void* out, void* stream) {
  const FwdArgs a{eq, ek, nullptr, slot_src, nullptr, scale, row_key,
                  row_ptr, w, key_max, R, H, O, act, slope, out};
  return fwd_dispatch<MODE_COUNT>(a, ek_bf16, stream);
}

// The edge-term forms: e [E_pad, H] in ek's type, slot_edge [S] int32.
int ell_max_fwd_edge(const void* eq, const void* ek, const void* e,
                     int ek_bf16, const void* slot_src, const void* slot_edge,
                     const void* scale, const void* row_key,
                     const void* row_ptr, const void* w, int R, int H, int O,
                     int act, float slope, void* out, void* stream) {
  if (e == nullptr) return (int)cudaErrorInvalidValue;
  const FwdArgs a{eq, ek, e, slot_src, slot_edge, scale, row_key,
                  row_ptr, w, nullptr, R, H, O, act, slope, out};
  return fwd_dispatch<MODE_MAX>(a, ek_bf16, stream);
}

int ell_max_wincount_edge(const void* eq, const void* ek, const void* e,
                          int ek_bf16, const void* slot_src,
                          const void* slot_edge, const void* scale,
                          const void* row_key, const void* row_ptr,
                          const void* w, const void* key_max, int R, int H,
                          int O, int act, float slope, void* out,
                          void* stream) {
  if (e == nullptr) return (int)cudaErrorInvalidValue;
  const FwdArgs a{eq, ek, e, slot_src, slot_edge, scale, row_key,
                  row_ptr, w, key_max, R, H, O, act, slope, out};
  return fwd_dispatch<MODE_COUNT>(a, ek_bf16, stream);
}

// The path the three max kernels take for widths H and O, or -1 if they
// cannot take them: bit 0 the tensor-core product (the only one), bits
// 1-5 the forward's warps a block, bits 6-13 its W columns a block, bits
// 14-17 the backward's warps a block, bit 18 W in its shared memory, bit
// 19 its g_W partial in registers. Every sigma and the edge forms take
// the same path.
int ell_max_layout(int H, int O) {
  FwdCfg f;
  BwdCfg b;
  if (H <= 0 || O <= 0 || !fwd_config(H, O, f) || !bwd_config(H, O, b))
    return -1;
  return 1 | f.warps << 1 | f.oc << 6 | b.warps << 14 | b.w_smem << 18 |
         b.resident << 19;
}

// The number of blocks ell_max_bwd (edge != 0: ell_max_bwd_edge) launches
// (its g_W scratch holds one [H, O] partial per block), or -1 for widths
// it cannot take.
int ell_max_bwd_blocks(int R, int H, int O, int act, int ek_bf16, int edge) {
  return bwd_blocks(R, H, O, act, ek_bf16, edge != 0);
}

// gw_part holds `blocks` (from ell_max_bwd_blocks) partials of [H, O].
int ell_max_bwd(const void* eq, const void* ek, int ek_bf16,
                const void* slot_src, const void* scale, const void* row_key,
                const void* row_ptr, const void* w, const void* key_max,
                const void* gsc, int R, int H, int O, int act, float slope,
                int blocks, void* geq_rows, void* gz, void* gw_part, void* gw,
                void* stream) {
  return bwd_launch(eq, ek, nullptr, ek_bf16, slot_src, nullptr, scale,
                    row_key, row_ptr, w, key_max, gsc, R, H, O, act, slope,
                    blocks, geq_rows, gz, gw_part, gw, stream);
}

int ell_max_bwd_edge(const void* eq, const void* ek, const void* e,
                     int ek_bf16, const void* slot_src, const void* slot_edge,
                     const void* scale, const void* row_key,
                     const void* row_ptr, const void* w, const void* key_max,
                     const void* gsc, int R, int H, int O, int act,
                     float slope, int blocks, void* geq_rows, void* gz,
                     void* gw_part, void* gw, void* stream) {
  if (e == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_launch(eq, ek, e, ek_bf16, slot_src, slot_edge, scale, row_key,
                    row_ptr, w, key_max, gsc, R, H, O, act, slope, blocks,
                    geq_rows, gz, gw_part, gw, stream);
}

// values [*, H] is bf16 when values_bf16 != 0, else f32.
int ell_scaled_reduce(const void* values, int values_bf16,
                      const void* slot_idx, const void* scale,
                      const void* row_ptr, int R, int H, void* out,
                      void* stream) {
  if (R <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SIR_REDUCE(NF, T)                                                    \
  scaled_reduce_kernel<NF, T><<<dim3((R + kWarps - 1) / kWarps),             \
                                kWarps * 32, 0, st>>>(                       \
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
