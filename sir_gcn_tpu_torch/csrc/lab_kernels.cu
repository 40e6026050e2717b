// Timing-lab kernels for Hopper (sm_90a), with a plain C interface bound
// from Python through ctypes (sir_gcn_tpu_torch/ops/cuda/lab.py).
//
// They replace the Pallas kernels of the JAX package's timing lab:
// tools/kernel_lab.py make_v1 .. make_v6 (variants of the bucket
// broadcast + act + reduce of #1 at one bucket, B slots a row), make_copy,
// make_copy32, make_pass, make_pass2 (stream probes), and
// tools/gather_dma.py's gather kernel and copy_kernel (a per-row gather
// and a row-sum consumer). Each computes what its Pallas kernel computes,
// to the same output; where the Pallas variants differ only in a TPU knob
// (tile size, inner chunk, form of the reduce, lane layout of the scale,
// megacore semantics), the kernel here varies the matching Hopper knob:
//
//   lab_v1       make_v1 (whole tile staged in VMEM): a block stages its
//                tile of rows in shared memory with cp.async, then reduces
//                it; knob: rows per tile (the TPU's 4096-16384 slots are
//                1-4 MB, over the 227 KB a block can have)
//   lab_v2       make_v2 (inner loop, small live set): one warp per row,
//                16-byte loads straight into registers; knob: loads in
//                flight per lane (the TPU's row chunk)
//   lab_v3       make_v3 (reduce as B strided-slice adds): one thread per
//                feature pair of a row adds its B slots in order
//   lab_v4       make_v4 (bf16 compute): lab_v2 rounded to bf16 where the
//                Pallas kernel computes in bf16, summed in f32
//   lab_v5/v6    make_v5/make_v6 (plane-major [B, R, H]): a thread owns a
//                16-byte chunk of a row and walks the B planes, each read
//                coalesced; the scale [B, R] is loaded per lane (v5, the
//                TPU's [B, R, 1]) or once per row and passed by
//                __shfl_sync (v6, the TPU's [B, R]); knob: rows per block
//   lab_copy     make_copy: the sum-only stream of lab_v2 (bf16 rows, no
//                act, no scale)
//   lab_copy32   make_copy32: the same from f32 rows, by bulk copies: a
//                row's B slot rows are one contiguous slab; a block of
//                `inflight` warps keeps a ring of two stages of `inflight`
//                consecutive slabs in shared memory, each stage brought by
//                one cp.async.bulk that completes on its mbarrier, and
//                sums one stage while the other is in flight: lane c of
//                warp w sums chunk c of slab w over its B slots in slot
//                order and writes it as a float4 (below H = 128 a warp's
//                unit is 32 / C rows, one per group of C lanes); knob:
//                slabs in flight a block
//   lab_pass     make_pass: x + 1 in bf16, one 16-byte chunk a thread
//   lab_pass2    make_pass2: the same over tiles of rows, one block a tile
//                ("parallel") or a persistent grid of as many blocks as fit
//                at once walking the tiles ("arbitrary"); a thread issues
//                its 16 loads of a 64 KB tile (no L1 allocation) before it
//                stores any (evict-first). A ring of bulk copies in and out
//                through shared memory ran 0.4% slower on an H100 with one
//                block a tile, 0.7% faster with the persistent grid
//                (PERF.md)
//   lab_gather   gather_dma.py's kernel: per tile of T indices, the f32 sum
//                of the indexed table rows, written to 8 rows. Mosaic could
//                not DMA one row, so the TPU kernel copies each row's 8-row
//                tile; here each row is read alone. A persistent grid splits
//                the index stream evenly over its warps in batches of 32
//                indices (one tile per block left 12 of 132 SMs working
//                alone at the end); each warp writes a partial row for each
//                tile its share meets, and a second launch adds them in a
//                fixed order. A warp loads a batch's indices with one
//                coalesced load, a batch ahead, and gathers 16 B a lane,
//                8 rows in flight a warp
//   lab_tile_sum gather_dma.py's copy_kernel: the column sum of each tile
//                of T rows, written to 8 rows, one block a tile, 16 rows in
//                flight a warp, the block's warps summed in shared memory
//
// Bound: device-memory bytes for every kernel (a few flops per element
// read). The act-reduce kernels read ekg once and write each output row
// once; the stream kernels use 16-byte loads throughout. lab_gather's
// table (43.5 MB at the lab's size) fits in the 50 MB L2, so its rate is
// L2-assisted: its 704.6 MB of gathered rows cross from the L2 to the SMs,
// and that crossing, not the 57 MB its bound counts, is what it is held
// to. All sums are f32; the act-reduce kernels, lab_copy and lab_copy32
// sum a row's slots in slot order within a lane. Offsets are
// size_t. lab_copy32 moves its bytes with the Tensor Memory Accelerator's
// 1-D bulk copies (no tensor map): no register or load instruction a
// 16-byte chunk, 64 KB copies of 8 rows at the lab's size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGatherInflight = 16;
constexpr int kMaxH = 256;  // a bf16 row of 32 16-byte chunks
// the rows each tile's sum is written to (the TPU's (8, 128) output block)
constexpr int TILE_ROWS = 8;
// lab_gather: rows in flight a warp (from the L2 on an H100, 8 ran 6%
// faster than 16 and 1.5% faster than 4, 32 slower, PERF.md)
constexpr int kGatherRows = 8;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block can have

// lab_pass2: 16-byte loads a thread in flight before its stores (the
// lab's 64 KB tile over kThreads threads).
constexpr int kPassLoads = 16;

// lab_copy32's ring: a block sums one stage while the other is in flight
// (3 or 4 stages of 2 slabs ran slower on an H100, PERF.md).
constexpr int kSlabStages = 2;

// 16 bytes of T widened to f32.
template <typename T>
struct Pack;
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// x rounded to bf16 (nearest even) and widened back, as astype(bf16).
__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float leaky(float z, float slope) {
  return z >= 0.f ? z : slope * z;
}

// Load n f32 values (n a multiple of 4) as float4s.
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

// ---------------------------------------------------------------------
// lab_v2, lab_v4, lab_copy: one warp per row of B slots
// ---------------------------------------------------------------------

enum { MODE_ACT = 0, MODE_ACT_BF16 = 1, MODE_SUM = 2 };

// One slot's term for feature value f, eq value q (bf16-rounded under
// MODE_ACT_BF16) and scale w.
template <int MODE>
__device__ __forceinline__ float term(float f, float q, float w, float slope) {
  if (MODE == MODE_SUM) return f;
  if (MODE == MODE_ACT) return leaky(f + q, slope) * w;
  // make_v4: z = bf16(ekg + bf16(eq)); a = where(z >= 0, z, bf16(bf16(slope)
  // * z)); m = bf16(a * bf16(sc)); each product of two bf16 values is exact
  // in f32, so one rounding after it is the bf16 product
  const float z = rnd(f + q);
  const float a = z >= 0.f ? z : rnd(rnd(slope) * z);
  return rnd(a * rnd(w));
}

// The row r of x [R*B, H] holds slots r*B .. r*B+B-1. C = H / Pack::N
// 16-byte chunks a row (a power of two <= 32): lane l owns chunk l % C and
// the slots l / C, l / C + 32 / C, ...; U loads a lane are issued before
// any is used. The lanes of one chunk are summed by shuffles at the end.
template <int MODE, typename T, int U>
__global__ void __launch_bounds__(kThreads)
row_reduce_kernel(const T* __restrict__ x, const float* __restrict__ eq,
                  const float* __restrict__ sc, int R, int B, int H,
                  float slope, float* __restrict__ out) {
  constexpr int EPV = Pack<T>::N;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp leaves together
  const int C = H / EPV;
  const int step = 32 / C;  // slots one warp load covers
  const int c = lane & (C - 1);
  float q[EPV], acc[EPV];
#pragma unroll
  for (int j = 0; j < EPV; ++j) acc[j] = q[j] = 0.f;
  if (MODE != MODE_SUM) {
    load_f32<EPV>(eq + (size_t)r * H + c * EPV, q);
    if (MODE == MODE_ACT_BF16) {
#pragma unroll
      for (int j = 0; j < EPV; ++j) q[j] = rnd(q[j]);
    }
  }
  const T* row = x + (size_t)r * B * H + c * EPV;
  const float* srow = sc + (size_t)r * B;
  for (int s = lane / C; s < B; s += step * U) {
    uint4 v[U];
    float w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = s + u * step;
      v[u] = t < B ? load16(row + (size_t)t * H) : make_uint4(0, 0, 0, 0);
      w[u] = MODE != MODE_SUM && t < B ? __ldg(srow + t) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s + u * step < B) {
        float f[EPV];
        Pack<T>::widen(v[u], f);
#pragma unroll
        for (int j = 0; j < EPV; ++j) acc[j] += term<MODE>(f[j], q[j], w[u], slope);
      }
    }
  }
  for (int off = C; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < EPV; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
  }
  if (lane < C) store_f32<EPV>(out + (size_t)r * H + c * EPV, acc);
}

// ---------------------------------------------------------------------
// lab_v1: the tile staged in shared memory first
// ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// A block owns rows r0 .. r0+TR-1: it copies their TR*B slot rows (bf16,
// contiguous) into shared memory, waits, and then each thread reduces
// feature pairs (row, p) over the B slots in order.
__global__ void __launch_bounds__(kThreads)
staged_act_reduce_kernel(const __nv_bfloat16* __restrict__ ekg,
                         const float* __restrict__ eq,
                         const float* __restrict__ sc, int R, int B, int H,
                         int TR, float slope, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, R - r0);
  const size_t chunks = (size_t)rows * B * H / 8;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(ekg + (size_t)r0 * B * H);
  for (size_t i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async16(tile_smem + 16 * i, src + 16 * i);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const __nv_bfloat162* tile =
      reinterpret_cast<const __nv_bfloat162*>(tile_smem);
  const int P = H / 2;
  for (int i = threadIdx.x; i < rows * P; i += blockDim.x) {
    const int rr = i / P, p = i - rr * P;
    const size_t r = (size_t)r0 + rr;
    const float2 q = __ldg(reinterpret_cast<const float2*>(eq + r * H) + p);
    float a0 = 0.f, a1 = 0.f;
    for (int b = 0; b < B; ++b) {
      const float2 f = __bfloat1622float2(tile[((size_t)rr * B + b) * P + p]);
      const float w = __ldg(sc + r * B + b);
      a0 += leaky(f.x + q.x, slope) * w;
      a1 += leaky(f.y + q.y, slope) * w;
    }
    reinterpret_cast<float2*>(out + r * H)[p] = make_float2(a0, a1);
  }
}

// ---------------------------------------------------------------------
// lab_v3: one thread per feature pair of a row, B slot adds in order
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
pair_act_reduce_kernel(const __nv_bfloat16* __restrict__ ekg,
                       const float* __restrict__ eq,
                       const float* __restrict__ sc, int R, int B, int H,
                       float slope, float* __restrict__ out) {
  const int P = H / 2;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * P) return;
  const size_t r = i / P;
  const int p = (int)(i - r * P);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(ekg);
  const float2 q = __ldg(reinterpret_cast<const float2*>(eq + r * H) + p);
  float a0 = 0.f, a1 = 0.f;
  for (int b = 0; b < B; ++b) {
    const float2 f = __bfloat1622float2(x[(r * B + b) * P + p]);
    const float w = __ldg(sc + r * B + b);
    a0 += leaky(f.x + q.x, slope) * w;
    a1 += leaky(f.y + q.y, slope) * w;
  }
  reinterpret_cast<float2*>(out + r * H)[p] = make_float2(a0, a1);
}

// ---------------------------------------------------------------------
// lab_v5, lab_v6: plane-major x3 [B, R, H], scale [B, R]
// ---------------------------------------------------------------------

// Thread t owns chunk t % C (C = H / 8, a power of two <= 32) of row t / C;
// a warp covers 32 / C rows. SHFL: the first 32 / C lanes load the warp's
// rows' scales of plane b and pass each to its row's lanes.
template <bool SHFL>
__global__ void __launch_bounds__(512)
plane_act_reduce_kernel(const __nv_bfloat16* __restrict__ x3,
                        const float* __restrict__ eq,
                        const float* __restrict__ sc, int R, int B, int H,
                        float slope, float* __restrict__ out) {
  const int C = H / 8;
  const int lane = threadIdx.x & 31;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t r = t / C;
  const int c = (int)(t & (C - 1));
  const size_t warp_row0 = (t - lane) / C;
  const bool live = r < (size_t)R;
  float q[8], acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = q[j] = 0.f;
  if (live) load_f32<8>(eq + r * H + c * 8, q);
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    float w;
    if (SHFL) {
      const size_t mine_row = warp_row0 + lane;
      const float mine = lane < 32 / C && mine_row < (size_t)R
                             ? __ldg(sc + (size_t)b * R + mine_row)
                             : 0.f;
      w = __shfl_sync(kFull, mine, lane / C);
    } else {
      w = live ? __ldg(sc + (size_t)b * R + r) : 0.f;
    }
    if (live) {
      float f[8];
      Pack<__nv_bfloat16>::widen(
          load16(x3 + ((size_t)b * R + r) * H + c * 8), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += leaky(f[j] + q[j], slope) * w;
    }
  }
  if (live) store_f32<8>(out + r * H + c * 8, acc);
}

// ---------------------------------------------------------------------
// Hopper's 1-D bulk copies (cp.async.bulk, no tensor map) and mbarriers
// ---------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One arrival expected a phase: the thread that arms the barrier with the
// byte count of the copy (mbar_expect_tx).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Makes the initialised barriers visible to the copy engine.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// to shared memory; completes `bytes` of the transaction count of `bar`.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------
// lab_copy32: the f32 sum-only stream by bulk copies of whole slabs
// ---------------------------------------------------------------------

// A block is W warps. C = H / 4 float4 chunks a row (a power of two <=
// 32); a unit is 32 / C consecutive rows, lane group g = lane / C of a
// warp owning row g of it, and its B slot rows a row are contiguous: 512 *
// B bytes a full unit. A stage holds W consecutive units, brought by one
// bulk copy, and warp w sums unit w. Block b takes the stages' worth of
// rows b, b + gridDim.x, ... through a ring of kSlabStages stages, each
// with its mbarrier: while the block sums one stage the others are in
// flight, and thread 0 refills a stage as soon as the block has read it.
template <int W>
__global__ void __launch_bounds__(32 * W)
slab_sum_kernel(const float* __restrict__ x, int R, int B, int H,
                float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char slab_ring[];
  __shared__ uint64_t full[kSlabStages];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = H / 4;
  const int rows = 32 / C;  // a unit's rows
  const int g = lane / C, c = lane & (C - 1);
  const unsigned stage_bytes = 512u * B * W;
  const size_t row_bytes = (size_t)B * H * 4;
  const long long stage_rows = (long long)rows * W;
  const long long copies = (R + stage_rows - 1) / stage_rows;
  const long long step = gridDim.x;
  auto load = [&](long long i, int s) {
    const long long left = R - i * stage_rows;  // the last may be short
    const unsigned bytes =
        (unsigned)((left < stage_rows ? left : stage_rows) * row_bytes);
    mbar_expect_tx(&full[s], bytes);
    bulk_load(slab_ring + (size_t)s * stage_bytes,
              reinterpret_cast<const unsigned char*>(x) +
                  i * stage_rows * row_bytes,
              bytes, &full[s]);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSlabStages; ++s) mbar_init(&full[s]);
    mbar_init_fence();
#pragma unroll
    for (int s = 0; s < kSlabStages; ++s)
      if (blockIdx.x + s * step < copies) load(blockIdx.x + s * step, s);
  }
  __syncthreads();
  unsigned k = 0;
  for (long long i = blockIdx.x; i < copies; ++k, i += step) {
    const int s = (int)(k % kSlabStages);
    mbar_wait(&full[s], (k / kSlabStages) & 1u);
    const long long r = i * stage_rows + warp * rows + g;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R) {
      const float4* p = reinterpret_cast<const float4*>(
                            slab_ring + (size_t)s * stage_bytes) +
                        ((size_t)warp * rows + g) * B * C + c;
#pragma unroll 4
      for (int b = 0; b < B; ++b) {
        const float4 v = p[(size_t)b * C];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    __syncthreads();  // the block has read stage s
    if (threadIdx.x == 0 && i + kSlabStages * step < copies)
      load(i + kSlabStages * step, s);
    if (r < R) reinterpret_cast<float4*>(out + r * H)[c] = acc;
  }
}

// ---------------------------------------------------------------------
// lab_pass, lab_pass2: y = x + 1 in bf16, 16 bytes at a time
// ---------------------------------------------------------------------

__device__ __forceinline__ uint4 add_one(uint4 u) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(f.x + 1.f, f.y + 1.f);
  }
  return u;
}

__global__ void __launch_bounds__(kThreads)
pass_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, size_t n16) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n16) y[i] = add_one(__ldg(x + i));
}

// 16 bytes read once (no L1 allocation) and written once (evict first).
__device__ __forceinline__ uint4 load16_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store16_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Tiles of `tile16` chunks; block b takes tiles b, b + gridDim.x, ... A
// thread issues kPassLoads 16-byte loads of the tile (the whole 64 KB tile
// a block at the lab's H) before it adds and stores any.
__global__ void __launch_bounds__(kThreads)
pass_burst_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                  size_t n16, int tile16, size_t tiles) {
  for (size_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t base = tile * tile16;
    const size_t end = base + tile16 < n16 ? base + tile16 : n16;
    for (size_t i0 = base + threadIdx.x; i0 < end;
         i0 += (size_t)kThreads * kPassLoads) {
      uint4 v[kPassLoads];
#pragma unroll
      for (int u = 0; u < kPassLoads; ++u) {
        const size_t k = i0 + (size_t)u * kThreads;
        if (k < end) v[u] = load16_stream(x + k);
      }
#pragma unroll
      for (int u = 0; u < kPassLoads; ++u) {
        const size_t k = i0 + (size_t)u * kThreads;
        if (k < end) store16_stream(y + k, add_one(v[u]));
      }
    }
  }
}

// ---------------------------------------------------------------------
// lab_tile_sum: one block per tile of T rows, f32 column sum
// ---------------------------------------------------------------------

// Block g sums rows v[g*T + i] for i < T and writes the sum to out rows
// 8g .. 8g+7. C = H / 8 chunks a row: a warp load covers 32 / C rows, and
// each lane issues U loads before using any, so kGatherInflight rows are
// in flight a warp.
template <int C>
__global__ void __launch_bounds__(kThreads)
tile_sum_kernel(const __nv_bfloat16* __restrict__ tbl, int T, int H,
                float* __restrict__ out) {
  constexpr int kStep = 32 / C;
  constexpr int U = kGatherInflight / kStep > 0 ? kGatherInflight / kStep : 1;
  __shared__ float part[kWarps][kMaxH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & (C - 1), sub = lane / C;
  const size_t first = (size_t)blockIdx.x * T;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int i0 = warp * kStep * U; i0 < T; i0 += kWarps * kStep * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kStep + sub;
      v[u] = make_uint4(0, 0, 0, 0);
      if (i < T) v[u] = load16(tbl + (first + i) * H + c * 8);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * kStep + sub < T) {
        float f[8];
        Pack<__nv_bfloat16>::widen(v[u], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += f[j];
      }
    }
  }
#pragma unroll
  for (int off = C; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
  }
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) part[warp][c * 8 + j] = acc[j];
  }
  __syncthreads();
  for (int f = threadIdx.x; f < H; f += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][f];
#pragma unroll
    for (int k = 0; k < 8; ++k) out[((size_t)blockIdx.x * 8 + k) * H + f] = s;
  }
}

// ---------------------------------------------------------------------
// lab_gather: an even persistent split of the gather stream
// ---------------------------------------------------------------------

// The index stream is cut into batches of 32 indices that never cross a
// tile (a tile of T indices is nbt = ceil(T / 32) batches, the last one
// short where 32 does not divide T), nb = G * nbt batches in all. Warp w of
// the nw walking them takes batches [w nb / nw, (w + 1) nb / nw): the same
// count to within one. Each warp sums the rows of each tile its range
// meets and writes that partial row into the tile's output rows 1..7, at
// row 1 + (w - the warp that holds the tile's first batch); nw is kept low
// enough (gather_warps) that at most 7 warps meet a tile. gather_combine
// then adds a tile's partials in warp order and writes the sum to its 8
// rows. Fixed orders throughout, no atomics: two launches give the same
// bits.
struct GatherSplit {
  int T, nbt, nb, nw;
  __device__ __forceinline__ int first(int w) const {  // of warp w's range
    return (int)((long long)w * nb / nw);
  }
  // the warp whose range holds batch b
  __device__ __forceinline__ int owner(int b) const {
    return (int)(((long long)(b + 1) * nw - 1) / nb);
  }
};

// The end of a warp's share of a tile: the lanes of each chunk c (C = H / 8
// chunks a row, 32 / C lanes a chunk) add their sums, and chunk c's first
// lane writes them into row `row` of tile g's 8 output rows.
template <int C>
__device__ __forceinline__ void gather_flush(float (&acc)[8], int lane,
                                             int g, int row, int H,
                                             float* __restrict__ out) {
#pragma unroll
  for (int off = C; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
  }
  if (lane < C)
    store_f32<8>(out + ((size_t)g * TILE_ROWS + row) * H + lane * 8, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
}

// Lane l of a warp loads index l of the next batch
// (one coalesced load) before the current batch's rows are gathered; a
// row's index reaches its C lanes by __shfl_sync, and each lane gathers
// its 16-byte chunk of LOADS rows (kGatherRows rows in flight a warp)
// before it adds any. kWarps warps a block.
template <int C>
__global__ void __launch_bounds__(kThreads)
gather_loads_kernel(const __nv_bfloat16* __restrict__ tbl,
                    const int* __restrict__ idx, GatherSplit sp, int H,
                    float* __restrict__ out) {
  constexpr int kStep = 32 / C;  // rows a warp load covers
  constexpr int LOADS = kGatherRows / kStep < 1 ? 1
                        : kGatherRows / kStep > C ? C
                        : kGatherRows / kStep;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= sp.nw) return;
  const int b0 = sp.first(w), b1 = sp.first(w + 1);
  if (b0 >= b1) return;
  const int c = lane & (C - 1), sub = lane / C;
  int g = b0 / sp.nbt, j = b0 - g * sp.nbt;  // the batch's tile and place
  int row = 1 + w - sp.owner(g * sp.nbt);
  auto index_of = [&](int gg, int jj) {  // lane's index of batch (gg, jj)
    const int i = jj * 32 + lane;
    return i < sp.T ? __ldg(idx + (size_t)gg * sp.T + i) : 0;
  };
  int cur = index_of(g, j);
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int b = b0; b < b1; ++b) {
    const int n = min(32, sp.T - j * 32);  // rows of the batch
    int ng = g, nj = j + 1;
    if (nj == sp.nbt) ng = g + 1, nj = 0;
    const int nxt = b + 1 < b1 ? index_of(ng, nj) : 0;
#pragma unroll
    for (int h = 0; h < 32 / kStep; h += LOADS) {
      uint4 v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int r = (h + u) * kStep + sub;  // the row in the batch
        const int node = __shfl_sync(kFull, cur, r);
        v[u] = r < n ? load16(tbl + (size_t)node * H + c * 8)
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        float f[8];
        Pack<__nv_bfloat16>::widen(v[u], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] += f[k];
      }
    }
    if (nj == 0 || b + 1 == b1) {  // the end of the warp's share of tile g
      gather_flush<C>(acc, lane, g, row, H, out);
      row = 1;  // the next tile's first batch is this warp's
    }
    g = ng, j = nj, cur = nxt;
  }
}

// Tile g's partial rows 1 .. m (m the warps that meet it) added in warp
// order, the sum written to its 8 rows; one thread a (tile, feature).
__global__ void __launch_bounds__(kThreads)
gather_combine_kernel(GatherSplit sp, int G, int H, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)G * H) return;
  const int g = (int)(i / H), f = (int)(i - (size_t)g * H);
  const int m = sp.owner((g + 1) * sp.nbt - 1) - sp.owner(g * sp.nbt) + 1;
  float* tile = out + (size_t)g * TILE_ROWS * H + f;
  float s = 0.f;
  for (int k = 1; k <= m; ++k) s += tile[(size_t)k * H];
#pragma unroll
  for (int k = 0; k < TILE_ROWS; ++k) tile[(size_t)k * H] = s;
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------

bool pow2_upto_32(int c) { return c >= 1 && c <= 32 && (c & (c - 1)) == 0; }

unsigned blocks_for(size_t n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

template <int MODE, typename T>
int launch_row_reduce(const void* x, const void* eq, const void* sc, int R,
                      int B, int H, int inflight, float slope, void* out,
                      cudaStream_t st) {
  if (R <= 0 || B <= 0 || !pow2_upto_32(H / Pack<T>::N) ||
      H % Pack<T>::N != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(R, kWarps));
#define SIR_ROW_REDUCE(U)                                                  \
  row_reduce_kernel<MODE, T, U><<<grid, kThreads, 0, st>>>(                \
      (const T*)x, (const float*)eq, (const float*)sc, R, B, H, slope,     \
      (float*)out)
  switch (inflight) {
    case 2: SIR_ROW_REDUCE(2); break;
    case 4: SIR_ROW_REDUCE(4); break;
    case 8: SIR_ROW_REDUCE(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SIR_ROW_REDUCE
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, and returns in
// `grid` the blocks of `threads` that fit on the card at once.
template <typename K>
cudaError_t fit(K kernel, int threads, size_t smem, size_t* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  *grid = (size_t)sms * per_sm;
  return e;
}

// W warps a block, W units a stage.
template <int W>
int launch_slab_sum(const void* x, int R, int B, int H, void* out,
                    cudaStream_t st) {
  const size_t smem = (size_t)kSlabStages * W * 512 * B;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  size_t grid = 0;
  const cudaError_t e = fit(slab_sum_kernel<W>, 32 * W, smem, &grid);
  if (e != cudaSuccess) return (int)e;
  const size_t stage_rows = (size_t)(32 / (H / 4)) * W;
  const size_t copies = (R + stage_rows - 1) / stage_rows;
  slab_sum_kernel<W><<<(unsigned)(grid < copies ? grid : copies), 32 * W,
                       smem, st>>>((const float*)x, R, B, H, (float*)out);
  return (int)cudaGetLastError();
}

int launch_tile_sum(const void* tbl, int G, int T, int H, void* out,
                    cudaStream_t st) {
  if (G <= 0 || T <= 0 || H % 8 != 0 || !pow2_upto_32(H / 8))
    return (int)cudaErrorInvalidValue;
#define SIR_TILE_SUM(C)                                                    \
  tile_sum_kernel<C><<<G, kThreads, 0, st>>>((const __nv_bfloat16*)tbl, T, \
                                             H, (float*)out)
  switch (H / 8) {
    case 1: SIR_TILE_SUM(1); break;
    case 2: SIR_TILE_SUM(2); break;
    case 4: SIR_TILE_SUM(4); break;
    case 8: SIR_TILE_SUM(8); break;
    case 16: SIR_TILE_SUM(16); break;
    default: SIR_TILE_SUM(32); break;
  }
#undef SIR_TILE_SUM
  return (int)cudaGetLastError();
}

// The warps lab_gather's split takes: as many as are resident (`resident`),
// but few enough that each has at least ceil((nbt - 1) / 6) batches, so
// that at most 7 warps meet a tile of nbt batches (its output rows 1..7
// hold their partials); at least one.
int gather_warps(long long resident, int nbt, int nb) {
  const int qmin = nbt > 7 ? (nbt - 1 + 5) / 6 : 1;
  const long long most = nb / qmin;
  const long long nw = resident < most ? resident : most;
  return nw > 0 ? (int)nw : 1;
}

// lab_gather's split and the grid of its kernel, or an error.
template <int C>
cudaError_t gather_plan(int G, int T, GatherSplit* sp, unsigned* grid) {
  size_t resident = 0;
  const cudaError_t e = fit(gather_loads_kernel<C>, kThreads, 0, &resident);
  if (e != cudaSuccess) return e;
  sp->T = T;
  sp->nbt = (T + 31) / 32;
  sp->nb = G * sp->nbt;
  sp->nw = gather_warps((long long)resident * kWarps, sp->nbt, sp->nb);
  *grid = (unsigned)((sp->nw + kWarps - 1) / kWarps);
  return cudaSuccess;
}

template <int C>
int launch_gather(const void* tbl, const void* idx, int G, int T, int H,
                  void* out, cudaStream_t st) {
  GatherSplit sp;
  unsigned grid = 0;
  const cudaError_t e = gather_plan<C>(G, T, &sp, &grid);
  if (e != cudaSuccess) return (int)e;
  gather_loads_kernel<C><<<grid, kThreads, 0, st>>>(
      (const __nv_bfloat16*)tbl, (const int*)idx, sp, H, (float*)out);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  gather_combine_kernel<<<blocks_for((size_t)G * H, kThreads), kThreads, 0,
                          st>>>(sp, G, H, (float*)out);
  return (int)cudaGetLastError();
}

// CALL(C) for the chunks C = H / 8 of a bf16 row (a power of two <= 32).
#define SIR_CHUNKS_SWITCH(H, CALL) \
  switch ((H) / 8) {               \
    case 1: return CALL(1);        \
    case 2: return CALL(2);        \
    case 4: return CALL(4);        \
    case 8: return CALL(8);        \
    case 16: return CALL(16);      \
    default: return CALL(32);      \
  }

bool gather_args_ok(int G, int T, int H) {
  return G > 0 && T > 0 && H % 8 == 0 && pow2_upto_32(H / 8) &&
         (long long)G * T <= 0x7fffffffLL;
}

template <bool SHFL>
int launch_plane(const void* x3, const void* eq, const void* sc, int R, int B,
                 int H, int block_rows, float slope, void* out,
                 cudaStream_t st) {
  const int C = H / 8;
  if (R <= 0 || B <= 0 || H % 8 != 0 || !pow2_upto_32(C) || block_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = block_rows * C;
  if (threads % 32 != 0 || threads > 512) return (int)cudaErrorInvalidValue;
  plane_act_reduce_kernel<SHFL>
      <<<blocks_for((size_t)R * C, threads), threads, 0, st>>>(
          (const __nv_bfloat16*)x3, (const float*)eq, (const float*)sc, R, B,
          H, slope, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted), or cudaErrorInvalidValue for sizes or a knob it
// does not take. ekg, x3, tbl and v are bf16; eq, sc and every output f32;
// idx int32. R rows of B slots, width H.

int lab_v1(const void* ekg, const void* eq, const void* sc, int R, int B,
           int H, int tile_rows, float slope, void* out, void* stream) {
  const size_t smem = (size_t)tile_rows * B * H * 2;
  if (R <= 0 || B <= 0 || H % 8 != 0 || tile_rows <= 0 || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        staged_act_reduce_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  staged_act_reduce_kernel<<<blocks_for(R, tile_rows), kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)ekg, (const float*)eq, (const float*)sc, R, B, H,
      tile_rows, slope, (float*)out);
  return (int)cudaGetLastError();
}

int lab_v2(const void* ekg, const void* eq, const void* sc, int R, int B,
           int H, int inflight, float slope, void* out, void* stream) {
  return launch_row_reduce<MODE_ACT, __nv_bfloat16>(
      ekg, eq, sc, R, B, H, inflight, slope, out, (cudaStream_t)stream);
}

int lab_v3(const void* ekg, const void* eq, const void* sc, int R, int B,
           int H, float slope, void* out, void* stream) {
  if (R <= 0 || B <= 0 || H % 2 != 0) return (int)cudaErrorInvalidValue;
  pair_act_reduce_kernel<<<blocks_for((size_t)R * (H / 2), kThreads),
                           kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)ekg, (const float*)eq, (const float*)sc, R, B, H,
      slope, (float*)out);
  return (int)cudaGetLastError();
}

int lab_v4(const void* ekg, const void* eq, const void* sc, int R, int B,
           int H, int inflight, float slope, void* out, void* stream) {
  return launch_row_reduce<MODE_ACT_BF16, __nv_bfloat16>(
      ekg, eq, sc, R, B, H, inflight, slope, out, (cudaStream_t)stream);
}

int lab_v5(const void* x3, const void* eq, const void* sc, int R, int B,
           int H, int block_rows, float slope, void* out, void* stream) {
  return launch_plane<false>(x3, eq, sc, R, B, H, block_rows, slope, out,
                             (cudaStream_t)stream);
}

int lab_v6(const void* x3, const void* eq, const void* sc, int R, int B,
           int H, int block_rows, float slope, void* out, void* stream) {
  return launch_plane<true>(x3, eq, sc, R, B, H, block_rows, slope, out,
                            (cudaStream_t)stream);
}

int lab_copy(const void* x, int R, int B, int H, int inflight, void* out,
             void* stream) {
  return launch_row_reduce<MODE_SUM, __nv_bfloat16>(
      x, nullptr, nullptr, R, B, H, inflight, 0.f, out, (cudaStream_t)stream);
}

// x [R*B, H] f32, 16-byte aligned, as out; `inflight` warps a block and
// units of 512 * B bytes a stage, kSlabStages stages in at most 227 KB.
int lab_copy32(const void* x, int R, int B, int H, int inflight, void* out,
               void* stream) {
  if (R <= 0 || B <= 0 || H % 4 != 0 || !pow2_upto_32(H / 4) ||
      !aligned16(x) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (inflight) {
    case 2: return launch_slab_sum<2>(x, R, B, H, out, st);
    case 4: return launch_slab_sum<4>(x, R, B, H, out, st);
    case 8: return launch_slab_sum<8>(x, R, B, H, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// n bf16 elements, a multiple of 8.
int lab_pass(const void* x, long long n, void* out, void* stream) {
  if (n <= 0 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  const size_t n16 = (size_t)n / 8;
  pass_kernel<<<blocks_for(n16, kThreads), kThreads, 0,
                (cudaStream_t)stream>>>((const uint4*)x, (uint4*)out, n16);
  return (int)cudaGetLastError();
}

// Tiles of tile_elems elements (a multiple of 8); persistent != 0 walks
// them with as many blocks as fit at once. x and out 16-byte aligned.
int lab_pass2(const void* x, long long n, int tile_elems, int persistent,
              void* out, void* stream) {
  if (n <= 0 || n % 8 != 0 || tile_elems <= 0 || tile_elems % 8 != 0 ||
      !aligned16(x) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const size_t n16 = (size_t)n / 8;
  const int tile16 = tile_elems / 8;
  const size_t tiles = (n16 + tile16 - 1) / tile16;
  size_t grid = tiles;
  if (persistent) {
    size_t resident = 0;
    const cudaError_t e = fit(pass_burst_kernel, kThreads, 0, &resident);
    if (e != cudaSuccess) return (int)e;
    grid = resident < tiles ? resident : tiles;
  }
  pass_burst_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)out, n16, tile16, tiles);
  return (int)cudaGetLastError();
}

// out [G, 8, H]: tile g sums tbl rows idx[g*T .. g*T+T-1]; tbl and out
// 16-byte aligned. Two launches: the split's warps write partials into
// out, and gather_combine adds them.
int lab_gather(const void* tbl, const void* idx, int G, int T, int H,
               void* out, void* stream) {
  if (!gather_args_ok(G, T, H) || !aligned16(tbl) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define SIR_GATHER(C) launch_gather<C>(tbl, idx, G, T, H, out, st)
  SIR_CHUNKS_SWITCH(H, SIR_GATHER)
#undef SIR_GATHER
}

// Launches nothing: the warps lab_gather's split takes for these sizes
// (the launch's own choice), or a negative CUDA error.
int lab_gather_warps(int G, int T, int H) {
  if (!gather_args_ok(G, T, H)) return -(int)cudaErrorInvalidValue;
  GatherSplit sp;
  unsigned grid = 0;
#define SIR_PLAN(C)                                           \
  (gather_plan<C>(G, T, &sp, &grid) == cudaSuccess ? sp.nw    \
                                                   : -(int)cudaErrorInvalidValue)
  SIR_CHUNKS_SWITCH(H, SIR_PLAN)
#undef SIR_PLAN
}

// out [G*8, H]: tile g sums v rows g*T .. g*T+T-1.
int lab_tile_sum(const void* v, int G, int T, int H, void* out,
                 void* stream) {
  return launch_tile_sum(v, G, T, H, out, (cudaStream_t)stream);
}

const char* lab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
