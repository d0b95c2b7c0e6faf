// The top-2 of three kernels on Hopper's tensor cores (sm_90a): TMA loads
// into a ring of shared-memory stages, 3xTF32 products by wgmma, and the
// running top-2 in registers. One main loop, four epilogues:
//
//  * EPI_PARTIAL, the one-shot round (fused_round.cu; replaces the top-2
//    half of repro/kernels/fused_round.py::fused_round_pallas, body
//    _round_kernel): the nearest and second-nearest centroid on the
//    partial distance |c|^2 - 2 x.c, then |x|^2 (a pre-pass) added to
//    both winners and the sums clamped at 0.
//  * EPI_FULL, assign_top2 in f32 (assign_top2.cu; replaces
//    repro/kernels/kmeans_assign.py::assign_top2_pallas, body
//    _assign_kernel): the top-2 of the ref expression max(|x|^2 - 2 x.c +
//    |c|^2, 0), each column's value clamped before it is pushed, so the
//    clamp's ties at 0 go to the lower index.
//  * EPI_NESTED, the nested round's top-2 (fused_nested_round.cu;
//    replaces the top-2 of repro/kernels/fused_round.py::
//    fused_nested_round_pallas, body _nested_kernel): EPI_FULL, then the
//    keep-select and sqrt. Invalid rows give -1 / 0 / 0, settled rows pass
//    a_prev, d_keep and lb_keep through, the rest the top-2 as euclidean
//    distances.
//  * EPI_DOT writes the products x.c (n, k) instead (a check of the main
//    loop's operand and fragment layout).
//
// In each the lower index wins a tie, a duplicate of the minimum counts as
// the second, k == 1 gives +inf as the second, and columns at or beyond k
// are never candidates.
//
// Precision: f32, by 3xTF32. Each value v is split into big = tf32(v) and
// small = tf32(v - big), both rounded to nearest (cvt.rna), and each
// product is formed as small.big + big.small + big.big on the tensor
// cores. The dropped small.small term is about 2^-22 relative. c is split
// once by a pre-pass (split_c_kernel, which also takes |c|^2) into two
// (k, d) scratch matrices; a tile of x is split in shared memory once TMA
// has landed it: big overwrites it in place and small goes to a second
// buffer at the same byte offsets, an elementwise map that keeps TMA's
// 128-byte swizzle without decoding it.
//
// Accumulation: the tensor cores' f32 accumulation rounds toward zero.
// A first version summed all 3 x d/8 products of a k tile in the wgmma
// accumulator; at the kmeans_xl shape, where x.c ~ 2.6e4 cancels down to
// d1 ~ 2e3, the truncations piled up to leave d1 0.70 off (the check
// allows 0.02). So the products of each GROUP = 2 k8 steps (16 features)
// start from a fresh accumulator, small terms first and the big ones last
// (two truncating adds at the group's magnitude, ~400), and the group's
// sum is added into the k tile's sum on the CUDA cores with Kahan's
// compensation, so that the 64 adds at ~2.6e4 round no further. d1 then
// comes out within 0.01 of its once-rounded float64 value (chip_smoke.py
// phase 6 logs it; PERF.md has the numbers).
//
// Tiles: a block of two consumer warpgroups holds BM = 128 rows (64 each)
// and walks k in tiles of BN centroids; per k tile it walks d in slabs of
// BK = 32 floats, one 128-byte swizzle row, i.e. four k8 steps of three
// m64nBNk8 per warpgroup. BN is 128, or 64 where k <= 64 in EPI_FULL,
// EPI_NESTED and EPI_DOT (EPI_PARTIAL keeps 128, and with it its bits): at
// k = 50 a 128-wide tile would waste 78 of its columns, a 64-wide one 14.
// Each thread keeps BN / 2 accumulators of a group and BN / 2 f32 sums
// with their compensations. TMA fills a ring of stages (x 16 KB, its
// small half 16 KB, c big and c small BN x 128 bytes each: three stages of
// 64 KB at BN = 128, four of 48 KB at BN = 64); thread 0 issues the
// loads, an mbarrier per stage reports them. Out-of-bounds rows and
// features come in as zeros. After the last slab of a k tile the
// epilogue pushes each thread's columns into a per-row top-2 in
// increasing index order, the four threads of a quad merge by shuffles,
// and the result merges into the row's running top-2: a fixed order, no
// atomics, so two runs give the same bits.
//
// |x|^2: EPI_PARTIAL takes it from a pre-pass over x (sqnorm_kernel), as
// it always has. EPI_FULL and EPI_NESTED take it from the tiles already in
// shared memory during the first k tile, while the split touches every
// element anyway: at k <= 64 there is one k tile and x is read once, so a
// pre-pass would double the bytes read. Each thread adds the squares of
// its four float4s of a slab into the sums of their four rows (fmaf, in
// slab order), the eight threads of a row combine by xor shuffles (1, 2,
// 4), and the warpgroup passes the sums through shared memory to the
// threads that hold the rows' accumulators. A call launches two device
// kernels (split_c_kernel and the main loop), three with EPI_PARTIAL.
//
// Bound on the H100 SXM. At the kmeans_xl shape (n = 4,194,304, d = 1024,
// k = 4096; EPI_PARTIAL): operations, 3 x 2 n k d TF32 operations at 495
// TFLOP/s dense, 105.6 TFLOP, 213 ms (the full-f32 CUDA-core bound is
// 525 ms at 67 TFLOP/s). Each block reads all of c big and small once
// (about 1.1 TB of L2 traffic over the grid at that shape) and its x rows
// once per k tile (32 times, ~550 GB from HBM). Each group waits for its
// products before adding them up; the two warpgroups interleave there.
// At the infMNIST shape (n = 400,000, d = 784, k = 50; EPI_FULL and
// EPI_NESTED at BN = 64): bytes, one read of x, 1.25 GB, 0.37 ms at 3.35
// TB/s, against 3 x 2 n 64 d TF32 operations, 0.24 ms (PERF.md has the
// measured times).
//
// Not done here (later work): warp specialisation, double-buffered group
// accumulators, persistent blocks, clusters and TMA multicast of c, a
// 64-row block for small n.
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)

#include <algorithm>

#include "common.cuh"

namespace nkm {
namespace tc {

constexpr int BM = 128;      // rows per block: two consumer warpgroups
constexpr int BK = 32;       // features per stage: one 128-byte row
constexpr int THREADS = 256;
constexpr int GROUP = 2;              // k8 steps summed on the tensor cores
constexpr int X_BYTES = BM * BK * 4;  // 16 KB

enum { EPI_DOT = 0, EPI_PARTIAL = 1, EPI_FULL = 2, EPI_NESTED = 3 };

// What follows from the tile width BN (centroids per k tile). A stage: x
// (split in place to big) | x small | c big | c small; every buffer
// starts on a 1024-byte boundary, as the 128-byte swizzle needs. After the
// stages: one mbarrier a stage, then BM floats of |x|^2.
template <int BN>
struct Tile {
  static constexpr int NACC = BN / 2;  // accumulators a thread: 64 x BN / 128
  static constexpr int C_BYTES = BN * BK * 4;
  static constexpr int STAGES = BN == 64 ? 4 : 3;
  static constexpr int STAGE_BYTES = 2 * X_BYTES + 2 * C_BYTES;
  static constexpr int TX_BYTES = X_BYTES + 2 * C_BYTES;  // what TMA writes
  static constexpr int SMEM_BYTES =
      1024 + STAGES * STAGE_BYTES + 8 * STAGES + 4 * BM;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// round to the nearest TF32 value, ties away from zero
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// ------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A load that never
// lands (a fault in a tensor map) traps after about 2^34 cycles (~10 s)
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  }
}

// ----------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// --------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused for this layout. Advancing along K inside the
// 128-byte row is +32 bytes, +2 in the address field, per k8 step.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define NKM_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x BN over the warpgroup) = a (64 x 8) . b (BN x 8)^T, plus d
// itself unless `fresh`: TF32 operands from shared memory, f32
// accumulate. Thread t of the warpgroup holds rows 16 (t / 32) +
// (t % 32) / 4 (+8) and columns 8 j + 2 (t % 4) (+1) of each n8 chunk j:
// d[4j], d[4j+1] on the first row, d[4j+2], d[4j+3] on the second.
__device__ __forceinline__ void mma_tf32(float (&d)[64], uint64_t a,
                                         uint64_t b, bool fresh) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1;\n}\n"
      : NKM_D8(0), NKM_D8(8), NKM_D8(16), NKM_D8(24), NKM_D8(32), NKM_D8(40),
        NKM_D8(48), NKM_D8(56)
      : "l"(a), "l"(b), "r"(fresh ? 0 : 1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[32], uint64_t a,
                                         uint64_t b, bool fresh) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : NKM_D8(0), NKM_D8(8), NKM_D8(16), NKM_D8(24)
      : "l"(a), "l"(b), "r"(fresh ? 0 : 1));
}

#undef NKM_D8

// ------------------------------------------------------------- kernels

// c (k, d): big = tf32(c), small = tf32(c - big) elementwise, and cn =
// |c_r|^2 for each row: one warp per row, rows in a grid-stride loop
// (64-bit offsets); lane l adds the squares of features l, l + 32, ...
// (fmaf), and the lanes combine by xor shuffles 16, 8, 4, 2, 1
// (sqnorm_kernel's order).
__global__ void split_c_kernel(const float* __restrict__ c, int k, int d,
                               float* __restrict__ big,
                               float* __restrict__ small,
                               float* __restrict__ cn) {
  const int lane = threadIdx.x % 32;
  const size_t warps = (size_t)gridDim.x * blockDim.x / 32;
  for (size_t r = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32;
       r < (size_t)k; r += warps) {
    float s = 0.f;
    for (int f = lane; f < d; f += 32) {
      const size_t i = r * d + f;
      const float v = c[i];
      const float b = tf32_rna(v);
      big[i] = b;
      small[i] = tf32_rna(v - b);
      s = fmaf(v, v, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) cn[r] = s;
  }
}

// |v_r|^2 for each row of v (rows, d): one warp per row, rows in a
// grid-stride loop (64-bit offsets)
__global__ void sqnorm_kernel(const float* __restrict__ v, int rows, int d,
                              float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const size_t warps = (size_t)gridDim.x * blockDim.x / 32;
  for (size_t r = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32;
       r < (size_t)rows; r += warps) {
    float s = 0.f;
    for (int f = lane; f < d; f += 32) {
      const float x = v[r * d + f];
      s = fmaf(x, x, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[r] = s;
  }
}

// What a launch of the main loop reads besides the tiles, and writes.
struct Top2Args {
  int n, k, d;
  const float* cn;  // |c|^2 (k)
  const float* xn;  // |x|^2 (n): EPI_PARTIAL only
  Top2Out out;      // EPI_PARTIAL, EPI_FULL: a, d1, d2 (n)
  NestedArgs nest;  // EPI_NESTED
  float* dot;       // EPI_DOT: x.c (n, k)
};

// Loads of iteration it (k tile it / n_ds, feature slab it % n_ds) into
// stage it % STAGES: x's 128 rows of the block, c big and c small.
template <int BN>
__device__ __forceinline__ void issue(uint8_t* smem, uint64_t* full,
                                      const CUtensorMap* xmap,
                                      const CUtensorMap* cbmap,
                                      const CUtensorMap* csmap, int it,
                                      int n_ds) {
  using T = Tile<BN>;
  uint64_t* bar = &full[it % T::STAGES];
  uint8_t* st = smem + (it % T::STAGES) * T::STAGE_BYTES;
  const int f0 = (it % n_ds) * BK, k0 = (it / n_ds) * BN;
  mbar_expect_tx(bar, T::TX_BYTES);
  tma_load_2d(st, xmap, bar, f0, blockIdx.x * BM);
  tma_load_2d(st + 2 * X_BYTES, cbmap, bar, f0, k0);
  tma_load_2d(st + 2 * X_BYTES + T::C_BYTES, csmap, bar, f0, k0);
}

// The squared distance a column offers in EPI_FULL and EPI_NESTED: the ref
// expression, clamped before the top-2 sees it
__device__ __forceinline__ float full_dist(float xn, float dot, float cn) {
  return fmaxf(xn - 2.f * dot + cn, 0.f);
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
tc_top2_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap cbmap,
               const __grid_constant__ CUtensorMap csmap,
               const Top2Args p) {
  using T = Tile<BN>;
  constexpr int NACC = T::NACC;
  constexpr int STAGES = T::STAGES;
  // |x|^2 from the tiles of the first k tile
  constexpr bool XNORM = EPI == EPI_FULL || EPI == EPI_NESTED;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * T::STAGE_BYTES);
  float* xn_s = reinterpret_cast<float*>(full + STAGES);  // BM floats

  const int n = p.n, k = p.k, d = p.d;
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // warpgroup: rows 64 wg .. 64 wg + 63 of the block
  const int t = tid % 128;
  const int lane = t % 32;
  const int q = lane % 4;  // columns 2q, 2q + 1 of each n8 chunk
  const int frag_row = (t / 32) * 16 + lane / 4;  // in the warpgroup's 64
  const int row_a = blockIdx.x * BM + wg * 64 + frag_row;
  const int n_ds = (d + BK - 1) / BK;
  const int total = n_ds * ((k + BN - 1) / BN);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid == 0)
    for (int it = 0; it < STAGES && it < total; ++it)
      issue<BN>(smem, full, &xmap, &cbmap, &csmap, it, n_ds);

  // part: one group's products on the tensor cores; acc + comp: their
  // compensated f32 sum over the k tile, on the CUDA cores (see
  // "Accumulation" above)
  float part[NACC], acc[NACC], comp[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) part[i] = 0.f;
  Top2 run_a = top2_empty(), run_b = top2_empty();  // rows row_a, row_a + 8
  // XNORM: squares of this thread's float4s of the first k tile, by row
  // (rows t / 8 + 16 i of the warpgroup); then |x|^2 of rows row_a and
  // row_a + 8
  float xsq[4] = {0.f, 0.f, 0.f, 0.f};
  float xn_a = 0.f, xn_b = 0.f;

  for (int it = 0; it < total; ++it) {
    const int ds = it % n_ds;
    uint8_t* st = smem + (it % STAGES) * T::STAGE_BYTES;
    uint8_t* xbig = st + wg * (X_BYTES / 2);  // this warpgroup's 64 rows
    uint8_t* xsmall = xbig + X_BYTES;
    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = comp[i] = 0.f;
    }
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);

    // split this warpgroup's 64 x 32 floats, 16 a thread: float4 number
    // t + 128 i lies in row t / 8 + 16 i (eight to a 128-byte row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* pb = reinterpret_cast<float4*>(xbig) + t + i * 128;
      float4* ps = reinterpret_cast<float4*>(xsmall) + t + i * 128;
      const float4 v = *pb;
      if constexpr (XNORM) {
        if (it < n_ds) {
          xsq[i] = fmaf(v.x, v.x, xsq[i]);
          xsq[i] = fmaf(v.y, v.y, xsq[i]);
          xsq[i] = fmaf(v.z, v.z, xsq[i]);
          xsq[i] = fmaf(v.w, v.w, xsq[i]);
        }
      }
      const float4 b = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                                   tf32_rna(v.w));
      *pb = b;
      *ps = make_float4(tf32_rna(v.x - b.x), tf32_rna(v.y - b.y),
                        tf32_rna(v.z - b.z), tf32_rna(v.w - b.w));
    }
    // the generic-proxy writes, before wgmma reads them through the async
    // proxy; a barrier of the warpgroup's 128 threads (ids 1 and 2)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");

    const uint64_t a_big = sw128_desc(xbig), a_small = sw128_desc(xsmall);
    const uint64_t b_big = sw128_desc(st + 2 * X_BYTES);
    const uint64_t b_small = sw128_desc(st + 2 * X_BYTES + T::C_BYTES);
#pragma unroll
    for (int g = 0; g < BK / (8 * GROUP); ++g) {
      acc_fence(part);
      wgmma_fence();
      // the small terms first, into a fresh accumulator, then the big
      // ones: GROUP adds at the group's magnitude (32 bytes per k8 step,
      // 2 in the descriptor's 16-byte units)
#pragma unroll
      for (int kk = 0; kk < GROUP; ++kk) {
        const uint64_t o = 2 * (GROUP * g + kk);
        mma_tf32(part, a_small + o, b_big + o, kk == 0);
        mma_tf32(part, a_big + o, b_small + o, false);
      }
#pragma unroll
      for (int kk = 0; kk < GROUP; ++kk) {
        const uint64_t o = 2 * (GROUP * g + kk);
        mma_tf32(part, a_big + o, b_big + o, false);
      }
      wgmma_commit();
      wgmma_wait_all();
      acc_fence(part);
#pragma unroll
      for (int i = 0; i < NACC; ++i) {  // Kahan: acc + comp = the sum
        const float y = part[i] - comp[i];
        const float s = acc[i] + y;
        comp[i] = (s - acc[i]) - y;
        acc[i] = s;
      }
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && it + STAGES < total)
      issue<BN>(smem, full, &xmap, &cbmap, &csmap, it + STAGES, n_ds);

    if (ds != n_ds - 1) continue;
    const int k0 = (it / n_ds) * BN;  // the k tile is complete
    if constexpr (XNORM) {
      if (k0 == 0) {  // |x|^2 is complete: the eight threads of each row
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            xsq[i] += __shfl_xor_sync(0xffffffffu, xsq[i], off);
        if (t % 8 == 0)
#pragma unroll
          for (int i = 0; i < 4; ++i) xn_s[wg * 64 + t / 8 + 16 * i] = xsq[i];
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
        xn_a = xn_s[wg * 64 + frag_row];
        xn_b = xn_s[wg * 64 + frag_row + 8];
      }
    }
    if constexpr (EPI == EPI_DOT) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * q + e;
          if (col >= k) continue;
          if (row_a < n) p.dot[(size_t)row_a * k + col] = acc[4 * j + e];
          if (row_a + 8 < n)
            p.dot[(size_t)(row_a + 8) * k + col] = acc[4 * j + 2 + e];
        }
    } else {
      Top2 ta = top2_empty(), tb = top2_empty();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * q + e;
          if (col < k) {  // index beyond k: never a candidate
            const float c2 = __ldg(p.cn + col);
            if constexpr (EPI == EPI_PARTIAL) {
              top2_push(ta, c2 - 2.f * acc[4 * j + e], col);
              top2_push(tb, c2 - 2.f * acc[4 * j + 2 + e], col);
            } else {
              top2_push(ta, full_dist(xn_a, acc[4 * j + e], c2), col);
              top2_push(tb, full_dist(xn_b, acc[4 * j + 2 + e], c2), col);
            }
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the quad: one row's columns
        Top2 oa, ob;
        oa.m1 = __shfl_xor_sync(0xffffffffu, ta.m1, off);
        oa.i1 = __shfl_xor_sync(0xffffffffu, ta.i1, off);
        oa.m2 = __shfl_xor_sync(0xffffffffu, ta.m2, off);
        ob.m1 = __shfl_xor_sync(0xffffffffu, tb.m1, off);
        ob.i1 = __shfl_xor_sync(0xffffffffu, tb.i1, off);
        ob.m2 = __shfl_xor_sync(0xffffffffu, tb.m2, off);
        ta = top2_merge(ta, oa);
        tb = top2_merge(tb, ob);
      }
      run_a = top2_merge(run_a, ta);
      run_b = top2_merge(run_b, tb);
    }
  }

  if constexpr (EPI != EPI_DOT) {
    if (q != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_a + 8 * h;
      const Top2& w = h ? run_b : run_a;
      if (r >= n) continue;
      if constexpr (EPI == EPI_PARTIAL) {
        const float x2 = p.xn[r];  // squared distances; +inf stays +inf
        p.out.a[r] = w.i1;
        p.out.d1[r] = fmaxf(w.m1 + x2, 0.f);
        p.out.d2[r] = fmaxf(w.m2 + x2, 0.f);
      } else if constexpr (EPI == EPI_FULL) {
        p.out.a[r] = w.i1;
        p.out.d1[r] = w.m1;
        p.out.d2[r] = w.m2;
      } else {  // EPI_NESTED: the caller's keep-select, euclidean
        const NestedArgs& s = p.nest;
        int an;
        float dn, lbn;
        if (!s.valid[r]) {
          an = -1;
          dn = 0.f;
          lbn = 0.f;
        } else if (s.settled[r]) {
          an = s.a_prev[r];
          dn = s.d_keep[r];
          lbn = s.lb_keep[r];
        } else {
          an = w.i1;
          dn = sqrtf(w.m1);
          lbn = sqrtf(w.m2);
        }
        s.a_new[r] = an;
        s.d_new[r] = dn;
        s.lb_new[r] = lbn;
      }
    }
  }
}

// ----------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// link against libcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major f32 (rows, cols) matrix as (box_rows, BK) tiles with the
// 128-byte swizzle; out of bounds reads as 0. cols * 4 must be a multiple
// of 16 and p 16-byte aligned.
inline bool make_map(CUtensorMap* m, const float* p, int rows, int cols,
                     int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int grid_for(size_t work) {
  return static_cast<int>(std::min<size_t>((work + 255) / 256, 132 * 32));
}

template <int BN, int EPI>
int launch_main(const CUtensorMap& xmap, const CUtensorMap& cbmap,
                const CUtensorMap& csmap, const Top2Args& p, cudaStream_t s) {
  cudaFuncSetAttribute(tc_top2_kernel<BN, EPI>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Tile<BN>::SMEM_BYTES);
  tc_top2_kernel<BN, EPI>
      <<<(p.n + BM - 1) / BM, THREADS, Tile<BN>::SMEM_BYTES, s>>>(
          xmap, cbmap, csmap, p);
  return static_cast<int>(cudaGetLastError());
}

// x (n, d) and c (k, d) f32, d % 4 == 0, both 16-byte aligned. Scratch:
// c_big, c_small (k, d), cn (k), xn (n; EPI_PARTIAL only). p gives n, k,
// d and the outputs of the epilogue EPI. Launches split_c_kernel (and
// sqnorm_kernel over x with EPI_PARTIAL), then the main loop at BN = 64
// where k <= 64 (but with EPI_PARTIAL), else 128.
template <int EPI>
int launch_top2(const float* x, const float* c, float* c_big, float* c_small,
                float* cn, float* xn, Top2Args p, cudaStream_t s) {
  if (p.n <= 0 || p.k <= 0) return static_cast<int>(cudaSuccess);
  // cuTensorMapEncodeTiled (not a runtime call) needs the device's
  // primary context current on this thread, and the runtime makes it so
  // only at its first call on a thread. A thread whose first CUDA work is
  // this launch (its tensors already on the card) has none, so set the
  // current device, which makes the primary context current.
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool narrow = EPI != EPI_PARTIAL && p.k <= 64;
  const int bn = narrow ? 64 : 128;
  CUtensorMap xmap, cbmap, csmap;
  if (!make_map(&xmap, x, p.n, p.d, BM) ||
      !make_map(&cbmap, c_big, p.k, p.d, bn) ||
      !make_map(&csmap, c_small, p.k, p.d, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  split_c_kernel<<<grid_for((size_t)p.k * 32), 256, 0, s>>>(
      c, p.k, p.d, c_big, c_small, cn);
  p.cn = cn;
  if constexpr (EPI == EPI_PARTIAL) {
    sqnorm_kernel<<<grid_for((size_t)p.n * 32), 256, 0, s>>>(x, p.n, p.d, xn);
    p.xn = xn;
  } else {
    if (narrow) return launch_main<64, EPI>(xmap, cbmap, csmap, p, s);
  }
  return launch_main<128, EPI>(xmap, cbmap, csmap, p, s);
}

}  // namespace tc
}  // namespace nkm
