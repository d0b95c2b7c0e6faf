// The one-shot round's top-2 on Hopper's tensor cores (sm_90a): TMA loads
// into a ring of shared-memory stages, 3xTF32 products by wgmma, and the
// running top-2 in registers.
//
// Replaces the top-2 half of repro/kernels/fused_round.py::fused_round_pallas
// (body _round_kernel, which takes it on the MXU). It computes the same
// function: for each row the nearest and second-nearest centroid on the
// partial distance |c|^2 - 2 x.c (the lower index wins a tie, a duplicate
// of the minimum counts as the second, k == 1 gives +inf), then |x|^2 is
// added to both winners and the sums are clamped at 0.
//
// Precision: f32, by 3xTF32. Each value v is split into big = tf32(v) and
// small = tf32(v - big), both rounded to nearest (cvt.rna), and each
// product is formed as small.big + big.small + big.big on the tensor
// cores. The dropped small.small term is about 2^-22 relative. c is split
// once by a pre-pass into two (k, d) scratch matrices; a tile of x is
// split in shared memory once TMA has landed it: big overwrites it in
// place and small goes to a second buffer at the same byte offsets, an
// elementwise map that keeps TMA's 128-byte swizzle without decoding it.
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
// and walks k in tiles of BN = 128 centroids; per k tile it walks d in
// slabs of BK = 32 floats, one 128-byte swizzle row, i.e. four k8 steps of
// three m64n128k8 per warpgroup. Each thread keeps 64 accumulators of a
// group and 64 f32 sums with their 64 compensations. TMA fills a ring of
// three stages (x 16 KB, its small half 16 KB, c big and c small 16 KB
// each); thread 0 issues the loads, an mbarrier per stage reports them.
// Out-of-bounds rows and features come in as zeros, and columns at or
// beyond k are never candidates. After the last slab of a k tile the
// epilogue pushes each thread's columns into a per-row top-2 in
// increasing index order, the four threads of a quad merge by shuffles,
// and the result merges into the row's running top-2: a fixed order, no
// atomics, so two runs give the same bits.
//
// Bound on the H100 SXM: operations. 3 x 2 n k d TF32 operations at 495
// TFLOP/s dense; at the kmeans_xl shape (n = 4,194,304, d = 1024,
// k = 4096) that is 105.6 TFLOP, 213 ms (the full-f32 CUDA-core bound of
// the kernel this replaces is 525 ms at 67 TFLOP/s). The SIMT kernel it
// replaces took 1304.6 ms there: 64 x 64 tiles, per-element loads, no
// tensor cores and nothing in flight during the FMAs. Here the products
// run on the tensor cores and the loads of the next two stages fly while
// the current one is multiplied. Each block reads all of c big and small
// once (about 1.1 TB of L2 traffic over the grid at that shape), which is
// of the order of the compute bound, and its x rows once per k tile (32
// times, ~550 GB from HBM). Each group waits for its products before
// adding them up; the two warpgroups interleave there. It took 566.9 ms
// there, 37.6 % of its bound (PERF.md).
//
// Not done here (later work): warp specialisation, double-buffered group
// accumulators, persistent blocks, clusters and TMA multicast of c.
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)

#include <algorithm>

#include "common.cuh"

namespace nkm {
namespace tc {

constexpr int BM = 128;      // rows per block: two consumer warpgroups
constexpr int BN = 128;      // centroids per k tile
constexpr int BK = 32;       // features per stage: one 128-byte row
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int NACC = BN / 2;          // accumulators a thread: 64 x BN / 128
constexpr int GROUP = 2;              // k8 steps summed on the tensor cores
constexpr int X_BYTES = BM * BK * 4;  // 16 KB
constexpr int C_BYTES = BN * BK * 4;  // 16 KB
// a stage: x (split in place to big) | x small | c big | c small; every
// buffer starts on a 1024-byte boundary, as the 128-byte swizzle needs
constexpr int STAGE_BYTES = 2 * X_BYTES + 2 * C_BYTES;  // 64 KB
constexpr int TX_BYTES = X_BYTES + 2 * C_BYTES;         // what TMA writes
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 8 * STAGES;

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
__device__ __forceinline__ void acc_fence(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define NKM_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 over the warpgroup) = a (64 x 8) . b (128 x 8)^T, plus d
// itself unless `fresh`: TF32 operands from shared memory, f32
// accumulate. Thread t of the warpgroup holds rows 16 (t / 32) +
// (t % 32) / 4 (+8) and columns 8 j + 2 (t % 4) (+1) of each n8 chunk j:
// d[4j], d[4j+1] on the first row, d[4j+2], d[4j+3] on the second.
__device__ __forceinline__ void mma_m64n128k8(float (&d)[NACC], uint64_t a,
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

#undef NKM_D8

// ------------------------------------------------------------- kernels

// big = tf32(v), small = tf32(v - big), elementwise
__global__ void split_tf32_kernel(const float* __restrict__ v, size_t count,
                                  float* __restrict__ big,
                                  float* __restrict__ small) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    const float x = v[i];
    const float b = tf32_rna(x);
    big[i] = b;
    small[i] = tf32_rna(x - b);
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

// Loads of iteration it (k tile it / n_ds, feature slab it % n_ds) into
// stage it % STAGES: x's 128 rows of the block, c big and c small.
__device__ __forceinline__ void issue(uint8_t* smem, uint64_t* full,
                                      const CUtensorMap* xmap,
                                      const CUtensorMap* cbmap,
                                      const CUtensorMap* csmap, int it,
                                      int n_ds) {
  uint64_t* bar = &full[it % STAGES];
  uint8_t* st = smem + (it % STAGES) * STAGE_BYTES;
  const int f0 = (it % n_ds) * BK, k0 = (it / n_ds) * BN;
  mbar_expect_tx(bar, TX_BYTES);
  tma_load_2d(st, xmap, bar, f0, blockIdx.x * BM);
  tma_load_2d(st + 2 * X_BYTES, cbmap, bar, f0, k0);
  tma_load_2d(st + 2 * X_BYTES + C_BYTES, csmap, bar, f0, k0);
}

// DOT: write the products x.c (n, k) to dot instead of the top-2 (a check
// of the main loop's operand and fragment layout).
template <bool DOT>
__global__ void __launch_bounds__(THREADS, 1)
tc_top2_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap cbmap,
               const __grid_constant__ CUtensorMap csmap,
               const float* __restrict__ cn, const float* __restrict__ xn,
               int n, int k, int d, Top2Out out, float* __restrict__ dot) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // warpgroup: rows 64 wg .. 64 wg + 63 of the block
  const int t = tid % 128;
  const int lane = t % 32;
  const int q = lane % 4;  // columns 2q, 2q + 1 of each n8 chunk
  const int row_a = blockIdx.x * BM + wg * 64 + (t / 32) * 16 + lane / 4;
  const int n_ds = (d + BK - 1) / BK;
  const int total = n_ds * ((k + BN - 1) / BN);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid == 0)
    for (int it = 0; it < STAGES && it < total; ++it)
      issue(smem, full, &xmap, &cbmap, &csmap, it, n_ds);

  // part: one group's products on the tensor cores; acc + comp: their
  // compensated f32 sum over the k tile, on the CUDA cores (see
  // "Accumulation" above)
  float part[NACC], acc[NACC], comp[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) part[i] = 0.f;
  Top2 run_a = top2_empty(), run_b = top2_empty();  // rows row_a, row_a + 8

  for (int it = 0; it < total; ++it) {
    const int ds = it % n_ds;
    uint8_t* st = smem + (it % STAGES) * STAGE_BYTES;
    uint8_t* xbig = st + wg * (X_BYTES / 2);  // this warpgroup's 64 rows
    uint8_t* xsmall = xbig + X_BYTES;
    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = comp[i] = 0.f;
    }
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);

    // split this warpgroup's 64 x 32 floats, 16 a thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* pb = reinterpret_cast<float4*>(xbig) + t + i * 128;
      float4* ps = reinterpret_cast<float4*>(xsmall) + t + i * 128;
      const float4 v = *pb;
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
    const uint64_t b_small = sw128_desc(st + 2 * X_BYTES + C_BYTES);
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
        mma_m64n128k8(part, a_small + o, b_big + o, kk == 0);
        mma_m64n128k8(part, a_big + o, b_small + o, false);
      }
#pragma unroll
      for (int kk = 0; kk < GROUP; ++kk) {
        const uint64_t o = 2 * (GROUP * g + kk);
        mma_m64n128k8(part, a_big + o, b_big + o, false);
      }
      wgmma_commit();
      wgmma_wait_all();
      acc_fence(part);
#pragma unroll
      for (int i = 0; i < NACC; ++i) {  // Kahan: acc + comp = the sum
        const float y = part[i] - comp[i];
        const float t = acc[i] + y;
        comp[i] = (t - acc[i]) - y;
        acc[i] = t;
      }
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && it + STAGES < total)
      issue(smem, full, &xmap, &cbmap, &csmap, it + STAGES, n_ds);

    if (ds != n_ds - 1) continue;
    const int k0 = (it / n_ds) * BN;  // the k tile is complete
    if constexpr (DOT) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * q + e;
          if (col >= k) continue;
          if (row_a < n) dot[(size_t)row_a * k + col] = acc[4 * j + e];
          if (row_a + 8 < n)
            dot[(size_t)(row_a + 8) * k + col] = acc[4 * j + 2 + e];
        }
    } else {
      Top2 ta = top2_empty(), tb = top2_empty();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * q + e;
          if (col < k) {  // index beyond k: never a candidate
            const float c2 = __ldg(cn + col);
            top2_push(ta, c2 - 2.f * acc[4 * j + e], col);
            top2_push(tb, c2 - 2.f * acc[4 * j + 2 + e], col);
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

  if constexpr (!DOT) {
    if (q != 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_a + 8 * h;
      const Top2& w = h ? run_b : run_a;
      if (r >= n) continue;
      const float x2 = xn[r];  // squared distances; +inf stays +inf (k == 1)
      out.a[r] = w.i1;
      out.d1[r] = fmaxf(w.m1 + x2, 0.f);
      out.d2[r] = fmaxf(w.m2 + x2, 0.f);
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

// x (n, d) and c (k, d) f32, d % 4 == 0, both 16-byte aligned. Scratch:
// c_big, c_small (k, d), cn (k), xn (n; unused with DOT). Without DOT it
// writes out.a, d1, d2 (n); with DOT, dot (n, k).
template <bool DOT>
int launch_top2(const float* x, const float* c, float* c_big, float* c_small,
                float* cn, float* xn, int n, int k, int d, Top2Out out,
                float* dot, cudaStream_t s) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  CUtensorMap xmap, cbmap, csmap;
  if (!make_map(&xmap, x, n, d, BM) || !make_map(&cbmap, c_big, k, d, BN) ||
      !make_map(&csmap, c_small, k, d, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  split_tf32_kernel<<<grid_for((size_t)k * d), 256, 0, s>>>(c, (size_t)k * d,
                                                            c_big, c_small);
  sqnorm_kernel<<<grid_for((size_t)k * 32), 256, 0, s>>>(c, k, d, cn);
  if (!DOT) sqnorm_kernel<<<grid_for((size_t)n * 32), 256, 0, s>>>(x, n, d, xn);
  cudaFuncSetAttribute(tc_top2_kernel<DOT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  tc_top2_kernel<DOT><<<(n + BM - 1) / BM, THREADS, SMEM_BYTES, s>>>(
      xmap, cbmap, csmap, cn, xn, n, k, d, out, dot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace nkm
