// Nearest and second-nearest centroid of every row: a (n) int32, d1 and
// d2 (n) f32 squared distances max(|x|^2 - 2 x.c + |c|^2, 0).
//
// Replaces repro/kernels/kmeans_assign.py::assign_top2_pallas (body
// _assign_kernel). On the TPU that kernel runs the x.c block on the MXU
// with the k dimension as a sequential grid axis carrying the running
// top-2 in its output blocks. Here one block owns rows and loops over k
// itself, keeping the running (min, 2nd-min, argmin) in registers, so
// nothing but the three output vectors is written.
//
// f32: the tensor-core top-2 of tc_top2.cuh with its EPI_FULL epilogue
// (TMA, 3xTF32 wgmma with compensated sums, |x|^2 from the tiles in
// shared memory, the ref expression clamped per column before the top-2;
// BN = 64 where k <= 64). Bound on the H100 at the main-path shape
// (n=400,000, d=784, k=50): bytes, one read of x (1.25 GB, 0.37 ms at
// 3.35 TB/s), against 3 x 2 x n x 64 x d TF32 operations (0.24 ms at 495
// TFLOP/s).
//
// bf16: the CUDA-core kernel below. Blocks of BM = 64 rows; each block
// walks k in tiles of BN = 64 centroids and keeps a running (min,
// 2nd-min, argmin) per row in registers. The x.c products are f32 FMAs of
// the bf16 values, staged through shared memory in BK-wide feature
// slices, 4x4 outputs per thread; the candidate is the ref expression.
// Bound: its 2 n k d f32 operations (0.47 ms at that shape at 67
// TFLOP/s). bf16 wgmma is later work.
#include <cuda_bf16.h>

#include "tc_top2.cuh"

namespace {

using namespace nkm;  // Top2, Top2Out and the top-2 merges of common.cuh

// ----------------------------------------------------- bf16, CUDA cores

constexpr int BM = 64;  // rows per block
constexpr int BN = 64;  // centroids per k tile
constexpr int BK = 16;  // features per shared-memory slice
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // centroids per thread
constexpr int LANES = BN / TN;                  // 16 threads share rows
constexpr int ASSIGN_THREADS = (BM / TM) * LANES;  // 256

// |c_j|^2 for each row of c: one warp per row.
__global__ void row_sqnorm_kernel(const __nv_bfloat16* __restrict__ c, int k,
                                  int d, float* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= k) return;  // the whole warp leaves together
  float s = 0.f;
  for (int f = lane; f < d; f += 32) {
    const float v = __bfloat162float(c[(size_t)row * d + f]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

__global__ void __launch_bounds__(ASSIGN_THREADS)
assign_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ c,
              const float* __restrict__ cn, int n, int k, int d,
              Top2Out out) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  __shared__ float cns[BN];

  const int tid = threadIdx.x;
  const int tx = tid % LANES;  // centroid group: lanes tx share rows
  const int ty = tid / LANES;  // row group
  const int row0 = blockIdx.x * BM;

  Top2 run[TM];
  float xn[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    run[i] = top2_empty();
    xn[i] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += BN) {
    const bool first = (k0 == 0);
    if (tid < BN) cns[tid] = (k0 + tid < k) ? cn[k0 + tid] : INFINITY;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += BK) {
#pragma unroll
      for (int l = 0; l < (BM * BK) / ASSIGN_THREADS; ++l) {
        const int idx = tid + l * ASSIGN_THREADS;
        const int m = idx / BK, kk = idx % BK;
        const int r = row0 + m, f = d0 + kk;
        As[kk][m] = (r < n && f < d) ? __bfloat162float(x[(size_t)r * d + f]) : 0.f;
      }
#pragma unroll
      for (int l = 0; l < (BN * BK) / ASSIGN_THREADS; ++l) {
        const int idx = tid + l * ASSIGN_THREADS;
        const int j = idx / BK, kk = idx % BK;
        const int ci = k0 + j, f = d0 + kk;
        Bs[kk][j] = (ci < k && f < d) ? __bfloat162float(c[(size_t)ci * d + f]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (first) {
        // |x|^2 on the first k tile only: lane tx takes feature tx of
        // each slice, summed across the 16 lanes below (BK == LANES)
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float v = As[tx][ty * TM + i];
          xn[i] = fmaf(v, v, xn[i]);
        }
      }
      __syncthreads();
    }
    if (first) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          xn[i] += __shfl_xor_sync(0xffffffffu, xn[i], off, LANES);
    }
    __syncthreads();  // cns is written (also when d == 0)

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      Top2 t = top2_empty();
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = k0 + tx * TN + j;
        if (col < k) {  // index beyond k: never a candidate
          const float v =
              fmaxf(xn[i] - 2.f * acc[i][j] + cns[tx * TN + j], 0.f);
          top2_push(t, v, col);
        }
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        Top2 o;
        o.m1 = __shfl_xor_sync(0xffffffffu, t.m1, off, LANES);
        o.i1 = __shfl_xor_sync(0xffffffffu, t.i1, off, LANES);
        o.m2 = __shfl_xor_sync(0xffffffffu, t.m2, off, LANES);
        t = top2_merge(t, o);
      }
      run[i] = top2_merge(run[i], t);
    }
    __syncthreads();  // cns is read before the next tile overwrites it
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (tx != i || r >= n) continue;
    out.a[r] = run[i].i1;
    out.d1[r] = run[i].m1;
    out.d2[r] = run[i].m2;
  }
}

void launch_assign(const __nv_bfloat16* x, const __nv_bfloat16* c,
                   float* cn, int n, int k, int d, Top2Out out,
                   cudaStream_t s) {
  if (k <= 0 || n <= 0) return;
  row_sqnorm_kernel<<<(k * 32 + 255) / 256, 256, 0, s>>>(c, k, d, cn);
  assign_kernel<<<(n + BM - 1) / BM, ASSIGN_THREADS, 0, s>>>(x, c, cn, n, k,
                                                             d, out);
}

}  // namespace

// xp (n, dp), cp (k, dp): x and c, or copies zero-padded to a row of dp
// floats, dp % 4 == 0, 16-byte aligned. Scratch: c_big, c_small (k * dp
// floats), cn (k).
extern "C" int assign_top2_f32(const void* xp, const void* cp, void* c_big,
                               void* c_small, void* cn, void* a, void* d1,
                               void* d2, int n, int k, int dp, void* stream) {
  nkm::tc::Top2Args p{};
  p.n = n;
  p.k = k;
  p.d = dp;
  p.out = nkm::Top2Out{static_cast<int*>(a), static_cast<float*>(d1),
                       static_cast<float*>(d2)};
  return nkm::tc::launch_top2<nkm::tc::EPI_FULL>(
      static_cast<const float*>(xp), static_cast<const float*>(cp),
      static_cast<float*>(c_big), static_cast<float*>(c_small),
      static_cast<float*>(cn), nullptr, p, static_cast<cudaStream_t>(stream));
}

// cn: scratch of k floats for |c|^2.
extern "C" int assign_top2_bf16(const void* x, const void* c, void* cn,
                                void* a, void* d1, void* d2, int n, int k,
                                int d, void* stream) {
  nkm::Top2Out out{static_cast<int*>(a), static_cast<float*>(d1),
                   static_cast<float*>(d2)};
  launch_assign(static_cast<const __nv_bfloat16*>(x),
                static_cast<const __nv_bfloat16*>(c), static_cast<float*>(cn),
                n, k, d, out, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
