// Device code shared by the four k-means kernels (sm_90a).
//
//  * assign_kernel<T, NESTED>: blocks of BM rows; each block walks k in
//    tiles of BN centroids and keeps a running (min, 2nd-min, argmin) per
//    row in registers. The x.c products are full f32 FMAs on the CUDA
//    cores (no TF32: the reference is f32), staged through shared memory
//    in BK-wide feature slices, 4x4 outputs per thread. The candidate is
//    the ref expression max(|x|^2 - 2 x.c + |c|^2, 0). NESTED adds the
//    nested round's keep-select and sqrt in the epilogue. (The one-shot
//    round's top-2 is the tensor-core kernel of tc_top2.cuh.)
//  * scatter_partials<MODE> + reduce_chunks: a deterministic weighted
//    per-cluster sum. Pass 1 splits the rows into chunks whose size is
//    fixed by the row count (never by the device); each block owns one
//    (chunk, feature tile, cluster tile), each thread one feature column,
//    and a thread adds its column of the chunk's rows into shared memory
//    in row order. Pass 2 sums the chunk partials in chunk order. No float
//    atomics anywhere, so two runs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace nkm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------- top-2

struct Top2 {
  float m1;  // smallest squared distance
  int i1;    // its index (the lower index on a tie)
  float m2;  // smallest over every other index (a duplicate of m1 counts)
};

__device__ __forceinline__ Top2 top2_empty() { return {INFINITY, INT_MAX, INFINITY}; }

// Columns pushed in increasing index order: strict < keeps the lower index
// on a tie, and the tied value falls through to the 2nd-min.
__device__ __forceinline__ void top2_push(Top2& t, float v, int i) {
  if (v < t.m1) {
    t.m2 = t.m1;
    t.m1 = v;
    t.i1 = i;
  } else if (v < t.m2) {
    t.m2 = v;
  }
}

// Symmetric merge of two partial results over disjoint index sets.
__device__ __forceinline__ Top2 top2_merge(Top2 a, Top2 b) {
  const bool bw = (b.m1 < a.m1) || (b.m1 == a.m1 && b.i1 < a.i1);
  Top2 r;
  r.m1 = bw ? b.m1 : a.m1;
  r.i1 = bw ? b.i1 : a.i1;
  r.m2 = fminf(fmaxf(a.m1, b.m1), fminf(a.m2, b.m2));
  return r;
}

// ------------------------------------------------------------ assignment

constexpr int BM = 64;  // rows per block
constexpr int BN = 64;  // centroids per k tile
constexpr int BK = 16;  // features per shared-memory slice
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // centroids per thread
constexpr int LANES = BN / TN;                  // 16 threads share rows
constexpr int ASSIGN_THREADS = (BM / TM) * LANES;  // 256

struct Top2Out {
  int* a;
  float* d1;
  float* d2;
};

struct NestedArgs {
  const int* a_prev;
  const uint8_t* settled;
  const float* d_keep;
  const float* lb_keep;
  const uint8_t* valid;
  int* a_new;
  float* d_new;
  float* lb_new;
};

// |c_j|^2 for each row of c: one warp per row.
template <typename T>
__global__ void row_sqnorm_kernel(const T* __restrict__ c, int k, int d,
                                  float* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= k) return;  // the whole warp leaves together
  float s = 0.f;
  for (int f = lane; f < d; f += 32) {
    const float v = to_f32(c[(size_t)row * d + f]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

template <typename T, bool NESTED>
__global__ void __launch_bounds__(ASSIGN_THREADS)
assign_kernel(const T* __restrict__ x, const T* __restrict__ c,
              const float* __restrict__ cn, int n, int k, int d, Top2Out out,
              NestedArgs nest) {
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
        As[kk][m] = (r < n && f < d) ? to_f32(x[(size_t)r * d + f]) : 0.f;
      }
#pragma unroll
      for (int l = 0; l < (BN * BK) / ASSIGN_THREADS; ++l) {
        const int idx = tid + l * ASSIGN_THREADS;
        const int j = idx / BK, kk = idx % BK;
        const int ci = k0 + j, f = d0 + kk;
        Bs[kk][j] = (ci < k && f < d) ? to_f32(c[(size_t)ci * d + f]) : 0.f;
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
    if constexpr (NESTED) {
      int an;
      float dn, lbn;
      if (!nest.valid[r]) {
        an = -1;
        dn = 0.f;
        lbn = 0.f;
      } else if (nest.settled[r]) {
        an = nest.a_prev[r];
        dn = nest.d_keep[r];
        lbn = nest.lb_keep[r];
      } else {
        an = run[i].i1;
        dn = sqrtf(run[i].m1);
        lbn = sqrtf(run[i].m2);
      }
      nest.a_new[r] = an;
      nest.d_new[r] = dn;
      nest.lb_new[r] = lbn;
    } else {
      out.a[r] = run[i].i1;
      out.d1[r] = run[i].m1;
      out.d2[r] = run[i].m2;
    }
  }
}

template <typename T, bool NESTED>
void launch_assign(const T* x, const T* c, float* cn, int n, int k, int d,
                   Top2Out out, NestedArgs nest, cudaStream_t s) {
  if (k <= 0 || n <= 0) return;
  row_sqnorm_kernel<T><<<(k * 32 + 255) / 256, 256, 0, s>>>(c, k, d, cn);
  assign_kernel<T, NESTED><<<(n + BM - 1) / BM, ASSIGN_THREADS, 0, s>>>(
      x, c, cn, n, k, d, out, nest);
}

// ------------------------------------------------ deterministic scatter

constexpr int SD = 128;  // feature columns per block (one per thread)
constexpr int SK = 64;   // clusters per block
constexpr int SU = 4;    // rows whose loads are in flight together

enum ScatterMode { SCATTER_SUM = 0, SCATTER_NESTED = 1, SCATTER_ROUND = 2 };

struct ScatterArgs {
  const float* x;
  int n, k, d;
  // SCATTER_SUM: row r adds w[r] * x[r] to cluster a[r]
  const int* a;
  const float* w;
  // SCATTER_NESTED: +x at a_new for joins and new rows, -x at a_prev for
  // leaves, and d_new^2 to sse at a_new for every row
  const int* a_prev;
  const int* a_new;
  const float* d_new;
  // SCATTER_ROUND: row r adds x[r] and 1 to cluster a[r], and d1sq[r] (a
  // squared distance, added as it is) to sse
  const float* d1sq;
  float* partial;  // (n_chunks, stride): [S (k*d) | v (k) | sse (k)]
  int chunk_rows;
  int stride;
};

template <int MODE>
__global__ void __launch_bounds__(SD) scatter_partials(ScatterArgs p) {
  __shared__ float Sp[SK][SD];
  __shared__ float vp[SK];
  __shared__ float ssep[SK];
  __shared__ int lab1[SD], lab2[SD], labs[SD];  // -1: nothing in this tile
  __shared__ float w1[SD], w2[SD], sq[SD];

  const int tid = threadIdx.x;
  const int col = blockIdx.y * SD + tid;
  const int k0 = blockIdx.z * SK;
  const bool lead = (blockIdx.y == 0 && tid == 0);  // sums v and sse
  const bool has_col = col < p.d;

#pragma unroll 8
  for (int kk = 0; kk < SK; ++kk) Sp[kk][tid] = 0.f;
  if (tid < SK) {
    vp[tid] = 0.f;
    ssep[tid] = 0.f;
  }

  const int r0 = blockIdx.x * p.chunk_rows;
  const int r1 = min(p.n, r0 + p.chunk_rows);
  for (int base = r0; base < r1; base += SD) {
    __syncthreads();  // zeroing done / previous batch consumed
    const int r = base + tid;
    if (r < r1) {
      int la, lb = -1, ls = -1;
      float wa, wb = 0.f;
      if constexpr (MODE == SCATTER_SUM) {
        la = p.a[r] - k0;
        wa = p.w[r];
      } else if constexpr (MODE == SCATTER_ROUND) {
        la = p.a[r] - k0;
        wa = 1.f;
        ls = la;
        sq[tid] = p.d1sq[r];
      } else {
        const int ap = p.a_prev[r], an = p.a_new[r];
        const bool seen = ap >= 0;
        const bool changed = seen && an != ap;
        wa = ((changed || !seen) && an >= 0) ? 1.f : 0.f;
        wb = changed ? -1.f : 0.f;
        la = min(max(an, 0), p.k - 1) - k0;
        lb = min(max(ap, 0), p.k - 1) - k0;
        ls = la;
        const float dn = p.d_new[r];
        sq[tid] = dn * dn;
      }
      const bool ina = wa != 0.f && la >= 0 && la < SK && la + k0 < p.k;
      const bool inb = wb != 0.f && lb >= 0 && lb < SK && lb + k0 < p.k;
      lab1[tid] = ina ? la : -1;
      lab2[tid] = inb ? lb : -1;
      labs[tid] = (ls >= 0 && ls < SK) ? ls : -1;
      w1[tid] = wa;
      w2[tid] = wb;
    }
    __syncthreads();
    const int m = min(SD, r1 - base);
    for (int j0 = 0; j0 < m; j0 += SU) {
      float xv[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int j = j0 + u;
        xv[u] = 0.f;
        if (j < m && has_col && (lab1[j] >= 0 || lab2[j] >= 0))
          xv[u] = __ldg(p.x + (size_t)(base + j) * p.d + col);
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int j = j0 + u;
        if (j >= m) break;
        const int la = lab1[j], lb = lab2[j];
        if (la >= 0) Sp[la][tid] += w1[j] * xv[u];
        if (lb >= 0) Sp[lb][tid] += w2[j] * xv[u];
        if (lead) {
          if (la >= 0) vp[la] += w1[j];
          if (lb >= 0) vp[lb] += w2[j];
          if (MODE != SCATTER_SUM && labs[j] >= 0) ssep[labs[j]] += sq[j];
        }
      }
    }
  }
  __syncthreads();

  float* slab = p.partial + (size_t)blockIdx.x * p.stride;
  if (has_col) {
    for (int kk = 0; kk < SK && k0 + kk < p.k; ++kk)
      slab[(size_t)(k0 + kk) * p.d + col] = Sp[kk][tid];
  }
  if (blockIdx.y == 0 && tid < SK && k0 + tid < p.k) {
    const size_t kd = (size_t)p.k * p.d;
    slab[kd + k0 + tid] = vp[tid];
    if (MODE != SCATTER_SUM) slab[kd + p.k + k0 + tid] = ssep[tid];
  }
}

// out[i] = sum over chunks, in chunk order, of partial[chunk][i].
__global__ void reduce_chunks(const float* __restrict__ partial, int n_chunks,
                              int stride, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)stride) return;
  float s = 0.f;
#pragma unroll 8
  for (int ch = 0; ch < n_chunks; ++ch) s += partial[(size_t)ch * stride + i];
  out[i] = s;
}

template <int MODE>
void launch_scatter(ScatterArgs p, float* out, cudaStream_t s) {
  if (p.n <= 0 || p.k <= 0) return;
  const int n_chunks = (p.n + p.chunk_rows - 1) / p.chunk_rows;
  const dim3 grid(n_chunks, (max(p.d, 1) + SD - 1) / SD, (p.k + SK - 1) / SK);
  scatter_partials<MODE><<<grid, SD, 0, s>>>(p);
  reduce_chunks<<<(p.stride + 255) / 256, 256, 0, s>>>(p.partial, n_chunks,
                                                       p.stride, out);
}

}  // namespace nkm

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
