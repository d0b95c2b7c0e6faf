// One dense one-shot round over x (n, d): the nearest and second-nearest
// centroid of every row, and the per-cluster sums S (k, d), counts v (k)
// and sse (k) = sum of the squared d1 over the cluster's rows.
//
// Replaces repro/kernels/fused_round.py::fused_round_pallas (body
// _round_kernel). Its arithmetic is kept: the top-2 is taken on the
// partial distance |c|^2 - 2 x.c, and |x|^2 is added to the two winners
// and clamped, d = max(b + |x|^2, 0), squared. That rounds differently at
// ties from the ref expression of assign_top2, so it is a template flag
// of the shared assign_kernel (common.cuh), not the ref expression.
//
// The TPU kernel keeps the whole (k, d) centroid block in VMEM and forms
// S as onehot^T x, a second MXU matmul of 2*n*k*d flops for n*d useful
// adds, carried across a sequential grid in revisited output blocks, and
// its wrapper removes the grid's pad rows again. Here the top-2 is
// kernel 1's k-tiled loop (64 rows per block, running top-2 in
// registers), and each row adds itself once, into its own cluster, by
// the deterministic two-pass chunked scatter of cluster_sum (no float
// atomics: two runs give the same bits). Rows >= n are never touched, so
// there are no pad rows to correct.
//
// Bound on the H100: operations. 2*n*k*d f32 FMA work for the distances
// plus n*d adds for S, against one read of x. At the kmeans_xl shape
// (n=4,194,304, d=1024, k=4096) that is 35.2 TFLOP, 0.525 s at the
// 67 TFLOP/s f32 peak, against 17.2 GB, 5.1 ms at 3.35 TB/s. The
// distances stay full f32 on the CUDA cores (the reference is f32); the
// scatter reads x a second time, which the bound does not count.
#include "common.cuh"

// cn: scratch of k floats; partial: scratch of n_chunks * (k*d + 2k)
// floats, n_chunks = ceil(n / chunk_rows); a (n) int32, d1 and d2 (n) f32;
// out: k*d + 2k floats, S, v, then sse.
extern "C" int fused_round_f32(const void* x, const void* c, void* cn,
                               void* a, void* d1, void* d2, void* partial,
                               void* out, int n, int k, int d, int chunk_rows,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  nkm::Top2Out top2{static_cast<int*>(a), static_cast<float*>(d1),
                    static_cast<float*>(d2)};
  nkm::launch_assign<float, false, true>(static_cast<const float*>(x),
                                         static_cast<const float*>(c),
                                         static_cast<float*>(cn), n, k, d,
                                         top2, nkm::NestedArgs{}, s);
  nkm::ScatterArgs p{};
  p.x = static_cast<const float*>(x);
  p.n = n;
  p.k = k;
  p.d = d;
  p.a = static_cast<const int*>(a);
  p.d1sq = static_cast<const float*>(d1);
  p.partial = static_cast<float*>(partial);
  p.chunk_rows = chunk_rows;
  p.stride = k * d + 2 * k;
  nkm::launch_scatter<nkm::SCATTER_ROUND>(p, static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}
