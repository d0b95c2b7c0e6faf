// One dense one-shot round over x (n, d): the nearest and second-nearest
// centroid of every row, and the per-cluster sums S (k, d), counts v (k)
// and sse (k) = sum of the squared d1 over the cluster's rows.
//
// Replaces repro/kernels/fused_round.py::fused_round_pallas (body
// _round_kernel). Its arithmetic is kept: the top-2 is taken on the
// partial distance |c|^2 - 2 x.c, and |x|^2 is added to the two winners
// and clamped, d = max(b + |x|^2, 0), squared. That rounds differently at
// ties from the ref expression of assign_top2.
//
// The TPU kernel keeps the whole (k, d) centroid block in VMEM and forms
// S as onehot^T x, a second MXU matmul of 2*n*k*d flops for n*d useful
// adds, carried across a sequential grid in revisited output blocks, and
// its wrapper removes the grid's pad rows again. Here the top-2 is the
// tensor-core kernel of tc_top2.cuh with its EPI_PARTIAL epilogue (TMA,
// 3xTF32 wgmma, running top-2 in registers; its note gives its design and
// bound), and each row adds
// itself once, into its own cluster, by the deterministic scatter of
// cluster_sum (common.cuh): the rows of each chunk listed by cluster
// tile, each (chunk, feature tile, cluster tile) summing its own list in
// row order, the chunks summed in chunk order; no float atomics, two runs
// give the same bits. Rows >= n are never touched, so there are no pad
// rows to correct.
//
// Bound on the H100 SXM: operations. 3 x 2*n*k*d TF32 operations for the
// distances at 495 TFLOP/s plus n*d f32 adds for S, against one read of
// x. At the kmeans_xl shape (n=4,194,304, d=1024, k=4096) that is 213 ms,
// against 17.2 GB, 5.1 ms at 3.35 TB/s (full f32 on the CUDA cores would
// be 525 ms at 67 TFLOP/s). The scatter alone is bound by bytes: a second
// read of x (17.2 GB, 5.1 ms) plus writing and reading its partials, 256
// chunks of (k*d + 2k) floats, 4.3 GB each way (about 2.6 ms).
#include "tc_top2.cuh"

// The top-2 reads xp (n, dp) and cp (k, dp): x and c, or copies of them
// zero-padded to a row of dp floats, dp % 4 == 0 (TMA's 16-byte stride);
// the scatter reads x (n, d). Scratch: c_big, c_small (k * dp floats), cn
// (k), xn (n), partial: n_chunks * (k*d + 2k) floats, n_chunks =
// ceil(n / chunk_rows), lists: 2 * n_chunks * ceil(k / 64) + n ints. Out:
// a (n) int32, d1 and d2 (n) f32; out: k*d + 2k floats, S, v, then sse.
extern "C" int fused_round_f32(const void* x, const void* xp, const void* cp,
                               void* c_big, void* c_small, void* cn, void* xn,
                               void* a, void* d1, void* d2, void* partial,
                               void* lists, void* out, int n, int k, int d,
                               int dp, int chunk_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  nkm::tc::Top2Args t{};
  t.n = n;
  t.k = k;
  t.d = dp;
  t.out = nkm::Top2Out{static_cast<int*>(a), static_cast<float*>(d1),
                       static_cast<float*>(d2)};
  const int err = nkm::tc::launch_top2<nkm::tc::EPI_PARTIAL>(
      static_cast<const float*>(xp), static_cast<const float*>(cp),
      static_cast<float*>(c_big), static_cast<float*>(c_small),
      static_cast<float*>(cn), static_cast<float*>(xn), t, s);
  if (err != 0) return err;
  nkm::ScatterArgs p{};
  p.x = static_cast<const float*>(x);
  p.n = n;
  p.k = k;
  p.d = d;
  p.a = static_cast<const int*>(a);
  p.d1sq = static_cast<const float*>(d1);
  p.partial = static_cast<float*>(partial);
  p.lists = static_cast<int*>(lists);
  p.chunk_rows = chunk_rows;
  p.stride = k * d + 2 * k;
  nkm::launch_scatter<nkm::SCATTER_ROUND>(p, static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

// The top-2's main loop alone (TMA, 3xTF32 split, wgmma; BN = 64 where
// k <= 64, else 128): dot (n, k) = xp . cp^T, for a check of its operand
// and fragment layout. Arguments as for fused_round_f32.
extern "C" int tc_dot_f32(const void* xp, const void* cp, void* c_big,
                          void* c_small, void* cn, void* dot, int n, int k,
                          int dp, void* stream) {
  nkm::tc::Top2Args t{};
  t.n = n;
  t.k = k;
  t.d = dp;
  t.dot = static_cast<float*>(dot);
  return nkm::tc::launch_top2<nkm::tc::EPI_DOT>(
      static_cast<const float*>(xp), static_cast<const float*>(cp),
      static_cast<float*>(c_big), static_cast<float*>(c_small),
      static_cast<float*>(cn), nullptr, t, static_cast<cudaStream_t>(stream));
}
