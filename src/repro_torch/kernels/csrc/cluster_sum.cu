// Weighted per-cluster sums S (k, d) = sum_r w[r] x[r] over rows with
// a[r] == j, and counts v (k) = sum_r w[r]; f32.
//
// Replaces repro/kernels/cluster_sum.py::cluster_sum_pallas (body
// _cluster_sum_kernel). The TPU kernel turns the scatter into a one-hot
// matmul onehot(a)^T (w x) on the MXU: 2*n*k*d flops for n*d useful adds.
// That is not carried over. Here each row is added once, into its own
// cluster, by the deterministic scatter of common.cuh: the rows of each
// chunk are listed by cluster tile (rows of weight 0 or with a label
// outside [0, k) are left out), each (chunk, feature tile, cluster tile)
// sums its own list into shared memory in row order, and a last pass sums
// the chunks in chunk order. No float atomics: two runs give the same
// bits, and the bits are those of summing each chunk row by row.
//
// Bound on the H100: memory. The function must read n*d*4 bytes of x for
// the rows whose weight is not 0 (plus a and w); at n=400,000, d=784 with
// two thirds of the weights not 0 (weights +1/-1/0) that is 0.84 GB,
// 0.25 ms at 3.35 TB/s. The partials (n_chunks * (k*d + k) floats, 31 MB
// there) are written and read once more. With d == 0 only v is formed:
// that is how the nested round sums a per-row scalar per cluster
// deterministically.
#include "common.cuh"

// partial: scratch of n_chunks * (k*d + k) floats, n_chunks =
// ceil(n / chunk_rows); lists: scratch of 2 * n_chunks * ceil(k / 64) + n
// ints; out: k*d + k floats, S then v.
extern "C" int cluster_sum_f32(const void* x, const void* a, const void* w,
                               void* partial, void* lists, void* out, int n,
                               int k, int d, int chunk_rows, void* stream) {
  nkm::ScatterArgs p{};
  p.x = static_cast<const float*>(x);
  p.n = n;
  p.k = k;
  p.d = d;
  p.a = static_cast<const int*>(a);
  p.w = static_cast<const float*>(w);
  p.partial = static_cast<float*>(partial);
  p.lists = static_cast<int*>(lists);
  p.chunk_rows = chunk_rows;
  p.stride = k * d + k;
  nkm::launch_scatter<nkm::SCATTER_SUM>(p, static_cast<float*>(out),
                                        static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
