// One dense nested round over the prefix x (b, d): top-2 assignment, the
// caller's keep-select, the signed delta S/v and the per-cluster sse.
//
// Replaces repro/kernels/fused_round.py::fused_nested_round_pallas (body
// _nested_kernel). Outputs, as there: a_new (-1 on invalid rows), d_new
// and lb_new (euclidean; kept rows pass d_keep / lb_keep through), dS
// (k, d) and dv (k) with +1 at a_new for joins and new rows and -1 at
// a_prev for leaves, and sse (k) = sum of d_new^2 at a_new over every
// valid row, kept rows too.
//
// The TPU kernel keeps the whole (k_pad, d) centroid block in VMEM and
// folds dS into a second MXU matmul of a signed coefficient matrix. On
// the H100 a block has 227 KB of shared memory, which holds k=50, d=784
// in f32 (157 KB) but not k_pad=128 nor large k*d, so the top-2 is the
// tensor-core kernel of tc_top2.cuh, which streams c in tiles of BN
// centroids (64 where k <= 64), with its EPI_NESTED epilogue: the ref
// expression's top-2 (3xTF32 wgmma, compensated sums, |x|^2 from the
// tiles in shared memory), then the keep select and sqrt. Each row then
// adds at most two signed rows of x to dS: that is the deterministic
// scatter of cluster_sum (common.cuh), whose lists hold every row at
// a_new's tile (for its sse) and a leaver at a_prev's too, and which
// reads x again only for rows that join, leave or are new.
// Grid pad rows do not exist (rows beyond b are never touched) and
// invalid rows add nothing. No float atomics.
//
// Bound on the H100 at b=400,000, d=784, k=50: bytes, one read of x
// (1.25 GB, 0.37 ms at 3.35 TB/s) plus the second read of the delta rows,
// against 3 x 2 x b x 64 x d TF32 operations (0.24 ms at 495 TFLOP/s).
// The second read is what this design pays beyond the TPU kernel's
// single pass.
#include "tc_top2.cuh"

// The top-2 reads xp (n, dp) and cp (k, dp): x and c, or copies of them
// zero-padded to a row of dp floats, dp % 4 == 0 (TMA's 16-byte stride);
// the scatter reads x (n, d). Scratch: c_big, c_small (k * dp floats), cn
// (k); partial: n_chunks * (k*d + 2k) floats, n_chunks = ceil(n /
// chunk_rows); lists: 2 * n_chunks * ceil(k / 64) + 2n ints. Out: k*d +
// 2k floats, dS, dv, then sse. settled and valid are bytes (torch.bool).
extern "C" int fused_nested_round_f32(
    const void* x, const void* xp, const void* cp, void* c_big,
    void* c_small, void* cn, const void* a_prev, const void* settled,
    const void* d_keep, const void* lb_keep, const void* valid, void* a_new,
    void* d_new, void* lb_new, void* partial, void* lists, void* out, int n,
    int k, int d, int dp, int chunk_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  nkm::tc::Top2Args t{};
  t.n = n;
  t.k = k;
  t.d = dp;
  t.nest = nkm::NestedArgs{static_cast<const int*>(a_prev),
                           static_cast<const uint8_t*>(settled),
                           static_cast<const float*>(d_keep),
                           static_cast<const float*>(lb_keep),
                           static_cast<const uint8_t*>(valid),
                           static_cast<int*>(a_new),
                           static_cast<float*>(d_new),
                           static_cast<float*>(lb_new)};
  const int err = nkm::tc::launch_top2<nkm::tc::EPI_NESTED>(
      static_cast<const float*>(xp), static_cast<const float*>(cp),
      static_cast<float*>(c_big), static_cast<float*>(c_small),
      static_cast<float*>(cn), nullptr, t, s);
  if (err != 0) return err;
  nkm::ScatterArgs p{};
  p.x = static_cast<const float*>(x);
  p.n = n;
  p.k = k;
  p.d = d;
  p.a_prev = static_cast<const int*>(a_prev);
  p.a_new = static_cast<const int*>(a_new);
  p.d_new = static_cast<const float*>(d_new);
  p.partial = static_cast<float*>(partial);
  p.lists = static_cast<int*>(lists);
  p.chunk_rows = chunk_rows;
  p.stride = k * d + 2 * k;
  nkm::launch_scatter<nkm::SCATTER_NESTED>(p, static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}
