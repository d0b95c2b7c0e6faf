// Nearest and second-nearest centroid of every row: a (n) int32, d1 and
// d2 (n) f32 squared distances max(|x|^2 - 2 x.c + |c|^2, 0).
//
// Replaces repro/kernels/kmeans_assign.py::assign_top2_pallas (body
// _assign_kernel). On the TPU that kernel runs the x.c block on the MXU
// with the k dimension as a sequential grid axis carrying the running
// top-2 in its output blocks. Here one block owns 64 rows and loops over
// k itself, keeping the running (min, 2nd-min, argmin) in registers, so
// nothing but the three output vectors is written (see common.cuh).
//
// Bound on the H100: 2*n*k*d f32 FMA work against n*d input bytes. At the
// main-path shape (n=400,000, d=784, k=50) that is 31.4 GFLOP, 0.47 ms at
// the 67 TFLOP/s f32 peak, against 1.25 GB, 0.37 ms at 3.35 TB/s: compute
// bound. The distances stay full f32 FMA on the CUDA cores (TF32 would
// round the operands to 10 mantissa bits, and the reference is f32), so
// the f32 peak is the ceiling; tensor cores (3xTF32 or wgmma) are later
// work. x is read once per 64-centroid tile, which at k <= 64 is once.
// f32 and bf16 inputs, f32 accumulation.
#include "common.cuh"

namespace {
template <typename T>
int run(const void* x, const void* c, void* cn, void* a, void* d1, void* d2,
        int n, int k, int d, void* stream) {
  nkm::Top2Out out{static_cast<int*>(a), static_cast<float*>(d1),
                   static_cast<float*>(d2)};
  nkm::launch_assign<T, false>(static_cast<const T*>(x),
                               static_cast<const T*>(c),
                               static_cast<float*>(cn), n, k, d, out,
                               nkm::NestedArgs{},
                               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// cn: scratch of k floats for |c|^2.
extern "C" int assign_top2_f32(const void* x, const void* c, void* cn,
                               void* a, void* d1, void* d2, int n, int k,
                               int d, void* stream) {
  return run<float>(x, c, cn, a, d1, d2, n, k, d, stream);
}

extern "C" int assign_top2_bf16(const void* x, const void* c, void* cn,
                                void* a, void* d1, void* d2, int n, int k,
                                int d, void* stream) {
  return run<__nv_bfloat16>(x, c, cn, a, d1, d2, n, k, d, stream);
}
