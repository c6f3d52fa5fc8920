// embedding_bag: per bag, the sum of F gathered table rows.
//
// Replaces src/repro/kernels/embedding_bag.py:embedding_bag (Pallas, TPU):
// out[b, :] = sum over f = 0..F-1 of table[ids[b, f], :], accumulated in
// f32 in that order (the Pallas kernel's output block is revisited across
// the F grid steps and added to in place, starting from zeros).  The same
// order here makes the kernel, its plain version and the Pallas kernel
// agree bit for bit.
//
// Bound on the H100: bytes.  Each bag reads F ids and F rows of D floats
// and writes D floats; there is one add per row element.  At the DeepFM
// bulk shape (B=262,144, F=39, D=10) the ids are 40.9 MB and the output
// 10.5 MB; the rows are 40 bytes each, scattered over a 1.56 GB table,
// so a row read costs a 32-byte sector or two whatever is used of it,
// and Zipf-skewed ids make most of those reads hit L2.
// Design: one thread per (bag, column), columns fastest, so a warp's
// reads of one row are contiguous and serve D = 1, 10 or 16 alike, with
// no shared memory and no block-wide step.  The F row loads of a thread
// are independent (only the adds are ordered), so the unrolled loop keeps
// several in flight.  Later work: a warp per bag with vector loads for
// wide D, and caching the hottest rows.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const float* __restrict__ table,
                         const int* __restrict__ ids, float* __restrict__ out,
                         int B, int F, int D) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= static_cast<long long>(B) * D) return;
  const int b = static_cast<int>(t / D);
  const int c = static_cast<int>(t - static_cast<long long>(b) * D);
  const int* bag = ids + static_cast<long long>(b) * F;
  float acc = 0.0f;
#pragma unroll 8
  for (int f = 0; f < F; ++f)
    acc += table[static_cast<long long>(__ldg(bag + f)) * D + c];
  out[t] = acc;
}

}  // namespace

extern "C" int embedding_bag(const float* table, const int* ids, float* out,
                             int B, int F, int D, void* stream) {
  const long long n = static_cast<long long>(B) * D;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  embedding_bag_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(table, ids, out,
                                                              B, F, D);
  return static_cast<int>(cudaGetLastError());
}
