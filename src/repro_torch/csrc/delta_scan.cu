// delta_scan: raw scores of every query against every delta-buffer slot.
//
// Replaces src/repro/kernels/delta_scan.py:delta_scan (Pallas, TPU):
// out[b, s] = q_b . vecs[s] for every slot s < cap, empty and tombstoned
// slots included (callers mask by ids >= 0 and by the cluster gate).
//
// Bound on the H100: operations.  B * cap * d multiply-adds over
// (B + cap) * d + B * cap floats moved: at B=128, cap=4096, d=768 that is
// 805 MFLOP (0.012 ms at 67 TFLOP/s in f32) against 15 MB (0.0045 ms at
// 3.35 TB/s).  The Pallas kernel feeds the MXU; this one cannot use the
// tensor cores, because every score must be row_dot's bits (f32 FMA in
// lane order, no TF32): a delta doc then scores the same on the per-probe
// pair, inside the fused kernel and after merge_delta moved it into a
// list, which is what keeps the live overlay equal to a rebuilt index.
// Design: a CTA stages kQ queries in shared memory and its kWarps warps
// walk kSlots slots, one slot per warp at a time; a warp reads its slot's
// row once and accumulates it against the kQ queries (row_dot_multi), so
// the buffer is read B / kQ times, mostly from L2.  Later work: register
// tiling over queries and slots, and cp.async staging of the rows.
#include <cuda_runtime.h>

#include "row_dot.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kQ = 8;       // queries staged per CTA
constexpr int kSlots = 64;  // slots per CTA

__global__ void __launch_bounds__(kWarps * 32)
    delta_scan_kernel(const float* __restrict__ q,
                      const float* __restrict__ vecs, float* __restrict__ out,
                      int B, int cap, int d) {
  extern __shared__ float q_s[];  // kQ * d, zero past the last query
  const int b0 = blockIdx.y * kQ;
  const int nq = min(kQ, B - b0);
  for (int t = threadIdx.x; t < kQ * d; t += blockDim.x)
    q_s[t] = t < nq * d ? q[static_cast<long long>(b0) * d + t] : 0.0f;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s0 = blockIdx.x * kSlots;
  const int s1 = min(cap, s0 + kSlots);
  for (int s = s0 + warp; s < s1; s += kWarps) {
    float acc[kQ];
    row_dot_multi<kQ>(q_s, vecs + static_cast<long long>(s) * d, d, lane, acc);
#pragma unroll
    for (int i = 0; i < kQ; ++i)
      if (lane == i && i < nq)
        out[static_cast<long long>(b0 + i) * cap + s] = acc[i];
  }
}

}  // namespace

extern "C" int delta_scan(const float* q, const float* vecs, float* out, int B,
                          int cap, int d, void* stream) {
  const dim3 grid((cap + kSlots - 1) / kSlots, (B + kQ - 1) / kQ);
  const size_t smem = kQ * d * sizeof(float);
  const cudaError_t set = cudaFuncSetAttribute(
      delta_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  delta_scan_kernel<<<grid, kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(q, vecs, out, B,
                                                           cap, d);
  return static_cast<int>(cudaGetLastError());
}
