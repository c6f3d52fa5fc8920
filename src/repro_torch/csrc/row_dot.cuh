// The one dot product of the IVF kernels: a query (staged in shared
// memory) against one document row, by one warp.
//
// ivf_scan.cu scores through this routine, and ivf_scan_merge.cu's
// two-row dot2 and delta_scan.cu's register tile keep its order (the
// same lane-strided FMAs, the same butterfly), so a document's score is
// the same bits on
// the per-probe pair, on the fused path, in the delta buffer and after
// merge_delta moved it into a list ("fused == per-probe pair" and "live
// overlay == rebuilt index" hold on the card).  Lane l accumulates elements l,
// l+32, ... with f32 FMA (no TF32), then an XOR butterfly sums the 32
// partials; every lane ends with the same value.  Neighbouring lanes
// read neighbouring floats: each step of the warp is one coalesced
// 128-byte load.
#pragma once

__device__ __forceinline__ float row_dot(const float* __restrict__ q_s,
                                         const float* __restrict__ row,
                                         int d, int lane) {
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) acc = fmaf(q_s[c], __ldg(row + c), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}
