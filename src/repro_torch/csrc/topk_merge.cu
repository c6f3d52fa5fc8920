// topk_merge: per row, merge a running top-k with L new candidates.
//
// Replaces src/repro/kernels/topk_merge.py:topk_merge (Pallas, TPU):
// concatenate the running (k0) and new (L) scores/ids, pad to m_pad =
// next_pow2(k0 + L) with (-1e30, -1), turn every non-finite score into
// the -1e30 sentinel, sort the packed (key, id word) records descending
// and keep the first k.  Scores stay raw here; the Python wrapper maps
// the sentinel back to -inf.
//
// Bound on the H100: neither bytes nor flops but the sort's barriers:
// a row moves (k0 + L + k) * 8 bytes, while the network is
// log2(m)(log2(m)+1)/2 passes (45 at m = 512), each ending in a
// __syncthreads.  Design: one CTA per row with m_pad / 2 threads, so
// every pass is one compare-exchange per thread on 64-bit records in
// shared memory (one compare and one swap per record, as the packed TPU
// network does with one shuffle and one select).  The records live in
// dynamic shared memory: the live per-probe pair merges k + list_pad +
// cap columns (8,192 records, 64 KB, at k=100, list_pad=256, cap=4096),
// past the 48 KB default, so the entry point opts in to what the wrapper
// checked the card allows.
#include <cuda_runtime.h>

#include "packed_sort.cuh"

namespace {

__global__ void topk_merge_kernel(const float* __restrict__ s,
                                  const int* __restrict__ ids,
                                  const float* __restrict__ ns,
                                  const int* __restrict__ nids,
                                  float* __restrict__ out_s,
                                  int* __restrict__ out_i, int k0, int L,
                                  int k, int m_pad) {
  extern __shared__ long long rec[];
  const long long b = blockIdx.x;
  for (int t = threadIdx.x; t < m_pad; t += blockDim.x) {
    float v = packed::kNeg;
    int id = -1;
    if (t < k0) {
      v = s[b * k0 + t];
      id = ids[b * k0 + t];
    } else if (t < k0 + L) {
      v = ns[b * L + (t - k0)];
      id = nids[b * L + (t - k0)];
    }
    if (!isfinite(v)) v = packed::kNeg;
    rec[t] = packed::pack(packed::score_to_key(v), id);
  }
  __syncthreads();
  packed::bitonic_desc(rec, m_pad);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const long long r = rec[t];
    out_s[b * k + t] = packed::key_to_score(packed::key_of(r));
    out_i[b * k + t] = packed::idw_of(r);
  }
}

}  // namespace

extern "C" int topk_merge(const float* s, const int* ids, const float* ns,
                          const int* nids, float* out_s, int* out_i, int B,
                          int k0, int L, int k, int m_pad, void* stream) {
  const int threads = m_pad / 2 < 32 ? 32 : (m_pad / 2 > 1024 ? 1024 : m_pad / 2);
  const size_t smem = m_pad * sizeof(long long);
  const cudaError_t set = cudaFuncSetAttribute(
      topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  topk_merge_kernel<<<B, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      s, ids, ns, nids, out_s, out_i, k0, L, k, m_pad);
  return static_cast<int>(cudaGetLastError());
}
