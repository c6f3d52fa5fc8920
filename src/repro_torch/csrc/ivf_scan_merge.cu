// ivf_scan_merge: a chunk of probes per query, scan -> merge fused, with
// the live index's delta stream.
//
// Replaces src/repro/kernels/ivf_scan_merge.py:ivf_scan_merge (Pallas,
// TPU).  For query b and probe slot j < chunk: score the list_pad rows of
// the probed list (rows at or past the list's size, and rows whose id is
// -1, are not candidates), mark the new candidates with NEW_MARK, merge
// them into the packed running top-k, count the survivors that are still
// marked (phi = 100 (k - count) / k), strip the marks and write the
// slot's top-k snapshot and count.  Scores stay raw (the -1e30 sentinel
// on empty slots); the Python wrapper maps the sentinel back to -inf.
//
// Delta stream (cap > 0): at the chunk's first slot the CTA scores the
// delta buffer into a shared-memory strip, once per query; a slot whose
// id is < 0 (empty or tombstoned) can never pass the gate, so its dot
// product is skipped.  At slot j the entries with assign == gates[slot]
// and id >= 0 join the slot's candidates, NEW-marked.  The reference
// merges them in a second merge after the list's; one merge of the
// running top-k with the list rows and the gated entries keeps the same
// records and the same count, because the packed (key, id word) order is
// total (the per-probe pair merges the concatenation once, too).  The
// gated entries are appended behind the list rows in any order, and the
// sort runs over next_pow2(k + list_pad + gated) records, so a slot that
// gates nothing sorts no more than without the stream.  Slots past the
// probe budget gate on -2, which no live entry carries.
//
// Bound on the H100: memory, as for ivf_scan: a slot reads its live
// rows (size * d f32 plus their ids) once, and the delta stream reads
// each live buffer row once per query; the running top-k and the raw
// scores never leave shared memory, so a slot writes k records and one
// count instead of list_pad scores.  Design: on the TPU the grid's chunk
// dimension runs in order and carries scratch between steps.  CUDA blocks
// carry nothing, so the chunk is a loop inside ONE CTA per query: the
// running top-k stays in shared memory across the chunk; each slot reads
// its own offset, size and gate (no scalar prefetch); each warp scores
// rows with the row_dot that ivf_scan.cu and delta_scan.cu use (bitwise
// the same scores as the per-probe pair) and skips rows past the size;
// the merge is the shared bitonic sort.  With one CTA per query the
// memory latency of the scoring, not the bandwidth, is what a CTA waits
// on, so the CTA is 1024 threads: 32 warps keep 32 rows in flight, and
// the sort's passes leave three quarters of them idle, which costs less
// (PERF.md).  Shared memory holds next_pow2(k + list_pad + cap) records,
// d query floats and cap strip floats: 83 KB at k=100, list_pad=256,
// cap=4096, d=768, past the 48 KB default, so the entry point opts in.
// Later work: cp.async/TMA double-buffering of the tiles, wgmma scoring,
// more than one CTA per query, and scoring only the buffer rows that a
// chunk's gates select.
#include <cuda_runtime.h>

#include "packed_sort.cuh"
#include "row_dot.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) ivf_scan_merge_kernel(
    const float* __restrict__ q, const float* __restrict__ docs,
    const int* __restrict__ ids, const int* __restrict__ boffs,
    const int* __restrict__ sizes, const float* __restrict__ run_s,
    const int* __restrict__ run_i, const float* __restrict__ dvecs,
    const int* __restrict__ dids, const int* __restrict__ dassign,
    const int* __restrict__ gates, float* __restrict__ out_s,
    int* __restrict__ out_i, int* __restrict__ cnt, int d, int k, int chunk,
    int list_pad, int blk_l, int cap, int m_max) {
  extern __shared__ long long smem[];
  __shared__ int n_gated;
  long long* rec = smem;                                  // m_max records
  float* q_s = reinterpret_cast<float*>(smem + m_max);   // d floats
  float* dsc = q_s + d;                                  // cap floats
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const long long pad = packed::pack(packed::score_to_key(packed::kNeg), -1);
  const int key_valid = packed::score_to_key(packed::kValidMin);
  const int base_n = k + list_pad;   // records before the gated entries

  for (int c = tid; c < d; c += blockDim.x) q_s[c] = q[b * d + c];
  for (int t = tid; t < k; t += blockDim.x) {
    float s = run_s[b * k + t];
    s = s < packed::kNeg ? packed::kNeg : s;   // clamp -inf empty slots
    rec[t] = packed::pack(packed::score_to_key(s), run_i[b * k + t]);
  }
  if (cap > 0) {
    __syncthreads();   // q_s in place
    for (int e = warp; e < cap; e += n_warps) {
      if (dids[e] >= 0) {                     // uniform across the warp
        const float s = row_dot(q_s, dvecs + static_cast<long long>(e) * d,
                                d, lane);
        if (lane == 0) dsc[e] = s;
      }
    }
  }

  for (int j = 0; j < chunk; ++j) {
    const long long slot = b * chunk + j;
    const long long base = static_cast<long long>(boffs[slot]) * blk_l;
    const int size = sizes[slot];
    if (tid == 0) n_gated = 0;
    __syncthreads();   // q_s, the strip and the running top-k are in place
    for (int r = warp; r < list_pad; r += n_warps) {
      long long v = pad;
      if (r < size) {                       // uniform across the warp
        const int id = ids[base + r];
        if (id >= 0) {
          const float s = row_dot(q_s, docs + (base + r) * d, d, lane);
          v = packed::pack(packed::score_to_key(s), id | packed::kNewMark);
        }
      }
      if (lane == 0) rec[k + r] = v;
    }
    if (cap > 0) {
      const int gate = gates[slot];
      for (int e = tid; e < cap; e += blockDim.x) {
        const int id = dids[e];
        if (dassign[e] == gate && id >= 0) {
          const int at = atomicAdd(&n_gated, 1);
          rec[base_n + at] = packed::pack(packed::score_to_key(dsc[e]),
                                          id | packed::kNewMark);
        }
      }
    }
    __syncthreads();   // candidates and n_gated in place
    const int n = base_n + n_gated;
    int m = 1;
    while (m < n) m <<= 1;
    for (int t = n + tid; t < m; t += blockDim.x) rec[t] = pad;
    __syncthreads();
    packed::bitonic_desc(rec, m);
    // lanes still NEW-marked entered on this probe; empty slots count
    // as new because only keys above the valid floor count as kept
    int key = 0, idw = -1;
    if (tid < k) {
      const long long r = rec[tid];
      key = packed::key_of(r);
      idw = packed::idw_of(r);
    }
    const int kept = __syncthreads_count(
        tid < k && key > key_valid && !packed::is_marked(idw));
    if (tid < k) {
      const int clean = packed::strip_marks(idw);
      out_s[slot * k + tid] = packed::key_to_score(key);
      out_i[slot * k + tid] = clean;
      rec[tid] = packed::pack(key, clean);
    }
    if (tid == 0) cnt[slot] = k - kept;
  }
}

}  // namespace

extern "C" int ivf_scan_merge(const float* q, const float* docs,
                              const int* ids, const int* boffs,
                              const int* sizes, const float* run_s,
                              const int* run_i, const float* dvecs,
                              const int* dids, const int* dassign,
                              const int* gates, float* out_s, int* out_i,
                              int* cnt, int B, int d, int k, int chunk,
                              int list_pad, int blk_l, int cap, int m_max,
                              void* stream) {
  // kThreads >= k: one thread per running-top-k lane (the wrapper checks
  // k <= 1024 and that the shared memory fits the card's opt-in limit)
  const size_t smem = m_max * sizeof(long long) + (d + cap) * sizeof(float);
  const cudaError_t set = cudaFuncSetAttribute(
      ivf_scan_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  ivf_scan_merge_kernel<<<B, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      q, docs, ids, boffs, sizes, run_s, run_i, dvecs, dids, dassign, gates,
      out_s, out_i, cnt, d, k, chunk, list_pad, blk_l, cap, m_max);
  return static_cast<int>(cudaGetLastError());
}
