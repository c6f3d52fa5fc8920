// topk_merge: per row, merge a running top-k with L new candidates.
//
// Replaces src/repro/kernels/topk_merge.py:topk_merge (Pallas, TPU): the
// first k records, in the packed (key, id word) order, of running (k0)
// ++ new (L) ++ (m_pad - k0 - L) pad records (-1e30, -1), m_pad =
// next_pow2(k0 + L), after every non-finite score has become the -1e30
// sentinel.  Scores at or below -1e29 come back as -inf (the reference
// wrapper's map, done here so that a call is one launch).
//
// Bound on the H100: the launch.  A row moves (k0 + L + k) * 8 bytes: at
// the pair search's shapes (B 128, k 100, L 256) 0.47 MB, 0.14 us at
// 3.35 TB/s, below the floor of one launch; at the live pair's width (L
// = 256 list rows + 4,096 buffer columns, nearly all -inf) 5.6 MB.
//
// Design.  The packed order is total and equal records are identical, so
// any exact selection of the first k gives the bits of the reference's
// bitonic network over all m_pad records; nothing sorts m_pad records.
// One CTA of 256 threads per row:
// - The running top-k: the first min(k0, k) running records, clamped and
//   packed, are checked for packed order with one __syncthreads_and and
//   ranked only if they are out of it (the pair path's running top-k is
//   sorted unless tombstone scrubbing punched -inf holes in it).  Then
//   min(k, m_pad - k0 - L) pad records join it by binary search: no more
//   than the reference pads with, since ids below -1 rank under a pad.
//   Slots still free hold a word below every record, so every column
//   passes the filter until k records are in.
// - The stream: the running records past the first k (k0 > k) and the L
//   new columns, in tiles of 256 columns, one coalesced load a thread;
//   each thread has the loads of the next 2 tiles in flight while it
//   filters these 2 (deeper prefetch spilled registers and was no
//   faster at the live width on an H100).  A column survives only if its record is strictly above the
//   running k-th (an equal one would rank at k or below); survivors are
//   compacted by ballot into a 512-record buffer, which is merged by rank
//   (packed_sort.cuh's merge, the fused kernel's) whenever the next tile
//   could overflow it, and at the end.  After a probe most columns lie
//   below the running k-th, and the live width's -inf buffer columns
//   never pass, so the merges are short.
// - The k records are written once, with the -inf map.
// Shared memory is 16 (k + 512) bytes whatever L is.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "packed_sort.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTiles = 2;               // tiles of loads a thread has in flight
constexpr int kBuf = 2 * kThreads;      // survivors between merges
constexpr long long kFree = LLONG_MIN;  // no clamped record packs to it

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

__device__ __forceinline__ long long record(float s, int id) {
  return packed::pack(packed::score_to_key(isfinite(s) ? s : packed::kNeg),
                      id);
}

// the stream's columns c0 + u * kThreads + threadIdx.x (u < kTiles): the
// `extra` running records rs/ri first, then the new ones; (-1e30, -1)
// past its end (the caller masks those columns)
__device__ __forceinline__ void fetch(float (&v)[kTiles], int (&vi)[kTiles],
                                      const float* rs, const int* ri,
                                      const float* rns, const int* rni,
                                      int extra, int n_stream, int c0) {
#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
    const int c = c0 + u * kThreads + threadIdx.x;
    v[u] = packed::kNeg;
    vi[u] = -1;
    if (c < extra) {
      v[u] = rs[c];
      vi[u] = ri[c];
    } else if (c < n_stream) {
      v[u] = rns[c - extra];
      vi[u] = rni[c - extra];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    topk_merge_kernel(const float* __restrict__ s, const int* __restrict__ ids,
                      const float* __restrict__ ns,
                      const int* __restrict__ nids, float* __restrict__ out_s,
                      int* __restrict__ out_i, int k0, int L, int k,
                      int n_pad) {
  // the running top-k, its merge scratch, the survivors and their ranks
  extern __shared__ long long smem[];
  long long* run = smem;
  long long* tmp = run + k;
  long long* cand = tmp + k;
  long long* bsort = cand + kBuf;
  __shared__ int wsum[kThreads / 32];
  __shared__ int n_surv_s;  // merge() resets it: the fused kernel counts there
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int kr = min(k0, k);
  const int extra = k0 - kr;  // running records that join the stream
  const int n_stream = extra + L;
  const float* row_s = s + b * k0;
  const int* row_i = ids + b * k0;
  const float* row_ns = ns + b * L;
  const int* row_ni = nids + b * L;

  // the first tiles' loads go out with the running top-k's
  float v[kTiles];
  int vi[kTiles];
  fetch(v, vi, row_s + kr, row_i + kr, row_ns, row_ni, extra, n_stream, 0);
  // a thread packs its running records and checks each against the next
  // one (read again from global memory), so one barrier also publishes
  // them
  bool sorted = true;
  for (int t = tid; t < k; t += kThreads) {
    const long long r = t < kr ? record(row_s[t], row_i[t]) : kFree;
    run[t] = r;
    if (t + 1 < kr) sorted &= r >= record(row_s[t + 1], row_i[t + 1]);
  }
  if (!__syncthreads_and(sorted)) {
    packed::rank<kThreads>(run, tmp, kr);
    __syncthreads();
    for (int t = tid; t < kr; t += kThreads) run[t] = tmp[t];
    __syncthreads();
  }
  // np equal pad records enter after the running records at or above
  // them (unless those fill the top-k); what they push past slot k - 1
  // leaves
  const int np = min(k, n_pad);
  const long long pad = packed::pack(packed::score_to_key(packed::kNeg), -1);
  const int at = np > 0 ? packed::count_above(run, kr, pad, true) : k;
  if (at < k) {
    for (int t = tid; t < k; t += kThreads) {
      tmp[t] = t < at ? run[t] : (t < at + np ? pad : run[t - np]);
    }
    __syncthreads();
    for (int t = tid; t < k; t += kThreads) run[t] = tmp[t];
    __syncthreads();
  }

  int n_surv = 0;  // survivors in the buffer, the same in every thread
  for (int c0 = 0; c0 < n_stream; c0 += kTiles * kThreads) {
    float cv[kTiles];
    int ci[kTiles];
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      cv[u] = v[u];
      ci[u] = vi[u];
    }
    if (c0 + kTiles * kThreads < n_stream) {
      fetch(v, vi, row_s + kr, row_i + kr, row_ns, row_ni, extra, n_stream,
            c0 + kTiles * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      const int tile0 = c0 + u * kThreads;
      if (tile0 >= n_stream) break;
      if (n_surv + kThreads > kBuf) {
        packed::merge<kThreads>(run, tmp, cand, bsort, n_surv, &n_surv_s, k,
                                BlockSync{});
        n_surv = 0;
      }
      const long long r = record(cv[u], ci[u]);
      const bool keep = tile0 + tid < n_stream && r > run[k - 1];
      n_surv += packed::compact<kThreads>(keep, r, cand + n_surv, wsum,
                                          BlockSync{});
    }
  }
  if (n_surv > 0) {
    packed::merge<kThreads>(run, tmp, cand, bsort, n_surv, &n_surv_s, k,
                            BlockSync{});
  }
  for (int t = tid; t < k; t += kThreads) {
    const long long r = run[t];
    const float x = packed::key_to_score(packed::key_of(r));
    out_s[b * k + t] = x > packed::kValidMin ? x : -INFINITY;
    out_i[b * k + t] = packed::idw_of(r);
  }
}

}  // namespace

// shared memory of one CTA (kernels/topk_merge.py:smem_bytes mirrors it)
extern "C" int topk_merge(const float* s, const int* ids, const float* ns,
                          const int* nids, float* out_s, int* out_i, int B,
                          int k0, int L, int k, int m_pad, void* stream) {
  // the wrapper checks 0 < k <= m_pad and that the shared memory fits
  const size_t smem = 16 * (static_cast<size_t>(k) + kBuf);
  const cudaError_t set = cudaFuncSetAttribute(
      topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  topk_merge_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      s, ids, ns, nids, out_s, out_i, k0, L, k, m_pad - k0 - L);
  return static_cast<int>(cudaGetLastError());
}
