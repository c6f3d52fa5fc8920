// Packed (score, id) records and the filtered rank merge that every top-k
// merge of the port runs: the CUDA side of src/repro/kernels/sort.py (the
// plain PyTorch side is src/repro_torch/kernels/sort.py).
//
// A score maps to an int32 key whose signed order is the float order.
// A record is (key, id word), packed into ONE signed 64-bit word: the
// key in the high half, the id word biased by 2^31 in the low half, so
// a single 64-bit compare is the lexicographic (key, id word) compare
// of the reference and -1 sorts below every real id.  Ties go to the
// higher id word, compared while it still carries NEW_MARK.
//
// The order is total and equal records are identical, so any exact
// selection of the first k records gives the bits of the reference's
// bitonic network over all of them.  Both merging kernels select so:
// they keep a sorted running top-k, let only records strictly above its
// k-th into a survivor buffer, and merge the buffer by rank (`merge`).
// ivf_scan_merge runs these helpers on its 8 consumer warps (named
// barrier 1), topk_merge on its whole block (__syncthreads): each passes
// its thread count and its barrier.  row_topk packs its (value, position)
// records with the same key map and words and compacts with `compact`,
// but sorts its larger survivor buffer by a bitonic network of its own.
#pragma once

namespace packed {

constexpr int kSignFlip = 0x7FFFFFFF;
constexpr int kNewMark = 1 << 30;
constexpr float kNeg = -1e30f;       // finite stand-in for -inf
constexpr float kValidMin = -1e29f;  // scores above this are real

__device__ __forceinline__ int score_to_key(float s) {
  const int b = __float_as_int(s);
  return b < 0 ? (b ^ kSignFlip) : b;
}

__device__ __forceinline__ float key_to_score(int key) {
  return __int_as_float(key < 0 ? (key ^ kSignFlip) : key);
}

__device__ __forceinline__ int strip_marks(int idw) {
  return idw >= 0 ? (idw & ~kNewMark) : idw;
}

__device__ __forceinline__ bool is_marked(int idw) {
  return idw >= 0 && (idw & kNewMark) != 0;
}

__device__ __forceinline__ long long pack(int key, int idw) {
  const unsigned long long hi =
      static_cast<unsigned long long>(static_cast<unsigned int>(key)) << 32;
  const unsigned long long lo = static_cast<unsigned int>(idw) ^ 0x80000000u;
  return static_cast<long long>(hi | lo);
}

__device__ __forceinline__ int key_of(long long rec) {
  return static_cast<int>(static_cast<unsigned long long>(rec) >> 32);
}

__device__ __forceinline__ int idw_of(long long rec) {
  return static_cast<int>(static_cast<unsigned int>(rec) ^ 0x80000000u);
}

// the number of records of sorted (descending) v[0, n) above x, or at
// or above x when `or_equal`
__device__ __forceinline__ int count_above(const long long* v, int n,
                                           long long x, bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] > x || (or_equal && v[mid] == x)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// rank v[0, n) into out[0, n) in packed order, equal records by position
// (kThreads threads, no barrier: the caller synchronises after)
template <int kThreads>
__device__ __forceinline__ void rank(const long long* v, long long* out,
                                     int n) {
  for (int x = threadIdx.x; x < n; x += kThreads) {
    const long long a = v[x];
    int pos = 0;
    for (int y = 0; y < n; ++y) {
      const long long o = v[y];
      pos += (o > a) | ((o == a) & (y < x));
    }
    out[pos] = a;
  }
}

// merge the nb survivors cand[0, nb) into the sorted running top-k
// run[0, k) (kThreads threads, nb the same in each, every one past its
// last read of *n_surv; ends with a barrier and leaves *n_surv at 0).
// The survivors are ranked among themselves into bsort (equal ones by
// position); then running lane i lands at i + #{survivors above it} and
// survivor r at r + #{running lanes at or above it}, both by binary
// search, and the ranks below k are the new top-k.  Records are
// totally ordered and equal records are identical, so the bits are any
// exact merge's.
template <int kThreads, class Sync>
__device__ void merge(long long* run, long long* tmp, const long long* cand,
                      long long* bsort, int nb, int* n_surv, int k,
                      Sync sync) {
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    const long long c = cand[j];
    int pos = 0;
#pragma unroll 8
    for (int i = 0; i < nb; ++i) {
      const long long o = cand[i];
      pos += (o > c) | ((o == c) & (i < j));
    }
    bsort[pos] = c;
  }
  sync();
  for (int x = threadIdx.x; x < k + nb; x += kThreads) {
    if (x < k) {
      const long long a = run[x];
      const int pos = x + count_above(bsort, nb, a, false);
      if (pos < k) tmp[pos] = a;
    } else {
      const long long c = bsort[x - k];
      const int pos = x - k + count_above(run, k, c, true);
      if (pos < k) tmp[pos] = c;
    }
  }
  sync();
  for (int i = threadIdx.x; i < k; i += kThreads) run[i] = tmp[i];
  if (threadIdx.x == 0) *n_surv = 0;
  sync();
}

// compaction in thread order over kThreads threads: threads with `found`
// write `value` to out; returns the count in every thread.  Two
// barriers; wsum (kThreads / 32 ints) is read only before the second,
// so calls may follow each other without another barrier.
template <int kThreads, class T, class Sync>
__device__ __forceinline__ int compact(bool found, T value, T* out,
                                       int* wsum, Sync sync) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, found);
  if (lane == 0) wsum[warp] = __popc(m);
  sync();
  int off = 0, n = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    off += w < warp ? wsum[w] : 0;
    n += wsum[w];
  }
  if (found) out[off + __popc(m & ((1u << lane) - 1u))] = value;
  sync();
  return n;
}

}  // namespace packed
