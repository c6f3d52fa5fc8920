// row_topk: per row of a float32 (B, W) matrix, the first k (value,
// position) pairs in the order of core/ivf.py:top_k.
//
// Replaces no TPU kernel.  The reference ranks with lax.top_k, which XLA
// lowers itself; the port's top_k ran a full stable sort of every row
// (torch.sort(descending=True, stable=True), then the first k), which on
// the admission's (a few hundred, 65,536) centroid sims was the largest
// device cost of a serving wave: a segmented radix sort of every column
// and int64 indices for all of them, to keep 80.  The order kept is the
// stable sort's: values descending, NaN above +inf, -0.0 equal to +0.0,
// and equal values by lower position.  The values come back bit for bit
// (read again from the row at each kept position), positions as int32.
//
// Bound on the H100: reading the row once.  B W 4 + B k 8 bytes at 3.35
// TB/s: (512, 65,536) at k 80 is 134 MB, 40 us.
//
// Design.  A record is one signed 64-bit word: the value's order key in
// the high half (packed_sort.cuh's key map, NaN raised to the top key
// and -0.0 folded onto +0.0), and the position word ~pos in the low
// half, so that a larger word is a lower position.  One compare is then
// top_k's order, and records are unique.  One CTA of 256 threads per row:
// - The stream: passes of 2,048 columns, 8 a thread, as 16-byte loads
//   where the row's start and width allow it (kVector), else as coalesced
//   scalar loads; a thread has the next pass's loads in flight while it
//   filters this one (16 columns a thread spilled registers and were no
//   faster on an H100).
// - The filter: a column survives only if its record is strictly above
//   the running k-th (free slots hold a word below every record, so every
//   column passes until k are held).  A pass costs one barrier, a block
//   scan of the threads' survivor counts, after which each thread writes
//   its survivors into a 512-record buffer.  On a row whose order says
//   nothing of its values about k ln(W / k) columns survive (540 of
//   65,536 at k 80), so most passes write a few records or none.
// - The merge, when a pass's survivors would overflow the buffer and once
//   at the end: the buffer is sorted by a bitonic network (45 steps of
//   one compare-exchange a thread at 512 records), then each running and
//   each buffered record finds its rank in the other list by binary
//   search, as packed_sort.cuh's merge places them.  A pass with more
//   survivors than the buffer holds even after a merge (the row's first
//   columns) is compacted 256 columns at a time, merging between, and
//   as soon as k are buffered while the running top-k is not yet full,
//   so that the filter has a k-th early.
// - The k records are written once.
// Shared memory is 8 (2 k + 512) bytes whatever W is.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "packed_sort.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                 // columns of one 16-byte load
constexpr int kPer = 8;                 // columns a thread holds in a pass
constexpr int kPass = kThreads * kPer;  // columns a pass
constexpr int kBuf = 2 * kThreads;      // survivors between merges (a power
                                        // of 2: the bitonic network's size)
constexpr long long kFree = LLONG_MIN;  // no record packs to it

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// top_k's order as one word; the key INT_MIN (a NaN's) never occurs
__device__ __forceinline__ long long record(float x, int pos) {
  const int key =
      isnan(x) ? INT_MAX : packed::score_to_key(x == 0.0f ? 0.0f : x);
  return packed::pack(key, ~pos);
}

// column i of this thread in the pass at c0: 16-byte loads take 4
// neighbouring columns a thread, scalar loads one column a thread in
// each run of 256
template <bool kVector>
__device__ __forceinline__ int column(int c0, int i) {
  return kVector ? c0 + (i / kVec) * (kThreads * kVec) +
                       threadIdx.x * kVec + i % kVec
                 : c0 + i * kThreads + threadIdx.x;
}

// this thread's columns of the pass at c0 (0 past the row's end, where
// the caller masks them)
template <bool kVector>
__device__ __forceinline__ void fetch(float (&v)[kPer], const float* row,
                                      int w, int c0) {
#pragma unroll
  for (int i = 0; i < kPer; i += kVector ? kVec : 1) {
    const int c = column<kVector>(c0, i);
    if (kVector) {
      // w % kVec == 0, so a load lies wholly inside or past the row
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < w) f = __ldg(reinterpret_cast<const float4*>(row + c));
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    } else {
      v[i] = c < w ? __ldg(row + c) : 0.f;
    }
  }
}

// exclusive prefix of x over the block and its total, one barrier; ws
// (kWarps ints) is read after the barrier, so calls alternate two arrays
__device__ __forceinline__ int block_scan(int x, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int u = 0; u < kWarps; ++u) {
    const int s = ws[u];
    before += u < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + incl - x;
}

// merge the nb survivors cand[0, nb) into the sorted running top-k
// run[0, k): cand sorted in place (free words pad it to a power of 2),
// then running lane i lands at i + #{survivors above it} and survivor r
// at r + #{running lanes at or above it}; the ranks below k are the new
// top-k.  Every thread enters with the same nb; ends with a barrier.
__device__ void merge(long long* run, long long* tmp, long long* cand, int nb,
                      int k) {
  int n = 2;
  while (n < nb) n <<= 1;
  for (int t = nb + threadIdx.x; t < n; t += kThreads) cand[t] = kFree;
  __syncthreads();  // also publishes the survivors' writes
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += kThreads) {
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const long long a = cand[lo], b = cand[lo + stride];
        if ((a < b) == ((lo & size) == 0)) {  // descending where bit clear
          cand[lo] = b;
          cand[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  }
  const int nc = min(nb, k);  // survivors ranked k or later cannot land
  for (int x = threadIdx.x; x < k + nc; x += kThreads) {
    if (x < k) {
      const long long a = run[x];
      const int pos = x + packed::count_above(cand, nc, a, false);
      if (pos < k) tmp[pos] = a;
    } else {
      const long long c = cand[x - k];
      const int pos = x - k + packed::count_above(run, k, c, true);
      if (pos < k) tmp[pos] = c;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += kThreads) run[i] = tmp[i];
  __syncthreads();
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
    row_topk_kernel(const float* __restrict__ x, float* __restrict__ out_v,
                    int* __restrict__ out_i, int w, int k) {
  // the running top-k, its merge scratch and the survivors
  extern __shared__ long long smem[];
  long long* run = smem;
  long long* tmp = run + k;
  long long* cand = tmp + k;
  __shared__ int wsum[2][kWarps];  // block_scan's, alternating
  __shared__ int csum[kWarps];     // packed::compact's
  const long long b = blockIdx.x;
  const float* row = x + b * w;

  float v[kPer];
  fetch<kVector>(v, row, w, 0);
  for (int t = threadIdx.x; t < k; t += kThreads) run[t] = kFree;
  __syncthreads();

  int n_surv = 0;  // survivors in the buffer, the same in every thread
  int held = 0;    // records merged into the running top-k (k: full)
  int parity = 0;
  for (int c0 = 0; c0 < w; c0 += kPass) {
    float cv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) cv[i] = v[i];
    if (c0 + kPass < w) fetch<kVector>(v, row, w, c0 + kPass);

    for (bool merged = false;; merged = true) {
      const long long kth = run[k - 1];
      unsigned keep = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = column<kVector>(c0, i);
        keep |= (c < w && record(cv[i], c) > kth) ? 1u << i : 0u;
      }
      int total;
      const int off = block_scan(__popc(keep), wsum[parity], &total);
      parity ^= 1;
      if (n_surv + total <= kBuf) {
        // written after the scan's barrier, published by the next one
        int o = n_surv + off;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (keep >> i & 1u) {
            cand[o++] = record(cv[i], column<kVector>(c0, i));
          }
        }
        n_surv += total;
        break;
      }
      if (n_surv == 0 || merged) {
        // more survivors than the buffer holds: 256 columns at a time,
        // merged as soon as they fill the running top-k (a first k-th
        // to filter by) or could overflow the buffer
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (n_surv + kThreads > kBuf || (held < k && n_surv >= k)) {
            held += n_surv;
            merge(run, tmp, cand, n_surv, k);
            n_surv = 0;
          }
          const int c = column<kVector>(c0, i);
          const long long r = record(cv[i], c);
          const bool in = c < w && r > run[k - 1];
          n_surv += packed::compact<kThreads>(in, r, cand + n_surv, csum,
                                              BlockSync{});
        }
        break;
      }
      held += n_surv;
      merge(run, tmp, cand, n_surv, k);  // then filter again, higher
      n_surv = 0;
    }
  }
  if (n_surv > 0) merge(run, tmp, cand, n_surv, k);
  for (int t = threadIdx.x; t < k; t += kThreads) {
    const int pos = ~packed::idw_of(run[t]);
    out_i[b * k + t] = pos;
    out_v[b * k + t] = row[pos];
  }
}

}  // namespace

// shared memory of one CTA: kernels/row_topk.py:smem_bytes mirrors it
extern "C" int row_topk(const float* x, float* out_v, int* out_i, int B,
                        int w, int k, void* stream) {
  // the wrapper checks 0 < k <= w and that the shared memory fits
  const size_t smem = 8 * (2 * static_cast<size_t>(k) + kBuf);
  const bool vector =
      w % kVec == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  auto kernel = vector ? row_topk_kernel<true> : row_topk_kernel<false>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out_v, out_i, w, k);
  return static_cast<int>(cudaGetLastError());
}
