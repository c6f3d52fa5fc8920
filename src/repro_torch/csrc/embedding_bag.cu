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
// bulk shape (B=262,144, F=39) the ids are 40.9 MB and the output 10.5 MB
// at D=10 (1.0 MB at D=1); the card reads whole 32-byte sectors, so a
// 40-byte row at offset 40 r costs two of them, and Zipf-skewed ids make
// most row reads hit L2.
// Design:
// - Staged ids.  A CTA takes a tile of bags and copies their tile x F ids,
//   contiguous in memory, into shared memory with 16-byte loads (a few
//   4-byte loads at the unaligned ends), so no warp reads ids strided by
//   F.  The tile is as many bags as the CTA has bag lanes (below), fewer
//   when the ids would pass 48 KB; a bag whose F ids alone pass it reads
//   them from global memory.
// - Vector rows.  A bag's row is read by D / W lanes with W-float loads:
//   W = 4 (float4) when D % 4 == 0 and the table is 16-byte aligned, 2
//   (float2, D = 10) when D % 2 == 0 and it is 8-byte aligned, else 1 (one
//   lane a bag at D = 1).
// - Loads in flight.  A lane issues its bag's row loads in batches, a
//   whole batch before its ordered adds, through the read-only path, so
//   Zipf's hot rows stay in L1 and L2: 16 loads a batch for scalar rows,
//   8 for vector rows (on an H100, 16 scalar loads beat 8 at D = 1, and 6
//   to 16 float2 loads tied at D = 10, where more cost registers).
// - Ragged edges: the last tile is masked, and offsets are 64-bit, so
//   B x F may pass 2^31.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// row loads a lane has in flight, by floats a load
template <int W>
constexpr int kBatch = W == 1 ? 16 : 8;
constexpr int kStagedInts = 12 * 1024;  // staged ids of a tile: 48 KB

template <int W>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static void add(T& a, T b) { a += b; }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.0f, 0.0f); }
  __device__ static void add(T& a, T b) {
    a.x += b.x;
    a.y += b.y;
  }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static void add(T& a, T b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};

// copy src[0, n) to dst[p, p + n), p = src's int offset in its 16-byte
// block, so that src's 16-byte-aligned ints land 16-byte aligned; returns
// p (no barrier)
__device__ __forceinline__ int stage(const int* __restrict__ src, int* dst,
                                     long long n) {
  const int p = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const long long head = min(static_cast<long long>((4 - p) & 3), n);
  const long long body = (n - head) >> 2;
  for (long long i = threadIdx.x; i < head; i += kThreads) {
    dst[p + i] = src[i];
  }
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + p + head);
  for (long long i = threadIdx.x; i < body; i += kThreads) {
    d4[i] = __ldg(s4 + i);
  }
  for (long long i = head + 4 * body + threadIdx.x; i < n; i += kThreads) {
    dst[p + i] = src[i];
  }
  return p;
}

template <int W, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const float* __restrict__ table,
                         const int* __restrict__ ids, float* __restrict__ out,
                         int B, int F, int D, int tile) {
  using V = typename Vec<W>::T;
  extern __shared__ __align__(16) int ids_s[];
  const int lanes = D / W;
  const long long b0 = static_cast<long long>(blockIdx.x) * tile;
  const int nb = static_cast<int>(min(static_cast<long long>(tile), B - b0));
  const int* bag_ids = ids + b0 * F;
  if constexpr (kStaged) {
    bag_ids = ids_s + stage(ids + b0 * F, ids_s,
                            static_cast<long long>(nb) * F);
    __syncthreads();
  }
  const V* rows = reinterpret_cast<const V*>(table);
  V* dst = reinterpret_cast<V*>(out);
  for (int item = threadIdx.x; item < nb * lanes; item += kThreads) {
    const int bag = item / lanes;
    const int lane = item - bag * lanes;
    const int* my = bag_ids + static_cast<long long>(bag) * F;
    V acc = Vec<W>::zero();
    for (int f0 = 0; f0 < F; f0 += kBatch<W>) {
      V r[kBatch<W>];
#pragma unroll
      for (int u = 0; u < kBatch<W>; ++u) {
        if (f0 + u < F) {
          const int id = kStaged ? my[f0 + u] : __ldg(my + f0 + u);
          r[u] = __ldg(rows + static_cast<long long>(id) * lanes + lane);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch<W>; ++u) {
        if (f0 + u < F) Vec<W>::add(acc, r[u]);
      }
    }
    dst[(b0 + bag) * lanes + lane] = acc;
  }
}

template <int W>
int launch(const float* table, const int* ids, float* out, int B, int F,
           int D, cudaStream_t stream) {
  const int lanes = D / W;
  int tile = lanes >= kThreads ? 1 : kThreads / lanes;
  if (F > 0) tile = std::min(tile, (kStagedInts - 3) / F);
  const bool staged = tile > 0;
  if (!staged) tile = lanes >= kThreads ? 1 : kThreads / lanes;
  const long long blocks = (static_cast<long long>(B) + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (staged) {
    const size_t smem = (static_cast<size_t>(tile) * F + 3) * sizeof(int);
    embedding_bag_kernel<W, true>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
            table, ids, out, B, F, D, tile);
  } else {
    embedding_bag_kernel<W, false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            table, ids, out, B, F, D, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int embedding_bag(const float* table, const int* ids, float* out,
                             int B, int F, int D, void* stream) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && base % 16 == 0) {
    return launch<4>(table, ids, out, B, F, D, s);
  }
  if (D % 2 == 0 && base % 8 == 0) {
    return launch<2>(table, ids, out, B, F, D, s);
  }
  return launch<1>(table, ids, out, B, F, D, s);
}
