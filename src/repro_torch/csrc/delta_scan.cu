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
//
// Design: register tiling in row_dot's order.  A CTA of 8 warps owns 32
// queries x 32 slots; each warp an 8 x 16 tile, 128 sums a lane.  Lane l
// takes elements c = l, l+32, ... of every sum in that order (row_dot's
// lane-strided FMA chain), so at each c it reads 8 query and 16 row
// elements from shared memory for 128 FMAs.  One CTA an SM walks its
// tiles as one stream of 128-float chunks of d, staged by cp.async into
// a five-stage ring that runs four chunks ahead, across tiles too.  The
// 32 partials of each sum are then added by a reduce-scatter XOR
// butterfly: at stage o (16, 8, 4, 2, 1) a lane keeps half of its sums
// and adds its partner's copy of them.  That is each of row_dot's
// butterfly additions, in the same tree (float addition is commutative,
// so which lane adds does not matter), in 124 shuffles for 128 sums
// instead of 640; lane l ends holding sums 4l .. 4l + 3.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 8;                // queries per warp tile
constexpr int kTileS = 16;               // slots per warp tile
constexpr int kWarpsQ = 4;
constexpr int kWarpsS = 2;
constexpr int kThreads = kWarpsQ * kWarpsS * 32;
constexpr int kCtaQ = kTileQ * kWarpsQ;  // 32 queries per CTA
constexpr int kCtaS = kTileS * kWarpsS;  // 32 slots per CTA
constexpr int kRows = kCtaQ + kCtaS;     // staged rows: queries, then slots
constexpr int kChunk = 128;              // floats of d per stage
constexpr int kStages = 5;
constexpr int kSmemBytes = kStages * kRows * kChunk * 4;

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int n_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(n_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int n_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(n_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// one stage: rows [0, kCtaQ) are queries b0.., the rest slots s0..;
// elements [c0, c0 + kChunk) of each, zeros past B, cap or d; by 16-byte
// copies when every row starts 16-byte aligned (kVec), else 4-byte ones.
// A pass of the CTA copies kThreads / kPerRow whole rows.
template <bool kVec>
__device__ __forceinline__ void load_stage(uint32_t dst, const float* q,
                                           const float* vecs, int b0, int s0,
                                           int B, int cap, int d, int c0) {
  constexpr int kWidth = kVec ? 4 : 1;
  constexpr int kPerRow = kChunk / kWidth;
  constexpr int kRowsPerPass = kThreads / kPerRow;
  static_assert(kThreads % kPerRow == 0 && kCtaQ % kRowsPerPass == 0 &&
                    kCtaS % kRowsPerPass == 0,
                "a pass copies whole rows of one kind");
  const int r0 = threadIdx.x / kPerRow;
  const int w = (threadIdx.x % kPerRow) * kWidth;
  const int c = c0 + w;
#pragma unroll
  for (int p = 0; p < kRows / kRowsPerPass; ++p) {
    const bool is_q = p * kRowsPerPass < kCtaQ;  // known once unrolled
    const int r = r0 + p * kRowsPerPass;
    const int row = is_q ? b0 + r : s0 + r - kCtaQ;
    const bool in = row < (is_q ? B : cap) && c < d;
    // an empty copy (0 source bytes) still names a valid address
    const float* src =
        in ? (is_q ? q : vecs) + static_cast<long long>(row) * d + c : q;
    const uint32_t at = dst + (r * kChunk + w) * 4;
    if (kVec)
      cp_async16(at, src, in ? 16 : 0);
    else
      cp_async4(at, src, in ? 4 : 0);
  }
}

// the reduce-scatter step of stage ``o``: N sums in, N / 2 out
template <int N>
__device__ __forceinline__ void scatter_half(float* v, int o, int lane) {
  const bool hi = lane & o;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float send = hi ? v[k] : v[k + N / 2];
    const float keep = hi ? v[k + N / 2] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// one chunk into the tile's sums: step i (element c0 + 32 i + lane) of
// every sum before step i + 1, as row_dot; kRagged guards c < d
template <bool kRagged>
__device__ __forceinline__ void chunk_fma(const float* qs, const float* xs,
                                          float* acc, int c0, int d,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < kChunk / 32; ++i) {
    if (kRagged && c0 + 32 * i + lane >= d) break;
    float qv[kTileQ], xv[kTileS];
#pragma unroll
    for (int a = 0; a < kTileQ; ++a) qv[a] = qs[a * kChunk + 32 * i];
#pragma unroll
    for (int b = 0; b < kTileS; ++b) xv[b] = xs[b * kChunk + 32 * i];
#pragma unroll
    for (int a = 0; a < kTileQ; ++a)
#pragma unroll
      for (int b = 0; b < kTileS; ++b)
        acc[a * kTileS + b] = fmaf(qv[a], xv[b], acc[a * kTileS + b]);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    delta_scan_kernel(const float* __restrict__ q,
                      const float* __restrict__ vecs, float* __restrict__ out,
                      int B, int cap, int d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wq = warp / kWarpsS;  // this warp's query tile
  const int ws = warp % kWarpsS;  // and slot tile
  const int n_chunks = (d + kChunk - 1) / kChunk;
  const int tiles_s = (cap + kCtaS - 1) / kCtaS;
  const int n_tiles = tiles_s * ((B + kCtaQ - 1) / kCtaQ);
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  constexpr int kStageFloats = kRows * kChunk;
  // this CTA's tiles are blockIdx.x, + gridDim.x, ...: one stream of
  // (tile, chunk) steps, so the ring runs ahead across tile boundaries;
  // the loader walks it kStages - 1 steps ahead of the compute
  int l_tile = blockIdx.x, l_ch = 0, l_stage = 0;
  auto prefetch = [&]() {
    if (l_tile < n_tiles) {
      load_stage<kVec>(ring + l_stage * kStageFloats * 4, q, vecs,
                       (l_tile / tiles_s) * kCtaQ, (l_tile % tiles_s) * kCtaS,
                       B, cap, d, l_ch * kChunk);
      if (++l_ch == n_chunks) {
        l_ch = 0;
        l_tile += gridDim.x;
      }
      l_stage = l_stage + 1 == kStages ? 0 : l_stage + 1;
    }
    cp_commit();
  };

#pragma unroll
  for (int f = 0; f < kStages - 1; ++f) prefetch();

  constexpr int kSums = kTileQ * kTileS;
  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;

  int stage = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int ch = 0; ch < n_chunks; ++ch) {
      cp_wait<kStages - 2>();  // this step has landed
      __syncthreads();         // and every warp is done with the last one
      prefetch();
      const float* at = smem + stage * kStageFloats + lane;
      const float* qs = at + wq * kTileQ * kChunk;
      const float* xs = at + (kCtaQ + ws * kTileS) * kChunk;
      if ((ch + 1) * kChunk <= d)
        chunk_fma<false>(qs, xs, acc, ch * kChunk, d, lane);
      else
        chunk_fma<true>(qs, xs, acc, ch * kChunk, d, lane);
      stage = stage + 1 == kStages ? 0 : stage + 1;
    }
    // row_dot's butterfly, o = 16, 8, 4, 2, 1, scattering as it goes
    scatter_half<kSums>(acc, 16, lane);
    scatter_half<kSums / 2>(acc, 8, lane);
    scatter_half<kSums / 4>(acc, 4, lane);
    scatter_half<kSums / 8>(acc, 2, lane);
    scatter_half<kSums / 16>(acc, 1, lane);
    // acc[t] is sum kPer * lane + t of the tile (query-major)
    constexpr int kPer = kSums / 32;
    const int b = (tile / tiles_s) * kCtaQ + wq * kTileQ + kPer * lane / kTileS;
    const int s = (tile % tiles_s) * kCtaS + ws * kTileS + kPer * lane % kTileS;
    if (b < B) {
      float* dst = out + static_cast<long long>(b) * cap + s;
#pragma unroll
      for (int t = 0; t < kPer; ++t)
        if (s + t < cap) dst[t] = acc[t];
    }
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
  }
  cp_wait<0>();
}

// the SMs of the current device, 0 if it cannot be read
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

}  // namespace

extern "C" int delta_scan(const float* q, const float* vecs, float* out, int B,
                          int cap, int d, void* stream) {
  const int n_tiles = ((cap + kCtaS - 1) / kCtaS) * ((B + kCtaQ - 1) / kCtaQ);
  const int n_sm = sm_count();
  if (n_sm == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = n_tiles < n_sm ? n_tiles : n_sm;  // one CTA an SM
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vecs) % 16 == 0;
  const auto kernel = vec ? delta_scan_kernel<true> : delta_scan_kernel<false>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q, vecs, out, B, cap, d);
  return static_cast<int>(cudaGetLastError());
}
