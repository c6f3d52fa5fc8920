// flash_attention: online-softmax attention over streamed KV tiles.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (Pallas,
// TPU): q, k, v (BH, S, hd) -> o (BH, S, hd) in q's type,
// o = softmax(q k^T / sqrt(hd) [causal-masked with -1e30]) v, computed
// in f32 inside, with the running max m, the running sum l and the
// accumulator carried over KV tiles and o = acc / max(l, 1e-30).  Unlike
// the Pallas kernel (which asserts S % blk == 0) any S is taken: keys
// past S score -1e30, query rows past S are computed and not written.
//
// Bound on the H100: operations.  At the StarCoder2-3B prefill (bf16,
// BH = 96, S = 2,048, hd = 128, causal) the work is
// 4 * BH * hd * S(S+1)/2 = 103 GFLOP against 201 MB of q, k, v and o:
// 0.104 ms at the bf16 tensor-core peak, 1.54 ms at the 67 TFLOP/s of f32
// outside the tensor cores, 0.060 ms by bytes.  This first kernel computes
// in f32 on the CUDA cores, so its own ceiling is the f32 figure; the
// tensor-core route (mma/wgmma on bf16 tiles, P in bf16) is later work.
// Design: one CTA of 256 threads per (bh, 64-row query tile); the query
// tile stays in shared memory, transposed (d-major), for the whole KV
// walk; each 64-key tile of K (transposed) and V is staged in shared
// memory as f32.  A thread owns a 4 x 4 block of the 64 x 64 score tile
// (float4 reads of Q and K per d: 16 FMAs for two shared loads) and
// 4 rows x hd/16 columns of the accumulator; the 16 threads of a row
// reduce max and sum with shuffles, and m, l, acc live in registers.
// P goes through shared memory (aliasing the K tile) into P V.  KV tiles
// past the diagonal are skipped when causal, and the heaviest query tiles
// are scheduled first.  About 100 KB of shared memory at hd = 128 leaves
// two CTAs per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // keys per KV tile
constexpr int kPad = 4;         // keeps float4 alignment, breaks bank runs
constexpr int kQS = kBQ + kPad;  // row stride of Qt (d-major)
constexpr int kKS = kBK + kPad;  // row stride of Kt (d-major)
constexpr int kPS = kBQ + kPad;  // row stride of Pt (key-major)
constexpr int kThreads = 256;    // 16 x 16: ty owns rows, tx owns columns
constexpr float kNeg = -1e30f;   // the Pallas kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr int smem_floats() {
  return HD * kQS + (HD * kKS > kBK * kPS ? HD * kKS : kBK * kPS) + kBK * HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int causal) {
  static_assert(HD % 64 == 0, "hd must be a multiple of 64");
  constexpr int kH = HD / 64;  // float4 column groups a thread owns
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;             // [HD][kQS]
  float* kt = qt + HD * kQS;    // [HD][kKS], later Pt [kBK][kPS]
  float* pt = kt;
  float* vs = kt + (HD * kKS > kBK * kPS ? HD * kKS : kBK * kPS);  // [kBK][HD]

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int q0 = qi * kBQ;
  const long long base = static_cast<long long>(blockIdx.y) * S * HD;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  // the Pallas kernel's scale: f32(1 / sqrt(hd)) from a double
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    qt[d * kQS + r] =
        q0 + r < S ? to_f32(q[base + static_cast<long long>(q0 + r) * HD + d])
                   : 0.0f;
  }

  float m[4], l[4], acc[4][4 * kH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kH; ++c) acc[i][c] = 0.0f;
  }

  const int n_kv = (S + kBK - 1) / kBK;
  const int last = causal ? min(n_kv - 1, (q0 + kBQ - 1) / kBK) : n_kv - 1;
  for (int j = 0; j <= last; ++j) {
    const int k0 = j * kBK;
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e - r * HD;
      const bool in = k0 + r < S;
      const long long g = base + static_cast<long long>(k0 + r) * HD + d;
      kt[d * kKS + r] = in ? to_f32(k[g]) : 0.0f;
      vs[r * HD + d] = in ? to_f32(v[g]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * kQS + 4 * ty);
      const float4 kv = *reinterpret_cast<const float4*>(kt + d * kKS + 4 * tx);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qa[i], ka[c], s[i][c]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 4 * tx + c;
        float x = s[i][c] * scale;
        if (key >= S || (causal && key > row)) x = kNeg;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[i][c] = expf(s[i][c] - m_new);
        rs += p[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kH; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done with Kt: P takes its place
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt + (4 * tx + c) * kPS + 4 * ty) =
          make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + key * kPS + 4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + key * HD + 64 * h + 4 * tx);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][4 * h + c] = fmaf(pa[i], va[c], acc[i][4 * h + c]);
      }
    }
    __syncthreads();  // before the next tile overwrites Kt/Pt and V
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = o + base + static_cast<long long>(row) * HD;
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store(dst + 64 * h + 4 * tx + c, acc[i][4 * h + c] / denom);
  }
}

template <typename T, int HD>
int launch(const T* q, const T* k, const T* v, T* o, int BH, int S,
           int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(q, k, v, o,
                                                                 S, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int BH, int S, int hd,
             int causal, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<T, 64>(q, k, v, o, BH, S, causal, st);
  if (hd == 128) return launch<T, 128>(q, k, v, o, BH, S, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int BH, int S,
                                   int hd, int causal, void* stream) {
  return dispatch(q, k, v, o, BH, S, hd, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int BH, int S,
                                    int hd, int causal, void* stream) {
  using B = __nv_bfloat16;
  return dispatch(static_cast<const B*>(q), static_cast<const B*>(k),
                  static_cast<const B*>(v), static_cast<B*>(o), BH, S, hd,
                  causal, stream);
}
