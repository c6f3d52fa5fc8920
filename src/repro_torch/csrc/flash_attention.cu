// flash_attention: online-softmax attention over streamed KV tiles.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (Pallas,
// TPU): q, k (BH, S, dqk), v (BH, S, dv) -> o (BH, S, dv) in q's type,
// o = softmax(q k^T / sqrt(dqk) [causal-masked with -1e30]) v, with the
// running max m, the running sum l and the accumulator carried over KV
// tiles in f32 and o = acc / max(l, 1e-30).  Unlike the Pallas kernel
// (which asserts S % blk == 0) any S is taken: keys past S score -1e30,
// query rows past S are computed and not written.  (dqk, dv) is (64, 64)
// or (128, 128), and in bf16 also (96, 64): MLA's heads (MiniCPM3-4B,
// 64 nope + 32 rope dims for q and k, 64 for v), as the JAX model's
// chunked attention takes them.
//
// Bound on the H100: operations.  At the StarCoder2-3B prefill (bf16,
// BH = 96, S = 2,048, hd = 128, causal) the work is
// 4 * BH * hd * S(S+1)/2 = 103 GFLOP against 201 MB of q, k, v and o:
// 0.104 ms at the bf16 tensor-core peak, 0.060 ms by bytes; at
// MiniCPM3's (BH = 160, S = 2,048, (96, 64)) 2 * BH * (96 + 64) *
// S(S+1)/2 = 107 GFLOP against 210 MB: 0.109 ms against 0.063 ms.
//
// Two kernels, one per input type.
//
// bf16 (the model's path) runs both products on the tensor cores.  One
// CTA per (bh, 128-row query tile), the heaviest causal tiles first: two
// consumer warpgroups, each owning 64 query rows, and a producer
// warpgroup that gives its registers to them (setmaxnreg).
// The producer loads the Q tile once and streams 128-key K and V tiles
// into a two-stage ring by TMA (cp.async.bulk.tensor over the 3-D
// (BH, S, hd) tensor, 128-byte swizzle, full/empty mbarrier pairs); rows
// past S come back as zeros and never read the next head.  A consumer
// computes S = Q K^T with wgmma from shared memory into f32 registers,
// scales, masks and takes the online softmax in registers (row max and
// sum across the quad that shares a row), rounds P to bf16 in the
// accumulator's own layout, which is wgmma's register A-operand layout,
// and accumulates P V with wgmma (A from registers, V as an MN-major B
// from shared memory).  P is rounded to bf16 before P V, as the JAX
// model's attention does (p.astype(v.dtype)); l sums the f32 P.
// Q K^T takes dqk / 16 k16 steps and P V an N of dv.  A 96-column q or
// k row is loaded as two 64-column boxes, the second reading columns
// 96-127 past the tensor's edge: TMA fills them with zeros, which the
// k16 steps never read (6 of the 8 the two boxes hold).  The one box
// width keeps the one 128-byte swizzle and its wgmma descriptors; a
// 32-column box would need a 64-byte swizzle and descriptors of its own,
// for 16 KB of shared memory per tile saved.
//
// f32 stays on the CUDA cores (no TF32): one CTA of 256 threads per
// (bh, 64-row query tile); the query tile stays in shared memory,
// transposed, for the whole KV walk; each 64-key tile of K (transposed)
// and V is staged as f32.  A thread owns a 4 x 4 block of the 64 x 64
// score tile and 4 rows x hd/16 columns of the accumulator; P goes
// through shared memory (aliasing the K tile) into P V.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // the Pallas kernel's mask value

// -- f32: CUDA cores ----------------------------------------------------------

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per KV tile
constexpr int kPad = 4;          // keeps float4 alignment, breaks bank runs
constexpr int kQS = kBQ + kPad;  // row stride of Qt (d-major)
constexpr int kKS = kBK + kPad;  // row stride of Kt (d-major)
constexpr int kPS = kBQ + kPad;  // row stride of Pt (key-major)
constexpr int kThreads = 256;    // 16 x 16: ty owns rows, tx owns columns

template <int HD>
constexpr int smem_floats() {
  return HD * kQS + (HD * kKS > kBK * kPS ? HD * kKS : kBK * kPS) + kBK * HD;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int S, int causal) {
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
        q0 + r < S ? q[base + static_cast<long long>(q0 + r) * HD + d] : 0.0f;
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
      kt[d * kKS + r] = in ? k[g] : 0.0f;
      vs[r * HD + d] = in ? v[g] : 0.0f;
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
    float* dst = o + base + static_cast<long long>(row) * HD;
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dst[64 * h + 4 * tx + c] = acc[i][4 * h + c] / denom;
  }
}

template <int HD>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int BH, int S, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(q, k, v, o, S,
                                                               causal);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16: wgmma tensor cores fed by TMA ------------------------------------

constexpr int kTM = 128;        // query rows per CTA: two warpgroups x 64
constexpr int kTN = 128;        // keys per KV tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kConsumerWarps = 8;
// + a producer warpgroup: setmaxnreg moves registers between whole
// warpgroups, and a lone ninth warp would leave 168 a thread
constexpr int kTcThreads = kConsumerWarps * 32 + 128;
constexpr int kProducerRegs = 24;   // 24 + 2 x 240 = 504 of 512 a lane
constexpr int kConsumerRegs = 240;
constexpr int kBox = 64;        // columns per TMA box: 128 bytes, the swizzle
constexpr int kBoxBytes = 128 * kBox * 2;  // one box of 128 rows: 16 KB
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: the Q tile, then kStages x (K tile, V tile), a Q or K
// tile ceil(DQK / 64) boxes and a V tile DV / 64 boxes of [128 rows][64
// columns] bf16, 128-byte swizzled; then the barriers.  1 KB of slack
// aligns the tiles to the swizzle atom.
template <int DQK, int DV>
struct TcSmem {
  static constexpr int kQKBoxes = (DQK + kBox - 1) / kBox;
  static constexpr int kVBoxes = DV / kBox;
  static constexpr int kQKTile = kQKBoxes * kBoxBytes;
  static constexpr int kVTile = kVBoxes * kBoxBytes;
  static constexpr int kStage = kQKTile + kVTile;         // K tile, V tile
  static constexpr int kKV = kQKTile;                     // stage 0's K
  static constexpr int kBar = kKV + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 3-D tensor map at (column c0, row c1, head c2)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4), layout type 1 at bit 62
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_F8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_F32(d) FA_F8(d, 0), FA_F8(d, 8), FA_F8(d, 16), FA_F8(d, 24)
#define FA_F64(d) \
  FA_F32(d), FA_F8(d, 32), FA_F8(d, 40), FA_F8(d, 48), FA_F8(d, 56)
#define FA_D32                                                           \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18," \
  "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
#define FA_D64                                                           \
  FA_D32 ",%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46," \
         "%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,"  \
         "%62,%63"

// S(64 x 128) (+)= A(64 x 16, K-major smem) B(16 x 128, K-major smem)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64
      "}, %64, %65, p, 1, 1, 0, 0;\n}"
      : FA_F64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// O(64 x N) += A(64 x 16, registers) B(16 x N, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : FA_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : FA_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x, denormal results flushed to 0: P is at most 1, so such a term is
// below 2^-126 of the row's largest
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o, int S,
                                int causal) {
  static_assert(DQK % 16 == 0 && (DV == 64 || DV == 128),
                "dqk a multiple of 16; dv 64 or 128");
  using L = TcSmem<DQK, DV>;
  constexpr int kKSteps = DQK / 16;  // k16 steps of Q K^T
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t bar = base + L::kBar;  // full[s], empty[s], then q
  auto s_k = [&](int st) { return base + L::kKV + st * L::kStage; };
  auto full = [&](int st) { return bar + 8 * st; };
  auto empty = [&](int st) { return bar + 8 * (kStages + st); };
  const uint32_t q_bar = bar + 8 * 2 * kStages;

  const int bh = blockIdx.x;
  const int n_q = (S + kTM - 1) / kTM;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * kTM;  // heaviest first
  const int n_kv = (S + kTN - 1) / kTN;
  const int last = causal ? min(n_kv - 1, (q0 + kTM - 1) / kTN) : n_kv - 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer: one thread loads by TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      // a box's bytes count in full, its zero-filled part too
      mbar_expect_tx(q_bar, L::kQKTile);
      for (int c = 0; c < L::kQKBoxes; ++c)
        tma_load(s_q + c * kBoxBytes, &tq, q_bar, c * kBox, q0, bh);
      for (int j = 0; j <= last; ++j) {
        const int st = j % kStages;
        mbar_wait(empty(st), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), L::kStage);
        for (int c = 0; c < L::kQKBoxes; ++c)
          tma_load(s_k(st) + c * kBoxBytes, &tk, full(st), c * kBox, j * kTN,
                   bh);
        for (int c = 0; c < L::kVBoxes; ++c)
          tma_load(s_k(st) + L::kQKTile + c * kBoxBytes, &tv, full(st),
                   c * kBox, j * kTN, bh);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows; this thread holds rows r and r+8
  // of its warp's 16 in every 8-column chunk of S and O
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int row_a = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  const int col = 2 * (lane & 3);
  // the Pallas kernel's scale, f32(1 / sqrt(dqk)), times log2(e) for exp2
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(DQK))) * kLog2e;
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.0f, l_b = 0.0f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j <= last; ++j) {
    const int st = j % kStages;
    mbar_wait(full(st), (j / kStages) & 1);
    const uint32_t k_tile = s_k(st);
    const uint32_t v_tile = k_tile + L::kQKTile;

    float s[64];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      // K-major: k16 step kk is 32 bytes into box kk / 4
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss_n128(s, sw128_desc(s_q + off + wg * 64 * 128, 16, 1024),
                    sw128_desc(k_tile + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // mask, online softmax in the exp2 domain (m is scaled, s is not);
    // s[4c + e] is (row e < 2 ? a : b, key k0 + 8c + col + (e & 1))
    const int k0 = j * kTN;
    const bool edge =
        k0 + kTN > S || (causal && k0 + kTN - 1 > q0 + wg * 64 + (warp & 3) * 16);
    float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (edge) {
        const int key = k0 + 8 * (i >> 2) + col + (i & 1);
        const int row = (i & 2) ? row_b : row_a;
        if (key >= S || (causal && key > row)) s[i] = kNeg;
      }
      if (i & 2)
        mx_b = fmaxf(mx_b, s[i]);
      else
        mx_a = fmaxf(mx_a, s[i]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * scale);
    const float mn_b = fmaxf(m_b, mx_b * scale);
    const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.0f, rs_b = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float p = ex2(fmaf(s[i], scale, (i & 2) ? -mn_b : -mn_a));
      s[i] = p;
      if (i & 2)
        rs_b += p;
      else
        rs_a += p;
    }
    // l is this thread's share of the row sum: the quad adds at the end
    l_a = l_a * al_a + rs_a;
    l_b = l_b * al_b + rs_b;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= (i & 2) ? al_b : al_a;

    // P in bf16: S's chunk pair (2kk, 2kk + 1) is the A fragment of k16
    // step kk (rows a, b x keys col, col + 8)
    uint32_t pa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTN / 16; ++kk)
      // MN-major V: k16 step kk is 16 rows of 128 bytes down; the
      // 64-column boxes are a box apart (LBO), 8-row groups 1 KB (SBO)
      wgmma_rs(acc, pa + 4 * kk,
               sw128_desc(v_tile + kk * 16 * 128, kBoxBytes, 1024));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  const long long head = static_cast<long long>(bh) * S;
#pragma unroll
  for (int c = 0; c < DV / 8; ++c) {
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + (head + row_a) * DV + 8 * c + col) =
          __floats2bfloat162_rn(acc[4 * c] / den_a, acc[4 * c + 1] / den_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + (head + row_b) * DV + 8 * c + col) =
          __floats2bfloat162_rn(acc[4 * c + 2] / den_b,
                                acc[4 * c + 3] / den_b);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (the
// library does not link libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (BH, S, HD) bf16 tensor as boxes of 128 rows x 64 columns of one head,
// 128-byte swizzled; rows past S and columns past HD read as zeros (the
// row stride, 2 HD bytes, must be a multiple of 16: HD % 8 == 0)
bool make_map(CUtensorMap* map, const void* ptr, int BH, int S, int HD) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(S) * HD * 2};
  const cuuint32_t box[3] = {kBox, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                int S, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, BH, S, DQK) || !make_map(&tk, k, BH, S, DQK) ||
      !make_map(&tv, v, BH, S, DV))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = TcSmem<DQK, DV>::kBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(BH, (S + kTM - 1) / kTM);
  flash_attention_bf16_kernel<DQK, DV><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int BH, int S,
                                   int dqk, int dv, int causal,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dqk != dv) return static_cast<int>(cudaErrorInvalidValue);
  if (dqk == 64) return launch_f32<64>(q, k, v, o, BH, S, causal, st);
  if (dqk == 128) return launch_f32<128>(q, k, v, o, BH, S, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int BH, int S,
                                    int dqk, int dv, int causal,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dqk == 64 && dv == 64)
    return launch_bf16<64, 64>(q, k, v, o, BH, S, causal, st);
  if (dqk == 128 && dv == 128)
    return launch_bf16<128, 128>(q, k, v, o, BH, S, causal, st);
  if (dqk == 96 && dv == 64)
    return launch_bf16<96, 64>(q, k, v, o, BH, S, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
