// tau_stage: a learned exit policy's work in one fused wave of the wave
// scheduler (core/serving.py:_tau_stage), between the chunk's scan and the
// slot roll, in one launch.
//
// Replaces no TPU kernel.  The reference runs the stage as jnp under jit
// (src/repro/core/policies.py:225-235: feature_matrix, predict_margin,
// the sigmoid and the threshold), which XLA fuses.  The port ran it as a
// chain of PyTorch ops, 169 launches at the benchmark's wave, each paying
// the host's cost of a launch; kernels/tau_stage.py:tau_stage_plain keeps
// that chain, and this kernel gives its bits.  Per lane, with h its
// probes taken and ok(t) = active && h + t < n_probe for slot t of the
// chunk:
//   RS_1     = the ids of slot 0's snapshot where ok(0) and h == 0;
//   history  column c (probe c + 2) from slot c + 1 - h where that slot
//            lies in the chunk and ok: phi = 100 (k - cnt) / k, and the
//            share of RS_1 kept = 100 |RS_1 ∩ ids| / k, counted as
//            core/ivf.py:intersection_pct counts it (pairs i, j with
//            RS_1[i] == ids[j] and RS_1[i] >= 0);
//   the stage, where active && 0 <= tau - 1 - h < chunk: the Table-1
//            features (core/features.py:feature_matrix) read where they
//            lie, the trees walked max_depth rounds as predict_margin
//            walks them, the leaves summed by its pairwise adds, base
//            added, and lane_cap = tau where 1 / (1 + exp(-margin)) >=
//            the threshold; each such exit adds 1 to clf_exits.
//
// The bits.  Every product, sum and quotient is __fmul_rn, __fadd_rn or
// __fdiv_rn, so that nothing is contracted into an FMA: the chain's ops
// round each step.  phi and the share multiply by the float32
// reciprocal of k, as PyTorch's CUDA true division by a CPU scalar does
// (BinaryDivTrueKernel.cu); a history column is multiplied by 0.01f
// (feature_matrix's "* 0.01"); _guard(x) is x where |x| > 1e-6f, else
// sign(x) * 1e-6f + 1e-6f; -inf and other non-finite scores read 0; the
// sigmoid is PyTorch's CUDA one in float32, 1 / (1 + expf(-margin)).
// predict_margin pads every odd level of its pairwise sum with +0.0;
// that is the pairwise sum over the trees padded with +0.0 to a power
// of two, P, which the block takes level by level in shared memory.
//
// Bound on the H100: the launch.  A wave of the benchmark's cell (1,024
// lanes, chunk 8, k 100, tau 10, 100 trees of depth 6) reads the
// snapshot ids and count of each column it writes (about 4,100 columns:
// 7 for a lane's first wave, 2 for its second), the two scores at tau's
// slot, the lanes' RS_1 and history in and out, the trees' nodes once
// (20 bytes a node) and the features the walks read: about 4 MB, 1.2 us
// at 3.35 TB/s.  The count of RS_1 kept is k x k compares a column:
// 10,000 at k 100, 70,000 for a lane's first wave.
//
// Design.  One block of 128 threads (4 warps) a lane, so that 1,024
// lanes fill the card's SMs.  The block stages the lane's new RS_1 (-1
// entries stored as INT_MIN, which no id equals) and its two history
// rows in shared memory; each warp takes every fourth column the chunk
// writes, every thread keeps up to 4 of the slot's ids in registers
// (-1 entries as INT_MIN + 1) and runs over RS_1 in shared memory
// (broadcast reads), and a shuffle sum gives the count.  At tau each
// thread walks the trees t, t + 128, ... and stores its leaf values;
// the block then adds them in predict_margin's pairs, and its first
// thread decides.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstddef>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kIdsPerThread = 4;          // slot ids a thread compares
constexpr int kNoRs1 = INT_MIN;           // an empty RS_1 entry
constexpr int kNoId = INT_MIN + 1;        // an empty slot id or a pad
constexpr float kEps = 1e-6f;             // feature_matrix's guard
constexpr float kPct = 0.01f;             // its "* 0.01" of a history column

// feature_matrix's where(isfinite(x), x, 0): NaN and +-inf read 0
__device__ __forceinline__ float finite_or_zero(float x) {
  return fabsf(x) <= FLT_MAX ? x : 0.0f;
}

// core/features.py:_guard: a denominator kept off zero
__device__ __forceinline__ float guard(float x) {
  if (fabsf(x) > kEps) return x;
  const float sign = static_cast<float>((0.0f < x) - (x < 0.0f));
  return __fadd_rn(__fmul_rn(sign, kEps), kEps);
}

// 100 * n / k as the chain computes it: two products, the second by 1/k
__device__ __forceinline__ float pct_of_k(int n, float inv_k) {
  return __fmul_rn(__fmul_rn(100.0f, static_cast<float>(n)), inv_k);
}

struct Stage {
  // a wave's inputs
  const float* snap_s;     // (W, chunk, k)
  const int* snap_i;       // (W, chunk, k)
  const int* cnts;         // (W, chunk)
  const int* h;            // (W,)
  const bool* active;      // (W,)
  const float* qvec;       // (W, d)
  const float* csims;      // (W, tau)
  const int* rs1_in;       // (W, k)
  const float* phi_in;     // (W, hist_w)
  const float* phi1_in;    // (W, hist_w)
  const int* cap_in;       // (W,)
  // the trees, (n_trees, n_nodes) each, and base ()
  const int* feat;
  const float* thresh;
  const int* left;
  const int* right;
  const float* value;
  const float* base;
  // outputs; clf_exits is counted in place
  int* rs1_out;
  float* phi_out;
  float* phi1_out;
  int* cap_out;
  unsigned long long* clf_exits;
  int w, chunk, k, d, tau, hist_w, n_probe, n_trees, n_nodes, max_depth;
  int pow2;                // the trees padded to a power of two
  float threshold;
};

__global__ void __launch_bounds__(kThreads) tau_stage_kernel(const Stage s) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, t = tid % 32;
  const int k = s.k, chunk = s.chunk, hist_w = s.hist_w;

  // the lane's shared memory: RS_1 (k), the history rows (phi, then the
  // share of RS_1 kept: the features' own order), the leaf sums (2P)
  extern __shared__ int smem[];
  int* rs1 = smem;
  float* hist = reinterpret_cast<float*>(rs1 + k);
  float* sums = hist + 2 * hist_w;

  const int h = s.h[lane];
  const bool active = s.active[lane];
  const size_t row_k = static_cast<size_t>(lane) * k;
  const size_t row_h = static_cast<size_t>(lane) * hist_w;
  const size_t lane_snap = static_cast<size_t>(lane) * chunk;

  // RS_1 from slot 0's snapshot where the lane merges its first probe
  const int* rs1_src = active && h == 0 && h < s.n_probe
                           ? s.snap_i + lane_snap * k
                           : s.rs1_in + row_k;
  for (int j = tid; j < k; j += kThreads) {
    const int v = rs1_src[j];
    rs1[j] = v >= 0 ? v : kNoRs1;
    s.rs1_out[row_k + j] = v;
  }
  for (int c = tid; c < hist_w; c += kThreads) {
    hist[c] = s.phi_in[row_h + c];
    hist[hist_w + c] = s.phi1_in[row_h + c];
  }
  __syncthreads();

  if (s.tau > 1 && active) {
    const float inv_k = __fdiv_rn(1.0f, static_cast<float>(k));
    // column c holds probe c + 2 (0-based c + 1), merged at slot c + 1 - h
    // of this chunk if that slot lies in it and inside the probe budget
    const int c_end = min(min(hist_w, h - 1 + chunk), s.n_probe - 1);
    for (int c = max(h - 1, 0) + warp; c < c_end; c += kWarps) {
      const int slot = c + 1 - h;
      const int* ids = s.snap_i + (lane_snap + slot) * k;
      int n = 0;
      for (int j0 = 0; j0 < k; j0 += 32 * kIdsPerThread) {
        int mine[kIdsPerThread];
#pragma unroll
        for (int m = 0; m < kIdsPerThread; ++m) {
          const int j = j0 + 32 * m + t;
          const int v = j < k ? ids[j] : -1;
          mine[m] = v >= 0 ? v : kNoId;
        }
#pragma unroll 4
        for (int i = 0; i < k; ++i) {
          const int r = rs1[i];
#pragma unroll
          for (int m = 0; m < kIdsPerThread; ++m) n += r == mine[m];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        n += __shfl_xor_sync(0xffffffffu, n, off);
      if (t == 0) {
        hist[c] = pct_of_k(k - s.cnts[lane_snap + slot], inv_k);
        hist[hist_w + c] = pct_of_k(n, inv_k);
      }
    }
    __syncthreads();
  }
  for (int c = tid; c < hist_w; c += kThreads) {
    s.phi_out[row_h + c] = hist[c];
    s.phi1_out[row_h + c] = hist[hist_w + c];
  }

  const int t_tau = s.tau - 1 - h;
  int cap = s.cap_in[lane];
  if (active && t_tau >= 0 && t_tau < chunk) {
    // groups 1-3 of the Table-1 features; group 4 is hist, times 0.01
    const float* scores = s.snap_s + (lane_snap + t_tau) * k;
    const float s1 = finite_or_zero(scores[0]);
    const float sk = finite_or_zero(scores[k - 1]);
    const float r_1k = __fdiv_rn(s1, guard(sk));
    const float* cs = s.csims + static_cast<size_t>(lane) * s.tau;
    const float r_1c = __fdiv_rn(s1, guard(cs[0]));
    const float* q = s.qvec + static_cast<size_t>(lane) * s.d;

    for (int tree = tid; tree < s.pow2; tree += kThreads) {
      float leaf = 0.0f;  // predict_margin's pads are +0.0
      if (tree < s.n_trees) {
        const size_t at = static_cast<size_t>(tree) * s.n_nodes;
        int node = 0;
        for (int round = 0; round < s.max_depth; ++round) {
          int f = s.feat[at + node];
          if (f < 0) break;  // a leaf loops to itself
          float x;
          if (f < s.d) {
            x = q[f];
          } else if ((f -= s.d) < s.tau) {
            x = cs[f];
          } else if ((f -= s.tau) < 4) {
            x = f == 0 ? s1 : f == 1 ? sk : f == 2 ? r_1k : r_1c;
          } else {
            x = __fmul_rn(hist[f - 4], kPct);
          }
          node = x <= s.thresh[at + node] ? s.left[at + node]
                                          : s.right[at + node];
        }
        leaf = s.value[at + node];
      }
      sums[tree] = leaf;
    }
    __syncthreads();
    // predict_margin's pairwise sum, level by level, between two halves
    float* src = sums;
    float* dst = sums + s.pow2;
    for (int width = s.pow2 / 2; width > 0; width /= 2) {
      for (int i = tid; i < width; i += kThreads)
        dst[i] = __fadd_rn(src[2 * i], src[2 * i + 1]);
      __syncthreads();
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
    if (tid == 0) {
      const float margin = __fadd_rn(src[0], s.base[0]);
      const float p_exit =
          __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-margin)));
      if (p_exit >= s.threshold) {
        cap = s.tau;
        atomicAdd(s.clf_exits, 1ull);
      }
    }
  }
  if (tid == 0) s.cap_out[lane] = cap;
}

}  // namespace

// The wrapper checks every shape, the knobs (k, chunk, tau, n_probe,
// n_trees, n_nodes > 0, max_depth >= 0) and that the shared memory fits.
extern "C" int tau_stage(
    const float* snap_s, const int* snap_i, const int* cnts, const int* h,
    const bool* active, const float* qvec, const float* csims,
    const int* rs1_in, const float* phi_in, const float* phi1_in,
    const int* cap_in, const int* feat, const float* thresh, const int* left,
    const int* right, const float* value, const float* base, int* rs1_out,
    float* phi_out, float* phi1_out, int* cap_out, long long* clf_exits,
    int w, int chunk, int k, int d, int tau, int n_probe, int n_trees,
    int n_nodes, int max_depth, float threshold, void* stream) {
  int pow2 = 1;
  while (pow2 < n_trees) pow2 *= 2;
  const int hist_w = tau > 1 ? tau - 1 : 1;
  const Stage s{snap_s, snap_i, cnts, h, active, qvec, csims, rs1_in,
                phi_in, phi1_in, cap_in, feat, thresh, left, right, value,
                base, rs1_out, phi_out, phi1_out, cap_out,
                reinterpret_cast<unsigned long long*>(clf_exits), w, chunk,
                k, d, tau, hist_w, n_probe, n_trees, n_nodes, max_depth,
                pow2, threshold};
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(k) + 2 * hist_w + 2 * pow2);
  const cudaError_t set = cudaFuncSetAttribute(
      tau_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  tau_stage_kernel<<<w, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}
