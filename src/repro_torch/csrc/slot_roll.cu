// slot_roll: the fused advance's roll of a wave's lane state through the
// chunk's per-probe snapshots (core/serving.py:_advance), in one launch.
//
// Replaces no TPU kernel.  The reference rolls with jnp ops
// (src/repro/core/serving.py:141-180), which XLA fuses under jit; the
// port ran the same chain as PyTorch ops, some twenty a probe slot, ~190
// launches a wave of 8 slots, each paying the host's cost of a launch.
// kernels/slot_roll.py:slot_roll_plain keeps that chain, and this kernel
// gives its bits.  Per lane, at each slot t while the lane is active:
//   phi_v    = 100 * (k - cnt[t]) / k
//   patience = (h >= 1 && phi_v >= phi) ? patience + 1 : 0
//   h       += 1
//   the lane exits when patience >= lane_delta and h >= min_probes (a
//   cascade's tau; 1 gates nothing), or when h >= lane_cap;
// at a slot where the lane is inactive its patience reads 0 and h stays.
// The top-k is the snapshot of the last slot at which the lane was
// active, or the carried one if it was inactive at the wave's top.
//
// phi_v's bits: on the card the chain computes 100.0 * float(k - cnt) /
// k, and PyTorch's CUDA true division by a CPU scalar multiplies by the
// float32 reciprocal 1.0f / k (BinaryDivTrueKernel.cu) instead of
// dividing.  The kernel makes the same float32 operations in the same
// order, the products by __fmul_rn so that nothing is contracted.
//
// Bound on the H100: the launch.  It moves W (4 chunk + 26 + 16 k) bytes,
// most of them the exit slot's k scores and ids read and written: 1.7 MB
// at W 1,024, chunk 8 and k 100, 0.5 us at 3.35 TB/s.
//
// Design.  One warp a lane, 8 lanes a block of 256 threads.  Every
// thread of the warp walks the lane's chunk counts in registers (the
// same words: broadcast loads) and so knows the exit slot; the warp then
// copies that slot's k scores and ids, 32 consecutive words a load, and
// its first thread writes h, patience and active.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanesPerBlock = 8;
constexpr int kThreads = 32 * kLanesPerBlock;

__global__ void __launch_bounds__(kThreads) slot_roll_kernel(
    const float* __restrict__ snap_s, const int* __restrict__ snap_i,
    const int* __restrict__ cnts, const int* __restrict__ h_in,
    const int* __restrict__ patience_in, const bool* __restrict__ active_in,
    const float* __restrict__ topk_s_in, const int* __restrict__ topk_i_in,
    const int* __restrict__ lane_delta, const int* __restrict__ lane_cap,
    int* __restrict__ h_out, int* __restrict__ patience_out,
    bool* __restrict__ active_out, float* __restrict__ topk_s_out,
    int* __restrict__ topk_i_out, int w, int chunk, int k, int min_probes,
    float phi) {
  const int lane = blockIdx.x * kLanesPerBlock + threadIdx.x / 32;
  if (lane >= w) return;
  const int t_warp = threadIdx.x % 32;
  const float inv_k = __fdiv_rn(1.0f, static_cast<float>(k));
  const int delta = lane_delta[lane];
  const int cap = lane_cap[lane];
  const int* cnt = cnts + static_cast<size_t>(lane) * chunk;
  bool active = active_in[lane];
  int h = h_in[lane];
  int patience = patience_in[lane];
  int last = -1;  // the last slot at which the lane was active
  for (int t = 0; t < chunk; ++t) {
    if (active) {
      const float phi_v = __fmul_rn(
          __fmul_rn(100.0f, static_cast<float>(k - cnt[t])), inv_k);
      patience = (h >= 1 && phi_v >= phi) ? patience + 1 : 0;
      h += 1;
      last = t;
      if ((patience >= delta && h >= min_probes) || h >= cap) active = false;
    } else {
      patience = 0;
    }
  }
  if (t_warp == 0) {
    h_out[lane] = h;
    patience_out[lane] = patience;
    active_out[lane] = active;
  }
  const size_t row = static_cast<size_t>(lane) * k;
  const size_t src = last < 0 ? row
                              : (static_cast<size_t>(lane) * chunk + last) * k;
  const float* s = last < 0 ? topk_s_in : snap_s;
  const int* i = last < 0 ? topk_i_in : snap_i;
  for (int j = t_warp; j < k; j += 32) {
    topk_s_out[row + j] = s[src + j];
    topk_i_out[row + j] = i[src + j];
  }
}

}  // namespace

// The wrapper checks every shape against (w, chunk, k), k > 0 and chunk > 0.
extern "C" int slot_roll(const float* snap_s, const int* snap_i,
                         const int* cnts, const int* h, const int* patience,
                         const bool* active, const float* topk_s,
                         const int* topk_i, const int* lane_delta,
                         const int* lane_cap, int* h_out, int* patience_out,
                         bool* active_out, float* topk_s_out, int* topk_i_out,
                         int w, int chunk, int k, int min_probes, float phi,
                         void* stream) {
  const int blocks = (w + kLanesPerBlock - 1) / kLanesPerBlock;
  slot_roll_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      snap_s, snap_i, cnts, h, patience, active, topk_s, topk_i, lane_delta,
      lane_cap, h_out, patience_out, active_out, topk_s_out, topk_i_out, w,
      chunk, k, min_probes, phi);
  return static_cast<int>(cudaGetLastError());
}
