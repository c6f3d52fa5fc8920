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
// Delta stream (cap > 0): at slot j the buffer entries with assign ==
// gates[slot] and id >= 0 join the slot's candidates, NEW-marked.  The
// reference merges them in a second merge after the list's; one merge of
// the running top-k with the list rows and the gated entries keeps the
// same records and the same count, because the packed (key, id word)
// order is total.  Slots past the probe budget gate on -2, which no live
// entry carries.
//
// Bound on the H100: memory.  A slot reads its live rows (size * d f32
// plus their ids) once; the stream reads the cap assigns (and the ids of
// the entries whose assign matches a gate) once per query and the gated
// rows only; the running top-k and the scores never leave shared memory.
//
// Design.  One CTA walks one query's chunk: 8 consumer warps and one
// producer warp; the running top-k stays in shared memory across the
// chunk.  What the card showed (PERF.md, PR 16): the kernel's time is the
// CTA of the query with the most rows, so one SM's stream rate and the
// merges between slots set it.
// - Staging.  The live rows of the chunk's slots form one stream of
//   tiles of 16 rows (a slot's tail tile is short; rows at or past the
//   size are never fetched) and their 16 ids.  A list's rows are
//   contiguous, so a tile is one cp.async.bulk of its rows and one of its
//   ids, into a ring of `stages` stages, each with a full and an empty
//   mbarrier.  The producer warp refills a stage once the 8 consumer
//   warps have released it, and runs on across slots, so the next slot's
//   rows arrive while this slot merges.  d not a multiple of 4 (rows not
//   16-byte aligned), docs or ids not 16-byte aligned, blk_l not a
//   multiple of 16, or no room for two stages: the consumers read rows
//   and ids from global memory instead (`stages` = 0).
// - Slabs.  Where two stages of whole rows do not fit (d above 1,692 at
//   k 100, chunk 8, list_pad 256), a stage holds the tile's 16
//   rows' next kSlabCols columns: one cp.async.bulk a row, a tile's
//   slabs streamed in column order, its ids with its first slab.  Each
//   warp carries its two accumulators across a row's slabs and runs the
//   XOR butterfly after the last, so the sums keep row_dot's order.
// - Scoring.  Each consumer warp scores two rows of a tile with two
//   accumulators, q's first 1,024 floats in registers, and walks a slot's
//   tiles on its own: the survivor buffer holds every list row of a slot,
//   so no barrier falls inside a slot's list rows.  Every score keeps
//   row_dot's order (lane l sums l, l+32, ... by fmaf, then the XOR
//   butterfly 16..1), so fused == per-probe pair and live == rebuilt hold
//   bit for bit.  No TF32, no tensor cores.
// - Filter, then merge.  A candidate can enter only if its packed word is
//   above the running k-th record (a marked candidate never equals an
//   unmarked record, and a candidate equal to a marked k-th is the same
//   record twice, which the top-k holds once at that rank either way).
//   At the slot's end (and before a batch of gated entries that could
//   overflow the buffer) the survivors are ranked among themselves and
//   merged by binary search: running lane i lands at i + #{survivors
//   above it}, the r-th survivor at r + #{running lanes at or above it},
//   and ranks below k are the new top-k (equal records are identical, so
//   the bits are the merge's; packed_sort.cuh's merge, which topk_merge
//   runs too).  A slot with no survivor writes the
//   running top-k unchanged.  Marks are stripped at the slot's end; where
//   that puts two equal-key records out of packed order, the running
//   top-k is re-ranked within its equal-key groups (the snapshot keeps
//   the merge's order, as the reference's).
// - The incoming running top-k is ranked once into packed order, since a
//   caller's may hold equal scores with ids out of order.
// - Gating.  At the chunk's start the consumers read the cap assigns once
//   (16 loads in flight a thread) and list up to 256 (entry, slot)
//   matches, counting each slot's matches; a slot whose matches did not
//   all fit rescans the buffer in windows of 256 entries.  Gated rows are
//   read from global memory, 16 at a time.  Shared memory does not grow
//   with cap.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "packed_sort.cuh"

namespace {

constexpr int kWarps = 8;                   // consumer warps
constexpr int kConsumers = 32 * kWarps;     // consumer threads
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kTileRows = 2 * kWarps;       // rows a stage holds: two a warp
constexpr int kList = 256;                  // gated (entry, slot) list
constexpr int kQReg = 32;                   // q floats in registers a lane
constexpr int kMaxStages = 4;
constexpr int kSlabCols = 32 * kQReg;       // columns a slab stage holds
constexpr int kGateUnroll = 16;             // assigns a thread loads at once
// the list path gathers one list entry per consumer thread
static_assert(kList == kConsumers, "one list entry per consumer thread");

// survivor buffer: a slot's list rows all fit, so the list phase of a slot
// needs no barrier; gated entries come kTileRows at a time
__host__ __device__ constexpr int cand_cap(int list_pad) {
  return list_pad > kTileRows ? list_pad : kTileRows;
}

// dynamic shared memory: the ring (stages tiles of kTileRows rows of
// `cols` floats, whole rows or slabs, and their ids), the running top-k
// and its merge scratch, the survivors and their sorted copy, q,
// the gated list and its per-slot gather buffer, and per slot its size,
// block offset, gate, match count and overflow flag
// (kernels/ivf_scan_merge.py:smem_bytes mirrors this sum)
constexpr long long smem_bytes(int d, int k, int chunk, int list_pad,
                               int stages, int cols) {
  return static_cast<long long>(stages) * kTileRows * (cols + 1) * 4 +
         2LL * k * 8 + 16LL * cand_cap(list_pad) + 4LL * d + 3 * kList * 4 +
         5LL * chunk * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
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

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the consumer warps' barrier (named barrier 1; the producer warp never
// joins it), plain and with a count or an or of a predicate
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ int csync_count(bool p) {
  int n;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %1, 0;\n"
      "bar.red.popc.u32 %0, 1, %2, q;\n}"
      : "=r"(n)
      : "r"(static_cast<unsigned>(p)), "n"(kConsumers)
      : "memory");
  return n;
}

__device__ __forceinline__ bool csync_or(bool p) {
  unsigned r;
  asm volatile(
      "{\n.reg .pred q, o;\nsetp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred o, 1, %2, q;\nselp.u32 %0, 1, 0, o;\n}"
      : "=r"(r)
      : "r"(static_cast<unsigned>(p)), "n"(kConsumers)
      : "memory");
  return r != 0;
}

template <bool kShared>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// two rows' dot products with q in row_dot's order; every lane ends with
// both sums
template <bool kShared>
__device__ __forceinline__ void dot2(const float (&qr)[kQReg],
                                     const float* q_s, const float* r0,
                                     const float* r1, int d, int lane,
                                     float& s0, float& s1) {
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int i = 0; i < kQReg; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      a0 = fmaf(qr[i], load<kShared>(r0 + c), a0);
      a1 = fmaf(qr[i], load<kShared>(r1 + c), a1);
    }
  }
  for (int c = lane + 32 * kQReg; c < d; c += 32) {
    a0 = fmaf(q_s[c], load<kShared>(r0 + c), a0);
    a1 = fmaf(q_s[c], load<kShared>(r1 + c), a1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, o);
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
  }
  s0 = a0;
  s1 = a1;
}

// a slab's part of two rows' dot products with q, added to a0 and a1:
// lane l takes columns c0 + l, c0 + l + 32, ... of the w the slab holds
// (r0, r1 its rows), in row_dot's order; the first slab is q's register
// part (the wrapper picks slabs only for d > kSlabCols)
__device__ __forceinline__ void slab_dot2(const float (&qr)[kQReg],
                                          const float* q_s, const float* r0,
                                          const float* r1, int c0, int w,
                                          int lane, float& a0, float& a1) {
  if (c0 == 0) {
#pragma unroll
    for (int i = 0; i < kQReg; ++i) {
      const int c = lane + 32 * i;
      a0 = fmaf(qr[i], r0[c], a0);
      a1 = fmaf(qr[i], r1[c], a1);
    }
  } else {
#pragma unroll 8
    for (int c = lane; c < w; c += 32) {
      a0 = fmaf(q_s[c0 + c], r0[c], a0);
      a1 = fmaf(q_s[c0 + c], r1[c], a1);
    }
  }
}

// the consumer warps' barrier as the packed:: merge helpers take it
struct ConsumerSync {
  __device__ __forceinline__ void operator()() const { csync(); }
};

// kStaged: list rows come through the ring; kSlab: its stages hold slabs
// of kSlabCols columns (`cols`), else whole rows (`cols` == d)
template <bool kStaged, bool kSlab>
__global__ void __launch_bounds__(kThreads) ivf_scan_merge_kernel(
    const float* __restrict__ q, const float* __restrict__ docs,
    const int* __restrict__ ids, const int* __restrict__ boffs,
    const int* __restrict__ sizes, const float* __restrict__ run_s,
    const int* __restrict__ run_i, const float* __restrict__ dvecs,
    const int* __restrict__ dids, const int* __restrict__ dassign,
    const int* __restrict__ gates, float* __restrict__ out_s,
    int* __restrict__ out_i, int* __restrict__ cnt, int d, int k, int chunk,
    int list_pad, int blk_l, int cap, int stages, int cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int wsum[kWarps];
  __shared__ int n_surv_s;   // survivors' slots taken (atomic)
  __shared__ int n_list;     // (entry, slot) matches of the chunk-start pass
  const long long tile_floats =
      static_cast<long long>(kTileRows) * (kSlab ? cols : d);
  float* ring = reinterpret_cast<float*>(smem);
  int* ring_ids = reinterpret_cast<int*>(ring + stages * tile_floats);
  long long* run = reinterpret_cast<long long*>(
      ring_ids + (kStaged ? stages * kTileRows : 0));
  long long* tmp = run + k;
  long long* cand = tmp + k;
  long long* bsort = cand + cand_cap(list_pad);
  float* q_s = reinterpret_cast<float*>(bsort + cand_cap(list_pad));
  int* list_e = reinterpret_cast<int*>(q_s + d);
  int* list_j = list_e + kList;
  int* gbuf = list_j + kList;
  int* size_s = gbuf + kList;
  int* boff_s = size_s + chunk;
  int* gate_s = boff_s + chunk;
  int* gcount = gate_s + chunk;
  int* ovf = gcount + chunk;

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int key_valid = packed::score_to_key(packed::kValidMin);

  if (warp == kWarps) {
    // the producer warp: the slots' sizes (rows past list_pad are not
    // the list's) and offsets, then the tile stream, `stages` tiles ahead
    // of the consumers.  A tile is up to kTileRows rows and the kTileRows
    // ids from its first row on (the wrapper stages only when blk_l is a
    // multiple of kTileRows, so they lie in the list's padded rows and
    // start 64-byte aligned); lane 0 copies the rows, lane 1 the ids.
    // In slab mode a tile is its rows' slabs in column order, a stage
    // each, lane r copying row r's slab and lane kTileRows the ids with
    // the first slab
    for (int j = lane; j < chunk; j += 32) {
      size_s[j] = min(sizes[b * chunk + j], list_pad);
      boff_s[j] = boffs[b * chunk + j];
    }
    if (kStaged && lane == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(smem_u32(&full[s]), 1);
        mbar_init(smem_u32(&empty[s]), kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    int pj = 0, pr = 0, t = 0;
    int pc = 0;   // the tile's next slab's first column (slab mode)
    auto issue = [&]() {
      while (pj < chunk && pr >= size_s[pj]) {
        ++pj;
        pr = 0;
      }
      if (pj == chunk) return false;
      const int stage = t % stages;
      if (t >= stages) {   // wait for the consumers to release the stage
        mbar_wait(smem_u32(&empty[stage]), ((t / stages) & 1) ^ 1);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
      const int n = min(kTileRows, size_s[pj] - pr);
      const uint32_t bar = smem_u32(&full[stage]);
      const long long row0 =
          static_cast<long long>(boff_s[pj]) * blk_l + pr;
      if constexpr (kSlab) {
        const int w = min(cols, d - pc);
        const uint32_t slab_bytes = static_cast<uint32_t>(w) * 4;
        const uint32_t id_bytes = pc == 0 ? kTileRows * 4 : 0;
        if (lane == 0) {
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                  bar),
              "r"(slab_bytes * n + id_bytes)
              : "memory");
        }
        __syncwarp();
        if (lane < n) {
          bulk_load(smem_u32(ring + stage * tile_floats + lane * cols),
                    docs + (row0 + lane) * d + pc, slab_bytes, bar);
        } else if (lane == kTileRows && id_bytes) {
          bulk_load(smem_u32(ring_ids + stage * kTileRows), ids + row0,
                    id_bytes, bar);
        }
        pc += w;
        if (pc == d) {
          pc = 0;
          pr += n;
        }
      } else {
        const uint32_t row_bytes = static_cast<uint32_t>(d) * 4;
        if (lane == 0) {
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                  bar),
              "r"(row_bytes * n + kTileRows * 4)
              : "memory");
        }
        __syncwarp();
        if (lane == 0) {   // a list's rows are contiguous: one copy
          bulk_load(smem_u32(ring + stage * tile_floats), docs + row0 * d,
                    row_bytes * n, bar);
        } else if (lane == 1) {
          bulk_load(smem_u32(ring_ids + stage * kTileRows), ids + row0,
                    kTileRows * 4, bar);
        }
        pr += n;
      }
      ++t;
      return true;
    };
    if (kStaged) {
      while (t < stages && issue()) {
      }
    }
    __syncthreads();   // the CTA's one full barrier: setup done
    if (kStaged) {
      while (issue()) {
      }
    }
    return;
  }

  if (tid == 0) {
    n_surv_s = 0;
    n_list = 0;
  }
  float qr[kQReg];
#pragma unroll
  for (int i = 0; i < kQReg; ++i) {
    const int c = lane + 32 * i;
    qr[i] = c < d ? __ldg(q + b * d + c) : 0.0f;
  }
  for (int c = tid; c < d; c += kConsumers) q_s[c] = q[b * d + c];
  for (int t = tid; t < k; t += kConsumers) {
    float s = run_s[b * k + t];
    s = s < packed::kNeg ? packed::kNeg : s;   // clamp -inf empty slots
    run[t] = packed::pack(packed::score_to_key(s), run_i[b * k + t]);
  }
  for (int j = tid; j < chunk; j += kConsumers) {
    gate_s[j] = cap > 0 ? gates[b * chunk + j] : 0;
    gcount[j] = 0;
    ovf[j] = 0;
  }
  __syncthreads();   // with the producer: setup done
  // the merge needs the running top-k in packed order: rank the incoming
  // records (equal ones by position; the caller's may tie out of order)
  packed::rank<kConsumers>(run, tmp, k);
  csync();
  for (int t = tid; t < k; t += kConsumers) run[t] = tmp[t];

  // gating, while the first tiles are in flight: list each (entry, slot)
  // match, count every slot's matches, flag the slots that overflowed
  // (16 loads in flight a thread: one round trip at cap 4,096)
  for (int e0 = tid; e0 < cap; e0 += kGateUnroll * kConsumers) {
    int a[kGateUnroll];
#pragma unroll
    for (int u = 0; u < kGateUnroll; ++u) {
      const int e = e0 + u * kConsumers;
      a[u] = e < cap ? __ldg(dassign + e) : 0;
    }
#pragma unroll
    for (int u = 0; u < kGateUnroll; ++u) {
      const int e = e0 + u * kConsumers;
      if (e >= cap) continue;
      for (int j = 0; j < chunk; ++j) {
        if (gate_s[j] == a[u] && __ldg(dids + e) >= 0) {
          atomicAdd(&gcount[j], 1);
          const int at = atomicAdd(&n_list, 1);
          if (at < kList) {
            list_e[at] = e;
            list_j[at] = j;
          } else {
            ovf[j] = 1;
          }
        }
      }
    }
  }
  csync();

  // lane 0 pushes the score sa of candidate ida if it beats the running
  // k-th, lane 1 sb of idb (ids < 0 are not candidates); returns whether
  // this lane pushed
  auto push_pair = [&](float sa, float sb, int ida, int idb) {
    const int id = lane == 0 ? ida : idb;
    if (lane < 2 && id >= 0) {
      const long long v = packed::pack(
          packed::score_to_key(lane == 0 ? sa : sb), id | packed::kNewMark);
      if (v > run[k - 1]) {
        cand[atomicAdd(&n_surv_s, 1)] = v;
        return true;
      }
    }
    return false;
  };
  // score a warp's pair of candidates and push them
  auto score_pair = [&](const float* pa, const float* pb, int ida, int idb,
                        auto in_shared) {
    bool pushed = false;
    if (ida >= 0 || idb >= 0) {               // uniform across the warp
      if (ida < 0) pa = pb;
      if (idb < 0) pb = pa;
      float sa, sb;
      dot2<decltype(in_shared)::value>(qr, q_s, pa, pb, d, lane, sa, sb);
      pushed = push_pair(sa, sb, ida, idb);
    }
    return pushed;
  };
  using InShared = std::integral_constant<bool, true>;
  using InGlobal = std::integral_constant<bool, false>;

  // survivors in the buffer, the same count in every consumer thread
  int n_surv = 0;
  // score gbuf[0, n) (delta buffer entries) in pairs a warp, merging
  // first whenever a batch could overflow the buffer
  auto score_gated = [&](int n) {
    for (int g0 = 0; g0 < n; g0 += kTileRows) {
      if (n_surv + kTileRows > cand_cap(list_pad)) {
        packed::merge<kConsumers>(run, tmp, cand, bsort, n_surv, &n_surv_s, k,
                                  ConsumerSync{});
        n_surv = 0;
      }
      const int xa = g0 + warp, xb = g0 + warp + kWarps;
      const int ea = xa < n ? gbuf[xa] : 0;
      const int eb = xb < n ? gbuf[xb] : 0;
      n_surv += csync_count(
          score_pair(dvecs + static_cast<long long>(ea) * d,
                     dvecs + static_cast<long long>(eb) * d,
                     xa < n ? __ldg(dids + ea) : -1,
                     xb < n ? __ldg(dids + eb) : -1, InGlobal{}));
    }
  };

  int it = 0;   // stages consumed
  for (int j = 0; j < chunk; ++j) {
    const long long slot = b * chunk + j;
    const long long base = static_cast<long long>(boff_s[j]) * blk_l;
    const int size = size_s[j];
    // the list rows: each warp walks the slot's tiles on its own (the
    // buffer holds every row of a slot), releasing each stage as it goes
    for (int r0 = 0; r0 < size; r0 += kTileRows) {
      const int ra = r0 + warp, rb = r0 + warp + kWarps;
      if constexpr (kSlab) {
        // the tile's slabs in column order: the ids with the first, the
        // butterfly after the last
        float a0 = 0.0f, a1 = 0.0f;
        int ida = -1, idb = -1;
        for (int c0 = 0; c0 < d; c0 += cols, ++it) {
          const int stage = it % stages;
          mbar_wait(smem_u32(&full[stage]), (it / stages) & 1);
          if (c0 == 0) {
            const int* tile_ids = ring_ids + stage * kTileRows;
            ida = ra < size ? tile_ids[warp] : -1;
            idb = rb < size ? tile_ids[warp + kWarps] : -1;
          }
          if (ida >= 0 || idb >= 0) {           // uniform across the warp
            const float* tile = ring + stage * tile_floats;
            slab_dot2(qr, q_s, tile + warp * cols,
                      tile + (warp + kWarps) * cols, c0, min(cols, d - c0),
                      lane, a0, a1);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
        }
        if (ida >= 0 || idb >= 0) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            a0 += __shfl_xor_sync(0xffffffffu, a0, o);
            a1 += __shfl_xor_sync(0xffffffffu, a1, o);
          }
          push_pair(a0, a1, ida, idb);
        }
      } else if constexpr (kStaged) {
        const int stage = it % stages;
        mbar_wait(smem_u32(&full[stage]), (it / stages) & 1);
        const int* tile_ids = ring_ids + stage * kTileRows;
        const float* tile = ring + stage * tile_floats;
        score_pair(tile + warp * d, tile + (warp + kWarps) * d,
                   ra < size ? tile_ids[warp] : -1,
                   rb < size ? tile_ids[warp + kWarps] : -1, InShared{});
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
        ++it;
      } else {
        const int ida = ra < size ? __ldg(ids + base + ra) : -1;
        const int idb = rb < size ? __ldg(ids + base + rb) : -1;
        score_pair(docs + (base + (ida >= 0 ? ra : r0)) * d,
                   docs + (base + (idb >= 0 ? rb : r0)) * d, ida, idb,
                   InGlobal{});
      }
    }
    csync();
    n_surv = n_surv_s;
    if (gcount[j] > 0) {
      if (!ovf[j]) {
        // every match of this slot is in the list (kList == kConsumers)
        const int x = tid;
        const bool mine = x < min(n_list, kList) && list_j[x] == j;
        score_gated(packed::compact<kConsumers>(
            mine, mine ? list_e[x] : 0, gbuf, wsum, ConsumerSync{}));
      } else {
        // rescan the buffer in windows of kList entries
        const int gate = gate_s[j];
        for (int w0 = 0; w0 < cap; w0 += kList) {
          const int e = w0 + tid;
          const bool mine = e < cap && __ldg(dassign + e) == gate &&
                            __ldg(dids + e) >= 0;
          score_gated(packed::compact<kConsumers>(mine, e, gbuf, wsum,
                                                    ConsumerSync{}));
        }
      }
    }
    if (n_surv > 0) {
      packed::merge<kConsumers>(run, tmp, cand, bsort, n_surv, &n_surv_s, k,
                                  ConsumerSync{});
      n_surv = 0;
    }
    // lanes still NEW-marked entered on this probe; empty slots count as
    // new because only keys above the valid floor count as kept.  The
    // stripped records go to tmp; stripping can put an equal-key pair out
    // of packed order (a marked id word above a higher unmarked one)
    int kept = 0;
    bool inverted = false;
    for (int t0 = 0; t0 < k; t0 += kConsumers) {
      const int t = t0 + tid;
      bool keep = false;
      if (t < k) {
        const long long r = run[t];
        const int key = packed::key_of(r);
        const int idw = packed::idw_of(r);
        keep = key > key_valid && !packed::is_marked(idw);
        const int clean = packed::strip_marks(idw);
        out_s[slot * k + t] = packed::key_to_score(key);
        out_i[slot * k + t] = clean;
        tmp[t] = packed::pack(key, clean);
        if (t + 1 < k) {
          const long long n = run[t + 1];
          inverted |= packed::key_of(n) == key &&
                      packed::strip_marks(packed::idw_of(n)) > clean;
        }
      }
      kept += csync_count(keep);
    }
    if (tid == 0) cnt[slot] = k - kept;
    // back into packed order: a record moves only within its equal-key
    // group (keys do not change, so the groups stay where they are)
    const bool reorder = csync_or(inverted);
    for (int t = tid; t < k; t += kConsumers) {
      const long long a = tmp[t];
      int pos = t;
      if (reorder) {
        const int key = packed::key_of(a);
        int gs = t, ge = t + 1;
        while (gs > 0 && packed::key_of(tmp[gs - 1]) == key) --gs;
        while (ge < k && packed::key_of(tmp[ge]) == key) ++ge;
        pos = gs;
        for (int u = gs; u < ge; ++u) {
          const long long o = tmp[u];
          pos += (o > a) | ((o == a) & (u < t));
        }
      }
      run[pos] = a;
    }
    csync();
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
                              int list_pad, int blk_l, int cap, int stages,
                              int cols, void* stream) {
  // the wrapper checks k <= 1024, that the shared memory fits the card's
  // opt-in limit, and picks `stages` (0: rows read from global memory)
  // and `cols`, the columns of a row a stage holds: d (whole rows) or
  // kSlabCols (slabs, for d > kSlabCols)
  const bool slab = stages > 0 && cols != d;
  if (stages < 0 || stages > kMaxStages || stages == 1 ||
      (slab && (cols != kSlabCols || d <= kSlabCols))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(
      smem_bytes(d, k, chunk, list_pad, stages, slab ? cols : d));
  auto kernel = !stages ? ivf_scan_merge_kernel<false, false>
                : slab  ? ivf_scan_merge_kernel<true, true>
                        : ivf_scan_merge_kernel<true, false>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, docs, ids, boffs, sizes, run_s, run_i, dvecs, dids, dassign, gates,
      out_s, out_i, cnt, d, k, chunk, list_pad, blk_l, cap, stages,
      slab ? cols : d);
  return static_cast<int>(cudaGetLastError());
}
