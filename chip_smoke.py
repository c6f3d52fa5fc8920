#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Run it from a checkout of the repository (it puts ``<repo>/src`` on
``sys.path`` itself).  It needs one CUDA card and ``nvcc``; it builds
the kernels from ``src/repro_torch/csrc`` first.  Phases, each timed on
a line of its own:

1. device and build, and the built kernels' instructions: the bf16
   ``flash_attention`` must hold wgmma (HGMMA) and TMA loads (UTMALDG),
   ``delta_scan`` and ``ivf_scan_merge`` no tensor-core instruction
   (HMMA, HGMMA), both staged ``ivf_scan_merge`` instantiations (a
   ring of whole rows, a ring of slabs) a bulk async copy (UBLKCP);
2. each kernel against its plain version at main-path shapes, on
   integer-valued inputs (bit-equal, ties included) and on L2-normalised
   Gaussian inputs (scores within 1e-5, ids equal up to near-tie swaps);
   ``flash_attention`` in f32 (within 2e-5) and bf16 (within the
   per-element bound of ``kernels.flash_attention.bf16_bound``: the
   kernel rounds P to bf16), hd 64 and 128, S a tile multiple and not,
   causal or not, and bf16 at MLA's qk 96, v 64 (S 512 and 2,064);
   ``embedding_bag`` bit for bit at D 1, 10, 16 and F 1, 39;
   ``row_topk`` bit for bit its plain version (the stable sort) on the
   sims of random unit vectors at the benchmark cells' admission (512 x
   65,536, k 80) and at this script's wave (128 x 8,192, k 80);
3. the main path at the paper's widths (``configs/msmarco_ivf``:
   d=768, k=100, N=80, tau=10, patience Delta=7, Phi=95, list_pad=256)
   on a 1M-document synthetic corpus: build the index on the card,
   serve 1,024 queries through the wave scheduler (one fused
   ``ivf_scan_merge`` launch per chunk, one ``slot_roll`` launch a wave,
   one ``row_topk`` launch per admission; host reads a wave printed, at
   most one read of ``active`` and one wait for the exits' copy), and
   check it against fused
   ``search``, the per-probe kernel pair and brute force;
3b. the learned exit stages on that index (``learned_train``,
   ``learned_search``, ``learned_fused_vs_pair``, ``learned_features``):
   the four forests of Table 2 (30 trees, depth 5) trained on 2,048
   queries of their own (validated on 512) at N=80, tau=10, w=3; the
   eight Table-2 strategies on the 1,024 served queries through the
   fused kernel (R*@1, R*@k, mRR@10, C, wall, speedup, launches; every
   learned query's probes within [tau, N], +Patience's C at most the
   weighted classifier's); both cascades' fused search against the
   kernel pair; +Patience served by the wave scheduler
   (``learned_serve``: one ``tau_stage`` launch a wave, the answers,
   probes and classifier exits of fused ``search``); and the features
   built offline against the online ones at tau and across batch
   sizes, bit for bit;
4. the live index on that index (``LiveIndex``, delta capacity 4,096):
   1,024 adds and 256 deletes before serving, then the same 1,024
   queries served through a version registry while every wave adds 64
   docs, deletes 16 earlier adds and publishes, with ``merge_delta``
   every 16 waves (the reference CLI's ``--mutation-rate 64
   --merge-every 16 --delta-cap 4096``): every wave is one fused launch
   with the delta stream; recall against the static serve; then the
   final live index against its rebuilt twin and the per-probe kernel
   pair (bit for bit) and against brute force over its net corpus;
5. the model zoo on seeded random weights at full width: StarCoder2-3B
   (30 layers, d=3,072, GQA kv=2) prefills 4 x 2,048 Zipf tokens (30
   ``flash_attention`` launches), decodes 16 steps, and both agree with
   ``forward`` over all 2,064 tokens within the reference test's bounds;
   then the rest of the LM zoo at published widths, the same 4 x 2,048
   prefill and 16 steps, each freed before the next: MiniCPM3-4B (all
   62 layers, MLA: the flash kernel at qk 96, v 64, 62 launches a
   prefill; the latent cache under 1/10 of a GQA cache), Qwen1.5-32B
   (16 of 64 layers, f32, the int8 KV cache: its bytes against the bf16
   cache's), DeepSeekMoE-16B (all 28 layers, bf16 master weights) and
   DBRX (4 of 40 layers, bf16), both MoE configs served at their
   published capacity factor 1.25 with the dropped assignments counted
   (and counted again on uniformly drawn tokens), their consistency
   held in a harness at the drop-free factor E/k where a token whose
   own routing differs from the forward's must be a near tie and is
   left out of the bounds; their walls, peak memory and cache bytes
   printed (phases ``minicpm3_*``, ``qwen_int8_*``, ``deepseek_moe_*``,
   ``dbrx_*``);
   DeepFM (39 x 1M rows, D=10) serves 8 ``serve_p99`` batches and one
   ``serve_bulk`` batch (2 ``embedding_bag`` launches a call), each
   against the same forward from ``emb.sum(1)``; profiled calls of both;
5b. training (phases ``lm_train_*``, ``train_restart*``,
   ``recsys_train_*``, ``recsys_score_candidates``,
   ``retriever_lifecycle``): StarCoder2-3B at published widths and all
   30 layers, f32 master weights, the trainer's AdamW, on ``lm_batcher``'s
   2 x 4,096 tokens (train_4k's sequence; its global batch of 256 cut to
   a micro-batch of 2): the first step's loss and gradients through the
   flash kernel's autograd Function (2 launches a layer: the forward and
   the remat recompute) held against the same step through the plain
   ``_causal_chunk_attn`` under autograd, then 4 steps (step ms,
   tokens/s, peak memory, 60 flash launches each), one profiled step,
   the plain attention backward's time a layer and its share of a step;
   the restart drill on the same widths cut to 2 layers (4 GB
   checkpoints in a temporary directory, removed after): one step run
   twice from one state bit for bit, then 8 steps checkpointed every 2
   with failures injected at steps 3 and 5, the losses bit for bit the
   uninterrupted run's; DeepFM at published widths on ``recsys_batcher``'s
   65,536-example batches: the first step's loss and gradients through
   the embedding_bag Function bit for bit the plain version's under the
   same deterministic backward, 4 AdamW steps (2 launches each), the
   backward's time; ``score_candidates`` at retrieval_cand (1 x 1M x
   256, k=100) against a full sort; the retriever example's life cycle
   (``--big``: ~103M parameters, 300 steps, 40k docs embedded, the
   index built, N chosen, fixed and patience searched on the fused
   kernel), fused == the per-probe kernel pair bit for bit; then MLA
   and MoE training on the same 2 x 4,096 tokens (phases
   ``minicpm3_train_*``, ``deepseek_moe_train_*``): MiniCPM3-4B at 44 of
   its 62 layers (flash at qk 96, v 64 under autograd, 2 launches a
   layer a step) and DeepSeekMoE-16B at 4 of 28 (1 dense + 3 MoE layers)
   at its published capacity factor 1.25 (the dropped share and the aux
   loss printed; its hold at the drop-free factor, near-tie tokens
   routed otherwise masked), both in the configs' f32 weights;
5c. the GAT (``configs/gat_cora``) at ``GNN_SHAPES`` (phases
   ``gnn_*``): Cora's sizes (the first step against the CPU port's, one
   step run twice bit for bit, the example's 100 AdamW steps), one
   forward at ogbn-products' full scale (2,449,029 nodes, 61,859,140
   edges) and training steps there or at a cut that fits, Reddit's
   sizes (114,615,892 edges, the CSR on the host) through the fanout
   sampler, and 128 disjoint molecule graphs; then the port's dry run
   (phase ``dryrun``): six cells of ``launch.dryrun`` on the single-pod
   mesh, one process each, every record ``ok``, and the GAT forward
   counted by ``launch.cost_analysis`` beside its measured ms and peak;
6. each kernel's time (CUDA events) beside its plain version, a library
   yardstick the port never calls, and its bound; ``topk_merge`` at
   probe 1, at a late probe and at the live pair's width (list rows and
   the gated buffer columns), beside the launch floor (an empty
   kernel); ``row_topk`` at a merge's width (128 x 356, k 100), the
   admission's (512 x 65,536, k 80) and a brute force's (128 x 8,000, k
   10), beside the stable sort and ``torch.topk``; ``slot_roll`` at the
   benchmark's wave (1,024 lanes, chunk 8, k 100 and 10) beside the
   chain of PyTorch ops it replaced, by events and by host clock
   around a synchronised call; ``tau_stage`` at the ``star-cascade``
   cell's wave (1,024 lanes, chunk 8, k 100, d 768, tau 10, 100 trees
   of depth 6) bit for bit beside the chain of PyTorch ops it
   replaced, timed the same ways; ``ivf_scan_merge`` at the
   ``nq-bulk`` cell's rows (phases ``wide_*``: 4,096 of its lists at
   d 4,096, its wave of 1,024 lanes, chunk 8, k 100; the ring holds
   slabs): ``WaveScheduler`` serves 2,048 queries with the counters
   zeroed just before, one fused launch through the ring a wave, ==
   fused ``search``; the wave's first chunk bit for bit the kernel's
   unstaged path and within 1e-5 of the plain version (bit for bit on
   integer inputs, that chunk and the next), timed with the unstaged
   path and the plain version beside the bytes bound; ``flash_attention``
   (the prefill's 96 x 2,048 x 128 bf16,
   and MiniCPM3's 160 x 2,048 at qk 96, v 64 beside the
   ``scaled_dot_product_attention`` backend PyTorch picks there)
   and ``embedding_bag`` (the bulk batch on both DeepFM tables, D=10
   and D=1, its bound on 32-byte sectors) are held against their plain
   versions there too, as are the training rows of 5b (flash at 2 x
   4,096, at qk 96 / v 64 there too, the bag at the training batch); a
   profiled static and live serve;
6b. deadline-budgeted serving on the main path's index and queries
   (``WaveScheduler(deadline_ms=)``, one fused launch a wave): under a
   simulated clock of 1 ms a wave, budgets of 4, 8, 16 and 32 ms and
   none, every query answered once, none past its budget by more than
   one wave, every degraded query with a reason, R*@k not falling as the
   budget grows, the unbounded row the static serve bit for bit, the
   8 ms row equal on the per-probe kernel pair; 4 ms waves under a 1 ms
   budget shed; on the real clock budgets of 4, 8 and 16 mean wave
   walls (the overshoot printed); on the drills' 65,536-document
   substrate (built here, reused by 7) the live stream with a WAL,
   snapshots and a rebuild requested before the serve, paused under a
   6 ms budget and ticking without one; the main index in 4 shards by
   ``search_with_retry`` (clean, a flaky shard answering as clean, a
   dead shard skipped, a backoff budget run dry); the mesh search
   (``make_distributed_search``) on spawned ranks: one NCCL rank over
   the whole index as one shard (patience at probe width 1 and 4,
   fixed-N equal to ``search_with_retry``, ``sharded_assign_step`` on
   2^20 sampled docs bit for bit the Lloyd step) and four gloo ranks on
   the one card over the 4 shards (fixed-N equal to
   ``search_with_retry``, patience, int8 docs within 0.02 of fixed-N's
   R*@1, the (4, 1) assign step equal to one rank's); ``run_chaos`` on the
   drills' substrate, its artifact held to ``make chaos-smoke`` and
   bench-smoke's resilience checks; ``serving_bench.main(smoke=True)``;
7. durability on the main path's index, after the profiled phases: the
   live serve of 4 with a mutation WAL (group commit 8 records / 50
   ms), a snapshot manager (``keep=1``) in a temporary directory and a
   background rebuild requested every 16 waves (the reference CLI's
   ``--rebuild-every 16``; a 65,536-slot buffer holds the rebuild's
   spill) until the first one publishes: every rebuild stage a tick
   between waves, the rebuild published and drained mid-serve, recall
   against the static serve; then ``IndexRegistry.recover`` from the
   snapshot and the log, bit for bit the serving index (state, and the
   fused path and the kernel pair), which answers bit for bit as its
   from-scratch re-layout; every kernel that reads the buffer against
   its plain version on the serving index's own buffer; the six
   rebuild failpoints crashed and recovered on a
   65,536-document corpus at d=768, each bit for bit the no-rebuild or
   the rebuilt state, and a drift tracker triggered by shifted adds and
   rebased by the rebuild it requests; ``kernel_bench.main()`` on the
   card, its JSON held to ``make bench-smoke``'s schema.

It prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
failed phase ends the script with a non-zero exit and no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# main-path shapes (configs/msmarco_ivf.py, serving at wave 128, chunk 4)
B, D, LIST_PAD, BLK_L, K, CHUNK = 128, 768, 256, 64, 100, 4
# the live stream: the reference CLI's --delta-cap 4096 --mutation-rate 64
# --merge-every 16, after a pre-serve burst of adds and deletes
CAP, MUTATION_RATE, MERGE_EVERY = 4096, 64, 16
PRE_ADDS, PRE_DELETES = 1024, 256
RECALL_GAP_MAX = 0.01          # the reference's make bench-smoke gate
N_PROBE, TAU, DELTA, PHI = 80, 10, 7, 95.0
# the benchmark cells' wave (portbench/): its slot_roll timing rows
SLOT_ROLL_LANES, SLOT_ROLL_CHUNK = 1024, 8
# the star-cascade cell's exit trees: its tau_stage timing row
TAU_STAGE_TREES, TAU_STAGE_DEPTH = 100, 6
# the nq-bulk cell's deployment (4,096-d rows): WIDE_LISTS of its 16,384
# lists at its mean list size (~13 GB of rows), WIDE_QUERIES of its queries
WIDE_CONFIG = ROOT / "portbench" / "configs" / "nq-e5-mistral.json"
WIDE_LISTS, WIDE_QUERIES, WIDE_SEED = 4096, 2048, 3_537_000_001
N_DOCS, N_CLUSTERS, N_QUERIES = 1_000_000, 8192, 1024
# the late-probe timing row: probe LATE_PROBE (0-based) of a search whose
# mean probe count C is about 28 at these widths
LATE_PROBE = 20
# noise norm spread * sqrt(d) = 2, as the reference CLI's default corpus
# (dim 64, spread 0.25); at spread 0.25 and d=768 noise drowns clusters
SPREAD = 0.25 * math.sqrt(64 / 768)
# added docs' noise: the reference CLI's scale 0.05 at dim 64, rescaled so
# the noise norm (0.4) is the same at d=768
NOISE = 0.05 * math.sqrt(64 / 768)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM f32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
ATOL = 1e-5
# profiler sessions a profiled timing row may take to record device time
PROFILE_TRIES = 5
# ~20 ms at the H100's clock: longer than the host takes to enqueue any
# timed call, the plain versions included
SLEEP_CYCLES = 40_000_000


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


@contextmanager
def phase(name: str):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def finite_err(a, b):
    """Max |a - b| over the entries finite in both, which must be the
    same entries."""
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        raise AssertionError("non-finite entries differ")
    return float((a - b)[both].abs().max()) if both.any() else 0.0


def near_tie_swaps(gs, gi, ws, wi, what):
    """Scores agree position by position within ATOL, and every id
    that differs is a near tie: it stands in the other list at a score
    within ATOL, or it is missing there and its score is within ATOL
    of that list's last one.  Returns (differing ids, max score err)."""
    err = finite_err(gs, ws)
    if err > ATOL:
        raise AssertionError(f"{what}: scores differ by {err}")
    diff = gi != wi

    def near(a, b):
        return (a == b) | ((a - b).abs() <= ATOL)

    for xs, xi, ys, yi in ((gs, gi, ws, wi), (ws, wi, gs, gi)):
        same = xi[..., :, None] == yi[..., None, :]
        found = (same & near(xs[..., :, None], ys[..., None, :])).any(-1)
        at_cut = ~same.any(-1) & near(xs, ys[..., -1:])
        bad = diff & ~found & ~at_cut
        if bad.any():
            raise AssertionError(f"{what}: {int(bad.sum())} ids differ "
                                 f"and are not near ties")
    return int(diff.sum()), err


def unit_sims(n_q, width, dev, *, seed, d=96):
    """(n_q, width) sims of random unit queries and centroids in d
    dimensions on ``dev``, as an admission ranks them."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(n_q, d, generator=g, device=dev)
    c = torch.randn(width, d, generator=g, device=dev)
    return torch.nn.functional.normalize(q, dim=1) \
        @ torch.nn.functional.normalize(c, dim=1).T


def slot_roll_inputs(w, chunk, k, dev, *, seed):
    """A wave's ``slot_roll`` arguments on ``dev``: random snapshots and
    carried top-k, new-entry counts 0 (phi 100) about half the time so
    that lanes exit by patience mid-chunk, 15% of the lanes inactive, h
    from 0 to 12, patience 7, probe budget 80."""
    import torch
    from repro_torch.kernels.slot_roll import Lanes
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    cnts = torch.where(rand(w, chunk) < 0.5, 0, ints(0, k + 1, w, chunk))
    lanes = Lanes(h=ints(0, 13, w), patience=ints(0, 7, w),
                  active=rand(w) < 0.85,
                  topk_scores=torch.randn(w, k, generator=g, device=dev),
                  topk_ids=ints(0, 1 << 30, w, k))
    return (torch.randn(w, chunk, k, generator=g, device=dev),
            ints(0, 1 << 30, w, chunk, k), cnts.to(torch.int32), lanes,
            torch.full((w,), DELTA, dtype=torch.int32, device=dev),
            torch.full((w,), N_PROBE, dtype=torch.int32, device=dev))


def tau_stage_inputs(w, chunk, k, d, tau, n_trees, depth, dev, *, seed):
    """A wave's ``tau_stage`` arguments on ``dev`` (the lane tensors in
    the wrapper's order, the trees, the knobs) and the least bytes the
    stage moves: lanes fresh (h 0), before, at and past tau's slot, 15%
    inactive; snapshots of descending scores, 30% of them with a tail of
    -inf (id -1), ids drawn without repeats from 3k so that RS_1 and the
    snapshots overlap; ``n_trees`` full trees of ``depth`` that split on
    features of the whole Table-1 layout at some lane's value of the
    feature, the base putting the margins of the lanes at tau on both
    sides of 0."""
    import torch
    from repro_torch.core.features import FeatureExtras, feature_matrix
    from repro_torch.trees.torch_infer import TreeEnsemble, predict_margin
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    hist_w = max(tau - 1, 1)
    snap_s = randn(w, chunk, k).sort(dim=-1, descending=True).values
    valid = torch.where(rand(w, chunk) < 0.3, ints(0, k + 1, w, chunk), k)
    tail = torch.arange(k, device=dev) >= valid[..., None]
    snap_s = snap_s.masked_fill(tail, float("-inf"))
    pick = rand(w, chunk, 3 * k).argsort(-1)[..., :k].to(torch.int32)
    snap_i = torch.where(tail, -1, pick)
    rs1 = rand(w, 3 * k).argsort(-1)[:, :k].to(torch.int32)
    rs1 = torch.where(rand(w, k) < 0.2, -1, rs1)
    h = ints(0, tau + chunk + 2, w)
    h = torch.where(rand(w) < 0.25, 0, h)
    h = torch.where(rand(w) < 0.3,
                    (tau - 1 - ints(0, chunk, w)).clamp(min=0), h)
    active = rand(w) < 0.85
    qvec, sims = randn(w, d), randn(w, tau)
    phi, phi1 = 100 * rand(w, hist_w), 100 * rand(w, hist_w)
    t_tau = (tau - 1 - h).long()
    stage = active & (t_tau >= 0) & (t_tau < chunk)
    rows = torch.arange(w, device=dev)
    fm = feature_matrix(FeatureExtras(
        queries=qvec, centroid_sims=sims,
        topk_scores=snap_s[rows, t_tau.clamp(0, chunk - 1)],
        phi_hist=phi, phi1_hist=phi1), with_intersections=True)
    n_inner, m = 2 ** depth - 1, 2 ** (depth + 1) - 1
    node = torch.arange(m, device=dev, dtype=torch.int32)
    inner = node < n_inner
    feat = torch.where(inner, ints(0, fm.shape[1], n_trees, m), -1)
    thresh = torch.where(inner, fm[ints(0, w, n_trees, m).long(),
                                   feat.clamp(min=0).long()], 0.0)
    left = torch.where(inner, 2 * node + 1, node).expand(n_trees, m)
    right = torch.where(inner, 2 * node + 2, node).expand(n_trees, m)
    value = torch.where(inner, 0.0, 0.5 * randn(n_trees, m))
    trees = dict(feat=feat, thresh=thresh, left=left.contiguous(),
                 right=right.contiguous(), value=value, max_depth=depth)
    raw = predict_margin(TreeEnsemble(**trees, base=torch.zeros((),
                                                                device=dev)),
                         fm)
    clf = TreeEnsemble(**trees, base=-raw[stage].median())
    lanes = (snap_s, snap_i, ints(0, k + 1, w, chunk), h, active, qvec,
             sims, rs1, phi, phi1,
             torch.tensor(7, dtype=torch.int64, device=dev),
             ints(tau + 1, 81, w))
    # the least bytes: ids and count of each history column the chunk
    # writes, RS_1 and both history rows in and out, each lane's h,
    # active, cap in and out, and every node once
    col = torch.arange(hist_w, device=dev)[None, :] + 1 - h[:, None]
    cols = int(((col >= 0) & (col < chunk) & (h[:, None] + col < N_PROBE)
                & active[:, None]).sum()) if tau > 1 else 0
    n_bytes = (cols * (k + 1) * 4 + w * (2 * k + 4 * hist_w) * 4
               + w * 13 + n_trees * m * 20)
    kw = dict(tau=tau, k=k, chunk=chunk, n_probe=N_PROBE, threshold=0.5)
    return lanes, clf, kw, n_bytes, int(stage.sum())


def bound(n_bytes, n_flops, flops_per_s=F32_FLOPS_PER_S):
    """The least ms for the work: its bytes over the memory rate or its
    operations over the peak rate, whichever is longer, and which."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# -- the model zoo: StarCoder2-3B serving and DeepFM serving -----------------
# These run inside main(); ``ctx``, built there once, carries the device,
# the phase timer, the launch counters, the timing helper and the table of
# each kernel's error, so the same functions can be rehearsed on the CPU
# at reduced configs.

LM_ARCH, LM_PROMPTS, LM_PROMPT_LEN, LM_DECODE = "starcoder2-3b", 4, 2048, 16
# the rest of the LM zoo at its published widths, each (phase prefix,
# arch, cuts): depth is cut only where the card cannot hold the model
# (Qwen1.5-32B is 135 GB in f32 whole, DBRX 263 GB in bf16 whole), and
# DeepSeekMoE and DBRX keep bf16 master weights
LM_ZOO = (("minicpm3", "minicpm3-4b", {}),
          ("qwen_int8", "qwen1.5-32b", dict(n_layers=16)),
          ("deepseek_moe", "deepseek-moe-16b",
           dict(param_dtype="bfloat16")),
          ("dbrx", "dbrx-132b", dict(n_layers=4, param_dtype="bfloat16")))
RS_ARCH, RS_P99_BATCH, RS_P99_CALLS, RS_BULK_BATCH = \
    "deepfm", 512, 8, 262_144
# tests/test_models_lm.py:38-47's bounds on log-softmax differences
PREFILL_TOL, DECODE_TOL = 0.15, 0.25
# the MoE harness (lm_serve): a served token routed otherwise than the
# forward in some layer is left out of those bounds.  Its first
# differing choice must be a near tie, the forward's expert within
# ROUTE_TIE of the step's own k-th router log-probability (read on the
# card: at most 0.0365), and at most these shares of the prefill's and
# the decode steps' tokens may differ (read: no prefill token; 51 and 2
# of the 64 decode tokens of DeepSeekMoE and DBRX, whose M=4 products
# round otherwise than the forward's M=8,256)
#
# The MoE training hold (lm_train) masks the tokens that the kernel and
# plain paths route otherwise, and holds them to the same ROUTE_TIE, in
# place of tests/test_torch_train.py's rule against the reference on the
# CPU (a probability gap under 1e-3, at most 5% of 128 tokens): at
# DeepSeekMoE's published width (64 experts, top 6) the card's first
# run of that rule found 778 of 8,192 tokens routed otherwise, the worst
# probability gap 0.00178; at the drop-free factor 816 (9.96%), 0.00104.
# A probability gap scales with the router's probabilities, a
# log-probability gap is the relative noise that the kernel's bf16
# rounding of P makes (read: worst 0.0299); the share is capped by what
# the paths' own router noise can swap (route_flips; read: 0.0996 under
# a cap of 0.366).
ROUTE_TIE = 0.05
PREFILL_SWAP_SHARE, DECODE_SWAP_SHARE = 0.001, 0.9
# f32 flash_attention against its plain version, (atol, rtol): f32 sums
# in another order.  bf16 is held to kernels.flash_attention.bf16_bound
# instead (the kernel rounds P to bf16 before P V).
FLASH_F32_TOL = (2e-5, 2e-5)
# serve_logits against the same forward from emb.sum(1): f32 sums in
# another order (rtol), logits near 0 (atol)
RS_RTOL, RS_ATOL = 1e-5, 1e-6


def profile_run(sync, what, fn, top=10):
    """Run ``fn`` once under the profiler: its host wall, the device's
    busy and idle share of it, and the ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1000
    dev = {ev.key: (ev.device_time_total / 1e3, ev.count)
           for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}
    busy = sum(ms for ms, _ in dev.values())
    print(f"profiled {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}% of wall, idle "
          f"{100 - 100 * busy / wall:.1f}%), "
          f"{sum(n for _, n in dev.values())} device operations")
    for name, (ms, cnt) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:9.3f} ms  x{cnt:<5d} {name[:90]}")


def check_flash(got, q, k, v, causal):
    """Hold flash_attention's output ``got`` of q, k, v against its plain
    version's: f32 within FLASH_F32_TOL, bf16 within ``bf16_bound``.
    Returns the max abs difference and the max of |got - want| / bound
    (None in f32)."""
    import torch
    from repro_torch.kernels import flash_attention as k_fa

    want = k_fa.flash_attention_plain(q, k, v, causal=causal)
    if got.dtype != q.dtype:
        raise AssertionError("flash_attention: output dtype")
    diff = (got.float() - want.float()).abs()
    if q.dtype == torch.float32:
        atol, rtol = FLASH_F32_TOL
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
        return float(diff.max()), None
    ratio = float((diff / k_fa.bf16_bound(q, k, v, want,
                                          causal=causal)).max())
    if not ratio <= 1.0:
        raise AssertionError(f"flash_attention (bf16): |got - want| reaches "
                             f"{ratio} of its bound")
    return float(diff.max()), ratio


SASS_FAMILIES = ("flash_attention_bf16", "delta_scan",
                 "ivf_scan_merge_kernel")
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "UBLKCP", "LDGSTS")


def sass_counts(so):
    """Count, in the built library ``so``, the tensor-core, TMA and async
    copy instructions of each kernel whose name holds one of
    ``SASS_FAMILIES`` (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = next((k for k in SASS_FAMILIES if k in name), None)
            if fn:
                # the kernel's name from the family on (template arguments)
                name = name[name.index(fn):][:48]
                counts.setdefault(fn, {})[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        op = re.search(r"\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z0-9_]+)", line)
        if fn and op and op.group(1) in counts[fn][name]:
            counts[fn][name][op.group(1)] += 1
    return counts


def model_zoo_kernels_vs_plain(ctx):
    """flash_attention (causal and not, f32 and bf16, hd 64 and 128, S a
    tile multiple and not; bf16 also at MLA's qk 96, v 64) and
    embedding_bag (D 1, 10, 16; F 1, 39) on the card against their plain
    versions, off the main path's shapes (``model_zoo_timing`` holds both
    at those)."""
    import numpy as np
    import torch
    from repro_torch.kernels import embedding_bag as k_eb
    from repro_torch.kernels import flash_attention as k_fa

    rng = np.random.default_rng(11)
    for s in (512, 2064):
        for hd in (64, 128):
            q, k, v = (torch.from_numpy(rng.normal(size=(8, s, hd)).astype(
                np.float32)).to(ctx.dev) for _ in range(3))
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
                for causal in (True, False):
                    got = k_fa.flash_attention(qd, kd, vd, causal=causal)
                    ctx.sync()
                    err, ratio = check_flash(got, qd, kd, vd, causal)
                    within = (f"(atol, rtol {FLASH_F32_TOL})"
                              if ratio is None else
                              f"max |got - want| / bound {ratio}")
                    print(f"flash_attention (S={s}, hd={hd}, {dtype}, "
                          f"causal={causal}): max_abs_err {err} {within}")
        # MLA's heads: q, k 96 = 64 nope + 32 rope, v 64; bf16 only
        q, k = (torch.from_numpy(rng.normal(size=(8, s, 96)).astype(
            np.float32)).to(ctx.dev).bfloat16() for _ in range(2))
        v = torch.from_numpy(rng.normal(size=(8, s, 64)).astype(
            np.float32)).to(ctx.dev).bfloat16()
        for causal in (True, False):
            got = k_fa.flash_attention(q, k, v, causal=causal)
            ctx.sync()
            if got.shape != (8, s, 64):
                raise AssertionError(f"flash_attention (96, 64): output "
                                     f"shape {tuple(got.shape)}")
            err, ratio = check_flash(got, q, k, v, causal)
            print(f"flash_attention (S={s}, qk 96, v 64, bf16, "
                  f"causal={causal}): max_abs_err {err} max |got - want| / "
                  f"bound {ratio}")
    for d in (1, 10, 16):
        table = torch.from_numpy(rng.normal(size=(100_000, d)).astype(
            np.float32)).to(ctx.dev)
        for f in (1, 39):
            ids = torch.from_numpy(rng.integers(0, 100_000, (4096, f)).astype(
                np.int32)).to(ctx.dev)
            got = k_eb.embedding_bag(table, ids)
            ctx.sync()
            if not torch.equal(got, k_eb.embedding_bag_plain(table, ids)):
                raise AssertionError(f"embedding_bag (D={d}, F={f}): not "
                                     f"bit-equal")
            print(f"embedding_bag (D={d}, F={f}): bit-equal")


def cache_report(cfg, cache):
    """The cache's bytes, and beside them: for an int8 cache its ratio to
    the bf16 cache of the same shape, for MLA's latent cache its ratio to
    the per-head K/V cache it replaces (the rule of
    tests/test_models_lm.py::test_mla_cache_is_small: under 1/10)."""
    n_bytes = sum(c.numel() * c.element_size() for c in cache.data)
    out = dict(cache_kind=cache.kind, cache_bytes=n_bytes)
    if cache.kind == "gqa8":
        k = cache.data[0]
        out["bf16_cache_bytes"] = 2 * k.numel() * 2
        out["ratio_to_bf16_cache"] = n_bytes / out["bf16_cache_bytes"]
    if cache.kind == "mla":
        l_, b_, smax = cache.data[0].shape[:3]
        out["gqa_cache_bytes"] = l_ * 2 * b_ * smax * cfg.n_heads \
            * cfg.head_dim() * 2
        out["ratio_to_gqa_cache"] = n_bytes / out["gqa_cache_bytes"]
        if not out["ratio_to_gqa_cache"] < 0.1:
            raise AssertionError(f"the MLA cache is not under 1/10 of the "
                                 f"GQA cache: {out}")
    return out


def expected_params(cfg):
    """The parameter count of ``cfg``'s tree: ``param_count()`` (which
    holds for GQA, MoE and dense layers) plus ``ln_f``, plus MLA's two
    latent norms a layer, which ``param_count`` leaves out (held against
    the JAX trees in tests/test_torch_models_zoo.py)."""
    n = cfg.param_count() + cfg.d_model
    if cfg.attn_type == "mla":
        n += cfg.n_layers * (cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank)
    return n


def drop_free(cfg):
    """An MoE config at the capacity factor E/k, where an expert's
    capacity is the whole batch: no token is dropped, whatever the batch
    (the reference's smoke configs use 8 for the same reason)."""
    mo = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


def route_swaps(fwd, step, positions, batch):
    """A served step's routing against the forward's for the same tokens.

    ``fwd`` and ``step`` are the two runs' ``RouteLog.calls`` (one per
    MoE layer), ``positions`` the step's slice of the forward's
    positions.  Returns the (B, n) mask of the tokens routed otherwise
    in some layer; for each such token's first differing layer, how far
    the forward's least choice lies under the step's own k-th router
    log-probability (the largest of these; 0.0 if none); and the
    router's noise, max |log p_step - log p_forward| over the experts,
    at each token-layer routed alike so far.  Past a token's first
    differing layer its hidden state differs by design."""
    import torch

    if len(fwd) != len(step):
        raise AssertionError(f"{len(step)} MoE calls against the forward's "
                             f"{len(fwd)}")
    hit, worst, noise = None, 0.0, []
    for (f_p, f_e, _), (s_p, s_e, _) in zip(fwd, step):
        e, k = s_p.shape[1], s_e.shape[1]
        f_e = f_e.reshape(batch, -1, k)[:, positions].reshape(s_e.shape)
        f_p = f_p.reshape(batch, -1, e)[:, positions].reshape(s_p.shape)
        diff = (f_e.sort(-1).values != s_e.sort(-1).values).any(-1)
        hit = torch.zeros_like(diff) if hit is None else hit
        first = diff & ~hit
        if first.any():
            lp = s_p[first].log()
            short = lp.gather(-1, s_e[first]).min(-1).values \
                - lp.gather(-1, f_e[first]).min(-1).values
            worst = max(worst, float(short.max()))
        alike = ~(diff | hit)
        noise.append((s_p[alike].log() - f_p[alike].log()).abs().amax(-1))
        hit |= diff
    return hit.reshape(batch, -1), worst, torch.cat(noise)


def swap_share_expected(fwd, noise):
    """The share of tokens a router noise of ``noise`` (a log-probability)
    would route otherwise in some MoE layer, read off the forward's own
    routing: a token-layer whose k-th and (k+1)-th router
    log-probabilities lie within ``noise`` is taken to swap."""
    import torch

    keep = 1.0
    for f_p, f_e, _ in fwd:
        top = f_p.log().topk(f_e.shape[1] + 1, -1).values
        keep *= 1.0 - float(((top[:, -2] - top[:, -1]) < noise).float()
                            .mean())
    return 1.0 - keep


def drop_report(log, capacity):
    """What the route log of a prefill at the published capacity factor
    says of its drops: the dropped share, its range over the MoE layers,
    and the most any layer's busiest expert took of the assignments and
    the most experts a layer held past their ``capacity``."""
    import torch

    shares, busiest, over = [], [], []
    for _, top_e, dropped in log.calls:
        load = torch.bincount(top_e.reshape(-1))
        shares.append(int(dropped) / top_e.numel())
        busiest.append(int(load.max()) / top_e.numel())
        over.append(int((load > capacity).sum()))
    return dict(dropped_assignments=log.dropped(),
                dropped_share=log.dropped() / log.assigned(),
                layer_dropped_share=[min(shares), max(shares)],
                busiest_expert_share=max(busiest),
                experts_over_capacity=max(over))


def lm_serve(ctx, cfg, *, name="lm", prompts=LM_PROMPTS,
             prompt_len=LM_PROMPT_LEN, n_decode=LM_DECODE, seed=0):
    """An LM's serving on seeded random weights: init, prefill of
    ``prompts`` Zipf prompts, ``n_decode`` decode steps fed the stream's
    next tokens, and both held against ``forward`` over the whole
    sequence; phases ``{name}_*``.

    An MoE config serves at its own (published) capacity factor, whose
    prefill drops assignments that depend on the batch; decode's 4
    tokens are under the capacity floor of 8, and drop none.  So its
    consistency phase is a harness: the same prefill, decode steps and
    forward at the drop-free factor E/k, where each served token is held
    to the bounds unless its own routing differs from the forward's (a
    near tie, checked, and a share of the tokens, bounded).  Returns the
    serving summary."""
    import contextlib

    import numpy as np
    import torch
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_map

    max_seq = prompt_len + n_decode
    summary = dict(model=cfg.name, n_layers=cfg.n_layers)
    with ctx.phase(f"{name}_init"):
        ctx.reset_peak()
        params = transformer.init_params(cfg, seed=seed, device=ctx.dev)
        ctx.sync()
        leaves = []
        tree_map(leaves.append, params)
        n = sum(t.numel() for t in leaves)
        attn = (f"MLA (q_lora {cfg.mla.q_lora_rank}, kv_lora "
                f"{cfg.mla.kv_lora_rank}, qk {cfg.mla.qk_nope_head_dim}+"
                f"{cfg.mla.qk_rope_head_dim}, v {cfg.mla.v_head_dim})"
                if cfg.attn_type == "mla" else f"kv={cfg.n_kv_heads}")
        ffn = (f"MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
               f"(+{cfg.moe.n_shared} shared, d_ff_expert "
               f"{cfg.moe.d_ff_expert}, capacity factor "
               f"{cfg.moe.capacity_factor}, {cfg.moe.first_k_dense} dense "
               f"first)" if cfg.moe else f"d_ff={cfg.d_ff}")
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        print(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
              f"{cfg.n_heads} heads, {attn}, {ffn}, vocab {cfg.vocab_size}, "
              f"{cfg.param_dtype} weights, {cfg.kv_cache_dtype} KV: {n} "
              f"parameters ({n_bytes} bytes; expected {expected_params(cfg)}:"
              f" config param_count + ln_f"
              f"{' + MLA norms' if cfg.attn_type == 'mla' else ''})")
        if n != expected_params(cfg):
            raise AssertionError("parameter count differs from the config's")
        summary.update(params=n, param_bytes=n_bytes,
                       init_peak_device_mem_bytes=ctx.peak())
    toks = token_stream(prompts * max_seq, cfg.vocab_size, seed=seed) \
        .reshape(prompts, max_seq)

    def routed():
        return moe_lib.route_log() if cfg.moe else contextlib.nullcontext()

    with ctx.phase(f"{name}_prefill"):
        # twice: the first call pays for the GEMM heuristics and the
        # allocator's first blocks (and logs the routing), the second is
        # the steady state
        walls = []
        for i in range(2):
            ctx.reset()
            ctx.reset_peak()
            ctx.sync()
            t0 = time.perf_counter()
            with routed() if i == 0 else contextlib.nullcontext() as log:
                logits, cache = transformer.prefill(
                    cfg, params, toks[:, :prompt_len], max_seq=max_seq)
                ctx.sync()
            walls.append((time.perf_counter() - t0) * 1000)
            if i == 0 and cfg.moe:
                drops = drop_report(log, moe_lib.capacity_of(
                    prompts * prompt_len, cfg))
                del log
        wall = walls[-1]
        counts = ctx.read(f"{cfg.name} prefill ({prompts} x {prompt_len})",
                          ["flash_attention"], absent=["embedding_bag"])
        if counts["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"prefill launched flash_attention "
                                 f"{counts['flash_attention']} times, not "
                                 f"{cfg.n_layers}")
        if logits.shape != (prompts, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite or of the "
                                 "expected shape")
        summary.update(prefill_wall_ms=wall,
                       prefill_wall_ms_first_call=walls[0],
                       prompt_tokens_per_s=prompts * prompt_len
                       / (wall / 1000),
                       peak_device_mem_bytes=ctx.peak(),
                       flash_attention_launches=counts["flash_attention"],
                       **cache_report(cfg, cache))
        print(json.dumps(summary))
        if cfg.moe:
            # the drops, and what they come from: the same prefill on
            # uniformly drawn tokens (no Zipf head), untimed
            uniform = torch.from_numpy(np.random.default_rng(seed).integers(
                0, cfg.vocab_size, (prompts, prompt_len)))
            with moe_lib.route_log() as log:
                transformer.prefill(cfg, params, uniform, max_seq=max_seq)
            drops_u = drop_report(log, moe_lib.capacity_of(
                prompts * prompt_len, cfg))
            del log
            summary.update(capacity_factor=cfg.moe.capacity_factor,
                           dropped_assignments=drops["dropped_assignments"],
                           dropped_share=drops["dropped_share"],
                           dropped_share_uniform_tokens=drops_u[
                               "dropped_share"])
            print(json.dumps(dict(zipf_prompts=drops,
                                  uniform_tokens=drops_u)))
    ctx.reset()
    with ctx.phase(f"{name}_decode"):
        step_ms, steps = [], []
        for i in range(n_decode):
            pos = prompt_len + i
            ctx.sync()
            t0 = time.perf_counter()
            with routed() if i == 0 else contextlib.nullcontext() as log:
                lg, cache = transformer.decode_step(cfg, params, cache,
                                                    toks[:, pos: pos + 1],
                                                    pos)
                ctx.sync()
            step_ms.append((time.perf_counter() - t0) * 1000)
            steps.append(lg)
            if i == 0 and cfg.moe and log.dropped():
                raise AssertionError(f"decode dropped {log.dropped()} "
                                     f"assignments under the capacity "
                                     f"floor")
        ctx.read(f"{cfg.name} decode", [],
                 absent=["flash_attention", "embedding_bag"])
        if not all(torch.isfinite(lg).all() for lg in steps):
            raise AssertionError("decode logits are not finite")
        summary.update(ms_per_step_median=float(np.median(step_ms)),
                       decode_tokens_per_s=prompts * n_decode
                       / (sum(step_ms) / 1000))
        print(json.dumps(dict(decode_steps=n_decode, batch=prompts,
                              ms_per_step_median=float(np.median(step_ms)),
                              ms_per_step=step_ms,
                              decode_tokens_per_s=prompts * n_decode
                              / (sum(step_ms) / 1000))))
    ctx.reset()
    with ctx.phase(f"{name}_consistency"):
        harness = drop_free(cfg) if cfg.moe else cfg
        with routed() as fwd_log:
            full, _ = transformer.forward(harness, params, toks)
        ctx.sync()
        counts = ctx.read(f"{cfg.name} forward ({prompts} x {max_seq})",
                          ["flash_attention"])
        if counts["flash_attention"] != cfg.n_layers:
            raise AssertionError("forward did not launch flash_attention "
                                 "once per layer")
        # per token: (B,) max |log-softmax - forward's| and whether its
        # routing differed from the forward's
        swapped, worst = [], 0.0
        if cfg.moe:
            with moe_lib.route_log() as log:
                logits, cache = transformer.prefill(
                    harness, params, toks[:, :prompt_len], max_seq=max_seq)
            hit, w, _ = route_swaps(fwd_log.calls, log.calls,
                                    slice(0, prompt_len), prompts)
            swapped.append(hit)
            worst, steps, noise = w, [], []
            for i in range(n_decode):
                pos = prompt_len + i
                with moe_lib.route_log() as log:
                    lg, cache = transformer.decode_step(
                        harness, params, cache, toks[:, pos: pos + 1], pos)
                steps.append(lg)
                hit, w, nz = route_swaps(fwd_log.calls, log.calls,
                                         slice(pos, pos + 1), prompts)
                swapped.append(hit)
                noise.append(nz)
                worst = max(worst, w)
            # how many decode tokens the decode steps' router noise
            # would swap, by the forward's own near ties
            noise = float(torch.cat(noise).median())
            expected = swap_share_expected(fwd_log.calls, noise)
            del log, fwd_log

        def lsm(x):
            return torch.log_softmax(x.float(), -1)

        pre_err = (lsm(logits) - lsm(full[:, prompt_len - 1])).abs() \
            .amax(-1)
        dec_err = torch.stack([(lsm(lg) - lsm(full[:, prompt_len + i]))
                               .abs().amax(-1) for i, lg in enumerate(steps)])
        pre_own = dec_own = torch.zeros(0, dtype=torch.bool, device=ctx.dev)
        if cfg.moe:
            pre_own = swapped[0][:, -1]
            dec_own = torch.stack([h[:, 0] for h in swapped[1:]])
        held_pre = pre_err[~pre_own] if cfg.moe else pre_err
        held_dec = dec_err[~dec_own] if cfg.moe else dec_err
        pre_max = float(held_pre.max()) if held_pre.numel() else 0.0
        dec_max = float(held_dec.max()) if held_dec.numel() else 0.0
        print(f"log-softmax max |prefill - forward| {pre_max} (bound "
              f"{PREFILL_TOL}); |decode - forward| per step "
              f"{dec_err.amax(-1).tolist()} (bound {DECODE_TOL})")
        summary.update(prefill_vs_forward=pre_max,
                       decode_vs_forward_max=dec_max)
        if cfg.moe:
            pre_share = float(swapped[0].float().mean())
            dec_share = float(dec_own.float().mean())
            print(json.dumps(dict(
                harness_capacity_factor=harness.moe.capacity_factor,
                prefill_tokens_routed_otherwise=int(swapped[0].sum()),
                prefill_tokens=swapped[0].numel(),
                decode_tokens_routed_otherwise=int(dec_own.sum()),
                decode_tokens=dec_own.numel(),
                decode_router_noise_median=noise,
                decode_swap_share_expected_from_noise=expected,
                worst_first_swap_log_gap=worst,
                decode_err_routed_otherwise=dec_err[dec_own].tolist(),
                held_prefill_vs_forward=pre_max,
                held_decode_vs_forward=dec_max,
                bounds=dict(route_tie=ROUTE_TIE,
                            prefill_swap_share=PREFILL_SWAP_SHARE,
                            decode_swap_share=DECODE_SWAP_SHARE))))
            summary.update(
                prefill_tokens_routed_otherwise=int(swapped[0].sum()),
                decode_tokens_routed_otherwise=int(dec_own.sum()),
                decode_vs_forward_routed_otherwise_max=float(
                    dec_err[dec_own].max()) if dec_own.any() else 0.0,
                worst_first_swap_log_gap=worst)
            if worst >= ROUTE_TIE:
                raise AssertionError(f"a token's routing differs from the "
                                     f"forward's {worst} under its own k-th "
                                     f"router log-probability (bound "
                                     f"{ROUTE_TIE})")
            if pre_share > PREFILL_SWAP_SHARE or \
                    dec_share > DECODE_SWAP_SHARE:
                raise AssertionError(f"tokens routed otherwise than the "
                                     f"forward: {pre_share} of the prefill's"
                                     f", {dec_share} of the decode steps'")
        if pre_max >= PREFILL_TOL or dec_max >= DECODE_TOL:
            raise AssertionError("prefill/decode disagree with forward")
    del full, steps
    with ctx.phase(f"{name}_profile"):
        # the same prefill again, and the last decode step again (it
        # rewrites the cache slot with the same values)
        ctx.profile(f"{cfg.name} prefill ({prompts} x {prompt_len})",
                    lambda: transformer.prefill(cfg, params,
                                                toks[:, :prompt_len],
                                                max_seq=max_seq))
        pos = max_seq - 1
        ctx.profile(f"{cfg.name} decode step", lambda: transformer.decode_step(
            cfg, params, cache, toks[:, pos: pos + 1], pos))
    del params, cache, logits
    return summary


def recsys_serve(ctx, cfg, *, p99_batch=RS_P99_BATCH, p99_calls=RS_P99_CALLS,
                 bulk_batch=RS_BULK_BATCH, seed=0):
    """DeepFM serving on seeded random weights: ``p99_calls`` batches of
    ``serve_p99`` and one of ``serve_bulk`` from ``click_log``, each call
    two embedding_bag launches; every batch's logits against the same
    forward computed from ``emb.sum(1)``.  Returns the params and the
    bulk batch's combined-table rows (the timing phase's inputs)."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import click_log
    from repro_torch.models import recsys

    with ctx.phase("recsys_init"):
        params = recsys.init_params(cfg, seed=seed, device=ctx.dev)
        ctx.sync()
        n_bytes = 4 * (params["table"].numel()
                       + params["linear_table"].numel())
        print(f"{cfg.name}: {cfg.n_sparse} fields x {cfg.rows_per_field} "
              f"rows, D={cfg.embed_dim}, MLP {cfg.mlp}: table "
              f"{tuple(params['table'].shape)}, {n_bytes} bytes of tables")
    batches = [("serve_p99", click_log(p99_batch, cfg.n_dense, cfg.n_sparse,
                                       cfg.rows_per_field, seed=seed + i))
               for i in range(p99_calls)]
    batches.append(("serve_bulk", click_log(bulk_batch, cfg.n_dense,
                                            cfg.n_sparse, cfg.rows_per_field,
                                            seed=seed + 100)))

    def from_sum(batch):
        """DeepFM's forward with the bags summed as emb.sum(1)."""
        ids = torch.as_tensor(batch["sparse"], device=ctx.dev)
        emb = recsys.embedding_lookup(params["table"], ids, cfg)
        lin = recsys.embedding_lookup(params["linear_table"], ids,
                                      recsys.dataclass_like(cfg)).sum((1, 2))
        sv = emb.sum(1)
        fm = 0.5 * (sv * sv - (emb * emb).sum(1)).sum(1)
        deep = recsys._mlp_apply(params["mlp"],
                                 emb.reshape(emb.shape[0], -1))[:, 0]
        return lin + fm + deep

    with ctx.phase("recsys_serve"):
        ms = {"serve_p99": [], "serve_bulk": []}
        for i, (shape, batch) in enumerate(batches):
            ctx.reset()
            ctx.sync()
            t0 = time.perf_counter()
            out = recsys.serve_logits(cfg, params, batch)
            ctx.sync()
            ms[shape].append((time.perf_counter() - t0) * 1000)
            counts = ctx.read(f"recsys {shape} (batch {len(out)})",
                              ["embedding_bag"], absent=["flash_attention"])
            if counts["embedding_bag"] != 2:
                raise AssertionError(f"serve_logits launched embedding_bag "
                                     f"{counts['embedding_bag']} times")
            if out.shape != (batch["sparse"].shape[0],) or \
                    not torch.isfinite(out).all():
                raise AssertionError("serve logits are not finite or of the "
                                     "expected shape")
            torch.testing.assert_close(out, from_sum(batch), rtol=RS_RTOL,
                                       atol=RS_ATOL)
        print(json.dumps(dict(
            serve_p99_ms=ms["serve_p99"],
            serve_p99_ms_median=float(np.median(ms["serve_p99"])),
            serve_bulk_ms=ms["serve_bulk"][0],
            serve_bulk_examples_per_s=bulk_batch
            / (ms["serve_bulk"][0] / 1000))))
        print(f"serve_logits == forward from emb.sum(1) on every batch "
              f"(rtol {RS_RTOL}, atol {RS_ATOL}); host-to-device copy of "
              f"each batch included in its ms")
    with ctx.phase("recsys_profile"):
        for shape, batch in (batches[-2], batches[-1]):
            ctx.profile(f"{shape} call (batch {batch['sparse'].shape[0]})",
                        lambda: recsys.serve_logits(cfg, params, batch))
    ids = torch.as_tensor(batches[-1][1]["sparse"], device=ctx.dev)
    return params, recsys._combined_ids(ids, cfg).contiguous()


def sdpa_backend(q, k, v):
    """The backend ``scaled_dot_product_attention`` picks for these
    (B, H, S, d) inputs, causal (PyTorch's own choice, ``SDPBackend``)."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)) \
            .name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


def mla_flash_row(ctx, cfg, launches, *, batch=None, s=None,
                  name="flash_attention (qk 96, v 64)", seed=6):
    """flash_attention at MiniCPM3's prefill shapes (BH = prompts x 40
    heads, S 2,048, qk 96, v 64, bf16, causal), or at ``batch`` x ``s``:
    held against its plain version, then timed beside it and beside
    ``scaled_dot_product_attention`` (the backend it picked named); its
    bound is the larger of BH S (S+1) (dqk + dv) operations at the bf16
    peak and the bytes of q, k, v and o at the memory rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k_fa

    dqk, dv = qk_v_dims(cfg)
    batch = batch or LM_PROMPTS
    s = s or LM_PROMPT_LEN
    bh = batch * cfg.n_heads
    g = torch.Generator(device=ctx.dev).manual_seed(seed)
    q, k = (torch.randn((bh, s, dqk), generator=g, device=ctx.dev)
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn((bh, s, dv), generator=g, device=ctx.dev) \
        .to(torch.bfloat16)
    flops = bh * s * (s + 1) * (dqk + dv)
    n_bytes = bh * s * (2 * dqk + 2 * dv) * 2
    bnd = bound(n_bytes, flops, BF16_FLOPS_PER_S)
    got = k_fa.flash_attention(q, k, v, causal=True)
    ctx.sync()
    err, ratio = check_flash(got, q, k, v, True)
    del got
    shp = (batch, cfg.n_heads, s)
    qs, ks_, vs = q.view(*shp, dqk), k.view(*shp, dqk), v.view(*shp, dv)
    backend = sdpa_backend(qs, ks_, vs)
    print(f"{name} (BH={bh}, S={s}, qk {dqk}, v {dv}, bf16, causal): "
          f"{flops:.6e} FLOP, {n_bytes} bytes, bound {bnd[0]:.6f} ms "
          f"({bnd[1]}); max_abs_err {err}, max |got - want| / bound "
          f"{ratio}; scaled_dot_product_attention runs {backend}")
    return dict(
        name=name, counter="flash_attention",
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:65",
        launches=launches, max_abs_err=err,
        ms=ctx.time_call(name,
                         lambda: k_fa.flash_attention(q, k, v, causal=True),
                         10, profiled=True),
        plain_ms=ctx.time_call(f"{name} plain",
                               lambda: k_fa.flash_attention_plain(
                                   q, k, v, causal=True), 5),
        bound=bnd,
        library_ms=ctx.time_call(
            f"scaled_dot_product_attention ({backend})",
            lambda: F.scaled_dot_product_attention(qs, ks_, vs,
                                                   is_causal=True), 20))


def flash_row(ctx, name, batch, heads, s, hd, seed, launches=None):
    """flash_attention at (batch x heads, s, hd), random bf16, causal: held
    against its plain version (its row's ``max_abs_err``), then timed
    beside it and beside ``scaled_dot_product_attention``; its bound the
    larger of the causal products at the bf16 peak and the bytes of q,
    k, v and o."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k_fa

    bh = batch * heads
    g = torch.Generator(device=ctx.dev).manual_seed(seed)
    q, k, v = (torch.randn((bh, s, hd), generator=g, device=ctx.dev)
               .to(torch.bfloat16) for _ in range(3))
    flops = 4 * bh * hd * s * (s + 1) / 2
    n_bytes = 4 * bh * s * hd * 2
    print(f"{name}: {flops:.6e} causal FLOP, {n_bytes} bytes; at the f32 "
          f"CUDA-core peak {flops / F32_FLOPS_PER_S * 1e3:.6f} ms")
    got = k_fa.flash_attention(q, k, v, causal=True)
    ctx.sync()
    err, ratio = check_flash(got, q, k, v, True)
    print(f"{name} (BH={bh}, S={s}, hd={hd}, bf16, causal): max_abs_err "
          f"{err}, max |got - want| / bound {ratio}")
    del got

    def sdpa():
        shp = (batch, heads, s, hd)
        return F.scaled_dot_product_attention(
            q.view(shp), k.view(shp), v.view(shp), is_causal=True)

    row = dict(
        name=name, counter="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:65", max_abs_err=err,
        ms=ctx.time_call(name, lambda: k_fa.flash_attention(
            q, k, v, causal=True), 10, profiled=True),
        plain_ms=ctx.time_call(f"{name} plain",
                               lambda: k_fa.flash_attention_plain(
                                   q, k, v, causal=True), 5),
        bound=bound(n_bytes, flops, BF16_FLOPS_PER_S),
        library_ms=ctx.time_call(f"{name}: scaled_dot_product_attention",
                                 sdpa, 20))
    if launches is not None:
        row["launches"] = launches
    return row


def model_zoo_timing(ctx, lm_cfg, table, linear_table, rows):
    """Timing rows of flash_attention (the prefill's shapes, random bf16)
    and embedding_bag (the bulk batch on both DeepFM tables: D=10 and the
    D=1 ``linear_table``), each first held against its plain version on
    those inputs: its row's ``max_abs_err``."""
    row = flash_row(ctx, "flash_attention", LM_PROMPTS, lm_cfg.n_heads,
                    LM_PROMPT_LEN, lm_cfg.head_dim(), 5)
    ctx.max_err["flash_attention"] = row["max_abs_err"]
    rows_out = [row]
    for tab, name in ((table, "embedding_bag"),
                      (linear_table, "embedding_bag (linear_table)")):
        rows_out.append(embedding_bag_row(ctx, tab, rows, name))
    return rows_out


def sector_bytes(rows_u, d, sector=32):
    """Bytes of the distinct ``sector``-byte sectors that the distinct
    rows ``rows_u`` of a (R, d) f32 table touch: the card reads whole
    32-byte sectors, so a 40-byte row at offset 40 r spans two."""
    import torch

    start = rows_u.long() * (d * 4) // sector
    end = (rows_u.long() * (d * 4) + d * 4 - 1) // sector
    span = int((end - start).max()) + 1
    sec = start[:, None] + torch.arange(span, device=rows_u.device)[None]
    return int(torch.unique(sec[sec <= end[:, None]]).numel()) * sector


def embedding_bag_row(ctx, table, rows, name):
    """embedding_bag on ``table`` at the bulk batch's rows: held bit for
    bit against its plain version, then timed beside it and beside
    ``F.embedding_bag``; the bound reads the ids once, writes the output
    once and reads the distinct 32-byte sectors of the distinct rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as k_eb

    b, f = rows.shape
    d = table.shape[1]
    distinct = torch.unique(rows)
    row_bytes = sector_bytes(distinct, d)
    n_bytes = b * f * 4 + b * d * 4 + row_bytes
    old_bytes = b * f * 4 + b * d * 4 + int(distinct.numel()) * d * 4
    bnd = bound(n_bytes, b * f * d, F32_FLOPS_PER_S)
    print(f"{name}: {b} bags x {f} ids, D={d}: {int(distinct.numel())} "
          f"distinct rows of {table.shape[0]} in {row_bytes} bytes of "
          f"32-byte sectors; {n_bytes} bytes, bound {bnd[0]:.6f} ms "
          f"({bnd[1]}); at {d * 4} bytes a distinct row instead "
          f"{old_bytes} bytes, {old_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms")
    got = k_eb.embedding_bag(table, rows)
    ctx.sync()
    if not torch.equal(got, k_eb.embedding_bag_plain(table, rows)):
        raise AssertionError(f"{name} at the bulk batch's shapes: not "
                             f"bit-equal to its plain version")
    print(f"{name} at the bulk batch's shapes: bit-equal")
    return dict(
        name=name, counter="embedding_bag", route="cuda",
        source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:28", max_abs_err=0.0,
        ms=ctx.time_call(name, lambda: k_eb.embedding_bag(table, rows), 20,
                         profiled=True),
        plain_ms=ctx.time_call(f"{name} plain",
                               lambda: k_eb.embedding_bag_plain(table, rows),
                               5),
        bound=bnd,
        library_ms=ctx.time_call(f"{name}: F.embedding_bag(mode='sum')",
                                 lambda: F.embedding_bag(rows, table,
                                                         mode="sum"), 20))


# -- training: StarCoder2-3B, the restart drill, DeepFM, the retriever -------
# These run inside main() after the serving phases of the model zoo, with
# the same ``ctx``; rehearse them on the CPU at reduced configs.

# LM_SHAPES' train_4k: sequence 4,096; its global batch of 256 cut to a
# micro-batch of 2 (one card), all 30 layers at published widths
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 4
# the restart drill: published widths cut to 2 layers (a 4 GB checkpoint)
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY = 2, 8, 2
RESTART_FAILS = {3: 1, 5: 1}
# RECSYS_SHAPES' train_batch and retrieval_cand
RS_TRAIN_BATCH, RS_TRAIN_STEPS = 65_536, 4
CAND_N, CAND_D, CAND_K = 1_000_000, 256, 100
RETRIEVER_STEPS = 300
# the kernel path's first step against the plain path's, on the card:
# the loss (relative) and each gradient leaf (max |kernel - plain| over
# the leaf's max |plain|), tests/test_torch_train.py's bounds for the
# port against the reference (bf16 activations on both sides; read on
# the CPU: loss within 2.1e-4, leaves within 0.037 of their scale)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-3, 0.06
# MLA and MoE training at published widths, depth cut to what one card
# holds beside the earlier phases (16 B of f32 weights, gradients and
# AdamW moments a parameter): MiniCPM3-4B's 62 layers to 44 (2.93B
# parameters, ~47 GB of state; 40 layers peaked at 65.8 GB beside a 17 GB
# ballast), DeepSeekMoE-16B's 28 to 4 (1 dense + 3 MoE, 2.27B, ~36 GB)
MLA_TRAIN_LAYERS, MOE_TRAIN_LAYERS = 44, 4


def named_leaves(tree, prefix=""):
    """(path, tensor) pairs of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def grads_vs_plain(g_k, g_p):
    """The worst leaf's max |kernel - plain| over its max |plain|."""
    worst = (0.0, "")
    for (name, a), (_, b) in zip(named_leaves(g_k), named_leaves(g_p)):
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        worst = max(worst, (err / scale if scale else err, name))
    return worst


def same_bits(a, b):
    """Whether two trees of tensors hold the same bits leaf by leaf."""
    import torch

    return all(torch.equal(x, y) for (_, x), (_, y)
               in zip(named_leaves(a), named_leaves(b)))


def attention_backward_row(ctx, cfg, batch, seq, step_ms):
    """The plain attention backward (``flash_attention_backward_plain``)
    of one layer at the training step's shapes, timed by events; its
    bound the larger of the bytes of q, k, v, do in and dq, dk, dv out
    and the causal products of the recompute and the four gradient
    products, BH S (S+1)/2 (3 dqk + 2 dv) x 2 operations, at the bf16
    peak.  Returns its summary (per layer and per step)."""
    import torch
    from repro_torch.kernels import flash_attention as k_fa

    bh = batch * cfg.n_heads
    dqk, dv = qk_v_dims(cfg)
    g = torch.Generator(device=ctx.dev).manual_seed(8)
    q, k = (torch.randn((bh, seq, dqk), generator=g, device=ctx.dev)
            .to(torch.bfloat16) for _ in range(2))
    v, do = (torch.randn((bh, seq, dv), generator=g, device=ctx.dev)
             .to(torch.bfloat16) for _ in range(2))
    flops = bh * seq * (seq + 1) * (3 * dqk + 2 * dv)
    n_bytes = (4 * bh * seq * dqk + 3 * bh * seq * dv) * 2  # q k dq dk; v do dv
    bnd = bound(n_bytes, flops, BF16_FLOPS_PER_S)
    ms = ctx.time_call("flash_attention_backward_plain (one layer)",
                       lambda: k_fa.flash_attention_backward_plain(
                           q, k, v, do, causal=True, chunk=cfg.attn_chunk),
                       5)
    out = dict(bh=bh, s=seq, dqk=dqk, chunk=cfg.attn_chunk, ms_per_layer=ms,
               bound_ms=bnd[0], bound_by=bnd[1], flops=flops,
               bytes=n_bytes, ms_per_step=ms * cfg.n_layers,
               share_of_step=ms * cfg.n_layers / step_ms)
    print(json.dumps({"plain_attention_backward": dict(out, model=cfg.name,
                                                      dv=dv)}))
    return out


def qk_v_dims(cfg):
    """An LM's attention head dims: (qk, v)."""
    if cfg.attn_type == "mla":
        m = cfg.mla
        return m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    return cfg.head_dim(), cfg.head_dim()


def route_flips(cfg, params, tokens):
    """The kernel path's forward against the plain path's, MoE layer by
    layer: the (B, S) mask of the tokens routed otherwise in some layer,
    and the readings the hold is judged by (``route_swaps``' measures,
    the plain path standing for the forward): for each such token's first
    differing choice, how far the plain path's least expert lies under
    the kernel path's k-th router log-probability (worst) and the same
    gap in probability (``tests/test_torch_train.py``'s unit); the
    router noise between the paths, max |log p_kernel - log p_plain|
    over the experts at the token-layers routed alike so far (median,
    99th percentile); the first flips per MoE layer; and the share of
    tokens that the median noise could route otherwise by the kernel
    path's own near ties (``swap_share_expected``, as ``lm_serve``
    reports it): the cap on the share that flips.  The noise is the max
    over 64 experts, more than the two experts at the top-k boundary
    move, so the cap stands above the share it explains (read on the
    card: 0.366 against 0.0996)."""
    import numpy as np
    import torch
    from repro_torch.models import attention, moe, transformer

    with torch.no_grad():
        with moe.route_log() as lk:
            transformer.forward(cfg, params, tokens)
        with attention.plain_attention(), moe.route_log() as lp:
            transformer.forward(cfg, params, tokens)
    b = tokens.shape[0]
    hit, worst_log, noise = route_swaps(lp.calls, lk.calls, slice(None), b)
    seen = torch.zeros(hit.numel(), dtype=torch.bool, device=hit.device)
    worst_p, per_layer = 0.0, []
    for (p_k, e_k, _), (_, e_p, _) in zip(lk.calls, lp.calls):
        diff = (e_k.sort(-1).values != e_p.sort(-1).values).any(-1)
        first = diff & ~seen
        if first.any():
            pk = p_k[first]
            short = pk.gather(-1, e_k[first]).min(-1).values \
                - pk.gather(-1, e_p[first]).min(-1).values
            worst_p = max(worst_p, float(short.max()))
        per_layer.append(int(first.sum()))
        seen |= diff
    nz = noise.float()
    q50, q99 = (float(torch.quantile(nz, q)) for q in (0.5, 0.99))
    readings = dict(masked_tokens=int(hit.sum()), tokens=hit.numel(),
                    flip_share=float(hit.float().mean()),
                    first_flips_per_moe_layer=per_layer,
                    worst_flip_log_gap=worst_log,
                    worst_flip_prob_gap=worst_p,
                    router_noise_median=q50, router_noise_p99=q99,
                    flip_share_cap=swap_share_expected(lk.calls, q50))
    return hit.cpu().numpy(), readings


def moe_parts(cfg, params, batch):
    """A training batch's MoE aux loss and its dropped share of the
    token-expert assignments (the config's own capacity factor)."""
    import torch
    from repro_torch.models import moe, transformer

    with torch.no_grad(), moe.route_log() as log:
        _, parts = transformer.loss_fn(cfg, params, batch)
    return dict(aux=float(parts["aux"]), ce=float(parts["ce"]),
                dropped=log.dropped(), assigned=log.assigned(),
                dropped_share=log.dropped() / max(log.assigned(), 1),
                capacity_factor=cfg.moe.capacity_factor)


def lm_train(ctx, cfg, *, name="lm_train", batch=TRAIN_BATCH,
             seq=TRAIN_SEQ, steps=TRAIN_STEPS, seed=0, timing_row=True):
    """An LM's training on seeded random f32 weights: the first step's
    loss and gradients through the flash kernel's Function held against
    the same step through the plain ``_causal_chunk_attn`` under autograd
    (phase ``lm_train_hold``), then ``steps`` steps of the trainer's
    AdamW on ``lm_batcher``'s batches (``lm_train_steps``: 2 flash
    launches a layer a step, the forward and the remat recompute; one in
    an MoE config's leading dense layers, which run without remat), one
    profiled step, the plain attention backward's share of a step and the
    kernel's timing row at the step's shapes.  An MoE config trains at
    its own capacity factor (the dropped share and the aux loss
    printed); its hold runs at the drop-free factor E/k, as
    ``lm_serve``'s consistency harness does, since at 1.25 a token routed
    otherwise moves which later tokens an expert drops: a token that the
    two paths route otherwise must be a near tie (``ROUTE_TIE``, in
    log-probability), no larger a share of them than the paths' router
    noise can swap (``route_flips``), and its label is masked (-1) on
    both sides.  Phases are named after ``name``.  Returns (summary, that
    row, or None without ``timing_row``)."""
    import functools

    import numpy as np
    import torch
    from repro_torch.data.pipeline import lm_batcher
    from repro_torch.launch import train
    from repro_torch.models import attention, transformer

    batcher = lm_batcher(cfg.vocab_size, batch, seq, seed)
    b0 = batcher.batch(0)
    summary = dict(model=cfg.name, n_layers=cfg.n_layers, batch=batch,
                   seq=seq, params=cfg.param_count())
    # a forward launch a layer, and one in each rematerialised layer's
    # recompute (the reference checkpoints the scanned layers, not an MoE
    # config's leading dense ones)
    per_step = 2 * cfg.n_layers - (cfg.moe.first_k_dense if cfg.moe else 0)
    with ctx.phase(f"{name}_hold"):
        ctx.reset_peak()
        params = transformer.init_params(cfg, seed, device=ctx.dev)
        hold_cfg = drop_free(cfg) if cfg.moe else cfg
        if cfg.moe:
            summary["moe"] = moe_parts(cfg, params, b0)
            flips, rd = route_flips(hold_cfg, params, b0["tokens"])
            b0 = dict(b0, labels=np.where(flips, -1, b0["labels"])
                      .astype(b0["labels"].dtype))
            summary.update(rd)
            print(f"{cfg.name} at capacity factor "
                  f"{cfg.moe.capacity_factor}: {json.dumps(summary['moe'])}; "
                  f"the hold at the drop-free factor "
                  f"{hold_cfg.moe.capacity_factor}, tokens routed otherwise "
                  f"by the kernel and plain paths (labels masked): "
                  f"{json.dumps(rd)} (bounds: worst_flip_log_gap < "
                  f"{ROUTE_TIE}, flip_share <= flip_share_cap)")
            if rd["worst_flip_log_gap"] >= ROUTE_TIE:
                raise AssertionError(f"a token routed otherwise is no near "
                                     f"tie: {rd}")
            if rd["flip_share"] > rd["flip_share_cap"]:
                raise AssertionError(f"more tokens routed otherwise than "
                                     f"the paths' router noise explains: "
                                     f"{rd}")
        loss_of = functools.partial(transformer.loss_fn, hold_cfg, batch=b0)
        ctx.reset()
        ctx.sync()
        t0 = time.perf_counter()
        loss_k, g_k = train.value_and_grad(loss_of, params)
        ctx.sync()
        grad_ms = (time.perf_counter() - t0) * 1000
        counts = ctx.read(f"{cfg.name} loss and gradients ({batch} x {seq})",
                          ["flash_attention"], absent=["embedding_bag"])
        if counts["flash_attention"] != per_step:
            raise AssertionError(f"a gradient step launched flash_attention "
                                 f"{counts['flash_attention']} times, not "
                                 f"{per_step}")
        ctx.reset()
        with attention.plain_attention():
            loss_p, g_p = train.value_and_grad(loss_of, params)
        ctx.sync()
        ctx.read(f"{cfg.name} loss and gradients, plain attention", [],
                 absent=["flash_attention", "embedding_bag"])
        rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        worst, leaf = grads_vs_plain(g_k, g_p)
        hold = dict(loss_kernel=float(loss_k), loss_plain=float(loss_p),
                    loss_rel_err=rel, worst_grad_rel_err=worst,
                    worst_grad_leaf=leaf, first_grad_ms=grad_ms,
                    peak_device_mem_bytes=ctx.peak(),
                    bounds=dict(loss_rtol=TRAIN_LOSS_RTOL,
                                grad_rtol=TRAIN_GRAD_RTOL))
        print(json.dumps({f"{name}_hold": hold}))
        if not np.isfinite(float(loss_k)) or rel > TRAIN_LOSS_RTOL or \
                worst > TRAIN_GRAD_RTOL:
            raise AssertionError(f"the kernel path's first step is off the "
                                 f"plain path's: {hold}")
        summary.update(hold=hold)
        del g_k, g_p
    with ctx.phase(f"{name}_steps"):
        ctx.reset_peak()
        opt = train.trainer_optimizer()
        step_fn = train.make_lm_step(cfg, opt)
        state = (params, opt.init(params),
                 torch.zeros((), dtype=torch.int32, device=ctx.dev))
        del params
        ms, losses, launches = [], [], []
        for i in range(steps):
            b = b0 if i == 0 else batcher.batch(i)
            ctx.reset()
            ctx.sync()
            t0 = time.perf_counter()
            state, loss = step_fn(state, b)
            losses.append(float(loss))
            ctx.sync()
            ms.append((time.perf_counter() - t0) * 1000)
            launches.append(ctx.read(f"{cfg.name} training step {i}",
                                     ["flash_attention"])["flash_attention"])
        med = float(np.median(ms[1:]))
        summary.update(losses=losses, step_ms=ms, step_ms_median_2_on=med,
                       tokens_per_s=batch * seq / (med / 1000),
                       flash_launches_per_step=launches,
                       peak_device_mem_bytes=ctx.peak())
        print(json.dumps({name: summary}))
        if not all(np.isfinite(losses)) or set(launches) != {
                per_step} or int(state[2]) != steps:
            raise AssertionError(f"training went wrong: {summary}")
        if hold_cfg is cfg and float(loss_k) != losses[0]:
            raise AssertionError("the trainer's first loss is not the held "
                                 "step's")
    with ctx.phase(f"{name}_profile"):
        b = batcher.batch(steps)
        ctx.profile(f"{cfg.name} training step ({batch} x {seq})",
                    lambda: step_fn(state, b))
        if cfg.moe:
            summary["moe_last"] = moe_parts(cfg, state[0], b)
            print(f"{cfg.name} after {steps + 1} steps: "
                  f"{json.dumps(summary['moe_last'])}")
        del state
        summary["plain_attention_backward"] = attention_backward_row(
            ctx, cfg, batch, seq, med)
        if not timing_row:
            row = None
        elif cfg.attn_type == "mla":
            row = mla_flash_row(ctx, cfg, per_step, batch=batch,
                                s=seq, name="flash_attention (qk 96, v 64, "
                                f"training, {batch} x {seq})", seed=10)
        else:
            row = flash_row(ctx, f"flash_attention (training, {batch} x "
                            f"{seq})", batch, cfg.n_heads, seq,
                            cfg.head_dim(), 9, launches=per_step)
    return summary, row


def train_restart(ctx, cfg, *, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                  steps=RESTART_STEPS, every=RESTART_EVERY,
                  fail_at=RESTART_FAILS, seed=0):
    """The restart drill: one step run twice from the same state gives the
    same params and moments bit for bit (no atomics on the path); then a
    run with failures injected at ``fail_at``, checkpointing every
    ``every`` steps, against an uninterrupted run: the same losses bit
    for bit.  The checkpoints go to a temporary directory, removed
    after."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import lm_batcher
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.runtime.fault import FaultTolerantTrainer

    opt = train.trainer_optimizer()
    step_fn = train.make_lm_step(cfg, opt)
    batcher = lm_batcher(cfg.vocab_size, batch, seq, seed)

    def init_state():
        params = transformer.init_params(cfg, seed, device=ctx.dev)
        return params, opt.init(params), torch.zeros(
            (), dtype=torch.int32, device=ctx.dev)

    with ctx.phase("train_restart_same_step"):
        a, loss_a = step_fn(init_state(), batcher.batch(0))
        b, loss_b = step_fn(init_state(), batcher.batch(0))
        if not (torch.equal(loss_a, loss_b) and same_bits(a, b)):
            raise AssertionError("one step run twice from one state gave "
                                 "other params, moments or loss")
        n = sum(t.numel() for _, t in named_leaves(a[0]))
        print(f"{cfg.name} ({cfg.n_layers} layers, {n} parameters): one "
              f"step run twice from the same state, params, moments and "
              f"loss bit for bit")
        del a, b
    tmp = tempfile.mkdtemp(prefix="train-restart-")
    try:
        with ctx.phase("train_restart"):
            runs = {}
            for name, fails in (("uninterrupted", None), ("chaos", fail_at)):
                trainer = FaultTolerantTrainer(
                    step_fn, init_state, batcher,
                    CheckpointManager(f"{tmp}/{name}", keep=2),
                    ckpt_every=every, device=ctx.dev)
                rep = trainer.run(steps, fail_at=fails)
                last = trainer.ckpt.latest_step()
                runs[name] = dict(losses=rep.losses, restarts=rep.restarts,
                                  wall_s=rep.wall_s, latest_step=last,
                                  checkpoint_bytes=dir_bytes(
                                      f"{tmp}/{name}/step_{last:08d}"))
            print(json.dumps({"train_restart": dict(
                n_layers=cfg.n_layers, steps=steps, ckpt_every=every,
                fail_at=fail_at, **runs)}))
            if runs["chaos"]["restarts"] != sum(fail_at.values()) or \
                    len(runs["chaos"]["losses"]) != steps or \
                    runs["chaos"]["losses"] != runs["uninterrupted"]["losses"]:
                raise AssertionError("the restarted run's losses are not the "
                                     "uninterrupted run's bit for bit")
            print(f"restart drill: {runs['chaos']['restarts']} restarts, the "
                  f"{steps} losses bit for bit the uninterrupted run's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"removed {tmp}: {Path(tmp).exists() is False}")


def recsys_train(ctx, cfg, *, batch=RS_TRAIN_BATCH, steps=RS_TRAIN_STEPS,
                 cand_n=CAND_N, cand_d=CAND_D, cand_k=CAND_K, seed=0):
    """DeepFM's training on seeded random weights at ``batch`` examples a
    step from ``recsys_batcher``: the first step's loss and gradients
    through the embedding_bag kernel's Function held bit for bit against
    the same step through ``embedding_bag_plain`` under the same
    backward; ``steps`` AdamW steps (2 embedding_bag launches each), the
    backward's time and the bag backward's (``rows_grad``) alone; then
    ``score_candidates`` at retrieval_cand against a full sort.  Returns
    (summary, the embedding_bag timing row at the training batch)."""
    import functools

    import numpy as np
    import torch
    from repro_torch.data.pipeline import recsys_batcher
    from repro_torch.kernels import embedding_bag as k_eb
    from repro_torch.launch import train
    from repro_torch.models import recsys

    batcher = recsys_batcher(cfg.n_dense, cfg.n_sparse, cfg.rows_per_field,
                             batch, seed)
    b0 = batcher.batch(0)
    summary = dict(model=cfg.name, batch=batch)
    with ctx.phase("recsys_train_hold"):
        params = recsys.init_params(cfg, seed, device=ctx.dev)
        loss_of = functools.partial(recsys.loss_fn, cfg, batch=b0)
        ctx.reset()
        loss_k, g_k = train.value_and_grad(loss_of, params)
        ctx.sync()
        counts = ctx.read(f"{cfg.name} loss and gradients (batch {batch})",
                          ["embedding_bag"], absent=["flash_attention"])
        if counts["embedding_bag"] != 2:
            raise AssertionError("a DeepFM gradient step launched "
                                 f"embedding_bag {counts['embedding_bag']} "
                                 f"times")
        ctx.reset()
        with recsys.plain_bags():
            loss_p, g_p = train.value_and_grad(loss_of, params)
        ctx.sync()
        ctx.read(f"{cfg.name} loss and gradients, plain bags", [],
                 absent=["embedding_bag", "flash_attention"])
        if not (torch.equal(loss_k, loss_p) and same_bits(g_k, g_p)):
            raise AssertionError("DeepFM's first step through the kernel is "
                                 "not the plain path's bit for bit")
        print(f"{cfg.name}: the first step's loss {float(loss_k)} and every "
              f"gradient (table {tuple(g_k['table'].shape)}) bit for bit "
              f"the plain embedding_bag path's")
        del g_k, g_p
    with ctx.phase("recsys_train_steps"):
        opt = train.trainer_optimizer()
        step_fn = train.make_recsys_step(cfg, opt)
        state = (params, opt.init(params),
                 torch.zeros((), dtype=torch.int32, device=ctx.dev))
        ms, losses = [], []
        for i in range(steps):
            b = b0 if i == 0 else batcher.batch(i)
            ctx.reset()
            ctx.sync()
            t0 = time.perf_counter()
            state, loss = step_fn(state, b)
            losses.append(float(loss))
            ctx.sync()
            ms.append((time.perf_counter() - t0) * 1000)
            if ctx.read(f"{cfg.name} training step {i}",
                        ["embedding_bag"])["embedding_bag"] != 2:
                raise AssertionError("a DeepFM step did not launch "
                                     "embedding_bag twice")
        if float(loss_k) != losses[0] or not all(np.isfinite(losses)):
            raise AssertionError(f"DeepFM training went wrong: {losses}")
        b = batcher.batch(steps)
        loss_b = functools.partial(recsys.loss_fn, cfg, batch=b)
        fwd = ctx.time_call("DeepFM loss (forward)", lambda: loss_b(params),
                            5)
        both = ctx.time_call("DeepFM loss and gradients",
                             lambda: train.value_and_grad(loss_b, params), 5)
        ids = recsys._combined_ids(torch.as_tensor(b["sparse"],
                                                   device=ctx.dev), cfg)
        g = torch.ones((batch, cfg.embed_dim), device=ctx.dev)
        bag_bwd = ctx.time_call(
            "the bag's table gradient (EmbeddingBagFunction.backward)",
            lambda: k_eb.rows_grad(ids, g[:, None].expand(
                -1, cfg.n_sparse, -1).reshape(-1, cfg.embed_dim),
                params["table"].shape[0]), 5)
        summary.update(losses=losses, step_ms=ms,
                       step_ms_median_2_on=float(np.median(ms[1:])),
                       examples_per_s=batch / (np.median(ms[1:]) / 1000),
                       forward_ms=fwd, forward_backward_ms=both,
                       backward_ms=both - fwd, bag_backward_ms=bag_bwd)
        print(json.dumps({"recsys_train": summary}))
        row = embedding_bag_row(ctx, params["table"].detach(),
                                ids.to(torch.int32).contiguous(),
                                "embedding_bag (train_batch)")
        row["launches"] = 2
        del state
    with ctx.phase("recsys_score_candidates"):
        gen = torch.Generator(device=ctx.dev).manual_seed(7)
        user = torch.randn((1, cand_d), generator=gen, device=ctx.dev)
        cand = torch.randn((cand_n, cand_d), generator=gen, device=ctx.dev)
        s, i = recsys.score_candidates(user, cand, k=cand_k)
        want = torch.sort((user @ cand.T)[0], descending=True, stable=True)
        top = want.values[:cand_k + 1]
        ties = int((top[1:] == top[:-1]).sum())
        if ties or not (torch.equal(i[0].long(), want.indices[:cand_k]) and
                        torch.equal(s[0], want.values[:cand_k])):
            raise AssertionError(f"score_candidates is not the brute-force "
                                 f"top-{cand_k} ({ties} ties)")
        cand_ms = ctx.time_call("score_candidates (retrieval_cand)",
                                lambda: recsys.score_candidates(
                                    user, cand, k=cand_k), 10)
        summary.update(score_candidates_ms=cand_ms)
        print(f"score_candidates at retrieval_cand (1 x {cand_n} x {cand_d},"
              f" k={cand_k}) == a full sort's top-{cand_k}, no ties; "
              f"{cand_ms:.6f} ms")
        del cand
    return summary, row


def retriever_lifecycle(ctx, *, steps=RETRIEVER_STEPS, big=True, **sizes):
    """``examples/train_retriever.py``'s port end to end (``--big``: two
    ~52M-parameter encoders): contrastive training through the port's
    trainer and AdamW, the corpus embedded, ``build_index``,
    ``choose_n_probe``, fixed and patience search on the fused kernel;
    then each policy's fused search against the per-probe kernel pair
    on the same embeddings, bit for bit."""
    import tempfile

    import torch
    from repro_torch.core import search
    from repro_torch.examples import train_retriever

    with ctx.phase("retriever_lifecycle"):
        with tempfile.TemporaryDirectory(prefix="retriever-") as tmp:
            ctx.reset()
            out = train_retriever.main(steps=steps, big=big, ckpt=tmp,
                                       device=ctx.dev, **sizes)
            ctx.sync()
            ctx.read("retriever lifecycle (fixed and patience search)",
                     ["ivf_scan_merge"],
                     absent=["flash_attention", "embedding_bag"])
        losses = out["losses"]
        print(json.dumps({"retriever_lifecycle": dict(
            steps=len(losses), loss_every_50=losses[::50] + losses[-1:],
            n_probe=out["n_probe"], results=out["results"])}))
        if not losses[-1] < losses[0]:
            raise AssertionError("the retriever's loss did not fall")
        for pol in out["policies"]:
            fused = search(out["index"], out["queries"], pol,
                           use_fused_kernel=True, chunk=4)
            pair = search(out["index"], out["queries"], pol,
                          use_scan_kernel=True, use_topk_kernel=True)
            for name in ("topk_ids", "probes", "topk_scores"):
                if not torch.equal(getattr(fused, name), getattr(pair, name)):
                    raise AssertionError(f"retriever {pol.name}: fused != "
                                         f"per-probe pair on {name}")
        print("retriever: fused == per-probe kernel pair bit for bit for "
              "fixed and patience")
    return out["results"]


# -- the learned exit stages: REG, classifier and cascades (Table 2) ---------
# Their own train / valid queries over the served corpus (the served
# queries' mix, from the corpus's own component centres), the forests of
# table2's --quick mode at the paper's point, then the eight Table-2
# strategies on the 1,024 served queries through the fused kernel.

LEARNED_TRAIN, LEARNED_VALID, LEARNED_SEED = 2048, 512, 1
LEARNED_TREES, LEARNED_DEPTH, EXIT_W = 30, 5, 3.0
def learned_exit(ctx, index, corpus, queries, docs_t, exact, *,
                 n_probe=N_PROBE, k=K, tau=TAU, delta=DELTA, phi=PHI,
                 n_train=LEARNED_TRAIN, n_valid=LEARNED_VALID,
                 n_trees=LEARNED_TREES, max_depth=LEARNED_DEPTH,
                 pair_queries=256, feature_block=128, spread=SPREAD,
                 timed_calls=5):
    """Phases ``learned_train``, ``learned_search``,
    ``learned_fused_vs_pair``, ``learned_serve`` and
    ``learned_features``: train the four
    forests, run Table 2's eight strategies on ``queries`` through the
    fused kernel (one ``ivf_scan_merge`` launch per chunk of 4 probes;
    the median wall of ``timed_calls`` after a warm one; A-kNN and
    +Patience once more under the profiler),
    hold both cascades' fused search against the kernel pair, serve
    +Patience through the wave scheduler (one ``tau_stage`` launch a
    wave) against its fused search, and hold
    the features built offline against the online ones and across batch
    sizes, bit for bit.  Returns the printed rows."""
    import numpy as np
    import torch
    from repro_torch.benchmarks.table2 import strategies
    from repro_torch.core import extract_features, metrics, search
    from repro_torch.core.training import train_policy_models
    from repro_torch.data.synthetic import component_centers, query_mix
    from repro_torch.kernels import delta_scan as k_ds

    with ctx.phase("learned_train"):
        centres = component_centers(n_docs=N_DOCS, dim=D,
                                    n_components=N_CLUSTERS, seed=0)
        qs = query_mix(np.random.default_rng(LEARNED_SEED), corpus.docs,
                       centres, n_train + n_valid, spread=spread)
        t0 = time.perf_counter()
        pm = train_policy_models(
            index, docs_t, qs[:n_train], qs[n_train:], n_probe=n_probe, k=k,
            tau=tau, exit_weight=EXIT_W, n_trees=n_trees,
            max_depth=max_depth)
        ctx.sync()
        total = time.perf_counter() - t0
        y = pm.labels_train
        print(json.dumps(dict(
            train_queries=n_train, valid_queries=n_valid, n_probe=n_probe,
            k=k, tau=tau, exit_weight=EXIT_W, trees_asked=n_trees,
            max_depth=max_depth, seconds=total,
            **{f"{part}_s": sec for part, sec in pm.seconds.items()},
            exit_fraction_train=float(np.mean(y <= tau)),
            label_mean_train=float(y.mean()),
            trees={name: getattr(pm, name).n_trees for name in
                   ("reg", "reg_int", "clf", "clf_weighted")})))

    # Table 2's eight strategies, named as table2 names them
    pols = strategies(n_probe, pm, delta, k=k, tau=tau, phi=phi,
                      exit_w=EXIT_W)
    pat = f"+Patience(d={delta})"
    clf_w = f"Classifier(w={EXIT_W:.0f})"
    rows, results = [], {}
    with ctx.phase("learned_search"):
        base_ms = None

        def run(pol):
            return search(index, queries, pol, use_fused_kernel=True,
                          chunk=CHUNK)

        for name, pol in pols.items():
            # a warm call, then timed calls (the median is the row's
            # wall); the first timed call's launches are read
            run(pol)
            walls = []
            for rep in range(timed_calls):
                ctx.sync()
                if rep == 0:
                    ctx.reset()
                t0 = time.perf_counter()
                res = run(pol)
                ctx.sync()
                walls.append((time.perf_counter() - t0) * 1000)
                if rep == 0:
                    counts = ctx.read(
                        f"learned search {name}", ["ivf_scan_merge"],
                        absent=["ivf_scan", "topk_merge",
                                "ivf_scan_merge+delta"])
            wall = float(np.median(walls))
            if counts["delta_scan"] != (1 if pol.learned else 0):
                raise AssertionError(f"{name}: {counts['delta_scan']} "
                                     f"delta_scan launches (the centroid "
                                     f"sims of a learned policy: 1)")
            probes = res.probes.cpu().numpy()
            summ = metrics.summarize(res.topk_ids.cpu().numpy(), probes,
                                     exact, corpus.relevant, wall)
            base_ms = base_ms or wall
            row = {"strategy": name, **{m: summ[m] for m in (
                "R*@1", "R*@k", "mRR@10", "C")}, "wall_ms": wall,
                "Sp": base_ms / wall,
                "wall_ms_each": walls,
                "ivf_scan_merge_launches": counts["ivf_scan_merge"],
                "delta_scan_launches": counts["delta_scan"],
                "min_probes": int(probes.min()),
                "max_probes": int(probes.max())}
            print(json.dumps(row))
            if pol.learned and not (tau <= probes.min()
                                    and probes.max() <= n_probe):
                raise AssertionError(f"{name}: a query's probes lie outside "
                                     f"[{tau}, {n_probe}]")
            if res.features is None and pol.learned:
                raise AssertionError(f"{name}: no features at tau")
            rows.append(row)
            results[name] = res
        c = {r["strategy"]: r["C"] for r in rows}
        if c[pat] > c[clf_w]:
            raise AssertionError(f"{pat}'s C {c[pat]} exceeds {clf_w}'s "
                                 f"{c[clf_w]}")
        print(f"learned C within [{tau}, {n_probe}] for every query; "
              f"{pat}'s C <= {clf_w}'s (the same weighted trees)")
        for name in (f"A-kNN95(N={n_probe})", pat):
            ctx.profile(f"search {name} ({queries.shape[0]} queries, "
                        f"fused)", lambda: run(pols[name]))

    with ctx.phase("learned_fused_vs_pair"):
        q = queries[:pair_queries]
        for name in ("+Reg+int", pat):
            fused = search(index, q, pols[name], use_fused_kernel=True,
                           chunk=CHUNK)
            ctx.reset()
            pair = search(index, q, pols[name], use_scan_kernel=True,
                          use_topk_kernel=True)
            ctx.sync()
            ctx.read(f"learned search {name} (kernel pair)",
                     ["ivf_scan", "topk_merge"],
                     absent=["ivf_scan_merge", "ivf_scan_merge+delta"])
            for f in ("topk_ids", "probes", "topk_scores", "features"):
                if not torch.equal(getattr(fused, f), getattr(pair, f)):
                    raise AssertionError(f"{name}: fused != kernel pair on "
                                         f"{f}")
            print(f"{name}: fused == per-probe kernel pair bit for bit on "
                  f"{q.shape[0]} queries (ids, probes, scores, features; "
                  f"C={fused.probes.float().mean().item():.4f})")

    with ctx.phase("learned_serve"):
        # the cascade served by the wave scheduler at this script's wave:
        # its stage at tau one tau_stage launch a fused wave, its answers,
        # probes and classifier exits those of fused search
        from repro_torch.core.serving import WaveScheduler
        from repro_torch.trees.torch_infer import predict_margin
        pol = pols[pat]
        ws = WaveScheduler(index, policy=pol, wave_size=B, chunk=CHUNK)
        ws.serve(queries[:B])
        ctx.sync()
        ctx.reset()
        t0 = time.perf_counter()
        rep = ws.serve(queries)
        ctx.sync()
        wall = (time.perf_counter() - t0) * 1000
        counts = ctx.read(f"learned serve {pat} (WaveScheduler, fused)",
                          ["ivf_scan_merge", "row_topk", "slot_roll",
                           "delta_scan", "tau_stage"],
                          absent=["ivf_scan", "topk_merge",
                                  "ivf_scan_merge+delta"])
        if counts["tau_stage"] != rep.waves:
            raise AssertionError(f"{counts['tau_stage']} tau_stage "
                                 f"launches in {rep.waves} waves")
        n_q = queries.shape[0]
        ref = results[pat]
        if not np.array_equal(np.stack([rep.results[i] for i in range(n_q)]),
                              ref.topk_ids.cpu().numpy()):
            raise AssertionError(f"{pat}: served ids != fused search")
        if not np.array_equal([rep.probes[i] for i in range(n_q)],
                              ref.probes.cpu().numpy()):
            raise AssertionError(f"{pat}: served probes != fused search")
        says = int((torch.sigmoid(predict_margin(pol.clf, ref.features))
                    >= pol.clf_threshold).sum())
        if rep.clf_exits != says:
            raise AssertionError(f"{pat}: {rep.clf_exits} classifier exits "
                                 f"served, {says} in fused search")
        print(json.dumps(dict(
            serve=pat, queries=n_q, waves=rep.waves, wall_ms=wall,
            queries_per_s=n_q / (wall / 1000), clf_exits=rep.clf_exits,
            tau_ms=rep.tau_ms, tau_stage_launches=counts["tau_stage"],
            C=float(np.mean([rep.probes[i] for i in range(n_q)])))))
        print(f"learned serve {pat}: == fused search bit for bit (ids, "
              f"probes, {says} classifier exits); one tau_stage launch in "
              f"each of {rep.waves} waves")

    with ctx.phase("learned_features"):
        # delta_scan at the shapes the learned path gives it: the centroid
        # sims of a whole batch and of one block (queries x N_CLUSTERS),
        # on the served queries and on integer inputs (bit-equal)
        r = np.random.default_rng(5)

        def ints(shape):
            return torch.from_numpy(
                r.integers(-2, 3, shape).astype(np.float32)).to(ctx.dev)

        int_q, int_c = ints(tuple(queries.shape)), ints(
            tuple(index.centroids.shape))
        for rows_ in (queries.shape[0], feature_block):
            for label, q_, c_ in (("integer", int_q, int_c),
                                  ("served", queries, index.centroids)):
                got = k_ds.delta_scan(q_[:rows_], c_)
                ctx.sync()
                want = k_ds.delta_scan_plain(q_[:rows_], c_)
                err = float((got - want).abs().max())
                if label == "integer" and not torch.equal(got, want):
                    raise AssertionError(f"delta_scan ({label}, {rows_} x "
                                         f"{c_.shape[0]}): not bit-equal")
                if not err <= ATOL:
                    raise AssertionError(f"delta_scan ({label}, {rows_} x "
                                         f"{c_.shape[0]}): err {err}")
                ctx.max_err["delta_scan"] = max(ctx.max_err["delta_scan"],
                                                err)
                print(f"delta_scan ({label} centroid sims, {rows_} x "
                      f"{c_.shape[0]} x {c_.shape[1]}): max_abs_err {err}")
        whole = extract_features(index, queries, tau=tau, k=k)
        parts = torch.cat([extract_features(index,
                                            queries[s: s + feature_block],
                                            tau=tau, k=k)
                           for s in range(0, queries.shape[0],
                                          feature_block)])
        ctx.sync()
        if not torch.equal(whole, parts):
            raise AssertionError(
                f"extract_features differs between one call and calls of "
                f"{feature_block}: {int((whole != parts).any(1).sum())} rows")
        for name, res in results.items():
            if pols[name].learned and not torch.equal(res.features, whole):
                raise AssertionError(f"{name}: the features at tau differ "
                                     f"from extract_features'")
        print(f"extract_features: one call of {queries.shape[0]} == "
              f"{queries.shape[0] // feature_block} calls of "
              f"{feature_block} == the features every learned search read "
              f"at tau, bit for bit ({tuple(whole.shape)})")
    return rows


def table2_smoke(ctx):
    """Phase ``table2_smoke``: the port's Table-2 entry point,
    ``table2.main(smoke=True)``, on the card (its substrate cached and
    its JSON written in a temporary directory): every strategy through
    the fused kernel, the artifact naming the backend, the card and its
    power limit, and Table 2's eight rows."""
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.benchmarks import common, table2

    with ctx.phase("table2_smoke"), \
            tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "BENCH_table2_torch.json")
        cache, common.CACHE = common.CACHE, os.path.join(tmp, "cache")
        try:
            ctx.reset()
            rows = table2.main(smoke=True, out=out)
            ctx.sync()
        finally:
            common.CACHE = cache
        counts = ctx.read("table2.main(smoke=True)", ["ivf_scan_merge"],
                          absent=["ivf_scan", "topk_merge",
                                  "ivf_scan_merge+delta"])
        # not named above, so delta_scan's row keeps the live pair's count
        if counts["delta_scan"] <= 0:
            raise AssertionError("table2: no per-row centroid sims "
                                 "(delta_scan) in a learned search")
        with open(out) as f:
            art = json.load(f)
        name, limit = (x.strip() for x in card_line().rsplit(",", 1))
        want = dict(backend="cuda", device=torch.cuda.get_device_name(0),
                    power_limit=limit)
        got = {key: art.get(key) for key in want}
        if got != want:
            raise AssertionError(f"table2 artifact names {got}, not {want}")
        if len(art["rows"]) != 8 or art["rows"] != json.loads(
                json.dumps(rows)):
            raise AssertionError(f"table2 artifact holds "
                                 f"{len(art['rows'])} rows, not the 8 "
                                 f"returned")
        for r in art["rows"]:
            if not all(np.isfinite(r[m]) and r[m] >= 0 for m in (
                    "R*@1", "mRR@10", "C", "T_ms", "Sp")) or r["C"] < 1:
                raise AssertionError(f"table2 row {r}")
            print(json.dumps({m: r[m] for m in (
                "strategy", "R*@1", "mRR@10", "C", "T_ms", "Sp")}))
        print(f"table2.main(smoke=True) on {name} ({limit}): "
              f"{len(rows)} rows, artifact {sorted(art)}")


# -- durability: a live serve with a WAL, snapshots and rebuilds --------------
# Module-level like the model-zoo phases, so they can be rehearsed on the
# CPU with a CPU ctx and small sizes.

REBUILD_EVERY = 16             # the reference CLI's --rebuild-every
# the durable serve's delta buffer, a departure from the live cell's
# 4,096 slots and not a deployment setting: retrain keeps the cluster
# count and splits nothing, so a rebuild of this cut spills 6,354
# entries past list_pad into the candidate's buffer, and more with each
# further rebuild (an NVIDIA H100 80GB HBM3 at 700 W, PERF.md); past the
# buffer's capacity the reference's rule raises (ROADMAP R4, open)
DURABLE_CAP = 65_536
# the crash drills' corpus: the widths stay, the scale is cut (list sizes
# stay those of the full cell: 65,536 / 512 = 1M / 8,192 docs a cluster)
DRILL_DOCS, DRILL_CLUSTERS = 65_536, 512
DRILL_SHIFT = 1.0              # norm of the drift drill's shift (docs: 1)
DRILL_ITERS = 2                # the drills' Lloyd steps a retrain
# deadline phases: simulated waves of 1 ms, so one wave bounds a query's
# overshoot (tests/test_resilience.py holds it so at chunk 1), the budgets
# in simulated ms; on the real clock the budgets are multiples of the
# unbounded serve's mean wave wall, measured in the phase
SIM_WAVE_MS, SIM_DEADLINES = 1.0, (4.0, 8.0, 16.0, 32.0)
SHED_WAVE_MS, SHED_DEADLINE = 4.0, 1.0
REAL_DEADLINE_WAVES = (4, 8, 16)
THROTTLE_DEADLINE = 6.0        # simulated ms, the drill serve's tight row
N_SHARDS = 4


def first_chunk(index, qb):
    """The fused kernel wrapper's inputs for the first CHUNK probes of the
    queries ``qb`` on ``index``, from an empty running top-k: every
    cluster ranked by similarity (B, n_clusters), the probed lists' sizes
    (B, CHUNK), their offsets in BLK_L blocks (B * CHUNK,), the ids as
    (rows / BLK_L, BLK_L) padded with -1, and the empty top-k."""
    import torch

    _, rank = torch.sort(qb @ index.centroids.T, dim=1, descending=True,
                         stable=True)
    cids = rank[:, :CHUNK]
    sz = index.cluster_sizes[cids].contiguous()
    boffs = (index.cluster_offsets[cids] // BLK_L).reshape(-1).contiguous()
    tail = (-index.doc_ids.shape[0]) % BLK_L
    ids2d = torch.nn.functional.pad(index.doc_ids, (0, tail),
                                    value=-1).reshape(-1, BLK_L)
    n = qb.shape[0]
    empty_s = torch.full((n, K), float("-inf"), device=qb.device)
    empty_i = torch.full((n, K), -1, dtype=torch.int32, device=qb.device)
    return rank, sz, boffs, ids2d, empty_s, empty_i


class Rebuilt:
    """Search a live index's from-scratch re-layout (no buffer): the
    rebuild-equivalence oracle, an answer the buffer's kernels do not
    compute."""

    def __init__(self, live):
        self.index = live.rebuild_equivalent()

    def search(self, q, p, **kw):
        from repro_torch.core import search

        return search(self.index, q, p, **kw)


def pre_serve_burst(live, docs, *, adds=PRE_ADDS):
    """The live cell's pre-serve burst on ``live``: ``adds`` noisy copies
    of corpus docs added, PRE_DELETES main docs deleted.  Returns the
    deleted ids."""
    import numpy as np

    r = np.random.default_rng(2)
    n, d = docs.shape
    src = r.integers(0, n, adds)
    live.add((docs[src] + r.normal(scale=NOISE, size=(adds, d))
              ).astype(np.float32))
    gone = r.choice(n, PRE_DELETES, replace=False)
    live.delete(gone)
    return gone


def disk_line(path):
    """``df`` of the file system that holds ``path``."""
    import shutil

    total, used, free = shutil.disk_usage(path)
    return (f"disk at {path}: {total / 2**30:.1f} GiB, {used / 2**30:.1f} "
            f"GiB used, {free / 2**30:.1f} GiB free")


def dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def same_live_state(a, b, what):
    """Two live indexes on one device hold equal tensors and counters."""
    import numpy as np
    import torch

    pairs = [(getattr(a.index, f), getattr(b.index, f), f) for f in
             ("centroids", "docs", "doc_ids", "cluster_offsets",
              "cluster_sizes")]
    pairs += [(getattr(a.delta, f), getattr(b.delta, f), f"delta.{f}")
              for f in ("vecs", "ids", "assign")]
    pairs.append((a.dead_lookup(), b.dead_lookup(), "dead"))
    for x, y, name in pairs:
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differs")
    for name in ("next_id", "version", "seq", "epoch", "n_live"):
        if getattr(a, name) != getattr(b, name):
            raise AssertionError(f"{what}: {name} {getattr(a, name)} != "
                                 f"{getattr(b, name)}")
    if a.index.list_pad != b.index.list_pad or a.delta.count != \
            b.delta.count or not np.array_equal(a.tombs.dead_ids(),
                                                b.tombs.dead_ids()):
        raise AssertionError(f"{what}: list_pad, buffer count or "
                             f"tombstones differ")


def same_answers(a, b, queries, pol, what):
    """``a`` and ``b`` (live indexes or adapters with ``search``) answer
    alike bit for bit on the fused path and on the kernel pair; the
    fused path equals the pair too."""
    import torch

    paths = {"fused": dict(use_fused_kernel=True, chunk=CHUNK),
             "pair": dict(use_scan_kernel=True, use_topk_kernel=True)}
    got = {p: a.search(queries, pol, **kw) for p, kw in paths.items()}
    for p, kw in paths.items():
        want = b.search(queries, pol, **kw)
        for name in ("topk_ids", "probes", "topk_scores", "phi_hist"):
            if not torch.equal(getattr(got[p], name), getattr(want, name)):
                raise AssertionError(f"{what} ({p}): {name} differs")
    for name in ("topk_ids", "probes", "topk_scores"):
        if not torch.equal(getattr(got["fused"], name),
                           getattr(got["pair"], name)):
            raise AssertionError(f"{what}: fused != pair on {name}")
    return got["fused"]


def buffer_kernels_vs_plain(ctx, live, qb):
    """Each kernel that reads the delta buffer, against its plain version
    on ``live``'s own buffer (its capacity and its fill, as a rebuild's
    spill leaves them), for the queries ``qb`` at two chunks of CHUNK
    probes: the serve's first, and the clusters among each query's first
    N_PROBE that hold the most buffered entries.  ``delta_scan`` over
    every slot and the fused kernel with the stream within ATOL
    (near-tie id swaps only); ``ivf_scan`` on the chunk's second lists
    within ATOL, and ``topk_merge`` of that strip and the gated buffer
    columns into the fused kernel's top-k after the chunk's first probe,
    bit-equal.  The errors join the kernels' rows.  The plain versions
    score the buffer as a (queries, cap, d) product, so they run 16
    queries at a time."""
    import torch
    from repro_torch.kernels import delta_scan as k_ds
    from repro_torch.kernels import ivf_scan as k_scan
    from repro_torch.kernels import ivf_scan_merge as k_sm
    from repro_torch.kernels import topk_merge as k_tm

    index, view, dead = live.index, live.delta_view(), live.dead_lookup()
    n, lp, block = qb.shape[0], index.list_pad, 16
    blocks = range(0, n, block)
    # tombstoned entries burnt to id -1, as the serve gives the buffer
    ids = torch.where(dead[view.ids.clamp(0, dead.shape[0] - 1).long()]
                      & (view.ids >= 0), -1, view.ids)
    rank, _, _, ids2d, empty_s, empty_i = first_chunk(index, qb)
    fill = torch.bincount(view.assign[ids >= 0].long(),
                          minlength=index.n_clusters)
    near = rank[:, :N_PROBE]
    fullest = torch.gather(near, 1, torch.topk(fill[near], CHUNK, 1).indices)
    errs = {"delta_scan": 0.0, "ivf_scan_merge+delta": 0.0, "ivf_scan": 0.0}

    got = k_ds.delta_scan(qb, view.vecs)
    ctx.sync()
    errs["delta_scan"] = finite_err(got, torch.cat([
        k_ds.delta_scan_plain(qb[i:i + block], view.vecs) for i in blocks]))
    lines = []
    for label, cids in (("first chunk", rank[:, :CHUNK]),
                        ("fullest buffered clusters", fullest)):
        sz = index.cluster_sizes[cids].reshape(-1).contiguous()
        boffs = (index.cluster_offsets[cids] // BLK_L).reshape(-1) \
            .contiguous()
        gates = cids.to(torch.int32).reshape(-1).contiguous()
        kw = dict(k=K, list_pad=lp, chunk=CHUNK, blk_l=BLK_L,
                  delta_vecs=view.vecs, delta_ids=ids,
                  delta_assign=view.assign)
        g = k_sm.ivf_scan_merge(qb, index.docs, ids2d, boffs, sz, empty_s,
                                empty_i, gate_cids=gates, **kw)
        ctx.sync()
        parts = []
        for i in blocks:
            rows, slots = slice(i, i + block), slice(i * CHUNK,
                                                     (i + block) * CHUNK)
            parts.append(k_sm.ivf_scan_merge_plain(
                qb[rows], index.docs, ids2d, boffs[slots], sz[slots],
                empty_s[rows], empty_i[rows], gate_cids=gates[slots], **kw))
        w = [torch.cat(x) for x in zip(*parts)]
        what = f"ivf_scan_merge+delta (serving buffer, {label})"
        swaps, err = near_tie_swaps(g[0], g[1], w[0], w[1], what)
        if ((g[2] != w[2]) & ~(g[1] != w[1]).any(-1)).any():
            raise AssertionError(f"{what}: counts differ without an id swap")
        errs["ivf_scan_merge+delta"] = max(errs["ivf_scan_merge+delta"], err)
        gated = int(((view.assign[None, :] == gates[:, None])
                     & (ids >= 0)[None, :]).sum())

        bo1 = boffs.view(n, CHUNK)[:, 1].contiguous()
        raw = k_scan.ivf_scan(qb, index.docs, bo1, list_pad=lp, blk_l=BLK_L)
        ctx.sync()
        errs["ivf_scan"] = max(errs["ivf_scan"], finite_err(
            raw, k_scan.ivf_scan_plain(qb, index.docs, bo1, list_pad=lp,
                                       blk_l=BLK_L)))
        # the chunk's second strip as core.ivf's _probe_rows gives it to
        # the pair search, then the buffer's columns gated on its cluster
        lane = torch.arange(lp, device=qb.device)[None]
        strip_i = torch.where(
            lane < sz.view(n, CHUNK)[:, 1:2],
            index.doc_ids[bo1.long()[:, None] * BLK_L + lane], -1)
        gate = (ids >= 0)[None, :] & (view.assign[None, :] == cids[:, 1:2])
        wide_s = torch.cat([torch.where(strip_i >= 0, raw, float("-inf")),
                            torch.where(gate, got, float("-inf"))],
                           1).contiguous()
        wide_i = torch.cat([strip_i, torch.where(gate, ids[None, :].expand(
            n, -1), -1)], 1).contiguous()
        run_s, run_i = g[0][:, 0].contiguous(), g[1][:, 0].contiguous()
        tg = k_tm.topk_merge(run_s, run_i, wide_s, wide_i, K)
        ctx.sync()
        tw = k_tm.topk_merge_plain(run_s, run_i, wide_s, wide_i, K)
        if not (torch.equal(tg[0], tw[0]) and torch.equal(tg[1], tw[1])):
            raise AssertionError(f"topk_merge (serving buffer, {label}): "
                                 f"not bit-equal")
        lines.append(f"{label}: {gated} entries gated on {n} x {CHUNK} "
                     f"slots, {int(gate.sum())} in the topk_merge strips, "
                     f"{swaps} near-tie id swaps")
    for name, err in errs.items():
        if not err <= ATOL:
            raise AssertionError(f"{name} (serving buffer): err {err}")
        ctx.max_err[name] = max(ctx.max_err[name], err)
    print(f"kernels vs plain on the serving buffer ({int((ids >= 0).sum())} "
          f"live entries of {ids.shape[0]} slots; topk_merge width "
          f"{lp + ids.shape[0]}, bit-equal): {json.dumps(errs)}; "
          + "; ".join(lines))


def durable_serve(ctx, index, docs, queries, served, exact, live_wall_ms, *,
                  cap=DURABLE_CAP, pre_adds=PRE_ADDS):
    """Phases ``durable_setup``, ``durable_serve``, ``durable_finish``,
    ``durable_recover``, ``durable_recovered_vs_serving`` and
    ``durable_kernels_vs_plain``: the live cell's serve (the pre-serve
    burst of ``pre_adds`` adds, then MUTATION_RATE adds, a quarter as
    many deletes and a publish a wave, a merge every MERGE_EVERY waves;
    a ``cap``-slot buffer) with a mutation WAL (group commit 8 records /
    50 ms) and a snapshot manager (``keep=1``) in a temporary directory,
    and a rebuild requested every REBUILD_EVERY waves, as the reference
    CLI's ``--mutation-rate 64 --merge-every 16 --rebuild-every 16``
    runs it, until the first rebuild publishes: every rebuild stage a
    tick between waves, the publish drained.  Then four more waves and a
    merge, and ``IndexRegistry.recover`` rebuilds a fresh LiveIndex from
    the snapshot and the log, which must equal the serving one bit for
    bit (state, and ids, probes and phi on the fused path and on the
    kernel pair); the serving index must answer as its from-scratch
    re-layout does, and each kernel of the buffer's paths must agree
    with its plain version on the serving index's own buffer.  Returns
    the printed row."""
    import os
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import metrics, policies
    from repro_torch.core.serving import WaveScheduler
    from repro_torch.index import (IndexRegistry, LiveIndex, MutationWAL,
                                   Rebuilder, version_of)
    from repro_torch.launch.serve import MutationStream

    tmp = tempfile.mkdtemp(prefix="durable_serve_")
    wal = None
    try:
        with ctx.phase("durable_setup"):
            print(disk_line(tmp))
            wal = MutationWAL(os.path.join(tmp, "mutations.wal"),
                              group_commit_n=8, group_commit_ms=50.0)
            appended = [0]
            append = wal.append

            def counted_append(*a, **kw):
                appended[0] += 1
                return append(*a, **kw)

            wal.append = counted_append
            mgr = CheckpointManager(os.path.join(tmp, "snapshots"), keep=1,
                                    async_save=False)
            live = LiveIndex(index, delta_cap=cap, wal=wal)
            reg = IndexRegistry(version_of(live))
            ctx.sync()
            t0 = time.perf_counter()
            reg.save(mgr)
            save_s = time.perf_counter() - t0
            wal.note_durable(live.seq)
            snap_bytes = dir_bytes(mgr.root)
            gone = pre_serve_burst(live, docs, adds=pre_adds)
            reg.publish(version_of(live))
            print(f"base snapshot: {snap_bytes} bytes saved in {save_s:.3f} "
                  f"s; {disk_line(tmp)}")

        stream = MutationStream(live, reg, docs, rate=MUTATION_RATE,
                                merge_every=MERGE_EVERY, noise=NOISE,
                                rebuild_every=REBUILD_EVERY)
        reports = []

        def on_publish(new_live, report):
            # one rebuild is what the checks need: each further one costs
            # a snapshot write and a retrain on the serving thread
            stream.on_publish(new_live, report)
            stream.rebuilder = None
            reports.append(report)

        rb = Rebuilder(live, reg, mgr, on_publish=on_publish)
        stream.rebuilder = rb
        stage_s = {}
        tick = rb.tick

        def timed_tick():
            ctx.sync()
            t1 = time.perf_counter()
            stage = tick()
            ctx.sync()
            stage_s.setdefault(stage, []).append(time.perf_counter() - t1)
            return stage

        rb.tick = timed_tick
        ws = WaveScheduler(index, wave_size=B, chunk=CHUNK, k=K,
                           n_probe=N_PROBE, delta=DELTA, phi=PHI,
                           registry=reg, rebuilder=rb)
        ctx.reset()
        with ctx.phase("durable_serve"):
            ctx.sync()
            t0 = time.perf_counter()
            rep = ws.serve(queries, on_wave=stream)
            ctx.sync()
            wall = (time.perf_counter() - t0) * 1000
            counts = ctx.read(
                "durable serve (WaveScheduler, fused, registry, WAL, "
                "rebuilds)", ["ivf_scan_merge+delta"],
                absent=["ivf_scan_merge", "delta_scan", "ivf_scan",
                        "topk_merge"])
            if counts["ivf_scan_merge+delta"] != rep.waves:
                raise AssertionError("the durable serve did not launch the "
                                     "fused kernel once per wave")
            nq = queries.shape[0]
            if sorted(rep.results) != list(range(nq)):
                raise AssertionError("the durable serve did not answer "
                                     "every query once")
            got = np.stack([rep.results[i] for i in range(nq)])
            probes = np.array([rep.probes[i] for i in range(nq)])
            for row in got:
                real = row[row >= 0]
                if len(np.unique(real)) != len(real):
                    raise AssertionError("a durable result holds a "
                                         "duplicate id")
            if np.isin(got, gone).any():
                raise AssertionError("a durable result holds an id deleted "
                                     "before serving began")
            r_static = metrics.r_star_at_k(served, exact)
            r_live = metrics.r_star_at_k(got, exact)
            summ = dict(
                **stream.stats, waves=rep.waves,
                rebuilds=rb.epochs_published, epoch=stream.live.epoch,
                epoch_swaps=rep.epoch_swaps, drain_waves=rep.drain_waves,
                rebuild_ticks=rep.rebuild_ticks,
                rebuild_throttled=rep.rebuild_throttled,
                recall_static=r_static, recall_live=r_live,
                recall_gap=abs(r_static - r_live), C=float(probes.mean()),
                wall_ms=wall, live_serve_wall_ms=live_wall_ms,
                wal_records_appended=appended[0],
                wal_bytes_at_end=os.path.getsize(wal.path),
                wal_fsyncs=wal.fsyncs, base_snapshot_bytes=snap_bytes,
                base_snapshot_save_s=save_s,
                stage_s={st: v for st, v in stage_s.items()},
                rebuild_reports=[dict(
                    epoch=r.epoch, fence_seq=r.fence_seq, corpus=r.corpus,
                    spilled=r.spilled, moved=r.moved,
                    caught_up=r.caught_up, step=r.step) for r in reports])
            print(json.dumps(summ))
            if rb.epochs_published < 1 or rep.epoch_swaps < 1:
                raise AssertionError("no rebuild was published and drained "
                                     "mid-serve")
            if summ["recall_gap"] > RECALL_GAP_MAX:
                raise AssertionError(f"durable serve recall gap "
                                     f"{summ['recall_gap']} > "
                                     f"{RECALL_GAP_MAX}")

        with ctx.phase("durable_finish"):
            # a rebuild still in flight when the queries ran out, then
            # mutations past its snapshot for the recovery to replay: four
            # more waves of the stream (no rebuild requests) and a merge
            ticks = 0
            while rb.active:
                rb.tick()
                ticks += 1
            for w in range(1, 5):
                stream(rep.waves + w)
            stream.live.merge_delta()
            stream(rep.waves + 5)
            print(f"finished the in-flight rebuild in {ticks} ticks: "
                  f"{rb.epochs_published} rebuilds, epoch "
                  f"{stream.live.epoch}, seq {stream.live.seq}; "
                  f"{disk_line(tmp)}; snapshots {mgr.all_steps()} "
                  f"({dir_bytes(mgr.root)} bytes)")

        with ctx.phase("durable_recover"):
            serving = stream.live
            wal.flush()
            restore, load_s = IndexRegistry.restore, []

            def timed_restore(*a, **kw):
                t1 = time.perf_counter()
                out = restore(*a, **kw)
                ctx.sync()
                load_s.append(time.perf_counter() - t1)
                return out

            IndexRegistry.restore = timed_restore
            try:
                ctx.sync()
                t0 = time.perf_counter()
                _, rec, rrep = IndexRegistry.recover(mgr, wal,
                                                     device=ctx.dev)
                ctx.sync()
                rec_s = time.perf_counter() - t0
            finally:
                IndexRegistry.restore = restore
            same_live_state(rec, serving, "recovered vs serving")
            print(json.dumps(dict(
                recovery_s=rec_s, snapshot_load_s=load_s[0],
                replayed=rrep.applied, skipped=rrep.skipped,
                torn_tail=rrep.torn_tail, epoch_records=rrep.epoch_records,
                rebuild_promoted=rrep.rebuild_promoted,
                rebuild_aborted=rrep.rebuild_aborted, seq=rec.seq,
                epoch=rec.epoch, n_live=rec.n_live)))

        pol = policies.patience(N_PROBE, delta=DELTA, phi=PHI, k=K, tau=TAU)
        q256 = queries[:256]
        ctx.reset()
        with ctx.phase("durable_recovered_vs_serving"):
            res = same_answers(rec, serving, q256, pol,
                               "recovered vs serving")
            rebuilt = Rebuilt(serving)
            same_answers(serving, rebuilt, q256, pol,
                         "serving vs its from-scratch re-layout")
            ctx.sync()
            ctx.read("recovered vs serving vs rebuilt (fused and kernel "
                     "pair)", ["ivf_scan_merge+delta", "ivf_scan",
                               "topk_merge", "delta_scan", "ivf_scan_merge"])
            print(f"recovered == serving == its from-scratch re-layout "
                  f"(list_pad {rebuilt.index.list_pad}) bit for bit (state; "
                  f"ids, probes, scores, phi on the fused path and the "
                  f"kernel pair) on {q256.shape[0]} queries (C="
                  f"{res.probes.float().mean().item():.4f}); buffer "
                  f"{serving.delta.count} entries of "
                  f"{serving.delta.vecs.shape[0]} slots")
            del rebuilt

        with ctx.phase("durable_kernels_vs_plain"):
            buffer_kernels_vs_plain(ctx, serving, queries[:B])
        return summ
    finally:
        if wal is not None:
            wal.close()
        shutil.rmtree(tmp, ignore_errors=True)


def drill_substrate(ctx, *, n_docs=DRILL_DOCS, dim=D):
    """Phase ``drill_setup``: the drills' corpus of ``n_docs`` at ``dim``
    (the live cell's widths and list sizes, its scale cut), 256 queries,
    and its index on the card.  Returns (corpus, index, queries on the
    card)."""
    import torch
    from repro_torch.core import build_index
    from repro_torch.data.synthetic import clustered_corpus

    with ctx.phase("drill_setup"):
        corpus = clustered_corpus(n_docs=n_docs, dim=dim,
                                  n_components=DRILL_CLUSTERS,
                                  n_queries=256, spread=SPREAD, seed=5)
        index = build_index(corpus.docs, DRILL_CLUSTERS, list_pad=LIST_PAD,
                            n_iters=6, align=BLK_L, device=ctx.dev)
        queries = torch.from_numpy(corpus.queries).to(ctx.dev)
        ctx.sync()
        print(f"drill corpus {corpus.docs.shape}, {index.n_clusters} "
              f"clusters, {index.docs.shape[0]} rows")
    return corpus, index, queries


def rebuild_crash_drills(ctx, drill, *, cap=CAP, shift_batches=16):
    """Phases ``drill_<failpoint>`` for each of the six ``FAILPOINTS``
    and ``drill_drift`` on ``drill`` (``drill_substrate``'s corpus, index
    and queries): a rebuild with mutations landing after its ``begin``
    stage crashes at the failpoint and ``IndexRegistry.recover`` must
    land bit for bit on the no-rebuild state (a crash before COMMIT) or
    on the rebuilt state (at COMMIT or after), twice; then a
    ``DriftTracker`` must trigger on ``shift_batches`` batches of 64
    shifted adds and rebase after the rebuild it requests, which must
    not raise the corpus's mean nearest-centroid distance (Lloyd steps
    never do).  Returns the per-failpoint rows."""
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import policies
    from repro_torch.index import (DriftTracker, IndexRegistry, LiveIndex,
                                   MutationWAL, RebuildCrash, Rebuilder,
                                   version_of)
    from repro_torch.index.rebuild import FAILPOINTS, mean_nearest_sq_dist

    corpus, index, queries = drill
    docs = corpus.docs
    dim = docs.shape[1]
    pol = policies.patience(N_PROBE, delta=DELTA, phi=PHI, k=K, tau=TAU)

    def mutate(live, rng, added, n=6):
        vecs = (docs[rng.integers(0, len(docs), n)]
                + rng.normal(scale=NOISE, size=(n, dim))).astype(np.float32)
        added.extend(int(i) for i in live.add(vecs))
        live.delete([added.pop()])

    def drill(workdir, failpoint):
        wal = MutationWAL(os.path.join(workdir, "wal.log"))
        live = LiveIndex(index, delta_cap=cap, wal=wal)
        mgr = CheckpointManager(os.path.join(workdir, "snaps"), keep=1,
                                async_save=False)
        reg = IndexRegistry(version_of(live))
        reg.save(mgr)
        wal.note_durable(live.seq)
        rng, added = np.random.default_rng(2), []
        mutate(live, rng, added)
        rb = Rebuilder(live, reg, mgr, n_iters=DRILL_ITERS,
                       failpoint=failpoint)
        rb.request("crash-drill")
        try:
            while rb.active:
                if rb.tick() == "begin":
                    mutate(live, rng, added)
        except RebuildCrash:
            pass
        return wal, live, mgr, rb

    rows = []
    with tempfile.TemporaryDirectory(prefix="drill_oracle_") as tmp:
        owal, _, _, orb = drill(tmp, None)
        owal.close()
    oracle_rebuilt = orb.live
    ctx.reset()
    for fp in FAILPOINTS:
        with ctx.phase(f"drill_{fp}"), \
                tempfile.TemporaryDirectory(prefix="drill_") as tmp:
            wal, live, mgr, _ = drill(tmp, fp)
            ctx.sync()
            t0 = time.perf_counter()
            _, rec, rep = IndexRegistry.recover(mgr, wal, device=ctx.dev)
            ctx.sync()
            rec_ms = (time.perf_counter() - t0) * 1000
            committed = rec.epoch > 0
            if committed != (fp in ("commit", "promote")):
                raise AssertionError(f"drill {fp}: recovered epoch "
                                     f"{rec.epoch}")
            if not committed and not rep.rebuild_aborted:
                raise AssertionError(f"drill {fp}: the open epoch was not "
                                     f"aborted")
            oracle = oracle_rebuilt if committed else live
            same_live_state(rec, oracle, f"drill {fp}")
            same_answers(rec, oracle, queries, pol, f"drill {fp}")
            same_answers(rec, Rebuilt(rec), queries, pol,
                         f"drill {fp}: live vs rebuilt")
            _, again, _ = IndexRegistry.recover(mgr, wal, device=ctx.dev)
            same_live_state(again, rec, f"drill {fp}: second recovery")
            wal.close()
            row = dict(failpoint=fp,
                       resolution="promoted" if rep.rebuild_promoted
                       else "aborted" if rep.rebuild_aborted else "none",
                       epoch=rec.epoch, replayed=rep.applied,
                       bit_identical=True, recovery_ms=rec_ms)
            rows.append(row)
            print(json.dumps(row))
    ctx.sync()
    ctx.read("rebuild crash drills (recovered vs oracle vs rebuilt, fused "
             "and pair)", ["ivf_scan_merge", "ivf_scan_merge+delta",
                           "ivf_scan", "topk_merge", "delta_scan"])

    with ctx.phase("drill_drift"):
        live = LiveIndex(index, delta_cap=cap)
        reg = IndexRegistry(version_of(live))
        tracker = DriftTracker(index.centroids, docs, threshold=1.5)
        rb = Rebuilder(live, reg, n_iters=DRILL_ITERS,
                       on_publish=lambda new, _:
                       tracker.rebase(new.index.centroids))
        rng = np.random.default_rng(7)
        direction = rng.normal(size=dim)
        offset = (DRILL_SHIFT * direction / np.linalg.norm(direction)
                  ).astype(np.float32)
        first = None
        for b in range(shift_batches):
            batch = (docs[rng.integers(0, len(docs), 64)] + offset
                     ).astype(np.float32)
            live.add(batch)
            tracker.observe(batch)
            if first is None and tracker.triggered:
                first = b + 1
        if not tracker.triggered:
            raise AssertionError(f"the drift tracker did not trigger "
                                 f"(ratio {tracker.ratio})")
        ratio = tracker.ratio
        net, _ = live.net_corpus()
        before = mean_nearest_sq_dist(net, index.centroids)
        rep = rb.run_once(f"drift>{tracker.threshold}")
        after = mean_nearest_sq_dist(net, rb.live.index.centroids)
        if tracker.ratio != 0.0 or tracker.triggered or not torch.equal(
                tracker.centroids, rb.live.index.centroids):
            raise AssertionError("the drift tracker did not rebase")
        if not after <= before * (1 + 1e-6):
            raise AssertionError(f"the rebuild raised the corpus's mean "
                                 f"nearest-centroid distance {before} -> "
                                 f"{after}")
        print(json.dumps(dict(
            shifted_batches=shift_batches, triggered_at_batch=first,
            ratio_before_rebuild=ratio,
            corpus_dist_before=before, corpus_dist_after=after,
            moved=rep.moved, spilled=rep.spilled, epoch=rb.live.epoch)))
    return rows


# -- resilience: deadlines, shard retry, chaos ------------------------------


def deadline_phases(ctx, index, queries, exact, static):
    """Phases ``deadline_sim``, ``deadline_fused_vs_pair``,
    ``deadline_shed`` and ``deadline_real`` on the main path's index and
    queries.  ``static`` is the ``serve`` phase's report.  Under a
    simulated clock (SIM_WAVE_MS a wave) every query is answered once,
    none overshoots its budget by more than one wave, every degraded
    query names a reason, R*@k does not fall as the budget grows, the
    unbounded row is the static serve bit for bit, and the per-probe
    kernel pair gives the fused serve's report; waves of SHED_WAVE_MS
    under SHED_DEADLINE shed.  On the real clock the invariants only:
    the overshoot is printed, a finding and no gate.  Returns the
    simulated and real rows."""
    from collections import Counter

    import numpy as np
    from repro_torch.core import metrics
    from repro_torch.core.policies import DEGRADE_REASONS
    from repro_torch.core.serving import WaveScheduler
    from repro_torch.runtime.chaos import SimClock

    nq = queries.shape[0]
    others = ["ivf_scan_merge+delta", "delta_scan", "ivf_scan",
              "topk_merge"]

    def scheduler(**kw):
        return WaveScheduler(index, wave_size=B, chunk=CHUNK, k=K,
                             n_probe=N_PROBE, delta=DELTA, phi=PHI, **kw)

    def sim_serve(deadline, wave_ms=SIM_WAVE_MS, **kw):
        clock = SimClock()
        return scheduler(deadline_ms=deadline, clock=clock, **kw).serve(
            queries, on_wave=lambda w: clock.advance(wave_ms))

    def checked(rep, deadline, what, late_reason=True):
        """The invariants of a deadline serve (with ``late_reason``, also
        that a query past its budget names a reason: a query that exits
        on its own inside an overlong wave has none); returns its row."""
        if sorted(rep.results) != list(range(nq)) \
                or sorted(rep.latency_ms) != list(range(nq)):
            raise AssertionError(f"{what}: not every query answered once")
        reasons = Counter(rep.degraded.values())
        if not set(reasons) <= set(DEGRADE_REASONS):
            raise AssertionError(f"{what}: unknown reasons {reasons}")
        over = 0.0
        if deadline is not None:
            late = [q for q, lat in rep.latency_ms.items()
                    if lat > deadline and q not in rep.degraded]
            if late and late_reason:
                raise AssertionError(f"{what}: {len(late)} queries past "
                                     f"the budget carry no reason")
            over = max(lat - deadline for lat in rep.latency_ms.values())
        elif rep.degraded:
            raise AssertionError(f"{what}: degraded without a deadline")
        ids = np.stack([rep.results[i] for i in range(nq)])
        return dict(deadline_ms=deadline,
                    recall=metrics.r_star_at_k(ids, exact),
                    C=float(np.mean([rep.probes[i] for i in range(nq)])),
                    degraded_fraction=rep.degraded_fraction,
                    reasons=dict(reasons), shed=len(rep.shed_ids()),
                    max_overshoot_ms=max(over, 0.0), waves=rep.waves,
                    wave_cost_ms=rep.wave_cost_ms)

    sim = {}
    with ctx.phase("deadline_sim"):
        rows = []
        for dl in SIM_DEADLINES + (None,):
            ctx.reset()
            sim[dl] = sim_serve(dl)
            ctx.sync()
            ctx.read(f"deadline serve {dl} ms (sim clock, fused)",
                     ["ivf_scan_merge"], absent=others)
            row = checked(sim[dl], dl, f"deadline {dl} ms")
            rows.append(row)
            print(json.dumps(row))
            if row["max_overshoot_ms"] > SIM_WAVE_MS + 1e-9:
                raise AssertionError(f"deadline {dl} ms overshot by "
                                     f"{row['max_overshoot_ms']} ms, more "
                                     f"than one wave")
        recalls = [r["recall"] for r in rows]
        if any(a > b + 1e-9 for a, b in zip(recalls, recalls[1:])):
            raise AssertionError(f"R*@k falls as the budget grows: "
                                 f"{recalls}")
        free = sim[None]
        if free.degraded or any(
                not np.array_equal(free.results[i], static.results[i])
                or free.probes[i] != static.probes[i] for i in range(nq)):
            raise AssertionError("the unbounded deadline serve != the "
                                 "static serve")
        print("unbounded deadline serve == static serve bit for bit "
              "(results, probes), nothing degraded")

    with ctx.phase("deadline_fused_vs_pair"):
        dl = SIM_DEADLINES[1]
        ctx.reset()
        pair = sim_serve(dl, use_fused=False)
        ctx.sync()
        ctx.read(f"deadline serve {dl} ms (sim clock, per-probe kernel "
                 f"pair)", ["ivf_scan", "topk_merge"],
                 absent=["ivf_scan_merge", "ivf_scan_merge+delta",
                         "delta_scan", "slot_roll"])
        fused = sim[dl]
        for name in ("degraded", "latency_ms", "waves", "wave_cost_ms",
                     "probes"):
            if getattr(pair, name) != getattr(fused, name):
                raise AssertionError(f"deadline {dl} ms: fused != pair on "
                                     f"{name}")
        if pair.results.keys() != fused.results.keys() or any(
                not np.array_equal(pair.results[q], fused.results[q])
                for q in fused.results):
            raise AssertionError(f"deadline {dl} ms: fused != pair on "
                                 f"results")
        print(f"deadline {dl} ms: fused == per-probe kernel pair (results, "
              f"probes, degraded, latency_ms, waves, wave_cost_ms)")

    with ctx.phase("deadline_shed"):
        rep = sim_serve(SHED_DEADLINE, wave_ms=SHED_WAVE_MS)
        row = checked(rep, SHED_DEADLINE, "shed", late_reason=False)
        shed = rep.shed_ids()
        if not shed or any(rep.degraded[q] != "shed"
                           or (rep.results[q] != -1).any()
                           or rep.probes[q] != 0 for q in shed):
            raise AssertionError(f"shed rows off: {row}")
        print(json.dumps(row))

    real = []
    with ctx.phase("deadline_real"):
        def real_serve(deadline):
            ws = scheduler(deadline_ms=deadline)
            ctx.sync()
            t0 = time.perf_counter()
            rep = ws.serve(queries)
            ctx.sync()
            wall = (time.perf_counter() - t0) * 1000
            row = checked(rep, deadline, f"real deadline {deadline} ms",
                          late_reason=False)
            row.update(wall_ms=wall, wave_wall_ms=wall / rep.waves,
                       max_overshoot_waves=row["max_overshoot_ms"]
                       / max(rep.wave_cost_ms, 1e-9))
            print(json.dumps(row))
            return row

        real_serve(None)                    # warm: its wall is not used
        ctx.reset()
        free = real_serve(None)
        ctx.read("unbounded serve (real clock, fused)", ["ivf_scan_merge"],
                 absent=others)
        real.append(free)
        for mult in REAL_DEADLINE_WAVES:
            real.append(real_serve(mult * free["wave_wall_ms"]))
    return rows, real


def deadline_throttle(ctx, drill, *, cap=CAP, deadline=THROTTLE_DEADLINE):
    """Phase ``deadline_throttle`` on the drills' substrate: the live
    stream (MUTATION_RATE adds a wave, a merge every MERGE_EVERY) with a
    WAL, snapshots and a rebuild requested before the serve, once under a
    ``deadline`` of simulated ms (SIM_WAVE_MS a wave) and once without:
    the tight serve must pause rebuild ticks (``rebuild_throttled`` > 0),
    the unbounded one never and tick."""
    import os
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.serving import WaveScheduler
    from repro_torch.index import (IndexRegistry, LiveIndex, MutationWAL,
                                   Rebuilder, version_of)
    from repro_torch.launch.serve import MutationStream
    from repro_torch.runtime.chaos import SimClock

    corpus, index, queries = drill
    rows = {}
    ctx.reset()
    with ctx.phase("deadline_throttle"):
        for dl in (deadline, None):
            with tempfile.TemporaryDirectory(prefix="throttle_") as tmp:
                wal = MutationWAL(os.path.join(tmp, "wal.log"),
                                  group_commit_n=8, group_commit_ms=50.0)
                live = LiveIndex(index, delta_cap=cap, wal=wal)
                mgr = CheckpointManager(os.path.join(tmp, "snaps"), keep=1,
                                        async_save=False)
                reg = IndexRegistry(version_of(live))
                reg.save(mgr)
                wal.note_durable(live.seq)
                stream = MutationStream(live, reg, corpus.docs,
                                        rate=MUTATION_RATE,
                                        merge_every=MERGE_EVERY,
                                        noise=NOISE)
                rb = Rebuilder(live, reg, mgr, n_iters=DRILL_ITERS,
                               on_publish=stream.on_publish)
                rb.request("deadline-throttle")
                clock = SimClock()
                ws = WaveScheduler(index, wave_size=B, chunk=CHUNK, k=K,
                                   n_probe=N_PROBE, delta=DELTA, phi=PHI,
                                   registry=reg, rebuilder=rb,
                                   deadline_ms=dl, clock=clock)

                def on_wave(w):
                    clock.advance(SIM_WAVE_MS)
                    stream(w)

                rep = ws.serve(queries, on_wave=on_wave)
                wal.close()
            if sorted(rep.results) != list(range(queries.shape[0])):
                raise AssertionError("the throttle serve did not answer "
                                     "every query once")
            rows[dl] = dict(
                deadline_ms=dl, waves=rep.waves,
                rebuild_ticks=rep.rebuild_ticks,
                rebuild_throttled=rep.rebuild_throttled,
                epoch_swaps=rep.epoch_swaps, drain_waves=rep.drain_waves,
                rebuilds=rb.epochs_published,
                degraded_fraction=rep.degraded_fraction, **stream.stats)
            print(json.dumps(rows[dl]))
        ctx.sync()
        ctx.read("throttle serves (fused, registry, WAL, rebuild)",
                 ["ivf_scan_merge+delta"],
                 absent=["ivf_scan_merge", "delta_scan", "ivf_scan",
                         "topk_merge"])
        tight, free = rows[deadline], rows[None]
        if tight["rebuild_throttled"] <= 0:
            raise AssertionError(f"a {deadline} ms budget paused no "
                                 f"rebuild tick: {tight}")
        if free["rebuild_throttled"] or free["rebuild_ticks"] <= 0:
            raise AssertionError(f"the unbounded serve throttled or did "
                                 f"not tick: {free}")
    return rows


def shard_retry(ctx, index, queries, exact, static_recall):
    """Phase ``shard_retry``: the main path's index dealt over N_SHARDS
    shards (``shard_index``, on the host) and searched by
    ``search_with_retry`` at n_probe N_PROBE on the card (plain scoring:
    the shards' lists are not ``blk_l``-aligned, so no list kernel
    applies).  The clean run's R*@k is printed beside the static
    serve's; a flaky shard whose retries succeed answers as the clean
    run bit for bit; a dead shard is skipped with its non-empty lists
    lost; a budget that runs dry skips shards without waiting."""
    import numpy as np
    from repro_torch.core import metrics
    from repro_torch.core.distributed_ivf import (ShardFault,
                                                  search_with_retry,
                                                  shard_index)
    from repro_torch.runtime.straggler import RetryPolicy

    def flaky(shard, attempt):
        if shard == 1 and attempt < 2:
            raise ShardFault("flaky shard 1")

    def dead(shard, attempt):
        if shard == 0:
            raise ShardFault("shard 0 is gone")

    def all_dead(shard, attempt):
        raise ShardFault(f"shard {shard} is gone")

    with ctx.phase("shard_retry"):
        t0 = time.perf_counter()
        sh = shard_index(index, N_SHARDS)
        shard_s = time.perf_counter() - t0
        slept = []

        def run(**kw):
            ctx.sync()
            t1 = time.perf_counter()
            out = search_with_retry(sh, queries, k=K, n_probe=N_PROBE,
                                    sleep=slept.append, device=ctx.dev,
                                    **kw)
            ctx.sync()
            return out + ((time.perf_counter() - t1) * 1000,)

        ctx.reset()
        s0, i0, rep0, ms0 = run()
        ctx.read("search_with_retry (plain scoring, row_topk ranking)",
                 ["row_topk"],
                 absent=[n for n in ctx.counter_names if n != "row_topk"])
        recall = metrics.r_star_at_k(i0, exact)
        print(json.dumps(dict(
            shards=N_SHARDS, rows_per_shard=sh.docs.shape[1],
            shard_index_s=shard_s, clean_ms=ms0, recall_clean=recall,
            recall_static_serve=static_recall, attempts=rep0.attempts)))
        if rep0.retries or rep0.skipped_shards:
            raise AssertionError(f"the clean run retried: {rep0}")
        s1, i1, rep1, _ = run(retry=RetryPolicy(max_retries=3), fault=flaky)
        if not (np.array_equal(i1, i0) and np.array_equal(s1, s0)) \
                or rep1.retries != 2 or rep1.skipped_shards:
            raise AssertionError(f"a flaky shard's retries changed the "
                                 f"answer: {rep1}")
        _, i2, rep2, _ = run(retry=RetryPolicy(max_retries=2), fault=dead)
        lost = int((sh.sizes[0] > 0).sum())
        if rep2.skipped_shards != [0] or rep2.lost_clusters != lost \
                or not (i2 >= 0).all():
            raise AssertionError(f"the dead shard: {rep2}, want "
                                 f"{lost} lost lists")
        _, _, rep3, _ = run(retry=RetryPolicy(max_retries=3, base_ms=4.0,
                                              budget_ms=10.0),
                            fault=all_dead)
        if rep3.budget_skips <= 0 or not rep3.budget_exhausted:
            raise AssertionError(f"the budget never ran dry: {rep3}")
        print(json.dumps(dict(
            flaky=dict(retries=rep1.retries, backoff_ms=rep1.backoff_ms),
            dead=dict(skipped=rep2.skipped_shards,
                      lost_clusters=rep2.lost_clusters,
                      recall=metrics.r_star_at_k(i2, exact)),
            budget=dict(skipped=rep3.skipped_shards,
                        budget_skips=rep3.budget_skips,
                        backoff_ms=rep3.backoff_ms))))
    return recall, sh


MESH_SAMPLE_ROWS = 1 << 20     # sharded_assign_step's rows (sampled docs)
INT8_RECALL_GAP = 0.02         # the reference test's int8 bound (0.98)
CENTROID_RTOL = 1e-5           # the (4, 1) Lloyd step against one rank's
MESH_TIMEOUT, MESH_DEADLINE = 120.0, 600.0   # s: a collective, a launch
SHARD_KEYS = ("centroids", "docs", "doc_ids", "offsets", "sizes")


def mesh_rank(rank, world, cfg):
    """One rank of the ``mesh_search`` phase (spawned by
    ``launch.mesh.launch``; ``cfg`` carries every setting, since a
    spawned rank imports this module afresh).  It reads its own shard of
    the ``.npy`` stacks in ``cfg["dir"]`` (memory-mapped; the queries and
    the assign step's rows and centroids in ``cfg["common"]``), runs the mesh
    search's rows on a (1, S) mesh and ``sharded_assign_step`` on an
    (S, 1) mesh, and returns their results, wall ms and steps."""
    from pathlib import Path as P_

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed_ivf import (ShardedIVF, local_shard,
                                                  make_distributed_search,
                                                  quantize_sharded)
    from repro_torch.core.kmeans import (_assign_block, _update,
                                         sharded_assign_step)
    from repro_torch.launch.mesh import axis_group, local_block, \
        make_local_mesh

    if dist.get_backend() != cfg["backend"]:
        raise AssertionError(f"backend {dist.get_backend()}")
    d = P_(cfg["dir"])
    dev = torch.device(cfg["device"])
    n = cfg["shards"]
    mm = {key: np.load(d / f"{key}.npy", mmap_mode="r") for key in SHARD_KEYS}
    mesh = make_local_mesh(1, n)
    loc = local_shard(ShardedIVF(*(mm[key] for key in SHARD_KEYS),
                                 cfg["list_pad"], n), mesh)
    common = P_(cfg["common"])
    queries = torch.as_tensor(np.load(common / "queries.npy"), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def place(sh):
        blocks = [getattr(sh, key) for key in SHARD_KEYS]
        if sh.doc_scales is not None:
            blocks.append(sh.doc_scales)
        return [torch.as_tensor(x, device=dev) for x in blocks]

    def timed(fn, *args):
        fn(*args)                       # warm-up
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        return out, (time.perf_counter() - t0) * 1000

    f32 = place(loc)
    out = {}
    for name, kw in cfg["rows"].items():
        arrays = f32
        if kw.get("int8_docs"):
            arrays = place(quantize_sharded(loc))
        fn = make_distributed_search(
            mesh, n_probe=cfg["n_probe"], k=cfg["k"],
            list_pad=cfg["list_pad"], device=dev, **kw)
        (s, i, p), ms = timed(fn, *arrays[:5], queries, *arrays[5:])
        if not all(t.device == dev for t in (s, i, p)):
            raise AssertionError(f"{name}: results off {dev}")
        out[name] = dict(ms=ms, stats=fn.stats, scores=s.cpu().numpy(),
                         ids=i.cpu().numpy(), probes=p.cpu().numpy())
    del f32, arrays
    amesh = make_local_mesh(n, 1)
    x = torch.as_tensor(np.array(local_block(
        np.load(common / "x.npy", mmap_mode="r"),
        axis_group(amesh, "data"))), device=dev)
    c = torch.as_tensor(np.load(common / "c.npy"), device=dev)
    (new, assign), ms = timed(sharded_assign_step(amesh), x, c)
    out["assign"] = dict(ms=ms, rows=x.shape[0], new=new.cpu().numpy(),
                         assign=assign.cpu().numpy())
    if n == 1:
        want = _update(x, _assign_block(x, c)[0], c)
        out["assign"]["lloyd_bit_for_bit"] = bool(torch.equal(new, want))
    return out


def mesh_search(ctx, index, corpus, queries, exact, static, shards4):
    """Phase ``mesh_search``: ``make_distributed_search`` and
    ``sharded_assign_step`` on ranks spawned by ``launch.mesh.launch``,
    on the main path's index and queries.  The shards go to the ranks
    as ``.npy`` stacks in a temporary directory, each rank reading only
    its own block.  (a) One NCCL rank, mesh (1, 1), over
    ``shard_index(index, 1)``: patience at probe width 1 and 4 beside
    the static serve; fixed-N against ``search_with_retry`` on the same
    shard (ids equal up to near-tie swaps, scores within ATOL);
    ``sharded_assign_step`` on MESH_SAMPLE_ROWS sampled docs x
    N_CLUSTERS centroids, bit for bit the port's Lloyd step.  (b) Four
    gloo ranks on the one card (collectives staged through host memory),
    mesh (1, 4), over the ``shard_retry`` phase's 4 shards: fixed-N
    against ``search_with_retry``, patience, int8 (``quantize_sharded``,
    R*@1 within INT8_RECALL_GAP of fixed-N's), and the (4, 1) assign
    step equal to (a)'s.  The mesh path runs no kernel of the port: the
    reference's mesh gathers and multiplies outside Pallas too."""
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import metrics
    from repro_torch.core.distributed_ivf import (search_with_retry,
                                                  shard_index)
    from repro_torch.launch.mesh import launch

    card = card_line()
    on_card = ctx.dev.type == "cuda"
    patience = dict(patience_delta=DELTA, patience_phi=PHI)

    def write(d, sh):
        for key in SHARD_KEYS:
            np.save(os.path.join(d, f"{key}.npy"), getattr(sh, key))

    def run(d, shards, backend, rows):
        cfg = dict(dir=d, common=d1, shards=shards, backend=backend,
                   device=str(ctx.dev) if on_card else "cpu", rows=rows,
                   n_probe=N_PROBE, k=K, list_pad=LIST_PAD)
        t0 = time.perf_counter()
        outs = launch(mesh_rank, shards, cfg, backend=backend,
                      device="cuda" if on_card else "cpu",
                      timeout=MESH_TIMEOUT, deadline=MESH_DEADLINE)
        launch_s = time.perf_counter() - t0
        for o in outs[1:]:              # the whole result on every rank
            for name in rows:
                for key in ("ids", "probes", "scores"):
                    if not np.array_equal(o[name][key], outs[0][name][key]):
                        raise AssertionError(f"{name}: ranks differ on "
                                             f"{key}")
        return outs, launch_s

    def report(label, name, o):
        ids = o["ids"]
        print(json.dumps(dict(
            mesh=label, row=name, wall_ms=o["ms"], steps=o["stats"]["steps"],
            ms_per_step=o["ms"] / o["stats"]["steps"],
            all_gather_bytes=o["stats"]["gather_bytes"],
            all_reduce_bytes=o["stats"]["reduce_bytes"],
            C=float(o["probes"].mean()),
            **{"R*@1": metrics.r_star_at_1(ids, exact[:, 0]),
               "R*@k": metrics.r_star_at_k(ids, exact)},
            static_serve={m: static[m] for m in ("R*@1", "R*@k", "C")},
            card=card)))

    def against_retry(label, sh, o):
        ws, wi, rep = search_with_retry(sh, queries, k=K, n_probe=N_PROBE,
                                        device=ctx.dev)
        if rep.retries or rep.skipped_shards:
            raise AssertionError(f"{label}: search_with_retry {rep}")
        swaps, err = near_tie_swaps(
            torch.from_numpy(o["scores"]), torch.from_numpy(o["ids"]),
            torch.from_numpy(ws), torch.from_numpy(wi),
            f"{label} fixed-N mesh vs search_with_retry")
        print(json.dumps(dict(mesh=label, fixed_vs_search_with_retry=dict(
            max_score_err=err, near_tie_id_swaps=swaps), card=card)))

    with ctx.phase("mesh_search"), \
            tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d4:
        if on_card:                     # the ranks share this card
            torch.cuda.empty_cache()
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        sh1 = shard_index(index, 1)
        x = corpus.docs[rng.integers(0, corpus.docs.shape[0],
                                     MESH_SAMPLE_ROWS)]
        c = corpus.docs[rng.choice(corpus.docs.shape[0], N_CLUSTERS,
                                   replace=False)]
        np.save(os.path.join(d1, "queries.npy"), queries.cpu().numpy())
        np.save(os.path.join(d1, "x.npy"), x)
        np.save(os.path.join(d1, "c.npy"), c)
        write(d1, sh1)
        write(d4, shards4)
        del x
        print(json.dumps(dict(setup_s=time.perf_counter() - t0,
                              rows_per_shard_1=sh1.docs.shape[1],
                              rows_per_shard_4=shards4.docs.shape[1])))

        # (a) one NCCL rank
        label = "(1,1) nccl" if on_card else "(1,1) gloo"
        outs, launch_s = run(d1, 1, "nccl" if on_card else "gloo", dict(
            fixed={}, patience_w1=patience,
            patience_w4=dict(patience, probe_width=4)))
        a = outs[0]
        print(json.dumps(dict(mesh=label, launch_s=launch_s, card=card)))
        for name in ("patience_w1", "patience_w4", "fixed"):
            report(label, name, a[name])
        against_retry(label, sh1, a["fixed"])
        del sh1
        if not a["assign"]["lloyd_bit_for_bit"]:
            raise AssertionError("one rank's sharded_assign_step != the "
                                 "port's Lloyd step")
        print(json.dumps(dict(mesh=label, row="sharded_assign_step",
                              rows=a["assign"]["rows"], centroids=N_CLUSTERS,
                              wall_ms=a["assign"]["ms"],
                              lloyd_bit_for_bit=True, card=card)))

        # (b) four gloo ranks on the one card
        label = "(1,4) gloo"
        outs, launch_s = run(d4, N_SHARDS, "gloo", dict(
            fixed={}, patience_w1=patience, int8=dict(int8_docs=True)))
        b = outs[0]
        print(json.dumps(dict(mesh=label, launch_s=launch_s,
                              rank_ms={name: [o[name]["ms"] for o in outs]
                                       for name in ("fixed", "patience_w1",
                                                    "int8")},
                              card=card)))
        for name in ("fixed", "patience_w1", "int8"):
            report(label, name, b[name])
        against_retry(label, shards4, b["fixed"])
        r_f32 = metrics.r_star_at_1(b["fixed"]["ids"], exact[:, 0])
        r_int8 = metrics.r_star_at_1(b["int8"]["ids"], exact[:, 0])
        if abs(r_f32 - r_int8) > INT8_RECALL_GAP:
            raise AssertionError(f"int8 R*@1 {r_int8} vs f32 {r_f32}")
        # each centroid within CENTROID_RTOL of its largest coordinate:
        # four partial sums add in another order than one rank's
        want = a["assign"]["new"]
        scale = np.abs(want).max(1, keepdims=True)
        rel = max(float((np.abs(o["assign"]["new"] - want) / scale).max())
                  for o in outs)
        for o in outs:
            if not np.array_equal(o["assign"]["assign"],
                                  a["assign"]["assign"]):
                raise AssertionError("(4,1) assignments != one rank's")
        if rel > CENTROID_RTOL:
            raise AssertionError(f"(4,1) centroids off one rank's by {rel}")
        print(json.dumps(dict(
            mesh="(4,1) gloo", row="sharded_assign_step",
            rows_per_rank=b["assign"]["rows"],
            wall_ms=[o["assign"]["ms"] for o in outs],
            assign_equal_one_rank=True, max_rel_centroid_err=rel,
            card=card)))


def check_chaos_artifact(d):
    """The assertions of ``make chaos-smoke`` and the resilience part of
    ``make bench-smoke`` on a ``BENCH_resilience_torch.json``."""
    if not (d["recovery"]["bit_identical"] and d["recovery"]["crashes"] > 0
            and len(d["deadline_curve"]) > 0
            and d["shard_faults"]["attempts"] > 0):
        raise AssertionError(f"chaos-smoke: {d['recovery']}, "
                             f"{d['shard_faults']}")
    rb = d["rebuild"]
    bs = rb["crash_boundaries"]
    sr, dr = rb["swap_race"], rb["drift"]
    ok = (len(bs) == 6 and all(b["bit_identical"] for b in bs)
          and {"aborted", "committed"} == {b["resolution"] for b in bs}
          and sr["fenced"] and sr["lost_mutations"] == 0
          and sr["recovered_bit_identical"]
          and dr["rebuilds_triggered"] > 0 and dr["recall_restored"])
    keys = (all({"failpoint", "resolution", "bit_identical", "recovery_ms"}
                <= b.keys() for b in bs)
            and {"fenced", "lost_mutations", "recovered_bit_identical"}
            <= sr.keys()
            and {"recall_fixed", "recall_rebuilt", "rebuilds_triggered",
                 "recall_restored"} <= dr.keys())
    if not (ok and keys):
        raise AssertionError(f"chaos-smoke/bench-smoke on the rebuild "
                             f"drills: {rb}")


def chaos_phase(ctx, drill):
    """Phase ``chaos``: ``run_chaos`` (its default ``ChaosConfig``) on the
    drills' substrate at k K and n_probe N_PROBE, its payload written as
    ``BENCH_resilience_torch.json`` into a temporary directory with the
    backend, the card's name and its power limit, read back and held to
    ``make chaos-smoke`` and bench-smoke's resilience assertions."""
    import os
    import tempfile

    import torch
    from repro_torch.benchmarks.common import device_info
    from repro_torch.core import brute_force
    from repro_torch.runtime.chaos import ChaosConfig, run_chaos

    corpus, index, queries = drill
    with ctx.phase("chaos"), tempfile.TemporaryDirectory() as tmp:
        exact = brute_force(torch.from_numpy(corpus.docs).to(ctx.dev),
                            queries, K)[1].cpu().numpy()
        ctx.reset()
        payload = run_chaos(index, corpus.docs, corpus.queries, exact,
                            ChaosConfig(), tmp, k=K, n_probe=N_PROBE)
        ctx.sync()
        ctx.read("run_chaos (drills: kernel pair and fused, live index)",
                 ["ivf_scan_merge", "ivf_scan_merge+delta", "ivf_scan",
                  "topk_merge", "delta_scan"])
        payload.update(device_info(ctx.dev))
        out = os.path.join(tmp, "BENCH_resilience_torch.json")
        with open(out, "w") as f:
            json.dump(payload, f, indent=2)
        with open(out) as f:
            d = json.load(f)
        check_chaos_artifact(d)
        name, limit = (x.strip() for x in card_line().rsplit(",", 1))
        want = dict(backend="cuda", device=torch.cuda.get_device_name(0),
                    power_limit=limit)
        got = {key: d.get(key) for key in want}
        if got != want:
            raise AssertionError(f"chaos artifact names {got}, not {want}")
        print(json.dumps({key: d[key] for key in (
            "recovery", "deadline_curve", "shard_faults", "wall_s")}))
        print(json.dumps({"rebuild": {
            "crash_boundaries": [{key: b[key] for key in (
                "failpoint", "resolution", "recovery_ms", "bit_identical")}
                for b in d["rebuild"]["crash_boundaries"]],
            "swap_race": d["rebuild"]["swap_race"],
            "drift": d["rebuild"]["drift"]}}))
    return d


def serving_bench_smoke(ctx):
    """Phase ``serving_bench_smoke``: ``serving_bench.main(smoke=True)``
    on the card (its substrate cached and its JSON written in a
    temporary directory): the live stream's ``recall_gap`` within
    RECALL_GAP_MAX, the fused row's mean probes the compact row's, the
    artifact naming the backend, the card and its power limit."""
    import os
    import tempfile

    import torch
    from repro_torch.benchmarks import common, serving_bench

    with ctx.phase("serving_bench_smoke"), \
            tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "BENCH_serving_torch.json")
        cache, common.CACHE = common.CACHE, os.path.join(tmp, "cache")
        try:
            ctx.reset()
            rows = serving_bench.main(smoke=True, out=out)
            ctx.sync()
        finally:
            common.CACHE = cache
        ctx.read("serving_bench.main(smoke=True)",
                 ["ivf_scan_merge", "ivf_scan_merge+delta", "ivf_scan",
                  "topk_merge"])
        with open(out) as f:
            art = json.load(f)
        name, limit = (x.strip() for x in card_line().rsplit(",", 1))
        want = dict(backend="cuda", device=torch.cuda.get_device_name(0),
                    power_limit=limit)
        got = {key: art.get(key) for key in want}
        if got != want:
            raise AssertionError(f"serving artifact names {got}, not "
                                 f"{want}")
        gap = art["live_stream"]["recall_gap"]
        if gap > RECALL_GAP_MAX:
            raise AssertionError(f"live-stream recall gap {gap} > "
                                 f"{RECALL_GAP_MAX}")
        if rows["fused"]["mean_probes"] != rows["compact"]["mean_probes"]:
            raise AssertionError("the fused row's mean probes differ from "
                                 "the compact row's")
        print(json.dumps({tag: {key: r[key] for key in (
            "occupancy", "waves", "mean_probes", "recall", "wall_s")}
            for tag, r in rows.items() if isinstance(r, dict)}))
        print(f"serving_bench.main(smoke=True) on {name} ({limit}): "
              f"recall_gap {gap}, speedup {rows['speedup']}")
    return rows


def kernel_bench_phase(ctx):
    """Phase ``kernel_bench``: ``kernel_bench.main()`` on the card, its
    JSON (written in a temporary directory) held to the schema
    ``make bench-smoke`` asserts, the card named with its power limit,
    every kernel beside its plain version (f32 rows within 1e-3 of it,
    bf16 flash within 0.05: normal inputs, d 64)."""
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.benchmarks import kernel_bench

    with ctx.phase("kernel_bench"), tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "BENCH_kernels_torch.json")
        kernel_bench.main(out=out)
        with open(out) as f:
            d = json.load(f)
        kernel_bench.check_schema(d)
        name, limit = (x.strip() for x in card_line().rsplit(",", 1))
        want = dict(backend="cuda", device=torch.cuda.get_device_name(0),
                    power_limit=limit, pipelined_available=True)
        got = {key: d.get(key) for key in want}
        if got != want:
            raise AssertionError(f"kernel_bench names {got}, not {want}")
        names = {r["name"] for r in d["rows"]}
        for r in d["rows"]:
            tol = 0.05 if "bf16" in r["name"] else 1e-3
            if not (r["us"] > 0 and np.isfinite(r["err"])
                    and r["err"] <= tol):
                raise AssertionError(f"kernel_bench row {r}")
        for kern in ("flash_attention", "flash_attention_bf16", "ivf_scan",
                     "topk_merge", "ivf_scan_merge", "delta_scan",
                     "embedding_bag"):
            if not {f"{kern}_plain", f"{kern}_cuda"} <= names:
                raise AssertionError(f"kernel_bench has no {kern} rows")
        print(f"kernel_bench on {name} ({limit}): {len(d['rows'])} rows, "
              f"{len(d['fused_sweep'])} fused sweep rows, sort "
              f"{json.dumps(d['sort'])}")


# ---------------------------------------------------------------------------
# the GNN (gat-cora at GNN_SHAPES) and the dry run
# ---------------------------------------------------------------------------

GNN_ARCH = "gat-cora"
GNN_FULL_STEPS, GNN_LR = 100, 0.02   # examples/gnn_and_recsys.py's GAT run
GNN_STEPS = 3                        # timed steps of the larger cells
# the card's first full_graph_sm step against the CPU port's same step
# in f64 (its exact value at these weights): the loss within 1e-5 and
# each gradient leaf within 1e-5 of its max |.| (tests/test_torch_gnn.py's
# tolerances against the reference).  Not against the CPU port's f32
# step: on the card-drawn weights its layer-0 a_dst gradient is 7.4e-3
# of the leaf's max off the f64 value, where the card's f32 step is
# within 1e-6.  One (edge, head) of layer 0's attention logits lies at
# -4.4e-8 before the leaky ReLU in f64; torch's f32 product on the CPU
# puts it at +4.5e-8, across the kink, where the gradient's slope jumps
# from 0.2 to 1 (the reference's f32 step on the CPU stays on the f64
# side, within 1.9e-6: tests/gat_f32_diagnostic.py).  That difference is
# printed, not gated
GNN_ATOL, GNN_GRAD_REL = 1e-5, 1e-5
# ogbn-products' training steps run on a random_graph of 1/GNN_TRAIN_CUT
# of its nodes and edges (the published 25.26 edges a node and d_feat
# kept): a full-scale step runs the card out of memory (its forward alone,
# without autograd, peaks at 63.9 GB; a step at 1/2 at 68.5 GB)
GNN_TRAIN_CUT = 2
DRYRUN_CELLS = (("starcoder2-3b", "train_4k"), ("deepseek-moe-16b", "train_4k"),
                ("gat-cora", "ogb_products"), ("deepfm", "train_batch"),
                ("msmarco-ivf", "ivf_serve_1k"), ("msmarco-ivf", "ivf_build"))
DRYRUN_TIMEOUT = 900


def gat_pass_bytes(cfg, n_edges):
    """The bytes of one f32 pass over each per-edge tensor of each GAT
    layer, (E, H, D) and (E, H), and of one layer's forward by the pass
    count of ``models/gnn.py``'s attention layer: 4 (E, H, D) passes (the
    source gather's write, the message's two reads and write, its
    segment sum's read) and 22 (E, H) passes (gathers, the leaky ReLU,
    the segment max and sum, the softmax's elementwise steps)."""
    out = []
    for i in range(cfg.n_layers):
        d = cfg.n_classes if i == cfg.n_layers - 1 else cfg.d_hidden
        ehd, eh = n_edges * cfg.n_heads * d * 4, n_edges * cfg.n_heads * 4
        out.append(dict(layer=i, ehd_pass_bytes=ehd, eh_pass_bytes=eh,
                        forward_bytes=4 * ehd + 22 * eh))
    return out


def gnn_phases(ctx):
    """The GAT (``configs/gat_cora``: 2 layers, 8 heads x 8) at the shapes
    of ``GNN_SHAPES``, plain PyTorch on the card (the reference's GAT is
    ``segment_*`` ops that XLA lowers itself: no Pallas kernel, so no
    launch counter moves).  ``gnn_full_graph_sm`` (Cora's sizes): the
    first step's loss and gradients against the same step on the CPU
    port, one AdamW step run twice from one state bit for bit, then the
    example's 100 steps; ``gnn_ogb_products``: one forward at full scale
    (ms, peak memory, each per-edge pass's bytes bound), then
    ``GNN_STEPS`` training steps on a ``random_graph`` cut to
    1/``GNN_TRAIN_CUT`` (a full-scale step does not fit);
    ``gnn_minibatch_lg`` (Reddit's sizes): the CSR built on the host,
    ``GNN_STEPS`` steps of ``loss_blocks`` + AdamW on ``sample_blocks`` ->
    ``pad_block`` batches of 1,024 seeds at fanouts 15/10, the sampler's
    host ms beside the device step's; ``gnn_molecule``: 128 disjoint
    graphs of 30 nodes and 64 edges, ``GNN_STEPS`` steps.  Returns the
    summary (the ogb_products forward's figures for ``dryrun_phase``)."""
    import functools
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.graph_sampler import (CSRGraph, block_shapes,
                                                pad_block, sample_blocks)
    from repro_torch.data.synthetic import random_graph
    from repro_torch.launch import train
    from repro_torch.models import gnn
    from repro_torch.models.layers import tree_map
    from repro_torch.optim.optimizers import adamw

    spec = get_arch(GNN_ARCH)
    dims = {s.name: s.dims for s in spec.shapes}
    out = {}

    def cfg_of(shape):
        return dataclasses.replace(spec.model, d_in=dims[shape]["d_feat"])

    def graph_on(g_np, dev):
        return gnn.Graph(*(torch.from_numpy(g_np[k]).to(dev) for k in
                           ("feat", "edge_src", "edge_dst", "label")))

    def run_steps(loss, params, steps, lr=GNN_LR):
        """``steps`` AdamW steps of ``loss(params)``: the losses and the
        device ms of each step."""
        opt = adamw(lr, weight_decay=0.0)
        state = opt.init(params)
        losses, ms = [], []
        for i in range(steps):
            ctx.sync()
            t0 = time.perf_counter()
            lv, grads = train.value_and_grad(loss, params)
            opt.update(grads, state, params, i)
            del grads
            ctx.sync()
            ms.append((time.perf_counter() - t0) * 1000)
            losses.append(float(lv))
        return losses, ms, state

    with ctx.phase("gnn_full_graph_sm"):
        cfg = cfg_of("full_graph_sm")
        d = dims["full_graph_sm"]
        g_np = random_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                            cfg.n_classes, seed=0)
        graph = graph_on(g_np, ctx.dev)
        params = gnn.init_params(cfg, seed=0, device=ctx.dev)
        ctx.reset()
        loss_d, g_d = train.value_and_grad(
            functools.partial(gnn.loss_fn, cfg, g=graph), params)
        ctx.sync()
        ctx.read("gat full_graph_sm loss and gradients", [],
                 absent=ctx.counter_names)

        def cpu_step(dtype):
            g = graph_on(g_np, "cpu")
            g = g._replace(feat=g.feat.to(dtype))
            return train.value_and_grad(
                functools.partial(gnn.loss_fn, cfg, g=g),
                tree_map(lambda t: t.detach().cpu().to(dtype), params))

        def worst_leaf(got, want):
            worst = (0.0, "")
            for (name, a), (_, b) in zip(named_leaves(got),
                                         named_leaves(want)):
                a, b = a.detach().double().cpu(), b.double()
                scale = float(b.abs().max())
                err = float((a - b).abs().max())
                worst = max(worst, (err / scale if scale else err, name))
            return worst

        loss_64, g_64 = cpu_step(torch.float64)
        loss_32, g_32 = cpu_step(torch.float32)
        worst = worst_leaf(g_d, g_64)
        worst_32 = worst_leaf(g_32, g_64)
        hold = dict(loss_card=float(loss_d), loss_cpu_f64=float(loss_64),
                    loss_cpu_f32=float(loss_32),
                    loss_abs_err=abs(float(loss_d) - float(loss_64)),
                    worst_grad_rel_err=worst[0], worst_grad_leaf=worst[1],
                    cpu_f32_worst_grad_rel_err=worst_32[0],
                    cpu_f32_worst_grad_leaf=worst_32[1],
                    card_vs_cpu_f32_worst=worst_leaf(g_d, g_32),
                    bounds=dict(loss_atol=GNN_ATOL, grad_rel=GNN_GRAD_REL))
        print(json.dumps({"gnn_full_graph_sm_vs_cpu": hold}))
        if hold["loss_abs_err"] > GNN_ATOL or worst[0] > GNN_GRAD_REL:
            raise AssertionError(f"the card's GAT step is off the CPU "
                                 f"port's: {hold}")

        def one_step():
            p = tree_map(torch.clone, params)
            _, _, st = run_steps(functools.partial(gnn.loss_fn, cfg,
                                                   g=graph), p, 1)
            return p, st

        if not same_bits(one_step(), one_step()):
            raise AssertionError("one GAT step from one state gave other "
                                 "bits on a second run")
        print("one GAT AdamW step run twice from one state: the same bits")
        losses, ms, _ = run_steps(functools.partial(gnn.loss_fn, cfg,
                                                    g=graph),
                                  params, GNN_FULL_STEPS)
        _, m = gnn.loss_fn(cfg, params, graph)
        out["full_graph_sm"] = dict(
            nodes=d["n_nodes"], edges=d["n_edges"], d_feat=d["d_feat"],
            first_loss=losses[0], last_loss=losses[-1], acc=float(m["acc"]),
            step_ms_median=float(np.median(ms[1:])), steps=len(ms), hold=hold)
        print(json.dumps({"gnn_full_graph_sm": out["full_graph_sm"]}))
        if not losses[-1] < losses[0] or not np.isfinite(losses).all():
            raise AssertionError(f"the GAT did not learn: {losses[::10]}")
        del graph, params, g_d, g_64, g_32

    with ctx.phase("gnn_ogb_products"):
        cfg = cfg_of("ogb_products")
        d = dims["ogb_products"]
        t0 = time.perf_counter()
        g_np = random_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                            cfg.n_classes, seed=1)
        host_s = time.perf_counter() - t0
        graph = graph_on(g_np, ctx.dev)
        del g_np
        params = gnn.init_params(cfg, seed=0, device=ctx.dev)
        with torch.no_grad():
            gnn.forward(cfg, params, graph)     # the graph's sort, once
            ctx.sync()
            ctx.reset_peak()
            base = torch.cuda.memory_allocated(ctx.dev)
            t0 = time.perf_counter()
            logits = gnn.forward(cfg, params, graph)
            ctx.sync()
            fwd_ms = (time.perf_counter() - t0) * 1000
        passes = gat_pass_bytes(cfg, d["n_edges"])
        fwd_bytes = sum(p["forward_bytes"] for p in passes)
        fwd = dict(nodes=d["n_nodes"], edges=d["n_edges"],
                   d_feat=d["d_feat"], graph_host_s=host_s,
                   forward_ms=fwd_ms, peak_bytes=ctx.peak(),
                   peak_above_inputs_bytes=ctx.peak() - base,
                   passes=passes, forward_pass_bytes=fwd_bytes,
                   forward_bytes_bound_ms=fwd_bytes / HBM_BYTES_PER_S * 1e3,
                   finite=bool(torch.isfinite(logits).all()))
        fwd["bytes_bound_share"] = fwd["forward_bytes_bound_ms"] / fwd_ms
        print(json.dumps({"gnn_ogb_products_forward": fwd}))
        if not fwd["finite"] or logits.shape != (d["n_nodes"],
                                                 cfg.n_classes):
            raise AssertionError("the full-scale GAT forward is not finite "
                                 "or of the wrong shape")
        del logits
        out["ogb_products_forward"] = fwd

        # the full graph makes way for the cut one
        del graph
        gc.collect()
        torch.cuda.empty_cache()
        n, e = d["n_nodes"] // GNN_TRAIN_CUT, d["n_edges"] // GNN_TRAIN_CUT
        g = graph_on(random_graph(n, e, d["d_feat"], cfg.n_classes, seed=1),
                     ctx.dev)
        ctx.reset_peak()
        losses, ms, _ = run_steps(functools.partial(gnn.loss_fn, cfg, g=g),
                                  params, GNN_STEPS + 1)
        tr = dict(cut=GNN_TRAIN_CUT, nodes=n, edges=e, losses=losses,
                  step_ms=ms, step_ms_median=float(np.median(ms[1:])),
                  peak_bytes=ctx.peak(),
                  forward_bytes_bound_ms=sum(
                      q["forward_bytes"] for q in gat_pass_bytes(cfg, e))
                  / HBM_BYTES_PER_S * 1e3)
        out["ogb_products_train"] = tr
        print(json.dumps({"gnn_ogb_products_train": tr}))
        if not np.isfinite(tr["losses"]).all():
            raise AssertionError("the GAT's ogbn-products losses are not "
                                 "finite")
        del g, params
        gc.collect()
        torch.cuda.empty_cache()

    with ctx.phase("gnn_minibatch_lg"):
        cfg = cfg_of("minibatch_lg")
        d = dims["minibatch_lg"]
        t0 = time.perf_counter()
        g_np = random_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                            cfg.n_classes, seed=2)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        csr = CSRGraph.from_edges(g_np["edge_src"], g_np["edge_dst"],
                                  d["n_nodes"])
        csr_s = time.perf_counter() - t0
        feats = torch.from_numpy(g_np["feat"]).to(ctx.dev)
        labels = torch.from_numpy(g_np["label"]).to(ctx.dev)
        del g_np
        fanouts = (d["fanout0"], d["fanout1"])
        bn = d["batch_nodes"]
        shapes = block_shapes(bn, fanouts)
        n_outs = tuple(o for (_, _, o) in shapes)
        params = gnn.init_params(cfg, seed=0, device=ctx.dev)
        opt = adamw(GNN_LR, weight_decay=0.0)
        state = opt.init(params)
        rng = np.random.default_rng(0)
        host_ms, dev_ms, losses = [], [], []
        ctx.reset_peak()
        for i in range(GNN_STEPS + 1):
            t0 = time.perf_counter()
            seeds = rng.choice(d["n_nodes"], bn, replace=False)
            blocks = sample_blocks(csr, seeds, fanouts, rng)
            padded = [pad_block(b, e, n) for b, (e, n, _) in
                      zip(blocks, shapes)]
            host_ms.append((time.perf_counter() - t0) * 1000)
            ctx.sync()
            t0 = time.perf_counter()
            bl = [{k: torch.from_numpy(getattr(b, k)).to(ctx.dev)
                   for k in ("edge_src", "edge_dst", "edge_mask")}
                  for b in padded]
            nodes = torch.from_numpy(padded[-1].nodes).to(ctx.dev).long()
            lab = labels[torch.from_numpy(seeds).to(ctx.dev).long()]
            lv, grads = train.value_and_grad(
                lambda p: gnn.loss_blocks(cfg, p, feats[nodes], bl, lab,
                                          n_outs), params)
            opt.update(grads, state, params, i)
            ctx.sync()
            dev_ms.append((time.perf_counter() - t0) * 1000)
            losses.append(float(lv))
        mb = dict(nodes=d["n_nodes"], edges=d["n_edges"], batch_nodes=bn,
                  fanouts=fanouts, block_shapes=shapes, graph_host_s=gen_s,
                  csr_host_s=csr_s, sampler_host_ms=host_ms,
                  device_step_ms=dev_ms,
                  sampler_ms_median=float(np.median(host_ms[1:])),
                  device_ms_median=float(np.median(dev_ms[1:])),
                  losses=losses, peak_bytes=ctx.peak())
        mb["host_share"] = mb["sampler_ms_median"] / (
            mb["sampler_ms_median"] + mb["device_ms_median"])
        out["minibatch_lg"] = mb
        print(json.dumps({"gnn_minibatch_lg": mb}))
        if not np.isfinite(losses).all():
            raise AssertionError("the sampled GAT's losses are not finite")
        del csr, feats, labels, params, state

    with ctx.phase("gnn_molecule"):
        cfg = cfg_of("molecule")
        d = dims["molecule"]
        parts = [random_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                              cfg.n_classes, seed=100 + i)
                 for i in range(d["batch"])]
        off = np.arange(d["batch"]) * d["n_nodes"]
        g_np = {"feat": np.concatenate([g["feat"] for g in parts]),
                "label": np.concatenate([g["label"] for g in parts]),
                "edge_src": np.concatenate([g["edge_src"] + o for g, o in
                                            zip(parts, off)]),
                "edge_dst": np.concatenate([g["edge_dst"] + o for g, o in
                                            zip(parts, off)])}
        graph = graph_on(g_np, ctx.dev)
        params = gnn.init_params(cfg, seed=0, device=ctx.dev)
        losses, ms, _ = run_steps(functools.partial(gnn.loss_fn, cfg,
                                                    g=graph),
                                  params, GNN_STEPS + 1)
        out["molecule"] = dict(graphs=d["batch"], nodes=len(g_np["label"]),
                               edges=len(g_np["edge_src"]), losses=losses,
                               step_ms=ms,
                               step_ms_median=float(np.median(ms[1:])))
        print(json.dumps({"gnn_molecule": out["molecule"]}))
        if not np.isfinite(losses).all():
            raise AssertionError("the molecule GAT's losses are not finite")
    return out


def dryrun_phase(ctx, gat_forward):
    """The port's dry run on the card's machine: ``DRYRUN_CELLS`` on the
    single-pod mesh, one ``python -m repro_torch.launch.dryrun`` process
    a cell, all started together; each record must read ``status: ok``.
    Then the GAT forward that ``gnn_ogb_products`` ran at full scale,
    counted by ``launch.cost_analysis`` on ``meta`` tensors under a fake
    group of size 1, beside the measured ms and peak memory (printed,
    not gated)."""
    import functools
    import os
    import tempfile

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import cells, cost_analysis, dryrun
    from repro_torch.models import gnn

    with ctx.phase("dryrun"), tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        procs = []
        try:
            for arch, shape in DRYRUN_CELLS:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", "single",
                     "--out", tmp], env=env, cwd=str(ROOT),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            logs = [p.communicate(timeout=DRYRUN_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        recs = {}
        for (arch, shape), log in zip(DRYRUN_CELLS, logs):
            path = Path(tmp) / f"{arch}__{shape}__single.json"
            if not path.exists():
                raise AssertionError(f"dry run {arch}:{shape} wrote no "
                                     f"record: {log[-2000:]}")
            rec = json.loads(path.read_text())
            recs[f"{arch}:{shape}"] = {
                k: rec.get(k) for k in ("status", "error", "memory", "cost",
                                        "collectives", "compile_s",
                                        "model_flops_global", "note")}
            print(f"dry run {arch}:{shape}: {json.dumps(recs[f'{arch}:{shape}'])}")
        bad = [c for c, r in recs.items() if r["status"] != "ok"]
        if bad:
            raise AssertionError(f"dry-run cells failed: "
                                 f"{[(c, recs[c]['error']) for c in bad]}")

        cfg = dataclasses.replace(get_arch(GNN_ARCH).model,
                                  d_in=gat_forward["d_feat"])
        n, e = gat_forward["nodes"], gat_forward["edges"]
        with dryrun.fake_group(1), dryrun.quiet_dtensor():
            params = cells._abstract(functools.partial(gnn.init_params, cfg))
            graph = gnn.Graph(cells.meta((n, cfg.d_in)),
                              cells.meta((e,), torch.int32),
                              cells.meta((e,), torch.int32),
                              cells.meta((n,), torch.int32))
            logits, counter = cost_analysis.count(
                lambda p, g: gnn.forward(cfg, p, g), params, graph)
            mem = counter.memory([logits])
        counted = dict(flops=counter.flops, bytes=counter.bytes,
                       peak_bytes=mem["peak_gb"] * 1e9,
                       bytes_ms=counter.bytes / HBM_BYTES_PER_S * 1e3)
        vs = dict(measured_ms=gat_forward["forward_ms"],
                  measured_peak_bytes=gat_forward["peak_bytes"],
                  ms_over_counted_bytes_ms=gat_forward["forward_ms"]
                  / counted["bytes_ms"],
                  peak_over_counted_peak=gat_forward["peak_bytes"]
                  / counted["peak_bytes"])
        print(json.dumps({"dryrun_gat_forward": dict(counted=counted,
                                                     measured=vs)}))
    return recs


def fused_unstaged(queries, docs, ids2d, block_offsets, sizes, run_scores,
                   run_ids, *, k, list_pad, chunk, blk_l):
    """``ivf_scan_merge``'s kernel with no ring (stages 0: list rows and
    ids read from global memory), the path the wrapper takes only where
    ``cp.async.bulk`` cannot copy the rows; the wrapper has no switch."""
    import torch
    from repro_torch.kernels import _build

    b, d = queries.shape
    dev = queries.device
    out_s = torch.empty((b, chunk, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, chunk, k), dtype=torch.int32, device=dev)
    cnt = torch.empty((b, chunk), dtype=torch.int32, device=dev)
    _build.launch("ivf_scan_merge", dev,
                  *(x.data_ptr() for x in (queries, docs, ids2d,
                                           block_offsets, sizes, run_scores,
                                           run_ids)),
                  None, None, None, None, out_s.data_ptr(), out_i.data_ptr(),
                  cnt.data_ptr(), b, d, k, chunk, list_pad, blk_l, 0, 0, d)
    return out_s, out_i, cnt


def wide_rows(ctx, *, n_lists=WIDE_LISTS, n_queries=WIDE_QUERIES,
              lanes=SLOT_ROLL_LANES, reps=20):
    """The fused kernel at the ``nq-bulk`` cell's 4,096-d rows, where its
    ring holds slabs of a tile's rows (phases ``wide_*``).  The corpus is
    the cell's (``portbench/corpus.make`` from its configuration), its
    list count cut to ``n_lists`` and its mean list kept.

    ``wide_serve``: ``WaveScheduler`` at the cell's knobs (``lanes``
    lanes, chunk 8, k 100, N 80, patience 7/95) serves ``n_queries``
    queries, the launch counters zeroed just before: every wave one
    fused launch through the ring (``ivf_scan_merge`` launches ==
    ``ring_launches`` == waves), the answers and probes fused
    ``search``'s.  ``wide_vs_plain``: the first chunk of a wave (the
    first ``lanes`` queries' 8 nearest lists, an empty running top-k)
    through the wrapper, bit for bit the kernel's unstaged path, and
    against the plain version: scores within ATOL, near-tie id swaps
    only.  ``wide_timing``: the three by events (the wrapper by the
    profiler too) beside the bytes bound of the slots' live rows, as
    ``portbench/reference/counts.py`` counts a scan.  ``wide_integer``:
    the documents and queries overwritten with integers in [-2, 2], so
    every sum is exact: that chunk and the next one (the running top-k
    carried) bit for bit the plain version.  Returns the kernels line's
    row."""
    import numpy as np
    import torch
    from portbench import corpus as corpus_mod
    from repro_torch.core import policies, search
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.core.serving import WaveScheduler
    from repro_torch.kernels import _build
    from repro_torch.kernels import ivf_scan_merge as k_sm

    dev, sync = ctx.dev, ctx.sync
    cfg = json.loads(WIDE_CONFIG.read_text())
    d, k, chunk, pad, blk_l = (cfg[key] for key in ("dim", "k", "chunk",
                                                   "list_pad", "align"))
    with ctx.phase("wide_corpus"):
        cut = dict(cfg, n_lists=n_lists,
                   n_docs=round(cfg["n_docs"] * n_lists / cfg["n_lists"]))
        c = corpus_mod.make(cut, n_queries, WIDE_SEED, dev)
        index = IVFIndex(c.centroids, c.docs, c.doc_ids, c.offsets, c.sizes,
                         c.list_pad)
        layout = k_sm.ring_layout(d, k, chunk, pad, True,
                                  _build.max_shared_optin(dev))
        sync()
        print(f"wide corpus: {n_lists} lists of {cfg['name']}'s sizes "
              f"(mean {float(c.sizes.float().mean()):.2f}, max "
              f"{int(c.sizes.max())}), {c.docs.shape[0]} rows x {d} "
              f"({c.docs.numel() * 4 / 1e9:.3f} GB); the ring's layout "
              f"(stages, cols) {layout}")
        if not layout[0] or layout[1] >= d:
            raise AssertionError(f"the ring holds no slabs at d {d}: "
                                 f"{layout}")

    knobs = dict(wave_size=lanes, chunk=chunk, k=k, n_probe=cfg["n_probe"],
                 delta=cfg["patience_delta"], phi=cfg["patience_phi"])
    ws = WaveScheduler(index, **knobs)
    with ctx.phase("wide_serve"):
        ctx.reset()
        sync()
        t0 = time.perf_counter()
        rep = ws.serve(c.pool)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = ctx.read("wide serve (WaveScheduler, fused, 4,096-d rows)",
                          ["ivf_scan_merge", "ivf_scan_merge ring",
                           "row_topk", "slot_roll"],
                          absent=["ivf_scan_merge+delta", "delta_scan",
                                  "ivf_scan", "topk_merge"])
        if not (counts["ivf_scan_merge"] == counts["ivf_scan_merge ring"]
                == rep.ring_launches == rep.waves):
            raise AssertionError(
                f"{counts['ivf_scan_merge']} fused launches, "
                f"{rep.ring_launches} through the ring, in {rep.waves} "
                f"waves")
        ids = np.stack([rep.results[i] for i in range(n_queries)])
        probes = np.array([rep.probes[i] for i in range(n_queries)])
        pol = policies.patience(knobs["n_probe"], delta=knobs["delta"],
                                phi=knobs["phi"], k=k)
        res = search(index, c.pool, pol, use_fused_kernel=True, chunk=chunk)
        if not np.array_equal(res.topk_ids.cpu().numpy(), ids):
            raise AssertionError("wide serve's results != fused search")
        if not np.array_equal(res.probes.cpu().numpy(), probes):
            raise AssertionError("wide serve's probes != fused search")
        print(f"wide serve: {n_queries} queries in {rep.waves} waves, "
              f"{wall_ms:.3f} ms, mean probes {probes.mean():.2f}; "
              f"{counts['ivf_scan_merge']} fused launches, "
              f"{rep.ring_launches} through the ring; == fused search "
              f"(ids and probes)")
    del res, ws

    q = c.pool[:lanes].contiguous()
    near = torch.topk(q @ c.centroids.T, 2 * chunk, dim=1).indices
    ids2d = c.doc_ids.reshape(-1, blk_l)
    kw = dict(k=k, list_pad=pad, chunk=chunk, blk_l=blk_l)

    def slots(part):
        cids = near[:, part * chunk:(part + 1) * chunk]
        return ((c.offsets[cids] // blk_l).to(torch.int32).reshape(-1)
                .contiguous(), c.sizes[cids].reshape(-1).contiguous())

    boffs, sizes = slots(0)
    run_s = torch.full((lanes, k), float("-inf"), device=dev)
    run_i = torch.full((lanes, k), -1, dtype=torch.int32, device=dev)
    args = (q, c.docs, ids2d, boffs, sizes, run_s, run_i)
    what = "ivf_scan_merge (4,096-d rows)"
    with ctx.phase("wide_vs_plain"):
        ring0 = k_sm.ivf_scan_merge.ring_launches
        g = k_sm.ivf_scan_merge(*args, **kw)
        u = fused_unstaged(*args, **kw)
        sync()
        if k_sm.ivf_scan_merge.ring_launches != ring0 + 1:
            raise AssertionError(f"{what}: the wrapper's launch did not go "
                                 f"through the ring")
        if not all(torch.equal(x, y) for x, y in zip(g, u)):
            raise AssertionError(f"{what}: not bit-equal to its unstaged "
                                 f"path")
        w = k_sm.ivf_scan_merge_plain(*args, **kw)
        swaps, err = near_tie_swaps(g[0], g[1], w[0], w[1], what)
        if ((g[2] != w[2]) & ~(g[1] != w[1]).any(-1)).any():
            raise AssertionError(f"{what}: counts differ without an id swap")
        print(f"{what}: bit-equal to its unstaged path; against plain "
              f"max_abs_err {err}, near-tie id swaps {swaps}, count "
              f"mismatches {int((g[2] != w[2]).sum())}")
        del g, u, w

    with ctx.phase("wide_timing"):
        live = int(sizes.long().sum())
        bnd = bound(lanes * d * 4 + live * (4 * d + 4) + lanes * k * 8
                    + lanes * chunk * (k * 8 + 4 + 8), 2 * live * d)
        ms = ctx.time_call(what, lambda: k_sm.ivf_scan_merge(*args, **kw),
                           reps, profiled=True)
        unstaged_ms = ctx.time_call(f"{what}, unstaged",
                                    lambda: fused_unstaged(*args, **kw), reps)
        plain_ms = ctx.time_call(f"{what} plain",
                                 lambda: k_sm.ivf_scan_merge_plain(
                                     *args, **kw), 3)
        print(f"wide timing: {live} live rows over {lanes * chunk} slots "
              f"({lanes} lanes x chunk {chunk}); bound {bnd[0]:.6f} ms "
              f"({bnd[1]}); ring {layout} {ms:.6f} ms "
              f"({100 * bnd[0] / ms:.2f}% of the bound), unstaged "
              f"{unstaged_ms:.6f} ms ({100 * bnd[0] / unstaged_ms:.2f}%), "
              f"plain {plain_ms:.6f} ms")
        row = dict(name=what, counter="ivf_scan_merge", route="cuda",
                   source="src/repro_torch/csrc/ivf_scan_merge.cu",
                   replaces="src/repro/kernels/ivf_scan_merge.py:212",
                   launches=counts["ivf_scan_merge"], max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, bound=bnd, library_ms=None)

    with ctx.phase("wide_integer"):
        gen = torch.Generator(device=dev).manual_seed(WIDE_SEED + 1)
        for r0 in range(0, c.docs.shape[0], corpus_mod.FILL_ROWS):
            c.docs[r0:r0 + corpus_mod.FILL_ROWS].random_(-2, 3,
                                                         generator=gen)
        q.random_(-2, 3, generator=gen)
        for part in (0, 1):
            if part:
                boffs, sizes = slots(1)
                run_s = torch.where(g[0][:, -1] > k_sm.VALID_MIN,
                                    g[0][:, -1], float("-inf")).contiguous()
                run_i = g[1][:, -1].contiguous()
            args = (q, c.docs, ids2d, boffs, sizes, run_s, run_i)
            g = k_sm.ivf_scan_merge(*args, **kw)
            sync()
            w = k_sm.ivf_scan_merge_plain(*args, **kw)
            if not all(torch.equal(x, y) for x, y in zip(g, w)):
                raise AssertionError(f"{what}, integer inputs, chunk "
                                     f"{part}: not bit-equal to plain")
            print(f"{what}, integer inputs, chunk {part} "
                  f"({'carried' if part else 'empty'} running top-k): "
                  f"bit-equal to plain")
    return row


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a "
             f"checkout of the repository")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")

    from types import SimpleNamespace

    from repro_torch.configs import get_arch
    from repro_torch.core import (brute_force, build_index, metrics,
                                  policies, search)
    from repro_torch.core import serving
    from repro_torch.core.serving import WaveScheduler
    from repro_torch.data.synthetic import clustered_corpus, relevant_docs
    from repro_torch.index import (IndexRegistry, LiveIndex,
                                   assign_clusters, version_of)
    from repro_torch.kernels import _build
    from repro_torch.kernels import delta_scan as k_ds
    from repro_torch.kernels import embedding_bag as k_eb
    from repro_torch.kernels import flash_attention as k_fa
    from repro_torch.kernels import ivf_scan as k_scan
    from repro_torch.kernels import ivf_scan_merge as k_sm
    from repro_torch.kernels import row_topk as k_rt
    from repro_torch.kernels import slot_roll as k_sr
    from repro_torch.kernels import tau_stage as k_ts
    from repro_torch.kernels import topk_merge as k_tm
    from repro_torch.launch.serve import MutationStream

    dev = torch.device("cuda", 0)
    # each kernel's launch counter: (wrapper, attribute); the fused kernel
    # counts its launches with and without the delta stream apart
    counters = {"ivf_scan": (k_scan.ivf_scan, "launches"),
                "topk_merge": (k_tm.topk_merge, "launches"),
                "row_topk": (k_rt.row_topk, "launches"),
                "slot_roll": (k_sr.slot_roll, "launches"),
                "tau_stage": (k_ts.tau_stage, "launches"),
                "ivf_scan_merge": (k_sm.ivf_scan_merge, "launches"),
                "delta_scan": (k_ds.delta_scan, "launches"),
                "ivf_scan_merge+delta": (k_sm.ivf_scan_merge,
                                         "delta_launches"),
                # either of the two above whose rows came through the ring
                "ivf_scan_merge ring": (k_sm.ivf_scan_merge,
                                        "ring_launches"),
                "flash_attention": (k_fa.flash_attention, "launches"),
                "embedding_bag": (k_eb.embedding_bag, "launches")}

    def sync():
        torch.cuda.synchronize(dev)

    # each kernel's max |kernel - plain| at its main-path shapes
    max_err = {name: 0.0 for name in counters}
    # each path's launches: counters set to 0 just before its run and
    # read just after it
    launches = {}

    def reset_launches():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_launches(path, names, absent=()):
        """Launches since the last reset: each of ``names`` must have run,
        none of ``absent``.  A kernel's first path is its JSON row's."""
        counts = {name: getattr(fn, attr)
                  for name, (fn, attr) in counters.items()}
        print(f"launches on path {path}: {json.dumps(counts)}")
        for name in names:
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched on {path}")
            launches.setdefault(name, counts[name])
        for name in absent:
            if counts[name]:
                raise AssertionError(f"{name} ran on {path}")
        return counts

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_ms(prof):
        """Device time (ms) and count of each kernel or copy profiled."""
        return {ev.key: (ev.device_time_total / 1e3, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA}

    def time_call(name, fn, reps, profiled=False):
        """Median CUDA-event ms of one call, over ``reps`` calls after a
        warm-up.  Each call is queued behind a device-side sleep longer
        than the host takes to enqueue it, so the card never waits on
        the host between a call's two events.  With ``profiled`` (a
        kernel's own row and the launch floor) the profiler's (CUPTI)
        device time of the same calls is printed beside it; plain
        versions, library yardsticks and diagnostic lines are timed by
        events only, so the run keeps its profiler sessions few (a run
        that profiled every timed call once saw no device time in one of
        its last sessions).  A session that records no device time is
        run again, up to PROFILE_TRIES sessions: CUPTI now and then
        drops a session's device records (a whole run of this script
        lost the first session of ``timing``, its events' times and
        every check sound)."""
        for _ in range(3):
            fn()
        sync()
        events = []
        for _ in range(reps):
            torch.cuda._sleep(SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        sync()
        med = float(np.median([a.elapsed_time(b) for a, b in events]))
        if not profiled:
            print(f"  {name}: {med:.6f} ms median by events over {reps} "
                  f"calls")
            return med
        for tries in range(1, PROFILE_TRIES + 1):
            with profile(activities=activities) as prof:
                for _ in range(reps):
                    fn()
                sync()
            dev = sum(ms for ms, _ in device_ms(prof).values()) / reps
            if dev > 0:
                break
            print(f"  {name}: profiler session {tries} saw no device time")
        if dev <= 0:
            raise AssertionError(f"{name}: the profiler saw no device time "
                                 f"in {PROFILE_TRIES} sessions")
        print(f"  {name}: {med:.6f} ms median by events over {reps} calls, "
              f"{dev:.6f} ms device per call by the profiler")
        return med

    # what the model-zoo phases need of this run (see lm_serve)
    ctx = SimpleNamespace(
        dev=dev, sync=sync, phase=phase, max_err=max_err,
        counter_names=tuple(counters),
        reset=reset_launches, read=read_launches, time_call=time_call,
        reset_peak=lambda: torch.cuda.reset_peak_memory_stats(dev),
        peak=lambda: torch.cuda.max_memory_allocated(dev),
        profile=lambda what, fn: profile_run(sync, what, fn))

    # -- 1. device and build -------------------------------------------------
    with phase("device"):
        card = card_line()
        print(card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} "
              f"count {torch.cuda.device_count()}")
    with phase("build"):
        so = _build.build(verbose=True)
        print(f"built {so.relative_to(ROOT)}")
        _build.library()
        sass = sass_counts(so)
        print(f"SASS instructions: {json.dumps(sass)}")
        flash = sass.get("flash_attention_bf16", {})
        if not flash or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0
                            for c in flash.values()):
            raise AssertionError("a bf16 flash_attention kernel has no "
                                 "HGMMA or no UTMALDG")
        for fam in ("delta_scan", "ivf_scan_merge_kernel"):
            if not sass.get(fam) or any(c["HGMMA"] or c["HMMA"]
                                        for c in sass[fam].values()):
                raise AssertionError(f"{fam} is missing or has a "
                                     f"tensor-core instruction")
        # both staged instantiations (kStaged = true; kSlab = false, whole
        # rows, and true, slabs) stream list rows by cp.async.bulk
        for mode, tag in (("whole rows", "ILb1ELb0E"), ("slabs", "ILb1ELb1E")):
            staged = [c for n, c in sass["ivf_scan_merge_kernel"].items()
                      if tag in n]
            if not staged or not all(c["UBLKCP"] or c["LDGSTS"]
                                     for c in staged):
                raise AssertionError(f"the staged ivf_scan_merge_kernel "
                                     f"({mode}) is missing or has no async "
                                     f"copy (UBLKCP or LDGSTS)")

    # -- 2. each kernel against its plain version ----------------------------
    rng = np.random.default_rng(0)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def draw(integer, shape):
        if integer:
            return rng.integers(-2, 3, shape).astype(np.float32)
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def kernel_inputs(integer: bool, n_lists: int = 256, k: int = K,
                      chunk: int = CHUNK, d: int = D):
        def draw_(shape):
            return draw(integer, shape)
        docs = draw_((n_lists * LIST_PAD + LIST_PAD, d))
        # doc ids differ from row positions, so a kernel that wrote the
        # row instead of ids[row] would fail
        ids = rng.permutation(docs.shape[0]).astype(np.int32)
        ids[rng.random(ids.size) < 0.02] = -1          # tombstones
        ids[n_lists * LIST_PAD:] = -1
        q = draw_((B, d))
        offs = np.stack([rng.choice(n_lists, chunk, replace=False)
                         for _ in range(B)]) * LIST_PAD
        sizes = rng.integers(0, LIST_PAD + 1, (B, chunk))
        sizes[:, 0] = LIST_PAD
        run_s = -np.sort(-draw_((B, k)), axis=1)
        run_i = rng.integers(n_lists * LIST_PAD, 1 << 29, (B, k))
        n_empty = min(10, k - 1)
        run_s[:, k - n_empty:], run_i[:, k - n_empty:] = -np.inf, -1
        return [t(a) for a in (q, docs, ids.reshape(-1, BLK_L),
                               (offs // BLK_L).astype(np.int32).reshape(-1),
                               sizes.astype(np.int32).reshape(-1), run_s,
                               run_i.astype(np.int32))]

    def delta_inputs(integer: bool, boffs, n_lists: int = 256,
                     chunk: int = CHUNK, d: int = D):
        """A CAP-slot delta stream for kernel_inputs' probes: ids a random
        permutation past the doc ids, a fifth of the slots tombstoned
        (-1), the last tenth empty (id and assign -1), an eighth of the
        buffer assigned to one probed list, and gates of -2 past the
        budget on some slots."""
        cids = (boffs.view(B, chunk).long() * BLK_L // LIST_PAD).cpu().numpy()
        dvecs = draw(integer, (CAP, d))
        dids = (rng.permutation(CAP) + (n_lists + 1) * LIST_PAD
                ).astype(np.int32)
        dassign = rng.integers(0, n_lists, CAP).astype(np.int32)
        dassign[:CAP // 8] = cids[0, min(1, chunk - 1)]
        dids[rng.random(CAP) < 0.2] = -1
        dids[CAP - CAP // 10:], dassign[CAP - CAP // 10:] = -1, -1
        gates = cids.astype(np.int32)
        gates[1:9, 2:] = -2
        return dict(zip(("delta_vecs", "delta_ids", "delta_assign",
                         "gate_cids"),
                        (t(a) for a in (dvecs, dids, dassign,
                                        gates.reshape(-1)))))

    def check_fused(g, w, integer, what, name):
        """A fused launch against its plain version: bit-equal on integer
        inputs, else scores within ATOL with near-tie id swaps only."""
        if integer:
            if not all(torch.equal(x, y) for x, y in zip(g, w)):
                raise AssertionError(f"{what}: not bit-equal")
            print(f"{what}: bit-equal")
            return
        swaps, err = near_tie_swaps(g[0], g[1], w[0], w[1], what)
        rows_swapped = (g[1] != w[1]).any(-1)
        if ((g[2] != w[2]) & ~rows_swapped).any():
            raise AssertionError(f"{what}: counts differ without an id swap")
        max_err[name] = max(max_err[name], err)
        print(f"{what}: max_abs_err {err}, near-tie id swaps {swaps}, "
              f"count mismatches {int((g[2] != w[2]).sum())}")

    def fused_edges():
        """The fused kernel's edges in both modes, on integer inputs at
        the main path's widths (B 128, list_pad 256, cap 4,096; 64 lists):
        every live buffer entry gated on one slot, an all-inactive wave
        (sizes 0, gates -2), the running k-th tied by candidates, k 1 and
        1,024, chunk 1 and 8, d 100 and d 30 (rows read from global
        memory), d 4,096 at chunk 8 (the ring's slabs); bit-equal to the
        plain version."""
        for name, kw in (("all gated on one slot", {}), ("inactive", {}),
                         ("ties", {}), ("k=1", dict(k=1)),
                         ("k=1024", dict(k=1024)), ("chunk=1", dict(chunk=1)),
                         ("chunk=8", dict(chunk=8)), ("d=100", dict(d=100)),
                         ("d=30", dict(d=30)),
                         ("d=4096, chunk=8", dict(d=4096, chunk=8))):
            k, chunk = kw.get("k", K), kw.get("chunk", CHUNK)
            q, docs, ids2d, boffs, sizes, run_s, run_i = kernel_inputs(
                True, n_lists=64, **kw)
            dargs = delta_inputs(True, boffs, n_lists=64, chunk=chunk,
                                 d=kw.get("d", D))
            if name == "all gated on one slot":
                dargs["delta_ids"] = torch.arange(
                    CAP, dtype=torch.int32, device=dev) + 65 * LIST_PAD
                dargs["delta_assign"] = torch.full_like(
                    dargs["delta_assign"], int(dargs["gate_cids"][1]))
            if name == "inactive":
                sizes = torch.zeros_like(sizes)
                dargs["gate_cids"] = torch.full_like(dargs["gate_cids"], -2)
            if name == "ties":
                run_s = torch.zeros_like(run_s)
                run_i = t(np.stack([rng.choice(64 * LIST_PAD, k,
                                               replace=False)
                                    for _ in range(B)]).astype(np.int32))
            for stream in ({}, dargs):
                args = (q, docs, ids2d, boffs, sizes, run_s, run_i)
                kws = dict(k=k, list_pad=LIST_PAD, chunk=chunk, blk_l=BLK_L,
                           **stream)
                g = k_sm.ivf_scan_merge(*args, **kws)
                sync()
                w = k_sm.ivf_scan_merge_plain(*args, **kws)
                mode = "ivf_scan_merge+delta" if stream else "ivf_scan_merge"
                check_fused(g, w, True, f"{mode} edge ({name})", mode)

    with phase("kernels_vs_plain"):
        for label, integer in (("a", True), ("b", False)):
            q, docs, ids2d, boffs, sizes, run_s, run_i = \
                kernel_inputs(integer)
            # ivf_scan, slot 0 of every query
            got = k_scan.ivf_scan(q, docs, boffs[::CHUNK].contiguous(),
                                  list_pad=LIST_PAD, blk_l=BLK_L)
            sync()
            want = k_scan.ivf_scan_plain(q, docs, boffs[::CHUNK].contiguous(),
                                         list_pad=LIST_PAD, blk_l=BLK_L)
            err = finite_err(got, want)
            if integer and not torch.equal(got, want):
                raise AssertionError("ivf_scan (a): not bit-equal")
            if err > ATOL:
                raise AssertionError(f"ivf_scan ({label}): err {err}")
            max_err["ivf_scan"] = max(max_err["ivf_scan"], err)
            print(f"ivf_scan ({label}): max_abs_err {err}")
            # topk_merge: running top-k with a fresh strip of L scores
            new_s = got.clone()
            new_s[:, ::9] = float("-inf")
            new_i = ids2d.reshape(-1)[
                boffs[::CHUNK].long()[:, None] * BLK_L
                + torch.arange(LIST_PAD, device=dev)].contiguous()
            g = k_tm.topk_merge(run_s, run_i, new_s, new_i, K)
            sync()
            w = k_tm.topk_merge_plain(run_s, run_i, new_s, new_i, K)
            if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])):
                raise AssertionError(f"topk_merge ({label}): not bit-equal")
            print(f"topk_merge ({label}): bit-equal")
            # ivf_scan_merge over a chunk, from a non-empty running top-k
            g = k_sm.ivf_scan_merge(q, docs, ids2d, boffs, sizes, run_s,
                                    run_i, k=K, list_pad=LIST_PAD,
                                    chunk=CHUNK, blk_l=BLK_L)
            sync()
            w = k_sm.ivf_scan_merge_plain(q, docs, ids2d, boffs, sizes,
                                          run_s, run_i, k=K,
                                          list_pad=LIST_PAD, chunk=CHUNK,
                                          blk_l=BLK_L)
            check_fused(g, w, integer, f"ivf_scan_merge ({label})",
                        "ivf_scan_merge")
            # delta_scan: every query against a CAP-slot buffer
            dargs = delta_inputs(integer, boffs)
            got = k_ds.delta_scan(q, dargs["delta_vecs"])
            sync()
            want = k_ds.delta_scan_plain(q, dargs["delta_vecs"])
            err = finite_err(got, want)
            if integer and not torch.equal(got, want):
                raise AssertionError("delta_scan (a): not bit-equal")
            if err > ATOL:
                raise AssertionError(f"delta_scan ({label}): err {err}")
            max_err["delta_scan"] = max(max_err["delta_scan"], err)
            print(f"delta_scan ({label}): max_abs_err {err}")
            # ivf_scan_merge with the delta stream, same probes
            g = k_sm.ivf_scan_merge(q, docs, ids2d, boffs, sizes, run_s,
                                    run_i, k=K, list_pad=LIST_PAD,
                                    chunk=CHUNK, blk_l=BLK_L, **dargs)
            sync()
            w = k_sm.ivf_scan_merge_plain(q, docs, ids2d, boffs, sizes,
                                          run_s, run_i, k=K,
                                          list_pad=LIST_PAD, chunk=CHUNK,
                                          blk_l=BLK_L, **dargs)
            check_fused(g, w, integer, f"ivf_scan_merge+delta ({label})",
                        "ivf_scan_merge+delta")
        del q, docs, ids2d, got, want, g, w, dargs
        fused_edges()
        # row_topk: the benchmark cells' admission (512 queries, 65,536
        # centroids, N 80) and this script's (B queries, N_CLUSTERS, N
        # N_PROBE), on the sims of random unit vectors: bit for bit its
        # plain version and the stable sort
        for n_q, width, kk in ((512, 65_536, 80), (B, N_CLUSTERS, N_PROBE)):
            x = unit_sims(n_q, width, dev, seed=width)
            g = k_rt.row_topk(x, kk)
            sync()
            srt = torch.sort(x, dim=1, descending=True, stable=True)
            for label, w in (("plain", k_rt.row_topk_plain(x, kk)),
                             ("stable sort", (srt[0][:, :kk],
                                              srt[1][:, :kk].int()))):
                if not (torch.equal(g[0].view(torch.int32),
                                    w[0].view(torch.int32))
                        and torch.equal(g[1], w[1])):
                    raise AssertionError(f"row_topk ({n_q} x {width}, k "
                                         f"{kk}) != its {label}")
            print(f"row_topk ({n_q} x {width}, k {kk}): bit-equal to its "
                  f"plain version and the stable sort")
        model_zoo_kernels_vs_plain(ctx)

    # -- 3. the main path at the paper's widths -------------------------------
    with phase("corpus"):
        corpus = clustered_corpus(n_docs=N_DOCS, dim=D,
                                  n_components=N_CLUSTERS,
                                  n_queries=N_QUERIES, spread=SPREAD, seed=0)
        print(f"corpus {corpus.docs.shape} queries {corpus.queries.shape} "
              f"spread {SPREAD:.6f}")
    with phase("relevant_docs (host matmul, timed again on its own)"):
        if not np.array_equal(relevant_docs(corpus.queries, corpus.docs),
                              corpus.relevant):
            raise AssertionError("relevant_docs is not deterministic")

    with phase("build_index"):
        index = build_index(corpus.docs, N_CLUSTERS, list_pad=LIST_PAD,
                            n_iters=6, align=BLK_L)
        sync()
        sizes_np = index.cluster_sizes.cpu().numpy()
        print(f"clusters {index.n_clusters}, rows {index.docs.shape[0]}, "
              f"mean list {sizes_np.mean():.1f}, max list {sizes_np.max()}")

    queries = torch.from_numpy(corpus.queries).to(dev)
    with phase("brute_force"):
        docs_t = torch.from_numpy(corpus.docs).to(dev)
        ex_s, ex_i = zip(*(brute_force(docs_t, queries[s: s + B], K)
                           for s in range(0, N_QUERIES, B)))
        exact_s, exact_i = torch.cat(ex_s), torch.cat(ex_i)
        sync()
        exact = exact_i.cpu().numpy()

    pol = policies.patience(N_PROBE, delta=DELTA, phi=PHI, k=K, tau=TAU)
    ws = WaveScheduler(index, wave_size=B, chunk=CHUNK, k=K, n_probe=N_PROBE,
                       delta=DELTA, phi=PHI)
    reset_launches()
    with phase("serve"):
        torch.cuda.reset_peak_memory_stats(dev)
        # each admission ranks its queries' centroids by one row_topk
        admits = []
        admit = serving._admit

        def counted_admit(*args):
            admits.append(args[2].shape[0])
            return admit(*args)

        serving._admit = counted_admit
        try:
            sync()
            t0 = time.perf_counter()
            rep = ws.serve(queries)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1000
        finally:
            serving._admit = admit
        counts = read_launches("serve (WaveScheduler, fused)",
                               ["ivf_scan_merge", "row_topk", "slot_roll"],
                               absent=["ivf_scan_merge+delta", "delta_scan"])
        if counts["row_topk"] != len(admits):
            raise AssertionError(f"{counts['row_topk']} row_topk launches "
                                 f"for {len(admits)} admissions")
        if counts["slot_roll"] != rep.waves:
            raise AssertionError(f"{counts['slot_roll']} slot_roll launches "
                                 f"in {rep.waves} waves")
        print(f"serve: {len(admits)} admissions of {min(admits)} to "
              f"{max(admits)} queries, one row_topk launch each; "
              f"{rep.host_syncs} host reads in {rep.waves} waves "
              f"({rep.host_syncs / rep.waves:.4f} a wave)")
        # one read of active a harvest, one wait a harvest's exits
        if rep.host_syncs > 2 * rep.waves + 1:
            raise AssertionError(f"{rep.host_syncs} host reads in "
                                 f"{rep.waves} waves")
        served = np.stack([rep.results[i] for i in range(N_QUERIES)])
        probes = np.array([rep.probes[i] for i in range(N_QUERIES)])
        summ = metrics.summarize(served, probes, exact, corpus.relevant,
                                 wall_ms)
        summ.update(queries_per_s=N_QUERIES / (wall_ms / 1000),
                    occupancy=rep.occupancy, waves=rep.waves,
                    peak_device_mem_bytes=torch.cuda.max_memory_allocated(dev))
        print(json.dumps(summ))
        if not np.isfinite(summ["C"]) or summ["R*@1"] <= 0.0:
            raise AssertionError(f"implausible serve metrics {summ}")

    with phase("serve_vs_search"):
        res = search(index, queries, pol, use_fused_kernel=True, chunk=CHUNK)
        if not np.array_equal(res.topk_ids.cpu().numpy(), served):
            raise AssertionError("served results != fused search")
        if not np.array_equal(res.probes.cpu().numpy(), probes):
            raise AssertionError("served probes != fused search")
        print("served == search(fused) for every query (ids and probes)")

    with phase("fused_vs_pair"):
        q256 = queries[:256]
        fused = search(index, q256, pol, use_fused_kernel=True, chunk=CHUNK)
        reset_launches()
        pair = search(index, q256, pol, use_scan_kernel=True,
                      use_topk_kernel=True)
        sync()
        read_launches("search (per-probe kernel pair)",
                      ["ivf_scan", "topk_merge"])
        for name in ("topk_ids", "probes", "topk_scores"):
            if not torch.equal(getattr(fused, name), getattr(pair, name)):
                raise AssertionError(f"fused != per-probe pair on {name}")
        print(f"fused == per-probe kernel pair bit for bit on 256 queries "
              f"(C={fused.probes.float().mean().item():.4f})")

    with phase("full_probe_vs_brute_force"):
        full = search(index, queries[:32],
                      policies.fixed(index.n_clusters, k=K, tau=TAU),
                      use_fused_kernel=True, chunk=CHUNK)
        swaps, err = near_tie_swaps(full.topk_scores, full.topk_ids,
                                    exact_s[:32], exact_i[:32],
                                    "full-probe search vs brute force")
        print(f"full-probe search == brute force on 32 queries (max score "
              f"err {err}, near-tie id swaps {swaps})")

    # -- 3b. the learned exit stages ------------------------------------------
    learned_exit(ctx, index, corpus, queries, docs_t, exact)
    table2_smoke(ctx)

    # -- 4. the live index ----------------------------------------------------
    def fresh_live():
        """A LiveIndex over ``index`` after the pre-serve burst; returns it
        and the deleted ids."""
        lv = LiveIndex(index, delta_cap=CAP)
        return lv, pre_serve_burst(lv, corpus.docs)

    def live_serve(lv):
        """Serve every query against ``lv`` through a registry, with the
        mutation stream publishing after each wave; ``merge_delta``'s host
        ms (synchronised) are collected as it runs."""
        reg = IndexRegistry(version_of(lv))
        ws_l = WaveScheduler(index, wave_size=B, chunk=CHUNK, k=K,
                             n_probe=N_PROBE, delta=DELTA, phi=PHI,
                             registry=reg)
        mutate = MutationStream(lv, reg, corpus.docs, rate=MUTATION_RATE,
                                merge_every=MERGE_EVERY, noise=NOISE)
        stats = mutate.stats
        merge, merge_ms = lv.merge_delta, []

        def timed_merge():
            sync()
            t0 = time.perf_counter()
            v = merge()
            sync()
            merge_ms.append((time.perf_counter() - t0) * 1000)
            return v

        lv.merge_delta = timed_merge
        sync()
        t0 = time.perf_counter()
        rep_ = ws_l.serve(queries, on_wave=mutate)
        sync()
        wall = (time.perf_counter() - t0) * 1000
        del lv.merge_delta
        return rep_, reg, stats, wall, merge_ms

    with phase("live_setup"):
        live, gone = fresh_live()
        sync()
        print(f"live index: {live.n_live} live docs, {len(live.delta)} "
              f"buffered of {live.delta.capacity}, {live.tombs.count} "
              f"tombstones")

    reset_launches()
    with phase("live_serve"):
        rep_l, reg_l, stats, wall_l, merge_ms = live_serve(live)
        counts = read_launches("live serve (WaveScheduler, fused, registry)",
                               ["ivf_scan_merge+delta"],
                               absent=["ivf_scan_merge", "delta_scan",
                                       "ivf_scan", "topk_merge"])
        if counts["ivf_scan_merge+delta"] != rep_l.waves \
                or counts["slot_roll"] != rep_l.waves:
            raise AssertionError("the live serve did not launch the fused "
                                 "kernel with the stream and slot_roll "
                                 "once per wave")
        if sorted(rep_l.results) != list(range(N_QUERIES)):
            raise AssertionError("the live serve did not answer every "
                                 "query once")
        served_l = np.stack([rep_l.results[i] for i in range(N_QUERIES)])
        probes_l = np.array([rep_l.probes[i] for i in range(N_QUERIES)])
        for row in served_l:
            real = row[row >= 0]
            if len(np.unique(real)) != len(real):
                raise AssertionError("a live result holds a duplicate id")
        if np.isin(served_l, gone).any():
            raise AssertionError("a live result holds an id deleted before "
                                 "serving began")
        r_static = metrics.r_star_at_k(served, exact)
        r_live = metrics.r_star_at_k(served_l, exact)
        live_summ = dict(
            **stats, versions=live.version, swaps=reg_l.swaps,
            waves=rep_l.waves, delta_occupancy=live.delta.occupancy(),
            recall_static=r_static, recall_live=r_live,
            recall_gap=abs(r_static - r_live), wall_ms=wall_l,
            queries_per_s=N_QUERIES / (wall_l / 1000),
            C=float(probes_l.mean()), merge_delta_host_ms=merge_ms)
        print(json.dumps(live_summ))
        if live_summ["recall_gap"] > RECALL_GAP_MAX or not stats["merges"]:
            raise AssertionError(f"live serve off: {live_summ}")

    q256 = queries[:256]
    with phase("live_vs_rebuilt"):
        reset_launches()
        fused_l = live.search(q256, pol, use_fused_kernel=True, chunk=CHUNK)
        sync()
        read_launches("live search (fused)", ["ivf_scan_merge+delta"],
                      absent=["ivf_scan_merge", "delta_scan", "ivf_scan",
                              "topk_merge"])
        rebuilt = live.rebuild_equivalent()
        res_rb = search(rebuilt, q256, pol, use_fused_kernel=True,
                        chunk=CHUNK)
        for name in ("topk_ids", "probes", "topk_scores"):
            if not torch.equal(getattr(fused_l, name), getattr(res_rb, name)):
                raise AssertionError(f"live fused != rebuilt index on {name}")
        print(f"live fused search == fused search over rebuild_equivalent() "
              f"bit for bit on 256 queries (list_pad {rebuilt.list_pad}, "
              f"C={fused_l.probes.float().mean().item():.4f})")
        del rebuilt, res_rb

    with phase("live_fused_vs_pair"):
        reset_launches()
        pair_l = live.search(q256, pol, use_scan_kernel=True,
                             use_topk_kernel=True)
        sync()
        counts = read_launches("live search (per-probe kernel pair)",
                               ["ivf_scan", "delta_scan", "topk_merge"],
                               absent=["ivf_scan_merge",
                                       "ivf_scan_merge+delta"])
        live_pair_launches = counts["topk_merge"]
        if counts["delta_scan"] != 1:
            raise AssertionError("the pair search scanned the buffer "
                                 f"{counts['delta_scan']} times, not once")
        for name in ("topk_ids", "probes", "topk_scores"):
            if not torch.equal(getattr(fused_l, name), getattr(pair_l, name)):
                raise AssertionError(f"live fused != live per-probe pair on "
                                     f"{name}")
        print("live fused == live per-probe kernel pair bit for bit on 256 "
              "queries")

    with phase("live_full_probe_vs_brute_force"):
        vecs_n, ids_n = live.net_corpus()
        full = live.search(queries[:32],
                           policies.fixed(index.n_clusters, k=K, tau=TAU),
                           use_fused_kernel=True, chunk=CHUNK)
        bs, brows = brute_force(vecs_n, queries[:32], K)
        bids = torch.as_tensor(ids_n, device=dev)[brows.long()]
        swaps, err = near_tie_swaps(full.topk_scores, full.topk_ids, bs,
                                    bids, "live full probe vs brute force")
        print(f"live full-probe search == brute force over the net corpus "
              f"({len(ids_n)} docs) on 32 queries (max score err {err}, "
              f"near-tie id swaps {swaps})")
        del vecs_n, bs, brows, bids

    # -- 5. the model zoo: StarCoder2-3B and DeepFM serving -----------------
    lm_serve(ctx, get_arch(LM_ARCH).model)
    zoo = {}
    for name, arch, cuts in LM_ZOO:
        cfg = dataclasses.replace(get_arch(arch).model, **cuts)
        zoo[name] = lm_serve(ctx, cfg, name=name)
        # free each model before the next one starts
        torch.cuda.empty_cache()
        print(f"after {name}: {torch.cuda.memory_allocated(dev)} bytes "
              f"allocated on the card")
    print(json.dumps({"lm_zoo": zoo}))
    rs_params, rs_rows = recsys_serve(ctx, get_arch(RS_ARCH).model)

    # -- 5b. training: StarCoder2-3B, the restart drill, DeepFM, the
    # retriever's life cycle ----------------------------------------------
    lm_cfg = get_arch(LM_ARCH).model
    lm_tr, flash_train = lm_train(ctx, lm_cfg)
    torch.cuda.empty_cache()
    train_restart(ctx, dataclasses.replace(lm_cfg, n_layers=RESTART_LAYERS))
    torch.cuda.empty_cache()
    rs_tr, bag_train = recsys_train(ctx, get_arch(RS_ARCH).model)
    torch.cuda.empty_cache()
    retriever = retriever_lifecycle(ctx)
    torch.cuda.empty_cache()
    # MLA and MoE training, each at its own depth cut (module constants)
    mla_tr, flash_mla_train = lm_train(
        ctx, dataclasses.replace(get_arch("minicpm3-4b").model,
                                 n_layers=MLA_TRAIN_LAYERS),
        name="minicpm3_train")
    torch.cuda.empty_cache()
    moe_tr, _ = lm_train(
        ctx, dataclasses.replace(get_arch("deepseek-moe-16b").model,
                                 n_layers=MOE_TRAIN_LAYERS),
        name="deepseek_moe_train", timing_row=False)
    torch.cuda.empty_cache()
    print(json.dumps({"training": dict(lm=lm_tr, recsys=rs_tr,
                                       retriever=retriever, minicpm3=mla_tr,
                                       deepseek_moe=moe_tr)}))

    # -- 5c. the GNN at GNN_SHAPES, then the port's dry run ------------------
    gat = gnn_phases(ctx)
    torch.cuda.empty_cache()
    dryrun_phase(ctx, gat["ogb_products_forward"])

    # -- 6. timing ------------------------------------------------------------
    rows = []
    with phase("timing"):
        # main-path inputs: the first wave's queries, their first CHUNK
        # probes, and the running top-k after probe 0
        qb = queries[:B]
        rank, sz, boffs, ids2d, empty_s, empty_i = first_chunk(index, qb)
        cids = rank[:, :CHUNK]
        szf = sz.reshape(-1).contiguous()
        s0, i0, _ = k_sm.ivf_scan_merge(qb, index.docs, ids2d, boffs, szf,
                                        empty_s, empty_i, k=K,
                                        list_pad=LIST_PAD, chunk=CHUNK,
                                        blk_l=BLK_L)
        run_s, run_i = s0[:, 0].contiguous(), i0[:, 0].contiguous()
        bo1 = boffs.view(B, CHUNK)[:, 1].contiguous()
        rows1 = bo1.long()[:, None] * BLK_L \
            + torch.arange(LIST_PAD, device=dev)
        new_s = k_scan.ivf_scan(qb, index.docs, bo1, list_pad=LIST_PAD,
                                blk_l=BLK_L)
        # the strip as core.ivf's _probe_rows gives it to the pair search:
        # id -1 past the list's size, -inf wherever the id is -1
        live = torch.arange(LIST_PAD, device=dev)[None] < sz[:, 1:2]
        new_i = torch.where(live, index.doc_ids[rows1], -1).contiguous()
        new_s = torch.where(new_i >= 0, new_s, float("-inf")).contiguous()

        def unique_live_rows(c):
            u = torch.unique(c)
            return int(index.cluster_sizes[u].sum())

        # ivf_scan: probe slot 1 of every query.  The function scores all
        # list_pad rows of each tile it is given (rows past the size too),
        # so its bound reads each unique tile's list_pad rows once and
        # does B * list_pad dot products
        live1 = unique_live_rows(cids[:, 1])
        tiles1 = int(torch.unique(cids[:, 1]).numel())
        old_bnd = bound(B * D * 4 + live1 * D * 4 + B * LIST_PAD * 4 + B * 4,
                        2 * live1 * D)
        bnd = bound(B * D * 4 + tiles1 * LIST_PAD * D * 4
                    + B * LIST_PAD * 4 + B * 4, 2 * B * LIST_PAD * D)
        print(f"ivf_scan bound: {bnd[0]:.6f} ms ({bnd[1]}; {tiles1} unique "
              f"tiles of {LIST_PAD} rows); PR 15's reckoning of live rows "
              f"only {old_bnd[0]:.6f} ms ({old_bnd[1]})")
        rows.append(dict(
            name="ivf_scan", route="cuda",
            source="src/repro_torch/csrc/ivf_scan.cu",
            replaces="src/repro/kernels/ivf_scan.py:28",
            ms=time_call("ivf_scan", lambda: k_scan.ivf_scan(
                qb, index.docs, bo1, list_pad=LIST_PAD, blk_l=BLK_L), 50,
                profiled=True),
            plain_ms=time_call("ivf_scan plain", lambda: k_scan.ivf_scan_plain(
                qb, index.docs, bo1, list_pad=LIST_PAD, blk_l=BLK_L), 20),
            bound=bnd,
            library_ms=time_call("gather + torch.bmm", lambda: torch.bmm(
                index.docs[rows1], qb[:, :, None]), 20)))

        def topk_merge_row(name, rs, ri, ns, ni, n_launches):
            """topk_merge on one running top-k and strip: bit-equal to its
            plain version first, then timed beside it and ``torch.topk``;
            the bound reads both once and writes the top-k once."""
            g = k_tm.topk_merge(rs, ri, ns, ni, K)
            sync()
            w = k_tm.topk_merge_plain(rs, ri, ns, ni, K)
            if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])):
                raise AssertionError(f"{name}: not bit-equal")
            # the columns a filter by the running k-th record keeps: score
            # above it, or equal with a higher id (-inf is the sentinel)
            def sentinel(x):
                return torch.where(torch.isfinite(x), x, -1e30)

            ks, ki = sentinel(rs[:, K - 1:K]), ri[:, K - 1:K]
            above = (sentinel(ns) > ks) | ((sentinel(ns) == ks) & (ni > ki))
            print(f"{name}: k0={rs.shape[1]}, L={ns.shape[1]}; columns above "
                  f"the running k-th record a row: mean "
                  f"{float(above.sum(1).float().mean()):.2f}, max "
                  f"{int(above.sum(1).max())}, finite "
                  f"{float(torch.isfinite(ns).sum(1).float().mean()):.2f}; "
                  f"bit-equal to its plain version")
            cat = torch.cat([rs, ns], 1)
            return dict(
                name=name, counter="topk_merge", route="cuda",
                source="src/repro_torch/csrc/topk_merge.cu",
                replaces="src/repro/kernels/topk_merge.py:42",
                launches=n_launches, max_abs_err=0.0,
                ms=time_call(name, lambda: k_tm.topk_merge(rs, ri, ns, ni, K),
                             50, profiled=True),
                plain_ms=time_call(f"{name} plain",
                                   lambda: k_tm.topk_merge_plain(
                                       rs, ri, ns, ni, K), 20),
                bound=bound(B * (K + ns.shape[1]) * 8 + B * K * 8, 0),
                library_ms=time_call(f"{name}: torch.topk",
                                     lambda: torch.topk(cat, K, dim=1), 20))

        # a late probe: the running top-k after LATE_PROBE probes (one
        # fused launch over them from empty) and probe LATE_PROBE's strip,
        # where few candidates beat a full running top-k
        cids_l = rank[:, :LATE_PROBE + 1]
        sl, il, _ = k_sm.ivf_scan_merge(
            qb, index.docs, ids2d,
            (index.cluster_offsets[cids_l[:, :LATE_PROBE]] // BLK_L)
            .reshape(-1).contiguous(),
            index.cluster_sizes[cids_l[:, :LATE_PROBE]].reshape(-1)
            .contiguous(), empty_s, empty_i, k=K, list_pad=LIST_PAD,
            chunk=LATE_PROBE, blk_l=BLK_L)
        run_s_late = sl[:, -1].contiguous()
        run_i_late = il[:, -1].contiguous()
        bo_l = (index.cluster_offsets[cids_l[:, -1]] // BLK_L).contiguous()
        live_l = torch.arange(LIST_PAD, device=dev)[None] \
            < index.cluster_sizes[cids_l[:, -1]][:, None]
        new_i_late = torch.where(live_l, index.doc_ids[
            bo_l.long()[:, None] * BLK_L
            + torch.arange(LIST_PAD, device=dev)], -1).contiguous()
        new_s_late = torch.where(
            new_i_late >= 0,
            k_scan.ivf_scan(qb, index.docs, bo_l, list_pad=LIST_PAD,
                            blk_l=BLK_L), float("-inf")).contiguous()

        # topk_merge: running top-k after probe 0 with probe 1's strip
        rows.append(topk_merge_row("topk_merge", run_s, run_i, new_s, new_i,
                                   launches["topk_merge"]))
        floor_ms = time_call("launch floor (an empty kernel)",
                             lambda: _build.launch("launch_floor", dev), 50,
                             profiled=True)
        print(f"timing: launch floor {floor_ms:.6f} ms beside topk_merge's "
              f"bound {rows[1]['bound'][0]:.6f} ms and its time "
              f"{rows[1]['ms']:.6f} ms")
        rows.append(topk_merge_row(
            "topk_merge (late probe)", run_s_late, run_i_late, new_s_late,
            new_i_late, launches["topk_merge"]))
        # ivf_scan_merge: the first wave's first chunk
        live_c = unique_live_rows(cids)
        bnd = bound(B * D * 4 + live_c * (D * 4 + 4) + B * K * 8
                    + B * CHUNK * (K * 8 + 4 + 8), 2 * live_c * D)
        rows.append(dict(
            name="ivf_scan_merge", route="cuda",
            source="src/repro_torch/csrc/ivf_scan_merge.cu",
            replaces="src/repro/kernels/ivf_scan_merge.py:212",
            ms=time_call("ivf_scan_merge", lambda: k_sm.ivf_scan_merge(
                qb, index.docs, ids2d, boffs, szf, empty_s, empty_i, k=K,
                list_pad=LIST_PAD, chunk=CHUNK, blk_l=BLK_L), 50,
                profiled=True),
            plain_ms=time_call(
                "ivf_scan_merge plain", lambda: k_sm.ivf_scan_merge_plain(
                    qb, index.docs, ids2d, boffs, szf, empty_s, empty_i,
                    k=K, list_pad=LIST_PAD, chunk=CHUNK, blk_l=BLK_L), 10),
            bound=bnd, library_ms=None))
        fused_ms = rows[-1]["ms"]
        print(f"timing inputs: ivf_scan {live1} live rows of "
              f"{B * LIST_PAD} tile rows; ivf_scan_merge {live_c} unique "
              f"live rows, {int(szf.sum())} live rows summed over the "
              f"{B * CHUNK} slots (each query reads its own), of "
              f"{B * CHUNK * LIST_PAD}")
        # one CTA walks one query's chunk: the query with the most rows,
        # alone, against the whole wave
        per_q = sz.sum(1)
        top = int(torch.argmax(per_q))
        ms_top = time_call(
            "ivf_scan_merge, the query with the most rows alone",
            lambda: k_sm.ivf_scan_merge(
                qb[top:top + 1], index.docs, ids2d,
                boffs.view(B, CHUNK)[top].contiguous(),
                szf.view(B, CHUNK)[top].contiguous(), empty_s[:1],
                empty_i[:1], k=K, list_pad=LIST_PAD, chunk=CHUNK,
                blk_l=BLK_L), 50)
        print(f"ivf_scan_merge rows per query: mean "
              f"{float(per_q.float().mean()):.1f}, median "
              f"{float(per_q.float().median()):.1f}, max {int(per_q.max())}; "
              f"the query with the most rows alone {ms_top:.6f} ms, the "
              f"wave {fused_ms:.6f} ms")
        stages = k_sm.ring_stages(D, K, CHUNK, LIST_PAD, True,
                                  _build.max_shared_optin(dev))
        smem = k_sm.smem_bytes(D, K, CHUNK, LIST_PAD, stages)
        print(f"ivf_scan_merge shared memory: {smem} bytes dynamic "
              f"({stages} ring stages of {k_sm.TILE_ROWS} rows) with and "
              f"without the stream, at any cap")
        # the delta buffer as the live serve holds it: CAP slots, the
        # first half live (noisy copies of corpus docs, assigned to their
        # nearest centroid), the rest empty (zeros, id and assign -1)
        r = np.random.default_rng(3)
        n_buf = CAP // 2
        bvecs = torch.zeros((CAP, D), device=dev)
        bvecs[:n_buf] = torch.from_numpy((
            corpus.docs[r.integers(0, N_DOCS, n_buf)]
            + r.normal(scale=NOISE, size=(n_buf, D))).astype(np.float32)
        ).to(dev)
        bids = torch.full((CAP,), -1, dtype=torch.int32, device=dev)
        bids[:n_buf] = torch.arange(N_DOCS, N_DOCS + n_buf, device=dev,
                                    dtype=torch.int32)
        bassign = torch.full((CAP,), -1, dtype=torch.int32, device=dev)
        bassign[:n_buf] = assign_clusters(bvecs[:n_buf], index.centroids)
        stream = dict(delta_vecs=bvecs, delta_ids=bids,
                      delta_assign=bassign,
                      gate_cids=cids.to(torch.int32).reshape(-1).contiguous())
        # delta_scan: the first wave's queries against the whole buffer
        bnd = bound((B * D + CAP * D + B * CAP) * 4, 2 * B * CAP * D)
        rows.append(dict(
            name="delta_scan", route="cuda",
            source="src/repro_torch/csrc/delta_scan.cu",
            replaces="src/repro/kernels/delta_scan.py:31",
            ms=time_call("delta_scan", lambda: k_ds.delta_scan(qb, bvecs),
                         50, profiled=True),
            plain_ms=time_call("delta_scan plain",
                               lambda: k_ds.delta_scan_plain(qb, bvecs), 10),
            bound=bnd,
            library_ms=time_call("torch.matmul (no TF32)",
                                 lambda: torch.matmul(qb, bvecs.T), 50)))
        # ivf_scan_merge+delta: the same tiles as ivf_scan_merge, plus the
        # stream.  Its output depends on the buffer's ids and assigns (cap
        # x 8 bytes) and on the gated entries only: their rows are read
        # once, and each is scored by each slot that gates it
        gated = int(sum(((bassign[None, :] == cids[:, j:j + 1]).sum()
                         for j in range(CHUNK))))
        gated_rows = int(torch.isin(bassign, cids).sum())
        base_bytes = B * D * 4 + live_c * (D * 4 + 4) + B * K * 8 \
            + B * CHUNK * (K * 8 + 4 + 8) + CAP * 8 + B * CHUNK * 4
        old_bnd = bound(base_bytes + n_buf * D * 4,
                        2 * live_c * D + 2 * B * n_buf * D)
        bnd = bound(base_bytes + gated_rows * D * 4,
                    2 * live_c * D + 2 * gated * D)
        print(f"ivf_scan_merge+delta bound: {bnd[0]:.6f} ms ({bnd[1]}; "
              f"{gated_rows} gated buffer rows); PR 15's reckoning of every "
              f"live buffer row per query {old_bnd[0]:.6f} ms "
              f"({old_bnd[1]})")
        rows.append(dict(
            name="ivf_scan_merge+delta", route="cuda",
            source="src/repro_torch/csrc/ivf_scan_merge.cu",
            replaces="src/repro/kernels/ivf_scan_merge.py:109",
            ms=time_call("ivf_scan_merge+delta",
                         lambda: k_sm.ivf_scan_merge(
                             qb, index.docs, ids2d, boffs, szf, empty_s,
                             empty_i, k=K, list_pad=LIST_PAD, chunk=CHUNK,
                             blk_l=BLK_L, **stream), 50, profiled=True),
            plain_ms=time_call(
                "ivf_scan_merge+delta plain",
                lambda: k_sm.ivf_scan_merge_plain(
                    qb, index.docs, ids2d, boffs, szf, empty_s, empty_i,
                    k=K, list_pad=LIST_PAD, chunk=CHUNK, blk_l=BLK_L,
                    **stream), 10),
            bound=bnd, library_ms=None))
        print(f"timing inputs: delta buffer {n_buf} live slots of {CAP}; "
              f"ivf_scan_merge+delta gates {gated} buffer entries over "
              f"{B * CHUNK} slots; without the stream on the same tiles "
              f"{fused_ms:.6f} ms")
        # the stream's fixed cost: the same launch with every gate at -2
        # (the buffer's assigns are read, nothing is gated)
        no_gate = dict(stream, gate_cids=torch.full_like(
            stream["gate_cids"], -2))
        ms_no_gate = time_call(
            "ivf_scan_merge+delta, every gate -2",
            lambda: k_sm.ivf_scan_merge(
                qb, index.docs, ids2d, boffs, szf, empty_s, empty_i, k=K,
                list_pad=LIST_PAD, chunk=CHUNK, blk_l=BLK_L, **no_gate), 50)
        print(f"timing: ivf_scan_merge+delta with every gate at -2 "
              f"{ms_no_gate:.6f} ms; without the stream "
              f"{fused_ms:.6f} ms; with the stream "
              f"{rows[-1]['ms']:.6f} ms")
        # topk_merge at the live per-probe pair's width: probe slot 1's
        # strip and the buffer's CAP columns, gated as core.ivf's
        # delta_candidates gates them (entries assigned to the probed
        # cluster keep their scores, the rest are -inf with id -1)
        gate = (bids >= 0)[None, :] & (bassign[None, :] == cids[:, 1:2])
        wide_s = torch.cat([new_s, torch.where(
            gate, k_ds.delta_scan(qb, bvecs), float("-inf"))], 1).contiguous()
        wide_i = torch.cat([new_i, torch.where(
            gate, bids[None, :].expand(B, -1), -1)], 1).contiguous()
        rows.append(topk_merge_row(
            "topk_merge (live pair width)", run_s, run_i, wide_s, wide_i,
            live_pair_launches))
        # row_topk at a merge's width (k + list_pad, the plain per-probe
        # merge's), the benchmark cells' admission and a brute_force width
        # of the tests (tests/test_torch_distributed_ivf.py's 8,000 docs)
        for name, n_q, width, kk in (
                ("row_topk (merge width)", B, K + LIST_PAD, K),
                ("row_topk", 512, 65_536, 80),
                ("row_topk (brute_force width)", B, 8_000, 10)):
            x = unit_sims(n_q, width, dev, seed=width + 1)
            g = k_rt.row_topk(x, kk)
            sync()
            w = k_rt.row_topk_plain(x, kk)
            if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])):
                raise AssertionError(f"{name}: not bit-equal")
            rows.append(dict(
                name=name, counter="row_topk", route="cuda",
                source="src/repro_torch/csrc/row_topk.cu",
                replaces="none: core/ivf.py:top_k's stable sort "
                         "(lax.top_k in the reference)",
                max_abs_err=0.0,
                ms=time_call(name, lambda: k_rt.row_topk(x, kk), 50,
                             profiled=True),
                plain_ms=time_call(f"{name} plain",
                                   lambda: k_rt.row_topk_plain(x, kk), 20),
                bound=bound(n_q * width * 4 + n_q * kk * 8, 0),
                library_ms=time_call(f"{name}: torch.topk",
                                     lambda: torch.topk(x, kk, dim=1), 20)))
        # slot_roll at the benchmark cells' wave: 1,024 lanes, chunk 8,
        # msmarco's k 100 and deep10m's k 10
        for kk in (100, 10):
            name = f"slot_roll (k {kk})"
            args = slot_roll_inputs(SLOT_ROLL_LANES, SLOT_ROLL_CHUNK, kk,
                                    dev, seed=kk)
            kw = dict(k=kk, chunk=SLOT_ROLL_CHUNK, phi=PHI)
            g = k_sr.slot_roll(*args, **kw)
            sync()
            w = k_sr.slot_roll_plain(*args, **kw)
            if not all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                       for x, y in zip(g, w)):
                raise AssertionError(f"{name}: not bit-equal")
            walls = {}
            for label, fn in (("kernel", k_sr.slot_roll),
                              ("chain", k_sr.slot_roll_plain)):
                roll_ms = []
                for _ in range(50):
                    sync()
                    t0 = time.perf_counter()
                    fn(*args, **kw)
                    sync()
                    roll_ms.append((time.perf_counter() - t0) * 1e3)
                walls[label] = float(np.median(roll_ms))
            print(f"{name}: host clock around a synchronised call, median "
                  f"of 50: kernel {walls['kernel']:.6f} ms, chain of "
                  f"PyTorch ops {walls['chain']:.6f} ms")
            rows.append(dict(
                name=name, counter="slot_roll", route="cuda",
                source="src/repro_torch/csrc/slot_roll.cu",
                replaces="none: core/serving.py:_advance's chain of "
                         "PyTorch ops (jnp ops in the reference)",
                max_abs_err=0.0,
                ms=time_call(name, lambda: k_sr.slot_roll(*args, **kw), 50,
                             profiled=True),
                plain_ms=time_call(f"{name} plain", lambda: (
                    k_sr.slot_roll_plain(*args, **kw)), 20),
                bound=bound(SLOT_ROLL_LANES * (SLOT_ROLL_CHUNK * 4 + 26
                                               + kk * 16), 0),
                library_ms=None))
        # tau_stage at the star-cascade cell's wave: 1,024 lanes, chunk
        # 8, k 100, d 768, tau 10, 100 trees of depth 6; for the check
        # each side counts its exits into a clone of clf_exits, the timed
        # calls count theirs into the one tensor
        name = "tau_stage"
        lanes, clf, kw, st_bytes, at_tau = tau_stage_inputs(
            SLOT_ROLL_LANES, SLOT_ROLL_CHUNK, K, D, TAU, TAU_STAGE_TREES,
            TAU_STAGE_DEPTH, dev, seed=36)

        def stage_run(fn):
            return fn(*lanes, clf, **kw)

        g, w = (fn(*(x.clone() for x in lanes), clf, **kw)
                for fn in (k_ts.tau_stage, k_ts.tau_stage_plain))
        sync()
        if not all(torch.equal(x.reshape(-1).view(torch.uint8),
                               y.reshape(-1).view(torch.uint8))
                   for x, y in zip(g, w)):
            raise AssertionError(f"{name}: not bit-equal")
        exits = int(w.clf_exits) - int(lanes[10])
        if not 0 < exits < at_tau:
            raise AssertionError(f"{name}: {exits} exits of {at_tau} lanes "
                                 f"at tau")
        walls = {}
        for label, fn in (("kernel", k_ts.tau_stage),
                          ("chain", k_ts.tau_stage_plain)):
            stage_ms = []
            for _ in range(50):
                sync()
                t0 = time.perf_counter()
                stage_run(fn)
                sync()
                stage_ms.append((time.perf_counter() - t0) * 1e3)
            walls[label] = float(np.median(stage_ms))
        print(f"{name}: bit-equal, {exits} exits of {at_tau} lanes at tau; "
              f"host clock around a synchronised call, median of 50: "
              f"kernel {walls['kernel']:.6f} ms, chain of PyTorch ops "
              f"{walls['chain']:.6f} ms")
        rows.append(dict(
            name=name, counter="tau_stage", route="cuda",
            source="src/repro_torch/csrc/tau_stage.cu",
            replaces="none: core/serving.py:_tau_stage's chain of PyTorch "
                     "ops (jnp ops in the reference)",
            max_abs_err=0.0,
            ms=time_call(name, lambda: stage_run(k_ts.tau_stage), 50,
                         profiled=True),
            plain_ms=time_call(f"{name} plain", lambda: stage_run(
                k_ts.tau_stage_plain), 20),
            bound=bound(st_bytes, 0), library_ms=None))
        rows += model_zoo_timing(ctx, get_arch(LM_ARCH).model,
                                 rs_params["table"],
                                 rs_params["linear_table"], rs_rows)
        rows.append(mla_flash_row(
            ctx, get_arch("minicpm3-4b").model,
            zoo["minicpm3"]["flash_attention_launches"]))
        # the training paths' rows, timed in their phases
        rows += [flash_train, bag_train, flash_mla_train]

    # -- 6, at the nq-bulk cell's 4,096-d rows (the ring's slabs) ---------
    rows.append(wide_rows(ctx))
    torch.cuda.empty_cache()

    with phase("serve_profile"):
        with profile(activities=activities) as prof:
            sync()
            t0 = time.perf_counter()
            rep2 = ws.serve(queries)
            sync()
            prof_wall = (time.perf_counter() - t0) * 1000
        if rep2.results.keys() != rep.results.keys() or any(
                not np.array_equal(rep2.results[i], rep.results[i])
                for i in rep.results):
            raise AssertionError("a second serve gave other results")
        dev_ms = device_ms(prof)
        busy = sum(v[0] for v in dev_ms.values())
        fused_dev = sum(v[0] for k_, v in dev_ms.items()
                        if "ivf_scan_merge" in k_)
        print(f"profiled serve: wall {prof_wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / prof_wall:.1f}% of wall), "
              f"{sum(v[1] for v in dev_ms.values())} device operations")
        for name, (ms, cnt) in sorted(dev_ms.items(),
                                      key=lambda kv: -kv[1][0])[:12]:
            print(f"  {ms:9.3f} ms  x{cnt:<5d} {name[:90]}")
        print(f"fused ivf_scan_merge: {launches['ivf_scan_merge']} "
              f"launches in the "
              f"timed serve; {fused_dev:.3f} ms of device time in the "
              f"profiled serve = {100 * fused_dev / wall_ms:.2f}% of the "
              f"timed serve's {wall_ms:.3f} ms wall")

    with phase("live_serve_profile"):
        # the same live stream again, from the same start, under the
        # profiler: the same results, and where its time goes
        live2, _ = fresh_live()
        with profile(activities=activities) as prof:
            rep_p, reg_p, _, wall_p, merge_p = live_serve(live2)
        if any(not np.array_equal(rep_p.results[i], rep_l.results[i])
               for i in range(N_QUERIES)):
            raise AssertionError("a second live serve gave other results")
        dev_ms = device_ms(prof)
        busy = sum(v[0] for v in dev_ms.values())
        fused_dev = sum(v[0] for k_, v in dev_ms.items()
                        if "ivf_scan_merge" in k_)
        print(f"profiled live serve: wall {wall_p:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall_p:.1f}% of wall, idle "
              f"{100 - 100 * busy / wall_p:.1f}%), "
              f"{sum(v[1] for v in dev_ms.values())} device operations, "
              f"{rep_p.waves} waves, merge_delta host ms {merge_p}")
        for name, (ms, cnt) in sorted(dev_ms.items(),
                                      key=lambda kv: -kv[1][0])[:12]:
            print(f"  {ms:9.3f} ms  x{cnt:<5d} {name[:90]}")
        print(f"fused ivf_scan_merge+delta: "
              f"{launches['ivf_scan_merge+delta']} launches in the timed "
              f"live serve; {fused_dev:.3f} ms of device time in the "
              f"profiled one = {100 * fused_dev / wall_l:.2f}% of the timed "
              f"live serve's {wall_l:.3f} ms wall")
        # a publish after a mutation: the view's device copy and the dead
        # lookup's host-to-device copy are both made anew
        pub_ms = []
        for i in range(10):
            added = live2.add(corpus.docs[i: i + 1])
            live2.delete(added)
            sync()
            t0 = time.perf_counter()
            reg_p.publish(version_of(live2))
            sync()
            pub_ms.append((time.perf_counter() - t0) * 1000)
        print(f"publish after a mutation: host ms median "
              f"{float(np.median(pub_ms)):.3f} over 10 (min "
              f"{min(pub_ms):.3f}, max {max(pub_ms):.3f})")

    # -- 6b. resilience: deadline serves at full width, the rebuild
    # throttle, shard retry, the chaos drills, the serving benchmark -----
    deadline_phases(ctx, index, queries, exact, rep)
    drill = drill_substrate(ctx)
    deadline_throttle(ctx, drill)
    _, shards4 = shard_retry(ctx, index, queries, exact,
                             metrics.r_star_at_k(served, exact))
    mesh_search(ctx, index, corpus, queries, exact, summ, shards4)
    del shards4
    chaos_phase(ctx, drill)
    serving_bench_smoke(ctx)

    # -- 7. durability: WAL, snapshots, rebuilds, recovery, after the
    # profiled phases (the profiler's sessions all precede this work) ----
    durable_serve(ctx, index, corpus.docs, queries, served, exact, wall_l)
    rebuild_crash_drills(ctx, drill)
    kernel_bench_phase(ctx)

    kernels = []
    for r in rows:
        # a row of a kernel at another shape names the kernel's counter
        bound_ms, bound_by = r.pop("bound")
        counter = r.get("counter", r["name"])
        kernels.append({**{k_: r[k_] for k_ in ("name", "route", "source",
                                                 "replaces")},
                        "launches": r.get("launches", launches[counter]),
                        "max_abs_err": r.get("max_abs_err",
                                             max_err[counter]),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
