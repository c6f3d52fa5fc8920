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
   (HMMA, HGMMA), the staged ``ivf_scan_merge`` a bulk async copy
   (UBLKCP);
2. each kernel against its plain version at main-path shapes, on
   integer-valued inputs (bit-equal, ties included) and on L2-normalised
   Gaussian inputs (scores within 1e-5, ids equal up to near-tie swaps);
   ``flash_attention`` in f32 (within 2e-5) and bf16 (within the
   per-element bound of ``kernels.flash_attention.bf16_bound``: the
   kernel rounds P to bf16), hd 64 and 128, S a tile multiple and not,
   causal or not;
   ``embedding_bag`` bit for bit at D 1, 10, 16 and F 1, 39;
3. the main path at the paper's widths (``configs/msmarco_ivf``:
   d=768, k=100, N=80, tau=10, patience Delta=7, Phi=95, list_pad=256)
   on a 1M-document synthetic corpus: build the index on the card,
   serve 1,024 queries through the wave scheduler (one fused
   ``ivf_scan_merge`` launch per chunk), and check it against fused
   ``search``, the per-probe kernel pair and brute force;
3b. the learned exit stages on that index (``learned_train``,
   ``learned_search``, ``learned_fused_vs_pair``, ``learned_features``):
   the four forests of Table 2 (30 trees, depth 5) trained on 2,048
   queries of their own (validated on 512) at N=80, tau=10, w=3; the
   eight Table-2 strategies on the 1,024 served queries through the
   fused kernel (R*@1, R*@k, mRR@10, C, wall, speedup, launches; every
   learned query's probes within [tau, N], +Patience's C at most the
   weighted classifier's); both cascades' fused search against the
   kernel pair, and the features built offline against the online ones
   at tau and across batch sizes, bit for bit;
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
   DeepFM (39 x 1M rows, D=10) serves 8 ``serve_p99`` batches and one
   ``serve_bulk`` batch (2 ``embedding_bag`` launches a call), each
   against the same forward from ``emb.sum(1)``; profiled calls of both;
6. each kernel's time (CUDA events) beside its plain version, a library
   yardstick the port never calls, and its bound; ``topk_merge`` at
   probe 1, at a late probe and at the live pair's width (list rows and
   the gated buffer columns), beside the launch floor (an empty
   kernel); ``flash_attention`` (the prefill's 96 x 2,048 x 128 bf16)
   and ``embedding_bag`` (the bulk batch on both DeepFM tables, D=10
   and D=1, its bound on 32-byte sectors) are held against their plain
   versions there too; a profiled static and live serve.

It prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
failed phase ends the script with a non-zero exit and no result.
"""
from __future__ import annotations

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
RS_ARCH, RS_P99_BATCH, RS_P99_CALLS, RS_BULK_BATCH = \
    "deepfm", 512, 8, 262_144
# tests/test_models_lm.py:38-47's bounds on log-softmax differences
PREFILL_TOL, DECODE_TOL = 0.15, 0.25
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
    tile multiple and not) and embedding_bag (D 1, 10, 16; F 1, 39) on
    the card against their plain versions, off the main path's shapes
    (``model_zoo_timing`` holds both at those)."""
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


def lm_serve(ctx, cfg, *, prompts=LM_PROMPTS, prompt_len=LM_PROMPT_LEN,
             n_decode=LM_DECODE, seed=0):
    """StarCoder2-3B serving on seeded random weights: init, prefill of
    ``prompts`` Zipf prompts, ``n_decode`` decode steps fed the stream's
    next tokens, and both held against ``forward`` over the whole
    sequence."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_map

    max_seq = prompt_len + n_decode
    with ctx.phase("lm_init"):
        params = transformer.init_params(cfg, seed=seed, device=ctx.dev)
        ctx.sync()
        leaves = []
        tree_map(leaves.append, params)
        n = sum(t.numel() for t in leaves)
        print(f"{cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
              f"{cfg.n_heads} heads, kv={cfg.n_kv_heads}, d_ff={cfg.d_ff}, "
              f"vocab {cfg.vocab_size}: {n} parameters "
              f"({sum(t.numel() * t.element_size() for t in leaves)} bytes "
              f"f32; config param_count {cfg.param_count()} + ln_f)")
        if n != cfg.param_count() + cfg.d_model:
            raise AssertionError("parameter count differs from the config's")
    toks = token_stream(prompts * max_seq, cfg.vocab_size, seed=seed) \
        .reshape(prompts, max_seq)
    with ctx.phase("lm_prefill"):
        # twice: the first call pays for the GEMM heuristics and the
        # allocator's first blocks, the second is the steady state
        walls = []
        for _ in range(2):
            ctx.reset()
            ctx.reset_peak()
            ctx.sync()
            t0 = time.perf_counter()
            logits, cache = transformer.prefill(
                cfg, params, toks[:, :prompt_len], max_seq=max_seq)
            ctx.sync()
            walls.append((time.perf_counter() - t0) * 1000)
        wall = walls[-1]
        counts = ctx.read(f"lm prefill ({prompts} x {prompt_len})",
                          ["flash_attention"], absent=["embedding_bag"])
        if counts["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"prefill launched flash_attention "
                                 f"{counts['flash_attention']} times, not "
                                 f"{cfg.n_layers}")
        if logits.shape != (prompts, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite or of the "
                                 "expected shape")
        peak = ctx.peak()
        print(json.dumps(dict(prefill_wall_ms=wall,
                              prefill_wall_ms_first_call=walls[0],
                              prompt_tokens_per_s=prompts * prompt_len
                              / (wall / 1000),
                              peak_device_mem_bytes=peak,
                              cache_bytes=sum(c.numel() * c.element_size()
                                              for c in cache.data))))
    ctx.reset()
    with ctx.phase("lm_decode"):
        step_ms, steps = [], []
        for i in range(n_decode):
            pos = prompt_len + i
            ctx.sync()
            t0 = time.perf_counter()
            lg, cache = transformer.decode_step(cfg, params, cache,
                                                toks[:, pos: pos + 1], pos)
            ctx.sync()
            step_ms.append((time.perf_counter() - t0) * 1000)
            steps.append(lg)
        ctx.read("lm decode", [], absent=["flash_attention", "embedding_bag"])
        if not all(torch.isfinite(lg).all() for lg in steps):
            raise AssertionError("decode logits are not finite")
        print(json.dumps(dict(decode_steps=n_decode, batch=prompts,
                              ms_per_step_median=float(np.median(step_ms)),
                              ms_per_step=step_ms,
                              decode_tokens_per_s=prompts * n_decode
                              / (sum(step_ms) / 1000))))
    ctx.reset()
    with ctx.phase("lm_consistency"):
        full, _ = transformer.forward(cfg, params, toks)
        ctx.sync()
        counts = ctx.read(f"lm forward ({prompts} x {max_seq})",
                          ["flash_attention"])
        if counts["flash_attention"] != cfg.n_layers:
            raise AssertionError("forward did not launch flash_attention "
                                 "once per layer")

        def lsm(x):
            return torch.log_softmax(x.float(), -1)

        pre_err = float((lsm(logits) - lsm(full[:, prompt_len - 1]))
                        .abs().max())
        dec_err = [float((lsm(lg) - lsm(full[:, prompt_len + i])).abs().max())
                   for i, lg in enumerate(steps)]
        print(f"log-softmax max |prefill - forward| {pre_err} (bound "
              f"{PREFILL_TOL}); |decode - forward| per step {dec_err} "
              f"(bound {DECODE_TOL})")
        if pre_err >= PREFILL_TOL or max(dec_err) >= DECODE_TOL:
            raise AssertionError("prefill/decode disagree with forward")
    del full, steps
    with ctx.phase("lm_profile"):
        # the same prefill again, and the last decode step again (it
        # rewrites the cache slot with the same values)
        ctx.profile(f"prefill ({prompts} x {prompt_len})",
                    lambda: transformer.prefill(cfg, params,
                                                toks[:, :prompt_len],
                                                max_seq=max_seq))
        pos = max_seq - 1
        ctx.profile("decode step", lambda: transformer.decode_step(
            cfg, params, cache, toks[:, pos: pos + 1], pos))
    del params, cache, logits


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


def model_zoo_timing(ctx, lm_cfg, table, linear_table, rows):
    """Timing rows of flash_attention (the prefill's shapes, random bf16)
    and embedding_bag (the bulk batch on both DeepFM tables: D=10 and the
    D=1 ``linear_table``), each first held against its plain version on
    those inputs: its row's ``max_abs_err``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k_fa

    heads, hd = lm_cfg.n_heads, lm_cfg.head_dim()
    bh, s = LM_PROMPTS * heads, LM_PROMPT_LEN
    g = torch.Generator(device=ctx.dev).manual_seed(5)
    q, k, v = (torch.randn((bh, s, hd), generator=g, device=ctx.dev)
               .to(torch.bfloat16) for _ in range(3))
    flops = 4 * bh * hd * s * (s + 1) / 2
    n_bytes = 4 * bh * s * hd * 2
    print(f"flash_attention: {flops:.6e} causal FLOP, {n_bytes} bytes; "
          f"at the f32 CUDA-core peak {flops / F32_FLOPS_PER_S * 1e3:.6f}"
          f" ms")

    got = k_fa.flash_attention(q, k, v, causal=True)
    ctx.sync()
    err, ratio = check_flash(got, q, k, v, True)
    ctx.max_err["flash_attention"] = err
    print(f"flash_attention at the prefill's shapes (BH={bh}, S={s}, "
          f"hd={hd}, bf16, causal): max_abs_err {err}, max |got - want| / "
          f"bound {ratio}")
    del got

    def sdpa():
        shp = (LM_PROMPTS, heads, s, hd)
        return F.scaled_dot_product_attention(
            q.view(shp), k.view(shp), v.view(shp), is_causal=True)

    rows_out = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:65",
        ms=ctx.time_call("flash_attention", lambda: k_fa.flash_attention(
            q, k, v, causal=True), 10, profiled=True),
        plain_ms=ctx.time_call("flash_attention plain",
                               lambda: k_fa.flash_attention_plain(
                                   q, k, v, causal=True), 5),
        bound=bound(n_bytes, flops, BF16_FLOPS_PER_S),
        library_ms=ctx.time_call("scaled_dot_product_attention", sdpa, 20))]
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
    ``learned_fused_vs_pair`` and ``learned_features``: train the four
    forests, run Table 2's eight strategies on ``queries`` through the
    fused kernel (one ``ivf_scan_merge`` launch per chunk of 4 probes;
    the median wall of ``timed_calls`` after a warm one; A-kNN and
    +Patience once more under the profiler),
    hold both cascades' fused search against the kernel pair, and hold
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
    from repro_torch.kernels import topk_merge as k_tm
    from repro_torch.launch.serve import mutation_stream

    dev = torch.device("cuda", 0)
    # each kernel's launch counter: (wrapper, attribute); the fused kernel
    # counts its launches with and without the delta stream apart
    counters = {"ivf_scan": (k_scan.ivf_scan, "launches"),
                "topk_merge": (k_tm.topk_merge, "launches"),
                "ivf_scan_merge": (k_sm.ivf_scan_merge, "launches"),
                "delta_scan": (k_ds.delta_scan, "launches"),
                "ivf_scan_merge+delta": (k_sm.ivf_scan_merge,
                                         "delta_launches"),
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
        its last sessions)."""
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
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            sync()
        dev = sum(ms for ms, _ in device_ms(prof).values()) / reps
        if dev <= 0:
            raise AssertionError(f"{name}: the profiler saw no device time")
        print(f"  {name}: {med:.6f} ms median by events over {reps} calls, "
              f"{dev:.6f} ms device per call by the profiler")
        return med

    # what the model-zoo phases need of this run (see lm_serve)
    ctx = SimpleNamespace(
        dev=dev, sync=sync, phase=phase, max_err=max_err,
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
        # the staged instantiation (kStaged = true) streams list rows by
        # cp.async.bulk
        staged = [c for n, c in sass["ivf_scan_merge_kernel"].items()
                  if "ILb1E" in n]
        if not staged or not all(c["UBLKCP"] or c["LDGSTS"] for c in staged):
            raise AssertionError("the staged ivf_scan_merge_kernel has no "
                                 "async copy (UBLKCP or LDGSTS)")

    # -- 2. each kernel against its plain version ----------------------------
    rng = np.random.default_rng(0)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def finite_err(a, b):
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
        memory); bit-equal to the plain version."""
        for name, kw in (("all gated on one slot", {}), ("inactive", {}),
                         ("ties", {}), ("k=1", dict(k=1)),
                         ("k=1024", dict(k=1024)), ("chunk=1", dict(chunk=1)),
                         ("chunk=8", dict(chunk=8)), ("d=100", dict(d=100)),
                         ("d=30", dict(d=30))):
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
        sync()
        t0 = time.perf_counter()
        rep = ws.serve(queries)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1000
        read_launches("serve (WaveScheduler, fused)", ["ivf_scan_merge"],
                      absent=["ivf_scan_merge+delta", "delta_scan"])
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
        """A LiveIndex over ``index`` after the pre-serve burst: PRE_ADDS
        noisy copies of corpus docs added, PRE_DELETES main docs deleted.
        Returns it and the deleted ids."""
        lv = LiveIndex(index, delta_cap=CAP)
        r = np.random.default_rng(2)
        src = r.integers(0, N_DOCS, PRE_ADDS)
        lv.add((corpus.docs[src] + r.normal(scale=NOISE, size=(PRE_ADDS, D))
                ).astype(np.float32))
        gone = r.choice(N_DOCS, PRE_DELETES, replace=False)
        lv.delete(gone)
        return lv, gone

    def live_serve(lv):
        """Serve every query against ``lv`` through a registry, with the
        mutation stream publishing after each wave; ``merge_delta``'s host
        ms (synchronised) are collected as it runs."""
        reg = IndexRegistry(version_of(lv))
        ws_l = WaveScheduler(index, wave_size=B, chunk=CHUNK, k=K,
                             n_probe=N_PROBE, delta=DELTA, phi=PHI,
                             registry=reg)
        mutate, stats = mutation_stream(lv, reg, corpus.docs,
                                        rate=MUTATION_RATE,
                                        merge_every=MERGE_EVERY, noise=NOISE)
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
        if counts["ivf_scan_merge+delta"] != rep_l.waves:
            raise AssertionError("the live serve did not launch the fused "
                                 "kernel with the stream once per wave")
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
    rs_params, rs_rows = recsys_serve(ctx, get_arch(RS_ARCH).model)

    # -- 6. timing ------------------------------------------------------------
    rows = []
    with phase("timing"):
        # main-path inputs: the first wave's queries, their first CHUNK
        # probes, and the running top-k after probe 0
        qb = queries[:B]
        _, rank = torch.sort(qb @ index.centroids.T, dim=1, descending=True,
                             stable=True)
        cids = rank[:, :CHUNK]
        offs = index.cluster_offsets[cids].contiguous()
        sz = index.cluster_sizes[cids].contiguous()
        boffs = (offs // BLK_L).reshape(-1).contiguous()
        szf = sz.reshape(-1).contiguous()
        tail = (-index.doc_ids.shape[0]) % BLK_L
        ids2d = torch.nn.functional.pad(index.doc_ids, (0, tail),
                                        value=-1).reshape(-1, BLK_L)
        empty_s = torch.full((B, K), float("-inf"), device=dev)
        empty_i = torch.full((B, K), -1, dtype=torch.int32, device=dev)
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
        rows += model_zoo_timing(ctx, get_arch(LM_ARCH).model,
                                 rs_params["table"],
                                 rs_params["linear_table"], rs_rows)

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
