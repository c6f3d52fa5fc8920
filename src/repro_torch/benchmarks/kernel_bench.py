"""Kernel micro-benchmarks on the port (port of ``benchmarks.kernel_bench``):
each hand-written CUDA kernel beside its plain PyTorch version, at the
reference's shapes, timed with CUDA events (the median of ``reps``
calls after a warm-up), with the max |kernel - plain| of each.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench [--smoke]
        [--device cpu]

It writes ``artifacts/BENCH_kernels_torch.json`` in the schema
``make bench-smoke`` asserts of ``BENCH_kernels.json``: ``rows`` (name,
us, err); ``fused_sweep`` over chunk x blk_l of the fused
``ivf_scan_merge``, with a ``delta`` row, where ``pipelined`` says
whether the staged ``cp.async.bulk`` route ran
(``kernels.ivf_scan_merge.ring_stages`` > 0); ``sort``, the port's
packed (key, id) records sorted as one int64 word against the
reference's three-lane tagged bitonic network in plain torch; and
``backend``, ``pipelined_available``, the device's name and its power
limit.  On the card it runs unless ``device="cpu"`` is asked for; the
CPU run times only the plain versions (``backend: "cpu"``), and the
staged route, which only the card has, is recorded as pending
(``us: null``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.benchmarks.common import ARTIFACTS, device_info, sync
from repro_torch.kernels import _build
from repro_torch.kernels import delta_scan as k_ds
from repro_torch.kernels import embedding_bag as k_eb
from repro_torch.kernels import flash_attention as k_fa
from repro_torch.kernels import ivf_scan as k_scan
from repro_torch.kernels import ivf_scan_merge as k_sm
from repro_torch.kernels import ops, sort
from repro_torch.kernels import topk_merge as k_tm


def _time_us(fn: Callable, dev: torch.device, reps: int) -> float:
    """Median us of one call: CUDA events on the card, the host clock
    on the CPU, after one warm-up call."""
    fn()
    sync(dev)
    if dev.type != "cuda":
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e6
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    sync(dev)
    return float(np.median([a.elapsed_time(b) for a, b in events])) * 1e3


def _err(a, b) -> float:
    """max abs err, -inf against -inf counted equal."""
    d = (a.float() - b.float()).nan_to_num(neginf=0.0, posinf=0.0)
    return float(d.abs().max()) if d.numel() else 0.0


def _bitonic_desc_tagged_legacy(s, i, t):
    """The reference fused kernel's pre-packed three-lane sort (score
    f32, id i32, tag i32 — three shuffles + three selects per pass),
    kept ONLY as the packed-vs-tagged baseline."""
    r, m = s.shape
    idx = torch.arange(m, device=s.device)[None, :]

    def partner(x, jj):
        return x.reshape(r, m // (2 * jj), 2, jj).flip(2).reshape(r, m)

    for stage in range(1, int(np.log2(m)) + 1):
        kk = 1 << stage
        for jj in (1 << p for p in range(stage - 1, -1, -1)):
            keep_max = torch.where((idx & kk) == 0, (idx & jj) == 0,
                                   (idx & jj) != 0)
            ps, pi, pt = partner(s, jj), partner(i, jj), partner(t, jj)
            take_p = torch.where(keep_max, ps > s, ps < s)
            s = torch.where(take_p, ps, s)
            i = torch.where(take_p, pi, i)
            t = torch.where(take_p, pt, t)
    return s, i, t


def _sort_section(dev: torch.device, reps: int, smoke: bool) -> Dict:
    """Packed (one int64 record) vs the legacy tagged (3-lane) network."""
    rng = np.random.default_rng(17)
    r, m = (64, 512) if not smoke else (16, 512)
    sc = torch.as_tensor(rng.normal(size=(r, m)).astype(np.float32),
                         device=dev)
    ids = torch.as_tensor(rng.integers(0, 1 << 29, (r, m)).astype(np.int32),
                          device=dev)
    tags = torch.zeros((r, m), dtype=torch.int32, device=dev)

    def packed():
        return sort.bitonic_desc_packed(sort.pack(sort.score_to_key(sc),
                                                  ids))

    def tagged():
        return _bitonic_desc_tagged_legacy(sc, ids, tags)

    out_p, out_t = packed(), tagged()
    if not torch.equal(sort.key_to_score(out_p[:, 0]), out_t[0]):
        raise AssertionError("packed and tagged sorts disagree")
    packed_us = _time_us(packed, dev, reps)
    tagged_us = _time_us(tagged, dev, reps)
    return {"rows": r, "m": m, "packed_us": packed_us,
            "tagged_us": tagged_us,
            "speedup": tagged_us / max(packed_us, 1e-9)}


def check_schema(d: Dict) -> None:
    """Raise unless ``d`` passes the assertions ``make bench-smoke``
    makes of the kernel JSON (``Makefile``, bench-smoke)."""
    sweep = d.get("fused_sweep") or []
    ok = ({"rows", "fused_sweep", "sort", "backend"} <= d.keys() and sweep
          and all({"chunk", "blk_l", "us", "pipelined", "delta"} <= r.keys()
                  for r in sweep)
          and any(r["delta"] for r in sweep)
          and d["sort"]["packed_us"] > 0 and d["sort"]["tagged_us"] > 0
          and (any(r["us"] is None for r in d["rows"])
               or d["pipelined_available"]))
    if not ok:
        raise AssertionError(f"kernel JSON off the bench-smoke schema: "
                             f"{sorted(d)}")


def main(smoke: bool = False, device: DeviceLike = None,
         out: Optional[str] = os.path.join(ARTIFACTS,
                                           "BENCH_kernels_torch.json")
         ) -> Dict:
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    reps = 5 if smoke else 20
    rows: List[Dict] = []
    g = torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(dev)

    def add(name, plain, kernel):
        """A kernel's plain row, and on the card its kernel's row with
        the max |kernel - plain| of their outputs (the first output
        where a call returns several)."""
        if not on_card:
            rows.append({"name": f"{name}_plain",
                         "us": _time_us(plain, dev, reps), "err": 0.0})
            return
        first = (lambda o: o[0] if isinstance(o, tuple) else o)
        err = _err(first(kernel()), first(plain()))
        rows.append({"name": f"{name}_plain",
                     "us": _time_us(plain, dev, reps), "err": err})
        rows.append({"name": f"{name}_cuda",
                     "us": _time_us(kernel, dev, reps), "err": err})

    # flash attention, (4, 512, 64) causal, f32 and bf16
    q, k, v = normal(4, 512, 64), normal(4, 512, 64), normal(4, 512, 64)
    add("flash_attention",
        lambda: k_fa.flash_attention_plain(q, k, v, causal=True),
        lambda: k_fa.flash_attention(q, k, v, causal=True))
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    add("flash_attention_bf16",
        lambda: k_fa.flash_attention_plain(qb, kb, vb, causal=True),
        lambda: k_fa.flash_attention(qb, kb, vb, causal=True))

    # ivf scan: 64 queries, each on a 256-row list of a 65,536-doc matrix
    docs = normal(65536, 64)
    qs = normal(64, 64)
    boffs = (torch.arange(64, dtype=torch.int32) * 4).to(dev)   # blk_l 64
    add("ivf_scan",
        lambda: k_scan.ivf_scan_plain(qs, docs, boffs, list_pad=256,
                                      blk_l=64),
        lambda: k_scan.ivf_scan(qs, docs, boffs, list_pad=256, blk_l=64))

    # topk merge: (256, 50) running with (256, 256) new
    s, i = normal(256, 50), ints(0, 10 ** 6, 256, 50)
    ns, ni = normal(256, 256), ints(0, 10 ** 6, 256, 256)
    add("topk_merge", lambda: k_tm.topk_merge_plain(s, i, ns, ni, 50),
        lambda: k_tm.topk_merge(s, i, ns, ni, 50))

    # fused multi-probe scan -> merge: 16 queries, 8 probes of 256-row
    # lists each, k 50
    b, n_pr, lp, kk = 16, 8, 256, 50
    fdocs = normal(b * n_pr * lp, 64)
    fids = torch.arange(b * n_pr * lp, dtype=torch.int32, device=dev)
    all_offs = (torch.arange(b * n_pr, dtype=torch.int32, device=dev)
                * lp).reshape(b, n_pr)
    fq = normal(b, 64)
    rs = torch.full((b, kk), float("-inf"), device=dev)
    ri = torch.full((b, kk), -1, dtype=torch.int32, device=dev)
    szs4 = torch.full((b, 4), lp - 6, dtype=torch.int32, device=dev)
    ids2d = fids.reshape(-1, 64)
    bo4 = (all_offs[:, :4] // 64).reshape(-1).contiguous()
    add("ivf_scan_merge",
        lambda: k_sm.ivf_scan_merge_plain(
            fq, fdocs, ids2d, bo4, szs4.reshape(-1), rs, ri, k=kk,
            list_pad=lp, chunk=4, blk_l=64),
        lambda: k_sm.ivf_scan_merge(
            fq, fdocs, ids2d, bo4, szs4.reshape(-1), rs, ri, k=kk,
            list_pad=lp, chunk=4, blk_l=64))

    def sweep(chunk: int, blk_l: int = 64):
        """The full n_pr probes as n_pr / chunk launches (the wrapper: the
        kernel on the card, the plain version on the CPU)."""
        offs = all_offs.reshape(b, n_pr // chunk, chunk)
        szs = torch.full((b, chunk), lp - 6, dtype=torch.int32, device=dev)

        def run():
            ss, ii = rs, ri
            for j in range(n_pr // chunk):
                snap_s, snap_i, _ = ops.ivf_scan_merge(
                    fq, fdocs, fids, offs[:, j], szs, ss, ii, k=kk,
                    list_pad=lp, chunk=chunk, blk_l=blk_l)
                ss, ii = snap_s[:, -1], snap_i[:, -1]
            return ss, ii
        return run

    route = "cuda" if on_card else "plain"
    # the plain version of the whole sweep (one probe a call, on the
    # host), for each row's err
    want_s = None
    if on_card:
        cpu = {n: x.cpu() for n, x in (("fq", fq), ("fdocs", fdocs),
                                       ("fids", fids))}
        s_, i_ = rs.cpu(), ri.cpu()
        for j in range(n_pr):
            o = all_offs[:, j:j + 1].cpu()
            z = torch.full((b, 1), lp - 6, dtype=torch.int32)
            snap_s, snap_i, _ = ops.ivf_scan_merge(
                cpu["fq"], cpu["fdocs"], cpu["fids"], o, z, s_, i_, k=kk,
                list_pad=lp, chunk=1)
            s_, i_ = snap_s[:, -1], snap_i[:, -1]
        want_s = s_

    def sweep_err(run) -> float:
        return _err(run()[0].cpu(), want_s) if on_card else 0.0

    for chunk in ([4] if smoke else [1, 2, 4, 8]):
        run = sweep(chunk)
        rows.append({"name": f"ivf_scan_merge_{route}_c{chunk}",
                     "us": _time_us(run, dev, reps), "err": sweep_err(run)})

    # chunk x blk_l: launch granularity against tile height; the staged
    # route needs the card (and rows a ring stage can copy)
    def staged(chunk: int, blk_l: int) -> bool:
        return on_card and k_sm.ring_stages(
            64, kk, chunk, lp, blk_l % k_sm.TILE_ROWS == 0,
            _build.max_shared_optin(dev)) > 0

    fused_sweep = []
    for chunk in ([4] if smoke else [2, 4, 8]):
        for blk_l in ([64] if smoke else [64, 128, 256]):
            run = sweep(chunk, blk_l)
            fused_sweep.append({
                "chunk": chunk, "blk_l": blk_l,
                "pipelined": staged(chunk, blk_l), "delta": False,
                "us": _time_us(run, dev, reps), "err": sweep_err(run)})

    # the in-kernel delta stream: the same probes plus a 256-entry buffer
    # whose entries no slot gates (every gate -2), one launch
    dcap = 256
    dl_vecs = normal(dcap, 64)
    dl_ids = torch.arange(dcap, dtype=torch.int32, device=dev) + 10 ** 7
    dl_assign = torch.zeros(dcap, dtype=torch.int32, device=dev)
    gates = torch.full((b, 4), -2, dtype=torch.int32, device=dev)

    def run_delta():
        return ops.ivf_scan_merge(fq, fdocs, fids, all_offs[:, :4], szs4,
                                  rs, ri, dl_vecs, dl_ids, dl_assign, gates,
                                  k=kk, list_pad=lp, chunk=4)

    d_err = 0.0
    if on_card:
        got = run_delta()[0].cpu()
        want = ops.ivf_scan_merge(
            fq.cpu(), fdocs.cpu(), fids.cpu(), all_offs[:, :4].cpu(),
            szs4.cpu(), rs.cpu(), ri.cpu(), dl_vecs.cpu(), dl_ids.cpu(),
            dl_assign.cpu(), gates.cpu(), k=kk, list_pad=lp, chunk=4)[0]
        d_err = _err(got, want)
    fused_sweep.append({
        "chunk": 4, "blk_l": 64, "pipelined": staged(4, 64), "delta": True,
        "us": _time_us(run_delta, dev, reps), "err": d_err})
    for row in fused_sweep:
        mode = "pipelined" if row["pipelined"] else "unpipelined"
        tag = "_delta" if row["delta"] else ""
        rows.append({"name": f"fused_{mode}_c{row['chunk']}_blk"
                             f"{row['blk_l']}{tag}",
                     "us": row["us"], "err": row["err"]})
    pipelined_available = any(r["pipelined"] for r in fused_sweep)
    if not pipelined_available:
        # the staged route runs on the card only: recorded as pending
        rows.append({"name": "fused_pipelined_c4_blk64", "us": None,
                     "err": None})

    # delta scan: 16 queries against a 1,024-slot buffer
    dvecs = normal(1024, 64)
    add("delta_scan", lambda: k_ds.delta_scan_plain(fq, dvecs),
        lambda: k_ds.delta_scan(fq, dvecs))

    # embedding bag: 1,024 bags of 26 rows of a (100,000, 16) table
    table = normal(100_000, 16)
    bag_ids = ints(0, 100_000, 1024, 26)
    add("embedding_bag", lambda: k_eb.embedding_bag_plain(table, bag_ids),
        lambda: k_eb.embedding_bag(table, bag_ids))

    for row in rows:
        us = "pending" if row["us"] is None else f"{row['us']:.1f}"
        err = "" if row["err"] is None else f"{row['err']:.2e}"
        print(f"{row['name']},{us},{err}")
    result = {"rows": rows, "fused_sweep": fused_sweep,
              "sort": _sort_section(dev, reps, smoke),
              **device_info(dev), "pipelined_available": pipelined_available,
              "smoke": smoke}
    if out is not None:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {os.path.relpath(out)}")
    return result


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(smoke=args.smoke, device=args.device)
