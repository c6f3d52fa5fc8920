"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, and the result's line.

A cell whose mix has a ``mutations`` block is live: set-up wraps the
index in the program's ``LiveIndex``, serves it through an
``IndexRegistry`` and hands ``serve`` the mutation stream
(``mutations.Stream``) as its ``on_wave`` hook; it then drops its own
handles on the documents, so that the program holds the only copy of
the corpus on the card, and the check makes the corpus again from the
seed once the program's objects are gone.

A configuration with a ``policy`` block serves the paper's cascade: set-up
trains its exit trees from the seed (``policy.py``), hands them to the
program as a ``cascade_patience`` policy and builds
``WaveScheduler(index, policy=...)``; a program whose ``WaveScheduler``
takes no ``policy`` stops set-up before the corpus is made.

``run.py`` calls :func:`run` after it has seen the cards the cell
needs; the tests call it on the CPU at a tiny configuration.
"""
from __future__ import annotations

import dataclasses
import inspect
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from . import corpus as corpus_mod
from . import drive, judge, mutations, policy, spec, trace
from .reference import counts, ivf_cascade

# the traced window: at most this long, and no longer than the window
TRACE_SECONDS = 2.0
# documents sampled for the nearest-centre share checked at set-up, and
# the least share that makes the lists a nearest-centroid partition, as
# an IVF index's lists are
OWN_CENTRE_SAMPLE = 4096
OWN_CENTRE_MIN = 0.99


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def host_note() -> str:
    """The seconds a fixed pure-Python loop takes now: the host's speed,
    which a host-bound window follows (the host's steal counter reads 0
    on the card's machine, so it is not read)."""
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i
    return f"host: probe loop {time.perf_counter() - t:.4f} s"


@dataclasses.dataclass
class Run:
    """What the metric readers read (``portbench/metrics/*.py``).  In a
    live cell each call of a window carries the stream's record of it
    (``drive.Call.mutations``)."""
    loop: str
    setup_s: float
    window: drive.Window
    traced: Optional[drive.Window] = None
    trace: Optional[trace.Trace] = None
    # least seconds for the traced window's needed work, by component
    bound_s: Dict[str, float] = dataclasses.field(default_factory=dict)


def _sync_of(dev: torch.device):
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def needed_bounds(c: corpus_mod.Corpus, cfg: dict, w: drive.Window
                  ) -> Dict[str, float]:
    """The least seconds for the work the window's served queries need
    (``reference/counts.py``), by component."""
    idx = np.concatenate([call.pool_idx for call in w.calls])
    probes = np.concatenate([
        [call.report.probes.get(j, 0)
         for j in range(call.pool_idx.shape[0])]
        for call in w.calls]).astype(np.int64)
    uniq, inv = np.unique(idx, return_inverse=True)
    cum = counts.live_rows_by_probes(
        c.pool[torch.as_tensor(uniq, device=c.pool.device)], c.centroids,
        c.sizes, cfg["n_probe"]).cpu().numpy()
    rows = int(cum[inv, probes].sum())
    d, lists = cfg["dim"], cfg["n_lists"]
    return {
        "scan": counts.bound_s(counts.scan_bytes(rows, d), 0),
        "rank": counts.bound_s(0, counts.ranking_flops(idx.shape[0], d,
                                                       lists)),
        "table": counts.bound_s(counts.table_bytes(lists, d), 0),
    }


@dataclasses.dataclass
class Bench:
    """A cell set up: its corpus on the device, the program's scheduler
    over it, and the generator of its traffic; in a live cell, the
    mutation stream (and a corpus without its documents, which the
    program holds); with a ``policy`` block, the exit trees."""
    cell: spec.Cell
    corpus: corpus_mod.Corpus
    sched: object
    load: drive.Load
    sums: tuple
    sync: object
    stream: Optional[mutations.Stream] = None
    forest: Optional[ivf_cascade.Forest] = None

    @property
    def cfg(self) -> dict:
        return self.cell.config

    def release(self) -> None:
        """Drop the program's objects once the windows have closed; in
        a live cell, free what they held on the card as well."""
        self.sched = self.load = None
        if self.stream is not None:
            self.stream.release()
            if self.corpus.pool.device.type == "cuda":
                torch.cuda.empty_cache()


def program_policy(forest: ivf_cascade.Forest, cfg: dict,
                   dev: torch.device):
    """The program's ``cascade_patience`` policy over the trees
    ``forest``, put on ``dev`` by the program's ``ensemble_from_arrays``."""
    from repro_torch.core.policies import cascade_patience
    from repro_torch.trees.torch_infer import ensemble_from_arrays

    pol = cfg["policy"]
    clf = ensemble_from_arrays(forest.feat, forest.thresh, forest.left,
                               forest.right, forest.value, forest.base,
                               forest.max_depth, device=dev)
    return cascade_patience(cfg["n_probe"], clf, cfg["patience_delta"],
                            cfg["patience_phi"],
                            threshold=pol["clf_threshold"], k=cfg["k"],
                            tau=pol["tau"])


def setup(root: Path, workload: str, seed: int, dev: torch.device
          ) -> Bench:
    """Make the corpus, lay out the index, build the program's scheduler
    over it and warm it up at the cell's shapes; with a ``policy``
    block, train the exit trees first and hand the scheduler the
    cascade."""
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.core.serving import WaveScheduler

    cell = spec.cell(root, workload)
    cfg, mix = cell.config, cell.traffic
    if "policy" in cfg and \
            "policy" not in inspect.signature(WaveScheduler).parameters:
        raise RuntimeError(
            f"{cfg['name']}: the program's WaveScheduler takes no keyword "
            f"'policy'; a configuration with a policy block needs "
            f"WaveScheduler(index, policy=...)")
    sync = _sync_of(dev)
    t = time.perf_counter()
    c = corpus_mod.make(cfg, mix["pool"], seed, dev)
    sync()
    log(f"corpus: {c.n_docs} docs in {cfg['n_lists']} lists, "
        f"{c.docs.shape[0]} rows x {cfg['dim']}, pool {c.pool.shape[0]}, "
        f"{time.perf_counter() - t:.3f} s")
    share = corpus_mod.own_centre_share(c, OWN_CENTRE_SAMPLE, seed)
    log(f"documents nearest their own centre: {share:.4f} "
        f"(at least {OWN_CENTRE_MIN})")
    if share < OWN_CENTRE_MIN:
        raise RuntimeError(
            f"{cfg['name']}: only {share:.4f} of the sampled documents lie "
            f"nearest their own list's centre; the lists are no IVF "
            f"partition")
    sums = corpus_mod.checksum(c)
    index = IVFIndex(c.centroids, c.docs, c.doc_ids, c.offsets, c.sizes,
                     c.list_pad)
    knobs = dict(wave_size=cfg["wave_size"], chunk=cfg["chunk"], k=cfg["k"],
                 n_probe=cfg["n_probe"], delta=cfg["patience_delta"],
                 phi=cfg["patience_phi"], use_fused=True)
    if "mutations" in mix:
        return _setup_live(cell, c, index, knobs, sums, seed, dev, sync)
    forest = None
    if "policy" in cfg:
        forest, took = policy.train(c, cfg, seed)
        log("exit trees: " + ", ".join(
            f"{key} {v:.3f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in took.items()))
        knobs["policy"] = program_policy(forest, cfg, dev)
    sched = WaveScheduler(index, **knobs)

    def serve(idx: np.ndarray):
        return sched.serve(c.pool[torch.as_tensor(idx, device=dev)])

    load = drive.Load(mix, c.pool.shape[0], serve, sync)
    t = time.perf_counter()
    load.warmup()
    log(f"warm-up {mix['warmup']}: {time.perf_counter() - t:.3f} s")
    return Bench(cell, c, sched, load, sums, sync, forest=forest)


# warm-up rounds of a live cell at most, while none has merged yet
LIVE_WARMUP_ROUNDS = 16


def _setup_live(cell: spec.Cell, c: corpus_mod.Corpus, index, knobs: dict,
                sums: tuple, seed: int, dev: torch.device, sync) -> Bench:
    """The live path of :func:`setup`: the program's live index and
    registry under the scheduler, the mutation stream as its hook, and
    warm-up until the stream has merged once (where it merges)."""
    from repro_torch.core.serving import WaveScheduler
    from repro_torch.index.live import LiveIndex
    from repro_torch.index.registry import IndexRegistry, version_of

    cfg, mix = cell.config, cell.traffic
    live = LiveIndex(index, delta_cap=cfg["live"]["delta_cap"],
                     align=cfg["align"])
    reg = IndexRegistry(version_of(live))
    sched = WaveScheduler(index, registry=reg, **knobs)
    stream = mutations.Stream(live, reg, version_of, c, cfg, mix, seed)
    del index, live, reg
    # the program holds the documents from here on
    c = dataclasses.replace(c, docs=None, doc_ids=None, id_rows=None)
    pool = c.pool

    def serve(idx: np.ndarray):
        return sched.serve(pool[torch.as_tensor(idx, device=dev)],
                           on_wave=stream)

    load = drive.Load(mix, pool.shape[0], serve, sync, stream=stream)
    t = time.perf_counter()
    for _ in range(LIVE_WARMUP_ROUNDS):
        load.warmup()
        if stream.merges() or not cfg["live"]["merge_every"]:
            break
    log(f"warm-up {mix['warmup']} x {len(stream.calls)}: "
        f"{time.perf_counter() - t:.3f} s, {stream.wave} waves, "
        f"{stream.merges()} merges")
    return Bench(cell, c, sched, load, sums, sync, stream)


def check(bench: Bench, calls, seed: int, control: bool = False,
          explain: bool = False, every_query: bool = False) -> dict:
    """The numbers compared for the program's answers (``program``);
    with ``control``, the control's on the same sampled queries
    (``control``); with ``explain``, each answer that parts from the
    reference, explained (``mismatches``, ``judge.explain``).  With
    ``every_query``, one answer of each query served is judged in place
    of the configuration's sample."""
    if bench.stream is not None:
        return _check_live(bench, calls, seed, control, explain,
                           every_query)
    c, cfg = bench.corpus, bench.cfg
    chk = cfg["check"]
    numbers = {"missing": judge.missing(calls),
               "inputs_changed": int(corpus_mod.checksum(c) != bench.sums)}
    ans = judge.sample(calls, *_sample_size(chk, calls, every_query), seed)
    ref, inv = judge.reference_of(c, cfg, ans.pool_idx, forest=bench.forest)
    numbers.update(judge.compare(c, cfg, ans, ref, inv))
    out = {"program": numbers}
    if control:
        ctl = judge.control_answers(c, cfg, ans.pool_idx,
                                    forest=bench.forest)
        out["control"] = judge.compare(c, cfg, ctl, ref, inv)
    if explain:
        out["mismatches"] = judge.explain(c, cfg, ans, ref, inv)
    return out


def _sample_size(chk: dict, calls, every_query: bool):
    if every_query:
        n = np.unique(np.concatenate([x.pool_idx for x in calls])).shape[0]
        return n, n
    return chk["sample"], chk["longest"]


def _check_live(bench: Bench, calls, seed: int, control: bool,
                explain: bool, every_query: bool) -> dict:
    """:func:`check` for a live cell, after :meth:`Bench.release`: the
    corpus made again from the seed (its checksum and the tensors the
    harness kept against set-up's), the stream's mutations regenerated
    from its log, the schedule replayed, every answer held to the
    stream, and the sample judged against ``reference/ivf_live.py``."""
    kept, cfg, mix = bench.corpus, bench.cfg, bench.cell.traffic
    dev = kept.pool.device
    c = corpus_mod.make(cfg, mix["pool"], seed, dev)
    same = all(torch.equal(getattr(kept, f), getattr(c, f)) for f in
               ("centroids", "offsets", "sizes", "pool", "scale"))
    bench.corpus = c
    numbers = {"missing": judge.missing(calls),
               "inputs_changed": int(corpus_mod.checksum(c) != bench.sums
                                     or not same)}
    ov, plant_id, plant_row = mutations.overlay(
        bench.stream.log, c.centroids, c.scale, c.pool)
    admits, numbers["schedule_mismatch"] = judge.schedule(calls, cfg)
    numbers.update(judge.held_to_stream(
        calls, admits, cfg, ov, plant_id.cpu().numpy(),
        plant_row.cpu().numpy()))
    ans = judge.sample(calls, *_sample_size(cfg["check"], calls,
                                            every_query), seed)
    ans.admit = np.array([admits[i][j] for i, j in ans.src], np.int64)
    ref, inv = judge.reference_of(c, cfg, ans.pool_idx, admit=ans.admit,
                                  overlay=ov)
    numbers.update(judge.compare(c, cfg, ans, ref, inv, ov))
    st = bench.stream
    numbers.update(mutation_waves=st.wave, merges=len(st.log.merges),
                   forced_merges=len(st.log.forced),
                   added=ov.vecs.shape[0],
                   deletes=int(sum(x.size for x in st.log.deleted)))
    out = {"program": numbers}
    if control:
        ctl = judge.control_answers(c, cfg, ans.pool_idx, admit=ans.admit,
                                    overlay=ov)
        out["control"] = judge.compare(c, cfg, ctl, ref, inv, ov)
    if explain:
        out["mismatches"] = judge.explain(c, cfg, ans, ref, inv, ov)
    return out


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool,
        dev: torch.device, t_start: float, age_at_start: float = 0.0
        ) -> dict:
    """One run; returns the result's line as a dict, ``checks`` last."""
    bench = setup(root, workload, seed, dev)
    cell, cfg, mix = bench.cell, bench.cfg, bench.cell.traffic
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = age_at_start + time.perf_counter() - t_start
    win = bench.load.window(seconds)
    note = host_note()
    served = sum(x.pool_idx.shape[0] for x in win.calls)
    log(f"window: {win.seconds:.3f} s, {len(win.calls)} calls, {served} "
        f"queries, {sum(x.report.waves for x in win.calls)} waves, "
        f"{sum(sum(x.report.probes.values()) for x in win.calls) / served:.4f}"
        f" probes a query; {note}")
    if bench.stream is not None:
        tot = {key: sum(x.mutations[key] for x in win.calls)
               for key in mutations.RECORD_KEYS}
        log("window's mutations: " + ", ".join(
            f"{key} {v:.3f}" if isinstance(v, float) else f"{key} {v}"
            for key, v in tot.items()))
    result_run = Run(mix["loop"], setup_s, win)
    if traced:
        tw, tr = trace.traced(
            lambda: bench.load.window(min(TRACE_SECONDS, seconds)),
            bench.sync)
        result_run.traced, result_run.trace = tw, tr
        log(f"traced window: {tr.window_s:.3f} s, busy {tr.busy_s:.6f} s, "
            f"{len(tw.calls)} calls, reduced in {tr.reduce_s:.3f} s")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    bench.release()
    calls = win.calls + (result_run.traced.calls if traced else [])

    # -- the check, once the windows have closed ---------------------------
    t = time.perf_counter()
    numbers = check(bench, calls, seed)["program"]
    if traced:
        result_run.bound_s = needed_bounds(bench.corpus, cfg,
                                           result_run.traced)
    log(f"check against the reference: {time.perf_counter() - t:.3f} s")

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = spec.reader(root, m["name"])(result_run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"attempted": sum(x.pool_idx.shape[0] for x in calls),
           "failed": numbers["missing"], "metrics": metrics,
           "device": device}
    if traced:
        tr = result_run.trace
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                            "idle_gaps": [list(x) for x in tr.idle_gaps]}
    limits = cfg["check"]["limits"]
    failing = judge.verdict(numbers, limits)
    out["correct"] = not failing
    for n in sorted(set(numbers) - set(limits)):
        log(f"printed only, {n}: {numbers[n]!r}")
    out["checks"] = {n: {"value": numbers.get(n), "limit": lim}
                     for n, lim in limits.items()}
    for n, lim in limits.items():
        log(f"check {n}: {numbers.get(n)!r} limit {lim!r}"
            + (" FAILS" if n in failing else ""))
    return {key: out[key] for key in ("correct", "attempted", "failed",
                                      "metrics", "device", "breakdown",
                                      "checks") if key in out}
