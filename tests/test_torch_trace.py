"""The serving loop's spans and host-read counter (``repro_torch.trace``,
``WaveScheduler.serve``): the spans a profiler records and how they
nest, ``ServeReport.host_syncs`` against the spans and a hand count,
the same answers with the profiler on and off, and no span entered
with it off; the live write path's spans under a hook, and
``ServeReport.hook_ms``; a cascade serve's ``serve.tau`` spans and
``ServeReport.tau_ms``.  On the card (``-m gpu``): the fused serve
blocks once a harvest and waits once for each harvest's exits.

The gpu case runs on the card without JAX:
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_trace.py``.
"""
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.trace
from repro_torch.core import serving
from repro_torch.core.ivf import build_index
from repro_torch.core.serving import WaveScheduler
from repro_torch.data.synthetic import clustered_corpus
from repro_torch.index import IndexRegistry, LiveIndex, version_of
from repro_torch.runtime.chaos import SimClock

PHASES = ("serve.harvest", "serve.admit", "serve.advance", "serve.answer")
LIVE_SPANS = ("serve.hook", "live.add", "live.delete", "live.merge",
              "live.merge.layout", "live.merge.mirrors", "registry.publish")
_CFG = dict(wave_size=16, chunk=4, k=10, n_probe=16, delta=3, phi=90.0)


@pytest.fixture(scope="module")
def corpus():
    return clustered_corpus(n_docs=2000, dim=16, n_queries=48, seed=3)


@pytest.fixture(scope="module")
def index(corpus):
    return build_index(corpus.docs, 32, list_pad=128, n_iters=3,
                       device="cpu")


def _serves(index, queries, deadline):
    """Two serve() calls; under a deadline, on a simulated clock whose
    2 ms waves make the ladder read lane state and force exits."""
    clock = SimClock()
    ws = WaveScheduler(index, deadline_ms=deadline, clock=clock, **_CFG)
    return [ws.serve(q, on_wave=lambda w: clock.advance(2.0))
            for q in (queries[:40], queries[8:20])]


def _spans(prof, prefixes=("serve",)):
    """(name, start_ns, end_ns) of every span the host recorded whose
    name starts with one of ``prefixes``."""
    return sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation()
                  and e.name().startswith(prefixes))


def _innermost_parent(spans, i):
    """The name of the innermost other span that holds span ``i``."""
    _, s, e = spans[i]
    holders = [(s0, n) for j, (n, s0, e0) in enumerate(spans)
               if j != i and s0 <= s and e <= e0]
    return max(holders)[1] if holders else None


@pytest.mark.parametrize("deadline", [None, 5.0])
def test_spans_nest_and_count_the_host_reads(index, corpus, deadline):
    q = corpus.queries
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reps = _serves(index, q, deadline)
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    assert set(names) == {"serve", "serve.sync", "serve.hook", *PHASES}
    assert names.count("serve") == len(reps)
    waves = sum(r.waves for r in reps)
    assert names.count("serve.advance") == waves
    assert names.count("serve.hook") == waves
    # one harvest a wave, and the last one that finds every lane idle
    assert names.count("serve.harvest") == waves + len(reps)
    assert names.count("serve.sync") == sum(r.host_syncs for r in reps)
    if deadline is None:
        # one read of active a harvest, one wait a harvest's exits
        assert names.count("serve.answer") == sum(
            r.host_syncs for r in reps) - names.count("serve.harvest")
    for i, (n, _, _) in enumerate(spans):
        parent = _innermost_parent(spans, i)
        if n == "serve":
            assert parent is None
        elif n == "serve.sync":
            assert parent in ("serve", *PHASES)
        else:
            assert parent == "serve"
    if deadline is not None:
        assert any(r.degraded for r in reps)
        # the ladder's reads lie directly inside serve
        assert any(_innermost_parent(spans, i) == "serve"
                   and spans[i][0] == "serve.sync"
                   for i in range(len(spans)))


@pytest.mark.parametrize("lanes,n_queries,waves,syncs", [
    # one read of active a harvest (each wave's and the last) and one
    # wait for the copy of each harvest's exits; admission's active mask
    # and the lanes' qids are derived on the host, not read.  One lane's
    # query needs two 4-probe waves: harvest, admit, advance; harvest,
    # advance; harvest (it exited), wait: active, active, active+wait
    (4, 1, 2, 4),
    # two lanes, four queries of two waves each: the second pair is
    # admitted in the wave that harvests the first.  Five harvests read
    # active; the 3rd and the 5th find two exits each: 5 reads, 2 waits
    (2, 4, 4, 7),
])
def test_host_syncs_equal_a_hand_count(index, corpus, lanes, n_queries,
                                       waves, syncs):
    ws = WaveScheduler(index, wave_size=lanes, chunk=4, k=10, n_probe=8,
                       delta=100, phi=90.0)
    rep = ws.serve(corpus.queries[:n_queries])
    assert rep.waves == waves and set(rep.probes.values()) == {8}
    assert rep.host_syncs == syncs
    assert rep.sync_wait_ms >= 0.0


@pytest.mark.parametrize("deadline", [None, 5.0])
def test_same_answers_with_the_profiler_on_and_off(index, corpus,
                                                   deadline):
    off = _serves(index, corpus.queries, deadline)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _serves(index, corpus.queries, deadline)
    for a, b in zip(off, on):
        assert sorted(a.results) == sorted(b.results)
        for qid in a.results:
            np.testing.assert_array_equal(a.results[qid], b.results[qid])
        assert a.probes == b.probes and a.degraded == b.degraded
        assert (a.waves, a.lane_steps, a.host_syncs) \
            == (b.waves, b.lane_steps, b.host_syncs)


def test_no_span_is_entered_without_a_profiler(index, corpus,
                                               monkeypatch):
    def entered(name):
        raise AssertionError(f"span {name} entered with no profiler")

    monkeypatch.setattr(repro_torch.trace, "record_function", entered)
    reps = _serves(index, corpus.queries, 5.0)
    assert all(r.host_syncs > 0 for r in reps)
    with pytest.raises(AssertionError, match="span serve entered"):
        with profile(activities=[ProfilerActivity.CPU]):
            _serves(index, corpus.queries, None)


def _live_serve(index, corpus):
    """One serve() of a live index through a registry, its hook adding
    4 documents and deleting 2 after every wave and merging after every
    second."""
    live = LiveIndex(index, delta_cap=256)
    reg = IndexRegistry(version_of(live))
    ws = WaveScheduler(index, registry=reg, **_CFG)
    rng = np.random.default_rng(4)

    def hook(wave):
        live.add(corpus.docs[rng.integers(0, 2000, 4)] + np.float32(1e-3))
        live.delete(rng.integers(0, 2000, 2))
        if wave % 2 == 0:
            live.merge_delta()
        reg.publish(version_of(live))

    return ws.serve(corpus.queries[:40], on_wave=hook)


def test_live_serve_records_the_write_path_spans(index, corpus):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep = _live_serve(index, corpus)
    spans = _spans(prof, ("serve", "live", "registry"))
    names = [n for n, _, _ in spans]
    assert set(LIVE_SPANS) <= set(names)
    assert rep.waves >= 2
    for n in ("serve.hook", "live.add", "live.delete"):
        assert names.count(n) == rep.waves, n
    for n in ("live.merge", "live.merge.layout", "live.merge.mirrors"):
        assert names.count(n) == rep.waves // 2, n
    # the registry's first version, then one a wave
    assert names.count("registry.publish") == rep.waves + 1
    for i, (n, _, _) in enumerate(spans):
        parent = _innermost_parent(spans, i)
        if n in ("live.merge.layout", "live.merge.mirrors"):
            assert parent == "live.merge"
        elif n in ("live.add", "live.delete", "live.merge"):
            assert parent == "serve.hook"
        elif n == "serve.hook":
            assert parent == "serve"


def test_hook_ms_sums_the_hook(index, corpus):
    """0.0 without a hook; with one, at least the time it sleeps."""
    ws = WaveScheduler(index, **_CFG)
    assert ws.serve(corpus.queries[:40]).hook_ms == 0.0
    rep = ws.serve(corpus.queries[:40], on_wave=lambda w: time.sleep(0.002))
    assert rep.hook_ms >= 2.0 * rep.waves
    assert _live_serve(index, corpus).hook_ms > 0.0


def _exit_all(device="cpu"):
    """A forest of one leaf whose margin says Exit to every query."""
    from repro_torch.trees.torch_infer import ensemble_from_arrays
    return ensemble_from_arrays([[-1]], [[0.0]], [[0]], [[0]], [[5.0]], 0.0,
                                1, device=device)


@pytest.mark.parametrize("learned", [True, False],
                         ids=["cascade", "patience"])
def test_cascade_serve_records_tau_spans(index, corpus, learned):
    """A cascade serve holds one ``serve.tau`` span inside each
    ``serve.advance`` and sums their host ms in ``tau_ms``; a patience
    serve holds none and reads 0."""
    from repro_torch.core.policies import cascade_patience, patience
    pol = cascade_patience(_CFG["n_probe"], _exit_all(), _CFG["delta"],
                           _CFG["phi"], k=_CFG["k"], tau=4) if learned \
        else patience(_CFG["n_probe"], _CFG["delta"], _CFG["phi"],
                      k=_CFG["k"])
    ws = WaveScheduler(index, policy=pol, **_CFG)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep = ws.serve(corpus.queries[:40])
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    if not learned:
        assert "serve.tau" not in names
        assert rep.tau_ms == 0.0 and rep.clf_exits == 0
        return
    assert names.count("serve.tau") == names.count("serve.advance") \
        == rep.waves
    for i, (n, _, _) in enumerate(spans):
        if n == "serve.tau":
            assert _innermost_parent(spans, i) == "serve.advance"
    assert rep.tau_ms > 0.0
    assert set(rep.probes.values()) == {4} and rep.clf_exits == 40


@pytest.mark.gpu
def test_gpu_fused_serve_blocks_once_a_harvest(corpus, monkeypatch):
    """On the card the fused serve answers as the per-probe path, and a
    report outlives the next serve() on its scheduler, whose reads reuse
    pinned host memory.  Without a deadline the host waits once a
    harvest, for ``active``, and once for each harvest's exits, each
    time on the event behind a copy to pinned memory: CUDA's sync debug
    mode finds no synchronising call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    index = build_index(corpus.docs, 32, list_pad=128, n_iters=3,
                        device="cuda")
    q = torch.as_tensor(corpus.queries, device="cuda")
    cfg = dict(_CFG, wave_size=8)
    staged = []
    stage = serving._Call.stage_exits

    def counted(call, *args):
        staged.append(1)
        return stage(call, *args)

    monkeypatch.setattr(serving._Call, "stage_exits", counted)
    ws = WaveScheduler(index, **cfg)
    ws.serve(q[:8])                                     # warm up
    staged.clear()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            first = ws.serve(q[:32])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncing = [w for w in caught
               if "called a synchronizing" in str(w.message)]
    assert first.waves >= 8 and len(staged) >= first.waves // 2
    assert syncing == []
    assert first.host_syncs == first.waves + 1 + len(staged)
    ws.serve(q[32:])
    want = WaveScheduler(index, use_fused=False, **cfg).serve(q[:32])
    assert first.waves == want.waves
    assert first.probes == want.probes
    for qid in range(32):
        np.testing.assert_array_equal(first.results[qid], want.results[qid],
                                      err_msg=f"query {qid}")
