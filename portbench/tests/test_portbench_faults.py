"""``correct`` comes out false: for each fault a served IVF cell can
have, planted under the timed path of a whole run (all of it but the
look for a card), and for the control, the reference in TF32 put in
the program's place.  A one-chip cell has no exchange between chips to
leave out."""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import corpus, harness, judge

from conftest import REPO, TINY, TINY_LIVE


def _run(root):
    return harness.run(root, "t-bulk", 2**31 + 901, 0.5, False,
                       torch.device("cpu"), time.perf_counter())


def test_sound_run_is_correct(tiny_root):
    assert _run(tiny_root)["correct"] is True


def test_state_returned_unchanged(tiny_root, monkeypatch):
    """The fused kernel hands back the running top-k for every slot."""
    from repro_torch.kernels import ops

    def unchanged(queries, docs, doc_ids, offsets, sizes, run_scores,
                  run_ids, *a, k, list_pad, chunk, **kw):
        b = queries.shape[0]
        return (run_scores[:, None].expand(b, chunk, k).clone(),
                run_ids[:, None].expand(b, chunk, k).clone(),
                torch.zeros(b, chunk, dtype=torch.int32))

    monkeypatch.setattr(ops, "ivf_scan_merge", unchanged)
    out = _run(tiny_root)
    assert out["correct"] is False
    assert out["checks"]["gap_share_pct"]["value"] == 100.0


def test_half_of_the_batch_left_out(tiny_root, monkeypatch):
    """serve() answers the first half of its queries only."""
    from repro_torch.core.serving import WaveScheduler
    serve = WaveScheduler.serve

    def half(self, queries, **kw):
        return serve(self, queries[: max(1, queries.shape[0] // 2)], **kw)

    monkeypatch.setattr(WaveScheduler, "serve", half)
    out = _run(tiny_root)
    assert out["correct"] is False
    assert out["checks"]["missing"]["value"] > 0


def test_answer_altered_where_it_is_produced(tiny_root, monkeypatch):
    """The fused kernel's best id of every slot names another document."""
    from repro_torch.kernels import ops
    real = ops.ivf_scan_merge

    def altered(*a, **kw):
        s, i, c = real(*a, **kw)
        i = i.clone()
        i[:, :, 0] = torch.where(i[:, :, 0] >= 0, (i[:, :, 0] + 1) % 3000,
                                 i[:, :, 0])
        return s, i, c

    monkeypatch.setattr(ops, "ivf_scan_merge", altered)
    out = _run(tiny_root)
    assert out["correct"] is False
    assert out["checks"]["gap_share_pct"]["value"] > 50


def test_exit_one_probe_late(tiny_root, monkeypatch):
    """The patience counter's threshold off by one."""
    from repro_torch.core import serving
    real = serving.WaveScheduler.__init__

    def late(self, index, **kw):
        real(self, index, **dict(kw, delta=kw["delta"] + 1))

    monkeypatch.setattr(serving.WaveScheduler, "__init__", late)
    out = _run(tiny_root)
    assert out["correct"] is False
    assert out["checks"]["exit_mismatch_pct"]["value"] > 50


def test_setup_refuses_lists_that_are_no_partition(tiny_root):
    """At a noise that files a third of the documents away from their
    nearest centre, set-up stops before any run."""
    cfg = dict(TINY, corpus=dict(TINY["corpus"], spread_at_64=0.25))
    (tiny_root / "portbench" / "configs" / "tiny.json").write_text(
        json.dumps(cfg))
    with pytest.raises(RuntimeError, match="no IVF partition"):
        _run(tiny_root)


def _explained(root, seed, every_query=False):
    bench = harness.setup(root, "t-bulk", seed, torch.device("cpu"))
    win = bench.load.window(0.3)
    return harness.check(bench, win.calls, seed, explain=True,
                         every_query=every_query)


def test_explain_names_each_probe_mismatch(tiny_root, monkeypatch):
    """Exits one probe late: every sampled answer is explained, one probe
    past the reference's exit, with the reference's kept counts from
    Delta + 1 probes before that exit."""
    from repro_torch.core import serving
    real = serving.WaveScheduler.__init__

    def late(self, index, **kw):
        real(self, index, **dict(kw, delta=kw["delta"] + 1))

    monkeypatch.setattr(serving.WaveScheduler, "__init__", late)
    res = _explained(tiny_root, 2**31 + 903)
    mm = res["mismatches"]
    assert mm and res["program"]["probe_mismatch_pct"] > 50
    for m in mm:
        if m["program_probes"] < TINY["n_probe"]:
            assert m["program_probes"] == m["reference_probes"] + 1
        lo = max(0, m["reference_probes"] - TINY["patience_delta"] - 1)
        assert m["kept_from_probe"] == lo
        assert len(m["reference_kept"]) == m["program_probes"] - lo
        assert m["score_gap"] == 0.0


def test_explain_names_each_short_answer(tiny_root, monkeypatch):
    """The best id of every slot altered: with every query judged once,
    each query served is explained, short of its top-k, but those whose
    altered id repeats another (``invalid``, not scored)."""
    from repro_torch.kernels import ops
    real = ops.ivf_scan_merge

    def altered(*a, **kw):
        s, i, c = real(*a, **kw)
        i = i.clone()
        i[:, :, 0] = torch.where(i[:, :, 0] >= 0, (i[:, :, 0] + 1) % 3000,
                                 i[:, :, 0])
        return s, i, c

    monkeypatch.setattr(ops, "ivf_scan_merge", altered)
    res = _explained(tiny_root, 2**31 + 905, every_query=True)
    short = [m for m in res["mismatches"]
             if m["score_gap"] > TINY["check"]["gap_tol"]]
    assert res["program"]["gap_share_pct"] == 100.0
    assert len(short) == len(res["mismatches"]) \
        == 256 - res["program"]["invalid"] > 200


def test_sound_mismatches_are_near_ties(tiny_root):
    """The program's own departures from the reference, where it has
    any, part where the float64 reference sees a tie within ``tie_tol``;
    so its ``exit_mismatch_pct`` is 0."""
    for seed in (5, 6, 7):
        res = _explained(tiny_root, seed, every_query=True)
        assert res["program"]["exit_mismatch_pct"] == 0.0
        for m in res["mismatches"]:
            assert m["tied"], m


def test_sample_takes_the_longest_distinct_queries():
    """Five calls of the same ten queries (query j takes j + 1 probes):
    the four longest are four distinct queries, the rest uniform."""
    calls = [SimpleNamespace(pool_idx=np.arange(10), report=SimpleNamespace(
        results={j: [j] for j in range(10)},
        probes={j: j + 1 for j in range(10)})) for _ in range(5)]
    ans = judge.sample(calls, 12, 4, 3)
    assert ans.pool_idx[:4].tolist() == [9, 8, 7, 6]
    assert ans.pool_idx.shape == (12,) and ans.probes.tolist()[:4] == [
        10, 9, 8, 7]


def test_control_fails_the_star_limits():
    """The TF32 control at msmarco-star's widths (d 768, k 100, N 80,
    patience 7/95), cut to 1,024 lists and 1,024 queries, fails the
    configuration's limits; on the card it fails them at the cell's own
    size on every seed read (PERF.md)."""
    cfg = json.loads((REPO / "portbench" / "configs"
                      / "msmarco-star.json").read_text())
    cfg = dict(cfg, n_lists=1024, n_docs=1024 * 8841823 // 65536)
    c = corpus.make(cfg, 1024, 1, "cpu")
    idx = np.arange(1024)
    ref, inv = judge.reference_of(c, cfg, idx)
    ctl = judge.control_answers(c, cfg, idx)
    numbers = judge.compare(c, cfg, ctl, ref, inv)
    # the answer-by-answer limits (missing and inputs_changed are the
    # run's)
    limits = {n: v for n, v in cfg["check"]["limits"].items()
              if n in numbers}
    assert set(limits) == {"invalid", "exit_mismatch_pct",
                           "gap_share_pct"}
    assert "gap_share_pct" in judge.verdict(numbers, limits), numbers
    # and the reference in the program's place passes them
    own = judge.Answers(idx, ref.ids[torch.arange(1024), ref.probes - 1]
                        .numpy(), ref.probes.numpy())
    assert not judge.verdict(judge.compare(c, cfg, own, ref, inv), limits)


def _live_run(root, seconds=1.0):
    return harness.run(root, "t-live", 2**31 + 907, seconds, False,
                       torch.device("cpu"), time.perf_counter())


def _failing(out):
    return sorted(n for n, c in out["checks"].items()
                  if not c["value"] <= c["limit"])


def test_live_sound_run_is_correct(tiny_root):
    assert _failing(_live_run(tiny_root)) == []


def test_scheduler_without_the_registry(tiny_root, monkeypatch):
    """The scheduler serves the index it was built over and never adopts
    a published version: it misses the plants and returns deleted ids.
    Its answers then fall short of the live reference as well (a missed
    plant is a shortfall at rank 1), but its schedule is sound."""
    from repro_torch.core import serving
    real = serving.WaveScheduler.__init__

    def frozen(self, index, **kw):
        real(self, index, **dict(kw, registry=None))

    monkeypatch.setattr(serving.WaveScheduler, "__init__", frozen)
    out = _live_run(tiny_root)
    fails = _failing(out)
    assert {"acked_add_missed", "deleted_returned"} <= set(fails)
    assert "schedule_mismatch" not in fails


def test_tampered_probe_count(tiny_root, monkeypatch):
    """One answer of one call of the window reports a wave fewer of
    probes, where that ends its call a wave earlier by the admission
    rule: only the schedule fails (one answer in over 400 is under the
    exit limit's share)."""
    from portbench import drive
    from repro_torch.core.serving import WaveScheduler
    serve, window = WaveScheduler.serve, drive.Load.window
    chunk = TINY_LIVE["chunk"]
    tampered, started = [], []

    def tamper(self, queries, **kw):
        rep = serve(self, queries, **kw)
        if not started or tampered:
            return rep
        n = queries.shape[0]
        p = np.array([rep.probes[j] for j in range(n)])
        admit, waves = judge.replay(p, self.w, chunk)
        for j in np.argsort(-(admit + -(-p // chunk)), kind="stable"):
            if p[j] <= chunk:
                continue
            q = p.copy()
            q[j] -= chunk
            if judge.replay(q, self.w, chunk)[1] != waves:
                rep.probes[int(j)] = int(q[j])
                tampered.append(int(j))
                break
        return rep

    def in_window(self, seconds):
        started.append(True)
        return window(self, seconds)

    monkeypatch.setattr(WaveScheduler, "serve", tamper)
    monkeypatch.setattr(drive.Load, "window", in_window)
    out = _live_run(tiny_root)
    assert len(tampered) == 1 and out["attempted"] > 400
    assert _failing(out) == ["schedule_mismatch"]
    assert out["checks"]["schedule_mismatch"]["value"] == 1
