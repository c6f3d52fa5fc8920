"""Port parity for wave serving: the port's ``WaveScheduler`` (fused and
per-probe) against the reference ``WaveScheduler(use_fused=False)`` on
the same index, query by query.  (The reference's fused path does not
trace under this JAX: ROADMAP Queue 3, R1.)  A scheduler that serves a
registry frees the index it was built on once a merge replaces it.  The
host's copy of the lanes after each admission is the device's, and a
report's answers outlive the next serve() on its scheduler."""
import dataclasses
import gc

import numpy as np
import pytest
from torch.multiprocessing.reductions import StorageWeakRef

from repro.core.serving import WaveScheduler as JWaveScheduler
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import index_from_arrays, search, serving
from repro_torch.core.policies import patience
from repro_torch.core.serving import WaveScheduler
from repro_torch.index import (IndexRegistry, LiveIndex, MutationWAL,
                               Rebuilder, version_of)

_CFG = dict(wave_size=32, chunk=4, k=10, n_probe=24, delta=3, phi=90.0)


@pytest.fixture(scope="module")
def t_index(tiny_index):
    return index_from_arrays(
        np.asarray(tiny_index.centroids), np.asarray(tiny_index.docs),
        np.asarray(tiny_index.doc_ids),
        np.asarray(tiny_index.cluster_offsets),
        np.asarray(tiny_index.cluster_sizes), tiny_index.list_pad,
        device="cpu")


@pytest.fixture(scope="module")
def reference_report(tiny_index, tiny_corpus):
    ws = JWaveScheduler(tiny_index, use_fused=False, **_CFG)
    return ws.serve(tiny_corpus.queries[:100])


@pytest.mark.parametrize("use_fused", [True, False])
def test_wave_scheduler_matches_reference(t_index, tiny_corpus,
                                          reference_report, use_fused):
    rep = WaveScheduler(t_index, use_fused=use_fused, **_CFG).serve(
        tiny_corpus.queries[:100])
    assert sorted(rep.results) == list(range(100))
    for qid in range(100):
        np.testing.assert_array_equal(rep.results[qid],
                                      reference_report.results[qid],
                                      err_msg=f"query {qid}")
        assert rep.probes[qid] == reference_report.probes[qid], qid
    assert rep.waves == reference_report.waves
    assert rep.lane_steps == reference_report.lane_steps
    assert rep.occupancy == pytest.approx(reference_report.occupancy)


def test_compaction_improves_occupancy(t_index, tiny_corpus):
    ws = WaveScheduler(t_index, **_CFG)
    with_c = ws.serve(tiny_corpus.queries[:128], compact=True)
    without = ws.serve(tiny_corpus.queries[:128], compact=False)
    assert with_c.occupancy > without.occupancy
    assert with_c.lane_steps <= without.lane_steps
    for qid in range(128):
        np.testing.assert_array_equal(with_c.results[qid],
                                      without.results[qid])


def test_registry_scheduler_keeps_no_construction_index(t_index,
                                                        tiny_corpus):
    """Built on a registry, the scheduler holds no reference to its
    construction index: once a merge is published and one wave served,
    nothing of the program holds the base documents' storage."""
    live = LiveIndex(dataclasses.replace(t_index, docs=t_index.docs.clone()),
                     delta_cap=256)
    base = StorageWeakRef(live.index.docs.untyped_storage())
    reg = IndexRegistry(version_of(live))
    ws = WaveScheduler(live.index, registry=reg, **_CFG)
    merged_at = []

    def hook(wave):
        if not merged_at:
            live.add(tiny_corpus.docs[:8] + np.float32(0.01))
            live.merge_delta()
            merged_at.append(wave)
        reg.publish(version_of(live))

    rep = ws.serve(tiny_corpus.queries[:100], on_wave=hook)
    assert merged_at == [1] and rep.waves >= 2
    gc.collect()
    assert base.expired()


# -- the host's copy of the lanes ---------------------------------------------


class _Clock:
    """A ms clock that moves 0.25 ms at every read; the hook moves it a
    wave's time, and once 8 ms, so that the wave-cost EMA passes the
    budget for a while and the scheduler sheds."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t

    def hook(self, wave):
        self.t += 8.0 if wave == 4 else 1.0


def _noisy(docs, rng, n):
    return (docs[rng.integers(0, len(docs), n)]
            + rng.normal(scale=0.05, size=(n, docs.shape[1]))
            ).astype(np.float32)


def _serve_static(index, corpus, use_fused, workdir):
    return WaveScheduler(index, use_fused=use_fused, **_CFG).serve(
        corpus.queries[:100])


def _serve_small_batch(index, corpus, use_fused, workdir):
    """20 queries for 32 free lanes, one admission of them all."""
    rep = WaveScheduler(index, use_fused=use_fused, **_CFG).serve(
        corpus.queries[:20], compact=False)
    assert len(rep.results) == 20
    return rep


def _serve_deadline(index, corpus, use_fused, workdir):
    clock = _Clock()
    rep = WaveScheduler(index, use_fused=use_fused, deadline_ms=4.0,
                        clock=clock, **_CFG).serve(corpus.queries[:160],
                                                   on_wave=clock.hook)
    reasons = set(rep.degraded.values())
    assert {"forced_exit", "shed", "capped_probes"} <= reasons
    return rep


def _serve_registry(index, corpus, use_fused, workdir):
    """Adds, deletes and a merge every third wave; from wave 3 on the
    versions carry a higher epoch, which the scheduler drains for."""
    live = LiveIndex(dataclasses.replace(index, docs=index.docs.clone()),
                     delta_cap=256)
    reg = IndexRegistry(version_of(live))
    rng = np.random.default_rng(3)

    def hook(wave):
        live.add(_noisy(corpus.docs, rng, 6))
        live.delete(rng.integers(0, len(corpus.docs), 2))
        if wave % 3 == 0:
            live.merge_delta()
        if wave >= 3:
            live.epoch = 1
        reg.publish(version_of(live))

    rep = WaveScheduler(live.index, use_fused=use_fused, registry=reg,
                        **_CFG).serve(corpus.queries[:120], on_wave=hook)
    assert rep.epoch_swaps == 1 and rep.drain_waves > 0
    return rep


def _serve_rebuilder(index, corpus, use_fused, workdir):
    wal = MutationWAL(str(workdir / "wal.log"))
    live = LiveIndex(dataclasses.replace(index, docs=index.docs.clone()),
                     delta_cap=512, wal=wal)
    mgr = CheckpointManager(str(workdir / "snaps"), async_save=False)
    reg = IndexRegistry(version_of(live))
    reg.save(mgr)
    wal.note_durable(live.seq)
    handle = {"live": live}
    rb = Rebuilder(live, reg, mgr, n_iters=2,
                   on_publish=lambda new, report: handle.update(live=new))
    rng = np.random.default_rng(6)

    def hook(wave):
        ids = handle["live"].add(_noisy(corpus.docs, rng, 6))
        handle["live"].delete([int(ids[-1])])
        reg.publish(version_of(handle["live"]))
        if wave == 1:
            rb.request("mid-stream")

    rep = WaveScheduler(live.index, use_fused=use_fused, registry=reg,
                        rebuilder=rb, **dict(_CFG, wave_size=8)).serve(
                            corpus.queries[:96], on_wave=hook)
    wal.close()
    assert rep.rebuild_ticks > 0 and rep.epoch_swaps == 1
    return rep


@pytest.mark.parametrize("serve", [_serve_static, _serve_small_batch,
                                   _serve_deadline, _serve_registry,
                                   _serve_rebuilder],
                         ids=["static", "small_batch", "deadline",
                              "registry", "rebuilder"])
@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "per_probe"])
def test_host_admission_mirror_is_the_device_state(t_index, tiny_corpus,
                                                   tmp_path, monkeypatch,
                                                   serve, use_fused):
    """The scheduler derives each admission's active mask and the lanes'
    qids from ``_admit``'s rule instead of reading them back: after every
    admission they are the device's, read here by a wrapped ``_admit``."""
    device, host = [], []
    admit, admit_queued = serving._admit, WaveScheduler._admit_queued

    def read_admit(*args):
        state = admit(*args)
        device.append((state.lanes.active.cpu().numpy(),
                       state.qid.cpu().numpy()))
        return state

    def mirror(self, call, *args):
        n = len(device)
        state, admitted = admit_queued(self, call, *args)
        if len(device) > n:
            host.append((admitted.copy(), call.lane_qid.copy()))
        return state, admitted

    monkeypatch.setattr(serving, "_admit", read_admit)
    monkeypatch.setattr(WaveScheduler, "_admit_queued", mirror)
    rep = serve(t_index, tiny_corpus, use_fused, tmp_path)
    assert len(rep.results) > 0
    assert len(device) == len(host) >= 1
    for i, ((act, qid), (h_act, h_qid)) in enumerate(zip(device, host)):
        np.testing.assert_array_equal(h_act, act, err_msg=f"admission {i}")
        np.testing.assert_array_equal(h_qid, qid, err_msg=f"admission {i}")


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "per_probe"])
def test_answers_outlive_the_next_serve(t_index, tiny_corpus, use_fused):
    """Every row of a report's ``results``, and its ``probes``, stay the
    query's answer after a second serve() of other queries on the same
    scheduler: the answers share no buffer a later wave reuses."""
    q = tiny_corpus.queries[:64]
    want = search(t_index, q, patience(_CFG["n_probe"], delta=_CFG["delta"],
                                       phi=_CFG["phi"], k=_CFG["k"]))
    ws = WaveScheduler(t_index, use_fused=use_fused,
                       **dict(_CFG, wave_size=8))
    first = ws.serve(q)
    ws.serve(tiny_corpus.queries[64:192])
    assert first.waves >= 16
    assert sorted(first.results) == list(range(64))
    np.testing.assert_array_equal(np.stack(list(map(first.results.get,
                                                    range(64)))),
                                  want.topk_ids.numpy())
    assert list(map(first.probes.get, range(64))) == want.probes.tolist()
