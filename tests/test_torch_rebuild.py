"""Port parity for background re-clustering (``repro_torch.index.rebuild``):
the two-phase rebuild publish, WAL catch-up, epoch fencing, the drift
trigger, crash recovery at every protocol boundary, and
``WaveScheduler(rebuilder=)`` and the ``--rebuild-every`` CLI row,
against ``repro``'s (tests/test_rebuild.py).

Inside the port, recovery after a crash at any failpoint is bit-identical
to the no-rebuild state (a crash before COMMIT) or to the rebuilt state
(at COMMIT or after), on every search path.  Across packages the
rebuild candidate from the same snapshot has the same assignments and
layout, its centroids within 1e-6; ``DriftTracker.ratio`` agrees at
rtol 1e-5; a serve with a rebuilder answers alike (the reference side
runs ``use_fused=False``: its fused path does not trace under this JAX,
ROADMAP Queue 3, R1).

The gpu cases run on the card without JAX:
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_rebuild.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import build_index, index_from_arrays, search
from repro_torch.core.serving import WaveScheduler
from repro_torch.data.synthetic import clustered_corpus
from repro_torch.index import (DriftTracker, IndexRegistry, LiveIndex,
                               MutationWAL, RebuildCrash, Rebuilder,
                               StaleEpochError, version_of)
from repro_torch.index.rebuild import (FAILPOINTS, STAGES, first_come_keep,
                                       mean_nearest_sq_dist)
from repro_torch.launch import serve

from test_torch_wal import (assert_bit_same, assert_same_state, index_arrays,
                            results)

PORT = types.SimpleNamespace(
    LiveIndex=LiveIndex, MutationWAL=MutationWAL,
    CheckpointManager=CheckpointManager, IndexRegistry=IndexRegistry,
    version_of=version_of, Rebuilder=Rebuilder, RebuildCrash=RebuildCrash,
    WaveScheduler=WaveScheduler, DriftTracker=DriftTracker)


@pytest.fixture(scope="module")
def ref():
    """The reference's rebuild pipeline (JAX on the CPU)."""
    pytest.importorskip("jax")
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.core import build_index as jbuild
    from repro.core.serving import WaveScheduler as JScheduler
    from repro.index import (DriftTracker as JDrift,
                             IndexRegistry as JRegistry,
                             LiveIndex as JLive, MutationWAL as JWAL,
                             RebuildCrash as JCrash, Rebuilder as JRebuilder,
                             version_of as jversion_of)
    return types.SimpleNamespace(
        LiveIndex=JLive, MutationWAL=JWAL, CheckpointManager=JManager,
        IndexRegistry=JRegistry, version_of=jversion_of,
        Rebuilder=JRebuilder, RebuildCrash=JCrash, WaveScheduler=JScheduler,
        DriftTracker=JDrift, build_index=jbuild)


@pytest.fixture(scope="module")
def small(ref, tiny_corpus):
    docs = tiny_corpus.docs[:2000]
    jindex = ref.build_index(docs, 16, list_pad=256, n_iters=3, seed=0)
    return types.SimpleNamespace(
        docs=docs, queries=tiny_corpus.queries[:32],
        queries_long=tiny_corpus.queries[:96], jindex=jindex,
        tindex=index_from_arrays(*index_arrays(jindex), device="cpu"))


def _index_of(pkg, small):
    return small.tindex if pkg is PORT else small.jindex


def _mutate(live, rng, docs, added, n=6):
    """The reference tests' churn: n noisy doc copies in, the newest out."""
    vecs = (docs[rng.integers(0, len(docs), n)]
            + rng.normal(scale=0.05, size=(n, docs.shape[1]))
            ).astype(np.float32)
    added.extend(int(i) for i in live.add(vecs))
    live.delete([added.pop()])


def _wal_setup(pkg, index, workdir):
    workdir.mkdir()
    wal = pkg.MutationWAL(str(workdir / "wal.log"))
    live = pkg.LiveIndex(index, delta_cap=512, wal=wal)
    mgr = pkg.CheckpointManager(str(workdir / "snaps"), async_save=False)
    reg = pkg.IndexRegistry(pkg.version_of(live))
    reg.save(mgr)
    wal.note_durable(live.seq)
    return wal, live, mgr, reg


def _recover(pkg, mgr, wal):
    kw = {"device": "cpu"} if pkg is PORT else {}
    return pkg.IndexRegistry.recover(mgr, wal, **kw)


# -- the spill rule and the drift statistic ------------------------------------


@pytest.mark.parametrize("list_pad", [1, 3, 64])
def test_spill_rule_equals_the_first_come_loop(list_pad):
    """The tensor rule keeps exactly the entries the reference's host
    loop keeps, on a skewed assignment."""
    rng = np.random.default_rng(list_pad)
    assign = np.minimum(rng.zipf(1.3, 5000) - 1, 39).astype(np.int32)
    rng.shuffle(assign)
    fill, want = np.zeros(40, np.int64), np.ones(assign.size, bool)
    for i, cl in enumerate(assign):
        if fill[cl] >= list_pad:
            want[i] = False
        else:
            fill[cl] += 1
    got = first_come_keep(torch.as_tensor(assign), 40, list_pad).numpy()
    assert (~want).sum() > 0
    np.testing.assert_array_equal(got, want)


def _drift_inputs():
    rng = np.random.default_rng(4)
    cents = rng.normal(size=(8, 16)).astype(np.float32)
    near = (cents[rng.integers(0, 8, 256)]
            + rng.normal(scale=0.05, size=(256, 16))).astype(np.float32)
    return cents, near


def test_drift_ratio_matches_reference(ref):
    cents, near = _drift_inputs()
    far = (near[:64] + 10.0).astype(np.float32)
    trackers = [pkg.DriftTracker(cents, near, ema=0.5, threshold=1.5,
                                 **kw) for pkg, kw in
                ((ref, {}), (PORT, {"device": "cpu"}))]
    for batch in (near[:64], near[64:128], far, far, far):
        got, want = (tr.observe(batch) for tr in trackers[::-1])
        assert got == pytest.approx(want, rel=1e-5)
        assert trackers[1].triggered == trackers[0].triggered
    assert trackers[1].triggered
    for vecs in (far, near):                  # in blocks of 100 rows too
        want = ref.DriftTracker._mean_dist(vecs, cents)
        for block in (100, 4096):
            assert mean_nearest_sq_dist(
                torch.as_tensor(vecs), torch.as_tensor(cents),
                block=block) == pytest.approx(want, rel=1e-5)


def test_drift_tracker_triggers_and_rebases():
    cents, near = _drift_inputs()
    tr = DriftTracker(cents, near, ema=0.5, threshold=1.5, device="cpu")
    assert tr.observe(near[:64]) == pytest.approx(1.0, rel=0.5)
    assert not tr.triggered
    far = (near[:64] + 10.0).astype(np.float32)
    for _ in range(4):
        tr.observe(far)
    assert tr.ratio > 1.5 and tr.triggered
    tr.rebase(cents + 10.0)                    # rebuilt onto the drift
    assert tr.ratio == 0.0 and not tr.triggered
    with pytest.raises(ValueError):
        DriftTracker(cents, ema=1.0, device="cpu")


# -- the pipeline --------------------------------------------------------------


class _Static:
    """Adapter: search a LiveIndex's from-scratch re-layout."""

    def __init__(self, live):
        self._idx = live.rebuild_equivalent()
        self.device = live.device

    def search(self, q, pol, **kw):
        return search(self._idx, q, pol, **kw)


def test_in_memory_rebuild_bumps_epoch_and_stays_equivalent(small):
    rng = np.random.default_rng(0)
    live = LiveIndex(small.tindex, delta_cap=512)
    added = []
    for _ in range(3):
        _mutate(live, rng, small.docs, added)
    live.merge_delta()
    _mutate(live, rng, small.docs, added)
    before_ids = set(int(i) for i in live.net_corpus()[1])
    rb = Rebuilder(live, n_iters=2)
    rep = rb.run_once("test")
    new = rb.live
    assert rep is not None and rep.epoch == 1 and new.epoch == 1
    assert rep.corpus == len(before_ids) and rep.reason == "test"
    assert rb.epochs_published == 1 and not rb.active
    assert set(int(i) for i in new.net_corpus()[1]) == before_ids
    for kw in ({}, dict(use_scan_kernel=True, use_topk_kernel=True),
               dict(use_fused_kernel=True, chunk=4)):
        for got, want in zip(results(new, small.queries, **kw),
                             results(_Static(new), small.queries, **kw)):
            np.testing.assert_array_equal(got, want)


def _catchup_drill(pkg, small, workdir, crowd):
    """A rebuild with mutations landing after its ``begin`` and
    ``catchup`` stages, on an index whose cluster 0 was crowded past
    list_pad (so the layout spills).  Returns the rebuilder, the stages
    it ran, the old handle, the WAL, manager and registry."""
    wal, live, mgr, reg = _wal_setup(pkg, _index_of(pkg, small), workdir)
    rng = np.random.default_rng(1)
    added = []
    live.add(crowd)
    _mutate(live, rng, small.docs, added)
    reg.publish(pkg.version_of(live))
    rb = pkg.Rebuilder(live, reg, mgr, n_iters=2)
    assert rb.request("drill") and not rb.request("dup")
    stages, snaps = [], {}
    while rb.active:
        stage = rb.tick()
        stages.append(stage)
        if stage == "retrain":
            snaps["centroids"] = np.array(rb._new_centroids)
            snaps["assign"] = np.array(rb._assign)
        if stage in ("begin", "catchup"):
            _mutate(live, rng, small.docs, added)
            reg.publish(pkg.version_of(live))
    return rb, stages, snaps, live, wal, mgr, reg


def test_candidate_and_catchup_match_reference(ref, small, tmp_path):
    """The same snapshot and mutations: the port's retrain gives the
    reference's assignments and centroids (within 1e-6), its layout,
    spill and catch-up the reference's candidate; the publish compacts
    the log; the promoted snapshot recovers to the serving candidate."""
    c0 = np.asarray(small.jindex.centroids)[0]
    crowd = (c0[None, :] + np.random.default_rng(3).normal(
        scale=1e-3, size=(300, c0.size))).astype(np.float32)
    drills = {name: _catchup_drill(pkg, small, tmp_path / name, crowd)
              for name, pkg in (("jax", ref), ("torch", PORT))}
    (jrb, jst, jsn, *_), (rb, st, sn, live, wal, mgr, reg) = \
        drills["jax"], drills["torch"]
    assert st == jst == list(STAGES)
    np.testing.assert_array_equal(sn["assign"], jsn["assign"])
    np.testing.assert_allclose(sn["centroids"], jsn["centroids"], rtol=0,
                               atol=1e-6)
    rep, jrep = rb.last_report, jrb.last_report
    for f in ("epoch", "fence_seq", "corpus", "spilled", "caught_up",
              "moved", "step", "published_version"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert rep.spilled > 0 and rep.caught_up >= 4
    assert_same_state(rb.live, jrb.live, "candidate", centroid_atol=1e-6)
    assert reg.current().epoch == 1 and rep.step in mgr.all_steps()
    assert wal.scan() == []                    # compacted past cand.seq
    assert set(int(i) for i in rb.live.net_corpus()[1]) \
        == set(int(i) for i in live.net_corpus()[1])
    _, recovered, _ = _recover(PORT, mgr, wal)
    assert recovered.epoch == 1
    assert_same_state(recovered, rb.live)
    assert_bit_same(recovered, rb.live, small.queries)
    for d in drills.values():
        d[4].close()


# -- crash boundaries -----------------------------------------------------------


def _crash_drill(pkg, index, docs, workdir, failpoint):
    wal, live, mgr, reg = _wal_setup(pkg, index, workdir)
    rng = np.random.default_rng(2)
    added = []
    _mutate(live, rng, docs, added)
    rb = pkg.Rebuilder(live, reg, mgr, n_iters=2, failpoint=failpoint)
    rb.request("crash-test")
    try:
        while rb.active:
            if rb.tick() == "begin":
                _mutate(live, rng, docs, added)
    except pkg.RebuildCrash:
        pass
    return wal, live, mgr, rb


@pytest.mark.parametrize("fp", FAILPOINTS)
def test_crash_at_every_rebuild_boundary_recovers(ref, small, tmp_path, fp):
    """A crash before COMMIT recovers to the no-rebuild state, at COMMIT
    or after to the rebuilt state, bit for bit on every path, twice
    (idempotence), and to the state JAX recovers from the same drill."""
    wal, live, mgr, _ = _crash_drill(PORT, small.tindex, small.docs,
                                     tmp_path / "crash", fp)
    _, recovered, rep = _recover(PORT, mgr, wal)
    committed = recovered.epoch > 0
    assert committed == (fp in ("commit", "promote"))
    if committed:
        owal, _, _, orb = _crash_drill(PORT, small.tindex, small.docs,
                                       tmp_path / "oracle", None)
        oracle = orb.live
        owal.close()
    else:
        assert rep.rebuild_aborted
        oracle = live            # only the Rebuilder crashed
    assert_same_state(recovered, oracle, fp)
    assert_bit_same(recovered, oracle, small.queries)
    _, again, _ = _recover(PORT, mgr, wal)
    assert again.epoch == recovered.epoch
    assert_bit_same(again, recovered, small.queries)
    jwal, _, jmgr, _ = _crash_drill(ref, small.jindex, small.docs,
                                    tmp_path / "jax", fp)
    _, jrec, jrep = ref.IndexRegistry.recover(jmgr, jwal)
    assert (jrep.rebuild_aborted, jrep.rebuild_promoted) \
        == (rep.rebuild_aborted, rep.rebuild_promoted)
    assert_same_state(recovered, jrec, f"{fp} vs reference",
                      centroid_atol=1e-6)
    wal.close()
    jwal.close()


# -- epoch fencing, no manager, empty corpus -----------------------------------


def test_stale_epoch_publish_is_fenced(small):
    live = LiveIndex(small.tindex, delta_cap=512)
    reg = IndexRegistry(version_of(live))
    rb = Rebuilder(live, reg, n_iters=2)
    rb.run_once("fence-test")
    assert reg.current().epoch == 1
    with pytest.raises(StaleEpochError):
        reg.publish(version_of(live))          # stale epoch-0 handle
    assert reg.current().epoch == 1            # no clobber
    new = rb.live
    new.add(small.docs[:4])
    v1 = reg.publish(version_of(new))
    v2 = reg.publish(version_of(new))          # same version: bumped
    assert v2.epoch == v1.epoch == 1 and v2.version > v1.version


def test_rebuild_without_manager_closes_epoch_on_log(small, tmp_path):
    wal = MutationWAL(str(tmp_path / "nomgr.log"))
    live = LiveIndex(small.tindex, delta_cap=512, wal=wal)
    added = []
    _mutate(live, np.random.default_rng(3), small.docs, added)
    rb = Rebuilder(live, n_iters=2)
    rb.run_once("no-mgr")
    assert rb.live.epoch == 1                  # in-memory swap happened
    assert wal.open_epoch_fences() == []       # ...but the log is closed
    mgr = CheckpointManager(str(tmp_path / "snaps"), async_save=False)
    IndexRegistry(version_of(LiveIndex(small.tindex, delta_cap=512))
                  ).save(mgr)
    _, recovered, rep = _recover(PORT, mgr, wal)
    assert recovered.epoch == 0 and rep.applied >= 2
    assert set(int(i) for i in recovered.net_corpus()[1]) \
        == set(int(i) for i in rb.live.net_corpus()[1])
    assert_same_state(recovered, live)
    wal.close()


def test_in_memory_rebuild_refuses_unlogged_mutations(small):
    live = LiveIndex(small.tindex, delta_cap=512)
    rb = Rebuilder(live, n_iters=2)
    rb.request("no-wal")
    rb.tick()
    live.add(small.docs[:2])
    with pytest.raises(RuntimeError, match="no WAL"):
        while rb.active:
            rb.tick()
    assert not rb.active


def test_empty_corpus_rebuild_is_safe():
    rng = np.random.default_rng(5)
    docs = rng.normal(size=(256, 8)).astype(np.float32)
    idx = build_index(docs, 4, list_pad=128, n_iters=2, seed=0,
                      device="cpu")
    live = LiveIndex(idx, delta_cap=128)
    live.delete(np.arange(256))
    rb = Rebuilder(live, n_iters=2)
    rep = rb.run_once("empty")
    assert rep.corpus == 0 and rb.live.epoch == 1 and rb.live.n_live == 0
    assert torch.equal(rb.live.index.centroids, live.index.centroids)


# -- serving with a rebuilder --------------------------------------------------


def _stream(docs):
    """One precomputed mutation stream: a batch of 6 noisy doc copies a
    wave; the newest add of each batch is deleted again."""
    rng = np.random.default_rng(6)
    return [(docs[rng.integers(0, len(docs), 6)]
             + rng.normal(scale=0.05, size=(6, docs.shape[1]))
             ).astype(np.float32) for _ in range(64)]


def _serve_with_rebuilder(pkg, small, workdir, batches, **ws_kw):
    wal, live, mgr, reg = _wal_setup(pkg, _index_of(pkg, small), workdir)
    handle = {"live": live}       # on_publish rebinds the mutation stream

    def on_publish(new_live, report):
        handle["live"] = new_live

    rb = pkg.Rebuilder(live, reg, mgr, n_iters=2, on_publish=on_publish)
    ws = pkg.WaveScheduler(_index_of(pkg, small), wave_size=8, chunk=4,
                           k=10, n_probe=16, delta=2, phi=90.0,
                           registry=reg, rebuilder=rb, **ws_kw)

    def on_wave(wave):
        ids = handle["live"].add(batches[wave - 1])
        handle["live"].delete([int(ids[-1])])
        reg.publish(pkg.version_of(handle["live"]))
        if wave == 1:
            rb.request("mid-stream")

    rep = ws.serve(small.queries_long, compact=True, on_wave=on_wave)
    wal.close()
    return rep, rb, handle["live"], reg


@pytest.fixture(scope="module")
def reference_rebuild_serve(ref, small, tmp_path_factory):
    return _serve_with_rebuilder(ref, small,
                                 tmp_path_factory.mktemp("ref") / "run",
                                 _stream(small.docs), use_fused=False)


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "per_probe"])
def test_serve_with_rebuilder_matches_reference(small, tmp_path,
                                                reference_rebuild_serve,
                                                use_fused):
    """A rebuild requested after wave 1 runs one stage a wave, publishes
    a higher epoch mid-stream and is adopted after the lanes drain: the
    same results, probes, waves, epoch swaps, drain waves and rebuild
    ticks as the reference, and the same final live index."""
    want, jrb, jlive, jreg = reference_rebuild_serve
    rep, rb, live, reg = _serve_with_rebuilder(
        PORT, small, tmp_path / "port", _stream(small.docs),
        use_fused=use_fused)
    nq = len(small.queries_long)
    assert sorted(rep.results) == list(range(nq))
    for qid in range(nq):
        np.testing.assert_array_equal(rep.results[qid], want.results[qid],
                                      err_msg=f"query {qid}")
        assert rep.probes[qid] == want.probes[qid], qid
    for f in ("waves", "epoch_swaps", "drain_waves", "rebuild_ticks",
              "rebuild_throttled"):
        assert getattr(rep, f) == getattr(want, f), f
    assert rep.epoch_swaps == 1 and rep.rebuild_ticks >= len(STAGES)
    assert rep.rebuild_throttled == 0
    assert rb.epochs_published == jrb.epochs_published == 1
    assert reg.current().epoch == jreg.current().epoch == 1
    assert_same_state(live, jlive, "final live index", centroid_atol=1e-6)


def test_serve_cli_prints_the_rebuild_row(capsys):
    out = serve.main(["--device", "cpu", "--n-docs", "4000", "--dim", "24",
                      "--clusters", "32", "--queries", "64", "--n-probe",
                      "16", "--k", "10", "--delta", "3", "--wave-size", "32",
                      "--mutation-rate", "8", "--merge-every", "4",
                      "--delta-cap", "256", "--rebuild-every", "2"])
    assert "'rebuilds':" in capsys.readouterr().out
    # the reference CLI's live row with --rebuild-every
    assert {"mode", "mutation_rate", "merge_every", "adds", "deletes",
            "merges", "versions", "swaps", "delta_occupancy",
            "recall_static", "recall_live", "recall_gap", "latency_ms",
            "mean_probes", "rebuilds", "epoch", "epoch_swaps",
            "drain_waves", "rebuild_ticks", "rebuild_throttled"} <= out.keys()
    assert "drift_ratio" not in out
    assert out["rebuilds"] >= 1 and out["epoch"] == out["rebuilds"]
    assert out["epoch_swaps"] >= 1 and out["rebuild_throttled"] == 0
    assert out["recall_gap"] <= 0.01


def test_serve_cli_drift_trigger(capsys):
    out = serve.main(["--device", "cpu", "--n-docs", "4000", "--dim", "24",
                      "--clusters", "32", "--queries", "64", "--n-probe",
                      "16", "--k", "10", "--delta", "3", "--wave-size", "32",
                      "--mutation-rate", "8", "--merge-every", "4",
                      "--delta-cap", "256", "--rebuild-drift", "0.5"])
    assert out["rebuilds"] >= 1 and "drift_ratio" in out


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_small():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    c = clustered_corpus(n_docs=2000, dim=24, n_components=16,
                         n_queries=32, seed=7)
    return types.SimpleNamespace(
        docs=c.docs, queries=c.queries,
        index=build_index(c.docs, 16, list_pad=256, n_iters=3,
                          device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("fp", FAILPOINTS)
def test_gpu_crash_at_every_rebuild_boundary_recovers(cuda_small, tmp_path,
                                                      fp):
    """The crash drill on the card: recovery bit for bit on every path
    (the fused kernel, the kernel pair, the per-probe loop)."""
    s = cuda_small
    wal, live, mgr, _ = _crash_drill(PORT, s.index, s.docs,
                                     tmp_path / "crash", fp)
    _, recovered, rep = IndexRegistry.recover(mgr, wal)
    assert recovered.index.docs.device.type == "cuda"
    if fp in ("commit", "promote"):
        owal, _, _, orb = _crash_drill(PORT, s.index, s.docs,
                                       tmp_path / "oracle", None)
        oracle = orb.live
        owal.close()
    else:
        assert rep.rebuild_aborted
        oracle = live
    assert recovered.epoch == oracle.epoch
    assert_same_state(recovered, oracle, fp)
    assert_bit_same(recovered, oracle, s.queries)
    wal.close()


@pytest.mark.gpu
def test_gpu_spill_rule_and_drift_match_the_cpu(cuda_small):
    rng = np.random.default_rng(0)
    assign = np.minimum(rng.zipf(1.3, 100_000) - 1, 999).astype(np.int32)
    keep = first_come_keep(torch.as_tensor(assign, device="cuda"), 1000, 7)
    np.testing.assert_array_equal(
        keep.cpu().numpy(), first_come_keep(torch.as_tensor(assign), 1000,
                                            7).numpy())
    cents, near = _drift_inputs()
    far = near + np.float32(3.0)
    got = DriftTracker(cents, near, device="cuda")
    want = DriftTracker(cents, near, device="cpu")
    assert got.observe(far) == pytest.approx(want.observe(far), rel=1e-5)
