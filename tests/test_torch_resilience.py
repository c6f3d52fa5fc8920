"""Port parity for deadline-budgeted serving and shard retry: the
degradation ladder (``repro_torch.core.policies``), the deadline path of
``WaveScheduler``, ``RetryPolicy``/``run_waves``
(``repro_torch.runtime.straggler``), ``shard_index`` and
``search_with_retry`` (``repro_torch.core.distributed_ivf``) against
``repro``'s (tests/test_resilience.py).

Under a simulated clock the port's deadline serve equals the reference
``WaveScheduler(use_fused=False)`` in results, probes, degraded reasons,
latencies, waves and the wave-cost estimate, on the port's fused and
per-probe paths (the reference's fused path does not trace under this
JAX: ROADMAP Queue 3, R1); the reference tests' invariants hold on the
port's fused path.  The shard fan-out answers as the reference's: ids
equal, scores within 1e-5, every ``ShardRetryReport`` field equal.
JAX is imported in the ``ref`` fixture only.
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest
import torch

from repro_torch.core import brute_force, index_from_arrays, metrics
from repro_torch.core.distributed_ivf import (ShardFault, search_with_retry,
                                              shard_index)
from repro_torch.core.policies import (DEGRADE_REASONS, RUNG_CAP,
                                       RUNG_FORCE, RUNG_NONE, RUNG_TIGHTEN,
                                       DegradationLadder)
from repro_torch.core.serving import WaveScheduler
from repro_torch.runtime.chaos import SimClock
from repro_torch.runtime.straggler import RetryPolicy, run_waves

from test_torch_rebuild import PORT, _serve_with_rebuilder, _stream
from test_torch_wal import index_arrays

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores (their spin-waits then cost
    more than the ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference's resilience modules (JAX on the CPU)."""
    pytest.importorskip("jax")
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.core import build_index as jbuild
    from repro.core import distributed_ivf, policies
    from repro.core.serving import WaveScheduler as JScheduler
    from repro.index import (DriftTracker as JDrift,
                             IndexRegistry as JRegistry,
                             LiveIndex as JLive, MutationWAL as JWAL,
                             RebuildCrash as JCrash, Rebuilder as JRebuilder,
                             version_of as jversion_of)
    from repro.runtime import straggler
    return types.SimpleNamespace(
        policies=policies, dist=distributed_ivf, straggler=straggler,
        WaveScheduler=JScheduler, LiveIndex=JLive, MutationWAL=JWAL,
        CheckpointManager=JManager, IndexRegistry=JRegistry,
        version_of=jversion_of, Rebuilder=JRebuilder, RebuildCrash=JCrash,
        DriftTracker=JDrift, build_index=jbuild)


@pytest.fixture(scope="module")
def t_index(tiny_index):
    return index_from_arrays(*index_arrays(tiny_index), device="cpu")


@pytest.fixture(scope="module")
def exact(tiny_corpus):
    return brute_force(torch.as_tensor(tiny_corpus.docs),
                       torch.as_tensor(tiny_corpus.queries[:64]),
                       10)[1].numpy()


# -- degradation ladder -------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_ladder_rungs_and_throttle_match_reference(ref, seed):
    rng = np.random.default_rng(seed)
    kw = dict(tighten_at=float(rng.uniform(2, 5)),
              cap_at=float(rng.uniform(1, 2)),
              force_at=float(rng.uniform(-0.5, 0.5)),
              tight_delta=int(rng.integers(1, 4)),
              rebuild_pause_at=float(rng.uniform(2, 6)))
    got, want = DegradationLadder(**kw), ref.policies.DegradationLadder(**kw)
    for _ in range(20):
        remaining = rng.uniform(-5, 30, int(rng.integers(0, 64)))
        cost = float(rng.uniform(0.1, 8))
        np.testing.assert_array_equal(got.rungs(remaining, cost),
                                      want.rungs(remaining, cost))
        assert got.rungs(remaining, cost).dtype == np.int8
        assert got.throttle_rebuild(remaining, cost) \
            == want.throttle_rebuild(remaining, cost)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_ladder_constants_and_ordering_error_match_reference(ref):
    p = ref.policies
    assert (RUNG_NONE, RUNG_TIGHTEN, RUNG_CAP, RUNG_FORCE) \
        == (p.RUNG_NONE, p.RUNG_TIGHTEN, p.RUNG_CAP, p.RUNG_FORCE)
    assert DEGRADE_REASONS == p.DEGRADE_REASONS
    with pytest.raises(ValueError) as got:
        DegradationLadder(tighten_at=1.0, cap_at=2.0)
    with pytest.raises(ValueError) as want:
        p.DegradationLadder(tighten_at=1.0, cap_at=2.0)
    assert str(got.value) == str(want.value)


# -- deadline-budgeted serving --------------------------------------------------

_CFG = dict(wave_size=16, k=10, n_probe=16, delta=3, phi=90.0)


def _deadline_serve(cls, index, queries, deadline, chunk, wave_ms=2.0,
                    **kw):
    clock = SimClock()
    ws = cls(index, chunk=chunk, deadline_ms=deadline, clock=clock, **_CFG,
             **kw)
    return ws.serve(queries, on_wave=lambda w: clock.advance(wave_ms))


def _assert_same_report(got, want):
    assert sorted(got.results) == sorted(want.results)
    for qid in want.results:
        np.testing.assert_array_equal(got.results[qid], want.results[qid],
                                      err_msg=f"query {qid}")
        assert got.probes[qid] == want.probes[qid], qid
    assert got.degraded == want.degraded
    assert got.latency_ms == want.latency_ms
    for f in ("waves", "wave_cost_ms", "deadline_ms", "lane_steps",
              "degraded_fraction"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.shed_ids() == want.shed_ids()


@pytest.fixture(scope="module")
def reference_deadline_reports(ref, tiny_index, tiny_corpus):
    q = tiny_corpus.queries[:64]
    return {(dl, chunk): _deadline_serve(ref.WaveScheduler, tiny_index, q,
                                         dl, chunk, use_fused=False)
            for dl, chunk in itertools.product((1.0, 5.0, 8.0, None),
                                               (1, 4))}


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "per_probe"])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("deadline", [1.0, 5.0, 8.0, None])
def test_deadline_serve_matches_reference(t_index, tiny_corpus,
                                          reference_deadline_reports,
                                          deadline, chunk, use_fused):
    want = reference_deadline_reports[(deadline, chunk)]
    got = _deadline_serve(WaveScheduler, t_index, tiny_corpus.queries[:64],
                          deadline, chunk, use_fused=use_fused)
    _assert_same_report(got, want)
    if deadline is None:
        assert got.degraded == {} and got.deadline_ms is None
    else:
        assert got.degraded


@pytest.fixture(scope="module")
def served(t_index, tiny_corpus):
    """The reference test's serve on the port's fused path: a 5 ms
    budget, 2 ms simulated waves, chunk 1."""
    rep = _deadline_serve(WaveScheduler, t_index, tiny_corpus.queries[:64],
                          5.0, 1)
    return rep, tiny_corpus.queries[:64]


def test_deadline_invariants_on_the_fused_path(served):
    rep, queries = served
    assert set(rep.results) == set(range(queries.shape[0]))
    assert rep.deadline_ms == 5.0
    # overshoot bounded by one wave (chunk 1 => one probe's worth)
    for qid, lat in rep.latency_ms.items():
        assert lat <= rep.deadline_ms + 2.0 + 1e-9, (qid, lat)
    assert rep.degraded, "a tight deadline must degrade some queries"
    for qid, reason in rep.degraded.items():
        assert reason in DEGRADE_REASONS and qid in rep.results
    for qid, lat in rep.latency_ms.items():
        if lat > rep.deadline_ms:
            assert qid in rep.degraded
    assert 0.0 < rep.degraded_fraction <= 1.0


def test_no_deadline_no_degradation(t_index, tiny_corpus):
    rep = WaveScheduler(t_index, chunk=4, **_CFG).serve(
        tiny_corpus.queries[:32])
    assert rep.degraded == {} and rep.deadline_ms is None
    assert rep.degraded_fraction == 0.0 and rep.shed_ids() == []


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "per_probe"])
def test_deadline_sheds_admissions_when_hopeless(ref, t_index, tiny_index,
                                                 tiny_corpus, use_fused):
    """4 ms waves under a 1 ms budget shed admissions: all -1 rows, 0
    probes, every query once; the same report as the reference's."""
    q = tiny_corpus.queries[:32]
    kw = dict(wave_size=4, chunk=1, k=10, n_probe=16, delta=3, phi=90.0,
              deadline_ms=1.0)

    def serve(cls, index, **extra):
        clock = SimClock()
        return cls(index, clock=clock, **kw, **extra).serve(
            q, on_wave=lambda w: clock.advance(4.0))

    rep = serve(WaveScheduler, t_index, use_fused=use_fused)
    shed = rep.shed_ids()
    assert shed, "4 ms waves under a 1 ms budget must shed"
    for qid in shed:
        assert rep.degraded[qid] == "shed"
        assert np.all(rep.results[qid] == -1) and rep.probes[qid] == 0
    assert set(rep.results) == set(range(32))
    _assert_same_report(rep, serve(ref.WaveScheduler, tiny_index,
                                   use_fused=False))


def test_deadline_recall_monotone_on_the_fused_path(t_index, tiny_corpus,
                                                    exact):
    recalls = []
    for dl in (2.0, 8.0, None):
        rep = _deadline_serve(WaveScheduler, t_index,
                              tiny_corpus.queries[:64], dl, 1, wave_ms=1.0)
        ids = np.stack([rep.results[i] for i in range(64)])
        recalls.append(metrics.r_star_at_k(ids, exact))
    assert recalls[0] <= recalls[1] + 1e-9 <= recalls[2] + 2e-9


# -- the rebuild throttle -------------------------------------------------------


def _ticking_clock(step):
    """A clock that moves ``step`` ms at every read: both schedulers read
    it at the same points, so their budgets match read for read."""
    t = itertools.count()
    return lambda: step * next(t)


@pytest.fixture(scope="module")
def small(ref, tiny_corpus):
    docs = tiny_corpus.docs[:2000]
    jindex = ref.build_index(docs, 16, list_pad=256, n_iters=3, seed=0)
    return types.SimpleNamespace(
        docs=docs, queries_long=tiny_corpus.queries[:96], jindex=jindex,
        tindex=index_from_arrays(*index_arrays(jindex), device="cpu"))


@pytest.mark.parametrize("deadline", [6.0, 8.0])
def test_rebuild_throttle_matches_reference(ref, small, tmp_path, deadline):
    """One scripted live serve with a rebuild requested after wave 1,
    under a deadline: the same throttled and run ticks, epoch swaps and
    answers as the reference's ``use_fused=False`` serve."""
    batches = _stream(small.docs)
    want = _serve_with_rebuilder(ref, small, tmp_path / "ref", batches,
                                 use_fused=False, deadline_ms=deadline,
                                 clock=_ticking_clock(1.0))[0]
    got = _serve_with_rebuilder(PORT, small, tmp_path / "port", batches,
                                deadline_ms=deadline,
                                clock=_ticking_clock(1.0))[0]
    _assert_same_report(got, want)
    for f in ("rebuild_ticks", "rebuild_throttled", "epoch_swaps",
              "drain_waves"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.rebuild_throttled > 0 and got.rebuild_ticks > 0


# -- retry policy and the straggler simulation -----------------------------------


def test_retry_policy_schedules_match_reference(ref):
    for kw in (dict(max_retries=5, base_ms=1.0, multiplier=2.0, max_ms=6.0),
               dict(max_retries=4, base_ms=1.0, max_ms=8.0,
                    jitter="decorrelated"),
               dict(max_retries=3, base_ms=0.5, multiplier=3.0,
                    budget_ms=10.0)):
        got, want = RetryPolicy(**kw), ref.straggler.RetryPolicy(**kw)
        assert [got.backoff_ms(a) for a in range(6)] \
            == [want.backoff_ms(a) for a in range(6)]
        r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
        p1 = p2 = 0.0
        for a in range(6):
            p1 = got.next_backoff(a, p1, r1)
            p2 = want.next_backoff(a, p2, r2)
            assert p1 == p2
    for bad in (dict(max_retries=-1), dict(multiplier=0.5),
                dict(jitter="gaussian"), dict(budget_ms=0.0)):
        with pytest.raises(ValueError) as got:
            RetryPolicy(**bad)
        with pytest.raises(ValueError) as want:
            ref.straggler.RetryPolicy(**bad)
        assert str(got.value) == str(want.value)


def test_run_waves_matches_reference(ref):
    def lat(rng, shard):
        return float(rng.exponential(20.0)) + (60.0 if shard == 3 else 0.0)

    for kw in (dict(deadline_ms=50, wave_size=32, seed=0),
               dict(deadline_ms=30, wave_size=4, seed=5, max_waves=20)):
        got = run_waves(500, 4, lat, **kw)
        want = ref.straggler.run_waves(500, 4, lat, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- shard retry ------------------------------------------------------------------


@pytest.fixture(scope="module")
def shards(ref, t_index, tiny_index):
    return shard_index(t_index, 4), ref.dist.shard_index(tiny_index, 4)


def test_shard_index_matches_reference(shards):
    got, want = shards
    for f in ("centroids", "docs", "doc_ids", "offsets", "sizes"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.list_pad, got.n_shards) == (want.list_pad, want.n_shards)
    assert want.doc_scales is None


def _flaky(shard_id, times, fault_cls=ShardFault):
    left = {"n": times}

    def hook(shard, attempt):
        if shard == shard_id and left["n"] > 0:
            left["n"] -= 1
            raise fault_cls(f"flaky shard {shard}")
    return hook


def _dead(shard_id, fault_cls=ShardFault):
    def hook(shard, attempt):
        if shard_id is None or shard == shard_id:
            raise fault_cls(f"shard {shard} is gone")
    return hook


# name -> (retry kwargs, fault hook factory given a ShardFault class,
# rng seed)
_CASES = {
    "clean": (None, None, None),
    "flaky": (dict(max_retries=3, base_ms=1.0, multiplier=2.0),
              lambda f: _flaky(1, 2, f), None),
    "dead_shard": (dict(max_retries=2, base_ms=0.5),
                   lambda f: _dead(0, f), None),
    "budget": (dict(max_retries=3, base_ms=4.0, multiplier=2.0,
                    budget_ms=10.0), lambda f: _dead(None, f), None),
    "jitter": (dict(max_retries=4, base_ms=1.0, max_ms=8.0,
                    jitter="decorrelated", budget_ms=50.0),
               lambda f: _flaky(2, 3, f), 11),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_search_with_retry_matches_reference(ref, shards, tiny_corpus,
                                             case):
    got_sh, want_sh = shards
    retry_kw, hook, seed = _CASES[case]
    q = tiny_corpus.queries[:16]

    def run(fn, sh, policy_cls, fault_cls, **kw):
        slept = []
        s, i, rep = fn(
            sh, q, k=10, n_probe=16,
            retry=None if retry_kw is None else policy_cls(**retry_kw),
            fault=None if hook is None else hook(fault_cls),
            sleep=slept.append,
            rng=None if seed is None else np.random.default_rng(seed), **kw)
        return np.asarray(s), np.asarray(i), rep, slept

    gs, gi, grep, gslept = run(search_with_retry, got_sh, RetryPolicy,
                               ShardFault, device="cpu")
    ws, wi, wrep, wslept = run(ref.dist.search_with_retry, want_sh,
                               ref.straggler.RetryPolicy,
                               ref.dist.ShardFault)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=ATOL)
    assert dataclasses.asdict(grep) == dataclasses.asdict(wrep)
    assert gslept == wslept
    assert gi.shape == (16, 10) and gi.dtype == np.int32
    if case == "flaky":
        assert grep.retries == 2 and gslept == [1.0, 2.0]
    if case == "dead_shard":
        assert grep.skipped_shards == [0] and grep.lost_clusters > 0
        assert (gi >= 0).all()
    if case == "budget":
        assert grep.budget_exhausted and grep.budget_skips > 0
        assert sum(gslept) == pytest.approx(10.0)
        assert grep.skipped_shards == [0, 1, 2, 3]


def test_flaky_shard_answers_as_the_clean_run(shards, tiny_corpus):
    sh = shards[0]
    q = tiny_corpus.queries[:16]
    s0, i0, rep0 = search_with_retry(sh, q, k=10, n_probe=16, device="cpu")
    assert rep0.retries == 0 and not rep0.skipped_shards
    s1, i1, _ = search_with_retry(
        sh, q, k=10, n_probe=16, fault=_flaky(1, 2),
        retry=RetryPolicy(max_retries=3), sleep=lambda ms: None,
        device="cpu")
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(s1, s0)


def test_a_failed_launch_propagates_and_is_never_a_skipped_shard(shards,
                                                                  tiny_corpus):
    """Only ShardFault and TimeoutError are retried: a RuntimeError (what
    a failed kernel launch raises) reaches the caller."""
    def launch_failure(shard, attempt):
        if shard == 2:
            raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        search_with_retry(shards[0], tiny_corpus.queries[:4], k=10,
                          n_probe=16, fault=launch_failure,
                          sleep=lambda ms: None, device="cpu")

    def timeout(shard, attempt):
        if shard == 2 and attempt == 0:
            raise TimeoutError("slow shard")

    _, _, rep = search_with_retry(shards[0], tiny_corpus.queries[:4], k=10,
                                  n_probe=16, fault=timeout,
                                  sleep=lambda ms: None, device="cpu")
    assert rep.retries == 1 and not rep.skipped_shards


def test_serve_cli_reports_the_deadline_summary(capsys):
    """``--deadline-ms`` on the real clock: the static summary gains the
    degraded fraction and the wave-cost estimate, and the live row
    counts the rebuild ticks run and throttled."""
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--n-docs", "3000", "--dim", "16",
                      "--clusters", "24", "--queries", "48", "--n-probe",
                      "12", "--k", "10", "--delta", "3", "--wave-size", "16",
                      "--deadline-ms", "0.5", "--mutation-rate", "8",
                      "--merge-every", "4", "--delta-cap", "256",
                      "--rebuild-every", "2"])
    assert "'degraded_fraction':" in capsys.readouterr().out
    assert 0.0 < out["degraded_fraction"] <= 1.0
    assert out["wave_cost_ms"] > 0.0
    assert out["rebuild_ticks"] + out["rebuild_throttled"] > 0


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_pair():
    """One small corpus indexed on the CPU, and the same index on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    from repro_torch.core import build_index
    from repro_torch.data.synthetic import clustered_corpus

    c = clustered_corpus(n_docs=4000, dim=24, n_components=32,
                         n_queries=64, seed=7)
    cpu = build_index(c.docs, 32, list_pad=256, n_iters=3, device="cpu")
    return c, {"cpu": cpu, "cuda": index_from_arrays(*index_arrays(cpu),
                                                     device="cuda")}


@pytest.mark.gpu
@pytest.mark.parametrize("deadline", [2.0, 5.0, None])
def test_gpu_deadline_serve_fused_equals_pair_and_the_cpu(cuda_pair,
                                                          deadline):
    """On the card the fused serve and the per-probe kernel pair give one
    report bit for bit, and it is the CPU's (the kernels sum in another
    order than the plain versions; the ids, probes and budgets agree)."""
    c, index = cuda_pair
    reps = {(dev, fused): _deadline_serve(WaveScheduler, index[dev],
                                          c.queries, deadline, 4,
                                          use_fused=fused)
            for dev in ("cuda", "cpu") for fused in (True, False)}
    _assert_same_report(reps[("cuda", False)], reps[("cuda", True)])
    _assert_same_report(reps[("cuda", True)], reps[("cpu", True)])


@pytest.mark.gpu
def test_gpu_search_with_retry_matches_the_cpu(cuda_pair):
    c, index = cuda_pair
    sh = shard_index(index["cpu"], 4)
    got = search_with_retry(sh, c.queries, k=10, n_probe=16,
                            fault=_flaky(1, 2), sleep=lambda ms: None,
                            device="cuda")
    want = search_with_retry(sh, c.queries, k=10, n_probe=16,
                             fault=_flaky(1, 2), sleep=lambda ms: None,
                             device="cpu")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    np.testing.assert_array_equal(shard_index(index["cuda"], 4).docs,
                                  sh.docs)
