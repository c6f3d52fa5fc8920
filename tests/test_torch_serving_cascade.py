"""The wave scheduler under a learned exit policy: ``WaveScheduler(
policy=...)`` against the program's fused ``search`` under the same
policy and chunk, bit for bit, over lanes of different ages sharing a
wave; against the benchmark's plain cascade reference
(``portbench/reference/ivf_cascade.py``) but for the ties its judge
names; the edges of the stage at ``tau``; the policies and knobs the
scheduler refuses; and the reads a cascade serve makes.

The exit trees come from the benchmark's own trainer
(``portbench/policy.py``) on a tiny corpus made from a seed, as
``portbench/tests/test_portbench_cascade.py`` makes them."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import corpus as corpus_mod  # noqa: E402
from portbench import harness, judge, policy  # noqa: E402
from repro_torch.core import serving  # noqa: E402
from repro_torch.core.ivf import IVFIndex, search  # noqa: E402
from repro_torch.core.policies import (cascade_patience,  # noqa: E402
                                       cascade_regression, classifier,
                                       patience, regression)
from repro_torch.core.serving import WaveScheduler  # noqa: E402
from repro_torch.index import IndexRegistry, LiveIndex, version_of  # noqa
from repro_torch.trees.torch_infer import predict_margin  # noqa: E402

CPU = torch.device("cpu")
# a tiny deployment whose queries' best documents lie at many probe
# ranks, so the classifier exits some at tau and patience stops the rest
TINY = {
    "name": "tiny-cascade", "n_docs": 3000, "dim": 32,
    "metric": "inner_product", "n_lists": 64, "list_pad": 64, "align": 64,
    "n_probe": 16, "k": 10, "patience_delta": 3, "patience_phi": 90.0,
    "wave_size": 16, "chunk": 4,
    "corpus": {"spread_at_64": 0.3, "scale_range": [0.5, 1.5],
               "list_size_sigma": 0.35, "list_size_min": 1},
    "queries": {"hard_frac": 0.8, "easy_noise": 0.15},
    "reference": "portbench/reference/ivf_cascade.py",
    "check": {"sample": 4096, "longest": 32, "gap_tol": 1e-5,
              "tie_tol": 1e-6, "tree_tol": 1e-5,
              "limits": {"missing": 0, "inputs_changed": 0, "invalid": 0,
                         "exit_mismatch_pct": 0.25, "gap_share_pct": 0.2}},
    "policy": {"kind": "cascade_patience", "tau": 4, "clf_threshold": 0.5,
               "exit_weight": 3.0,
               "train": {"queries": 512, "valid": 128, "n_trees": 30,
                         "max_depth": 4, "n_bins": 32}}}
SEED = 2**31 + 35
POOL = 160


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(tau: int) -> dict:
    return dict(TINY, policy=dict(TINY["policy"], tau=tau))


@pytest.fixture(scope="module")
def bench():
    """The corpus, its index, and a cache of (forest, cfg) by tau."""
    c = corpus_mod.make(TINY, POOL, SEED, CPU)
    index = IVFIndex(c.centroids, c.docs, c.doc_ids, c.offsets, c.sizes,
                     c.list_pad)
    return c, index, {}


def trees(bench, tau: int):
    """The benchmark's forest for ``tau`` and its configuration."""
    c, _, cache = bench
    if tau not in cache:
        cfg = config(tau)
        cache[tau] = (policy.train(c, cfg, SEED)[0], cfg)
    return cache[tau]


def knobs(cfg: dict, **change) -> dict:
    return dict(dict(wave_size=cfg["wave_size"], chunk=cfg["chunk"],
                     k=cfg["k"], n_probe=cfg["n_probe"],
                     delta=cfg["patience_delta"], phi=cfg["patience_phi"]),
                **change)


def answers(rep, n: int):
    """(n, k) ids and (n,) probes of a report, in query order."""
    assert sorted(rep.results) == list(range(n))
    return (np.stack([rep.results[j] for j in range(n)]),
            np.array([rep.probes[j] for j in range(n)]))


def clf_says_exit(pol, features) -> np.ndarray:
    return (torch.sigmoid(predict_margin(pol.clf, features))
            >= pol.clf_threshold).numpy()


# -- the scheduler against the program's search -------------------------------

@pytest.mark.parametrize("tau,chunk,wave_size", [
    (3, 4, 16),      # tau inside a lane's first wave
    (4, 4, 16),      # tau at the first wave's last slot
    (5, 4, 24),      # tau at the first slot of a lane's second wave
    (10, 8, 32),     # the benchmark's: slot 1 of a lane's second wave
    (4, 4, 7),       # an odd wave, lanes of every age
], ids=lambda x: str(x))
def test_scheduler_equals_search(bench, tau, chunk, wave_size):
    """``WaveScheduler(policy=cascade_patience(...))`` answers every
    query with fused ``search``'s ids and probes under the same policy
    and chunk, over waves smaller than the batch, so that lanes admitted
    at different waves share one; its ``clf_exits`` count the queries
    whose features at tau the trees exit."""
    c, index, _ = bench
    forest, cfg = trees(bench, tau)
    pol = harness.program_policy(forest, cfg, CPU)
    res = search(index, c.pool, pol, use_fused_kernel=True, chunk=chunk)
    rep = WaveScheduler(index, policy=pol, **knobs(
        cfg, chunk=chunk, wave_size=wave_size)).serve(c.pool)
    ids, probes = answers(rep, POOL)
    np.testing.assert_array_equal(ids, res.topk_ids.numpy())
    np.testing.assert_array_equal(probes, res.probes.numpy())
    exits = clf_says_exit(pol, res.features)
    assert rep.clf_exits == int(exits.sum())
    assert (probes[exits] == tau).all()
    # both exits are reached: the classifier's at tau and patience's later
    assert 0 < exits.sum() < POOL
    assert ((probes > tau) & (probes < cfg["n_probe"])).any()
    assert rep.tau_ms > 0.0


@pytest.mark.parametrize("tau,chunk", [(5, 4), (10, 8)])
def test_stage_reads_search_s_features(bench, monkeypatch, tau, chunk):
    """The features the stage builds for a lane at tau are the ones
    ``search`` builds for its query, bit for bit: the centroid sims
    ranked per row at admission, the snapshot at tau's slot and the
    history recorded across the lane's waves."""
    c, index, _ = bench
    forest, cfg = trees(bench, tau)
    pol = harness.program_policy(forest, cfg, CPU)
    built, seen = [], {}
    feature_matrix, stage = serving.feature_matrix, serving._tau_stage

    def keep(extras, **kw):
        built.append(feature_matrix(extras, **kw))
        return built[-1]

    def at_tau(policy, state, *args, chunk, **kw):
        out = stage(policy, state, *args, chunk=chunk, **kw)
        t = policy.tau - 1 - state.lanes.h
        lanes = state.lanes.active & (t >= 0) & (t < chunk)
        for lane in torch.nonzero(lanes)[:, 0].tolist():
            seen[int(state.qid[lane])] = built[-1][lane]
        return out

    monkeypatch.setattr(serving, "feature_matrix", keep)
    monkeypatch.setattr(serving, "_tau_stage", at_tau)
    WaveScheduler(index, policy=pol, **knobs(
        cfg, chunk=chunk, wave_size=24)).serve(c.pool)
    res = search(index, c.pool, pol, use_fused_kernel=True, chunk=chunk)
    assert sorted(seen) == list(range(POOL))
    for q, row in seen.items():
        assert torch.equal(row.view(torch.int32),
                           res.features[q].view(torch.int32)), q


# -- the scheduler against the plain cascade reference ------------------------

@pytest.mark.parametrize("tau,chunk", [(4, 4), (10, 8)])
def test_scheduler_equals_the_cascade_reference(bench, tau, chunk):
    """Every served query's probe count is the reference's, or parts
    from it where the judge calls a tie; where they agree the ids are
    the reference's top-k after that probe.  ``clf_exits`` is the
    reference's count of classifier exits at tau, up to the queries
    whose stage lies within ``tree_tol`` of a cut."""
    c, index, _ = bench
    forest, cfg = trees(bench, tau)
    cfg = dict(cfg, chunk=chunk)
    pol = harness.program_policy(forest, cfg, CPU)
    rep = WaveScheduler(index, policy=pol, **knobs(cfg)).serve(c.pool)
    ids, probes = answers(rep, POOL)
    idx = np.arange(POOL)
    ref, inv = judge.reference_of(c, cfg, idx, forest=forest)
    num = judge.compare(c, cfg, judge.Answers(idx, ids.astype(np.int64),
                                              probes), ref, inv)
    assert num["invalid"] == 0
    assert num["exit_mismatch_pct"] == 0.0 and num["gap_share_pct"] == 0.0
    ref_probes = ref.probes.numpy()
    for r in np.nonzero(ref_probes == probes)[0]:
        want = ref.ids[r, probes[r] - 1].numpy()
        assert set(want[want >= 0]) == set(ids[r][ids[r] >= 0]), r
    want = int((ref.clf_exit.numpy() & (ref_probes == tau)).sum())
    tied = int((judge.stage_gaps(cfg, ref, inv)
                < cfg["check"]["tree_tol"]).sum())
    assert abs(rep.clf_exits - want) <= tied
    assert 0 < want < POOL


# -- edges of the stage -------------------------------------------------------

def never_exits(forest):
    """``forest`` with every leaf far on the Continue side."""
    return dataclasses.replace(forest, value=np.where(
        forest.feat < 0, np.float32(-100.0), forest.value))


@pytest.mark.parametrize("case", ["cascade_never_exits",
                                  "patience_min_probes",
                                  "patience_min_probes_per_probe"])
def test_patience_waits_for_tau(bench, case):
    """A lane whose patience reaches Delta before ``tau`` leaves no
    earlier than ``tau``: the cascade whose classifier never says Exit,
    and ``patience(..., min_probes=tau)`` on the fused and the per-probe
    path, each equal to ``search`` on the same kernels."""
    c, index, _ = bench
    tau = 10
    forest, cfg = trees(bench, tau)
    if case == "cascade_never_exits":
        pol = harness.program_policy(never_exits(forest), cfg, CPU)
    else:
        pol = patience(cfg["n_probe"], cfg["patience_delta"],
                       cfg["patience_phi"], k=cfg["k"], min_probes=tau)
    fused = case != "patience_min_probes_per_probe"
    rep = WaveScheduler(index, policy=pol, use_fused=fused,
                        **knobs(cfg)).serve(c.pool)
    ids, probes = answers(rep, POOL)
    plain = WaveScheduler(index, **knobs(cfg)).serve(c.pool)
    _, early = answers(plain, POOL)
    assert (early < tau).any()              # patience alone leaves earlier
    assert (probes >= tau).all() and (probes[early < tau] == tau).any()
    res = search(index, c.pool, pol, use_fused_kernel=fused,
                 use_scan_kernel=not fused, use_topk_kernel=not fused,
                 chunk=cfg["chunk"])
    np.testing.assert_array_equal(ids, res.topk_ids.numpy())
    np.testing.assert_array_equal(probes, res.probes.numpy())
    assert rep.clf_exits == 0


def test_classifier_alone_exits_at_tau_or_n(bench):
    c, index, _ = bench
    forest, cfg = trees(bench, 4)
    casc = harness.program_policy(forest, cfg, CPU)
    pol = classifier(cfg["n_probe"], casc.clf, threshold=0.5, k=cfg["k"],
                     tau=4)
    rep = WaveScheduler(index, policy=pol, **knobs(cfg)).serve(c.pool)
    ids, probes = answers(rep, POOL)
    assert set(probes.tolist()) == {4, cfg["n_probe"]}
    res = search(index, c.pool, pol, use_fused_kernel=True,
                 chunk=cfg["chunk"])
    np.testing.assert_array_equal(ids, res.topk_ids.numpy())
    np.testing.assert_array_equal(probes, res.probes.numpy())
    assert rep.clf_exits == int((probes == 4).sum())


def test_patience_policy_is_no_policy(bench):
    """``policy=patience(...)`` serves as the scheduler without one:
    the same answers, probes, waves, lane steps and reads."""
    c, index, _ = bench
    cfg = config(4)
    pol = patience(cfg["n_probe"], cfg["patience_delta"],
                   cfg["patience_phi"], k=cfg["k"])
    a = WaveScheduler(index, policy=pol, **knobs(cfg)).serve(c.pool)
    b = WaveScheduler(index, **knobs(cfg)).serve(c.pool)
    ia, pa = answers(a, POOL)
    ib, pb = answers(b, POOL)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(pa, pb)
    assert (a.waves, a.lane_steps, a.host_syncs, a.clf_exits, a.tau_ms) \
        == (b.waves, b.lane_steps, b.host_syncs, 0, 0.0)


@pytest.mark.parametrize("kind", ["cascade", "patience"])
def test_knobs_come_from_the_policy(bench, kind):
    """A scheduler given a policy and no exit knobs takes the policy's
    ``k``, ``n_probe``, ``delta`` and ``phi``, and serves as one given
    the same knobs as keywords too."""
    c, index, _ = bench
    forest, cfg = trees(bench, 4)
    pol = harness.program_policy(forest, cfg, CPU) if kind == "cascade" \
        else patience(12, 2, 80.0, k=8)
    bare = WaveScheduler(index, policy=pol, wave_size=cfg["wave_size"],
                         chunk=cfg["chunk"])
    assert (bare.k, bare.n, bare.delta, bare.phi) \
        == (pol.k, pol.n_probe, pol.delta, pol.phi)
    a = bare.serve(c.pool)
    b = WaveScheduler(index, policy=pol, **knobs(
        cfg, k=pol.k, n_probe=pol.n_probe, delta=pol.delta,
        phi=pol.phi)).serve(c.pool)
    for got, want in zip(answers(a, POOL), answers(b, POOL)):
        np.testing.assert_array_equal(got, want)
    assert (a.waves, a.clf_exits) == (b.waves, b.clf_exits)


@pytest.mark.parametrize("case,found", [
    ("regression", "no REG stage"),
    ("cascade_regression", "no REG stage"),
    ("deadline", "without deadline_ms"),
    ("registry", "without registry"),
    ("per_probe", "without use_fused=False"),
    ("k", "k 10 (the scheduler's 20)"),
    ("n_probe", "n_probe 16 (the scheduler's 12)"),
    ("delta", "delta 3 (the scheduler's 4)"),
    ("phi", "phi 90.0 (the scheduler's 95.0)"),
    ("tau_past_n", "must lie in"),
    ("min_probes", "min_probes (1) equal it"),
])
def test_scheduler_refuses(bench, case, found):
    c, index, _ = bench
    forest, cfg = trees(bench, 4)
    pol = harness.program_policy(forest, cfg, CPU)
    kw = knobs(cfg)
    if case == "regression":
        pol = regression(cfg["n_probe"], pol.clf, with_intersections=True,
                         k=cfg["k"], tau=4)
    elif case == "cascade_regression":
        pol = cascade_regression(cfg["n_probe"], pol.clf, pol.clf,
                                 k=cfg["k"], tau=4)
    elif case == "deadline":
        kw["deadline_ms"] = 5.0
    elif case == "registry":
        live = LiveIndex(index, delta_cap=64)
        kw["registry"] = IndexRegistry(version_of(live))
    elif case == "per_probe":
        kw["use_fused"] = False
    elif case == "k":
        kw["k"] = 20
    elif case == "n_probe":
        kw["n_probe"] = 12
    elif case == "delta":
        kw["delta"] = 4
    elif case == "phi":
        kw["phi"] = 95.0
    elif case == "tau_past_n":
        pol = cascade_patience(8, pol.clf, cfg["patience_delta"],
                               cfg["patience_phi"], k=cfg["k"], tau=9)
        kw["n_probe"] = 8
    else:
        pol = dataclasses.replace(pol, min_probes=1)
    with pytest.raises(ValueError, match=found.replace("(", r"\(")
                       .replace(")", r"\)")):
        WaveScheduler(index, policy=pol, **kw)


# -- the reads of a cascade serve ---------------------------------------------

def test_cascade_reads_once_more_than_patience(bench, monkeypatch):
    """The stage adds no blocking read to a wave: a cascade call reads
    ``active`` once a harvest and waits once for each harvest's exits,
    as a patience call does, and reads ``clf_exits`` once at its end."""
    c, index, _ = bench
    forest, cfg = trees(bench, 4)
    staged = []
    stage = serving._Call.stage_exits

    def counted(call, *args):
        staged.append(1)
        return stage(call, *args)

    monkeypatch.setattr(serving._Call, "stage_exits", counted)
    for pol, extra in ((harness.program_policy(forest, cfg, CPU), 1),
                       (None, 0)):
        staged.clear()
        rep = WaveScheduler(index, policy=pol, **knobs(cfg)).serve(c.pool)
        assert rep.host_syncs == rep.waves + 1 + len(staged) + extra
