"""A configuration with a ``policy`` block: the spec's rules, the cascade
reference and its tree walk by hand, the exit trees from the seed, the
judge's tie rule at the classifier stage, the reference against the
program's fused ``search`` on tiny corpora, and the harness's set-up."""
import json

import numpy as np
import pytest
import torch

from portbench import corpus as corpus_mod
from portbench import harness, judge, policy, spec
from portbench.reference import ivf_cascade
from portbench.reference.gbdt import Forest as GbdtForest, Tree

from conftest import REPO, TINY, make_root

POLICY = {"kind": "cascade_patience", "tau": 4, "clf_threshold": 0.5,
          "exit_weight": 3.0,
          "train": {"queries": 512, "valid": 128, "n_trees": 30,
                    "max_depth": 4, "n_bins": 32}}
# a corpus whose queries' best documents lie at many probe ranks, so the
# classifier exits some at tau and patience stops the rest later
CASCADE = dict(
    TINY, name="tiny-cascade", policy=POLICY,
    corpus=dict(TINY["corpus"], spread_at_64=0.3),
    queries={"hard_frac": 0.8, "easy_noise": 0.15},
    reference="portbench/reference/ivf_cascade.py",
    check=dict(TINY["check"], tree_tol=1e-5))
CPU = torch.device("cpu")


def with_policy(**change):
    pol = json.loads(json.dumps(POLICY))
    for key, v in change.items():
        if key in pol["train"]:
            pol["train"][key] = v
        else:
            pol[key] = v
    return dict(CASCADE, policy=pol)


# -- the spec -----------------------------------------------------------------

@pytest.mark.parametrize("cfg, found", [
    (with_policy(kind="classifier"), "policy kind"),
    (with_policy(tau=1), "tau 1 outside"),
    (with_policy(tau=17), "tau 17 outside"),
    (with_policy(tau=4.0), "tau 4.0 outside"),
    (with_policy(clf_threshold=0), "clf_threshold 0 outside"),
    (with_policy(clf_threshold=1.0), "clf_threshold 1.0 outside"),
    (with_policy(exit_weight=0), "exit_weight 0"),
    (with_policy(queries=0), "train queries 0"),
    (with_policy(valid=-4), "train valid -4"),
    (with_policy(n_trees=2.5), "train n_trees 2.5"),
    (with_policy(max_depth=True), "train max_depth True"),
    (with_policy(n_bins=None), "train n_bins None"),
    (dict(CASCADE, live={"delta_cap": 256, "merge_every": 8}),
     "beside a live block"),
    (dict(CASCADE, check=TINY["check"]), "without a check.tree_tol"),
    (dict(CASCADE, reference="portbench/reference/ivf_patience.py"),
     "not portbench/reference/ivf_cascade.py"),
    (dict(TINY, reference="portbench/reference/ivf_cascade.py"),
     "not portbench/reference/ivf_patience.py"),
    (dict(TINY, reference=None), "reference None"),
], ids=lambda x: x if isinstance(x, str) else "")
def test_spec_refuses(cfg, found):
    assert found in " ".join(spec.config_problems(cfg))


@pytest.mark.parametrize("name", ["msmarco-star", "deep10m",
                                  "msmarco-star-live"])
def test_spec_accepts_the_committed_configs(name):
    cfg = spec.load_json(REPO / "portbench" / "configs" / f"{name}.json")
    assert spec.config_problems(cfg) == []
    assert spec.config_problems(CASCADE) == []


def test_spec_finds_a_bad_policy_in_benchmark_json(tmp_path):
    root = cascade_root(tmp_path)
    assert spec.problems(root) == []
    bad = dict(CASCADE, policy=dict(POLICY, tau=99))
    (root / "portbench" / "configs" / "tiny-cascade.json").write_text(
        json.dumps(bad))
    assert any("tau 99" in p for p in spec.problems(root))


def cascade_root(tmp_path, cfg=CASCADE):
    """The tiny benchmark root with a cell ``t-cascade`` over ``cfg``."""
    root = make_root(tmp_path / "root")
    (root / "portbench" / "configs" / f"{cfg['name']}.json").write_text(
        json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": cfg["name"], "source": "a test", "reduced": [],
        "file": f"portbench/configs/{cfg['name']}.json", "why": "a test"})
    bench["workloads"].append({"name": "t-cascade", "config": cfg["name"],
                               "traffic": "t-closed", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("t-cascade")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


# -- the reference by hand ----------------------------------------------------

def hand_corpus():
    """Four lists of one document each (``list_pad`` 2).  Query A = e1
    probes lists 3, 2, 1, 0; query B = e0 probes 0, 1, 2, 3."""
    centroids = torch.tensor([[1.0, 0, 0, 0], [0.8, 0.6, 0, 0],
                              [0.6, 0.8, 0, 0], [0, 1.0, 0, 0]])
    one = torch.tensor([[0.5, 0, 0, 0], [0.8, 0.3, 0, 0],
                        [0.1, 0.95, 0, 0], [0.05, 0.9, 0, 0]])
    docs = torch.zeros(10, 4)
    docs[0:8:2] = one
    doc_ids = torch.full((10,), -1, dtype=torch.int32)
    doc_ids[0:8:2] = torch.tensor([10, 11, 12, 13], dtype=torch.int32)
    offsets = torch.tensor([0, 2, 4, 6], dtype=torch.int32)
    sizes = torch.ones(4, dtype=torch.int32)
    queries = torch.tensor([[0, 1.0, 0, 0], [1.0, 0, 0, 0]])
    return queries, docs, doc_ids, offsets, sizes, centroids


def split_forest(feature: int, thr: float, left: float, right: float,
                 base: float = 0.0) -> ivf_cascade.Forest:
    """One tree of one split: ``left`` where x[feature] <= thr."""
    tree = Tree(np.array([feature, -1, -1], np.int32),
                np.array([thr, 0, 0], np.float32),
                np.array([1, 0, 0], np.int32), np.array([2, 0, 0], np.int32),
                np.array([0, left, right], np.float32))
    return policy.stack(GbdtForest([tree], base), 1)


@pytest.mark.parametrize("trees, probes, ids", [
    # the classifier exits A (q[0] = 0 <= 0.5) at tau 2; B continues:
    # its top-1 changes at probe 2 (phi 0) and holds at probe 3 (phi
    # 100), so patience (Delta 1) stops it there
    (True, [2, 3], [12, 11]),
    # without the trees A's top-1 holds at probe 3 too
    (False, [3, 3], [12, 11]),
])
def test_reference_by_hand(trees, probes, ids):
    forest = split_forest(0, 0.5, 2.0, -2.0) if trees else None
    ref = ivf_cascade.search(*hand_corpus(), forest, k=1, n_probe=4,
                             delta=1, phi=95.0, tau=2, threshold=0.5,
                             list_pad=2)
    assert ref.order.tolist() == [[3, 2, 1, 0], [0, 1, 2, 3]]
    assert ref.probes.tolist() == probes
    at = ref.ids[torch.arange(2), ref.probes - 1, 0]
    assert at.tolist() == ids
    # query, first two centroid scores, s1, sk, s1/sk, s1/c1, kept/k at
    # probe 2, share of RS_1 kept at probe 2
    want = torch.tensor([[0, 1, 0, 0, 1, 0.8, 0.95, 0.95, 1, 0.95, 0, 0],
                         [1, 0, 0, 0, 1, 0.8, 0.8, 0.8, 1, 0.8, 0, 0]],
                        dtype=torch.float64)
    assert torch.allclose(ref.features, want, atol=1e-12)
    assert ref.features.shape[1] == ivf_cascade.n_features(4, 2)
    if trees:
        assert ref.margin.tolist() == [2.0, -2.0]
        assert ref.clf_exit.tolist() == [True, False]
        assert ref.split_gap.tolist() == [0.5, 0.5]
    else:
        assert ref.clf_exit.tolist() == [False, False]


def test_tree_walk_by_hand():
    """Two trees: a depth-2 split and a lone leaf; ties go left, and a
    float64 feature is rounded to float32 before it meets a threshold."""
    t0 = Tree(np.array([1, 0, -1, -1, -1], np.int32),
              np.array([0.5, -1.0, 0, 0, 0], np.float32),
              np.array([1, 3, 0, 0, 0], np.int32),
              np.array([2, 4, 0, 0, 0], np.int32),
              np.array([0, 0, -1.0, 1.0, 2.0], np.float32))
    t1 = Tree(np.array([-1], np.int32), np.zeros(1, np.float32),
              np.zeros(1, np.int32), np.zeros(1, np.int32),
              np.array([0.25], np.float32))
    forest = policy.stack(GbdtForest([t0, t1], 0.125), 2)
    assert forest.feat.shape == (2, 5)
    # padded as the program's from_numpy_forest pads: past a tree's
    # nodes, leaves of value 0 that point to the root
    assert forest.feat[1].tolist() == [-1] * 5
    assert forest.left[0].tolist() == [1, 3, 2, 3, 4]
    x = torch.tensor([[0.0, 0.2], [-2.0, 0.4], [0.0, 0.9], [0.0, 0.5],
                      [0.0, 0.5 + 1e-12]], dtype=torch.float64)
    margin, gap = ivf_cascade.walk(forest, x)
    assert margin.tolist() == [2.375, 1.375, -0.625, 2.375, 2.375]
    assert torch.allclose(gap, torch.tensor(
        [0.3, 0.1, 0.4, 0.0, 1e-12], dtype=torch.float64), atol=1e-9)
    # the program's walk of the same arrays
    from repro_torch.trees.torch_infer import (ensemble_from_arrays,
                                               predict_margin)
    ens = ensemble_from_arrays(forest.feat, forest.thresh, forest.left,
                               forest.right, forest.value, forest.base,
                               forest.max_depth, device="cpu")
    assert predict_margin(ens, x.float()).tolist() == margin.tolist()


# -- the exit trees from the seed ---------------------------------------------

def forest_arrays(f: ivf_cascade.Forest):
    return [f.feat, f.thresh, f.left, f.right, f.value,
            np.float64(f.base)]


def test_trees_follow_the_seed(one_thread):
    c = corpus_mod.make(CASCADE, 256, 5, CPU)
    one, took = policy.train(c, CASCADE, 5)
    again, _ = policy.train(c, CASCADE, 5)
    other, _ = policy.train(c, CASCADE, 6)
    for a, b in zip(forest_arrays(one), forest_arrays(again)):
        assert np.array_equal(a, b)
    assert not all(a.shape == b.shape and np.array_equal(a, b) for a, b
                   in zip(forest_arrays(one), forest_arrays(other)))
    assert 0 < took["exit_share"] < 1 and 1 <= took["trees"] <= 30
    assert set(took) >= {"labels_s", "features_s", "fit_s"}


def test_training_leaves_the_corpus_and_pool_alone(one_thread):
    plain = {key: v for key, v in CASCADE.items() if key != "policy"}
    c = corpus_mod.make(CASCADE, 256, 9, CPU)
    sums, pool = corpus_mod.checksum(c), c.pool.clone()
    policy.train(c, CASCADE, 9)
    assert corpus_mod.checksum(c) == sums and torch.equal(c.pool, pool)
    fresh = corpus_mod.make(plain, 256, 9, CPU)
    assert corpus_mod.checksum(fresh) == sums
    assert torch.equal(fresh.pool, pool)
    q = policy.training_queries(c, CASCADE, 9)
    assert q.shape == (640, CASCADE["dim"])
    assert not any(torch.equal(q[i], pool[j]) for i in range(8)
                   for j in range(pool.shape[0]))


def test_labels_are_the_best_list_rank(one_thread):
    """C_N against a brute force over each query's first N lists."""
    c = corpus_mod.make(CASCADE, 256, 4, CPU)
    q = c.pool[:40]
    got = policy.best_list_rank(q, c, CASCADE)
    sims = q.double() @ c.centroids.double().T
    order = torch.argsort(sims, dim=1, descending=True, stable=True)
    for r in range(q.shape[0]):
        best, at = -np.inf, 0
        for h in range(CASCADE["n_probe"]):
            lst = int(order[r, h])
            o, n = int(c.offsets[lst]), int(c.sizes[lst])
            s = float((c.docs[o:o + n].double() @ q[r].double()).max())
            if s > best:
                best, at = s, h + 1
        assert got[r] == at


# -- the judge at the classifier stage ----------------------------------------

@pytest.mark.parametrize("case, tied", [
    ("split", True),     # a split of the path at the feature's value
    ("margin", True),    # the margin within tree_tol of logit(0.5) = 0
    ("far", False),      # neither: the parting is a fault
])
def test_judge_stage_tie(one_thread, case, tied):
    c = corpus_mod.make(CASCADE, 256, 12, CPU)
    cfg, tau = CASCADE, CASCADE["policy"]["tau"]
    idx = np.arange(c.pool.shape[0])
    # the answers of a program whose classifier never says Exit
    cont, inv = judge.reference_of(c, cfg, idx, forest=None)
    from portbench.reference import ivf_patience
    mg = ivf_patience.margins(c.pool, c.docs, c.doc_ids, c.offsets, c.sizes,
                              c.centroids, k=cfg["k"], n_probe=tau,
                              list_pad=cfg["list_pad"])
    tol = cfg["check"]["tie_tol"]
    ok = (cont.probes > tau) & (mg.boundary.amin(1) >= tol) \
        & (mg.centroid.amin(1) >= tol)
    r = int(torch.nonzero(ok)[0, 0])
    col = cfg["dim"]                       # the first centroid score
    x = float(cont.features[r, col])
    thr = {"split": np.float32(x), "margin": np.float32(x) + 0.25,
           "far": np.float32(x) + 0.25}[case]
    left = 1e-7 if case == "margin" else 3.0
    forest = split_forest(col, float(thr), left, -3.0)
    ref, inv = judge.reference_of(c, cfg, np.array([r]), forest=forest)
    assert int(ref.probes[0]) == tau and bool(ref.clf_exit[0])
    h = int(cont.probes[r])
    ans = judge.Answers(np.array([r]), cont.ids[r, h - 1][None].numpy(),
                        np.array([h]))
    num = judge.compare(c, cfg, ans, ref, inv)
    assert num["probe_mismatch_pct"] == 100.0
    assert num["exit_mismatch_pct"] == (0.0 if tied else 100.0)
    assert num["clf_exit_pct"] == 100.0
    why = judge.explain(c, cfg, ans, ref, inv)
    assert why[0]["tied"] is tied and why[0]["kept_from_probe"] == 0


# -- the reference against the program ----------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_equals_the_programs_search(one_thread, seed):
    """The program's fused ``search`` under ``cascade_patience`` with the
    benchmark's trees: every probe count and top-k the reference's, or
    a parting the judge counts as tied."""
    from repro_torch.core.ivf import IVFIndex, search

    cfg, tau = CASCADE, CASCADE["policy"]["tau"]
    c = corpus_mod.make(cfg, 256, seed, CPU)
    forest, _ = policy.train(c, cfg, seed)
    index = IVFIndex(c.centroids, c.docs, c.doc_ids, c.offsets, c.sizes,
                     c.list_pad)
    res = search(index, c.pool, harness.program_policy(forest, cfg, CPU),
                 use_fused_kernel=True, chunk=8)
    idx = np.arange(c.pool.shape[0])
    ans = judge.Answers(idx, res.topk_ids.long().numpy(),
                        res.probes.long().numpy())
    ref, inv = judge.reference_of(c, cfg, idx, forest=forest)
    num = judge.compare(c, cfg, ans, ref, inv)
    assert num["invalid"] == 0
    assert num["exit_mismatch_pct"] == 0.0 and num["gap_share_pct"] == 0.0
    same = ref.probes.numpy() == ans.probes
    for r in np.nonzero(same)[0]:
        want = ref.ids[r, ans.probes[r] - 1].numpy()
        assert set(want[want >= 0]) == set(ans.ids[r][ans.ids[r] >= 0])
    # the test reaches both exits: some leave at tau by the classifier,
    # some continue and are stopped by patience before N
    probes = ref.probes.numpy()
    assert 0 < num["clf_exit_pct"] < 100
    assert ((probes > tau) & (probes < cfg["n_probe"])).any()


# -- the harness --------------------------------------------------------------

def test_setup_stops_before_the_corpus_without_policy_keyword(
        tmp_path, monkeypatch, one_thread):
    root = cascade_root(tmp_path)

    def no_corpus(*a, **k):
        raise AssertionError("the corpus was made")

    monkeypatch.setattr(corpus_mod, "make", no_corpus)
    from repro_torch.core import serving
    import inspect
    if "policy" in inspect.signature(serving.WaveScheduler).parameters:
        monkeypatch.setattr(serving, "WaveScheduler", PatienceOnly)
    with pytest.raises(RuntimeError, match="takes no keyword 'policy'"):
        harness.setup(root, "t-cascade", 3, CPU)


class PatienceOnly:
    """A scheduler that takes the patience knobs alone."""

    def __init__(self, index, *, wave_size, chunk, k, n_probe, delta, phi,
                 use_fused):
        raise AssertionError("built")


class SearchScheduler:
    """A stand-in for a ``WaveScheduler`` that takes ``policy``: each
    ``serve`` one fused ``search`` of the batch under the policy."""

    def __init__(self, index, *, policy, wave_size, chunk, k, n_probe,
                 delta, phi, use_fused):
        self.index, self.policy, self.chunk = index, policy, chunk

    def serve(self, queries):
        from repro_torch.core.ivf import search
        from repro_torch.core.serving import ServeReport
        res = search(self.index, queries, self.policy,
                     use_fused_kernel=True, chunk=self.chunk)
        ids, probes = res.topk_ids.numpy(), res.probes.numpy()
        n = ids.shape[0]
        return ServeReport({j: ids[j] for j in range(n)},
                           {j: int(probes[j]) for j in range(n)}, 1, 1.0,
                           int(probes.sum()))


def test_harness_runs_a_policy_cell(tmp_path, monkeypatch, one_thread,
                                    capsys):
    """With a scheduler that takes ``policy``, set-up trains the trees,
    the program gets the cascade, and the check holds it to the cascade
    reference; a program that answers at the patience exit instead
    fails."""
    from repro_torch.core import serving
    cfg = dict(CASCADE, corpus=TINY["corpus"],
               queries={"hard_frac": 0.9, "easy_noise": 0.15},
               policy=dict(POLICY, tau=2))
    root = cascade_root(tmp_path, cfg)
    monkeypatch.setattr(serving, "WaveScheduler", SearchScheduler)
    out = harness.run(root, "t-cascade", 41, 0.3, False, CPU, 0.0)
    assert out["correct"] is True, out["checks"]
    err = capsys.readouterr().err
    assert "exit trees: labels_s" in err and "clf_exit_pct" in err

    class Patience(SearchScheduler):
        def __init__(self, index, *, policy, **knobs):
            from repro_torch.core.policies import patience
            super().__init__(index, policy=patience(
                knobs["n_probe"], knobs["delta"], knobs["phi"],
                k=knobs["k"]), **knobs)

    monkeypatch.setattr(serving, "WaveScheduler", Patience)
    out = harness.run(root, "t-cascade", 41, 0.3, False, CPU, 0.0)
    assert out["correct"] is False
    assert out["checks"]["exit_mismatch_pct"]["value"] > \
        out["checks"]["exit_mismatch_pct"]["limit"]


# -- the frozen trainer -------------------------------------------------------

def test_frozen_trainer_fits_the_programs_trees():
    """The copies under ``reference/`` fit the program's trees bit for
    bit: the blocked split search changes no sum, gain or pick (a
    discrete column, a column with no finite edge, a weighted logistic
    fit after SMOTE, early stopping)."""
    from repro_torch.trees.gbdt import GBDT as ProgramGBDT
    from repro_torch.trees.smote import smote as program_smote

    from portbench.reference.gbdt import COLUMN_BLOCK, GBDT
    from portbench.reference.smote import smote

    rng = np.random.default_rng(3)
    f = 2 * COLUMN_BLOCK + 7
    x = rng.standard_normal((700, f)).astype(np.float32)
    x[:, 3] = np.round(x[:, 3])
    y = (x[:, 0] + 0.5 * x[:, 7] + rng.standard_normal(700) > 1.2
         ).astype(np.float64)
    xv = rng.standard_normal((200, f)).astype(np.float32)
    yv = (xv[:, 0] > 1.2).astype(np.float64)
    xs, ys = smote(x, y, seed=4)
    pxs, pys = program_smote(x, y, seed=4)
    assert np.array_equal(xs, pxs) and np.array_equal(ys, pys)
    xs[:, 5] = np.inf
    w = np.where(ys == 1.0, 3.0, 1.0)
    kw = dict(n_trees=40, max_depth=5, n_bins=32, seed=4)
    ours = GBDT("logistic", **kw).fit(xs, ys, sample_weight=w,
                                      eval_set=(xv, yv))
    theirs = ProgramGBDT("logistic", **kw).fit(xs, ys, sample_weight=w,
                                               eval_set=(xv, yv))
    assert len(ours.trees) == len(theirs.trees) and ours.base == theirs.base
    assert any((t.feat >= 0).sum() > 1 for t in ours.trees)
    for a, b in zip(ours.trees, theirs.trees):
        for key in ("feat", "thresh", "left", "right", "value"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key
