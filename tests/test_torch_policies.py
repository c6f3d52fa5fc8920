"""Port parity for the learned exit stages: the Table-1 features, golden
labels, and REG / REG+int / classifier / both cascades through
``search`` on every path, against ``repro`` on ``tiny_corpus``.

The forests are trained once by the reference's ``train_policy_models``
and carried across by ``ensemble_from_arrays``, so both packages run the
same trees.  The reference side is the per-probe JAX ``search``: its
fused path does not trace under this JAX (ROADMAP Queue 3, R1).  Ids
and probe counts are equal, scores agree within 1e-5; the query and
phi / phi1 feature columns are equal, the score columns within 1e-5.
Inside the port, the per-probe plain path, the kernel pair and the
fused kernel at chunk 1 and 4 agree bit for bit, features included.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import policies as jpol
from repro.core import search as jsearch
from repro.core.features import FeatureExtras as JFeatureExtras
from repro.core.features import feature_matrix as j_feature_matrix
from repro.core.ivf import DeltaView as JDeltaView
from repro.core.ivf import extract_features as j_extract_features
from repro.core.training import golden_labels as j_golden_labels
from repro.core.training import train_policy_models as j_train
from repro_torch.core import extract_features, index_from_arrays, policies, \
    search
from repro_torch.core.features import FeatureExtras, feature_matrix, \
    n_features
from repro_torch.core.ivf import DeltaView, intersection_pct
from repro_torch.core.training import features_blocked, golden_labels, \
    train_policy_models
from repro_torch.kernels import ops as kops
from repro_torch.trees import ensemble_from_arrays

N, K, TAU = 24, 10, 3
D = 24                               # tiny_corpus's dim
ATOL = 1e-5


def T(x):
    """A tensor copy of a host array (reference arrays are read-only)."""
    return torch.from_numpy(np.array(x))


def carry(ens):
    """A reference ``TreeEnsemble`` as the port's, on the CPU."""
    return ensemble_from_arrays(
        *(np.asarray(getattr(ens, f)) for f in
          ("feat", "thresh", "left", "right", "value", "base")),
        ens.max_depth, device="cpu")


@pytest.fixture(scope="module")
def t_index(tiny_index):
    return index_from_arrays(
        *(np.asarray(getattr(tiny_index, f)) for f in
          ("centroids", "docs", "doc_ids", "cluster_offsets",
           "cluster_sizes")), tiny_index.list_pad, device="cpu")


@pytest.fixture(scope="module")
def models(tiny_index, tiny_corpus):
    qs = tiny_corpus.queries
    return j_train(tiny_index, tiny_corpus.docs, qs[:128], qs[128:192],
                   n_probe=N, k=K, tau=TAU, n_trees=10, max_depth=3)


def _policy_pair(name, models, tau=TAU):
    """(reference policy, port policy) over the same trees."""
    reg, reg_int, clf_w = models.reg, models.reg_int, models.clf_weighted
    make = {
        "reg": lambda m, r, ri, c, cw: m.regression(
            N, r, with_intersections=False, k=K, tau=tau),
        "reg+int": lambda m, r, ri, c, cw: m.regression(
            N, ri, with_intersections=True, k=K, tau=tau),
        "classifier": lambda m, r, ri, c, cw: m.classifier(
            N, c, k=K, tau=tau),
        "cascade+patience": lambda m, r, ri, c, cw: m.cascade_patience(
            N, cw, 2, 90.0, k=K, tau=tau),
        "cascade+reg": lambda m, r, ri, c, cw: m.cascade_regression(
            N, cw, ri, k=K, tau=tau),
    }[name]
    return (make(jpol, reg, reg_int, models.clf, clf_w),
            make(policies, carry(reg), carry(reg_int), carry(models.clf),
                 carry(clf_w)))


LEARNED = ["reg", "reg+int", "classifier", "cascade+patience",
           "cascade+reg"]
PATHS = {
    "per_probe": {},
    "pair": dict(use_scan_kernel=True, use_topk_kernel=True),
    "fused_c1": dict(use_fused_kernel=True, chunk=1),
    "fused_c4": dict(use_fused_kernel=True, chunk=4),
}


@pytest.fixture(scope="module")
def queries(tiny_corpus):
    return tiny_corpus.queries[192:]


@pytest.fixture(scope="module")
def reference_runs(tiny_index, queries, models):
    return {name: jsearch(tiny_index, jnp.asarray(queries),
                          _policy_pair(name, models)[0])
            for name in LEARNED}


@pytest.fixture(scope="module")
def port_runs(t_index, queries, models):
    return {(name, path): search(t_index, queries,
                                 _policy_pair(name, models)[1], **kw)
            for name in LEARNED for path, kw in PATHS.items()}


def _assert_matches_reference(res, base):
    np.testing.assert_array_equal(res.topk_ids.numpy(),
                                  np.asarray(base.topk_ids))
    np.testing.assert_array_equal(res.probes.numpy(), np.asarray(base.probes))
    got, want = res.topk_scores.numpy(), np.asarray(base.topk_scores)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(np.nan_to_num(got, neginf=0.0),
                               np.nan_to_num(want, neginf=0.0), atol=ATOL)
    np.testing.assert_allclose(res.phi_hist.numpy(),
                               np.asarray(base.phi_hist), atol=1e-4)


def _assert_feature_columns(got, want, dim=D, tau=TAU):
    """Query and phi / phi1 columns equal, the score columns within
    ATOL."""
    score_cols = slice(dim, dim + tau + 4)
    np.testing.assert_array_equal(got[:, :dim], want[:, :dim])
    np.testing.assert_array_equal(got[:, dim + tau + 4:],
                                  want[:, dim + tau + 4:])
    np.testing.assert_allclose(got[:, score_cols], want[:, score_cols],
                               atol=ATOL)


# -- features -----------------------------------------------------------------


def test_feature_matrix_matches_reference():
    rng = np.random.default_rng(0)
    b, tau, k = 32, 5, 8
    q = rng.normal(size=(b, D)).astype(np.float32)
    cs = rng.normal(size=(b, tau)).astype(np.float32)
    cs[:4, 0] = [0.0, 1e-7, -1e-7, 2e-6]           # the eps guards
    scores = -np.sort(-rng.normal(size=(b, k)), 1).astype(np.float32)
    scores[4:8, 3:] = -np.inf                      # a top-k not yet full
    scores[8, :] = -np.inf
    scores[9:12, -1] = [0.0, 5e-7, -5e-7]
    phi = (100.0 * rng.integers(0, k + 1, (b, tau - 1)) / k) \
        .astype(np.float32)
    phi1 = (100.0 * rng.integers(0, k + 1, (b, tau - 1)) / k) \
        .astype(np.float32)
    for with_int in (True, False):
        want = np.asarray(jax.jit(
            lambda *a: j_feature_matrix(JFeatureExtras(*a),
                                        with_intersections=with_int))(
            q, cs, scores, phi, phi1))
        got = feature_matrix(FeatureExtras(*map(T, (q, cs, scores, phi,
                                                    phi1))),
                             with_intersections=with_int).numpy()
        assert got.shape == want.shape == (b, n_features(D, tau, with_int))
        _assert_feature_columns(got, want, tau=tau)


@pytest.mark.parametrize("with_int", [True, False])
def test_extract_features_matches_reference(tiny_index, t_index, queries,
                                            with_int):
    want = np.asarray(j_extract_features(tiny_index, jnp.asarray(queries),
                                         tau=TAU, k=K,
                                         with_intersections=with_int))
    got = extract_features(t_index, queries, tau=TAU, k=K,
                           with_intersections=with_int).numpy()
    assert got.shape == want.shape
    _assert_feature_columns(got, want)


def test_features_are_batch_independent_and_equal_the_online_ones(
        t_index, queries, port_runs):
    """Offline features in blocks of 16 equal one call over 64 and the
    features every learned search read at tau, bit for bit."""
    whole = extract_features(t_index, queries, tau=TAU, k=K)
    blocked = features_blocked(t_index, queries, tau=TAU, k=K, block=16)
    assert np.array_equal(blocked, whole.numpy())
    for res in port_runs.values():
        assert torch.equal(res.features, whole)


def test_golden_labels_match_reference(tiny_index, t_index, tiny_corpus):
    q = tiny_corpus.queries[:96]
    want = j_golden_labels(tiny_index, q, tiny_corpus.docs, N, K, block=40)
    got = golden_labels(t_index, q, tiny_corpus.docs, N, K, block=40)
    np.testing.assert_array_equal(got, want)


def test_reg_is_trained_on_the_columns_policy_step_feeds_it(t_index,
                                                             tiny_corpus):
    """REG's forest splits on groups 1-3 only (``base_columns``, what
    ``policy_step`` hands it), the same columns the reference's REG is
    fit on."""
    qs = tiny_corpus.queries
    pm = train_policy_models(t_index, tiny_corpus.docs, qs[:128],
                             qs[128:192], n_probe=N, k=K, tau=TAU,
                             n_trees=10, max_depth=3)
    splits = pm.reg.feat[pm.reg.feat >= 0]       # -1 marks a leaf
    assert splits.numel() and int(splits.max()) < n_features(D, TAU, False)
    assert pm.reg.n_trees > 0 and set(pm.seconds) == {"labels", "features",
                                                      "gbdt"}


def test_fused_phi_equals_intersection_while_the_top_k_fills(t_index,
                                                             queries):
    """phi from the fused kernel's new-entry counts, 100 (k - cnt) / k,
    equals ``intersection_pct`` of consecutive snapshots while the running
    top-k is not full (k = 300 > a list's rows): the count treats empty
    slots as new, the intersection finds no old id there."""
    k, chunk = 300, 4
    q = torch.from_numpy(queries)
    _, rank = torch.sort(q @ t_index.centroids.T, dim=1, descending=True,
                         stable=True)
    cids = rank[:, :chunk]
    empty_s = torch.full((q.shape[0], k), float("-inf"))
    empty_i = torch.full((q.shape[0], k), -1, dtype=torch.int32)
    snap_s, snap_i, cnt = kops.ivf_scan_merge(
        q, t_index.docs, t_index.doc_ids, t_index.cluster_offsets[cids],
        t_index.cluster_sizes[cids], empty_s, empty_i, k=k,
        list_pad=t_index.list_pad, chunk=chunk)
    prev = empty_i
    not_full = 0
    for t in range(chunk):
        phi_cnt = 100.0 * (k - cnt[:, t]).to(torch.float32) / k
        assert torch.equal(phi_cnt, intersection_pct(prev, snap_i[:, t]))
        not_full += int((snap_i[:, t] < 0).any(1).sum())
        prev = snap_i[:, t]
    assert not_full > 0
    # and a whole search at that k: the fused and per-probe phi agree
    pol = policies.patience(N, delta=2, phi=40.0, k=k, tau=TAU)
    fused = search(t_index, queries, pol, use_fused_kernel=True, chunk=4)
    plain = search(t_index, queries, pol)
    for f in ("phi_hist", "probes", "topk_ids"):
        assert torch.equal(getattr(fused, f), getattr(plain, f)), f


# -- learned policies ---------------------------------------------------------


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", LEARNED)
def test_learned_policy_matches_reference_per_probe(port_runs,
                                                    reference_runs, name,
                                                    path):
    _assert_matches_reference(port_runs[(name, path)], reference_runs[name])


@pytest.mark.parametrize("name", LEARNED)
def test_learned_policy_paths_agree_bit_for_bit(port_runs, name):
    base = port_runs[(name, "per_probe")]
    assert base.features is not None
    p = base.probes.numpy()
    assert (p >= TAU).all() and (p <= N).all()
    for path in PATHS:
        res = port_runs[(name, path)]
        for f in res._fields:
            assert torch.equal(getattr(res, f), getattr(base, f)), (path, f)


def test_cascade_patience_is_no_slower_than_the_classifier(t_index, models,
                                                          queries):
    """The reference's check (tests/test_policies.py): with the same
    weighted trees, the patience cascade's C does not pass the
    classifier's, and both stay within [tau, N]."""
    cw = carry(models.clf_weighted)
    probes = {}
    for name, pol in (
            ("clf", policies.classifier(N, cw, k=K, tau=TAU)),
            ("casc_pat", policies.cascade_patience(N, cw, 3, 90.0, k=K,
                                                   tau=TAU))):
        p = search(t_index, queries, pol, use_fused_kernel=True,
                   chunk=4).probes
        assert ((p >= TAU) & (p <= N)).all(), name
        probes[name] = float(p.float().mean())
    assert probes["casc_pat"] <= probes["clf"] + 1e-9


@pytest.mark.parametrize("tau", [6, 10])
def test_a_chunk_straddling_tau_fires_on_the_exact_slot(tiny_index, t_index,
                                                        queries, models,
                                                        tau):
    """tau 6 and 10 with chunk 4: the learned stage fires inside a chunk
    (slot 1 of the second, slot 1 of the third), as on the per-probe
    path and the reference's."""
    j_pol, t_pol = _policy_pair("cascade+reg", models, tau=tau)
    base = jsearch(tiny_index, jnp.asarray(queries), j_pol)
    fused = search(t_index, queries, t_pol, use_fused_kernel=True, chunk=4)
    plain = search(t_index, queries, t_pol)
    _assert_matches_reference(fused, base)
    for f in fused._fields:
        assert torch.equal(getattr(fused, f), getattr(plain, f)), f
    assert (fused.probes >= tau).all()


def _delta_arrays(tiny_corpus, centroids):
    """A 96-slot delta buffer: noisy copies of corpus docs with new ids,
    each assigned to its nearest centroid, a fifth tombstoned and the
    last eighth empty."""
    rng = np.random.default_rng(4)
    cap = 96
    vecs = tiny_corpus.docs[rng.integers(0, 8000, cap)] \
        + rng.normal(scale=0.05, size=(cap, D)).astype(np.float32)
    vecs = vecs.astype(np.float32)
    c = np.asarray(centroids)
    assign = np.argmax(vecs @ c.T - 0.5 * (c * c).sum(1), 1).astype(np.int32)
    ids = np.arange(8000, 8000 + cap, dtype=np.int32)
    ids[rng.random(cap) < 0.2] = -1
    ids[-cap // 8:], assign[-cap // 8:] = -1, -1
    vecs[-cap // 8:] = 0.0
    return vecs, ids, assign


@pytest.mark.parametrize("name", ["cascade+patience", "cascade+reg"])
def test_cascade_with_a_delta_view_matches_reference(tiny_index, t_index,
                                                     tiny_corpus, queries,
                                                     models, name):
    vecs, ids, assign = _delta_arrays(tiny_corpus, tiny_index.centroids)
    j_pol, t_pol = _policy_pair(name, models)
    base = jsearch(tiny_index, jnp.asarray(queries), j_pol,
                   delta=JDeltaView(*map(jnp.asarray, (vecs, ids, assign))))
    view = DeltaView(*map(T, (vecs, ids, assign)))
    runs = {path: search(t_index, queries, t_pol, delta=view, **kw)
            for path, kw in PATHS.items()}
    for res in runs.values():
        _assert_matches_reference(res, base)
        for f in res._fields:
            assert torch.equal(getattr(res, f),
                               getattr(runs["per_probe"], f)), f
    assert np.isin(runs["fused_c4"].topk_ids.numpy(), ids[ids >= 0]).any()


# -- the policy step and its guards -------------------------------------------


def test_policy_step_fires_the_learned_stages_at_tau_only(models):
    _, pol = _policy_pair("cascade+reg", models)
    b = 8
    fm = torch.zeros((b, n_features(D, TAU, True)))
    phi = torch.full((b,), 50.0)
    ctr = torch.zeros(b, dtype=torch.int32)
    target = torch.full((b,), N, dtype=torch.int32)
    for h in (0, 1, 3):
        dec = policies.policy_step(pol, h=h, phi=phi, patience_ctr=ctr,
                                   target=target, features=fm)
        assert torch.equal(dec.target, target) and not dec.exit.any()
    dec = policies.policy_step(pol, h=TAU - 1, phi=phi, patience_ctr=ctr,
                               target=target, features=fm)
    assert ((dec.target >= TAU) & (dec.target <= N)).all()
    assert torch.equal(dec.exit[dec.target == TAU],
                       torch.ones_like(dec.exit[dec.target == TAU]))
    with pytest.raises(ValueError, match="feature matrix"):
        policies.policy_step(pol, h=TAU - 1, phi=phi, patience_ctr=ctr,
                             target=target)


def test_constructors_match_the_reference(models):
    for name in LEARNED:
        j_pol, t_pol = _policy_pair(name, models)
        for f in ("k", "n_probe", "tau", "min_probes", "use_patience",
                  "use_reg", "reg_with_intersections", "use_classifier",
                  "name"):
            assert getattr(t_pol, f) == getattr(j_pol, f), (name, f)
        assert t_pol.delta == int(j_pol.delta)
        assert t_pol.phi == float(j_pol.phi)
        assert t_pol.clf_threshold == float(j_pol.clf_threshold)
        assert t_pol.learned and t_pol.min_probes == TAU


def test_search_refuses_trees_on_another_device(t_index, models, queries):
    _, pol = _policy_pair("classifier", models)
    meta = ensemble_from_arrays(
        *(np.asarray(getattr(models.clf, f)) for f in
          ("feat", "thresh", "left", "right", "value", "base")),
        models.clf.max_depth, device="meta")
    bad = policies.classifier(N, meta, k=K, tau=TAU)
    with pytest.raises(ValueError, match="a tree of the policy lies on meta"):
        search(t_index, queries, bad)
    assert pol.clf.feat.device.type == "cpu"
