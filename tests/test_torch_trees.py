"""Port parity for the tree ensembles: the NumPy GBDT and SMOTE copies
give the reference's forests and samples exactly, ``from_numpy_forest``
packs them into the reference's arrays exactly, and ``predict_margin``
agrees with the JAX gather descent within rtol 1e-5 / atol 1e-5 (the
port sums the trees' leaves pairwise, the reference with ``jnp.sum``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.trees import gbdt as j_gbdt
from repro.trees import jax_infer
from repro.trees import smote as j_smote
from repro_torch.trees import (GBDT, ensemble_from_arrays, from_numpy_forest,
                               predict_margin, predict_proba, smote)

TREE_FIELDS = ("feat", "thresh", "left", "right", "value")


def _data(n=600, f=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = x[:, 0] * 2 + np.sin(3 * x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y


def _fit(module, objective, weighted, n_trees=12, max_depth=4):
    x, y = _data()
    if objective == "logistic":
        y = (y > 0.3).astype(np.float64)
    w = np.where(y[:450] > 0.5, 3.0, 1.0) if weighted else None
    model = module(objective, n_trees=n_trees, max_depth=max_depth, seed=0,
                   colsample=0.7)
    return model.fit(x[:450], y[:450], sample_weight=w,
                     eval_set=(x[450:], y[450:]))


@pytest.fixture(scope="module")
def forests():
    return {(obj, w): (_fit(j_gbdt.GBDT, obj, w), _fit(GBDT, obj, w))
            for obj in ("l2", "logistic") for w in (False, True)}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", ["l2", "logistic"])
def test_gbdt_copy_fits_the_reference_forest(forests, objective, weighted):
    want, got = forests[(objective, weighted)]
    assert got.base == want.base
    assert got.best_iteration == want.best_iteration
    assert len(got.trees) == len(want.trees)
    for gt, wt in zip(got.trees, want.trees):
        for f in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(gt, f), getattr(wt, f),
                                          err_msg=f)


@pytest.mark.parametrize("target_ratio", [1.0, 0.5])
def test_smote_copy_draws_the_reference_samples(target_ratio):
    x, y = _data(n=300, f=6, seed=1)
    labels = (y > 1.2).astype(np.float64)           # a minority class
    want = j_smote.smote(x, labels, seed=3, target_ratio=target_ratio)
    got = smote(x, labels, seed=3, target_ratio=target_ratio)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("objective", ["l2", "logistic"])
def test_from_numpy_forest_packs_the_reference_arrays(forests, objective):
    forest = forests[(objective, True)][1]
    want = jax_infer.from_numpy_forest(forest, 4)
    got = from_numpy_forest(forest, 4, device="cpu")
    for f in TREE_FIELDS + ("base",):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.max_depth == want.max_depth and got.n_trees == want.n_trees
    carried = ensemble_from_arrays(
        *(np.asarray(getattr(want, f)) for f in TREE_FIELDS + ("base",)),
        want.max_depth, device="cpu")
    for f in TREE_FIELDS + ("base",):
        assert torch.equal(getattr(carried, f), getattr(got, f)), f


@pytest.mark.parametrize("objective", ["l2", "logistic"])
def test_predict_margin_matches_reference(forests, objective):
    forest = forests[(objective, False)][1]
    j_ens = jax_infer.from_numpy_forest(forest, 4)
    t_ens = from_numpy_forest(forest, 4, device="cpu")
    x = np.random.default_rng(5).normal(size=(257, 12)).astype(np.float32)
    # rows sitting exactly on split thresholds go left on both sides
    thr = forest.trees[0].thresh[0]
    x[:8, forest.trees[0].feat[0]] = thr
    want = np.asarray(jax_infer.predict_margin(j_ens, jnp.asarray(x)))
    got = predict_margin(t_ens, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        predict_proba(t_ens, torch.from_numpy(x)).numpy(),
        np.asarray(jax_infer.predict_proba(j_ens, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    # and the NumPy trainer's own predictor
    np.testing.assert_allclose(got, GBDT().predict_margin(forest, x),
                               rtol=1e-5, atol=1e-5)


def test_predict_margin_is_row_independent(forests):
    """A row's margin has the same bits alone and inside a batch."""
    t_ens = from_numpy_forest(forests[("l2", True)][1], 4, device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=(64, 12)).astype(np.float32))
    whole = predict_margin(t_ens, x)
    parts = torch.cat([predict_margin(t_ens, x[i:i + 1]) for i in range(64)])
    assert torch.equal(whole, parts)
