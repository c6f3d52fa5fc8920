"""Port parity for the recsys serving path: ``serve_logits`` of DeepFM,
DCN-v2, xDeepFM and two-tower retrieval at their reduced configs,
against the reference's, on the reference's weights carried across
with ``params_from_numpy`` and one ``click_log`` batch.

Tolerance: rtol 1e-5 (atol 1e-7 for logits near 0).  Both sides run in
f32, but sums go in other orders: XLA's ``emb.sum(axis=1)`` against the
bag kernel's plain version, which adds rows in field order, and the
two frameworks' matrix products.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch, reduced
from repro.data.synthetic import click_log as j_click_log
from repro.models import recsys as jr
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.data.synthetic import click_log, token_stream
from repro_torch.models import recsys as trs

ARCHS = ["deepfm", "dcn-v2", "xdeepfm", "two-tower-retrieval"]


def _pair(arch):
    cfg = reduced(get_arch(arch)).model
    jp = jr.init_params(cfg, jax.random.PRNGKey(0))
    tp = trs.params_from_numpy(t_reduced(t_get_arch(arch)).model,
                               jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, t_reduced(t_get_arch(arch)).model, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_logits_match_reference(arch):
    cfg, tcfg, jp, tp = _pair(arch)
    batch = click_log(16, cfg.n_dense, cfg.n_sparse, cfg.rows_per_field,
                      seed=3)
    want = jr.serve_logits(cfg, jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    got = trs.serve_logits(tcfg, tp, batch)
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_reference_shapes(arch):
    cfg = reduced(get_arch(arch)).model
    want = jax.eval_shape(lambda k: jr.init_params(cfg, k),
                          jax.random.PRNGKey(0))
    got = trs.init_params(t_reduced(t_get_arch(arch)).model, seed=0,
                          device="cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(w.shape) == tuple(g.shape)


def test_deepfm_sums_bags_through_the_kernel(monkeypatch):
    """The FM term's two bag sums go through ``ops.embedding_bag`` over
    the combined-table rows; the logits equal the same forward computed
    from ``emb.sum(1)`` within f32 rounding."""
    cfg, tcfg, _, tp = _pair("deepfm")
    batch = click_log(8, cfg.n_dense, cfg.n_sparse, cfg.rows_per_field,
                      seed=4)
    calls = []
    real = trs.ops.embedding_bag

    def counting(table, ids):
        calls.append((tuple(table.shape), tuple(ids.shape)))
        return real(table, ids)

    monkeypatch.setattr(trs.ops, "embedding_bag", counting)
    got = trs.serve_logits(tcfg, tp, batch)
    rows = trs.table_rows(tcfg)
    assert calls == [((rows, 1), (8, cfg.n_sparse)),
                     ((rows, cfg.embed_dim), (8, cfg.n_sparse))]
    ids = torch.from_numpy(batch["sparse"])
    emb = trs.embedding_lookup(tp["table"], ids, tcfg)
    lin = trs.embedding_lookup(tp["linear_table"], ids,
                               trs.dataclass_like(tcfg)).sum((1, 2))
    sv = emb.sum(1)
    fm = 0.5 * (sv * sv - (emb * emb).sum(1)).sum(1)
    deep = trs._mlp_apply(tp["mlp"], emb.reshape(8, -1))[:, 0]
    torch.testing.assert_close(got, lin + fm + deep, rtol=1e-5, atol=1e-7)


def test_generators_match_reference():
    from repro.data.synthetic import token_stream as j_token_stream
    np.testing.assert_array_equal(token_stream(1000, 512, seed=5),
                                  j_token_stream(1000, 512, seed=5))
    a, b = click_log(64, 13, 26, 1000, seed=6), \
        j_click_log(64, 13, 26, 1000, seed=6)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
