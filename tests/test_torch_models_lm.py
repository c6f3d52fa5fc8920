"""Port parity for the LM serving path: StarCoder2-3B's reduced config
(2 layers, d=64, 4 heads, kv=2, hd=16, GELU, tied embeddings) through
``gqa_forward``, ``forward``, ``prefill`` and ``decode_step`` of
``repro_torch.models`` against the reference's, on the reference's
weights carried across with ``params_from_numpy``.

Tolerances: the model computes in bf16 on both sides, and the two
frameworks round in different places (XLA's bf16 ops, the reference's
bf16 probabilities before P V where the flash kernel's plain version
keeps them in f32), so outputs agree to bf16 precision: logits within
0.02 (measured about 0.007 at a logit scale of 0.65), hidden states
within 2% of their scale.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch, reduced
from repro.models import attention as j_attn
from repro.models import transformer as jtf
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as ttf

ARCH = "starcoder2-3b"
LOGIT_ATOL = 0.02


@pytest.fixture(scope="module")
def lm():
    cfg = reduced(get_arch(ARCH)).model
    tcfg = t_reduced(t_get_arch(ARCH)).model
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = ttf.params_from_numpy(tcfg, tree, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    full, _ = jtf.forward(cfg, jp, jnp.asarray(toks))
    return dict(cfg=cfg, tcfg=tcfg, jp=jp, tree=tree, tp=tp, toks=toks,
                full=np.asarray(full))


def _log_softmax(x):
    return torch.log_softmax(torch.as_tensor(np.asarray(x)), -1)


def test_config_copy_equals_reference():
    """The port's copy of every config holds the reference's values (the
    classes differ: each package has its own)."""
    from repro.configs import list_archs
    from repro_torch.configs import list_archs as t_list_archs
    assert t_list_archs() == list_archs()
    for arch in list_archs():
        for fn, t_fn in ((lambda a: a, lambda a: a), (reduced, t_reduced)):
            want, got = fn(get_arch(arch)), t_fn(t_get_arch(arch))
            assert dataclasses.asdict(got.model) == \
                dataclasses.asdict(want.model)
            assert [dataclasses.asdict(s) for s in got.shapes] == \
                [dataclasses.asdict(s) for s in want.shapes]
            assert (got.arch_id, got.family, got.source) == \
                (want.arch_id, want.family, want.source)


def test_init_params_has_reference_shapes():
    """The port's own init draws every tensor at the reference's shape;
    the layers are a list where the reference stacks them."""
    cfg = reduced(get_arch(ARCH)).model
    want = jtf.abstract_params(cfg)
    got = ttf.init_params(t_reduced(t_get_arch(ARCH)).model, seed=0,
                          device="cpu")
    assert len(got["layers"]) == cfg.n_layers
    stacked = {k: v for k, v in got.items() if k != "layers"}
    stacked["layers"] = jax.tree.map(
        lambda *xs: torch.stack(xs), *got["layers"])
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(stacked)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(w.shape) == tuple(g.shape)
        assert g.dtype == torch.float32


def test_gqa_forward_matches_reference(lm):
    cfg, tcfg = lm["cfg"], lm["tcfg"]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 33, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(33), (2, 33))
    lp = jax.tree.map(lambda a: a[0], lm["jp"]["layers"])["attn"]
    want = j_attn.gqa_forward(lp, jnp.asarray(x, jnp.bfloat16), cfg,
                              jnp.asarray(pos))
    got = t_attn.gqa_forward(lm["tp"]["layers"][0]["attn"],
                             torch.from_numpy(x).to(torch.bfloat16), tcfg,
                             torch.from_numpy(np.array(pos)))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 33, cfg.d_model)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.02 * scale)


def test_forward_matches_reference(lm):
    got, aux = ttf.forward(lm["tcfg"], lm["tp"], lm["toks"])
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), lm["full"], atol=LOGIT_ATOL)


def test_prefill_and_decode_match_reference(lm):
    cfg, tcfg, toks = lm["cfg"], lm["tcfg"], lm["toks"]
    j_lg, j_cache = jtf.prefill(cfg, lm["jp"], jnp.asarray(toks[:, :16]),
                                max_seq=33)
    t_lg, t_cache = ttf.prefill(tcfg, lm["tp"], toks[:, :16], max_seq=33)
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg),
                               atol=LOGIT_ATOL)
    assert t_cache.kind == j_cache.kind == "gqa"
    for jc, tc in zip(j_cache.data, t_cache.data):
        assert tuple(tc.shape) == jc.shape and tc.dtype == torch.bfloat16
        jc = np.asarray(jc, np.float32)
        np.testing.assert_allclose(tc.float().numpy(), jc,
                                   atol=0.02 * np.abs(jc).max())
        assert not tc[:, :, 16:].any()             # padding past the prompt
    pos = 16
    for _ in range(2):
        j_lg, j_cache = jtf.decode_step(cfg, lm["jp"], j_cache,
                                        jnp.asarray(toks[:, pos: pos + 1]),
                                        jnp.asarray(pos))
        t_lg, t_cache = ttf.decode_step(tcfg, lm["tp"], t_cache,
                                        toks[:, pos: pos + 1], pos)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg),
                                   atol=LOGIT_ATOL)
        pos += 1


def test_decode_from_an_empty_cache_matches_reference(lm):
    """``init_cache`` then decode steps from position 0, no prefill."""
    cfg, tcfg, toks = lm["cfg"], lm["tcfg"], lm["toks"]
    j_cache = jtf.init_cache(cfg, 2, 8)
    t_cache = ttf.init_cache(tcfg, 2, 8, device="cpu")
    assert [tuple(c.shape) for c in t_cache.data] == \
        [c.shape for c in j_cache.data]
    for pos in range(3):
        j_lg, j_cache = jtf.decode_step(cfg, lm["jp"], j_cache,
                                        jnp.asarray(toks[:, pos: pos + 1]),
                                        jnp.asarray(pos))
        t_lg, t_cache = ttf.decode_step(tcfg, lm["tp"], t_cache,
                                        toks[:, pos: pos + 1], pos)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg),
                                   atol=LOGIT_ATOL)
    np.testing.assert_allclose(t_lg.numpy(), lm["full"][:, 2],
                               atol=LOGIT_ATOL)


def test_prefill_decode_consistent_with_forward(lm):
    """The port's own serving path against its forward, with the bounds
    of tests/test_models_lm.py::test_smoke_decode_consistency."""
    tcfg, tp, toks = lm["tcfg"], lm["tp"], lm["toks"]
    full, _ = ttf.forward(tcfg, tp, toks)
    lg, cache = ttf.prefill(tcfg, tp, toks[:, :16], max_seq=33)
    err = (torch.log_softmax(lg, -1)
           - torch.log_softmax(full[:, 15], -1)).abs().max()
    assert float(err) < 0.15
    for pos in (16, 17):
        lg, cache = ttf.decode_step(tcfg, tp, cache, toks[:, pos: pos + 1],
                                    pos)
        err = (torch.log_softmax(lg, -1)
               - torch.log_softmax(full[:, pos], -1)).abs().max()
        assert float(err) < 0.25, (pos, float(err))


def test_decode_attn_matches_reference():
    """The cache attention alone, f32 in and out, pos inside the cache:
    the same bf16 roundings on both sides (atol 1e-6: f32 sums)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 1, 2, 3, 16)).astype(np.float32)
    kc = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    want = j_attn.decode_attn(jnp.asarray(q), jnp.asarray(kc, jnp.bfloat16),
                              jnp.asarray(vc, jnp.bfloat16), None, None,
                              jnp.asarray(7))
    got = t_attn.decode_attn(torch.from_numpy(q),
                             torch.from_numpy(kc).to(torch.bfloat16),
                             torch.from_numpy(vc).to(torch.bfloat16), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("arch,what", [("minicpm3-4b", "MLA"),
                                       ("deepseek-moe-16b", "MoE")])
def test_unported_models_raise(arch, what):
    cfg = t_reduced(t_get_arch(arch)).model
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttf.init_params(cfg, device="cpu")


def test_int8_kv_cache_raises():
    cfg = t_reduced(t_get_arch("qwen1.5-32b")).model
    params = ttf.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="int8 KV cache"):
        ttf.prefill(cfg, params, np.zeros((1, 4), np.int32))
    logits, _ = ttf.forward(cfg, params, np.zeros((1, 4), np.int32))
    assert logits.shape == (1, 4, cfg.vocab_size)
