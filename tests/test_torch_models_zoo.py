"""Port parity for the rest of the LM zoo's serving path: MLA
(MiniCPM3-4B), the int8 KV cache (Qwen1.5-32B), MoE (DeepSeekMoE-16B,
DBRX) and bf16 master weights, on the reduced configs (2 layers, d=64,
4 heads), through ``forward``, ``prefill`` and ``decode_step`` of
``repro_torch.models.transformer`` against the reference's, on the
reference's weights carried across with ``params_from_numpy``.

Tolerances:
- logits: ``LOGIT_ATOL`` (0.02, tests/test_torch_models_lm.py's) at a
  logit scale up to 1, in proportion above it.  Both sides compute in
  bf16 and round in different places, under 2% of the logits' scale.
  Readings (these tests' inputs, CPU): MiniCPM3's tied head, scale
  0.52-0.69, at most 0.0087 apart; the untied heads, scale 3.05-4.63,
  at most 0.058 (Qwen), 0.046 (DBRX) and 0.078 (DeepSeekMoE, 1.84% of
  its scale 4.26) apart.
- MoE: both sides' expert choices are recorded, the port's through
  ``moe.route_log`` and the reference's by a callback beside its
  ``_moe_core``.  A token may take other experts than the reference's
  only where its first differing layer is a near tie on the port's
  side: the k-th and (k+1)-th router probabilities within
  ``ROUTE_GAP``.  The one such token in these inputs (DeepSeekMoE,
  forward, f32 weights) differs at a gap of 6.4e-5 and its logits by
  1.58.  A token whose experts differ leaves the logits compared; at
  most ``FLIP_SHARE`` of a call's tokens may, and each test prints the
  count and keeps it in its ``user_properties`` ("flipped_tokens").
- the pieces on identical inputs: ``quantize_kv`` bit for bit,
  ``decode_attn`` with int8 scales 1e-6 (f32 sums), ``mla_decode``
  2% of its output's scale (bf16 output projection), the flash plain
  version at (96, 64) 2e-5 (f32 sums).
"""
import dataclasses
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch, reduced
from repro.models import attention as j_attn
from repro.models import moe as j_moe
from repro.models import transformer as jtf
from repro.models.layers import dense as j_dense
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.models import attention as t_attn
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import from_numpy, tree_map

ARCHS = ["minicpm3-4b", "qwen1.5-32b", "deepseek-moe-16b", "dbrx-132b"]
LM_ARCHS = ARCHS + ["starcoder2-3b"]
LOGIT_ATOL = 0.02
ROUTE_GAP = 2e-4     # 3x the gap of the one differing choice measured
FLIP_SHARE = 0.05    # measured: 1 token of 66
KIND = {"minicpm3-4b": "mla", "qwen1.5-32b": "gqa8",
        "deepseek-moe-16b": "gqa", "dbrx-132b": "gqa"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one intra-op thread (ROADMAP ground rules)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    cfg = reduced(get_arch(arch)).model
    tcfg = t_reduced(t_get_arch(arch)).model
    return dataclasses.replace(cfg, **kw), dataclasses.replace(tcfg, **kw)


@contextmanager
def _ref_routes():
    """The reference's expert choices, one (T, K) array per MoE call: its
    router product and ``top_k`` on ``_moe_core``'s own input."""
    calls, core = [], j_moe._moe_core

    def observed(p, x, cfg):
        probs = jax.nn.softmax(j_dense(p["router"], x.reshape(-1, x.shape[-1]),
                                       dtype=jnp.float32), axis=-1)
        jax.debug.callback(lambda e: calls.append(np.asarray(e)),
                           jax.lax.top_k(probs, cfg.moe.top_k)[1],
                           ordered=True)
        return core(p, x, cfg)

    j_moe._moe_core = observed
    try:
        yield calls
    finally:
        j_moe._moe_core = core


def _flipped(ref_calls, log, shape, request):
    """(B, S) tokens whose experts differ between the two sides in some
    MoE layer.  A token's first differing layer must be a near tie on
    the port's side (after it the token's hidden states differ by
    design); at most FLIP_SHARE of the tokens may differ."""
    jax.effects_barrier()
    assert len(ref_calls) == len(log.calls)
    hit = np.zeros(int(np.prod(shape)), dtype=bool)
    for ref_e, (probs, top_e, _) in zip(ref_calls, log.calls):
        k = top_e.shape[1]
        diff = (np.sort(ref_e, -1) != np.sort(top_e.numpy(), -1)).any(-1)
        srt = -np.sort(-probs.numpy(), -1)
        gap = srt[:, k - 1] - srt[:, k]
        first = diff & ~hit
        assert (gap[first] < ROUTE_GAP).all(), gap[first]
        hit |= diff
    request.node.user_properties.append(("flipped_tokens", int(hit.sum())))
    print(f"{int(hit.sum())} of {hit.size} tokens routed otherwise than the "
          f"reference's")
    assert hit.mean() <= FLIP_SHARE, f"{int(hit.sum())} of {hit.size} tokens"
    return hit.reshape(shape)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    arch = request.param
    cfg, tcfg = _cfgs(arch)
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = ttf.params_from_numpy(tcfg, tree, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    with _ref_routes() as routes:
        full, aux = jtf.forward(cfg, jp, jnp.asarray(toks))
        jax.effects_barrier()
    return dict(arch=arch, cfg=cfg, tcfg=tcfg, jp=jp, tree=tree, tp=tp,
                toks=toks, full=np.asarray(full), aux=float(aux),
                routes=routes)


def _close(got, want, skip=None):
    """Logits within LOGIT_ATOL x max(1, their scale), rows in ``skip``
    (tokens routed otherwise than the reference's) left out."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    atol = LOGIT_ATOL * max(1.0, float(np.abs(want).max()))
    if skip is not None:
        got, want = got[~skip], want[~skip]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_forward_matches_reference(lm, request):
    with t_moe.route_log() as log:
        got, aux = ttf.forward(lm["tcfg"], lm["tp"], lm["toks"])
    skip = _flipped(lm["routes"], log, lm["toks"].shape, request)
    assert got.dtype == torch.float32
    _close(got, lm["full"], skip)
    # aux: a sum over MoE layers of f32 means; 0 without MoE
    assert abs(float(aux) - lm["aux"]) <= 1e-4 * max(1.0, lm["aux"])


def _both(j_call, t_call, shape, request):
    """Run the reference's and the port's call with their routing
    recorded: (reference's result, port's, tokens routed otherwise)."""
    with _ref_routes() as routes:
        want = j_call()
    with t_moe.route_log() as log:
        got = t_call()
    return want, got, _flipped(routes, log, shape, request)


def test_prefill_and_decode_match_reference(lm, request):
    cfg, tcfg, toks = lm["cfg"], lm["tcfg"], lm["toks"]
    (j_lg, j_cache), (t_lg, t_cache), skip = _both(
        lambda: jtf.prefill(cfg, lm["jp"], jnp.asarray(toks[:, :16]),
                            max_seq=33),
        lambda: ttf.prefill(tcfg, lm["tp"], toks[:, :16], max_seq=33),
        (2, 16), request)
    _close(t_lg, j_lg, skip[:, -1])
    assert t_cache.kind == j_cache.kind == KIND[lm["arch"]]
    for jc, tc in zip(j_cache.data, t_cache.data):
        assert tuple(tc.shape) == jc.shape
        assert str(tc.dtype).split(".")[1] == str(jc.dtype)
        assert not tc[:, :, 16:].float().any()       # padding past the prompt
        jc, tcf = np.asarray(jc, np.float32), tc.float().numpy()
        if tc.dtype == torch.int8:
            # a code may round the other way where the bf16 inputs differ
            assert np.abs(tcf - jc).max() <= 0.05 * 127
        else:
            np.testing.assert_allclose(tcf, jc, atol=0.05 * np.abs(jc).max())
    for pos in (16, 17):
        (j_lg, j_cache), (t_lg, t_cache), skip = _both(
            lambda: jtf.decode_step(cfg, lm["jp"], j_cache,
                                    jnp.asarray(toks[:, pos: pos + 1]),
                                    jnp.asarray(pos)),
            lambda: ttf.decode_step(tcfg, lm["tp"], t_cache,
                                    toks[:, pos: pos + 1], pos),
            (2,), request)
        _close(t_lg, j_lg, skip)


def test_decode_from_an_empty_cache_matches_reference(lm, request):
    """``init_cache`` then decode steps from position 0, no prefill."""
    cfg, tcfg, toks = lm["cfg"], lm["tcfg"], lm["toks"]
    j_cache = jtf.init_cache(cfg, 2, 8)
    t_cache = ttf.init_cache(tcfg, 2, 8, device="cpu")
    assert t_cache.kind == j_cache.kind
    assert [tuple(c.shape) for c in t_cache.data] == \
        [c.shape for c in j_cache.data]
    for jc, tc in zip(j_cache.data, t_cache.data):
        np.testing.assert_array_equal(tc.float().numpy(),
                                      np.asarray(jc, np.float32))
    for pos in range(3):
        (j_lg, j_cache), (t_lg, t_cache), skip = _both(
            lambda: jtf.decode_step(cfg, lm["jp"], j_cache,
                                    jnp.asarray(toks[:, pos: pos + 1]),
                                    jnp.asarray(pos)),
            lambda: ttf.decode_step(tcfg, lm["tp"], t_cache,
                                    toks[:, pos: pos + 1], pos),
            (2,), request)
        _close(t_lg, j_lg, skip)


def test_prefill_decode_consistent_with_forward(lm):
    """The port's own serving path against its forward, with the bounds
    of tests/test_models_lm.py::test_smoke_decode_consistency (the
    reduced MoE configs are drop-free, as the reference's)."""
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


# -- init, weights, parameter counts ------------------------------------------


def _stacked(params):
    """The port's params with ``layers`` stacked as the reference's."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *xs: torch.stack(xs),
                                 *params["layers"])
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_params_has_reference_shapes(arch, param_dtype):
    cfg, tcfg = _cfgs(arch, param_dtype=param_dtype)
    want = jtf.abstract_params(cfg)
    got = ttf.init_params(tcfg, seed=0, device="cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(_stacked(got))
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(w.shape) == tuple(g.shape)
        assert str(g.dtype).split(".")[1] == str(w.dtype)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_parameter_count_matches_config(arch):
    """The reference tree's count is the config's ``param_count()`` plus
    ``ln_f``, plus MLA's two latent norms a layer (``q_norm``,
    ``kv_norm``: ``param_count`` leaves them out), and the port's equals
    it."""
    cfg, tcfg = _cfgs(arch)
    extra = cfg.d_model
    if cfg.attn_type == "mla":
        extra += cfg.n_layers * (cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank)
    want = sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(jtf.abstract_params(cfg)))
    assert want == cfg.param_count() + extra
    leaves = []
    tree_map(leaves.append, ttf.init_params(tcfg, seed=0, device="cpu"))
    assert sum(t.numel() for t in leaves) == want


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b"])
def test_bf16_master_weights_carried_bit_for_bit(arch):
    cfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jtf.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    tp = _stacked(ttf.params_from_numpy(tcfg, tree, device="cpu"))
    flat_w = jax.tree.leaves(tree)
    flat_g = jax.tree.leaves(tp)
    assert len(flat_w) == len(flat_g)
    for w, g in zip(flat_w, flat_g):
        assert w.dtype.name == "bfloat16" and g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      w.view(np.int16))


def test_from_numpy_keeps_dtypes_and_bits():
    bits = np.array([0x3F80, 0x0001, 0x7F80, 0xFF80, 0x7FC1, 0x8000],
                    dtype=np.uint16)
    a = bits.view(jnp.bfloat16.dtype)
    t = from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  bits.view(np.int16))
    for dt in (np.float32, np.int32, np.int8):
        x = np.arange(6).astype(dt)
        x.setflags(write=False)
        assert from_numpy(x, "cpu").dtype == getattr(torch, np.dtype(dt).name)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_bf16_master_weights_forward_matches_reference(arch, request):
    cfg, tcfg = _cfgs(arch, param_dtype="bfloat16")
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tp = ttf.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    (want, _), (got, _), skip = _both(
        lambda: jtf.forward(cfg, jp, jnp.asarray(toks)),
        lambda: ttf.forward(tcfg, tp, toks), toks.shape, request)
    _close(got, want, skip)


# -- the int8 KV cache --------------------------------------------------------


def test_quantize_kv_bit_for_bit():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 5, 2, 16)) * rng.uniform(0.01, 10, (3, 5, 2, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                        # an all-zero vector: scale 1e-8
    x[1, 1, 1, :4] = [127.0, 0.5, -0.5, 1.5]   # halves: round to even
    for dtype in (np.float32, jnp.bfloat16):
        jx = jnp.asarray(x, dtype)
        want_q, want_s = j_attn.quantize_kv(jx)
        tx = from_numpy(np.asarray(jx), "cpu")
        got_q, got_s = t_attn.quantize_kv(tx)
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        back = t_attn.dequantize_kv(got_q, got_s)
        np.testing.assert_array_equal(
            back.float().numpy(),
            np.asarray(j_attn.dequantize_kv(want_q, want_s), np.float32))


def test_cache_update_writes_the_quantized_row_and_scale():
    rng = np.random.default_rng(5)
    new = rng.normal(size=(2, 1, 3, 16)).astype(np.float32)
    k = torch.zeros((2, 6, 3, 16), dtype=torch.int8)
    sc = torch.ones((2, 6, 3))
    t_attn.cache_update(k, sc, torch.from_numpy(new), 4)
    jk, js = j_attn.cache_update(jnp.zeros((2, 6, 3, 16), jnp.int8),
                                 jnp.ones((2, 6, 3)), jnp.asarray(new),
                                 jnp.asarray(4))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(js))


def test_int8_kv_cache_is_half_the_bf16_one():
    cfg = t_reduced(t_get_arch("qwen1.5-32b")).model
    c8 = t_attn.init_kv_cache(cfg, 2, 64, device="cpu")
    c16 = t_attn.init_kv_cache(dataclasses.replace(
        cfg, kv_cache_dtype="bfloat16"), 2, 64, device="cpu")
    assert c8.k.dtype == torch.int8 and c8.k_scale.dtype == torch.float32
    assert c8.k.data_ptr() != c8.v.data_ptr()     # written in place
    assert (c8.k_scale == 1).all() and c16.k_scale is None

    def nbytes(c):
        return sum(t.numel() * t.element_size() for t in c if t is not None)

    # int8 data plus one f32 scale per hd-vector: (hd + 4) / (2 hd)
    hd = cfg.head_dim()
    assert nbytes(c8) / nbytes(c16) == (hd + 4) / (2 * hd)


def test_decode_attn_with_int8_scales_matches_reference():
    """The scales folded after the QK dot and into the probabilities, in
    the reference's order; atol 1e-6 (f32 sums)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 1, 2, 3, 16)).astype(np.float32)
    kc = rng.integers(-127, 128, (2, 12, 2, 16)).astype(np.int8)
    vc = rng.integers(-127, 128, (2, 12, 2, 16)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (2, 12, 2)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (2, 12, 2)).astype(np.float32)
    want = j_attn.decode_attn(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(ks),
                              jnp.asarray(vs), jnp.asarray(7))
    got = t_attn.decode_attn(*(torch.from_numpy(a) for a in (q, kc, vc)), 7,
                             torch.from_numpy(ks), torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# -- MLA ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla():
    cfg, tcfg = _cfgs("minicpm3-4b")
    p = jax.tree.map(np.asarray, j_attn.mla_init(jax.random.PRNGKey(3), cfg))
    tp = tree_map(lambda a: from_numpy(a, "cpu"), p)
    x = np.random.default_rng(6).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, p, tp, x


def test_mla_forward_matches_reference(mla):
    cfg, tcfg, p, tp, x = mla
    pos = np.broadcast_to(np.arange(12), (2, 12))
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(j_attn.mla_forward(jax.tree.map(jnp.asarray, p), jx,
                                         cfg, jnp.asarray(pos)), np.float32)
    got, ckv, kr = t_attn.mla_forward(
        tp, from_numpy(np.asarray(jx), "cpu"), tcfg,
        torch.from_numpy(np.array(pos)), return_latent=True)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=0.02 * np.abs(want).max())
    _, _, j_ckv, j_kr = j_attn._mla_qkv(jax.tree.map(jnp.asarray, p), jx, cfg,
                                        jnp.asarray(pos))
    assert tuple(ckv.shape) == j_ckv.shape and tuple(kr.shape) == \
        j_kr[:, :, 0].shape


def test_mla_decode_matches_reference(mla):
    """One absorbed-matrix step over a latent cache holding a prefix:
    the new latents written at ``pos`` exactly as the reference's, the
    output within 2% of its scale (bf16 projections)."""
    cfg, tcfg, p, tp, x = mla
    m = cfg.mla
    rng = np.random.default_rng(7)
    ckv = rng.normal(size=(2, 10, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(2, 10, m.qk_rope_head_dim)).astype(np.float32)
    jc = (jnp.asarray(ckv, jnp.bfloat16), jnp.asarray(kr, jnp.bfloat16))
    jx = jnp.asarray(x[:, :1], jnp.bfloat16)
    want, (w_ckv, w_kr) = j_attn.mla_decode(jax.tree.map(jnp.asarray, p), jx,
                                            cfg, jc, jnp.asarray(6))
    t_ckv, t_kr = (from_numpy(np.asarray(a), "cpu") for a in jc)
    got = t_attn.mla_decode(tp, from_numpy(np.asarray(jx), "cpu"), tcfg,
                            t_ckv, t_kr, 6)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=0.02 * np.abs(want).max())
    for g, w in ((t_ckv, w_ckv), (t_kr, w_kr)):
        w = np.asarray(w, np.float32)
        np.testing.assert_array_equal(g[:, :6].float().numpy(), w[:, :6])
        np.testing.assert_array_equal(g[:, 7:].float().numpy(), w[:, 7:])
        np.testing.assert_allclose(g[:, 6].float().numpy(), w[:, 6],
                                   atol=0.02 * np.abs(w[:, 6]).max())


def test_mla_cache_is_small():
    """tests/test_models_lm.py::test_mla_cache_is_small's rule on the
    port's caches: the latent cache under 1/10 of the per-head K/V cache
    at MiniCPM3's widths."""
    cfg = t_get_arch("minicpm3-4b").model
    small = dataclasses.replace(cfg, n_layers=1)
    c = ttf.init_cache(small, 1, 16, device="cpu")
    assert c.kind == "mla"
    mla_bytes = sum(t.numel() * t.element_size() for t in c.data)
    gqa = ttf.init_cache(dataclasses.replace(small, attn_type="gqa", mla=None),
                         1, 16, device="cpu")
    gqa_bytes = sum(t.numel() * t.element_size() for t in gqa.data)
    assert mla_bytes < gqa_bytes / 10


# -- the flash kernel's plain version at MLA's head dims ----------------------


@pytest.mark.parametrize("s", [16, 33])
def test_flash_plain_at_qk96_v64_matches_causal_chunk_attn(s):
    """(BH, S, 96) q, k and (BH, S, 64) v through the plain version
    against the reference's chunked attention (f32: P is not rounded on
    either side), scale 1/sqrt(96)."""
    rng = np.random.default_rng(s)
    q, k = (rng.normal(size=(2, s, 3, 96)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(2, s, 3, 64)).astype(np.float32)
    want = j_attn._causal_chunk_attn(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), 16)

    def flat(a):
        return torch.from_numpy(a).permute(0, 2, 1, 3).reshape(
            6, s, a.shape[-1])

    got = t_fa.flash_attention(flat(q), flat(k), flat(v), causal=True)
    assert got.shape == (6, s, 64)
    got = got.reshape(2, 3, s, 64).permute(0, 2, 1, 3).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
