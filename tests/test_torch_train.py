"""Port parity for the training path: ``loss_fn`` and its gradients for
every LM arch's and every recsys arch's reduced config, ``score_candidates``,
the retriever's ``contrastive_loss``, and the two kernel ``Function``s'
gradients, against the reference's ``jax.grad`` on the reference's
weights carried across with ``params_from_numpy``.

Tolerances, each from a reading of these tests' inputs on the CPU:
- LM ``loss_fn``: the loss within ``LOSS_RTOL`` (1e-3; read at most 2.1e-4,
  DBRX) and every gradient leaf within ``GRAD_RTOL`` (0.06) of
  the leaf's max |reference| (read at most 0.037, Qwen).  Both sides
  compute in bf16 and round in different places: the plain flash
  forward keeps P in f32 where the reference rounds it to bf16, XLA and
  PyTorch round other products and sums otherwise.
- MoE: a token whose experts differ between the two sides in some layer
  (both sides' choices recorded as tests/test_torch_models_zoo.py
  records them) must be a near tie on the port's side, its k-th and
  (k+1)-th router probabilities within ``ROUTE_GAP`` (1e-3; read at most
  2.8e-4); its label is masked (-1) on both sides before the gradients
  are taken, so its own loss leaves both (read: 3 of 128 tokens for
  DeepSeekMoE, 5 for DBRX).  The reference runs under ``jax.jit``.
- recsys ``loss_fn`` (f32 throughout): the loss within 1e-6 and each
  gradient leaf within 1e-5 of its scale (read at most 1.2e-6).
- the flash ``Function``: its backward computes the reference's own
  chunked function in the reference's rounding, so dq, dk and dv are
  within 2^-6 of each gradient's scale in bf16, two bf16 ulps at the
  top binade (read: dv bit for bit, dq and dk one ulp apart on under
  0.02% of the entries, at most 2^-12 of the scale) and 1e-6 in f32.
- the embedding_bag ``Function`` and ``gather_rows``: the table gradient
  bit for bit the reference's serial scatter-add.

Tests marked ``gpu`` hold each ``Function``'s gradients on the card
against the plain path (the flash one within 2^-5 of each gradient's
scale: see its docstring) and skip without one.  The reference is imported
by a fixture, so they run on the card's machine, which has no JAX:
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_train.py``.
"""
import dataclasses
import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import embedding_bag as t_eb
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.launch.train import value_and_grad
from repro_torch.models import attention as t_attn
from repro_torch.models import moe as t_moe
from repro_torch.models import recsys as t_rec
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import cross_entropy_loss, gather_rows

ROOT = Path(__file__).resolve().parent.parent
LM_ARCHS = ["minicpm3-4b", "qwen1.5-32b", "starcoder2-3b",
            "deepseek-moe-16b", "dbrx-132b"]
RS_ARCHS = ["deepfm", "dcn-v2", "xdeepfm", "two-tower-retrieval"]
LOSS_RTOL, GRAD_RTOL = 1e-3, 0.06
ROUTE_GAP, FLIP_SHARE = 1e-3, 0.05
RS_LOSS_RTOL, RS_GRAD_RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one intra-op thread (ROADMAP ground rules)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference package (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_arch, reduced
    from repro.data.synthetic import click_log
    from repro.models import attention, moe, recsys, transformer
    from repro.models.layers import cross_entropy_loss as ce
    from repro.models.layers import dense
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_arch=get_arch,
                                 reduced=reduced, click_log=click_log,
                                 attention=attention, moe=moe, recsys=recsys,
                                 tf=transformer, ce=ce, dense=dense)


def _stacked(grads):
    """The port's LM gradient tree with its layer list stacked as the
    reference stacks ``layers``."""
    out = {k: v for k, v in grads.items() if k != "layers"}
    out["layers"] = _stack(grads["layers"])
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _leaf_errs(ref, want, got):
    """(keystr, max |got - want| / max |want|) per leaf, in the reference's
    flatten order; ``got`` a tree of tensors of the same structure."""
    jax = ref.jax
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    out = []
    for (path, w), (_, g) in zip(flat_w, flat_g):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        out.append((jax.tree_util.keystr(path),
                    float(np.abs(g - w).max()) / scale if scale else
                    float(np.abs(g).max())))
    return out


def _flipped_tokens(ref, cfg, tcfg, jp, tp, tokens):
    """(B, S) tokens whose experts differ between the two sides' forwards
    in some MoE layer; each first differing choice a near tie."""
    jax, jnp = ref.jax, ref.jnp
    calls, core = [], ref.moe._moe_core

    def observed(p, x, c):
        probs = jax.nn.softmax(ref.dense(p["router"],
                                         x.reshape(-1, x.shape[-1]),
                                         dtype=jnp.float32), axis=-1)
        jax.debug.callback(lambda e: calls.append(np.asarray(e)),
                           jax.lax.top_k(probs, c.moe.top_k)[1],
                           ordered=True)
        return core(p, x, c)

    ref.moe._moe_core = observed
    try:
        jax.jit(lambda p, t: ref.tf.forward(cfg, p, t))(
            jp, jnp.asarray(tokens))
        jax.effects_barrier()
    finally:
        ref.moe._moe_core = core
    with t_moe.route_log() as log:
        ttf.forward(tcfg, tp, tokens)
    assert len(calls) == len(log.calls)
    hit = np.zeros(tokens.size, dtype=bool)
    for ref_e, (probs, top_e, _) in zip(calls, log.calls):
        k = top_e.shape[1]
        diff = (np.sort(ref_e, -1) != np.sort(top_e.numpy(), -1)).any(-1)
        srt = -np.sort(-probs.detach().numpy(), -1)
        gap = srt[:, k - 1] - srt[:, k]
        assert (gap[diff & ~hit] < ROUTE_GAP).all(), gap[diff & ~hit]
        hit |= diff
    assert hit.mean() <= FLIP_SHARE, f"{int(hit.sum())} of {hit.size}"
    return hit.reshape(tokens.shape)


@pytest.fixture(scope="module", params=LM_ARCHS)
def lm(ref, request):
    arch = request.param
    jax, jnp = ref.jax, ref.jnp
    cfg = ref.reduced(ref.get_arch(arch)).model
    tcfg = t_reduced(t_get_arch(arch)).model
    jp = jax.jit(lambda k: ref.tf.init_params(cfg, k))(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = ttf.params_from_numpy(tcfg, tree, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    flipped = np.zeros(batch["tokens"].shape, dtype=bool)
    if cfg.moe:
        flipped = _flipped_tokens(ref, cfg, tcfg, jp, tp, batch["tokens"])
        batch["labels"][flipped] = -1
    # jit: one compile instead of the eager primitives' (3x faster here)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.tf.loss_fn(cfg, p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp, batch=batch,
                flipped=int(flipped.sum()), loss=float(loss),
                aux=float(parts["aux"]), grads=grads)


def test_loss_fn_and_gradients_match_reference(ref, lm, request):
    loss, grads = value_and_grad(
        functools.partial(ttf.loss_fn, lm["tcfg"], batch=lm["batch"]),
        lm["tp"])
    request.node.user_properties.append(("flipped_tokens", lm["flipped"]))
    assert abs(float(loss) - lm["loss"]) <= LOSS_RTOL * abs(lm["loss"])
    errs = _leaf_errs(ref, lm["grads"], _stacked(grads))
    worst = max(errs, key=lambda e: e[1])
    print(f"loss {float(loss)} vs {lm['loss']}; worst leaf {worst}; "
          f"{lm['flipped']} tokens routed otherwise (masked)")
    assert worst[1] <= GRAD_RTOL, worst


def test_loss_fn_aux_matches_reference(lm):
    _, parts = ttf.loss_fn(lm["tcfg"], lm["tp"], lm["batch"])
    if lm["tcfg"].moe is None:
        assert float(parts["aux"]) == lm["aux"] == 0.0
    else:
        assert abs(float(parts["aux"]) - lm["aux"]) <= 1e-3 * lm["aux"]


def test_chunked_ce_equals_forward_plus_cross_entropy(ref):
    """loss_fn's chunked CE (chunks of 8 of 32 tokens, labels with a masked
    one) is forward + cross_entropy_loss + aux; and cross_entropy_loss is
    the reference's on the same logits."""
    cfg = t_reduced(t_get_arch("starcoder2-3b")).model
    tp = ttf.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = toks.copy()
    labels[0, 5] = -1
    loss, parts = ttf.loss_fn(cfg, tp, {"tokens": toks, "labels": labels},
                              ce_chunk=8)
    logits, aux = ttf.forward(cfg, tp, toks)
    lab = torch.from_numpy(labels)
    mask = (lab >= 0).float()
    want = cross_entropy_loss(logits, lab.clamp_min(0), mask) + aux
    assert abs(float(loss) - float(want)) < 1e-5
    assert float(parts["ce"]) == pytest.approx(float(want - aux), abs=1e-5)
    jnp = ref.jnp
    x = rng.normal(size=(3, 7, 50)).astype(np.float32)
    y = rng.integers(0, 50, (3, 7))
    m = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for mk in (None, m):
        got = cross_entropy_loss(torch.from_numpy(x), torch.from_numpy(y),
                                 None if mk is None else torch.from_numpy(mk))
        w = ref.ce(jnp.asarray(x), jnp.asarray(y),
                   None if mk is None else jnp.asarray(mk))
        assert float(got) == pytest.approx(float(w), rel=1e-6)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_changes_no_value(policy):
    """Every layer under activation checkpointing (either policy) gives
    the loss and gradients of the same layers without it, bit for bit."""
    cfg = dataclasses.replace(t_reduced(t_get_arch("starcoder2-3b")).model,
                              remat_policy=policy)
    tp = ttf.init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))

    def loss_of(remat):
        def fn(p):
            h, aux = ttf.forward_hidden(cfg, p, toks, remat=remat)
            return (h.float().square().mean() + aux,)
        return value_and_grad(fn, tp)

    (la, ga), (lb, gb) = loss_of(False), loss_of(True)
    assert torch.equal(la, lb)
    ta, tb = _stacked(ga), _stacked(gb)
    for k in ta:
        for x, y in zip(torch.utils._pytree.tree_leaves(ta[k]),
                        torch.utils._pytree.tree_leaves(tb[k])):
            assert torch.equal(x, y), k


@pytest.mark.parametrize("arch", ["starcoder2-3b", "minicpm3-4b"])
def test_loss_fn_runs_the_flash_function_twice_a_layer(arch, monkeypatch):
    """Under remat each layer's flash forward runs again in the backward's
    recompute: 2 calls a layer a training step (on the card, 2 kernel
    launches a layer; none inside ``plain_attention()``)."""
    cfg = t_reduced(t_get_arch(arch)).model
    tp = ttf.init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    calls, plain = [], t_fa.flash_attention

    def counted(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(t_fa, "flash_attention", counted)
    value_and_grad(functools.partial(ttf.loss_fn, cfg, batch=batch), tp)
    assert len(calls) == 2 * cfg.n_layers
    with t_attn.plain_attention():
        value_and_grad(functools.partial(ttf.loss_fn, cfg, batch=batch), tp)
    assert len(calls) == 2 * cfg.n_layers


def test_plain_attention_path_matches_the_function_path():
    """The forwards inside ``plain_attention()`` (autograd through
    ``_causal_chunk_attn``) and through the flash Function give the same
    loss and gradients within the bf16 bounds: the pair chip_smoke.py
    holds on the card."""
    cfg = t_reduced(t_get_arch("minicpm3-4b")).model
    tp = ttf.init_params(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fn = functools.partial(ttf.loss_fn, cfg, batch=batch)
    lk, gk = value_and_grad(fn, tp)
    with t_attn.plain_attention():
        lp, gp = value_and_grad(fn, tp)
    assert abs(float(lk) - float(lp)) <= LOSS_RTOL * abs(float(lp))
    for x, y in zip(torch.utils._pytree.tree_leaves(gk),
                    torch.utils._pytree.tree_leaves(gp)):
        assert float((x - y).abs().max()) <= GRAD_RTOL * float(
            y.abs().max())


# -- recsys ----------------------------------------------------------------


@pytest.mark.parametrize("arch", RS_ARCHS)
def test_recsys_loss_fn_and_gradients_match_reference(ref, arch):
    jax, jnp = ref.jax, ref.jnp
    cfg = ref.reduced(ref.get_arch(arch)).model
    tcfg = t_reduced(t_get_arch(arch)).model
    jp = ref.recsys.init_params(cfg, jax.random.PRNGKey(0))
    tp = t_rec.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    batch = ref.click_log(64, cfg.n_dense, cfg.n_sparse, cfg.rows_per_field,
                          seed=3)
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: ref.recsys.loss_fn(cfg, p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(
        functools.partial(t_rec.loss_fn, tcfg, batch=batch), tp)
    assert float(loss) == pytest.approx(float(want), rel=RS_LOSS_RTOL)
    worst = max(_leaf_errs(ref, jg, grads), key=lambda e: e[1])
    assert worst[1] <= RS_GRAD_RTOL, worst


def test_deepfm_plain_bags_give_the_same_bits():
    """Inside ``plain_bags()`` DeepFM's bag sums run through
    ``embedding_bag_plain`` under the same backward: the same loss and
    gradients bit for bit (chip_smoke.py holds the kernel to this)."""
    cfg = t_reduced(t_get_arch("deepfm")).model
    tp = t_rec.init_params(cfg, seed=0, device="cpu")
    from repro_torch.data.synthetic import click_log
    batch = click_log(64, cfg.n_dense, cfg.n_sparse, cfg.rows_per_field,
                      seed=5)
    fn = functools.partial(t_rec.loss_fn, cfg, batch=batch)
    lk, gk = value_and_grad(fn, tp)
    with t_rec.plain_bags():
        lp, gp = value_and_grad(fn, tp)
    assert torch.equal(lk, lp)
    for x, y in zip(torch.utils._pytree.tree_leaves(gk),
                    torch.utils._pytree.tree_leaves(gp)):
        assert torch.equal(x, y)


def test_score_candidates_matches_reference(ref):
    rng = np.random.default_rng(6)
    u = rng.normal(size=(3, 32)).astype(np.float32)
    c = rng.normal(size=(5000, 32)).astype(np.float32)
    ws, wi = ref.recsys.score_candidates(ref.jnp.asarray(u),
                                         ref.jnp.asarray(c), k=100)
    gs, gi = t_rec.score_candidates(torch.from_numpy(u), torch.from_numpy(c),
                                    k=100)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_contrastive_loss_matches_reference(ref):
    """The retriever example's dual-encoder loss and gradients, on the
    reference example's weights (f32 encoders: within 1e-5)."""
    jax, jnp = ref.jax, ref.jnp
    j_ex = _load(ROOT / "examples" / "train_retriever.py", "j_retriever")
    from repro_torch.examples import train_retriever as t_ex
    dims = (16, 32, 8)
    key = jax.random.PRNGKey(0)
    jp = {"q": j_ex.encoder_init(jax.random.fold_in(key, 0), dims),
          "d": j_ex.encoder_init(jax.random.fold_in(key, 1), dims)}
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(7)
    batch = {"query": rng.normal(size=(12, 16)).astype(np.float32),
             "doc": rng.normal(size=(12, 16)).astype(np.float32)}
    (want, wacc), jg = jax.jit(jax.value_and_grad(
        j_ex.contrastive_loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(
        lambda p: t_ex.contrastive_loss(p, batch), tp)
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    assert float(t_ex.contrastive_loss(tp, batch)[1]) == float(wacc)
    worst = max(_leaf_errs(ref, jg, grads), key=lambda e: e[1])
    assert worst[1] <= 1e-5, worst


# -- the kernel Functions ---------------------------------------------------


def _flash_inputs(dqk, dv, b=2, s=40, h=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for d in (dqk, dqk, dv, dv)]


def _flat(x, dtype):
    b, s, h, d = x.shape
    return torch.from_numpy(x).to(dtype).permute(0, 2, 1, 3) \
        .reshape(b * h, s, d)


@pytest.mark.parametrize("dqk,dv", [(64, 64), (96, 64)])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_flash_function_gradients_match_reference(ref, dqk, dv, bf16):
    """The Function's (dq, dk, dv) against ``jax.grad`` of the reference's
    ``_causal_chunk_attn`` (chunk 16 over S 40: a short last block)."""
    jax, jnp = ref.jax, ref.jnp
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    q, k, v, g = _flash_inputs(dqk, dv)
    b, s, h, _ = q.shape
    gj = jnp.asarray(g, jdt).astype(jnp.float32)

    def f(q_, k_, v_):
        o = ref.attention._causal_chunk_attn(q_, k_, v_, 16)
        return jnp.sum(o.astype(jnp.float32) * gj)

    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    qt, kt, vt = (_flat(x, tdt).requires_grad_(True) for x in (q, k, v))
    out = t_ops.flash_attention(qt, kt, vt, causal=True, chunk=16)
    assert out.dtype == tdt and out.shape == (b * h, s, dv)
    (out.float() * _flat(g, tdt).float()).sum().backward()
    for t, w in zip((qt, kt, vt), want):
        w = np.asarray(w.astype(jnp.float32)).transpose(0, 2, 1, 3) \
            .reshape(b * h, s, -1)
        assert t.grad.dtype == tdt
        err = np.abs(t.grad.float().numpy() - w).max()
        assert err <= (2.0 ** -6 if bf16 else 1e-6) * np.abs(w).max(), err


def test_flash_function_backward_is_the_plain_chunked_attention_gradient():
    """The backward equals autograd through the port's own
    ``_causal_chunk_attn`` (the plain path), causal, in f32."""
    q, k, v, g = _flash_inputs(64, 64, s=33, seed=1)
    b, s, h, _ = q.shape
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = t_attn._causal_chunk_attn(tq, tk, tv, 16)
    (o * torch.from_numpy(g)).sum().backward()
    dq, dk, dv = t_fa.flash_attention_backward_plain(
        *(_flat(x, torch.float32) for x in (q, k, v)),
        _flat(g, torch.float32), causal=True, chunk=16)
    for got, t in zip((dq, dk, dv), (tq, tk, tv)):
        want = t.grad.permute(0, 2, 1, 3).reshape(b * h, s, -1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_embedding_bag_function_table_gradient_is_the_references(ref):
    """The bag's table gradient and ``gather_rows``'s against ``jax.grad``
    of ``jnp.take`` (+ sum over the bag), bit for bit, repeated ids
    included."""
    jax, jnp = ref.jax, ref.jnp
    rng = np.random.default_rng(8)
    table = rng.normal(size=(50, 10)).astype(np.float32)
    ids = rng.integers(0, 50, (64, 7)).astype(np.int32)
    w = rng.normal(size=(64, 10)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(
        jnp.take(t, jnp.asarray(ids), axis=0).sum(1) * w))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    (t_ops.embedding_bag(tt, torch.from_numpy(ids))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(want))
    w3 = rng.normal(size=(64, 7, 10)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(
        jnp.take(t, jnp.asarray(ids), axis=0) * w3))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    (gather_rows(tt, torch.from_numpy(ids)) * torch.from_numpy(w3)) \
        .sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(want))


def test_rows_grad_is_a_serial_scatter_add():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 20, 500)
    g = rng.normal(size=(500, 3)).astype(np.float32)
    want = np.zeros((25, 3), np.float32)
    for i, r in enumerate(ids):
        want[r] += g[i]
    got = t_eb.rows_grad(torch.from_numpy(ids), torch.from_numpy(g), 25)
    np.testing.assert_array_equal(got.numpy(), want)
    empty = t_eb.rows_grad(torch.zeros(0, dtype=torch.long),
                           torch.zeros((0, 3)), 4)
    assert torch.equal(empty, torch.zeros((4, 3)))


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dqk,dv", [(64, 64), (128, 128), (96, 64)])
def test_gpu_flash_function_gradients_match_the_plain_path(cuda, dqk, dv):
    """On the card: the Function (the kernel forward) against autograd
    through ``_causal_chunk_attn``, bf16, S 200 at chunk 64; its
    gradients run twice give the same bits.  The two round dK in other
    places: the Function, as the reference's scan, rounds each of the 4
    query blocks' dK to bf16 before it adds them in bf16, while autograd
    through the port's plain function adds the blocks' f32 dK and rounds
    once; and each bf16 output may round either way of a boundary.  So
    each gradient is held within 4 bf16 ulps of its largest entry,
    2^-5 of its scale (read on the card: one ulp, 0.0049 of the scale,
    which a first bound of 2^-8 refused)."""
    q, k, v, g = _flash_inputs(dqk, dv, b=2, s=200, h=4, seed=10)
    b, s, h, _ = q.shape

    def function_grads():
        ts = [_flat(x, torch.bfloat16).to(cuda).requires_grad_(True)
              for x in (q, k, v)]
        o = t_ops.flash_attention(*ts, causal=True, chunk=64)
        (o.float() * _flat(g, torch.bfloat16).to(cuda).float()).sum() \
            .backward()
        return [t.grad for t in ts]

    launches = t_fa.flash_attention.launches
    got = function_grads()
    assert t_fa.flash_attention.launches == launches + 1
    assert all(torch.equal(a, b_) for a, b_ in zip(got, function_grads()))
    ts = [torch.from_numpy(x).to(torch.bfloat16).to(cuda).requires_grad_(True)
          for x in (q, k, v)]
    o = t_attn._causal_chunk_attn(*ts, 64)
    (o.float() * torch.from_numpy(g).to(torch.bfloat16).to(cuda).float()) \
        .sum().backward()
    for a, t in zip(got, ts):
        want = t.grad.permute(0, 2, 1, 3).reshape(b * h, s, -1).float()
        ratio = float((a.float() - want).abs().max()) \
            / float(want.abs().max())
        print(f"max |Function - plain| / scale {ratio}")
        assert ratio <= 2.0 ** -5


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 10, 16])
def test_gpu_embedding_bag_function_matches_the_plain_path(cuda, d):
    """On the card: the kernel's Function and the plain version's under the
    same backward give the same sums and table gradient bit for bit, on
    every run (repeated ids: no atomics), and the CPU's."""
    rng = np.random.default_rng(11)
    table = rng.normal(size=(5000, d)).astype(np.float32)
    ids = rng.integers(0, 300, (4096, 39)).astype(np.int32)
    w = rng.normal(size=(4096, d)).astype(np.float32)

    def grads(fn, dev):
        t = torch.from_numpy(table).to(dev).requires_grad_(True)
        out = fn(t, torch.from_numpy(ids).to(dev))
        (out * torch.from_numpy(w).to(dev)).sum().backward()
        return out.detach().cpu(), t.grad.cpu()

    kern = grads(t_eb.EmbeddingBagFunction.apply, cuda)
    for other in (grads(t_eb.EmbeddingBagFunction.apply, cuda),
                  grads(t_eb.EmbeddingBagPlainFunction.apply, cuda),
                  grads(t_eb.EmbeddingBagFunction.apply, "cpu")):
        assert all(torch.equal(a, b) for a, b in zip(kern, other))
