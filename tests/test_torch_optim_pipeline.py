"""Port parity for the optimizers, the schedule and the input pipeline
(``repro_torch.optim``, ``repro_torch.data.pipeline``) against the
reference's (tests/test_optim_pipeline.py's functions).

Tolerances: the optimizers compute in f32 in the reference's order, so
three steps on identical numpy params and gradients agree within rtol
1e-6 (read: AdamW and SGDM bit for bit, Adafactor within 4e-8 of each
leaf's scale, its means summed in another order); ``warmup_cosine``
within 1e-6; the batchers bit for bit (the same NumPy generator).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import (DeterministicBatcher, Prefetcher,
                                       lm_batcher, pair_batcher,
                                       recsys_batcher)
from repro_torch.optim.optimizers import (adafactor, adamw,
                                          clip_by_global_norm, global_norm,
                                          sgdm, warmup_cosine)

OPT_RTOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.data import pipeline
    from repro.optim import optimizers
    return types.SimpleNamespace(jax=jax, jnp=jnp, opt=optimizers,
                                 pipe=pipeline)


def _tree(rng):
    """A params-shaped tree: a matrix, a vector, a 3-D stack, a list."""
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "layers": [{"b": rng.normal(size=(4,)).astype(np.float32),
                        "k": rng.normal(size=(3, 2, 4)).astype(np.float32)}
                       for _ in range(2)]}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _close(ref, want, got, rtol):
    jax = ref.jax
    w = jax.tree.leaves(want)
    g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(w) == len(g)
    for a, b in zip(w, g):
        a = np.asarray(a)
        assert b.dtype == torch.float32 and b.shape == a.shape
        assert np.abs(b.numpy() - a).max() <= rtol * max(np.abs(a).max(),
                                                         1e-30)


def _pairs(ref):
    j, lr = ref.opt, 1e-2
    return {"adamw": (j.adamw(j.warmup_cosine(lr, 2, 10)),
                      adamw(warmup_cosine(lr, 2, 10))),
            "adafactor": (j.adafactor(0.1), adafactor(0.1)),
            "sgdm": (j.sgdm(0.02, max_grad_norm=1.0),
                     sgdm(0.02, max_grad_norm=1.0))}


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizer_steps_match_reference(ref, name):
    """Three steps on the same params and gradients (norm ~23: clipped)
    give the reference's params and state; the port writes them into
    the tensors it is given and returns those."""
    jnp = ref.jnp
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [ref.jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * 3).astype(np.float32), params)
        for _ in range(3)]
    jo, to = _pairs(ref)[name]
    jp = ref.jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = _t(params)
    ts = to.init(tp)
    for step, g in enumerate(grads):
        jp, js = jo.update(ref.jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.asarray(step))
        out_p, out_s = to.update(_t(g), ts, tp, torch.tensor(step))
        assert out_p is tp and out_s is ts
    _close(ref, jp, tp, OPT_RTOL)
    _close(ref, js, ts, OPT_RTOL)


def test_bf16_params_update_in_their_dtype(ref):
    """A bf16 parameter's gradient is clipped in bf16 and its update
    rounded back to bf16, with f32 moments, as the reference does."""
    jnp = ref.jnp
    rng = np.random.default_rng(1)
    p = rng.normal(size=(8, 4)).astype(np.float32)
    g = (rng.normal(size=(8, 4)) * 5).astype(np.float32)
    jo = ref.opt.adamw(1e-2)
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    jp2, js = jo.update({"w": jnp.asarray(g, jnp.bfloat16)}, jo.init(jp),
                        jp, jnp.asarray(0))
    to = adamw(1e-2)
    tp = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    ts = to.init(tp)
    to.update({"w": torch.from_numpy(g).to(torch.bfloat16)}, ts, tp, 0)
    assert tp["w"].dtype == torch.bfloat16 and ts["mu"]["w"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        tp["w"].float().numpy(), np.asarray(jp2["w"].astype(jnp.float32)))
    np.testing.assert_allclose(ts["nu"]["w"].numpy(), np.asarray(js["nu"]["w"]),
                               rtol=OPT_RTOL)


def test_global_norm_and_clip_match_reference(ref):
    jnp = ref.jnp
    rng = np.random.default_rng(2)
    g = _tree(rng)
    want = float(ref.opt.global_norm(ref.jax.tree.map(jnp.asarray, g)))
    assert float(global_norm(_t(g))) == pytest.approx(want, rel=1e-6)
    clipped = clip_by_global_norm(_t(g), 1.0)
    _close(ref, ref.opt.clip_by_global_norm(
        ref.jax.tree.map(jnp.asarray, g), 1.0), clipped, OPT_RTOL)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_warmup_cosine_matches_reference(ref):
    want = ref.opt.warmup_cosine(3e-4, 50, 300)
    got = warmup_cosine(3e-4, 50, 300)
    for step in (0, 1, 25, 49, 50, 51, 120, 299, 300, 500):
        w = float(want(ref.jnp.asarray(step)))
        g = got(torch.tensor(step))
        assert g.dtype == torch.float32
        assert float(g) == pytest.approx(w, rel=1e-6)


# -- the reference's own checks (tests/test_optim_pipeline.py) ---------------


def _quadratic(opt, steps=60):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    for i in range(steps):
        grads = {"w": 2 * (params["w"] - target)}
        params, state = opt.update(grads, state, params, torch.tensor(i))
    return float((params["w"] - target).abs().max())


@pytest.mark.parametrize("name,opt,steps,bound", [
    ("adamw", lambda: adamw(0.1, weight_decay=0.0), 60, 0.15),
    ("adafactor", lambda: adafactor(0.3), 120, 0.3),
    ("sgdm", lambda: sgdm(0.02), 120, 0.1)])
def test_optimizer_converges(name, opt, steps, bound):
    assert _quadratic(opt(), steps) < bound


def test_adamw_matches_reference_math():
    """One AdamW step vs hand computation."""
    opt = adamw(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                max_grad_norm=1e9)
    p = {"w": torch.tensor([2.0])}
    s = opt.init(p)
    new_p, _ = opt.update({"w": torch.tensor([0.5])}, s, p, torch.tensor(0))
    m = 0.1 * 0.5 / (1 - 0.9)
    v = 0.01 * 0.25 / (1 - 0.99)
    expected = 2.0 - 0.1 * (m / (np.sqrt(v) + 1e-8))
    np.testing.assert_allclose(float(new_p["w"][0]), expected, rtol=1e-5)


def test_warmup_cosine_shape():
    fn = warmup_cosine(1.0, warmup=10, total=100, floor=0.1)
    vals = [float(fn(torch.tensor(s))) for s in [0, 9, 10, 50, 99]]
    assert vals[0] < vals[1] <= 1.0 + 1e-6
    assert vals[2] == pytest.approx(1.0, abs=0.1)
    assert vals[-1] == pytest.approx(0.1, abs=0.05)
    assert vals[3] < vals[2]


def test_adafactor_memory_is_factored():
    s = adafactor(0.01).init({"w": torch.zeros((64, 32))})
    assert sum(t.numel() for t in s["w"].values()) == 64 + 32


# -- the pipeline ----------------------------------------------------------


def _same_batches(want, got, steps=(0, 1, 7)):
    for step in steps:
        w, g = want.batch(step), got.batch(step)
        assert sorted(w) == sorted(g)
        for k in w:
            assert w[k].dtype == g[k].dtype
            np.testing.assert_array_equal(w[k], g[k])


def test_batchers_equal_the_references(ref):
    p = ref.pipe
    _same_batches(p.lm_batcher(1000, 4, 16, seed=3), lm_batcher(1000, 4, 16,
                                                                 seed=3))
    _same_batches(p.recsys_batcher(13, 26, 100, 32, seed=4),
                  recsys_batcher(13, 26, 100, 32, seed=4))
    docs = np.random.default_rng(0).normal(0, 1, (50, 8)).astype(np.float32)
    _same_batches(p.pair_batcher(docs, 16, noise=0.08, seed=5),
                  pair_batcher(docs, 16, noise=0.08, seed=5))


def test_batcher_determinism():
    b = lm_batcher(1000, 4, 16, seed=3)
    np.testing.assert_array_equal(b.batch(7)["tokens"], b.batch(7)["tokens"])
    assert not np.array_equal(b.batch(8)["tokens"], b.batch(7)["tokens"])
    d = DeterministicBatcher(lambda rng: {"x": rng.integers(0, 9, 4)}, 1)
    np.testing.assert_array_equal(d.batch(2)["x"], d.batch(2)["x"])


def test_prefetcher_yields_in_order():
    b = lm_batcher(100, 2, 4, seed=0)
    pf = Prefetcher(b, start_step=5, depth=2)
    try:
        got = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for step, batch in got:
        np.testing.assert_array_equal(batch["tokens"], b.batch(step)["tokens"])
    assert not pf._thread.is_alive()


def test_pair_batcher_labels_consistent():
    docs = np.random.default_rng(0).normal(0, 1, (50, 8)).astype(np.float32)
    bt = pair_batcher(docs, batch=16, seed=0).batch(0)
    np.testing.assert_allclose(bt["doc"], docs[bt["doc_id"]])
