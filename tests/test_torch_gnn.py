"""Port parity for the GNN: ``random_graph``, the fanout sampler, and the
GAT layer, forwards and losses of ``repro_torch.models.gnn`` against
``repro.models.gnn`` on the reference's weights carried across with
``params_from_numpy``; and the reference's own GNN tests, mirrored.

Tolerances, fixed before the first run: forwards and losses within atol
1e-5; every gradient leaf within 1e-5 of that leaf's max |.|.  The
reference runs under ``jax.jit``, as its own tests do.  Both
sides compute in f32 and add each node's incoming terms in edge order
(the reference's scatter-add, the port's segment reduction over edges
sorted stably by destination); the sums over edges that a parameter's
gradient takes run in other orders on the two sides, a few ulps of the
leaf's scale.  The generators and the sampler are NumPy copies and are
held bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.data import graph_sampler as tgs
from repro_torch.data.synthetic import random_graph
from repro_torch.launch.train import value_and_grad
from repro_torch.models import gnn
from repro_torch.models.layers import tree_map
from repro_torch.optim.optimizers import adamw

AGGS = ["attn", "mean", "sum", "max"]
ATOL = 1e-5
GRAD_REL = 1e-5


@pytest.fixture(scope="module")
def ref():
    """The reference package, imported here only (the card's machine has
    no JAX)."""
    import jax
    import jax.numpy as jnp
    from repro.data import graph_sampler
    from repro.data import synthetic
    from repro.models import gnn as jgnn
    from repro.configs import get_arch as j_get_arch
    from repro.configs import reduced as j_reduced
    return dict(jax=jax, jnp=jnp, gnn=jgnn, gs=graph_sampler,
                synthetic=synthetic, get_arch=j_get_arch,
                reduced=j_reduced)


def _cfg(**kw):
    return dataclasses.replace(reduced(get_arch("gat-cora")).model, **kw)


def _edge_case_graph(n=40, e=160, d=12, c=3, seed=0):
    """A random graph whose node 0 has no in-edges and whose first edge
    appears twice (exact ties in a segment max)."""
    g = random_graph(n, e, d, c, seed=seed)
    dst = np.where(g["edge_dst"] == 0, 1, g["edge_dst"]).astype(np.int32)
    src = np.concatenate([g["edge_src"], g["edge_src"][:1]])
    dst = np.concatenate([dst, dst[:1]])
    mask = np.random.default_rng(seed).random(src.shape[0]) < 0.8
    mask[0] = mask[-1] = True
    return dict(g, edge_src=src, edge_dst=dst, edge_mask=mask)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ref_params(ref, cfg):
    jp = ref["gnn"].init_params(cfg, ref["jax"].random.PRNGKey(0))
    return jp, gnn.params_from_numpy(
        cfg, ref["jax"].tree.map(np.asarray, jp), device="cpu")


def _assert_grads(got: dict, want: dict, where=""):
    for k in want:
        if isinstance(want[k], dict):
            _assert_grads(got[k], want[k], f"{where}[{k}]")
            continue
        w = np.asarray(want[k])
        scale = max(float(np.abs(w).max()), 1e-30)
        # a leaf the output does not reach gets no port gradient
        g = np.zeros_like(w) if got[k] is None else got[k].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_REL * scale, err_msg=where + k)


# ---------------------------------------------------------------------------
# generators and sampler, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("power_law", [True, False])
def test_random_graph_matches_reference(ref, power_law):
    want = ref["synthetic"].random_graph(300, 2000, 10, 4, seed=5,
                                         power_law=power_law)
    got = random_graph(300, 2000, 10, 4, seed=5, power_law=power_law)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_sampler_matches_reference(ref):
    js = ref["gs"]
    g = random_graph(500, 4000, 8, 3, seed=1)
    jc = js.CSRGraph.from_edges(g["edge_src"], g["edge_dst"], 500)
    tc = tgs.CSRGraph.from_edges(g["edge_src"], g["edge_dst"], 500)
    np.testing.assert_array_equal(tc.indptr, jc.indptr)
    np.testing.assert_array_equal(tc.indices, jc.indices)
    seeds = np.random.default_rng(0).choice(500, 32, replace=False)
    jb = js.sample_blocks(jc, seeds, (5, 3), np.random.default_rng(7))
    tb = tgs.sample_blocks(tc, seeds, (5, 3), np.random.default_rng(7))
    assert tgs.block_shapes(32, (5, 3)) == js.block_shapes(32, (5, 3))
    shapes = tgs.block_shapes(32, (5, 3))
    assert len(tb) == len(jb) == 2
    for a, b, (e, n, _) in zip(tb, jb, shapes):
        for x, y in ((a, b), (tgs.pad_block(a, e, n), js.pad_block(b, e, n))):
            assert x.n_out == y.n_out
            for f in ("edge_src", "edge_dst", "edge_mask", "nodes"):
                assert getattr(x, f).dtype == getattr(y, f).dtype
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


# ---------------------------------------------------------------------------
# the layer, the forwards and the losses against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_gat_layer_matches_reference(ref, agg, masked):
    jax, jnp, jgnn = ref["jax"], ref["jnp"], ref["gnn"]
    g = _edge_case_graph()
    n, d = g["feat"].shape
    mask = g["edge_mask"] if masked else None
    key = jax.random.PRNGKey(1)
    for final in (False, True):
        jp = jgnn.gat_layer_init(key, d, 5, 3)
        tp = gnn.params_from_numpy(None, jax.tree.map(np.asarray, jp),
                                   device="cpu")
        x = np.random.default_rng(2).normal(size=(n, d)).astype(np.float32)
        jg = jgnn.Graph(jnp.asarray(x), jnp.asarray(g["edge_src"]),
                        jnp.asarray(g["edge_dst"]), jnp.asarray(g["label"]),
                        None if mask is None else jnp.asarray(mask))
        tg = gnn.Graph(_t(x), _t(g["edge_src"]), _t(g["edge_dst"]),
                       _t(g["label"]), None if mask is None else _t(mask))
        out_shape = (n, 5) if final else (n, 15)
        cot = np.random.default_rng(3).normal(size=out_shape) \
            .astype(np.float32)

        def jfn(p, xx):
            o = jgnn.gat_layer(p, jg, xx, n_nodes=n, aggregator=agg,
                               final=final)
            return jnp.sum(o * cot), o

        (_, want), (jgp, jgx) = jax.jit(jax.value_and_grad(
            jfn, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
        xt = _t(x).requires_grad_(True)
        tree_map(lambda t: t.requires_grad_(True), tp)
        got = gnn.gat_layer(tp, tg, xt, n_nodes=n, aggregator=agg,
                            final=final)
        assert got.shape == out_shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=ATOL)
        (got * _t(cot)).sum().backward()
        _assert_grads({k: v.grad for k, v in tp.items()}, jgp,
                      f"{agg} final={final} ")
        _assert_grads({"x": xt.grad}, {"x": jgx}, f"{agg} final={final} ")


def test_segment_max_splits_ties_evenly():
    """A tie in a segment max shares its cotangent evenly, as JAX's does
    ([2, 2, 1, 5] into rows [0, 0, 0, 1] -> [0.5, 0.5, 0, 1]); an empty
    row is -inf."""
    ix = gnn._Index(torch.tensor([0, 0, 0, 1]), 3, sorted_=True)
    data = torch.tensor([2.0, 2.0, 1.0, 5.0], requires_grad=True)
    out = ix.max(data)
    assert out.tolist() == [2.0, 5.0, float("-inf")]
    out[:2].sum().backward()
    assert data.grad.tolist() == [0.5, 0.5, 0.0, 1.0]


@pytest.mark.parametrize("agg", AGGS)
def test_loss_fn_matches_reference(ref, agg):
    jax, jnp, jgnn = ref["jax"], ref["jnp"], ref["gnn"]
    cfg = _cfg(d_in=12, n_classes=3, aggregator=agg)
    g = _edge_case_graph()
    label = g["label"].copy()
    label[::5] = -1
    jg = jgnn.Graph(jnp.asarray(g["feat"]), jnp.asarray(g["edge_src"]),
                    jnp.asarray(g["edge_dst"]), jnp.asarray(label))
    tg = gnn.Graph(_t(g["feat"]), _t(g["edge_src"]), _t(g["edge_dst"]),
                   _t(label))
    jp, tp = _ref_params(ref, cfg)
    np.testing.assert_allclose(
        gnn.forward(cfg, tp, tg).numpy(),
        np.asarray(jax.jit(functools.partial(jgnn.forward, cfg))(jp, jg)),
        rtol=0, atol=ATOL)
    (jl, jm), jgr = jax.jit(jax.value_and_grad(
        functools.partial(jgnn.loss_fn, cfg), has_aux=True))(jp, jg)
    tl, tgr = value_and_grad(functools.partial(gnn.loss_fn, cfg, g=tg), tp)
    _, tm = gnn.loss_fn(cfg, tp, tg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=ATOL)
    assert float(tm["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-7)
    _assert_grads(tgr, jgr, agg + " ")


def _blocks(sampler, g, n, batch, fanouts, seed):
    csr = sampler.CSRGraph.from_edges(g["edge_src"], g["edge_dst"], n)
    rng = np.random.default_rng(seed)
    seeds = rng.choice(n, batch, replace=False)
    blocks = sampler.sample_blocks(csr, seeds, fanouts, rng)
    shapes = sampler.block_shapes(batch, fanouts)
    padded = [sampler.pad_block(b, e, m)
              for b, (e, m, _) in zip(blocks, shapes)]
    return seeds, padded, tuple(o for (_, _, o) in shapes)


@pytest.mark.parametrize("agg", ["attn", "max"])
def test_loss_blocks_matches_reference(ref, agg):
    jax, jnp, jgnn = ref["jax"], ref["jnp"], ref["gnn"]
    g = random_graph(500, 4000, 8, 3, seed=1)
    cfg = _cfg(d_in=8, n_classes=3, aggregator=agg)
    seeds, padded, n_outs = _blocks(tgs, g, 500, 16, (4, 3), seed=0)
    labels = g["label"][seeds].astype(np.int32)
    labels[:3] = -1
    feats = g["feat"][padded[-1].nodes]
    jp, tp = _ref_params(ref, cfg)
    jbl = [{k: jnp.asarray(getattr(b, k))
            for k in ("edge_src", "edge_dst", "edge_mask")} for b in padded]
    tbl = [{k: _t(getattr(b, k))
            for k in ("edge_src", "edge_dst", "edge_mask")} for b in padded]
    np.testing.assert_allclose(
        gnn.forward_blocks(cfg, tp, _t(feats), tbl, n_outs).numpy(),
        np.asarray(jax.jit(functools.partial(
            jgnn.forward_blocks, cfg, n_outs=n_outs))(
                jp, jnp.asarray(feats), jbl)), rtol=0, atol=ATOL)
    (jl, _), jgr = jax.jit(jax.value_and_grad(
        functools.partial(jgnn.loss_blocks, cfg, n_outs=n_outs),
        has_aux=True))(jp, jnp.asarray(feats), jbl, jnp.asarray(labels))
    tl, tgr = value_and_grad(
        lambda p: gnn.loss_blocks(cfg, p, _t(feats), tbl, _t(labels),
                                  n_outs), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=ATOL)
    _assert_grads(tgr, jgr, agg + " ")


def test_init_params_has_reference_shapes(ref):
    cfg = get_arch("gat-cora").model
    want = ref["jax"].eval_shape(
        functools.partial(ref["gnn"].init_params, cfg),
        ref["jax"].random.PRNGKey(0))
    got = gnn.init_params(cfg, seed=0, device="cpu")
    assert set(got) == set(want)
    for layer in want:
        assert set(got[layer]) == set(want[layer])
        for k, v in want[layer].items():
            assert tuple(got[layer][k].shape) == tuple(v.shape)
            assert got[layer][k].dtype == torch.float32


# ---------------------------------------------------------------------------
# the reference's GNN tests, mirrored; determinism
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_graph():
    g = random_graph(128, 512, 16, 4, seed=0)
    return gnn.Graph(_t(g["feat"]), _t(g["edge_src"]), _t(g["edge_dst"]),
                     _t(g["label"]))


def _train(cfg, graph, steps, lr=0.02, seed=0):
    params = gnn.init_params(cfg, seed=seed, device="cpu")
    opt = adamw(lr, weight_decay=0.0)
    state = opt.init(params)
    losses = []
    for i in range(steps):
        loss, grads = value_and_grad(
            functools.partial(gnn.loss_fn, cfg, g=graph), params)
        params, state = opt.update(grads, state, params, i)
        losses.append(float(loss))
    return params, state, losses


def test_gat_learns(small_graph):
    cfg = _cfg(d_in=16, n_classes=4)
    params, _, losses = _train(cfg, small_graph, 120)
    assert losses[-1] < losses[0] * 0.3
    _, m = gnn.loss_fn(cfg, params, small_graph)
    assert float(m["acc"]) > 0.8        # community features separable


@pytest.mark.parametrize("agg", ["mean", "sum", "max"])
def test_aggregators_run(small_graph, agg):
    cfg = _cfg(d_in=16, n_classes=4, aggregator=agg)
    loss, _ = gnn.loss_fn(cfg, gnn.init_params(cfg, device="cpu"),
                          small_graph)
    assert np.isfinite(float(loss))


def test_sampler_block_invariants():
    g = random_graph(500, 4000, 8, 3, seed=1)
    csr = tgs.CSRGraph.from_edges(g["edge_src"], g["edge_dst"], 500)
    rng = np.random.default_rng(0)
    seeds = rng.choice(500, 32, replace=False)
    blocks = tgs.sample_blocks(csr, seeds, (5, 3), rng)
    assert len(blocks) == 2
    for b, f in zip(blocks, (5, 3)):
        assert b.n_out <= b.nodes.shape[0]
        assert b.edge_mask.sum() <= b.n_out * f
        assert (b.edge_dst[b.edge_mask] < b.n_out).all()
        assert (b.edge_src[b.edge_mask] < b.nodes.shape[0]).all()
        src_g = b.nodes[b.edge_src[b.edge_mask]]
        dst_g = b.nodes[b.edge_dst[b.edge_mask]]
        for s_, d_ in list(zip(src_g, dst_g))[:20]:
            lo, hi = csr.indptr[d_], csr.indptr[d_ + 1]
            assert s_ in csr.indices[lo:hi]
    assert (blocks[1].nodes[: blocks[0].nodes.shape[0]]
            == blocks[0].nodes).all()


def test_minibatch_forward_matches_shapes():
    g = random_graph(500, 4000, 8, 3, seed=1)
    _, padded, n_outs = _blocks(tgs, g, 500, 16, (4, 3), seed=0)
    cfg = _cfg(d_in=8, n_classes=3)
    params = gnn.init_params(cfg, device="cpu")
    feats = _t(g["feat"])[_t(padded[-1].nodes).long()]
    bl = [{k: _t(getattr(b, k))
           for k in ("edge_src", "edge_dst", "edge_mask")} for b in padded]
    out = gnn.forward_blocks(cfg, params, feats, bl, n_outs)
    assert out.shape == (16, 3)
    assert torch.isfinite(out).all()


def test_step_repeats_bit_for_bit(small_graph):
    """One AdamW step from one state, twice: the same params and moments
    (no atomics in any gradient)."""
    cfg = _cfg(d_in=16, n_classes=4, aggregator="max")
    runs = [_train(cfg, small_graph, 2) for _ in range(2)]
    (p1, s1, l1), (p2, s2, l2) = runs
    assert l1 == l2
    flat = []
    tree_map(lambda t: flat.append(t), [p1, s1])
    flat2 = []
    tree_map(lambda t: flat2.append(t), [p2, s2])
    assert all(torch.equal(a, b) for a, b in zip(flat, flat2))


def test_init_params_needs_a_device_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn.init_params(_cfg())


def _mesh_rank(rank, world, cfg, g, label):
    """One rank of the GNN's mesh path: this rank's block of the edges,
    the whole graph's nodes and params; returns the loss and gradients."""
    from repro_torch.distributed.context import activation_mesh
    from repro_torch.launch.mesh import make_local_mesh

    blocks = np.array_split(np.arange(g["edge_src"].shape[0]), world)[rank]
    graph = gnn.Graph(_t(g["feat"]), _t(g["edge_src"][blocks]),
                      _t(g["edge_dst"][blocks]), _t(label),
                      _t(g["edge_mask"][blocks]))
    with activation_mesh(make_local_mesh(2, world // 2)):
        params = gnn.init_params(cfg, seed=3, device="cpu")
        loss, grads = value_and_grad(
            functools.partial(gnn.loss_fn, cfg, g=graph), params)
    return float(loss), tree_map(lambda t: t.numpy(), grads)


@pytest.mark.parametrize("agg", ["attn", "max"])
def test_mesh_path_matches_one_process(agg):
    """Edges split over 4 gloo ranks, every segment reduction all-reduced:
    each rank's loss and gradients equal one process's on all the edges
    (sums over ranks in another order: the stated tolerances)."""
    from repro_torch.launch.mesh import launch

    cfg = _cfg(d_in=12, n_classes=3, aggregator=agg)
    g = _edge_case_graph()
    label = g["label"].copy()
    label[::5] = -1
    whole = gnn.Graph(_t(g["feat"]), _t(g["edge_src"]), _t(g["edge_dst"]),
                      _t(label), _t(g["edge_mask"]))
    want_loss, want = value_and_grad(
        functools.partial(gnn.loss_fn, cfg, g=whole),
        gnn.init_params(cfg, seed=3, device="cpu"))
    outs = launch(_mesh_rank, 4, cfg, g, label, device="cpu", timeout=60,
                  deadline=120)
    for loss, grads in outs:
        assert loss == pytest.approx(float(want_loss), abs=ATOL)
        _assert_grads(tree_map(torch.from_numpy, grads),
                      tree_map(lambda t: t.numpy(), want), agg + " mesh ")
