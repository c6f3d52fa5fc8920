"""Port parity for the MoE FFN (``repro_torch.models.moe``) and the mesh
context (``repro_torch.distributed.context``) against ``repro``'s, on
the reduced DBRX and DeepSeekMoE configs and on weights and inputs drawn
with numpy.

``_dispatch_indices`` is exact (integer work).  ``_moe_core``: the
router's f32 product sums in another order on each side, so an expert
choice may flip where two probabilities at the top-k boundary are
within 1e-6; the test takes the port's choices from ``moe.route_log``,
prints how many tokens flipped, and holds every other token's
output to bf16 tolerance (the expert FFNs run in bf16 on both sides:
2% of the output's scale) and the aux loss to 1e-6.

The mesh: ``moe_forward`` on 8 spawned gloo ranks, mesh (2, 4), against
the reference's ``shard_map`` under ``jax.jit`` on 8 fake host devices
in a subprocess (as ``tests/test_torch_collectives.py`` runs it), with
the bound of ``tests/test_distributed.py::test_moe_sharded_matches_
single_device`` (2e-2) against the single-device reference.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch, reduced
from repro.models import moe as j_moe
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.configs import reduced as t_reduced
from repro_torch.distributed import context
from repro_torch.launch.mesh import (axis_group, launch, local_block,
                                     make_local_mesh)
from repro_torch.models import moe as t_moe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["dbrx-132b", "deepseek-moe-16b"]
NEAR_TIE = 1e-6      # router probabilities this close may order either way
OUT_RTOL = 0.02      # of the output's scale: bf16 expert products


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
    if kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))
        tcfg = dataclasses.replace(tcfg,
                                   moe=dataclasses.replace(tcfg.moe, **kw))
    return cfg, tcfg


def _params(cfg, seed=0):
    """MoE weights drawn with numpy: (numpy tree, jax tree, torch tree)."""
    mo = cfg.moe
    rng = np.random.default_rng(seed)
    d, ff, e = cfg.d_model, mo.d_ff_expert, mo.n_experts

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)

    tree = {"router": {"w": (rng.normal(size=(d, e)) * 0.3)
                       .astype(np.float32)},
            "wi": w(e, d, ff), "wg": w(e, d, ff), "wo": w(e, ff, d)}
    if mo.n_shared:
        sf = mo.n_shared * ff
        tree["shared"] = {"wi": {"w": w(d, sf)}, "wg": {"w": w(d, sf)},
                          "wo": {"w": w(sf, d)}}
    return (tree, jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.from_numpy, tree))


def _x(cfg, b=4, s=16, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


# -- dispatch -----------------------------------------------------------------


@pytest.mark.parametrize("n_experts,capacity", [(8, 40), (8, 6), (64, 3),
                                                (4, 1)])
def test_dispatch_indices_equal_reference(n_experts, capacity):
    """Slots, keep mask and permutation equal, drops included (a
    capacity under the mean load)."""
    rng = np.random.default_rng(n_experts * capacity)
    idx = rng.integers(0, n_experts, 96).astype(np.int32)
    want = j_moe._dispatch_indices(jnp.asarray(idx), n_experts, capacity)
    got = t_moe._dispatch_indices(torch.from_numpy(idx).long(), n_experts,
                                  capacity)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if capacity < 96 // n_experts:
        assert not got[1].all()          # the case drops tokens
        # a dropped token's slot is one past the buffer
        assert (got[0][~got[1]] == n_experts * capacity).all()


def test_capacity_floor_keeps_small_batches_drop_free():
    _, tcfg = _cfgs("deepseek-moe-16b")
    mo = tcfg.moe
    for t in (1, 2, 3, 50):
        want = int(max(np.ceil(t * mo.top_k / mo.n_experts
                               * mo.capacity_factor), min(t * mo.top_k, 8)))
        assert t_moe.capacity_of(t, tcfg) == want
    assert t_moe.capacity_of(1, tcfg) == mo.top_k


# -- the core -----------------------------------------------------------------


def _choices(router_w, x, k):
    """The reference's router probabilities and top-k experts (JAX)."""
    logits = jnp.asarray(x, jnp.float32).reshape(-1, x.shape[-1]) \
        @ jnp.asarray(router_w)
    probs = jax.nn.softmax(logits, axis=-1)
    return np.asarray(probs), np.asarray(jax.lax.top_k(probs, k)[1])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5],
                         ids=["drop-free", "drops"])
def test_moe_core_matches_reference(arch, dtype, capacity_factor, request):
    cfg, tcfg = _cfgs(arch, capacity_factor=capacity_factor)
    tree, jp, tp = _params(cfg)
    x = _x(cfg)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, want_aux = j_moe._moe_core(jp, jx, cfg)
    with t_moe.route_log() as log:
        got, aux = t_moe._moe_core(tp, tx, tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert abs(float(aux) - float(want_aux)) <= 1e-6

    # expert choices: the port's against the reference's, flips only at
    # near ties (the router's input is the same array on both sides)
    probs, j_top = _choices(tree["router"]["w"], np.asarray(jx, np.float32),
                            cfg.moe.top_k)
    (_, t_top, _), = log.calls
    flipped = (np.sort(j_top, -1) != np.sort(t_top.numpy(), -1)).any(-1)
    request.node.user_properties.append(("flipped_tokens",
                                         int(flipped.sum())))
    print(f"{int(flipped.sum())} of {flipped.size} tokens routed otherwise "
          f"than the reference's")
    srt = -np.sort(-probs, -1)
    gap = srt[:, cfg.moe.top_k - 1] - srt[:, cfg.moe.top_k]
    assert (gap[flipped] <= NEAR_TIE).all(), gap[flipped]
    # with drops, a flip also moves the ranks of later tokens: compare
    # every token only when none flipped
    keep = ~flipped if capacity_factor >= 8.0 or not flipped.any() else \
        np.zeros_like(flipped)
    want = np.asarray(want, np.float32).reshape(-1, cfg.d_model)
    got = got.float().numpy().reshape(-1, cfg.d_model)
    assert keep.sum() >= 0.9 * len(keep), f"{int(flipped.sum())} flips"
    np.testing.assert_allclose(got[keep], want[keep],
                               atol=OUT_RTOL * np.abs(want).max())


def test_moe_core_drops_tokens_past_capacity():
    """At capacity factor 0.5 some tokens lose experts: their routed
    contribution is zero where the drop-free run's is not, and the route
    log counts the dropped assignments."""
    _, tcfg = _cfgs("dbrx-132b", capacity_factor=0.5)
    _, tcfg8 = _cfgs("dbrx-132b")
    _, _, tp = _params(tcfg)
    x = torch.from_numpy(_x(tcfg))
    with t_moe.route_log() as drops:
        out, _ = t_moe._moe_core(tp, x, tcfg)
    with t_moe.route_log() as none:
        full, _ = t_moe._moe_core(tp, x, tcfg8)
    t, k = x.shape[0] * x.shape[1], tcfg.moe.top_k
    assert drops.assigned() == none.assigned() == t * k
    # capacity 0.5 t k / E a expert: at least half the assignments drop
    assert drops.dropped() >= t * k // 2 and none.dropped() == 0
    assert not torch.equal(out, full)
    assert (out.float().abs().sum(-1) == 0).any()   # dbrx: no shared expert


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_has_reference_shapes(arch):
    cfg, tcfg = _cfgs(arch)
    want = jax.eval_shape(lambda k: j_moe.moe_init(k, cfg),
                          jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    got = t_moe.moe_init(gen, tcfg)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, got))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(w.shape) == tuple(g.shape)


def test_moe_forward_without_mesh_is_the_core():
    _, tcfg = _cfgs("deepseek-moe-16b")
    _, _, tp = _params(tcfg)
    x = torch.from_numpy(_x(tcfg))
    assert context.current_mesh() is None and context.dp_axes() is None
    assert context.model_axis() is None and context.model_size() == 1
    out, aux = t_moe.moe_forward(tp, x, tcfg)
    want, want_aux = t_moe._moe_core(tp, x, tcfg)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)


# -- the mesh -----------------------------------------------------------------

ARCH_MESH = "dbrx-132b"

REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_arch, reduced
    from repro.models import moe as moe_lib
    from repro.distributed.context import activation_mesh
    inp = dict(np.load(sys.argv[1]))
    cfg = reduced(get_arch(sys.argv[3])).model
    p = {"router": {"w": jnp.asarray(inp["router"])},
         **{k: jnp.asarray(inp[k]) for k in ("wi", "wg", "wo")}}
    x = jnp.asarray(inp["x"])
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ref_out, ref_aux = moe_lib.moe_forward(p, x, cfg)
    with mesh, activation_mesh(mesh):
        out, aux = jax.jit(lambda p_, x_: moe_lib.moe_forward(p_, x_, cfg))(
            p, x)
    np.savez(sys.argv[2], out=np.asarray(out, np.float32), aux=np.asarray(aux),
             ref_out=np.asarray(ref_out, np.float32),
             ref_aux=np.asarray(ref_aux))
""")


def _moe_rank(rank, world, arch, inp):
    """Rank program on a (2, 4) gloo mesh: this rank's block of the batch
    and dim-1 block of the expert weights through ``moe_forward``; also
    a batch the DP size does not divide (the single-device path)."""
    from repro_torch.configs import get_arch as ga, reduced as rd
    cfg = rd(ga(arch)).model
    mesh = make_local_mesh(2, 4)
    data = axis_group(mesh, "data")
    p = {"router": {"w": torch.from_numpy(inp["router"])}}
    for name in t_moe.EXPERT_WEIGHTS:
        w = torch.from_numpy(inp[name])
        p[name] = local_block(w.transpose(0, 1), data).transpose(0, 1) \
            .contiguous()
    x = local_block(torch.from_numpy(inp["x"]), data)
    with context.activation_mesh(mesh):
        assert context.dp_axes() == ("data",)
        assert context.model_axis() == "model" and context.model_size() == 4
        out, aux = t_moe.moe_forward(p, x, cfg)
        odd, _ = t_moe.moe_forward(
            {**p, **{n: torch.from_numpy(inp[n])
                     for n in t_moe.EXPERT_WEIGHTS}},
            torch.from_numpy(inp["x"])[:1], cfg)
    assert context.current_mesh() is None
    return out, aux, odd


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(reference outputs, port outputs per rank, the inputs)."""
    cfg, _ = _cfgs(ARCH_MESH)
    tree, _, _ = _params(cfg, seed=3)
    inp = dict(router=tree["router"]["w"], wi=tree["wi"], wg=tree["wg"],
               wo=tree["wo"], x=_x(cfg, seed=4))
    tmp = tmp_path_factory.mktemp("moe")
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_disable_hlo_passes=all-reduce-promotion")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "inputs.npz"),
         str(tmp / "ref.npz"), ARCH_MESH], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = launch(_moe_rank, 8, ARCH_MESH, inp, device="cpu", timeout=60,
                      deadline=180)
        _, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with np.load(tmp / "ref.npz") as z:
        return {k: z[k] for k in z.files}, port, inp


def _assembled(port):
    """The (B, S, d) output from the ranks: data index i holds block i;
    every model rank of a data index holds the same block."""
    blocks = []
    for i in range(2):
        outs = [port[4 * i + m][0] for m in range(4)]
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
        blocks.append(outs[0])
    return torch.cat(blocks).float().numpy()


def test_moe_forward_on_a_mesh_matches_reference(mesh_runs):
    """Against the JAX mesh and the JAX single device (the reference
    test's bound, 2e-2), and against the port's own single-device
    output: within one bf16 rounding of the output (2^-8 of its scale;
    the experts' products run on other row blocks, the tokens' sums in
    the same order)."""
    ref, port, inp = mesh_runs
    _, tcfg = _cfgs(ARCH_MESH)
    got = _assembled(port)
    assert np.abs(got - ref["out"]).max() < 2e-2
    assert np.abs(got - ref["ref_out"]).max() < 2e-2
    tp = {"router": {"w": torch.from_numpy(inp["router"])},
          **{n: torch.from_numpy(inp[n]) for n in t_moe.EXPERT_WEIGHTS}}
    single, single_aux = t_moe._moe_core(tp, torch.from_numpy(inp["x"]), tcfg)
    single = single.float().numpy()
    np.testing.assert_allclose(got, single,
                               atol=2.0 ** -8 * np.abs(single).max())
    for _, aux, _ in port:
        # the mean of the two DP shards' aux against the reference's
        assert abs(float(aux) - float(ref["aux"])) < 1e-6
        assert abs(float(aux) - float(ref["ref_aux"])) < 1e-3


def test_moe_forward_on_a_mesh_falls_back_for_an_odd_batch(mesh_runs):
    """B=1 does not split over 2 DP ranks: every rank runs the whole
    batch with the whole weights, the single-device result."""
    _, port, inp = mesh_runs
    _, tcfg = _cfgs(ARCH_MESH)
    tp = {"router": {"w": torch.from_numpy(inp["router"])},
          **{n: torch.from_numpy(inp[n]) for n in t_moe.EXPERT_WEIGHTS}}
    want, _ = t_moe._moe_core(tp, torch.from_numpy(inp["x"])[:1], tcfg)
    for _, _, odd in port:
        assert torch.equal(odd, want)
