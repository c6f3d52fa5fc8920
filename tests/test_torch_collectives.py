"""Port parity for the collectives (``repro_torch.distributed``), the
row-sharded embedding lookup, ``kmeans.sharded_assign_step`` and the
mesh constructors (``repro_torch.launch.mesh``) against ``repro``'s
(tests/test_distributed.py).

The inputs are drawn once with numpy.  The reference runs once, in a
subprocess on 8 fake host devices (mesh (2, 4)), while the port runs
once on 8 spawned gloo ranks (mesh (2, 4)); each writes every output.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.kmeans import (_assign_block, _update,
                                     sharded_assign_step)
from repro_torch.distributed.collectives import (all_gather, bucketed_psum,
                                                 compress_int8,
                                                 compressed_psum,
                                                 ring_all_gather)
from repro_torch.distributed.embedding import (embedding_bag,
                                               make_sharded_lookup)
from repro_torch.launch.mesh import (axis_group, launch, local_block,
                                     make_local_mesh, production_mesh_shape)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, EMB_D = 64, 8


def draw_inputs() -> dict:
    rng = np.random.default_rng(0)
    offsets = np.sort(rng.integers(0, 40, 7))
    return dict(
        ring_x=np.arange(32, dtype=np.float32).reshape(8, 4),
        # the reference test's two DP rows of gradients
        psum_g=rng.normal(0, 1, (8, 64)).astype(np.float32)
        .reshape(2, 4, 64)[:, 0],
        int8_g=(rng.normal(0, 1, (4, 256)) * rng.uniform(0.1, 10, (4, 1)))
        .astype(np.float32),
        int8_err=rng.normal(0, 0.01, (4, 256)).astype(np.float32),
        table=rng.normal(0, 1, (ROWS, EMB_D)).astype(np.float32),
        lookup_ids=rng.integers(0, ROWS, (16, 5)).astype(np.int32),
        bag_table=rng.normal(0, 1, (50, EMB_D)).astype(np.float32),
        bag_ids=rng.integers(0, 50, 40).astype(np.int32),
        # 8 bags, two of them empty, ids past the last offset dropped
        bag_offsets=np.concatenate([[0], offsets[:3], offsets[2:3],
                                    offsets[3:], [36]]).astype(np.int32),
        km_x=rng.normal(0, 1, (256, 16)).astype(np.float32),
        km_c=rng.normal(0, 1, (12, 16)).astype(np.float32),
    )


REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core.kmeans import sharded_assign_step
    from repro.distributed.collectives import (compress_int8,
                                               compressed_psum,
                                               ring_all_gather)
    from repro.distributed.embedding import (embedding_bag,
                                             make_sharded_lookup)
    inp = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    ring = jax.shard_map(lambda xs: ring_all_gather(xs, "model", 4),
                         mesh=mesh, in_specs=P(None, "model"),
                         out_specs=P(None, None, "model"), check_vma=False)

    def psum_local(gs):
        o, _ = compressed_psum(gs[0], jnp.zeros_like(gs[0]), "data")
        return o[None]

    psum = jax.shard_map(psum_local, mesh=mesh, in_specs=P("data", None),
                         out_specs=P("data", None), check_vma=False)
    lookup = make_sharded_lookup(mesh, inp["table"].shape[0])
    step = sharded_assign_step(mesh)
    with mesh:
        out["ring"] = ring(jnp.asarray(inp["ring_x"]))
        out["psum"] = psum(jnp.asarray(inp["psum_g"]))
        out["lookup"] = lookup(jnp.asarray(inp["table"]),
                               jnp.asarray(inp["lookup_ids"]))
        out["km_new"], out["km_assign"] = step(jnp.asarray(inp["km_x"]),
                                               jnp.asarray(inp["km_c"]))
    # op by op, as the function is written (no jit)
    out["int8_q"], out["int8_scale"], out["int8_err"] = compress_int8(
        jnp.asarray(inp["int8_g"]), jnp.asarray(inp["int8_err"]))
    for combine in ("sum", "mean"):
        out[f"bag_{combine}"] = embedding_bag(
            jnp.asarray(inp["bag_table"]), jnp.asarray(inp["bag_ids"]),
            jnp.asarray(inp["bag_offsets"]), combine=combine)
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""")


def _collectives(rank, world, inp):
    """Rank program on a (2, 4) gloo mesh: every collective's output."""
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    mesh = make_local_mesh(2, 4)
    model, data = axis_group(mesh, "model"), axis_group(mesh, "data")
    x = local_block(t["ring_x"].T, model).T.contiguous()     # (8, 1)
    out = dict(ring=ring_all_gather(x, model, 4), gathered=all_gather(x,
                                                                       model))
    g = local_block(t["psum_g"], data)[0]
    out["psum"], _ = compressed_psum(g, torch.zeros_like(g), data)
    lookup = make_sharded_lookup(mesh, ROWS)
    out["lookup"] = lookup(local_block(t["table"], model), t["lookup_ids"])
    out["km_new"], out["km_assign"] = sharded_assign_step(mesh)(
        local_block(t["km_x"], data), t["km_c"])
    # integer-valued leaves: any order of the sums is exact
    tree = {"w": [t["km_x"][:40].round(), t["lookup_ids"]],
            "b": (t["km_c"].round(), t["table"][:7].round() * rank),
            "a": (t["ring_x"] + rank).int()}
    out["bucketed"] = bucketed_psum(tree, data, bucket_bytes=2048)
    out["one_reduce"] = [all_gather(leaf, data).sum(0, dtype=leaf.dtype)
                         for leaf in (tree["a"], tree["b"][0], tree["b"][1],
                                      tree["w"][0], tree["w"][1])]
    return out


def _one_rank_lloyd(rank, world, x, c):
    mesh = make_local_mesh(1, 1)
    x, c = torch.as_tensor(x), torch.as_tensor(c)
    new, assign = sharded_assign_step(mesh)(x, c)
    return (new.numpy(), assign.numpy(),
            _update(x, _assign_block(x, c)[0], c).numpy(),
            _assign_block(x, c)[0].numpy())


@pytest.fixture(scope="module")
def inputs():
    return draw_inputs()


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """(reference outputs, port outputs per rank): the reference's
    subprocess and the port's 8 ranks run side by side."""
    pytest.importorskip("jax", reason="the reference mesh needs jax")
    tmp = tmp_path_factory.mktemp("collectives")
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_disable_hlo_passes=all-reduce-promotion")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "inputs.npz"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = launch(_collectives, 8, inputs, device="cpu", timeout=60,
                      deadline=180)
        _, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with np.load(tmp / "ref.npz") as z:
        return {k: z[k] for k in z.files}, port


def test_ring_all_gather_equals_all_gather(runs):
    ref, port = runs
    for out in port:
        assert torch.equal(out["ring"], out["gathered"])
    # the reference assembles each model device's (4, 8, 1) chunks along
    # the last axis: (4, 8, 4), every device's block the same
    np.testing.assert_array_equal(
        np.broadcast_to(port[0]["ring"].numpy(), ref["ring"].shape),
        ref["ring"])


def test_compressed_psum_matches_reference(runs, inputs):
    ref, port = runs
    exp = inputs["psum_g"].mean(0)
    for out in port:
        got = out["psum"].numpy()
        np.testing.assert_allclose(got, ref["psum"][0], rtol=0, atol=1e-6)
        # the reference test's bound: one int8 quantization step
        assert np.abs(got - exp).max() / (np.abs(exp).max() + 1e-9) < 0.02


def test_compress_int8_bit_for_bit(runs, inputs):
    ref, _ = runs
    q, scale, err = compress_int8(torch.as_tensor(inputs["int8_g"]),
                                  torch.as_tensor(inputs["int8_err"]))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), ref["int8_q"])
    np.testing.assert_array_equal(scale.numpy(), ref["int8_scale"])
    np.testing.assert_array_equal(err.numpy(), ref["int8_err"])


def test_bucketed_psum_equals_one_all_reduce(runs):
    _, port = runs
    for out in port:
        b = out["bucketed"]
        assert sorted(b) == ["a", "b", "w"] and isinstance(b["b"], tuple)
        for got, want in zip((b["a"], b["b"][0], b["b"][1], b["w"][0],
                              b["w"][1]), out["one_reduce"]):
            assert got.dtype == want.dtype
            assert torch.equal(got, want)


def test_sharded_lookup_equals_dense_take(runs, inputs):
    ref, port = runs
    dense = inputs["table"][inputs["lookup_ids"]]
    for out in port:
        np.testing.assert_array_equal(out["lookup"].numpy(), dense)
    np.testing.assert_array_equal(ref["lookup"], dense)


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_ragged_embedding_bag_matches_reference(runs, inputs, combine):
    ref, _ = runs
    got = embedding_bag(torch.as_tensor(inputs["bag_table"]),
                        torch.as_tensor(inputs["bag_ids"]),
                        torch.as_tensor(inputs["bag_offsets"]),
                        combine=combine)
    np.testing.assert_allclose(got.numpy(), ref[f"bag_{combine}"],
                               rtol=1e-6, atol=0)


def test_sharded_assign_step_matches_reference(runs):
    ref, port = runs
    for out in port:
        np.testing.assert_array_equal(out["km_assign"].numpy(),
                                      ref["km_assign"])
        np.testing.assert_allclose(out["km_new"].numpy(), ref["km_new"],
                                   rtol=1e-5, atol=0)


def test_one_rank_sharded_assign_step_is_the_lloyd_step(inputs):
    new, assign, want_new, want_assign = launch(
        _one_rank_lloyd, 1, inputs["km_x"], inputs["km_c"], device="cpu",
        timeout=30, deadline=120)[0]
    np.testing.assert_array_equal(new, want_new)
    np.testing.assert_array_equal(assign, want_assign)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_and_names(multi_pod):
    shape, names = production_mesh_shape(multi_pod)
    if multi_pod:
        assert (shape, names) == ((2, 16, 16), ("pod", "data", "model"))
    else:
        assert (shape, names) == ((16, 16), ("data", "model"))
    assert np.prod(shape) == (512 if multi_pod else 256)
