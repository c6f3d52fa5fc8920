"""Port parity for the mesh search (``repro_torch.core.distributed_ivf``:
``make_distributed_search``, ``quantize_sharded``, ``abstract_sharded``)
against the reference's ``shard_map`` search on 8 fake host devices
(tests/test_distributed.py).

The reference runs once, in a subprocess (XLA_FLAGS must be set before
jax is imported): it builds the reference test's corpora and indexes,
deals them over 4 shards, runs every case on a (2, 4) mesh and writes the
shards and every output to an ``.npz``.  The port runs every case once on
8 spawned gloo ranks, mesh (2, 4), over the reference's shard arrays:
ids and probes equal, scores within 1e-5, every rank holding the same
whole result.  Inside the port the fixed-N mesh search equals
``search_with_retry``, and the reference test's recall assertions hold.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import build_index, brute_force, metrics
from repro_torch.core.distributed_ivf import (ShardedIVF, abstract_sharded,
                                              local_shard,
                                              make_distributed_search,
                                              quantize_sharded,
                                              search_with_retry, shard_index)
from repro_torch.data.synthetic import clustered_corpus
from repro_torch.launch.mesh import launch, make_local_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
K, LIST_PAD, SHARDS = 10, 256, 4
# the reference tests' corpora: "a" for test_distributed_ivf_matches_local,
# "b" for test_int8_doc_storage_matches_f32
CORPORA = {"a": dict(n_docs=8000, seed=0), "b": dict(n_docs=6000, seed=3)}
CASES = {
    "fixed": dict(corpus="a", n_probe=64),
    "fixed_w4": dict(corpus="a", n_probe=64, probe_width=4),
    "patience": dict(corpus="a", n_probe=32, patience_delta=7),
    "patience_w4": dict(corpus="a", n_probe=64, patience_delta=2,
                        probe_width=4),
    # Cs (17) < w: the probe index clamps and the last ranked list repeats
    "clamped_w32": dict(corpus="a", n_probe=64, probe_width=32),
    "int8": dict(corpus="b", n_probe=64, int8_docs=True),
    "unroll2": dict(corpus="a", n_probe=32, patience_delta=7,
                    unroll_steps=2),
}
SHARD_KEYS = ("centroids", "docs", "doc_ids", "offsets", "sizes")

REFERENCE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.core import build_index
    from repro.core.distributed_ivf import (abstract_sharded,
                                            make_distributed_search,
                                            quantize_sharded, shard_index)
    from repro.data.synthetic import clustered_corpus
    out_path, corpora, cases, k, list_pad, n_shards = (
        sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]),
        *map(int, sys.argv[4:7]))
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out, shards = {}, {}
    for name, c in corpora.items():
        corpus = clustered_corpus(n_docs=c["n_docs"], dim=24,
                                  n_components=64, n_queries=64,
                                  seed=c["seed"])
        idx = build_index(corpus.docs, 64, list_pad=list_pad, n_iters=4)
        sh = shard_index(idx, n_shards)
        q8 = quantize_sharded(sh)
        shards[name] = (sh, q8)
        out[f"{name}/docs_f32"] = corpus.docs
        out[f"{name}/queries"] = corpus.queries
        for key in ("centroids", "docs", "doc_ids", "offsets", "sizes"):
            out[f"{name}/{key}"] = np.asarray(getattr(sh, key))
            out[f"{name}/int8_{key}"] = np.asarray(getattr(q8, key))
        out[f"{name}/int8_doc_scales"] = q8.doc_scales
    for name, c in cases.items():
        c = dict(c)
        corpus = c.pop("corpus")
        sh, q8 = shards[corpus]
        use = q8 if c.get("int8_docs") else sh
        fn = make_distributed_search(mesh, k=k, list_pad=list_pad, **c)
        args = [jnp.asarray(getattr(use, key)) for key in
                ("centroids", "docs", "doc_ids", "offsets", "sizes")]
        args.append(jnp.asarray(out[f"{corpus}/queries"]))
        if c.get("int8_docs"):
            args.append(jnp.asarray(use.doc_scales))
        with mesh:
            res = fn(*args)
        for field in res._fields:
            out[f"{name}/{field}"] = np.asarray(getattr(res, field))
    abstract = {}
    for dt in ("float32", "int8"):
        a = abstract_sharded(8000, 24, 64, list_pad, n_shards,
                             getattr(jnp, dt))
        abstract[dt] = {f: None if getattr(a, f) is None else
                        [list(getattr(a, f).shape),
                         str(getattr(a, f).dtype)]
                        for f in ("centroids", "docs", "doc_ids",
                                  "offsets", "sizes", "doc_scales")}
    out["abstract"] = np.asarray(json.dumps(abstract))
    np.savez(out_path, **out)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference output, from one subprocess on 8 fake devices."""
    pytest.importorskip("jax", reason="the reference mesh needs jax")
    path = tmp_path_factory.mktemp("dist_ivf") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_disable_hlo_passes=all-reduce-promotion")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(path), json.dumps(CORPORA),
         json.dumps(CASES), str(K), str(LIST_PAD), str(SHARDS)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def sharded(ref, corpus: str, int8: bool = False) -> ShardedIVF:
    pre = f"{corpus}/int8_" if int8 else f"{corpus}/"
    return ShardedIVF(*(ref[pre + key] for key in SHARD_KEYS), LIST_PAD,
                      SHARDS, ref[pre + "doc_scales"] if int8 else None)


def _mesh_cases(rank, world, shards, queries, cases):
    """Rank program: every case on a (2, 4) gloo mesh, on the CPU."""
    mesh = make_local_mesh(2, 4)
    out = {}
    for name, c in cases.items():
        c = dict(c)
        corpus = c.pop("corpus")
        sh = shards[corpus + ("/int8" if c.get("int8_docs") else "")]
        loc = local_shard(sh, mesh)
        fn = make_distributed_search(mesh, k=K, list_pad=LIST_PAD,
                                     device="cpu", **c)
        extra = (loc.doc_scales,) if c.get("int8_docs") else ()
        res = fn(*(getattr(loc, key) for key in SHARD_KEYS),
                 queries[corpus], *extra)
        out[name] = ([t.numpy() for t in res], fn.stats)
    return out


@pytest.fixture(scope="module")
def port(ref):
    """Every case on 8 spawned gloo ranks: one result list per rank."""
    shards = {}
    for corpus in CORPORA:
        shards[corpus] = sharded(ref, corpus)
        shards[corpus + "/int8"] = sharded(ref, corpus, int8=True)
    queries = {c: ref[f"{c}/queries"] for c in CORPORA}
    return launch(_mesh_cases, 8, shards, queries, CASES, timeout=60,
                  deadline=240)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_search_matches_jax_mesh(ref, port, case):
    (s, i, p), stats = port[0][case]
    np.testing.assert_array_equal(i, ref[f"{case}/topk_ids"])
    np.testing.assert_array_equal(p, ref[f"{case}/probes"])
    np.testing.assert_allclose(s, ref[f"{case}/topk_scores"], rtol=0,
                               atol=ATOL)
    assert stats["steps"] >= 1
    for other in port[1:]:          # the whole result on every rank
        for a, b in zip(other[case][0], (s, i, p)):
            np.testing.assert_array_equal(a, b)


def test_quantize_sharded_bit_for_bit(ref):
    for corpus in CORPORA:
        want = sharded(ref, corpus, int8=True)
        got = quantize_sharded(sharded(ref, corpus))
        for key in SHARD_KEYS + ("doc_scales",):
            a, b = getattr(got, key), getattr(want, key)
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_abstract_sharded_matches_shape_dtype_structs(ref, dtype):
    want = json.loads(str(ref["abstract"]))[dtype]
    got = abstract_sharded(8000, 24, 64, LIST_PAD, SHARDS,
                           getattr(torch, dtype))
    for field, sd in want.items():
        t = getattr(got, field)
        if sd is None:
            assert t is None, field
            continue
        assert t.device.type == "meta"
        assert [list(t.shape), str(t.dtype).replace("torch.", "")] == sd, \
            field


def test_fixed_mesh_equals_search_with_retry(ref, port):
    """Both scan each shard's top ceil(n_probe/S) local lists."""
    (s, i, _), _ = port[0]["fixed"]
    ws, wi, rep = search_with_retry(sharded(ref, "a"), ref["a/queries"],
                                    k=K, n_probe=64, device="cpu")
    assert not rep.retries and not rep.skipped_shards
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_allclose(s, ws, rtol=0, atol=ATOL)


def test_reference_recall_assertions_hold(ref, port):
    for case, corpus, floor in (("fixed", "a", 1.0), ("int8", "b", 0.98)):
        _, exact = brute_force(torch.as_tensor(ref[f"{corpus}/docs_f32"]),
                               torch.as_tensor(ref[f"{corpus}/queries"]), K)
        r = metrics.r_star_at_1(port[0][case][0][1], exact[:, 0].numpy())
        assert r >= floor, (case, r)


# -- the loop's decision ------------------------------------------------------

def _diverging_flags(rank, world, sh, queries):
    """At phi 101 no query exits, but rank 0 sees every step's merged
    set at phi 200, so its queries exit after 2 steps while the other
    ranks' go on."""
    from repro_torch.core import distributed_ivf as dv

    if rank == 0:
        dv.intersection_pct = lambda a, b: torch.full(a.shape[:-1], 200.0)
    mesh = make_local_mesh(1, 4)
    loc = local_shard(sh, mesh)
    fn = make_distributed_search(mesh, n_probe=64, k=K, patience_delta=2,
                                 patience_phi=101.0, list_pad=LIST_PAD,
                                 device="cpu")
    res = fn(*(getattr(loc, key) for key in SHARD_KEYS), queries)
    return fn.stats["steps"], res.topk_ids.numpy(), res.probes.numpy()


def _skips_a_collective(rank, world):
    import torch.distributed as dist

    if rank:
        dist.all_reduce(torch.ones(1))


def test_loop_decision_guard_keeps_ranks_in_step(ref):
    """Ranks fed different active flags still take the same number of
    steps (the reduced flag) and finish with one result."""
    outs = launch(_diverging_flags, 4, sharded(ref, "a"), ref["a/queries"],
                  timeout=20, deadline=120)
    steps = {o[0] for o in outs}
    assert len(steps) == 1 and steps.pop() == 16     # ceil(64 / 4) steps
    for o in outs[1:]:
        np.testing.assert_array_equal(o[1], outs[0][1])


def test_a_diverging_rank_fails_the_launch_not_hangs():
    """A rank that skips a collective fails the launch within the
    group's timeout instead of hanging it."""
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises((ProcessRaisedException, TimeoutError)):
        launch(_skips_a_collective, 2, timeout=5, deadline=60)


# -- on the card --------------------------------------------------------------

def _nccl_fixed(rank, world, sh, queries):
    import torch.distributed as dist

    assert dist.get_backend() == "nccl"
    mesh = make_local_mesh(1, 1)
    loc = local_shard(sh, mesh)
    fn = make_distributed_search(mesh, n_probe=64, k=K, list_pad=LIST_PAD)
    res = fn(*(getattr(loc, key) for key in SHARD_KEYS), queries)
    assert all(t.is_cuda for t in res)
    return [t.cpu().numpy() for t in res]


@pytest.mark.gpu
def test_gpu_one_rank_nccl_mesh_equals_search_with_retry():
    """One NCCL rank on the card: the fixed-N mesh search equals
    ``search_with_retry`` on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = clustered_corpus(n_docs=8000, dim=24, n_components=64,
                         n_queries=64, seed=0)
    sh = shard_index(build_index(c.docs, 64, list_pad=LIST_PAD, n_iters=4,
                                 device="cpu"), 1)
    s, i, p = launch(_nccl_fixed, 1, sh, c.queries, backend="nccl",
                     device="cuda", timeout=60, deadline=300)[0]
    for dev in ("cuda", "cpu"):
        ws, wi, _ = search_with_retry(sh, c.queries, k=K, n_probe=64,
                                      device=dev)
        np.testing.assert_array_equal(i, wi)
        np.testing.assert_allclose(s, ws, rtol=0, atol=ATOL)
    assert (p > 0).all()
