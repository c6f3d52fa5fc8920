"""Port parity for the kernel layer: each kernel module's plain PyTorch
version (what the wrappers run on CPU tensors) against the reference's
kernels, which run in Pallas interpret mode here — or, for the fused
kernel, which does not trace under this JAX (ROADMAP Queue 3, R1),
against ``ref.ivf_scan_merge_ref``.

Tests marked ``gpu`` hold each CUDA kernel against its plain version
on the card; they skip without one.  The card's machine has no JAX, so
the reference is imported by a fixture and the gpu tests run without
the JAX conftest:
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import delta_scan as t_ds
from repro_torch.kernels import embedding_bag as t_eb
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ivf_scan as t_scan
from repro_torch.kernels import ivf_scan_merge as t_sm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import topk_merge as t_tm

T = torch.from_numpy


@pytest.fixture(scope="module")
def ref():
    """The reference kernels (Pallas interpret mode on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops, ref as oracles
    return types.SimpleNamespace(jnp=jnp, ops=ops, oracles=oracles)


def _assert_scores(got, want, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(np.nan_to_num(got, neginf=0.0),
                               np.nan_to_num(want, neginf=0.0), atol=atol)


def _scan_inputs(seed, b=5, d=16, lp=128, n_lists=6):
    rng = np.random.default_rng(seed)
    docs = rng.normal(size=(n_lists * lp + lp, d)).astype(np.float32)
    qs = rng.normal(size=(b, d)).astype(np.float32)
    offs = (rng.integers(0, n_lists, b) * lp).astype(np.int32)
    sizes = rng.integers(0, lp + 1, b).astype(np.int32)
    return qs, docs, offs, sizes, lp


@pytest.mark.parametrize("blk_l", [32, 64])
def test_ivf_scan_plain_matches_reference(ref, blk_l):
    jnp = ref.jnp
    qs, docs, offs, sizes, lp = _scan_inputs(blk_l)
    want = ref.ops.ivf_scan(jnp.asarray(qs), jnp.asarray(docs),
                            jnp.asarray(offs), jnp.asarray(sizes),
                            list_pad=lp, blk_l=blk_l)
    got = tops.ivf_scan(T(qs), T(docs), T(offs), T(sizes), list_pad=lp,
                        blk_l=blk_l)
    _assert_scores(got.numpy(), want)


def _merge_inputs(seed, b=4, k=10, L=30):
    rng = np.random.default_rng(seed)
    s = -np.sort(-rng.normal(size=(b, k)).astype(np.float32), 1)
    i = rng.integers(0, 1000, (b, k)).astype(np.int32)
    ns = rng.normal(size=(b, L)).astype(np.float32)
    ni = rng.integers(1000, 2000, (b, L)).astype(np.int32)
    # exact ties, empty slots and non-finite candidates
    ns[:, 3] = s[:, 2]
    s[0, -3:], i[0, -3:] = -np.inf, -1
    ns[1, :4] = [np.nan, np.inf, -np.inf, np.nan]
    ni[2, 5:9] = -1
    ns[2, 5:9] = -np.inf
    return s, i, ns, ni, k


def topk_case(name, rows=3):
    """(s, i, ns, ni, k) of a named edge of topk_merge, ``rows`` rows: the
    cases of the kernel's CPU model (tests/test_torch_sort.py) and of
    its gpu test below."""
    rng = np.random.default_rng(TOPK_CASES.index(name))
    k0, n_new, k = {"k0_above_k": (100, 256, 10), "k_above_k0": (10, 30, 50),
                    "pads_reach_output": (10, 20, 32),
                    "ids_below_minus_one": (100, 28, 100), "L1": (100, 1, 100),
                    "L4452": (100, 4452, 100),
                    "tiles_overflow_buffer": (100, 4452, 100)
                    }.get(name, (100, 256, 100))
    s = -np.sort(-rng.integers(-3, 4, (rows, k0)).astype(np.float32), 1)
    i = rng.integers(0, 60, (rows, k0)).astype(np.int32)
    ns = rng.integers(-3, 4, (rows, n_new)).astype(np.float32)
    ni = rng.integers(0, 60, (rows, n_new)).astype(np.int32)
    if name == "unsorted_with_holes":      # _scrub_dead's -inf holes
        hole = rng.random((rows, k0)) < 0.2
        s[hole], i[hole] = -np.inf, -1
    if name == "non_finite":               # NaN and ±inf with real ids
        for x in (s, ns):
            x[:, ::7], x[:, 3::11], x[:, 5::13] = np.nan, np.inf, -np.inf
    if name == "ids_below_minus_one":      # rank under the pad records
        ns[:, ::2], ni[:, ::2] = -np.inf, -5
        ns[:, 1::4] = -1e31
        s[:, -20:], i[:, -20:] = -np.inf, -7
    if name == "duplicates":               # records repeated everywhere
        ns[:, :k0], ni[:, :k0] = s, i
        ns[:, k0:2 * k0], ni[:, k0:2 * k0] = s, i
    if name == "all_equal":
        s[:], ns[:] = 0.5, 0.5
    if name == "L256_gaussian":
        s = -np.sort(-rng.normal(size=(rows, k0)).astype(np.float32), 1)
        ns = rng.normal(size=(rows, n_new)).astype(np.float32)
        i = rng.permutation(rows * k0).reshape(rows, k0).astype(np.int32)
    if name == "L4452":                    # the live pair: gated columns
        gate = rng.random((rows, n_new)) < 0.05
        ns, ni = np.where(gate, ns, -np.inf), np.where(gate, ni, -1)
    if name == "tiles_overflow_buffer":    # ascending: every tile survives
        ns = np.sort(rng.normal(size=(rows, n_new)).astype(np.float32), 1)
        s[:] = -np.inf
    return s, i, ns, ni.astype(np.int32), k


TOPK_CASES = ["k0_above_k", "k_above_k0", "pads_reach_output",
               "unsorted_with_holes", "non_finite", "ids_below_minus_one",
               "duplicates", "all_equal", "L1", "L256_gaussian", "L4452",
               "tiles_overflow_buffer"]


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_merge_plain_matches_reference(ref, seed):
    jnp = ref.jnp
    s, i, ns, ni, k = _merge_inputs(seed)
    ws, wi = ref.ops.topk_merge(jnp.asarray(s), jnp.asarray(i),
                                jnp.asarray(ns), jnp.asarray(ni), k)
    gs, gi = tops.topk_merge(T(s), T(i), T(ns), T(ni), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # scores are moved, never recomputed: bit-equal
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def _fused_inputs():
    """The inputs of tests/test_fused.py::test_fused_kernel_matches_ref."""
    rng = np.random.default_rng(3)
    B, chunk, lp, k, d = 4, 3, 256, 10, 16
    n = 64 * lp
    docs = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    qs = rng.normal(size=(B, d)).astype(np.float32)
    offs = np.stack([rng.choice(n // lp, chunk, replace=False) * lp
                     for _ in range(B)]).astype(np.int32)
    sizes = rng.integers(1, lp + 1, size=(B, chunk)).astype(np.int32)
    sizes[0, 1] = 0                        # empty probe slot
    rs = np.full((B, k), -np.inf, np.float32)
    ri = np.full((B, k), -1, np.int32)
    return qs, docs, ids, offs, sizes, rs, ri, k, lp, chunk


def test_ivf_scan_merge_plain_matches_ref_oracle(ref):
    jnp = ref.jnp
    qs, docs, ids, offs, sizes, rs, ri, k, lp, chunk = _fused_inputs()
    r_s, r_i, r_c = ref.oracles.ivf_scan_merge_ref(
        jnp.asarray(qs), jnp.asarray(docs), jnp.asarray(ids),
        jnp.asarray(offs), jnp.asarray(sizes), jnp.asarray(rs),
        jnp.asarray(ri), k, lp)
    o_s, o_i, o_c = tops.ivf_scan_merge(
        T(qs), T(docs), T(ids), T(offs), T(sizes), T(rs), T(ri), k=k,
        list_pad=lp, chunk=chunk)
    _assert_scores(o_s.numpy(), r_s)
    np.testing.assert_array_equal(o_i.numpy(), np.asarray(r_i))
    np.testing.assert_array_equal(o_c.numpy(), np.asarray(r_c))
    # phi recovered from counts == intersection_pct of the snapshots
    from repro_torch.core.ivf import intersection_pct
    prev = T(ri)
    for t in range(chunk):
        phi_cnt = 100.0 * (k - o_c[:, t].numpy()) / k
        np.testing.assert_allclose(
            phi_cnt, intersection_pct(prev, o_i[:, t]).numpy(), atol=1e-4)
        prev = o_i[:, t]


def test_ivf_scan_merge_carries_running_topk_across_calls():
    """Two launches of chunk c equal one launch of chunk 2c: the running
    top-k in and out is the whole state of a query."""
    qs, docs, ids, offs, sizes, rs, ri, k, lp, _ = _fused_inputs()
    offs, sizes = np.concatenate([offs, offs[:, ::-1]], 1), \
        np.concatenate([sizes, sizes[:, ::-1]], 1)
    full = tops.ivf_scan_merge(T(qs), T(docs), T(ids), T(offs), T(sizes),
                               T(rs), T(ri), k=k, list_pad=lp, chunk=6)
    a = tops.ivf_scan_merge(T(qs), T(docs), T(ids), T(offs[:, :3].copy()),
                            T(sizes[:, :3].copy()), T(rs), T(ri), k=k,
                            list_pad=lp, chunk=3)
    b = tops.ivf_scan_merge(T(qs), T(docs), T(ids), T(offs[:, 3:].copy()),
                            T(sizes[:, 3:].copy()), a[0][:, -1].contiguous(),
                            a[1][:, -1].contiguous(), k=k, list_pad=lp,
                            chunk=3)
    for x, y, z in zip(full, a, b):
        np.testing.assert_array_equal(x.numpy(),
                                      torch.cat([y, z], 1).numpy())


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _to(dev, *xs):
    return [T(np.ascontiguousarray(x)).to(dev) for x in xs]


@pytest.mark.gpu
def test_gpu_ivf_scan_matches_plain(cuda):
    rng = np.random.default_rng(0)
    qs, docs, offs, _, lp = _scan_inputs(0, b=64, d=768, lp=256)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    qs_i = rng.integers(-2, 3, qs.shape).astype(np.float32)
    docs_i = rng.integers(-2, 3, docs.shape).astype(np.float32)
    for q, dd, exact in ((qs_i, docs_i, True), (qs, docs, False)):
        q, dd, bo = _to(cuda, q, dd, offs // 64)
        before = t_scan.ivf_scan.launches
        got = t_scan.ivf_scan(q, dd, bo, list_pad=lp, blk_l=64)
        torch.cuda.synchronize()
        assert t_scan.ivf_scan.launches == before + 1
        want = t_scan.ivf_scan_plain(q, dd, bo, list_pad=lp, blk_l=64)
        if exact:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_gpu_topk_merge_matches_plain(cuda):
    """Bit-equal to the plain version on the pair search's shape and on
    every edge of the kernel's CPU model, one launch a call."""
    cases = [_merge_inputs(seed, b=64, k=100, L=256) for seed in (0, 1)]
    cases += [topk_case(name, rows=16) for name in TOPK_CASES]
    for s, i, ns, ni, k in cases:
        s, i, ns, ni = _to(cuda, s, i, ns, ni)
        before = t_tm.topk_merge.launches
        got = t_tm.topk_merge(s, i, ns, ni, k)
        torch.cuda.synchronize()
        assert t_tm.topk_merge.launches == before + 1
        want = t_tm.topk_merge_plain(s, i, ns, ni, k)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_gpu_ivf_scan_merge_matches_plain(cuda):
    qs, docs, ids, offs, sizes, rs, ri, k, lp, chunk = _fused_inputs()
    rng = np.random.default_rng(1)
    qs = rng.integers(-2, 3, qs.shape).astype(np.float32)
    docs = rng.integers(-2, 3, docs.shape).astype(np.float32)
    q, dd, ii, bo, sz, s0, i0 = _to(
        cuda, qs, docs, ids.reshape(-1, 64), (offs // 64).reshape(-1),
        sizes.reshape(-1), rs, ri)
    got = t_sm.ivf_scan_merge(q, dd, ii, bo, sz, s0, i0, k=k, list_pad=lp,
                              chunk=chunk, blk_l=64)
    torch.cuda.synchronize()
    want = t_sm.ivf_scan_merge_plain(q, dd, ii, bo, sz, s0, i0, k=k,
                                     list_pad=lp, chunk=chunk, blk_l=64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_gpu_wrapper_rejects_mixed_devices(cuda):
    qs, docs, offs, _, lp = _scan_inputs(0)
    with pytest.raises(ValueError, match="different devices"):
        t_scan.ivf_scan(T(qs).to(cuda), T(docs), T(offs // 64).to(cuda),
                        list_pad=lp, blk_l=64)


def _delta_fused_inputs(seed=5, b=6, chunk=4, lp=256, k=10, d=16, cap=300,
                        integer=False):
    """Fused inputs with a delta stream: doc and delta ids a random
    permutation, tombstoned (-1) slots in both, several buffer entries
    assigned to one probed cluster, empty buffer slots (assign -1) and
    gates of -2 past the budget."""
    rng = np.random.default_rng(seed)
    n_lists = 16

    def draw(shape):
        if integer:
            return rng.integers(-2, 3, shape).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)

    docs = draw(((n_lists + 1) * lp, d))
    perm = rng.permutation(docs.shape[0] + cap).astype(np.int32)
    ids = perm[: docs.shape[0]].copy()
    ids[rng.random(ids.size) < 0.05] = -1
    ids[n_lists * lp:] = -1
    qs = draw((b, d))
    cids = np.stack([rng.choice(n_lists, chunk, replace=False)
                     for _ in range(b)]).astype(np.int32)
    sizes = rng.integers(0, lp + 1, (b, chunk)).astype(np.int32)
    sizes[:, 0] = lp
    dvecs = draw((cap, d))
    dids = perm[docs.shape[0]:].copy()
    dassign = rng.integers(0, n_lists, cap).astype(np.int32)
    dassign[: cap // 8] = cids[0, min(1, chunk - 1)]   # a crowd in a list
    dids[rng.random(cap) < 0.2] = -1          # tombstoned
    dids[cap - cap // 10:], dassign[cap - cap // 10:] = -1, -1   # empty
    gates = cids.copy()
    gates[1, 2:] = -2                         # past the probe budget
    rs = np.full((b, k), -np.inf, np.float32)
    ri = np.full((b, k), -1, np.int32)
    return (qs, docs, ids, cids * lp // 64, sizes, rs, ri, dvecs, dids,
            dassign, gates, k, lp, chunk)


def test_ivf_scan_merge_delta_plain_matches_pair():
    """Plain fused-with-delta == the per-probe pair per slot: list rows
    and gated buffer entries concatenated, one merge, counts from the
    intersection."""
    from repro_torch.core.ivf import intersection_pct
    (qs, docs, ids, bo, sizes, rs, ri, dvecs, dids, dassign, gates, k, lp,
     chunk) = _delta_fused_inputs()
    q, dd, dv = T(qs), T(docs), T(dvecs)
    s, i, c = t_sm.ivf_scan_merge(
        q, dd, T(ids.reshape(-1, 64)), T(bo.reshape(-1)),
        T(sizes.reshape(-1)), T(rs), T(ri), k=k, list_pad=lp, chunk=chunk,
        delta_vecs=dv, delta_ids=T(dids), delta_assign=T(dassign),
        gate_cids=T(gates.reshape(-1)))
    d_sc = t_ds.delta_scan(q, dv)
    run_s, run_i = T(rs), T(ri)
    lane = torch.arange(lp)
    for j in range(chunk):
        rows = T(bo[:, j]).long()[:, None] * 64 + lane
        li = T(ids)[rows]
        alive = (lane < T(sizes[:, j])[:, None]) & (li >= 0)
        ls = torch.where(alive, t_scan.ivf_scan_plain(
            q, dd, T(bo[:, j]), list_pad=lp, blk_l=64), float("-inf"))
        gate = (T(dassign)[None] == T(gates[:, j])[:, None]) \
            & (T(dids)[None] >= 0)
        ns = torch.cat([ls, torch.where(gate, d_sc, float("-inf"))], 1)
        ni = torch.cat([torch.where(alive, li, -1),
                        torch.where(gate, T(dids)[None], -1)], 1)
        ws, wi = tops.topk_merge(run_s, run_i, ns, ni, k)
        got_s = torch.where(s[:, j] > t_sm.VALID_MIN, s[:, j], float("-inf"))
        assert torch.equal(i[:, j], wi), j
        assert torch.equal(got_s, ws), j
        phi = 100.0 * (k - c[:, j]).float() / k
        torch.testing.assert_close(phi, intersection_pct(run_i, wi),
                                   atol=1e-4, rtol=0)
        run_s, run_i = ws, wi
    assert (gates == -2).any() and (dids == -1).any()


def test_ivf_scan_merge_delta_arguments_come_together():
    (qs, docs, ids, bo, sizes, rs, ri, dvecs, dids, dassign, gates, k, lp,
     chunk) = _delta_fused_inputs()
    with pytest.raises(ValueError, match="together"):
        t_sm.ivf_scan_merge(
            T(qs), T(docs), T(ids.reshape(-1, 64)), T(bo.reshape(-1)),
            T(sizes.reshape(-1)), T(rs), T(ri), k=k, list_pad=lp,
            chunk=chunk, delta_vecs=T(dvecs), delta_ids=T(dids))


# -- on the card: the live index's kernels ------------------------------------


@pytest.mark.gpu
def test_gpu_delta_scan_matches_plain(cuda):
    rng = np.random.default_rng(2)
    # d = 30: rows not 16-byte aligned (4-byte staging), a ragged chunk
    for b, cap, d, exact in ((37, 300, 768, True), (128, 4096, 768, True),
                             (9, 50, 30, True), (128, 4096, 768, False)):
        if exact:
            q = rng.integers(-2, 3, (b, d)).astype(np.float32)
            v = rng.integers(-2, 3, (cap, d)).astype(np.float32)
        else:
            q = rng.normal(size=(b, d)).astype(np.float32)
            v = rng.normal(size=(cap, d)).astype(np.float32)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            v /= np.linalg.norm(v, axis=1, keepdims=True)
        q, v = _to(cuda, q, v)
        before = t_ds.delta_scan.launches
        got = t_ds.delta_scan(q, v)
        torch.cuda.synchronize()
        assert t_ds.delta_scan.launches == before + 1
        want = t_ds.delta_scan_plain(q, v)
        if exact:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,cap", [(37, 300), (128, 4096)])
def test_gpu_delta_scan_equals_ivf_scan_rows(cuda, b, cap):
    """delta_scan's register tile keeps row_dot's order: every score is
    ivf_scan's for the same row, the buffer laid out as lists of 256 rows
    that every query probes (one ivf_scan launch per list)."""
    rng = np.random.default_rng(b + cap)
    q = rng.normal(size=(b, 768)).astype(np.float32)
    v = rng.normal(size=(cap, 768)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    n_lists = -(-cap // 256)
    docs = np.zeros((n_lists * 256, 768), np.float32)
    docs[:cap] = v
    q, v, docs = _to(cuda, q, v, docs)
    got = t_ds.delta_scan(q, v)
    want = torch.cat([t_scan.ivf_scan(
        q, docs, torch.full((b,), 4 * i, dtype=torch.int32, device=cuda),
        list_pad=256, blk_l=64) for i in range(n_lists)], 1)[:, :cap]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_gpu_ivf_scan_merge_delta_matches_plain(cuda):
    """The delta stream at the main path's capacity (4,096 slots: past
    48 KB of shared memory) on integer inputs: bit-equal, ties included."""
    (qs, docs, ids, bo, sizes, rs, ri, dvecs, dids, dassign, gates, k, lp,
     chunk) = _delta_fused_inputs(b=16, k=100, d=768, cap=4096,
                                  integer=True)
    args = _to(cuda, qs, docs, ids.reshape(-1, 64), bo.reshape(-1),
               sizes.reshape(-1), rs, ri)
    delta = dict(zip(("delta_vecs", "delta_ids", "delta_assign",
                      "gate_cids"),
                     _to(cuda, dvecs, dids, dassign, gates.reshape(-1))))
    before = t_sm.ivf_scan_merge.delta_launches
    got = t_sm.ivf_scan_merge(*args, k=k, list_pad=lp, chunk=chunk,
                              **delta)
    torch.cuda.synchronize()
    assert t_sm.ivf_scan_merge.delta_launches == before + 1
    want = t_sm.ivf_scan_merge_plain(*args, k=k, list_pad=lp, chunk=chunk,
                                     blk_l=64, **delta)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _edge_case(name):
    """Integer fused inputs with the delta stream for one edge of the
    kernel's design (``test_gpu_ivf_scan_merge_edges_match_plain``)."""
    kw = dict(b=4, k=100, d=16, cap=300, integer=True)
    kw.update({"k1": dict(k=1), "k1024": dict(k=1024, d=768),
               "chunk1": dict(chunk=1), "chunk8": dict(chunk=8),
               "d100": dict(d=100), "d30": dict(d=30),
               "all_gated": dict(d=768, cap=4096)}.get(name, {}))
    (qs, docs, ids, bo, sizes, rs, ri, dvecs, dids, dassign, gates, k, lp,
     chunk) = _delta_fused_inputs(**kw)
    rng = np.random.default_rng(7)
    n_ids = docs.shape[0] + dvecs.shape[0]
    if name == "all_gated":
        # every buffer entry live and gated on one slot: past the gated
        # list and the survivor buffer, so rescans and several merges
        dids = np.arange(n_ids, n_ids + len(dids), dtype=np.int32)
        dassign[:] = gates[0, 1]
    if name in ("inactive", "empty_slots", "ties"):
        # a running top-k out of its packed order among equal scores
        rs = rng.integers(-3, 4, rs.shape).astype(np.float32)
        rs = -np.sort(-rs, 1)
        ri = rng.integers(0, n_ids, ri.shape).astype(np.int32)
    if name in ("inactive", "empty_slots"):
        rs[:, k - 10:], ri[:, k - 10:] = -np.inf, -1
    if name == "inactive":
        sizes[:], gates[:] = 0, -2
    if name == "ties":
        # the running k-th's score is a common candidate score; ids on
        # both sides of the k-th's among equal scores
        rs[:] = 0.0
        ri[:] = np.sort(rng.choice(n_ids, ri.shape[1], replace=False))[::-1]
    return (qs, docs, ids, bo, sizes, rs, ri, dvecs, dids, dassign, gates,
            k, lp, chunk)


def test_fused_layout_does_not_grow_with_cap():
    """The kernel's shared memory (mirrored by smem_bytes) has no cap term;
    the ring takes the most stages that fit, none where cp.async.bulk
    cannot copy the rows and ids."""
    limit = 232_448                        # an H100's opt-in limit
    assert "cap" not in t_sm.smem_bytes.__code__.co_varnames
    assert t_sm.ring_stages(768, 100, 4, 256, True, limit) == 4
    assert t_sm.smem_bytes(768, 100, 4, 256, 4) == 208_784
    assert t_sm.ring_stages(768, 1024, 4, 256, True, limit) == 4
    assert t_sm.ring_stages(100, 100, 4, 256, True, limit) == 4
    assert t_sm.ring_stages(30, 100, 4, 256, True, limit) == 0  # 120-byte rows
    assert t_sm.ring_stages(768, 100, 4, 256, False, limit) == 0
    assert t_sm.ring_stages(1536, 100, 4, 256, True, limit) == 2
    assert t_sm.ring_stages(4096, 100, 4, 256, True, limit) == 0  # 2 stages


@pytest.mark.parametrize("name", ["ties", "empty_slots", "inactive", "k1",
                                  "k1024", "chunk1", "chunk8", "d30"])
def test_ivf_scan_merge_edges_plain_match_kernel_model(name):
    """The edge cases of the gpu test below, on the CPU: the plain fused
    version equals, bit for bit, a model of the kernel's merge
    (``tests/test_torch_sort.py``: the running top-k ranked once,
    candidates 16 at a time filtered by the running k-th into a
    512-record buffer, merged by rank, re-ranked after the marks are
    stripped) fed each slot's list rows and gated entries."""
    from test_torch_sort import _kernel_rank, _kernel_slot, _words

    (qs, docs, ids, bo, sizes, rs, ri, dvecs, dids, dassign, gates, k, lp,
     chunk) = _edge_case(name)
    q, dd, dv = T(qs), T(docs), T(dvecs)
    s, i, c = t_sm.ivf_scan_merge(
        q, dd, T(ids.reshape(-1, 64)), T(bo.reshape(-1)),
        T(sizes.reshape(-1)), T(rs), T(ri), k=k, list_pad=lp, chunk=chunk,
        delta_vecs=dv, delta_ids=T(dids), delta_assign=T(dassign),
        gate_cids=T(gates.reshape(-1)))
    key = t_sm.sort.score_to_key
    d_key = key(t_ds.delta_scan_plain(q, dv)).numpy()
    mark = t_sm.sort.NEW_MARK
    for b in range(qs.shape[0]):
        run = _kernel_rank(_words(
            key(torch.clamp_min(T(rs[b]), t_sm.NEG)).numpy(), ri[b]), k)
        for j in range(chunk):
            rows = bo[b, j] * 64 + np.arange(sizes[b, j])
            rows = rows[ids[rows] >= 0]
            l_key = key(t_scan.score_rows(q[b:b + 1], dd, T(rows)[None]))[0]
            gated = np.flatnonzero((dassign == gates[b, j]) & (dids >= 0))
            cands = np.concatenate([
                _words(l_key.numpy(), ids[rows] | mark),
                _words(d_key[b, gated], dids[gated] | mark)])
            w_keys, w_ids, w_cnt, run = _kernel_slot(run, cands, k, 512, 16)
            np.testing.assert_array_equal(key(s[b, j]).numpy(), w_keys)
            np.testing.assert_array_equal(i[b, j].numpy(), w_ids)
            assert c[b, j] == w_cnt, (b, j)
    if name == "inactive":
        assert torch.equal(c, torch.full_like(c, 10))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["all_gated", "inactive", "ties",
                                  "empty_slots", "k1", "k1024", "chunk1",
                                  "chunk8", "d100", "d30"])
def test_gpu_ivf_scan_merge_edges_match_plain(cuda, name):
    """The redesign's edges, bit-equal to the plain version in both modes
    (one launch each): every buffer entry gated on one slot at cap 4,096,
    an all-inactive wave, ties with the running k-th, empty running
    slots, k 1 and 1,024, chunk 1 and 8, d 100 (staged) and d 30 (rows
    read from global memory)."""
    (qs, docs, ids, bo, sizes, rs, ri, dvecs, dids, dassign, gates, k, lp,
     chunk) = _edge_case(name)
    args = _to(cuda, qs, docs, ids.reshape(-1, 64), bo.reshape(-1),
               sizes.reshape(-1), rs, ri)
    delta = dict(zip(("delta_vecs", "delta_ids", "delta_assign",
                      "gate_cids"),
                     _to(cuda, dvecs, dids, dassign, gates.reshape(-1))))
    for stream, counter in (({}, "launches"), (delta, "delta_launches")):
        before = getattr(t_sm.ivf_scan_merge, counter)
        got = t_sm.ivf_scan_merge(*args, k=k, list_pad=lp, chunk=chunk,
                                  **stream)
        torch.cuda.synchronize()
        assert getattr(t_sm.ivf_scan_merge, counter) == before + 1
        want = t_sm.ivf_scan_merge_plain(*args, k=k, list_pad=lp,
                                         chunk=chunk, blk_l=64, **stream)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (name, counter)


@pytest.mark.gpu
def test_gpu_topk_merge_wide_matches_plain(cuda):
    """k + list_pad + 4,096 columns (8,192 records, 64 KB of shared
    memory): the live per-probe pair's merge."""
    s, i, ns, ni, k = _merge_inputs(3, b=32, k=100, L=256 + 4096)
    s, i, ns, ni = _to(cuda, s, i, ns, ni)
    got = t_tm.topk_merge(s, i, ns, ni, k)
    torch.cuda.synchronize()
    want = t_tm.topk_merge_plain(s, i, ns, ni, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_gpu_wrappers_raise_past_the_shared_memory_limit(cuda):
    """topk_merge's shared memory grows with k only: 40,000 columns merge
    bit for bit as the plain version does, and a k whose running top-k
    does not fit the card's shared memory raises."""
    s, i, ns, ni, k = _merge_inputs(4, b=4, k=100, L=40_000)
    s, i, ns, ni = _to(cuda, s, i, ns, ni)
    got = t_tm.topk_merge(s, i, ns, ni, k)
    torch.cuda.synchronize()
    for g, w in zip(got, t_tm.topk_merge_plain(s, i, ns, ni, k)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="the card allows"):
        t_tm.topk_merge(s, i, ns, ni, 20_000)


# -- the model zoo's kernels: flash_attention and embedding_bag ---------------


def _qkv(seed, bh, s, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, s, hd)).astype(np.float32)
            for _ in range(3)]


def _cast(ref, xs, bf16):
    """The same values on both sides: f32 numpy, rounded to bf16 (to
    nearest even) by each framework when ``bf16``."""
    jnp = ref.jnp
    jx = [jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32) for x in xs]
    tx = [T(x).to(torch.bfloat16) if bf16 else T(x) for x in xs]
    return jx, tx


# the sweep of tests/test_kernels.py::test_flash_attention_sweep; the
# tolerances are its own: f32 sums in another order (2e-5), and in bf16
# one rounding of the output (2e-2)
@pytest.mark.parametrize("s,hd,blk", [(128, 64, 64), (256, 64, 128),
                                      (256, 128, 64), (512, 32, 128)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_flash_attention_plain_matches_reference(ref, s, hd, blk, bf16):
    (jq, jk, jv), (tq, tk, tv) = _cast(ref, _qkv(s + hd, 2, s, hd), bf16)
    tol = 2e-2 if bf16 else 2e-5
    got = tops.flash_attention(tq, tk, tv).float().numpy()
    assert tops.flash_attention(tq, tk, tv).dtype == tq.dtype
    for want in (ref.ops.flash_attention(jq, jk, jv, blk_q=blk, blk_k=blk),
                 ref.oracles.flash_attention_ref(jq, jk, jv)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_flash_attention_plain_non_causal_matches_reference(ref):
    (jq, jk, jv), (tq, tk, tv) = _cast(ref, _qkv(1, 2, 128, 32), False)
    got = tops.flash_attention(tq, tk, tv, causal=False).numpy()
    for want in (ref.ops.flash_attention(jq, jk, jv, causal=False, blk_q=64,
                                         blk_k=64),
                 ref.oracles.flash_attention_ref(jq, jk, jv, causal=False)):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("s", [33, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_ragged_s_matches_ref_oracle(ref, s, causal):
    """Any S (the Pallas kernel asserts S % blk == 0, so only the oracle
    takes these)."""
    (jq, jk, jv), (tq, tk, tv) = _cast(ref, _qkv(s, 3, s, 64), False)
    got = tops.flash_attention(tq, tk, tv, causal=causal).numpy()
    want = ref.oracles.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_flash_attention_wrapper_checks_inputs():
    q, k, v = (T(x) for x in _qkv(0, 2, 16, 64))
    with pytest.raises(ValueError, match="k must be torch.float32"):
        t_fa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="shape"):
        t_fa.flash_attention(q, k[:, :8].contiguous(), v)


def _flash_bf16_emulation(q, k, v, causal, fault=None):
    """csrc/flash_attention.cu's bf16 arithmetic in plain torch: 128-key
    tiles, the online softmax in the exp2 domain (scale f32(1/sqrt(hd))
    times log2(e)), l summed from the f32 P, P rounded to bf16 before
    P V, f32 accumulation, one bf16 rounding of acc / max(l, 1e-30).
    ``fault`` plants one error: "mask_off_by_one" lets each row see one
    key past the diagonal, "l_one_tile_short" leaves the last tile out of
    l."""
    bh, s, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32) \
        * torch.tensor(np.log2(np.e), dtype=torch.float32)
    rows = torch.arange(s)[:, None]
    m = torch.full((bh, s, 1), t_fa.NEG_INF)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, hd))
    n_kv = -(-s // 128)
    for j in range(n_kv):
        keys = torch.arange(j * 128, min(s, j * 128 + 128))[None, :]
        x = torch.einsum("bqh,bkh->bqk", qf, kf[:, keys[0]]) * scale
        reach = keys - (1 if fault == "mask_off_by_one" else 0)
        if causal:
            x = torch.where(reach > rows, t_fa.NEG_INF, x)
        m_new = torch.maximum(m, x.max(-1, keepdim=True).values)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha
        if not (fault == "l_one_tile_short" and j == n_kv - 1):
            l = l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bqk,bkh->bqh", p.to(torch.bfloat16).float(), vf[:, keys[0]])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


def _bf16_qkv(seed, s, hd, bh=3):
    return [T(x).to(torch.bfloat16) for x in _qkv(seed, bh, s, hd)]


@pytest.mark.parametrize("s", [33, 200, 256])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_emulation_within_bound(s, hd, causal):
    """The bf16 kernel's arithmetic stays within ``bf16_bound`` of the
    plain version (which the Pallas kernel is held to above)."""
    q, k, v = _bf16_qkv(s * hd, s, hd)
    want = t_fa.flash_attention_plain(q, k, v, causal=causal)
    got = _flash_bf16_emulation(q, k, v, causal)
    err = (got.float() - want.float()).abs()
    assert (err <= t_fa.bf16_bound(q, k, v, want, causal=causal)).all()
    assert err.max() > 0      # P in bf16 does move the output


@pytest.mark.parametrize("fault", ["mask_off_by_one", "l_one_tile_short"])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_bf16_bound_catches_a_planted_fault(fault, hd):
    """The bound has teeth: one planted error in the emulation breaks it."""
    q, k, v = _bf16_qkv(hd, 200, hd)
    want = t_fa.flash_attention_plain(q, k, v, causal=True)
    got = _flash_bf16_emulation(q, k, v, True, fault=fault)
    bound = t_fa.bf16_bound(q, k, v, want, causal=True)
    assert ((got.float() - want.float()).abs() > bound).any()


# the sweep of tests/test_kernels.py::test_embedding_bag_sweep, plus
# DeepFM's widths (F=39, D=10 and the D=1 linear table)
@pytest.mark.parametrize("r,d,b,f", [(50, 8, 4, 3), (200, 16, 8, 5),
                                     (1000, 32, 2, 10), (200, 10, 8, 39),
                                     (200, 1, 8, 39)])
def test_embedding_bag_plain_bit_equal_to_pallas(ref, r, d, b, f):
    """Both add a bag's rows in f32 in the order f = 0..F-1: bit-equal."""
    rng = np.random.default_rng(2)
    table = rng.normal(0, 1, (r, d)).astype(np.float32)
    ids = rng.integers(0, r, (b, f)).astype(np.int32)
    want = ref.ops.embedding_bag(ref.jnp.asarray(table),
                                 ref.jnp.asarray(ids))
    got = tops.embedding_bag(T(table), T(ids).long())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- on the card: the model zoo's kernels -------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("s", [128, 200, 2064])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_flash_attention_matches_plain(cuda, s, hd, dtype):
    """f32 within 2e-5 (sums in another order); bf16 within
    ``bf16_bound`` (P rounded to bf16 before P V)."""
    q, k, v = (x.to(dtype) for x in _to(cuda, *_qkv(s + hd, 6, s, hd)))
    for causal in (True, False):
        before = t_fa.flash_attention.launches
        got = t_fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert t_fa.flash_attention.launches == before + 1
        want = t_fa.flash_attention_plain(q, k, v, causal=causal)
        assert got.dtype == dtype
        if dtype == torch.bfloat16:
            bound = t_fa.bf16_bound(q, k, v, want, causal=causal)
            assert ((got.float() - want.float()).abs() <= bound).all()
        else:
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_gpu_flash_attention_refuses_other_head_dims(cuda):
    q, k, v = _to(cuda, *_qkv(0, 2, 64, 32))
    with pytest.raises(ValueError, match="hd in"):
        t_fa.flash_attention(q, k, v)


@pytest.mark.gpu
def test_gpu_flash_attention_bf16_refuses_misaligned_inputs(cuda):
    """The bf16 kernel's TMA descriptors need 16-byte-aligned tensors: a
    contiguous view one element in raises instead of launching."""
    q, k, v = (x.to(torch.bfloat16) for x in _to(cuda, *_qkv(1, 2, 64, 64)))
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        t_fa.flash_attention(shifted, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("d", [1, 3, 10, 16])
@pytest.mark.parametrize("f", [1, 39, 40])
def test_gpu_embedding_bag_matches_plain(cuda, d, f, shift):
    """Bit-equal at every vector width the kernel picks (D 1, 3: scalars;
    10: float2; 16: float4), on a table view ``shift`` floats into its
    storage (4 and 8 bytes break the 16- and 8-byte loads), a B that is
    no multiple of any tile, and ids that start unaligned in each tile."""
    rng = np.random.default_rng(d * 100 + f)
    table = rng.normal(size=(5000, d)).astype(np.float32)
    ids = rng.integers(0, 5000, (777, f)).astype(np.int32)
    table, ids = _to(cuda, table, ids)
    flat = torch.zeros(table.numel() + shift, device=cuda)
    flat[shift:] = table.reshape(-1)
    table = flat[shift:].view(5000, d)
    before = t_eb.embedding_bag.launches
    got = t_eb.embedding_bag(table, ids)
    torch.cuda.synchronize()
    assert t_eb.embedding_bag.launches == before + 1
    assert torch.equal(got, t_eb.embedding_bag_plain(table, ids))


@pytest.mark.gpu
def test_gpu_embedding_bag_unstaged_bags_match_plain(cuda):
    """Bags whose ids alone pass the kernel's 48 KB of staged ids read
    them from global memory: bit-equal all the same."""
    rng = np.random.default_rng(7)
    table = rng.normal(size=(3000, 10)).astype(np.float32)
    ids = rng.integers(0, 3000, (5, 13_000)).astype(np.int32)
    table, ids = _to(cuda, table, ids)
    got = t_eb.embedding_bag(table, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, t_eb.embedding_bag_plain(table, ids))


# -- on the card: the learned stages' features --------------------------------


@pytest.mark.gpu
def test_gpu_extract_features_are_batch_independent(cuda):
    """``extract_features`` on the card: one call over 384 queries equals
    calls of 128, 96 and 1 rows bit for bit (centroid sims by the
    ``delta_scan`` kernel, probes by the fused kernel), and equals the
    features a learned search read at tau on the fused path and on the
    kernel pair."""
    from repro_torch.core import (build_index, extract_features, policies,
                                  search)
    from repro_torch.data.synthetic import clustered_corpus
    from repro_torch.trees import ensemble_from_arrays

    c = clustered_corpus(n_docs=20_000, dim=64, n_components=96,
                         n_queries=384, seed=3)
    index = build_index(c.docs, 96, list_pad=256, n_iters=4, device=cuda)
    q = torch.from_numpy(c.queries).to(cuda)
    tau, k = 10, 100
    whole = extract_features(index, q, tau=tau, k=k)
    for block in (128, 96, 1):
        parts = torch.cat([extract_features(index, q[s: s + block],
                                            tau=tau, k=k)
                           for s in range(0, q.shape[0], block)])
        assert torch.equal(parts, whole), block
    # a one-split stump on feature 0: half the queries exit at tau
    stump = ensemble_from_arrays(
        [[0, -1, -1]], [[float(whole[:, 0].median())] * 3], [[1, 1, 2]],
        [[2, 1, 2]], [[0.0, 1.0, -1.0]], 0.0, 1, device=cuda)
    pol = policies.cascade_patience(40, stump, 7, 95.0, k=k, tau=tau)
    fused = search(index, q, pol, use_fused_kernel=True, chunk=4)
    pair = search(index, q, pol, use_scan_kernel=True, use_topk_kernel=True)
    torch.cuda.synchronize()
    for res in (fused, pair):
        assert torch.equal(res.features, whole)
    for f in ("topk_ids", "probes", "topk_scores"):
        assert torch.equal(getattr(fused, f), getattr(pair, f)), f
    assert (fused.probes == tau).any() and (fused.probes > tau).any()
