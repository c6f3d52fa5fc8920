"""Port parity for the index build and early-exit search: the same
corpus and the same reference index (carried across as numpy arrays by
``index_from_arrays``) through ``repro`` and ``repro_torch``.

The reference side is the per-probe JAX ``search``: its fused path does
not trace under this JAX (ROADMAP Queue 3, R1).  Ids and probe counts
must be equal; scores agree within 1e-5 and phi history within 1e-4,
the tolerances of tests/test_fused.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import brute_force as j_brute_force
from repro.core import policies as jpol
from repro.core import search as jsearch
from repro.core.ivf import intersection_pct as j_intersection_pct
from repro.core.ivf import min_probes_labels as j_min_probes_labels
from repro.core.ivf import probe_trace as j_probe_trace
from repro_torch.core import (brute_force, build_index, index_from_arrays,
                              policies, search, validate_alignment)
from repro_torch.core.ivf import (DeltaView, _probe_tiles, centroid_rank,
                                  intersection_pct, merge_topk,
                                  min_probes_labels, probe_candidates,
                                  probe_trace, scan_merge_chunk, scrub_dead)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.delta_scan import delta_scan_plain


def port_index(jax_index):
    return index_from_arrays(
        np.asarray(jax_index.centroids), np.asarray(jax_index.docs),
        np.asarray(jax_index.doc_ids), np.asarray(jax_index.cluster_offsets),
        np.asarray(jax_index.cluster_sizes), jax_index.list_pad,
        device="cpu")


@pytest.fixture(scope="module")
def t_index(tiny_index):
    return port_index(tiny_index)


def _policies(name):
    if name == "patience":
        return (jpol.patience(24, delta=2, phi=90.0, k=10, tau=3),
                policies.patience(24, delta=2, phi=90.0, k=10, tau=3))
    return jpol.fixed(12, k=10, tau=3), policies.fixed(12, k=10, tau=3)


@pytest.fixture(scope="module")
def reference_runs(tiny_index, tiny_corpus):
    q = jnp.asarray(tiny_corpus.queries[:64])
    return {name: jsearch(tiny_index, q, _policies(name)[0])
            for name in ("patience", "fixed")}


def test_build_index_matches_reference(tiny_index, tiny_corpus):
    ti = build_index(tiny_corpus.docs, 64, list_pad=256, n_iters=4, seed=0,
                     device="cpu")
    np.testing.assert_allclose(ti.centroids.numpy(),
                               np.asarray(tiny_index.centroids), atol=1e-5)
    for f in ("cluster_offsets", "cluster_sizes", "doc_ids"):
        np.testing.assert_array_equal(getattr(ti, f).numpy(),
                                      np.asarray(getattr(tiny_index, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(ti.docs.numpy(),
                                  np.asarray(tiny_index.docs))
    assert ti.list_pad == tiny_index.list_pad


_PATHS = {
    "per_probe": {},
    "per_probe_kernels": dict(use_scan_kernel=True, use_topk_kernel=True),
    "fused_c2": dict(use_fused_kernel=True, chunk=2),
    "fused_c4": dict(use_fused_kernel=True, chunk=4),
    "fused_c5": dict(use_fused_kernel=True, chunk=5),
}


@pytest.mark.parametrize("path", sorted(_PATHS))
@pytest.mark.parametrize("policy_name", ["patience", "fixed"])
def test_search_matches_reference_per_probe(t_index, tiny_corpus,
                                            reference_runs, policy_name,
                                            path):
    base = reference_runs[policy_name]
    res = search(t_index, tiny_corpus.queries[:64],
                 _policies(policy_name)[1], **_PATHS[path])
    np.testing.assert_array_equal(res.topk_ids.numpy(),
                                  np.asarray(base.topk_ids))
    np.testing.assert_array_equal(res.probes.numpy(),
                                  np.asarray(base.probes))
    got, want = res.topk_scores.numpy(), np.asarray(base.topk_scores)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(np.nan_to_num(got, neginf=0.0),
                               np.nan_to_num(want, neginf=0.0), atol=1e-5)
    np.testing.assert_allclose(res.phi_hist.numpy(),
                               np.asarray(base.phi_hist), atol=1e-4)


def test_probe_tiles_match_reference(tiny_index, t_index):
    from repro.core.ivf import _probe_tiles as j_probe_tiles
    cids = np.arange(t_index.n_clusters, dtype=np.int32)[::-1].copy()
    want = j_probe_tiles(tiny_index, jnp.asarray(cids))
    got = _probe_tiles(t_index, torch.from_numpy(cids).long())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _chunk_case(t_index, tiny_corpus, with_delta, with_dead):
    """One chunk of 4 probes after a first one, for 16 queries: a
    (16, 4) slot mask whose last slot is past the probe budget and whose
    rows 3, 7, 11, 15 are masked, and a 24-slot delta buffer whose
    entries 0-8 copy query i (twice its length, so each beats every
    list row of its query) and gate on query i's slot i % 4 (entry 8 on
    its last slot), entry 9 a tombstoned slot (id -1) on query 9's
    first slot and 10-23 empty.  The dead lookup marks entry 0 and
    three ids of queries 1 and 2's running top-k."""
    k, chunk, b = 10, 4, 16
    q = torch.from_numpy(tiny_corpus.queries[:b])
    _, rank = centroid_rank(t_index, q, 1 + chunk)
    rank = rank.long()
    cids = rank[:, 1:]
    slot_ok = (torch.arange(chunk) < chunk - 1)[None, :] \
        & (torch.arange(b) % 4 != 3)[:, None]
    view = None
    if with_delta:
        vecs = torch.zeros(24, q.shape[1])
        ids = torch.full((24,), -1, dtype=torch.int32)
        assign = torch.full((24,), -1, dtype=torch.int32)
        for i in range(10):
            vecs[i] = 2.0 * q[i]
            ids[i] = -1 if i == 9 else 50_000 + i
            slot = 0 if i == 9 else chunk - 1 if i == 8 else i % chunk
            assign[i] = cids[i, slot]
        view = DeltaView(vecs, ids, assign)
    empty = (torch.full((b, k), float("-inf")),
             torch.full((b, k), -1, dtype=torch.int32))
    sc, ids0 = probe_candidates(t_index, q, rank[:, 0], use_kernel=False)
    run = merge_topk(*empty, sc, ids0, k)
    dead = None
    if with_dead:
        dead = torch.zeros(50_100, dtype=torch.bool)
        dead[50_000] = True
        dead[run[1][1, :2].long()] = True
        dead[run[1][2, 0].long()] = True
        run = scrub_dead(*run, dead)
        if view is not None:
            view = view.burn_dead(dead)
    return q, cids, slot_ok, run, view, dead, k, chunk


def _per_probe_chunk(t_index, q, cids, slot_ok, run, view, k, use_kernel):
    """The chunk one probe at a time: each probe's candidates merged
    where the slot is ok, the running top-k after every slot."""
    d_sc = None if view is None else (
        kops.delta_scan(q, view.vecs) if use_kernel
        else delta_scan_plain(q, view.vecs))
    ts, ti = run
    snaps = []
    for t in range(cids.shape[1]):
        sc, ids = probe_candidates(t_index, q, cids[:, t],
                                   use_kernel=use_kernel, delta=view,
                                   delta_scores=d_sc)
        ms, mi = merge_topk(ts, ti, sc, ids, k, use_kernel=use_kernel)
        ok = slot_ok[:, t, None]
        ts, ti = torch.where(ok, ms, ts), torch.where(ok, mi, ti)
        snaps.append((ts, ti))
    return (torch.stack([s for s, _ in snaps], 1),
            torch.stack([i for _, i in snaps], 1))


def _assert_same_topk(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(gi.numpy(), wi.numpy())
    gs, ws = gs.numpy(), ws.numpy()
    np.testing.assert_array_equal(np.isneginf(gs), np.isneginf(ws))
    np.testing.assert_allclose(np.nan_to_num(gs, neginf=0.0),
                               np.nan_to_num(ws, neginf=0.0), atol=1e-5)


@pytest.mark.parametrize("with_dead", [False, True],
                         ids=["no_dead", "dead"])
@pytest.mark.parametrize("with_delta", [False, True],
                         ids=["no_delta", "delta"])
def test_chunk_steps_hold_the_slot_conventions(t_index, tiny_corpus,
                                               with_delta, with_dead):
    """``scan_merge_chunk`` (the fused kernel) and ``probe_candidates``
    on the kernel pair give the plain per-probe path's top-k after every
    slot; a slot past the budget and a masked row merge nothing; a
    tombstoned buffer entry never enters."""
    q, cids, slot_ok, run, view, dead, k, chunk = _chunk_case(
        t_index, tiny_corpus, with_delta, with_dead)
    want = _per_probe_chunk(t_index, q, cids, slot_ok, run, view, k, False)
    pair = _per_probe_chunk(t_index, q, cids, slot_ok, run, view, k, True)
    snap_s, snap_i, cnts = scan_merge_chunk(t_index, q, cids, slot_ok, *run,
                                            view, k=k, chunk=chunk)
    _assert_same_topk(pair, want)
    _assert_same_topk((snap_s, snap_i), want)
    # the last slot is past the budget: it adds nothing to the one before
    _assert_same_topk((snap_s[:, -1], snap_i[:, -1]),
                      (snap_s[:, -2], snap_i[:, -2]))
    assert not cnts[:, -1].any()
    masked = ~slot_ok[:, 0]
    for t in range(chunk):
        _assert_same_topk((snap_s[masked, t], snap_i[masked, t]),
                          (run[0][masked], run[1][masked]))
    assert not cnts[masked].any()
    assert cnts[~masked, :-1].sum() > 0
    found = set(snap_i.flatten().tolist())
    if with_delta:
        # live entries gated on an ok slot of their own query enter it;
        # one gated past the budget, on a masked row or tombstoned
        # never does
        entered = {i for i in range(10)
                   if 50_000 + i in snap_i[i, -1].tolist()}
        assert entered == ({1, 2, 4, 5, 6} if with_dead
                           else {0, 1, 2, 4, 5, 6})
        assert not {50_003, 50_007, 50_008} & found
    if with_dead:
        assert 50_000 not in found
        gone = set(torch.nonzero(dead).flatten().tolist())
        assert not gone & set(snap_i[1:3].flatten().tolist())


def test_brute_force_and_intersection_match_reference(tiny_corpus):
    docs, q = tiny_corpus.docs, tiny_corpus.queries[:32]
    js, ji = j_brute_force(jnp.asarray(docs), jnp.asarray(q), 10)
    ts, ti = brute_force(torch.from_numpy(docs), torch.from_numpy(q), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    a = ji[:, ::-1]
    np.testing.assert_array_equal(
        intersection_pct(torch.from_numpy(np.array(ji)),
                         torch.from_numpy(np.array(a))).numpy(),
        np.asarray(j_intersection_pct(ji, a)))


def test_probe_trace_and_labels_match_reference(tiny_index, t_index,
                                                tiny_corpus, tiny_exact):
    q = tiny_corpus.queries[:16]
    j_traj, j_phi = j_probe_trace(tiny_index, jnp.asarray(q), 8, 10)
    t_traj, t_phi = probe_trace(t_index, q, 8, 10)
    np.testing.assert_array_equal(t_traj, j_traj)
    np.testing.assert_allclose(t_phi, j_phi, atol=1e-4)
    top1 = tiny_exact[1][:16, 0]
    np.testing.assert_array_equal(min_probes_labels(t_traj, top1, 8),
                                  j_min_probes_labels(j_traj, top1, 8))


def test_validate_alignment_rejects_misaligned_lists(t_index):
    bad = dataclasses.replace(t_index,
                              cluster_offsets=t_index.cluster_offsets + 1)
    with pytest.raises(ValueError, match="not blk_l=64"):
        validate_alignment(bad)
    with pytest.raises(ValueError, match="not a multiple"):
        validate_alignment(t_index, blk_l=48)
    with pytest.raises(ValueError, match="not blk_l"):
        search(bad, np.zeros((1, t_index.dim), np.float32),
               policies.fixed(4, k=10), use_fused_kernel=True)
