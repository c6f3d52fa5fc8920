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
from repro_torch.core.ivf import (_probe_tiles, intersection_pct,
                                  min_probes_labels, probe_trace)


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
