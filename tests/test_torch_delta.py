"""Port parity for the live index's building blocks: the plain
``delta_scan``, ``DeltaBuffer``, ``Tombstones``, ``assign_clusters``,
``relayout`` and the version registry, against ``repro``'s, on the same
numpy inputs.

The reference kernels run in Pallas interpret mode here.  Scores agree
within 1e-5 (f32 sums in another order); every array the reference
keeps as ints or bools, and every vector that is only moved, must be
equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.index import DeltaBuffer as JDeltaBuffer
from repro.index import DeltaFull as JDeltaFull
from repro.index import IndexRegistry as JIndexRegistry
from repro.index import LiveIndex as JLiveIndex
from repro.index import Tombstones as JTombstones
from repro.index import assign_clusters as j_assign_clusters
from repro.index import relayout as j_relayout
from repro.index import version_of as j_version_of
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import index_from_arrays
from repro_torch.index import (DeltaBuffer, DeltaFull, IndexRegistry,
                               IndexVersion, LiveIndex, StaleEpochError,
                               Tombstones, assign_clusters, relayout,
                               version_of)
from repro_torch.kernels import delta_scan as t_ds
from repro_torch.kernels import ops as tops


def T(x):
    """A tensor copy of a host array (reference arrays are read-only)."""
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("b,cap,d", [(5, 130, 24), (1, 7, 16), (9, 300, 33)])
def test_delta_scan_plain_matches_reference(b, cap, d):
    rng = np.random.default_rng(b * cap + d)
    q = rng.normal(size=(b, d)).astype(np.float32)
    v = rng.normal(size=(cap, d)).astype(np.float32)
    got = tops.delta_scan(T(q), T(v)).numpy()
    assert got.shape == (b, cap)
    np.testing.assert_allclose(
        got, np.asarray(jops.delta_scan(jnp.asarray(q), jnp.asarray(v))),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jref.delta_scan_ref(jnp.asarray(q), jnp.asarray(v))),
        atol=1e-5, rtol=0)
    # each slot scores what score_rows gives its row alone
    one = t_ds.delta_scan_plain(T(q), T(v[3 % cap:3 % cap + 1])).numpy()
    np.testing.assert_array_equal(one[:, 0], got[:, 3 % cap])


def test_assign_clusters_matches_reference(tiny_index, tiny_corpus):
    cents = np.asarray(tiny_index.centroids)
    vecs = tiny_corpus.docs[:500] + np.float32(0.01)
    got = assign_clusters(T(vecs), T(cents))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  j_assign_clusters(vecs, cents))


def _buffer_state(buf):
    vecs, ids, assign = (np.asarray(x) for x in (buf.vecs, buf.ids,
                                                  buf.assign))
    return vecs, ids, assign, buf.count, len(buf), buf.live_slots()


def test_delta_buffer_matches_reference(tiny_corpus):
    """One add/delete/compact_keep script on both buffers: every array
    equal after every step, DeltaFull raised at the same call, and the
    view a copy that later mutations do not reach."""
    rng = np.random.default_rng(4)
    d = tiny_corpus.docs.shape[1]
    jb = JDeltaBuffer(d, 200)
    tb = DeltaBuffer(d, 200, device="cpu")
    assert tb.capacity == jb.capacity == 256
    next_id = 1000
    view = None
    for step in range(12):
        op = ("add", "delete", "add", "compact")[step % 4]
        if op == "add":
            m = int(rng.integers(10, 60))
            vecs = tiny_corpus.docs[rng.integers(0, 8000, m)]
            ids = np.arange(next_id, next_id + m, dtype=np.int32)
            assign = rng.integers(0, 64, m).astype(np.int32)
            raised = []
            for buf, full in ((jb, JDeltaFull), (tb, DeltaFull)):
                try:
                    buf.add(vecs, ids, assign)
                    raised.append(False)
                except full as e:
                    assert "merge_delta" in str(e)
                    raised.append(True)
            assert raised[0] == raised[1], step
            if not raised[0]:
                next_id += m
        elif op == "delete":
            for i in list(rng.integers(900, next_id + 5, 12)):
                assert jb.delete(int(i)) == tb.delete(int(i)), i
        else:
            keep = jb.live_slots()[::2]
            jb.compact_keep(keep)
            tb.compact_keep(keep)
        for g, w in zip(_buffer_state(tb), _buffer_state(jb)):
            np.testing.assert_array_equal(g, w, err_msg=f"step {step}")
        assert tb.occupancy() == jb.occupancy()
        if view is not None:
            np.testing.assert_array_equal(view.ids.numpy(), view_ids)
        view = tb.view()
        view_ids = view.ids.numpy().copy()
        assert tb.view() is view                  # cached until mutated
        np.testing.assert_array_equal(view.vecs.numpy(), np.asarray(jb.vecs))


def test_tombstones_match_reference():
    jt, tt = JTombstones(5000), Tombstones(5000, device="cpu")
    for ids in ([3, 3, 17], [4095, 4096], [9000]):
        for t in (jt, tt):
            t.ensure_capacity(max(ids) + 1)
            t.add(ids)
        np.testing.assert_array_equal(tt.dead_ids(), jt.dead_ids())
        assert tt.count == jt.count
        look = tt.lookup()
        assert look.dtype == torch.bool and look.device.type == "cpu"
        np.testing.assert_array_equal(look.numpy(), np.asarray(jt.lookup()))
    assert all((i in tt) == (i in jt) for i in (3, 4, 9000, -1, 10 ** 7))
    before = tt.lookup()
    tt.add([5])
    assert not bool(before[5]) and bool(tt.lookup()[5])   # a copy


def _index_arrays(ix):
    return [np.asarray(getattr(ix, f)) for f in
            ("centroids", "docs", "doc_ids", "cluster_offsets",
             "cluster_sizes")] + [ix.list_pad]


@pytest.mark.parametrize("round_total_to", [None, 4096])
def test_relayout_matches_reference(tiny_index, tiny_corpus, round_total_to):
    rng = np.random.default_rng(6)
    cents = np.asarray(tiny_index.centroids)
    vecs = tiny_corpus.docs[:3000]
    ids = rng.permutation(10 ** 6)[:3000].astype(np.int32)
    assign = j_assign_clusters(vecs, cents)
    want = j_relayout(vecs, ids, assign, cents, list_pad=256,
                      round_total_to=round_total_to)
    got = relayout(vecs, ids, assign, T(cents), list_pad=256,
                   round_total_to=round_total_to)
    for g, w in zip(_index_arrays(got), _index_arrays(want)):
        np.testing.assert_array_equal(g, w)
    if round_total_to:
        assert got.docs.shape[0] % round_total_to == 0


def test_relayout_rejects_overfull_cluster(tiny_corpus):
    vecs = tiny_corpus.docs[:300]
    with pytest.raises(ValueError, match="list_pad"):
        relayout(vecs, np.arange(300, dtype=np.int32),
                 np.zeros(300, np.int32), np.zeros((4, 24), np.float32),
                 list_pad=256, device="cpu")
    with pytest.raises(ValueError, match="multiple of align"):
        relayout(vecs, np.arange(300, dtype=np.int32),
                 np.zeros(300, np.int32), np.zeros((4, 24), np.float32),
                 list_pad=100, device="cpu")


@pytest.fixture(scope="module")
def t_index(tiny_index):
    return index_from_arrays(*_index_arrays(tiny_index), device="cpu")


def test_registry_bumps_versions_as_the_reference(tiny_index, t_index):
    jl, tl = JLiveIndex(tiny_index), LiveIndex(t_index)
    jreg = JIndexRegistry(j_version_of(jl, version=3))
    treg = IndexRegistry(version_of(tl, version=3))
    for reg, vof, live in ((jreg, j_version_of, jl),
                           (treg, version_of, tl)):
        reg.publish(vof(live, version=1))           # stale: bumped
    assert treg.current().version == jreg.current().version == 4
    assert treg.swaps == jreg.swaps == 2


def test_registry_fences_stale_epochs(t_index):
    live = LiveIndex(t_index)
    reg = IndexRegistry(version_of(live))
    live.epoch = 1
    reg.publish(version_of(live))
    assert reg.current().epoch == 1
    live.epoch = 0
    with pytest.raises(StaleEpochError, match="epoch 0"):
        reg.publish(version_of(live))
    with pytest.raises(RuntimeError, match="no published version"):
        IndexRegistry().current()


def test_version_refuses_mixed_devices(t_index):
    ver = version_of(LiveIndex(t_index))
    with pytest.raises(ValueError, match="lies on meta"):
        IndexVersion(1, ver.index, ver.delta,
                     torch.zeros(8, dtype=torch.bool, device="meta"), 0)
