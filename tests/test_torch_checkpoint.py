"""Port parity for snapshot persistence
(``repro_torch.checkpoint.CheckpointManager``, ``IndexRegistry.save`` /
``restore``) against ``repro``'s.

A step written by either package reads back in the other: the same
``index.json`` keys (``jax.tree_util.keystr`` spellings, JAX's flatten
order), the same ``.npy`` bytes, and an index snapshot restores in the
other package with equal arrays, dtypes and ``meta``.  The actionable
``CheckpointError`` cases are the reference's
(tests/test_wal_recovery.py).

The gpu case runs on the card without JAX:
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_checkpoint.py``.
"""
import collections
import json
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import (CheckpointError,
                                            CheckpointManager, _leaf_paths,
                                            _treedef_str)
from repro_torch.core import build_index, index_from_arrays
from repro_torch.data.synthetic import clustered_corpus
from repro_torch.index import IndexRegistry, LiveIndex, version_of

from test_torch_wal import apply, index_arrays, script, state

Pair = collections.namedtuple("Pair", "left right")

TREES = {
    "dict": lambda: {"b": np.arange(3, dtype=np.int32),
                     "a": [np.ones(2, np.float32), np.zeros((2, 2), bool)]},
    "nested": lambda: {"x": (np.arange(4, dtype=np.int64),),
                       "y": {"q": np.float32(1.5) * np.ones(3, np.float32),
                             "p": None}},
    "list": lambda: [None, {"q": np.arange(5, dtype=np.int8)}],
    "namedtuple": lambda: Pair(np.arange(2, dtype=np.float32),
                               (np.arange(3, dtype=np.int32),)),
}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.core import build_index as jbuild
    from repro.index import IndexRegistry as JRegistry
    from repro.index import LiveIndex as JLive
    from repro.index import version_of as jversion_of
    return types.SimpleNamespace(
        jax=jax, CheckpointManager=JManager, build_index=jbuild,
        IndexRegistry=JRegistry, LiveIndex=JLive, version_of=jversion_of)


@pytest.mark.parametrize("name", sorted(TREES))
def test_keys_and_structure_are_jax_spellings(ref, name):
    tree = TREES[name]()
    flat = ref.jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [k for k, _ in _leaf_paths(tree)] \
        == [ref.jax.tree_util.keystr(kp) for kp, _ in flat]
    assert _treedef_str(tree) == str(ref.jax.tree_util.tree_structure(tree))


@pytest.mark.parametrize("name", sorted(TREES))
def test_a_step_is_byte_identical_and_reads_in_both(ref, tmp_path, name):
    """The same host tree saved by both packages: equal index.json and
    .npy files; each package restores the other's step into a
    template's structure."""
    tree = TREES[name]()
    mgrs = {"jax": ref.CheckpointManager(str(tmp_path / "jax"),
                                         async_save=False),
            "torch": CheckpointManager(str(tmp_path / "torch"))}
    for m in mgrs.values():
        m.save(4, tree)
    mgrs["torch"].wait()
    dirs = {p: tmp_path / p / "step_00000004" for p in mgrs}
    assert sorted(os.listdir(dirs["jax"])) == sorted(os.listdir(dirs["torch"]))
    for fn in os.listdir(dirs["jax"]):
        assert (dirs["jax"] / fn).read_bytes() \
            == (dirs["torch"] / fn).read_bytes(), fn
    want = [np.asarray(v) for _, v in _leaf_paths(tree)]
    # the port restores the reference's step, tensors in the template's
    # structure
    step, got = CheckpointManager(str(tmp_path / "jax")).restore(
        tree, device="cpu")
    assert step == 4 and type(got) is type(tree)
    for (_, g), w in zip(_leaf_paths(got), want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)
        assert g.numpy().dtype == w.dtype
    # and the reference restores the port's
    _, jgot = ref.CheckpointManager(str(tmp_path / "torch")).restore(tree)
    for g, w in zip(ref.jax.tree_util.tree_leaves(jgot), want):
        np.testing.assert_array_equal(np.asarray(g), w)
    _, arrs = mgrs["torch"].load_arrays()
    _, jarrs = mgrs["jax"].load_arrays()
    assert arrs.keys() == jarrs.keys()


def test_tensors_save_from_their_host_copy(tmp_path):
    """A tensor is copied to the host before the writer thread starts:
    writing into it after ``save`` returns changes nothing on disk."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = torch.arange(1 << 16, dtype=torch.float32)
    mgr.save(1, {"t": t})
    t.zero_()
    mgr.wait()
    _, arrs = mgr.load_arrays(1)
    np.testing.assert_array_equal(arrs["t"], np.arange(1 << 16,
                                                       dtype=np.float32))


def test_steps_keep_and_atomic_publish(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (3, 1, 7):
        mgr.save(s, {"a": np.full(2, s)})
    os.makedirs(tmp_path / "step_00000009.tmp")     # a torn write
    assert mgr.all_steps() == [3, 7] and mgr.latest_step() == 7
    _, arrs = mgr.load_arrays()
    np.testing.assert_array_equal(arrs["a"], [7, 7])
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"a": 0, "b": 1}, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).load_arrays()


# -- index snapshots across packages -----------------------------------------


@pytest.fixture(scope="module")
def live_pair(ref, tiny_corpus):
    """A reference and a port live index after the same mutation script
    (a merge, deletes of main and buffered docs, a non-empty buffer)."""
    docs = tiny_corpus.docs[:2000]
    jindex = ref.build_index(docs, 16, list_pad=256, n_iters=3, seed=0)
    j = ref.LiveIndex(jindex, delta_cap=256)
    t = LiveIndex(index_from_arrays(*index_arrays(jindex), device="cpu"),
                  delta_cap=256)
    for live in (j, t):
        added = []
        for op, payload in script(docs):
            apply(live, op, payload, added)
        live.epoch = 2
    return j, t


_DTYPES = {"centroids": np.float32, "docs": np.float32, "doc_ids": np.int32,
           "offsets": np.int32, "sizes": np.int32, "dvecs": np.float32,
           "dids": np.int32, "dassign": np.int32, "dead": np.bool_,
           "meta": np.int64}


def test_a_snapshot_is_byte_identical_across_packages(ref, live_pair,
                                                      tmp_path):
    j, t = live_pair
    ref.IndexRegistry(ref.version_of(j)).save(
        ref.CheckpointManager(str(tmp_path / "jax"), async_save=False))
    IndexRegistry(version_of(t)).save(
        CheckpointManager(str(tmp_path / "torch"), async_save=False))
    step = f"step_{t.seq:08d}"
    for fn in os.listdir(tmp_path / "jax" / step):
        assert (tmp_path / "jax" / step / fn).read_bytes() \
            == (tmp_path / "torch" / step / fn).read_bytes(), fn
    _, arrs = CheckpointManager(str(tmp_path / "torch")).load_arrays()
    assert {k: a.dtype for k, a in arrs.items()} \
        == {k: np.dtype(d) for k, d in _DTYPES.items()}
    np.testing.assert_array_equal(
        arrs["meta"], [256, t.seq, t.next_id, t.seq, t.version, 2])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_snapshot_restores_in_the_other_package(ref, live_pair, tmp_path,
                                                  writer):
    j, t = live_pair
    if writer == "jax":
        ref.IndexRegistry(ref.version_of(j)).save(
            ref.CheckpointManager(str(tmp_path), async_save=False))
        reg, ver = IndexRegistry.restore(CheckpointManager(str(tmp_path)),
                                         device="cpu")
        assert reg.current() is ver
        # device-side dtypes the kernels check
        for x, dt in ((ver.index.docs, torch.float32),
                      (ver.index.doc_ids, torch.int32),
                      (ver.index.cluster_offsets, torch.int32),
                      (ver.index.cluster_sizes, torch.int32),
                      (ver.delta.ids, torch.int32),
                      (ver.delta.assign, torch.int32),
                      (ver.dead, torch.bool)):
            assert x.dtype == dt
        got = LiveIndex.from_version(ver)
        assert (ver.version, ver.seq, ver.merges, ver.epoch) \
            == (j.seq, j.seq, j.version, 2)
        assert_state = state(got), state(j)
    else:
        IndexRegistry(version_of(t)).save(
            CheckpointManager(str(tmp_path), async_save=False))
        _, ver = ref.IndexRegistry.restore(
            ref.CheckpointManager(str(tmp_path)))
        got = ref.LiveIndex.from_version(ver)
        assert_state = state(got), state(t)
    for name, want in assert_state[1].items():
        np.testing.assert_array_equal(assert_state[0][name], want,
                                      err_msg=name)


# -- actionable errors ---------------------------------------------------------


def test_missing_index_json_actionable(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    (tmp_path / "step_00000007").mkdir()
    with pytest.raises(CheckpointError, match="index.json"):
        mgr.load_arrays(7)


def test_missing_step_dir_actionable(tmp_path):
    with pytest.raises(CheckpointError, match="does not exist"):
        CheckpointManager(str(tmp_path)).load_arrays(5)


def test_truncated_index_json_actionable(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    step_dir = tmp_path / "step_00000003"
    step_dir.mkdir()
    (step_dir / "index.json").write_text('{"step": 3, "keys": [')
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        mgr.load_arrays(3)
    (step_dir / "index.json").write_text(json.dumps({"step": 3}))
    with pytest.raises(CheckpointError, match="missing required field"):
        mgr.load_arrays(3)


def test_truncated_array_actionable(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, {"a": np.arange(1000, dtype=np.float32)})
    arr = tmp_path / "step_00000005" / "arr_00000.npy"
    arr.write_bytes(arr.read_bytes()[:40])        # truncate the file
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        mgr.load_arrays(5)
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        mgr.restore({"a": np.zeros(1000, np.float32)}, step=5, device="cpu")


def test_missing_array_file_actionable(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, {"a": np.arange(8)})
    os.remove(tmp_path / "step_00000002" / "arr_00000.npy")
    with pytest.raises(CheckpointError, match="missing array file"):
        mgr.load_arrays(2)


def test_inconsistent_shape_actionable(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, {"a": np.arange(8)})
    np.save(tmp_path / "step_00000002" / "arr_00000.npy", np.arange(3))
    with pytest.raises(CheckpointError, match="internally inconsistent"):
        mgr.load_arrays(2)


def test_registry_restore_wrong_schema_actionable(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"weights": np.zeros(4)})         # not an index snapshot
    with pytest.raises(CheckpointError, match="IndexRegistry.save"):
        IndexRegistry.restore(mgr, device="cpu")


# -- on the card ----------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_snapshot_restores_onto_the_card(tmp_path):
    """A snapshot of a live index on the card restores there with the
    dtypes the kernels check, equal to the state it was saved from."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    c = clustered_corpus(n_docs=2000, dim=24, n_components=16,
                         n_queries=8, seed=7)
    live = LiveIndex(build_index(c.docs, 16, list_pad=256, n_iters=3,
                                 device="cuda"), delta_cap=256)
    added = []
    for op, payload in script(c.docs):
        apply(live, op, payload, added)
    mgr = CheckpointManager(str(tmp_path))
    IndexRegistry(version_of(live)).save(mgr)
    _, ver = IndexRegistry.restore(mgr)
    assert ver.index.docs.device.type == "cuda"
    assert ver.index.doc_ids.dtype == torch.int32 \
        and ver.dead.dtype == torch.bool
    got = LiveIndex.from_version(ver)
    for name, want in state(live).items():
        np.testing.assert_array_equal(state(got)[name], want, err_msg=name)
