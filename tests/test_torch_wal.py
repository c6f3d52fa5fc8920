"""Port parity for the mutation WAL and crash recovery
(``repro_torch.index.wal``, ``LiveIndex(wal=)``,
``IndexRegistry.save/restore/recover``) against ``repro``'s.

One mutation script writes byte-identical WAL files from both packages,
and a log (or a snapshot + log) written by either package replays in
the other to the same state.  A port index recovered after a crash at
any mutation boundary equals the uncrashed port index bit for bit on
every search path, and JAX's recovered index: every array and counter
equal, ids and probe counts equal, phi within 1e-5 (the reference side
runs per-probe only: its fused path does not trace under this JAX,
ROADMAP Queue 3, R1).  The error paths are the reference's
(tests/test_wal_recovery.py).

The gpu case runs on the card without JAX:
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_wal.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import build_index, index_from_arrays, policies
from repro_torch.data.synthetic import clustered_corpus
from repro_torch.index import (IndexRegistry, LiveIndex, MutationWAL,
                               WALCorruptError, version_of)
from repro_torch.index.wal import OP_ADD, OP_DELETE

PATHS = {"per_probe": {},
         "pair": dict(use_scan_kernel=True, use_topk_kernel=True),
         "fused": dict(use_fused_kernel=True, chunk=4)}


@pytest.fixture(scope="module")
def ref():
    """The reference's durability modules (JAX on the CPU)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.core import build_index as jbuild
    from repro.core import policies as jpol
    from repro.index import IndexRegistry as JRegistry
    from repro.index import LiveIndex as JLive
    from repro.index import MutationWAL as JWAL
    from repro.index import version_of as jversion_of
    return types.SimpleNamespace(
        jnp=jnp, CheckpointManager=JManager, build_index=jbuild,
        policies=jpol, IndexRegistry=JRegistry, LiveIndex=JLive,
        MutationWAL=JWAL, version_of=jversion_of)


def index_arrays(ix):
    return [_np(getattr(ix, f)) for f in
            ("centroids", "docs", "doc_ids", "cluster_offsets",
             "cluster_sizes")] + [ix.list_pad]


@pytest.fixture(scope="module")
def small(ref, tiny_corpus):
    """The reference tests' substrate: 2,000 docs in 16 clusters, the
    reference index and its port copy."""
    docs = tiny_corpus.docs[:2000]
    jindex = ref.build_index(docs, 16, list_pad=256, n_iters=3, seed=0)
    return types.SimpleNamespace(
        docs=docs, queries=tiny_corpus.queries[:32],
        queries_long=tiny_corpus.queries[:96], jindex=jindex,
        tindex=index_from_arrays(*index_arrays(jindex), device="cpu"))


def script(docs, n_adds=5):
    """The reference tests' mutation script: (op, payload) tuples."""
    rng = np.random.default_rng(42)
    ops = []
    for j in range(n_adds):
        vecs = (docs[rng.integers(0, 2000, 6)]
                + rng.normal(scale=0.03, size=(6, docs.shape[1]))
                ).astype(np.float32)
        ops.append(("add", vecs))
        if j == 1:
            ops.append(("delete_main", rng.integers(0, 2000, 4)))
        if j == 2:
            ops.append(("merge", None))
        if j == 3:
            ops.append(("delete_added", 2))   # delete 2 recent adds
    return ops


def apply(live, op, payload, added):
    if op == "add":
        added.extend(int(i) for i in live.add(payload))
    elif op == "delete_main":
        live.delete(payload)
    elif op == "delete_added":
        doomed = added[-payload:]
        live.delete(doomed)
        del added[-payload:]
    else:
        live.merge_delta()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def state(live):
    """Every array and counter of a live index of either package."""
    out = dict(zip(("centroids", "docs", "doc_ids", "offsets", "sizes",
                    "list_pad"), index_arrays(live.index)))
    out.update(dvecs=_np(live.delta.vecs), dids=_np(live.delta.ids),
               dassign=_np(live.delta.assign), dead=live.tombs.dead_ids(),
               dcount=live.delta.count, tcount=live.tombs.count,
               **{n: getattr(live, n) for n in
                  ("next_id", "version", "seq", "epoch", "n_live")})
    return out


def assert_same_state(a, b, what="", centroid_atol=0.0):
    sa, sb = state(a), state(b)
    for name in sa:
        if name == "centroids" and centroid_atol:
            np.testing.assert_allclose(sa[name], sb[name], rtol=0,
                                       atol=centroid_atol, err_msg=what)
        else:
            np.testing.assert_array_equal(sa[name], sb[name],
                                          err_msg=f"{what} {name}")


def results(live, queries, **kw):
    pol = policies.patience(16, delta=2, phi=90.0, k=10, tau=3)
    r = live.search(torch.as_tensor(queries, device=live.device), pol, **kw)
    return r.topk_ids.cpu().numpy(), r.probes.cpu().numpy(), \
        r.phi_hist.cpu().numpy()


def ref_results(ref, jlive, queries):
    pol = ref.policies.patience(16, delta=2, phi=90.0, k=10, tau=3)
    r = jlive.search(ref.jnp.asarray(queries), pol)
    return (np.asarray(r.topk_ids), np.asarray(r.probes),
            np.asarray(r.phi_hist))


def assert_bit_same(a, b, queries):
    """Two port live indexes answer alike, bit for bit, on every path."""
    for kw in PATHS.values():
        for got, want in zip(results(a, queries, **kw),
                             results(b, queries, **kw)):
            np.testing.assert_array_equal(got, want)


def assert_matches_ref(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)


def _package(ref, name):
    if name == "jax":
        return (ref.LiveIndex, ref.MutationWAL, ref.CheckpointManager,
                ref.IndexRegistry, ref.version_of)
    return LiveIndex, MutationWAL, CheckpointManager, IndexRegistry, \
        version_of


def _write(ref, small, pkg, workdir, ops, **wal_kw):
    """Run ``ops`` on a package's live index with a WAL and a base
    snapshot under ``workdir``; returns the live index and the ids its
    adds allocated (less those the script deleted)."""
    live_cls, wal_cls, mgr_cls, reg_cls, vof = _package(ref, pkg)
    workdir.mkdir()
    wal = wal_cls(str(workdir / "wal.log"), **wal_kw)
    index = small.jindex if pkg == "jax" else small.tindex
    live = live_cls(index, delta_cap=256, wal=wal)
    reg_cls(vof(live)).save(mgr_cls(str(workdir / "snaps"),
                                    async_save=False))
    added = []
    for op, payload in ops:
        apply(live, op, payload, added)
    wal.close()
    return live, added


@pytest.mark.parametrize("group_commit_n", [1, 4])
def test_one_script_writes_the_same_wal_bytes(ref, small, tmp_path,
                                              group_commit_n):
    ops = script(small.docs)
    for pkg in ("jax", "torch"):
        _write(ref, small, pkg, tmp_path / pkg, ops,
               group_commit_n=group_commit_n)
    got = (tmp_path / "torch" / "wal.log").read_bytes()
    want = (tmp_path / "jax" / "wal.log").read_bytes()
    assert len(got) > 5 * 6 * 24 * 4 and got == want   # five adds


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_wal_replays_in_the_other_package(ref, small, tmp_path, writer):
    """The log of either package replays onto the other's base index to
    the writer's state; the snapshot + log recover in the other package
    to the same state, with the same replay report."""
    reader = "torch" if writer == "jax" else "jax"
    written, _ = _write(ref, small, writer, tmp_path / writer,
                        script(small.docs))
    live_cls, wal_cls, mgr_cls, reg_cls, _ = _package(ref, reader)
    index = small.jindex if reader == "jax" else small.tindex
    fresh = live_cls(index, delta_cap=256)
    wal = wal_cls(str(tmp_path / writer / "wal.log"))
    rep = wal.replay_into(fresh)
    assert rep.applied == written.seq and not rep.torn_tail
    assert_same_state(fresh, written, f"{writer} log replayed by {reader}")
    kw = {} if reader == "jax" else {"device": "cpu"}
    _, recovered, rep2 = reg_cls.recover(
        mgr_cls(str(tmp_path / writer / "snaps"), async_save=False), wal,
        **kw)
    assert rep2.applied == written.seq
    assert_same_state(recovered, written, f"{writer} recovered by {reader}")
    wal.close()


def test_kill_and_replay_every_boundary(ref, small, tmp_path):
    """A crash at every mutation boundary: the port's recovered index
    equals the uncrashed port index bit for bit on every path (and
    after the rest of the script runs on it), and JAX's recovered index
    (every array and counter; ids, probes and phi of a search)."""
    ops = script(small.docs)
    oracle, added_o = LiveIndex(small.tindex, delta_cap=256), []
    joracle, jadded = ref.LiveIndex(small.jindex, delta_cap=256), []
    for op, payload in ops:
        apply(oracle, op, payload, added_o)
        apply(joracle, op, payload, jadded)
    want_ref = ref_results(ref, joracle, small.queries)
    for crash_at in range(len(ops) + 1):
        recovered = {}
        for pkg in ("jax", "torch"):
            live, added = _write(ref, small, pkg,
                                 tmp_path / f"{pkg}_{crash_at}",
                                 ops[:crash_at])
            del live                                  # the process died
            _, _, mgr_cls, reg_cls, _ = _package(ref, pkg)
            wdir = tmp_path / f"{pkg}_{crash_at}"
            wal = _package(ref, pkg)[1](str(wdir / "wal.log"))
            kw = {} if pkg == "jax" else {"device": "cpu"}
            _, rec, rep = reg_cls.recover(
                mgr_cls(str(wdir / "snaps"), async_save=False), wal, **kw)
            assert rep.applied == crash_at
            recovered[pkg] = (rec, wal)
        t, j = recovered["torch"][0], recovered["jax"][0]
        assert_same_state(t, j, f"recovered at boundary {crash_at}")
        for op, payload in ops[crash_at:]:
            apply(t, op, payload, added)
        assert_same_state(t, oracle, f"finished after boundary {crash_at}")
        assert_bit_same(t, oracle, small.queries)
        assert_matches_ref(results(t, small.queries), want_ref)
        for _, wal in recovered.values():
            wal.close()


def test_recovery_from_mid_stream_snapshot(ref, small, tmp_path):
    """Snapshot part-way + WAL truncation: replay resumes past it, in
    the port as in the reference."""
    ops = script(small.docs)
    out = {}
    for pkg in ("jax", "torch"):
        live_cls, wal_cls, mgr_cls, reg_cls, vof = _package(ref, pkg)
        wal = wal_cls(str(tmp_path / f"{pkg}.log"))
        live = live_cls(small.jindex if pkg == "jax" else small.tindex,
                        delta_cap=256, wal=wal)
        mgr = mgr_cls(str(tmp_path / f"{pkg}_snaps"), async_save=False)
        reg_cls(vof(live)).save(mgr)
        added = []
        for op, payload in ops[:4]:
            apply(live, op, payload, added)
        reg_cls(vof(live)).save(mgr)
        assert wal.truncate_upto(live.seq) == 0       # snapshot covers it
        for op, payload in ops[4:]:
            apply(live, op, payload, added)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        _, recovered, rep = reg_cls.recover(mgr, wal, **kw)
        assert rep.applied == len(ops) - 4 and rep.skipped == 0
        assert_same_state(recovered, live, pkg)
        out[pkg] = (live, recovered)
        wal.close()
    assert_bit_same(out["torch"][1], out["torch"][0], small.queries)
    assert_same_state(out["torch"][1], out["jax"][1], "port vs reference")
    assert_matches_ref(results(out["torch"][1], small.queries),
                       ref_results(ref, out["jax"][1], small.queries))


def _torch_wal_setup(small, tmp_path, **wal_kw):
    path = str(tmp_path / "wal.log")
    wal = MutationWAL(path, **wal_kw)
    live = LiveIndex(small.tindex, delta_cap=256, wal=wal)
    mgr = CheckpointManager(str(tmp_path / "snaps"), async_save=False)
    IndexRegistry(version_of(live)).save(mgr)
    return path, wal, live, mgr


def test_torn_tail_is_tolerated(small, tmp_path):
    path, wal, live, mgr = _torn(small, tmp_path, {}, 2, 7)
    wal2 = MutationWAL(path)
    _, recovered, rep = IndexRegistry.recover(mgr, wal2, device="cpu")
    assert rep.torn_tail and rep.applied == 1 and recovered.seq == 1
    wal2.close()


def _torn(small, tmp_path, wal_kw, n_adds, cut):
    path, wal, live, mgr = _torch_wal_setup(small, tmp_path, **wal_kw)
    for j in range(n_adds):
        live.add(small.docs[4 * j: 4 * j + 4])
    wal.close()
    with open(path, "rb") as f:
        full = f.read()
    with open(path, "wb") as f:               # tear the last record
        f.write(full[:-cut])
    return path, wal, live, mgr


def test_mid_file_corruption_raises(small, tmp_path):
    path = str(tmp_path / "wal.log")
    wal = MutationWAL(path)
    live = LiveIndex(small.tindex, delta_cap=256, wal=wal)
    live.add(small.docs[:4])
    live.add(small.docs[4:8])
    wal.close()
    with open(path, "r+b") as f:              # flip payload bytes of
        f.seek(30)                            # the FIRST record
        f.write(b"\xff\xff\xff")
    wal2 = MutationWAL(path)
    with pytest.raises(WALCorruptError, match="(CRC|corrupt)"):
        wal2.scan()
    wal2.close()


def test_sequence_gap_raises(small, tmp_path):
    wal = MutationWAL(str(tmp_path / "wal.log"))
    wal.append(OP_ADD, 1, small.docs[:2])
    wal.append(OP_DELETE, 3, np.asarray([0]))     # gap: seq 2 missing
    live = LiveIndex(small.tindex, delta_cap=256)
    with pytest.raises(WALCorruptError, match="sequence gap"):
        wal.replay_into(live)
    wal.close()


def test_wal_rejects_foreign_file(tmp_path):
    path = str(tmp_path / "notawal.bin")
    with open(path, "wb") as f:
        f.write(b"definitely not a WAL file")
    with pytest.raises(WALCorruptError, match="magic"):
        MutationWAL(path)


def test_a_logged_add_is_validated_first(small, tmp_path):
    """A full buffer, an id never allocated or a tensor on another
    device raise before anything is logged."""
    wal = MutationWAL(str(tmp_path / "wal.log"))
    live = LiveIndex(small.tindex, delta_cap=128, wal=wal)
    with pytest.raises(RuntimeError, match="delta buffer full"):
        live.add(small.docs[:129])
    with pytest.raises(ValueError, match="never allocated"):
        live.delete([10 ** 6])
    with pytest.raises(ValueError, match="lies on meta"):
        live.add(torch.zeros(2, 24, device="meta"))
    assert wal.scan() == [] and live.seq == 0
    wal.close()


def test_group_commit_batches_fsyncs(small, tmp_path):
    """group_commit_n batches appends into one fsync; merge boundaries
    and close() force the batch; recovery is still bit-identical."""
    path, wal, live, mgr = _torch_wal_setup(small, tmp_path,
                                            group_commit_n=4)
    base = wal.fsyncs
    for j in range(3):                        # 3 pending, below n=4
        live.add(small.docs[4 * j: 4 * j + 4])
    assert wal.fsyncs == base and wal._pending == 3
    live.add(small.docs[12:16])               # 4th append: batch lands
    assert wal.fsyncs == base + 1 and wal._pending == 0
    live.add(small.docs[16:20])               # 1 pending again
    live.merge_delta()                        # boundary: forced fsync
    assert wal.fsyncs == base + 2 and wal._pending == 0
    live.delete([0, 1])                       # pending at close
    wal.close()                               # close flushes the batch
    wal2 = MutationWAL(path)
    _, recovered, rep = IndexRegistry.recover(mgr, wal2, device="cpu")
    assert rep.applied == 7 and not rep.torn_tail
    assert_same_state(recovered, live)
    assert_bit_same(recovered, live, small.queries)
    wal2.close()


def test_group_commit_ms_window_expires(small, tmp_path):
    t = [0.0]
    wal = MutationWAL(str(tmp_path / "wal.log"), group_commit_n=100,
                      group_commit_ms=50.0, clock=lambda: t[0])
    base = wal.fsyncs
    wal.append(OP_ADD, 1, small.docs[:2])
    assert wal.fsyncs == base and wal._pending == 1
    t[0] = 0.010                              # 10ms: still inside window
    wal.append(OP_ADD, 2, small.docs[2:4])
    assert wal.fsyncs == base and wal._pending == 2
    t[0] = 0.060                              # 60ms > 50ms window
    wal.append(OP_ADD, 3, small.docs[4:6])
    assert wal.fsyncs == base + 1 and wal._pending == 0
    wal.close()


def test_group_commit_torn_tail_semantics_unchanged(small, tmp_path):
    path, wal, live, mgr = _torn(small, tmp_path, {"group_commit_n": 8},
                                 3, 9)
    wal2 = MutationWAL(path)
    _, recovered, rep = IndexRegistry.recover(mgr, wal2, device="cpu")
    assert rep.torn_tail and rep.applied == 2 and recovered.seq == 2
    wal2.close()


def test_group_commit_scan_sees_pending_records(small, tmp_path):
    wal = MutationWAL(str(tmp_path / "wal.log"), group_commit_n=16)
    wal.append(OP_ADD, 1, small.docs[:2])
    wal.append(OP_DELETE, 2, np.asarray([0]))
    assert wal._pending == 2
    assert [r.seq for r in wal.scan()] == [1, 2]
    wal.flush()
    assert wal._pending == 0
    wal.close()


def test_truncate_clamped_to_durable_snapshot(small, tmp_path):
    """An over-eager compactor asking to cut the whole log keeps every
    record the durable snapshot does not cover."""
    ops = script(small.docs)
    wal = MutationWAL(str(tmp_path / "wal.log"))
    live = LiveIndex(small.tindex, delta_cap=256, wal=wal)
    mgr = CheckpointManager(str(tmp_path / "snaps"), async_save=False)
    added = []
    for op, payload in ops[:4]:
        apply(live, op, payload, added)
    IndexRegistry(version_of(live)).save(mgr)
    wal.note_durable(live.seq)
    durable_seq = live.seq
    for op, payload in ops[4:]:
        apply(live, op, payload, added)
    kept = wal.truncate_upto(live.seq)
    assert kept == live.seq - durable_seq
    assert [r.seq for r in wal.scan()] \
        == list(range(durable_seq + 1, live.seq + 1))
    _, recovered, rep = IndexRegistry.recover(mgr, wal, device="cpu")
    assert rep.applied == live.seq - durable_seq
    assert_bit_same(recovered, live, small.queries)
    wal.close()


def test_truncate_respects_open_epoch_fence(small, tmp_path):
    """Compaction while a rebuild epoch is open is clamped to the fence
    and keeps the fence records; a crash then aborts the epoch and
    loses nothing; once closed, the fences compact away."""
    from repro_torch.index import Rebuilder
    from repro_torch.index.wal import EPOCH_OPS
    ops = script(small.docs)
    wal = MutationWAL(str(tmp_path / "wal.log"))
    live = LiveIndex(small.tindex, delta_cap=256, wal=wal)
    mgr = CheckpointManager(str(tmp_path / "snaps"), async_save=False)
    IndexRegistry(version_of(live)).save(mgr)
    wal.note_durable(live.seq)
    added = []
    for op, payload in ops[:4]:
        apply(live, op, payload, added)
    rb = Rebuilder(live, n_iters=2)           # no manager: stays open
    rb.request("compact-race")
    rb.tick()                                 # begin: fence at seq=4
    fence_seq = live.seq
    for op, payload in ops[4:]:
        apply(live, op, payload, added)
    IndexRegistry(version_of(live)).save(mgr)
    wal.note_durable(live.seq)
    wal.truncate_upto(live.seq)
    recs = wal.scan()
    assert [r.seq for r in recs if r.op not in EPOCH_OPS] \
        == list(range(fence_seq + 1, live.seq + 1))
    assert wal.open_epoch_fences(recs) == [fence_seq]
    _, recovered, rep = IndexRegistry.recover(mgr, wal, device="cpu")
    assert rep.rebuild_aborted
    assert_bit_same(recovered, live, small.queries)
    wal.note_durable(live.seq)
    assert wal.truncate_upto(live.seq) == 0
    assert wal.scan() == []
    wal.close()


# -- on the card ----------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_wal_and_recovery_match_the_cpu(tmp_path):
    """A live index on the card logs the bytes a CPU one logs (its add
    payloads are device tensors here) and recovers on the card to the
    CPU's state and answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    c = clustered_corpus(n_docs=2000, dim=24, n_components=16,
                         n_queries=32, seed=7)
    cpu_index = build_index(c.docs, 16, list_pad=256, n_iters=3,
                            device="cpu")
    ops = script(c.docs)
    lives = {}
    for dev in ("cpu", "cuda"):
        index = cpu_index if dev == "cpu" else index_from_arrays(
            *index_arrays(cpu_index), device=dev)
        wdir = tmp_path / dev
        wdir.mkdir()
        wal = MutationWAL(str(wdir / "wal.log"))
        live = LiveIndex(index, delta_cap=256, wal=wal)
        IndexRegistry(version_of(live)).save(
            CheckpointManager(str(wdir / "snaps"), async_save=False))
        added = []
        for op, payload in ops:
            if op == "add" and dev == "cuda":
                payload = torch.as_tensor(payload, device=dev)
            apply(live, op, payload, added)
        wal.close()
        lives[dev] = live
    assert (tmp_path / "cpu" / "wal.log").read_bytes() \
        == (tmp_path / "cuda" / "wal.log").read_bytes()
    wal = MutationWAL(str(tmp_path / "cuda" / "wal.log"))
    _, rec, _ = IndexRegistry.recover(
        CheckpointManager(str(tmp_path / "cuda" / "snaps")), wal,
        device="cuda")
    assert rec.index.docs.device.type == "cuda"
    assert_same_state(rec, lives["cuda"])
    assert_same_state(rec, lives["cpu"])
    for kw in PATHS.values():
        assert_bit_same(rec, lives["cuda"], c.queries)
        # the kernels sum in another order than the plain versions
        assert_matches_ref(results(rec, c.queries, **kw),
                           results(lives["cpu"], c.queries, **kw))
    wal.close()
