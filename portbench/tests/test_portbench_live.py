"""The live path on the CPU: the live reference against the frozen one,
the admission replay against the scheduler, and the stream's log."""
import numpy as np
import pytest
import torch

from portbench import corpus, judge, mutations, spec
from portbench.reference import ivf_live, ivf_patience

from conftest import TINY, TINY_LIVE


def _search(c, cfg, q, **kw):
    return ivf_patience.search(
        q, c.docs, c.doc_ids, c.offsets, c.sizes, c.centroids, k=cfg["k"],
        n_probe=cfg["n_probe"], delta=cfg["patience_delta"],
        phi=cfg["patience_phi"], list_pad=cfg["list_pad"], **kw)


def _live(c, cfg, q, admit, ov, **kw):
    return ivf_live.search(
        q, admit, c.docs, c.doc_ids, c.offsets, c.sizes, c.centroids, ov,
        k=cfg["k"], n_probe=cfg["n_probe"], delta=cfg["patience_delta"],
        phi=cfg["patience_phi"], list_pad=cfg["list_pad"],
        chunk=cfg["chunk"], **kw)


def _no_mutation(c):
    return ivf_live.Overlay(torch.zeros(0, c.centroids.shape[1]),
                            torch.zeros(0, dtype=torch.int64),
                            torch.full((c.n_docs,), ivf_live.NEVER),
                            c.n_docs)


@pytest.mark.parametrize("tf32", [False, True])
def test_empty_log_is_the_frozen_reference_bit_for_bit(tf32):
    c = corpus.make(TINY, 96, 2**31 + 11, "cpu")
    admit = torch.arange(96) % 7
    want = _search(c, TINY, c.pool, tf32=tf32)
    got = _live(c, TINY_LIVE, c.pool, admit, _no_mutation(c), tf32=tf32)
    for f in ("order", "probes", "ids", "scores"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _overlay(c, g, n_add, deletes, waves):
    """Adds near random centres, each added at a wave of ``waves``, and
    ``deletes`` ids of base or added documents deleted at waves too."""
    lists = torch.randint(c.centroids.shape[0], (n_add,), generator=g)
    vecs = c.centroids[lists] + 0.02 * torch.randn(n_add, c.centroids.shape[1],
                                                   generator=g)
    vecs /= vecs.norm(dim=1, keepdim=True)
    added = torch.randint(waves, (n_add,), generator=g)
    deleted = torch.full((c.n_docs + n_add,), ivf_live.NEVER)
    gone = torch.randperm(c.n_docs + n_add, generator=g)[:deletes]
    deleted[gone] = torch.randint(waves, (deletes,), generator=g)
    return ivf_live.Overlay(vecs, added, deleted, c.n_docs)


def _net_corpus(c, cfg, ov):
    """The live documents laid out afresh: each list's surviving base
    rows, then its surviving adds in id order."""
    lists = ivf_live.assign(ov.vecs, c.centroids)[0]
    n_lists, d = c.centroids.shape
    rows_of = []
    for lst in range(n_lists):
        o, s = int(c.offsets[lst]), int(c.sizes[lst])
        base = [int(i) for i in c.doc_ids[o:o + s]
                if ov.deleted[int(i)] == ivf_live.NEVER]
        adds = [c.n_docs + int(j) for j in torch.nonzero(lists == lst)[:, 0]
                if ov.deleted[c.n_docs + int(j)] == ivf_live.NEVER]
        rows_of.append(base + adds)
    pad = -(-max(len(r) for r in rows_of) // 64) * 64
    docs = torch.zeros(n_lists * pad + pad, d)
    ids = torch.full((n_lists * pad + pad,), -1, dtype=torch.int32)
    vec_of = torch.cat([c.docs[c.id_rows], ov.vecs])
    for lst, r in enumerate(rows_of):
        docs[lst * pad:lst * pad + len(r)] = vec_of[r]
        ids[lst * pad:lst * pad + len(r)] = torch.tensor(r, dtype=torch.int32)
    sizes = torch.tensor([len(r) for r in rows_of], dtype=torch.int32)
    offsets = torch.arange(n_lists, dtype=torch.int32) * pad
    return corpus.Corpus(c.centroids, docs, ids, offsets, sizes, pad,
                         None, c.pool), pad


def test_mutations_before_admission_equal_a_rebuilt_corpus():
    """Every add and delete published before the queries are admitted:
    the live reference is the frozen one over the net corpus."""
    c = corpus.make(TINY, 128, 2**31 + 12, "cpu")
    g = torch.Generator().manual_seed(3)
    ov = _overlay(c, g, 400, 900, 5)
    net, pad = _net_corpus(c, TINY, ov)
    want = _search(net, dict(TINY, list_pad=pad), c.pool)
    got = _live(c, TINY_LIVE, c.pool, torch.full((128,), 5), ov)
    assert torch.equal(got.order, want.order)
    assert torch.equal(got.probes, want.probes)
    assert torch.equal(got.ids, want.ids)
    torch.testing.assert_close(got.scores, want.scores, rtol=0, atol=1e-12)
    # and mutations after the last probe's wave change nothing
    later = ivf_live.Overlay(ov.vecs, ov.added + 100,
                             torch.where(ov.deleted < ivf_live.NEVER,
                                         ov.deleted + 100, ov.deleted),
                             c.n_docs)
    frozen = _search(c, TINY, c.pool)
    assert torch.equal(_live(c, TINY_LIVE, c.pool, torch.zeros(
        128, dtype=torch.int64), later).ids, frozen.ids)


def test_scrub_at_the_top_of_each_wave():
    """A document deleted after the wave that merged it leaves the
    running top-k at the next wave's top: chunk 1, deleted after wave 0,
    it is gone from probe 1 on and never comes back."""
    c = corpus.make(TINY, 8, 2**31 + 13, "cpu")
    cfg = dict(TINY_LIVE, chunk=1)
    first = _search(c, TINY, c.pool)
    top = first.ids[:, 0, 0]                      # best of probe 0
    ov = _no_mutation(c)
    ov.deleted[top] = 0
    got = _live(c, cfg, c.pool, torch.zeros(8, dtype=torch.int64), ov)
    assert torch.equal(got.ids[:, 0], first.ids[:, 0])
    for r in range(8):
        assert not (got.ids[r, 1:] == top[r]).any()


def test_replay_by_hand():
    """Two lanes, chunk 2: q0 (3 probes) holds waves 1-2, q1 (1) wave 1,
    q2 (5) waves 2-4, q3 (2) waves 3; the call ends after wave 4."""
    admit, waves = judge.replay(np.array([3, 1, 5, 2]), 2, 2)
    assert admit.tolist() == [1, 1, 2, 3] and waves == 4
    assert judge.replay(np.zeros(0, np.int64), 2, 2)[1] == 0


@pytest.mark.parametrize("wave_size,chunk", [(16, 4), (8, 1), (5, 3)])
def test_replayed_waves_equal_the_scheduler_s(wave_size, chunk):
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.core.serving import WaveScheduler
    c = corpus.make(TINY, 200, 2**31 + 14, "cpu")
    index = IVFIndex(c.centroids, c.docs, c.doc_ids, c.offsets, c.sizes,
                     c.list_pad)
    sched = WaveScheduler(index, wave_size=wave_size, chunk=chunk,
                          k=TINY["k"], n_probe=TINY["n_probe"],
                          delta=TINY["patience_delta"],
                          phi=TINY["patience_phi"])
    for n in (1, 37, 200):
        rep = sched.serve(c.pool[:n])
        probes = np.array([rep.probes[j] for j in range(n)])
        assert judge.replay(probes, wave_size, chunk)[1] == rep.waves


def _stream(seed, waves):
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.index.live import LiveIndex
    from repro_torch.index.registry import IndexRegistry, version_of
    c = corpus.make(TINY, 64, 2**31 + 15, "cpu")
    live = LiveIndex(IVFIndex(c.centroids, c.docs, c.doc_ids, c.offsets,
                              c.sizes, c.list_pad), delta_cap=128)
    reg = IndexRegistry(version_of(live))
    mix = {"mutations": {"adds_per_wave": 5, "deletes_per_wave": 6,
                         "plants_per_wave": 2}}
    st = mutations.Stream(live, reg, version_of, c, TINY_LIVE, mix, seed)
    st.begin_call()
    for w in range(1, waves + 1):
        st(w)
    return c, live, reg, st


def test_same_seed_same_log():
    """The log and the vectors it regenerates depend on the seed alone,
    and the vectors are the ones the live index was given."""
    c, live, reg, a = _stream(2**31 + 21, 20)
    b = _stream(2**31 + 21, 20)[3]
    other = _stream(2**31 + 22, 20)[3]
    assert a.log.first_id == b.log.first_id
    assert all(np.array_equal(x, y) for x, y in zip(a.log.deleted,
                                                    b.log.deleted))
    assert a.log.merges == b.log.merges == [8, 16]
    assert not all(np.array_equal(x, y) for x, y in zip(a.log.deleted,
                                                        other.log.deleted))
    assert a.calls[0]["adds"] == 100 and a.calls[0]["plants"] == 40
    assert reg.current().seq == live.seq
    ov, plant_id, plant_row = mutations.overlay(a.log, c.centroids,
                                                c.scale, c.pool)
    assert torch.equal(ov.vecs, mutations.overlay(
        b.log, c.centroids, c.scale, c.pool)[0].vecs)
    assert ov.vecs.shape == (140, TINY["dim"])
    vecs, ids = live.net_corpus()
    added = ids >= c.n_docs
    assert added.sum() > 0
    assert torch.equal(vecs[torch.as_tensor(added)],
                       ov.vecs[torch.as_tensor(ids[added] - c.n_docs)])
    # the deletes the log holds are the ids the live index lost
    gone = np.concatenate(a.log.deleted)
    assert not np.isin(gone, ids).any()
    assert ((ov.deleted < ivf_live.NEVER).sum()) == gone.size
    # each plant is its pool query plus noise of norm PLANT_NOISE
    q = c.pool[plant_row]
    assert torch.allclose(ov.vecs[plant_id - c.n_docs], q, atol=2e-3)


def test_live_rules_are_found():
    cfg = dict(TINY_LIVE, live={"delta_cap": 0, "merge_every": -1},
               check=dict(TINY_LIVE["check"], limits=TINY["check"]["limits"]))
    mix = {"mutations": {"adds_per_wave": 1.5, "deletes_per_wave": -1,
                         "plants_per_wave": True}}
    found = " ".join(spec.live_problems("c", cfg, mix))
    for want in ("adds_per_wave", "deletes_per_wave", "plants_per_wave",
                 "without a source", "delta_cap", "merge_every",
                 "deleted_returned", "acked_add_missed",
                 "schedule_mismatch"):
        assert want in found, want
    assert "without a live block" in " ".join(spec.live_problems(
        "c", TINY, mix))
    assert "without mutations" in " ".join(spec.live_problems(
        "c", TINY_LIVE, {}))
    assert spec.live_problems("c", TINY_LIVE, {"mutations": {
        "adds_per_wave": 1, "deletes_per_wave": 0, "plants_per_wave": 2,
        "source": "s"}}) == []
