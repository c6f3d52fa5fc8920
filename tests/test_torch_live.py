"""Port parity for the live index: ``LiveIndex``, live ``search`` on
every path, ``version_from_arrays`` and registry-versioned serving,
against ``repro``'s on the same numpy inputs and mutation scripts.

The reference side runs per-probe only: its fused path does not trace
under this JAX (ROADMAP Queue 3, R1).  Across packages ids, probe
counts and every int or bool array are equal, scores agree within 1e-5
and phi history within 1e-4.  Inside the port, live search on every
path equals search over ``rebuild_equivalent()`` bit for bit.  The
learned cascades with a delta view are held against the reference in
tests/test_torch_policies.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import policies as jpol
from repro.core import search as jsearch
from repro.core.serving import WaveScheduler as JWaveScheduler
from repro.index import IndexRegistry as JIndexRegistry
from repro.index import LiveIndex as JLiveIndex
from repro.index import version_of as j_version_of
from repro_torch.core import brute_force, index_from_arrays, policies, \
    search
from repro_torch.core.serving import WaveScheduler
from repro_torch.index import (IndexRegistry, LiveIndex, version_from_arrays,
                               version_of)
from repro_torch.launch import serve


def T(x):
    """A tensor copy of a host array (reference arrays are read-only)."""
    return torch.from_numpy(np.array(x))


def _index_arrays(ix):
    return [np.asarray(getattr(ix, f)) for f in
            ("centroids", "docs", "doc_ids", "cluster_offsets",
             "cluster_sizes")] + [ix.list_pad]


def _port_index(jax_index):
    return index_from_arrays(*_index_arrays(jax_index), device="cpu")


def _assert_same_state(t, j, what=""):
    """Every array and counter of two live indexes equal."""
    for g, w in zip(_index_arrays(t.index), _index_arrays(j.index)):
        np.testing.assert_array_equal(g, w, err_msg=what)
    for name in ("vecs", "ids", "assign"):
        np.testing.assert_array_equal(getattr(t.delta, name).numpy(),
                                      getattr(j.delta, name),
                                      err_msg=f"{what} delta.{name}")
    np.testing.assert_array_equal(t.tombs.dead_ids(), j.tombs.dead_ids(),
                                  err_msg=what)
    for name in ("next_id", "version", "seq", "n_live"):
        assert getattr(t, name) == getattr(j, name), (what, name)
    assert t.delta.count == j.delta.count, what
    assert t.tombs.count == j.tombs.count, what


def _both(j, t, method, *args):
    got = getattr(t, method)(*args)
    want = getattr(j, method)(*args)
    if method in ("add", "merge_delta"):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    return want


def _mutate(j, t, tiny_corpus):
    """The burst of the reference's ``mutated`` fixture: adds, deletes
    of main docs, deletes of buffered docs."""
    rng = np.random.default_rng(11)
    new = tiny_corpus.docs[rng.choice(len(tiny_corpus.docs), 160,
                                      replace=False)]
    new = new + rng.normal(scale=0.05, size=new.shape).astype(np.float32)
    added = _both(j, t, "add", new)
    _both(j, t, "delete", rng.choice(8000, 120, replace=False))
    _both(j, t, "delete", added[::5])
    return added


@pytest.fixture(scope="module")
def mutated(tiny_index, tiny_corpus):
    j = JLiveIndex(tiny_index, delta_cap=512)
    t = LiveIndex(_port_index(tiny_index), delta_cap=512)
    _mutate(j, t, tiny_corpus)
    return j, t


def test_live_index_follows_the_reference_over_a_mutation_script(
        tiny_index, tiny_corpus):
    """Adds; deletes of main and buffered docs; double delete; delete
    then re-add across a merge; a merge that spills: the same state as
    the reference after every step."""
    j = JLiveIndex(tiny_index, delta_cap=512)
    t = LiveIndex(_port_index(tiny_index), delta_cap=512)
    _assert_same_state(t, j, "start")
    added = _mutate(j, t, tiny_corpus)
    _assert_same_state(t, j, "burst")
    _both(j, t, "delete", [int(added[0]), 5, 5])       # double delete
    _both(j, t, "delete", 5)
    _assert_same_state(t, j, "double delete")
    vec = tiny_corpus.docs[100:101] + np.float32(0.01)
    (old_id,) = _both(j, t, "add", vec)
    _both(j, t, "delete", old_id)
    _both(j, t, "merge_delta")
    _assert_same_state(t, j, "merge")
    (new_id,) = _both(j, t, "add", vec)
    assert new_id > old_id and old_id in t.tombs and new_id not in t.tombs
    _assert_same_state(t, j, "re-add")
    c0 = np.asarray(tiny_index.centroids)[0]
    crowd = (c0[None, :] + np.random.default_rng(3).normal(
        scale=1e-3, size=(300, c0.size))).astype(np.float32)
    _both(j, t, "add", crowd)
    _both(j, t, "merge_delta")
    assert len(t.delta) > 0                             # it spilled
    _assert_same_state(t, j, "spilling merge")
    with pytest.raises(ValueError, match="never allocated"):
        t.delete(10 ** 6)
    vecs, ids = t.net_corpus()
    jvecs, jids = j.net_corpus()
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(vecs.numpy(), jvecs)


def _policies(name):
    if name == "patience":
        return (jpol.patience(24, delta=2, phi=90.0, k=10, tau=3),
                policies.patience(24, delta=2, phi=90.0, k=10, tau=3))
    return jpol.fixed(12, k=10, tau=3), policies.fixed(12, k=10, tau=3)


_PATHS = {
    "per_probe": {},
    "pair": dict(use_scan_kernel=True, use_topk_kernel=True),
    "fused_c4": dict(use_fused_kernel=True, chunk=4),
}


@pytest.fixture(scope="module")
def reference_runs(mutated, tiny_corpus):
    q = jnp.asarray(tiny_corpus.queries[:64])
    return {name: mutated[0].search(q, _policies(name)[0])
            for name in ("patience", "fixed")}


def _assert_matches_reference(res, base):
    np.testing.assert_array_equal(res.topk_ids.numpy(),
                                  np.asarray(base.topk_ids))
    np.testing.assert_array_equal(res.probes.numpy(), np.asarray(base.probes))
    got, want = res.topk_scores.numpy(), np.asarray(base.topk_scores)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(np.nan_to_num(got, neginf=0.0),
                               np.nan_to_num(want, neginf=0.0), atol=1e-5)
    np.testing.assert_allclose(res.phi_hist.numpy(),
                               np.asarray(base.phi_hist), atol=1e-4)


def _assert_bit_equal(a, b):
    for name in ("topk_ids", "probes", "topk_scores", "phi_hist"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("path", sorted(_PATHS))
@pytest.mark.parametrize("policy_name", ["patience", "fixed"])
def test_live_search_matches_reference(mutated, tiny_corpus, reference_runs,
                                       policy_name, path):
    res = mutated[1].search(tiny_corpus.queries[:64],
                            _policies(policy_name)[1], **_PATHS[path])
    _assert_matches_reference(res, reference_runs[policy_name])


@pytest.mark.parametrize("path", sorted(_PATHS))
@pytest.mark.parametrize("policy_name", ["patience", "fixed"])
def test_live_search_equals_rebuilt_index(mutated, tiny_corpus, policy_name,
                                          path):
    live = mutated[1]
    pol = _policies(policy_name)[1]
    q = tiny_corpus.queries[:64]
    _assert_bit_equal(live.search(q, pol, **_PATHS[path]),
                      search(live.rebuild_equivalent(), q, pol,
                             **_PATHS[path]))


def test_full_probe_equals_brute_force_over_net_corpus(mutated, tiny_corpus):
    live = mutated[1]
    q = T(tiny_corpus.queries[:32])
    res = live.search(q, policies.fixed(live.index.n_clusters, k=10, tau=3),
                      use_fused_kernel=True, chunk=8)
    vecs, ids = live.net_corpus()
    _, rows = brute_force(vecs, q, 10)
    np.testing.assert_array_equal(res.topk_ids.numpy(), ids[rows.numpy()])


def test_merge_delta_preserves_results_and_spills_stay_searchable(
        tiny_index, tiny_corpus):
    live = LiveIndex(_port_index(tiny_index), delta_cap=512)
    _mutate(JLiveIndex(tiny_index, delta_cap=512), live, tiny_corpus)
    q = tiny_corpus.queries[:48]
    pol = policies.patience(24, delta=2, phi=90.0, k=10, tau=3)
    before = live.search(q, pol, use_fused_kernel=True, chunk=4)
    n_live = live.n_live
    assert live.merge_delta() == 1 and len(live.delta) == 0
    assert live.n_live == n_live
    _assert_bit_equal(live.search(q, pol, use_fused_kernel=True, chunk=4),
                      before)
    c0 = live.index.centroids[0].numpy()
    live.add((c0[None, :] + np.random.default_rng(3).normal(
        scale=1e-3, size=(300, c0.size))).astype(np.float32))
    live.merge_delta()
    assert len(live.delta) > 0
    fixed = policies.fixed(12, k=10, tau=3)
    for kw in _PATHS.values():
        _assert_bit_equal(live.search(q, fixed, **kw),
                          search(live.rebuild_equivalent(), q, fixed, **kw))


def test_version_from_arrays_carries_a_reference_version(mutated,
                                                         tiny_corpus):
    jver = j_version_of(mutated[0])
    ver = version_from_arrays(
        *_index_arrays(jver.index), *(np.asarray(x) for x in jver.delta),
        np.asarray(jver.dead), jver.next_id, jver.seq, jver.merges,
        jver.epoch, device="cpu")
    assert ver.version == jver.version and ver.index.list_pad == 256
    jpat, pol = _policies("patience")
    q = tiny_corpus.queries[:64]
    want = jsearch(jver.index, jnp.asarray(q), jpat, delta=jver.delta)
    for kw in _PATHS.values():
        _assert_matches_reference(search(ver.index, q, pol, delta=ver.delta,
                                         **kw), want)
    back = LiveIndex.from_version(ver)
    _assert_same_state(back, mutated[0], "from_version")


# -- registry-versioned serving ------------------------------------------------

_CFG = dict(wave_size=32, chunk=4, k=10, n_probe=24, delta=3, phi=90.0)


class _Stream:
    """One precomputed mutation stream fed to both schedulers: after
    wave w add 8 noisy doc copies, delete 2 earlier adds, merge every
    4th wave, optionally publish a higher epoch from ``epoch_at`` on."""

    def __init__(self, docs, next_id, epoch_at=None):
        self.docs, self.next_id, self.epoch_at = docs, next_id, epoch_at
        self.rng = np.random.default_rng(9)
        self.added, self.ops = [], {}

    def at(self, wave):
        if wave not in self.ops:
            new = (self.docs[self.rng.integers(0, 8000, 8)]
                   + self.rng.normal(scale=0.05, size=(8, 24))
                   ).astype(np.float32)
            self.added += range(self.next_id, self.next_id + 8)
            self.next_id += 8
            doomed = [self.added.pop(self.rng.integers(len(self.added)))
                      for _ in range(2)]
            self.ops[wave] = (new, doomed, wave % 4 == 0)
        return self.ops[wave]

    def replay(self):
        """A stream that repeats this one's operations."""
        other = _Stream(self.docs, 0, self.epoch_at)
        other.ops = dict(self.ops)
        return other

    def hook(self, live, reg, vof):
        def mutate(wave):
            new, doomed, merge = self.at(wave)
            live.add(new)
            live.delete(doomed)
            if merge:
                live.merge_delta()
            if self.epoch_at is not None and wave >= self.epoch_at:
                live.epoch = 1
            reg.publish(vof(live))
        return mutate


def _live_pair(tiny_index, tiny_corpus):
    j = JLiveIndex(tiny_index, delta_cap=512)
    t = LiveIndex(_port_index(tiny_index), delta_cap=512)
    rng = np.random.default_rng(5)
    _both(j, t, "add", tiny_corpus.docs[:32] + rng.normal(
        scale=1e-4, size=(32, 24)).astype(np.float32))
    _both(j, t, "delete", rng.choice(8000, 16, replace=False))
    return j, t


def _reference_serve(tiny_index, tiny_corpus, epoch_at):
    j, _ = _live_pair(tiny_index, tiny_corpus)
    stream = _Stream(tiny_corpus.docs, j.next_id, epoch_at)
    reg = JIndexRegistry(j_version_of(j))
    ws = JWaveScheduler(tiny_index, use_fused=False, registry=reg, **_CFG)
    rep = ws.serve(tiny_corpus.queries[:100],
                   on_wave=stream.hook(j, reg, j_version_of))
    return rep, reg.swaps, stream


@pytest.fixture(scope="module")
def reference_live_serve(tiny_index, tiny_corpus):
    return _reference_serve(tiny_index, tiny_corpus, None)


@pytest.fixture(scope="module")
def reference_epoch_serve(tiny_index, tiny_corpus):
    return _reference_serve(tiny_index, tiny_corpus, 3)


def _port_serve(tiny_index, tiny_corpus, ref_stream, use_fused):
    _, t = _live_pair(tiny_index, tiny_corpus)
    stream = ref_stream.replay()
    reg = IndexRegistry(version_of(t))
    ws = WaveScheduler(t.index, use_fused=use_fused, registry=reg, **_CFG)
    rep = ws.serve(tiny_corpus.queries[:100],
                   on_wave=stream.hook(t, reg, version_of))
    return rep, reg.swaps


def _assert_same_serve(rep, swaps, ref):
    want, want_swaps, _ = ref
    assert sorted(rep.results) == list(range(100))
    for qid in range(100):
        np.testing.assert_array_equal(rep.results[qid], want.results[qid],
                                      err_msg=f"query {qid}")
        assert rep.probes[qid] == want.probes[qid], qid
    assert rep.waves == want.waves
    assert swaps == want_swaps
    assert (rep.epoch_swaps, rep.drain_waves) == (want.epoch_swaps,
                                                  want.drain_waves)


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "per_probe"])
def test_live_serve_matches_reference(tiny_index, tiny_corpus,
                                      reference_live_serve, use_fused):
    rep, swaps = _port_serve(tiny_index, tiny_corpus,
                             reference_live_serve[2], use_fused)
    _assert_same_serve(rep, swaps, reference_live_serve)
    assert swaps > 1 and rep.epoch_swaps == 0


@pytest.mark.parametrize("use_fused", [True, False],
                         ids=["fused", "per_probe"])
def test_epoch_swap_drains_as_the_reference(tiny_index, tiny_corpus,
                                            reference_epoch_serve,
                                            use_fused):
    rep, swaps = _port_serve(tiny_index, tiny_corpus,
                             reference_epoch_serve[2], use_fused)
    _assert_same_serve(rep, swaps, reference_epoch_serve)
    assert rep.epoch_swaps == 1 and rep.drain_waves > 0


def test_live_index_names_its_device(tiny_index):
    live = LiveIndex(_port_index(tiny_index), delta_cap=128)
    assert live.delta.vecs.device.type == "cpu"
    with pytest.raises(ValueError, match="lies on meta"):
        live.add(torch.zeros(2, 24, device="meta"))
    view = live.delta_view()
    bad = view._replace(ids=view.ids.to("meta"))
    with pytest.raises(ValueError, match="delta view lies on meta"):
        search(live.index, np.zeros((1, 24), np.float32),
               policies.fixed(4, k=10), delta=bad)


def test_serve_cli_prints_the_live_row(capsys):
    out = serve.main(["--device", "cpu", "--n-docs", "4000", "--dim", "24",
                      "--clusters", "32", "--queries", "64", "--n-probe",
                      "16", "--k", "10", "--delta", "3", "--wave-size", "32",
                      "--mutation-rate", "8", "--merge-every", "4",
                      "--delta-cap", "256"])
    assert "'mode': 'live'" in capsys.readouterr().out
    assert out["adds"] > 0 and out["deletes"] > 0 and out["merges"] > 0
    assert out["swaps"] > 1 and out["versions"] >= 1
    assert out["recall_gap"] <= 0.01
