"""Port parity for wave serving: the port's ``WaveScheduler`` (fused and
per-probe) against the reference ``WaveScheduler(use_fused=False)`` on
the same index, query by query.  (The reference's fused path does not
trace under this JAX: ROADMAP Queue 3, R1.)  A scheduler that serves a
registry frees the index it was built on once a merge replaces it."""
import dataclasses
import gc

import numpy as np
import pytest
from torch.multiprocessing.reductions import StorageWeakRef

from repro.core.serving import WaveScheduler as JWaveScheduler
from repro_torch.core import index_from_arrays
from repro_torch.core.serving import WaveScheduler
from repro_torch.index import IndexRegistry, LiveIndex, version_of

_CFG = dict(wave_size=32, chunk=4, k=10, n_probe=24, delta=3, phi=90.0)


@pytest.fixture(scope="module")
def t_index(tiny_index):
    return index_from_arrays(
        np.asarray(tiny_index.centroids), np.asarray(tiny_index.docs),
        np.asarray(tiny_index.doc_ids),
        np.asarray(tiny_index.cluster_offsets),
        np.asarray(tiny_index.cluster_sizes), tiny_index.list_pad,
        device="cpu")


@pytest.fixture(scope="module")
def reference_report(tiny_index, tiny_corpus):
    ws = JWaveScheduler(tiny_index, use_fused=False, **_CFG)
    return ws.serve(tiny_corpus.queries[:100])


@pytest.mark.parametrize("use_fused", [True, False])
def test_wave_scheduler_matches_reference(t_index, tiny_corpus,
                                          reference_report, use_fused):
    rep = WaveScheduler(t_index, use_fused=use_fused, **_CFG).serve(
        tiny_corpus.queries[:100])
    assert sorted(rep.results) == list(range(100))
    for qid in range(100):
        np.testing.assert_array_equal(rep.results[qid],
                                      reference_report.results[qid],
                                      err_msg=f"query {qid}")
        assert rep.probes[qid] == reference_report.probes[qid], qid
    assert rep.waves == reference_report.waves
    assert rep.lane_steps == reference_report.lane_steps
    assert rep.occupancy == pytest.approx(reference_report.occupancy)


def test_compaction_improves_occupancy(t_index, tiny_corpus):
    ws = WaveScheduler(t_index, **_CFG)
    with_c = ws.serve(tiny_corpus.queries[:128], compact=True)
    without = ws.serve(tiny_corpus.queries[:128], compact=False)
    assert with_c.occupancy > without.occupancy
    assert with_c.lane_steps <= without.lane_steps
    for qid in range(128):
        np.testing.assert_array_equal(with_c.results[qid],
                                      without.results[qid])


def test_registry_scheduler_keeps_no_construction_index(t_index,
                                                        tiny_corpus):
    """Built on a registry, the scheduler holds no reference to its
    construction index: once a merge is published and one wave served,
    nothing of the program holds the base documents' storage."""
    live = LiveIndex(dataclasses.replace(t_index, docs=t_index.docs.clone()),
                     delta_cap=256)
    base = StorageWeakRef(live.index.docs.untyped_storage())
    reg = IndexRegistry(version_of(live))
    ws = WaveScheduler(live.index, registry=reg, **_CFG)
    merged_at = []

    def hook(wave):
        if not merged_at:
            live.add(tiny_corpus.docs[:8] + np.float32(0.01))
            live.merge_delta()
            merged_at.append(wave)
        reg.publish(version_of(live))

    rep = ws.serve(tiny_corpus.queries[:100], on_wave=hook)
    assert merged_at == [1] and rep.waves >= 2
    gc.collect()
    assert base.expired()
