"""Port parity for the seeded chaos harness (``repro_torch.runtime.chaos``)
and the ``--chaos`` CLI against ``repro.runtime.chaos``.

``ChaosMonkey`` draws the reference's sequences; ``run_chaos`` on the
CPU meets the assertions of ``make chaos-smoke`` and the resilience part
of ``make bench-smoke``; its deadline curve equals the reference sweep's
row for row and its shard drill the reference's field for field.  The
reference's fused path does not trace under this JAX (ROADMAP Queue 3,
R1), so its sweep runs ``WaveScheduler(use_fused=False)`` and its crash
drill searches per-probe only; the port's drills run as they ship.
JAX is imported in the ``ref`` fixture only.
"""
import functools
import json
import types

import numpy as np
import pytest
import torch

from repro_torch.core import brute_force, index_from_arrays
from repro_torch.core.distributed_ivf import ShardFault
from repro_torch.launch import serve
from repro_torch.runtime import chaos
from repro_torch.runtime.chaos import ChaosConfig, ChaosMonkey

from test_torch_wal import index_arrays

CFG = ChaosConfig(seed=1, mutation_steps=8, adds_per_step=6, crash_every=3,
                  snapshot_every=4, shard_fault_rate=0.4)
DEADLINES = [2.0, 10.0]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores (their spin-waits then cost
    more than the ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference's chaos harness (JAX on the CPU)."""
    pytest.importorskip("jax")
    import repro.core.serving as j_serving
    import repro.runtime.chaos as j_chaos
    from repro.core.distributed_ivf import ShardFault as JShardFault
    from repro.index import LiveIndex as JLive
    return types.SimpleNamespace(chaos=j_chaos, serving=j_serving,
                                 LiveIndex=JLive, ShardFault=JShardFault)


@pytest.fixture(scope="module")
def setup(tiny_index, tiny_corpus):
    queries = tiny_corpus.queries[:32]
    exact = brute_force(torch.as_tensor(tiny_corpus.docs),
                        torch.as_tensor(queries), 10)[1].numpy()
    t_index = index_from_arrays(*index_arrays(tiny_index), device="cpu")
    return types.SimpleNamespace(jindex=tiny_index, tindex=t_index,
                                 docs=tiny_corpus.docs, queries=queries,
                                 exact=exact)


@pytest.fixture(scope="module")
def payload(setup, tmp_path_factory):
    return chaos.run_chaos(setup.tindex, setup.docs, setup.queries,
                           setup.exact, CFG,
                           str(tmp_path_factory.mktemp("chaos")), k=10,
                           n_probe=16, deadlines_ms=DEADLINES)


def _faults(monkey, fault_cls, n=40):
    """Which of ``n`` shard dispatches the monkey fails."""
    out = []
    for i in range(n):
        try:
            monkey.shard_fault(i % 4, i // 4)
            out.append(False)
        except fault_cls:
            out.append(True)
    return out


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_chaos_monkey_sequences_match_reference(ref, seed):
    cfg = ChaosConfig(seed=seed, spike_rate=0.3, shard_fault_rate=0.4)
    a, b = ChaosMonkey(cfg), ref.chaos.ChaosMonkey(
        ref.chaos.ChaosConfig(**vars(cfg)))
    assert [a.wave_ms() for _ in range(50)] == [b.wave_ms() for _ in
                                                range(50)]
    for _ in range(7):
        a.tick_wave(0)
        b.tick_wave(0)
    assert a.clock() == b.clock() and a.spikes == b.spikes
    assert _faults(a, ShardFault) == _faults(b, ref.ShardFault)
    assert a.shard_faults == b.shard_faults


def test_chaos_config_and_mutation_stream_match_reference(ref, setup):
    assert vars(CFG) == vars(ref.chaos.ChaosConfig(**vars(CFG)))
    got = chaos._mutation_stream(CFG, setup.docs)
    want = ref.chaos._mutation_stream(CFG, setup.docs)
    assert [op for op, _ in got] == [op for op, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def check_chaos_smoke(d):
    """The assertions of ``make chaos-smoke`` on an artifact."""
    assert d["recovery"]["bit_identical"], "recovery not bit-identical"
    assert d["recovery"]["crashes"] > 0, "no crashes injected"
    assert len(d["deadline_curve"]) > 0, "empty deadline curve"
    assert d["shard_faults"]["attempts"] > 0, "shard drill did not run"
    rb = d["rebuild"]
    bs = rb["crash_boundaries"]
    assert len(bs) == 6, "rebuild boundaries missing"
    assert all(b["bit_identical"] for b in bs)
    assert {"aborted", "committed"} == {b["resolution"] for b in bs}
    sr = rb["swap_race"]
    assert sr["fenced"] and sr["lost_mutations"] == 0 \
        and sr["recovered_bit_identical"], "swap race not fenced"
    dr = rb["drift"]
    assert dr["rebuilds_triggered"] > 0 and dr["recall_restored"]


def check_bench_smoke_resilience(d):
    """The resilience part of ``make bench-smoke`` on an artifact."""
    rb = d["rebuild"]
    assert {"crash_boundaries", "swap_race", "drift"} <= rb.keys()
    assert all({"failpoint", "resolution", "bit_identical",
                "recovery_ms"} <= b.keys() for b in rb["crash_boundaries"])
    assert {"fenced", "lost_mutations", "recovered_bit_identical"} \
        <= rb["swap_race"].keys()
    assert {"recall_fixed", "recall_rebuilt", "rebuilds_triggered",
            "recall_restored"} <= rb["drift"].keys()


def test_run_chaos_end_to_end_meets_the_smoke_gates(payload):
    check_chaos_smoke(payload)
    check_bench_smoke_resilience(payload)
    rec = payload["recovery"]
    assert rec["replayed_records"] > 0
    curve = payload["deadline_curve"]
    assert len(curve) == len(DEADLINES) + 1
    assert curve[-1]["deadline_ms"] is None
    assert curve[-1]["degraded_fraction"] == 0.0
    assert all(0.0 <= row["recall"] <= 1.0 for row in curve)
    assert payload["shard_faults"]["attempts"] >= CFG.n_shards
    assert json.loads(json.dumps(payload)) == payload


def test_deadline_curve_matches_reference(ref, setup, payload,
                                          monkeypatch):
    monkeypatch.setattr(ref.serving, "WaveScheduler", functools.partial(
        ref.serving.WaveScheduler, use_fused=False))
    want = ref.chaos.run_deadline_sweep(
        setup.jindex, setup.queries, setup.exact,
        ref.chaos.ChaosConfig(**vars(CFG)), DEADLINES, k=10, n_probe=16)
    assert payload["deadline_curve"] == want


def test_shard_drill_matches_reference(ref, setup, payload):
    want = ref.chaos.run_shard_drill(setup.jindex, setup.queries,
                                     setup.exact,
                                     ref.chaos.ChaosConfig(**vars(CFG)),
                                     k=10, n_probe=16)
    assert payload["shard_faults"] == want


def test_crash_drill_counts_match_reference(ref, setup, payload, tmp_path,
                                            monkeypatch):
    """The reference's own drill over the same stream, its live searches
    per-probe only: the same crashes, mutations, replayed records, final
    sequence number and verdict."""
    search = ref.LiveIndex.search
    monkeypatch.setattr(ref.LiveIndex, "search",
                        lambda self, q, pol, **kw: search(self, q, pol))
    want = ref.chaos.run_crash_recovery(
        setup.jindex, setup.docs, setup.queries,
        ref.chaos.ChaosConfig(**vars(CFG)), str(tmp_path), k=10,
        n_probe=16)
    got = payload["recovery"]
    for f in ("crashes", "mutations", "replayed_records", "final_seq",
              "bit_identical"):
        assert got[f] == want[f], f


def test_chaos_cli_writes_the_artifact(tmp_path, capsys):
    out = tmp_path / "BENCH_resilience_torch.json"
    got = serve.main(["--chaos", "--device", "cpu", "--n-docs", "3000",
                      "--queries", "32", "--clusters", "24", "--dim", "16",
                      "--n-probe", "12", "--k", "10", "--chaos-deadlines",
                      "3,12", "--chaos-out", str(out)])
    assert f"wrote {out}" in capsys.readouterr().out
    d = json.loads(out.read_text())
    assert d == json.loads(json.dumps(got))
    check_chaos_smoke(d)
    check_bench_smoke_resilience(d)
    assert (d["backend"], d["power_limit"]) == ("cpu", None)
    assert [r["deadline_ms"] for r in d["deadline_curve"]] \
        == [3.0, 12.0, None]
    assert d["config"] == vars(ChaosConfig())
