"""Port parity for the serving benchmark and the benchmark driver:
``repro_torch.benchmarks.serving_bench.main(smoke=True)`` against the
JAX ``benchmarks.serving_bench.main(smoke=True)`` on one substrate
(recall within 1e-5, waves, lane steps and mean probes equal), and
``repro_torch.benchmarks.run --smoke`` writing its three artifacts.

Both packages' ``load_bench`` hand over the substrate of
tests/test_torch_table2.py and both caches point at a temporary
directory, so no test writes into ``artifacts/``.  The reference's fused
path does not trace under this JAX (ROADMAP Queue 3, R1), so its
scheduler runs ``use_fused=False`` throughout and the port's ``fused``
row is held to the port's ``compact`` row instead.  JAX is imported in
the ``ref`` fixture only.
"""
import json
import types

import pytest
import torch

from repro_torch.benchmarks import common, run, serving_bench, table2

from test_torch_table2 import substrate  # noqa: F401  (a fixture)

ATOL = 1e-5
ROWS = ("baseline", "compact", "delta_occ_0.50", "live_stream")


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
    pytest.importorskip("jax")
    import benchmarks.common as j_common
    import benchmarks.serving_bench as j_serving_bench
    from repro.core.serving import WaveScheduler as JScheduler
    return types.SimpleNamespace(common=j_common, bench=j_serving_bench,
                                 WaveScheduler=JScheduler)


@pytest.fixture(scope="module")
def rows(ref, substrate, tmp_path_factory):  # noqa: F811
    j_bench, t_bench, cache = substrate
    out = tmp_path_factory.mktemp("serving") / "BENCH_serving_torch.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref.common, "CACHE", str(cache))
        mp.setattr(common, "CACHE", str(cache))
        mp.setattr(ref.bench, "load_bench", lambda name, **kw: j_bench)
        mp.setattr(serving_bench, "load_bench", lambda name, **kw: t_bench)
        mp.setattr(ref.bench, "WaveScheduler", lambda *a, **kw:
                   ref.WaveScheduler(*a, **{**kw, "use_fused": False}))
        want = ref.bench.main(smoke=True)
        got = serving_bench.main(smoke=True, device="cpu", out=str(out))
    return want, got, json.loads(out.read_text())


@pytest.mark.parametrize("row", ROWS)
def test_serving_bench_row_matches_reference(rows, row):
    want, got, _ = rows
    for f in ("waves", "lane_steps", "mean_probes", "occupancy"):
        assert got[row][f] == want[row][f], (row, f)
    assert got[row]["recall"] == pytest.approx(want[row]["recall"], abs=ATOL)
    if row == "live_stream":
        for f in ("adds", "deletes", "merges", "versions", "swaps"):
            assert got[row][f] == want[row][f], f
        assert got[row]["recall_gap"] == pytest.approx(
            want[row]["recall_gap"], abs=ATOL)
        assert got[row]["recall_gap"] <= 0.01


def test_fused_row_equals_compact_row_and_artifact(rows):
    _, got, saved = rows
    for f in ("waves", "lane_steps", "mean_probes", "occupancy", "recall"):
        assert got["fused"][f] == got["compact"][f], f
    assert got["speedup"] >= 1.0
    assert saved["backend"] == "cpu" and saved["smoke"] is True
    assert saved["live_stream"]["recall_gap"] \
        == got["live_stream"]["recall_gap"] <= 0.01
    assert {"baseline", "compact", "fused", "delta_occ_0.50",
            "live_stream", "speedup"} <= saved.keys()


def test_run_smoke_writes_the_three_artifacts(substrate, tmp_path,  # noqa: F811
                                              monkeypatch, capsys):
    _, t_bench, cache = substrate
    monkeypatch.setattr(common, "CACHE", str(cache))
    monkeypatch.setattr(run, "ARTIFACTS", str(tmp_path))
    for mod in (table2, serving_bench):
        monkeypatch.setattr(mod, "load_bench", lambda name, **kw: t_bench)
    run.main(["--smoke", "--device", "cpu"])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["BENCH_kernels_torch.json", "BENCH_serving_torch.json",
                     "BENCH_table2_torch.json"]
    for name in names:
        d = json.loads((tmp_path / name).read_text())
        assert d["backend"] == "cpu", name
    assert "total bench time" in capsys.readouterr().out
