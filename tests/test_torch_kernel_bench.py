"""The port's kernel benchmark (``repro_torch.benchmarks.kernel_bench``)
writes the schema ``make bench-smoke`` asserts of ``BENCH_kernels.json``
(Makefile, bench-smoke): on the CPU it times the plain versions only and
records the staged route, which needs the card, as pending.

The gpu case runs on the card without JAX:
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernel_bench.py``.
"""
import json

import pytest
import torch

from repro_torch.benchmarks import kernel_bench


def test_schema_check_is_make_bench_smoke(tmp_path):
    """``check_schema`` refuses what ``make bench-smoke`` refuses."""
    d = kernel_bench.main(smoke=True, device="cpu", out=None)
    kernel_bench.check_schema(d)
    for broken in ({**d, "fused_sweep": []},
                   {**d, "fused_sweep": [dict(r, delta=False)
                                         for r in d["fused_sweep"]]},
                   {**d, "rows": [r for r in d["rows"] if r["us"]]},
                   {**d, "sort": dict(d["sort"], tagged_us=0.0)}):
        with pytest.raises(AssertionError, match="bench-smoke"):
            kernel_bench.check_schema(broken)


def test_cpu_run_writes_the_bench_smoke_schema(tmp_path):
    out = tmp_path / "BENCH_kernels_torch.json"
    ret = kernel_bench.main(smoke=True, device="cpu", out=str(out))
    d = json.loads(out.read_text())
    kernel_bench.check_schema(d)
    assert d["backend"] == "cpu" and not d["pipelined_available"]
    assert not any("cuda" in r["name"] for r in d["rows"])
    assert not any(r["pipelined"] for r in d["fused_sweep"])
    assert {r["name"] for r in d["rows"]} == {r["name"] for r in ret["rows"]}


@pytest.mark.gpu
def test_gpu_run_times_every_kernel(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    d = kernel_bench.main(smoke=True, out=str(tmp_path / "k.json"))
    kernel_bench.check_schema(d)
    assert d["backend"] == "cuda" and d["pipelined_available"]
    names = {r["name"] for r in d["rows"]}
    for k in ("flash_attention", "flash_attention_bf16", "ivf_scan",
              "topk_merge", "ivf_scan_merge", "delta_scan",
              "embedding_bag"):
        assert {f"{k}_plain", f"{k}_cuda"} <= names, k
    assert all(r["us"] > 0 for r in d["rows"])
