"""Guards of the port: it never imports JAX or the reference package,
it never runs on the CPU unless asked to, and it never moves an index
or mixes devices behind the caller's back."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import build_index, index_from_arrays, policies, \
    search
from repro_torch.core.serving import WaveScheduler
from repro_torch.index import DeltaBuffer, Tombstones, relayout
from repro_torch.kernels import ivf_scan as t_scan
from repro_torch.kernels import ivf_scan_merge as t_sm
from repro_torch.kernels import topk_merge as t_tm
from repro_torch.launch import serve
from repro_torch.configs import get_arch, reduced
from repro_torch.models import attention, recsys, transformer

ROOT = Path(__file__).resolve().parent.parent
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.M)


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_or_reference(path):
    assert not _IMPORT.search(path.read_text()), path


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.core.serving,"
            " repro_torch.index, repro_torch.models.transformer,"
            " repro_torch.models.recsys, repro_torch.configs,"
            " repro_torch.trees, repro_torch.core.training,"
            " repro_torch.benchmarks.table2, repro_torch.benchmarks.figure1,"
            " repro_torch.benchmarks.clabel_dist,"
            " repro_torch.runtime.chaos, repro_torch.core.distributed_ivf,"
            " repro_torch.launch.mesh, repro_torch.distributed.collectives,"
            " repro_torch.distributed.embedding,"
            " repro_torch.distributed.context, repro_torch.models.moe,"
            " repro_torch.benchmarks.serving_bench,"
            " repro_torch.benchmarks.run, repro_torch.optim.optimizers,"
            " repro_torch.data.pipeline, repro_torch.runtime.fault,"
            " repro_torch.runtime.elastic, repro_torch.launch.train,"
            " repro_torch.examples.quickstart,"
            " repro_torch.examples.serve_early_exit,"
            " repro_torch.examples.train_retriever,"
            " repro_torch.examples.lm_fault_tolerant,"
            " repro_torch.models.gnn, repro_torch.data.graph_sampler,"
            " repro_torch.examples.gnn_and_recsys,"
            " repro_torch.distributed.sharding,"
            " repro_torch.launch.cost_analysis, repro_torch.launch.cells,"
            " repro_torch.launch.dryrun, repro_torch.benchmarks.roofline,"
            " repro_torch.benchmarks.hillclimb;"
            "bad = sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'repro'));"
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


def _tiny_arrays(n=256, d=8, lp=64):
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(n + lp, d)).astype(np.float32)
    ids = np.arange(n + lp, dtype=np.int32)
    ids[n:] = -1
    return (docs[:4], docs, ids, np.arange(4, dtype=np.int32) * lp,
            np.full(4, lp, np.int32), lp)


def test_entry_points_need_a_card_or_an_explicit_cpu(no_card):
    arrays = _tiny_arrays()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index_from_arrays(*arrays)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(arrays[1], 4, list_pad=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--n-docs", "500", "--dim", "8", "--clusters", "4",
                    "--queries", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        index_from_arrays(*arrays, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeltaBuffer(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Tombstones(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        relayout(arrays[1][:8], np.arange(8), np.zeros(8, np.int32),
                 arrays[0], list_pad=64)


def test_learned_stage_entry_points_need_a_card_or_an_explicit_cpu(
        no_card, tmp_path, monkeypatch):
    from repro_torch.benchmarks import common, table2
    from repro_torch.trees import ensemble_from_arrays

    arrays = ([[0, -1, -1]], [[0.5, 0.0, 0.0]], [[1, 1, 2]], [[2, 1, 2]],
              [[0.0, 1.0, -1.0]], 0.0, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ensemble_from_arrays(*arrays)
    assert ensemble_from_arrays(*arrays, device="cpu").feat.device.type \
        == "cpu"
    monkeypatch.setattr(common, "CACHE", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.load_bench("star-like", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table2.main(smoke=True, out=str(tmp_path / "t2.json"))
    assert not list(tmp_path.iterdir())


def _numpy_tree(tree):
    """The port's params as the reference's numpy tree: a list of layers
    becomes one (L, ...) stack per leaf."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return {k: np.stack([_numpy_tree(lp)[k] for lp in tree])
                if not isinstance(tree[0][k], dict) else
                _numpy_tree([lp[k] for lp in tree]) for k in tree[0]}
    return tree.numpy()


@pytest.mark.parametrize("arch,family", [("starcoder2-3b", transformer),
                                         ("minicpm3-4b", transformer),
                                         ("deepseek-moe-16b", transformer),
                                         ("deepfm", recsys)])
def test_model_entry_points_need_a_card_or_an_explicit_cpu(no_card, arch,
                                                           family):
    cfg = reduced(get_arch(arch)).model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        family.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        family.init_params(cfg, seed=0, device="cuda")
    tree = _numpy_tree(family.init_params(cfg, seed=0, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        family.params_from_numpy(cfg, tree)
    back = family.params_from_numpy(cfg, tree, device="cpu")
    leaf = back["embed"] if family is transformer else back["table"]
    assert leaf.device.type == "cpu"


@pytest.mark.parametrize("make", [attention.init_kv_cache,
                                  transformer.init_cache])
def test_kv_caches_need_a_card_or_an_explicit_cpu(no_card, make):
    cfg = reduced(get_arch("starcoder2-3b")).model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(cfg, 2, 8)
    cache = make(cfg, 2, 8, device="cpu")
    k = cache.k if make is attention.init_kv_cache else cache.data[0]
    assert k.device.type == "cpu" and k.dtype == torch.bfloat16


@pytest.mark.parametrize("arch,make", [
    ("qwen1.5-32b", attention.init_kv_cache),
    ("minicpm3-4b", attention.init_mla_cache),
    ("minicpm3-4b", transformer.init_cache)])
def test_int8_and_mla_caches_need_a_card_or_an_explicit_cpu(no_card, arch,
                                                            make):
    cfg = reduced(get_arch(arch)).model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(cfg, 2, 8)
    cache = make(cfg, 2, 8, device="cpu")
    data = cache.data if make is transformer.init_cache else cache
    assert all(t.device.type == "cpu" for t in data if t is not None)


def test_training_entry_points_need_a_card_or_an_explicit_cpu(no_card,
                                                              tmp_path):
    """The trainer, the training CLI, the carried training state and the
    examples run on the card by default: with no card they raise before
    they build or write anything."""
    from repro_torch.examples import (gnn_and_recsys, lm_fault_tolerant,
                                      quickstart, serve_early_exit,
                                      train_retriever)
    from repro_torch.launch import train
    from repro_torch.models import gnn
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.build_trainer("starcoder2-3b", smoke=True,
                            ckpt_dir=str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--ckpt-dir", str(tmp_path / "c")])
    cfg = reduced(get_arch("starcoder2-3b")).model
    params = _numpy_tree(transformer.init_params(cfg, seed=0, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.train_state_from_numpy(cfg, (params, params, 0))
    for main in (quickstart.main, serve_early_exit.main,
                 gnn_and_recsys.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn.init_params(get_arch("gat-cora").model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_retriever.main(ckpt=str(tmp_path / "r"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_fault_tolerant.main(base=str(tmp_path / "f"))
    assert not (tmp_path / "c").exists() and not (tmp_path / "r").exists()


def test_kernel_functions_run_the_plain_versions_on_the_cpu_only():
    """The autograd Functions take the wrapper's path: the plain version
    on CPU tensors, and on a device with no kernel they raise (``meta``
    stands in for another device here)."""
    from repro_torch.kernels import ops
    q = torch.zeros((2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.embedding_bag(torch.zeros((4, 2), device="meta"),
                          torch.zeros((3, 2), dtype=torch.int32,
                                      device="meta"))


def test_mesh_launch_needs_a_card_or_an_explicit_cpu(no_card):
    """``launch.mesh.launch`` runs its ranks on the card by default: with
    no card it raises before it spawns anything."""
    from repro_torch.launch.mesh import launch
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch(print, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch(print, 2, device="cuda")


def test_search_and_scheduler_refuse_another_device():
    index = index_from_arrays(*_tiny_arrays(), device="cpu")
    q = np.zeros((2, index.dim), np.float32)
    pol = policies.fixed(4, k=4)
    for dev in ("cuda", "meta"):
        with pytest.raises(ValueError, match="index lies on cpu"):
            search(index, q, pol, device=dev)
        with pytest.raises(ValueError, match="index lies on cpu"):
            WaveScheduler(index, device=dev)
    assert not hasattr(index, "to")
    res = search(index, q, pol, device="cpu")
    assert res.topk_ids.device.type == "cpu"


def test_kernel_wrappers_reject_mixed_devices():
    """A wrapper checks that every input lies on one device before it
    picks a path (``meta`` stands in for the card here; the gpu-marked
    test in test_torch_kernels.py mixes real CUDA and CPU tensors)."""
    f32, i32 = torch.float32, torch.int32
    cpu = dict(dtype=f32)
    meta = dict(dtype=f32, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        t_scan.ivf_scan(torch.zeros(2, 8, **meta), torch.zeros(128, 8, **cpu),
                        torch.zeros(2, dtype=i32), list_pad=64, blk_l=64)
    with pytest.raises(ValueError, match="different devices"):
        t_tm.topk_merge(torch.zeros(2, 4, **cpu), torch.zeros(2, 4, dtype=i32),
                        torch.zeros(2, 8, **meta),
                        torch.zeros(2, 8, dtype=i32), 4)
    with pytest.raises(ValueError, match="different devices"):
        t_sm.ivf_scan_merge(
            torch.zeros(2, 8, **cpu), torch.zeros(128, 8, **cpu),
            torch.zeros(2, 64, dtype=i32), torch.zeros(2, dtype=i32),
            torch.zeros(2, dtype=i32), torch.zeros(2, 4, **meta),
            torch.zeros(2, 4, dtype=i32), k=4, list_pad=64, chunk=1)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        t_scan.ivf_scan(torch.zeros(2, 8, **meta),
                        torch.zeros(128, 8, **meta),
                        torch.zeros(2, dtype=i32, device="meta"),
                        list_pad=64, blk_l=64)


def test_resilience_entry_points_need_a_card_or_an_explicit_cpu(
        no_card, tmp_path, monkeypatch):
    from repro_torch.benchmarks import common, run, serving_bench
    from repro_torch.core.distributed_ivf import (search_with_retry,
                                                  shard_index)
    from repro_torch.runtime.chaos import ChaosConfig, run_drift_drill

    sh = shard_index(index_from_arrays(*_tiny_arrays(), device="cpu"), 2)
    q = np.zeros((2, sh.docs.shape[2]), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search_with_retry(sh, q, k=4, n_probe=2)
    assert search_with_retry(sh, q, k=4, n_probe=2,
                             device="cpu")[1].shape == (2, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_drift_drill(ChaosConfig())
    monkeypatch.setattr(common, "CACHE", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving_bench.main(smoke=True, out=str(tmp_path / "s.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--chaos", "--n-docs", "500", "--dim", "8",
                    "--clusters", "4", "--queries", "4",
                    "--chaos-out", str(tmp_path / "r.json")])
    assert not list(tmp_path.iterdir())
