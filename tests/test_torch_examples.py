"""The port's examples (``repro_torch.examples``), each at a small size
on the CPU: they run end to end and what they print holds."""
import numpy as np
import pytest
import torch

from repro_torch.examples import (gnn_and_recsys, lm_fault_tolerant,
                                  quickstart, serve_early_exit,
                                  train_retriever)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one intra-op thread (ROADMAP ground rules)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart():
    out = quickstart.main(n_docs=4000, dim=16, n_clusters=32, n_queries=64,
                          n_probe=8, device="cpu")
    (r_fixed, c_fixed), (r_pat, c_pat) = out.values()
    assert c_fixed == 8.0 and c_pat <= c_fixed
    assert r_fixed >= r_pat and r_pat > 0.5


def test_serve_early_exit():
    out = serve_early_exit.main(n_docs=4000, dim=16, n_clusters=32,
                                n_queries=300, n_train=96, n_valid=64,
                                n_trees=4, k=10, device="cpu")
    assert len(out) == 5
    assert all(0.0 < r <= 1.0 for r, _ in list(out.values())[:3])
    assert out["compact=True"] >= out["compact=False"]


def test_train_retriever(tmp_path):
    out = train_retriever.main(steps=60, n_docs=3000, n_components=32,
                               n_queries=300, n_clusters=32, batch=32,
                               ckpt=str(tmp_path), device="cpu")
    assert out["losses"][-1] < out["losses"][0] / 2
    fixed, patience = out["results"].values()
    assert fixed["C"] == out["n_probe"] and patience["C"] <= fixed["C"]
    assert fixed["R*@1"] >= 0.9


def test_lm_fault_tolerant(tmp_path):
    ref, chaos, restarts = lm_fault_tolerant.main(
        steps=8, fail_at=(3, 6), base=str(tmp_path), device="cpu")
    assert restarts == 2 and len(ref) == 8
    np.testing.assert_array_equal(ref, chaos)


def test_gnn_and_recsys():
    out = gnn_and_recsys.main(gat_steps=60, recsys_steps=20, device="cpu")
    loss, acc, shape = out["gat"]
    assert acc > 0.8 and loss < 0.5          # community features separable
    assert shape == (32, 5)
    assert out["dcn"][-1] < out["dcn"][0]
