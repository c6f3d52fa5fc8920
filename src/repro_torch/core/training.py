"""Offline training of the learned early-exit stages (REG / Classifier):
port of ``repro.core.training``.

Mirrors the paper's methodology: split queries into train/valid/test,
compute golden labels C(q) (min probes to reach the exact 1-NN, else N),
extract Table-1 features after tau probes, train LightGBM-class forests
(our GBDT), with SMOTE + Exit-class weighting for the classifier.

Labels and features are computed on the index's device (features by
``ivf.extract_features``, the serving path's own kernels); the GBDT and
SMOTE run on the host in NumPy, and the returned ensembles lie on the
index's device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from repro_torch.core import ivf
from repro_torch.core.features import base_columns
from repro_torch.trees.gbdt import GBDT
from repro_torch.trees.smote import smote
from repro_torch.trees.torch_infer import TreeEnsemble, from_numpy_forest


@dataclass
class PolicyModels:
    reg: TreeEnsemble            # groups 1-3 (Li et al.)
    reg_int: TreeEnsemble        # all features (REG+int)
    clf: TreeEnsemble            # unweighted classifier
    clf_weighted: TreeEnsemble   # Exit-class weight w
    labels_train: np.ndarray     # C(q) on the train split (diagnostics)
    n_probe: int
    tau: int
    # host seconds of the labels, the features and the four GBDT fits
    seconds: Dict[str, float] = field(default_factory=dict)


def _on_device(docs, dev: torch.device) -> torch.Tensor:
    """The corpus as a tensor on ``dev``: a host array is copied there, a
    tensor must already lie there."""
    if isinstance(docs, torch.Tensor):
        ivf.check_same_device(dev, "the corpus", docs)
        return docs
    return torch.as_tensor(np.asarray(docs, np.float32), device=dev)


def golden_labels(index: ivf.IVFIndex, queries: np.ndarray, docs,
                  n_probe: int, k: int, block: int = 512) -> np.ndarray:
    """C(q) for every query (blocked to bound memory).  ``docs`` is the
    corpus as a host array or as a tensor on the index's device."""
    dev = ivf.index_device(index)
    docs_t = _on_device(docs, dev)
    out = np.empty(queries.shape[0], np.int32)
    for s in range(0, queries.shape[0], block):
        e = min(s + block, queries.shape[0])
        q = torch.as_tensor(np.asarray(queries[s:e], np.float32), device=dev)
        _, top1 = ivf.brute_force(docs_t, q, 1)
        # in the probe order of the learned policies these labels train
        traj, _ = ivf.probe_trace(index, q, n_probe, k, per_row=True)
        out[s:e] = ivf.min_probes_labels(traj, top1.cpu().numpy()[:, 0],
                                         n_probe)
    return out


def features_blocked(index: ivf.IVFIndex, queries: np.ndarray, *, tau: int,
                     k: int, block: int = 1024) -> np.ndarray:
    outs = []
    for s in range(0, queries.shape[0], block):
        outs.append(ivf.extract_features(
            index, queries[s: s + block], tau=tau, k=k,
            with_intersections=True).cpu().numpy())
    return np.concatenate(outs, 0)


def train_policy_models(index: ivf.IVFIndex, docs, train_q: np.ndarray,
                        valid_q: np.ndarray, *, n_probe: int, k: int = 100,
                        tau: int = 10, exit_weight: float = 3.0,
                        n_trees: int = 100, max_depth: int = 6,
                        seed: int = 0) -> PolicyModels:
    """The four forests of Table 2, on the index's device.  REG is fit
    on ``base_columns``, the columns ``policy_step`` feeds it."""
    dev = ivf.index_device(index)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    y_tr = golden_labels(index, train_q, docs, n_probe, k)
    y_va = golden_labels(index, valid_q, docs, n_probe, k)
    sync()
    t1 = time.perf_counter()
    x_tr = features_blocked(index, train_q, tau=tau, k=k)
    x_va = features_blocked(index, valid_q, tau=tau, k=k)
    sync()
    t2 = time.perf_counter()

    # --- REG (groups 1-3) & REG+int (all features) ---
    reg_model = GBDT("l2", n_trees=n_trees, max_depth=max_depth, seed=seed)
    f_reg = reg_model.fit(base_columns(x_tr, tau), y_tr.astype(np.float64),
                          eval_set=(base_columns(x_va, tau),
                                    y_va.astype(np.float64)))
    f_reg_int = reg_model.fit(x_tr, y_tr.astype(np.float64),
                              eval_set=(x_va, y_va.astype(np.float64)))

    # --- Classifier: Exit iff C(q) <= tau; SMOTE on the minority class,
    # then instance weight w on the Exit class (paper: penalise F-Exits) ---
    c_tr = (y_tr <= tau).astype(np.float64)   # Exit = 1
    c_va = (y_va <= tau).astype(np.float64)
    xs, cs = smote(x_tr, c_tr, seed=seed)
    clf_model = GBDT("logistic", n_trees=n_trees, max_depth=max_depth,
                     seed=seed)
    f_clf = clf_model.fit(xs, cs, eval_set=(x_va, c_va))
    w = np.where(cs == 1.0, exit_weight, 1.0)
    f_clf_w = clf_model.fit(xs, cs, sample_weight=w, eval_set=(x_va, c_va))
    seconds = dict(labels=t1 - t0, features=t2 - t1,
                   gbdt=time.perf_counter() - t2)

    return PolicyModels(
        reg=from_numpy_forest(f_reg, max_depth, device=dev),
        reg_int=from_numpy_forest(f_reg_int, max_depth, device=dev),
        clf=from_numpy_forest(f_clf, max_depth, device=dev),
        clf_weighted=from_numpy_forest(f_clf_w, max_depth, device=dev),
        labels_train=y_tr, n_probe=n_probe, tau=tau, seconds=seconds)


def choose_n_probe(index: ivf.IVFIndex, docs, queries: np.ndarray, *,
                   rho: float = 0.95, k: int = 100, n_max: int = 256,
                   block: int = 512) -> int:
    """Paper §2: minimum N with R*@1 >= rho on a tuning query set."""
    dev = ivf.index_device(index)
    docs_t = _on_device(docs, dev)
    hits = np.zeros(n_max, np.int64)
    total = 0
    for s in range(0, queries.shape[0], block):
        e = min(s + block, queries.shape[0])
        q = torch.as_tensor(np.asarray(queries[s:e], np.float32), device=dev)
        _, top1 = ivf.brute_force(docs_t, q, 1)
        traj, _ = ivf.probe_trace(index, q, n_max, k)
        found = (traj == top1.cpu().numpy()[None, :, :1]).any(-1)  # (N, b)
        hit_at = np.cumsum(found, 0) > 0                            # (N, b)
        hits += hit_at.sum(1)
        total += e - s
    recall = hits / total
    ok = np.nonzero(recall >= rho)[0]
    return int(ok[0]) + 1 if ok.size else n_max
