# Frozen copy of src/repro_torch/trees/smote.py, the program's NumPy
# trainer, kept in the benchmark so that the exit trees it trains from
# the seed do not move when the program changes.  Copied as it was, code
# and docstrings alike; only this header is new.
"""SMOTE (Chawla et al., JAIR'02) — minority-class oversampling used to
rebalance the Exit/Continue classifier training set (paper §2)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def smote(x: np.ndarray, y: np.ndarray, *, k: int = 5, seed: int = 0,
          target_ratio: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Oversample the minority class with k-NN interpolation.

    target_ratio: desired minority/majority count ratio after sampling.
    Returns augmented (x, y); original rows come first.
    """
    x = np.asarray(x, np.float32)
    y = np.asarray(y)
    rng = np.random.default_rng(seed)
    classes, counts = np.unique(y, return_counts=True)
    if len(classes) == 1:
        return x, y          # degenerate split: nothing to rebalance
    if len(classes) != 2:
        raise ValueError("smote expects binary labels")
    minority = classes[np.argmin(counts)]
    majority_n = counts.max()
    minority_idx = np.nonzero(y == minority)[0]
    need = int(target_ratio * majority_n) - minority_idx.size
    if need <= 0 or minority_idx.size < 2:
        return x, y
    pts = x[minority_idx]
    kk = min(k, pts.shape[0] - 1)
    # brute-force k-NN within the minority class (blocked for memory)
    nn = np.empty((pts.shape[0], kk), np.int64)
    block = 1024
    sq = (pts ** 2).sum(1)
    for s in range(0, pts.shape[0], block):
        e = min(s + block, pts.shape[0])
        d2 = sq[s:e, None] - 2.0 * pts[s:e] @ pts.T + sq[None, :]
        d2[np.arange(e - s), np.arange(s, e)] = np.inf
        nn[s:e] = np.argpartition(d2, kk, axis=1)[:, :kk]
    src = rng.integers(0, pts.shape[0], need)
    nbr = nn[src, rng.integers(0, kk, need)]
    u = rng.random((need, 1)).astype(np.float32)
    synth = pts[src] + u * (pts[nbr] - pts[src])
    xa = np.concatenate([x, synth], 0)
    ya = np.concatenate([y, np.full(need, minority, y.dtype)])
    return xa, ya
