"""The plain cascade IVF search: what a configuration with a ``policy``
block is held to.

A frozen restatement of the paper's cascade (Busolin et al., CIKM'24,
§2 "Cascade Approach"): an Exit/Continue classifier read once, after
``tau`` probes, lets the queries it calls easy leave there, and the
patience exit stops the rest.  Written from the description and
independent of the program: plain PyTorch, in float64 by default, on
``ivf_patience``'s probe order, merge and ``kept``.

After probe ``h`` (0-based) the search exits when

- ``h + 1 == tau`` and the classifier says Exit;
- the patience counter (``ivf_patience.patience``: it grows from
  ``h >= 1``) has reached Delta and ``h + 1 >= tau``;
- ``h + 1 == N``.

The classifier reads the Table-1 features after probe ``tau``, in this
order (the layout the trees are trained on):

- the query (``d`` columns);
- the scores of the first ``tau`` centroids in probe order;
- the best and the k-th best document score so far (0 where there is
  none), best / k-th and best / first centroid score, each denominator
  kept off zero as ``guard`` says;
- ``kept / k`` after each probe ``1 .. tau - 1``, against the top-k
  before it;
- the share of the top-k after probe 0 that is still in the top-k
  after each probe ``1 .. tau - 1``, over ``k``.

The classifier is a forest of stacked trees (:class:`Forest`).  The
trees read float32 inputs: their thresholds are float32 values of the
features they were fit on.  So the walk rounds each feature to float32
once and goes left where it is at most the node's threshold.  The leaf
values are summed over the trees in float64, the base added, and the
classifier says Exit where ``sigmoid(margin) >= threshold``.

``tf32=True`` computes in TF32, as ``ivf_patience`` does: the features
and the margin too, in float32.  That is the control.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import ivf_patience
from .ivf_patience import (NEG, _cast, _merge, exact_f32, list_scores,
                           patience)

# a denominator under this is kept off zero (``guard``)
EPS = 1e-6


@dataclasses.dataclass
class Forest:
    """Stacked trees, host arrays, one row a tree: node 0 is the root;
    an inner node splits on ``feat`` (-1 at a leaf) and goes to
    ``left`` where the feature is at most ``thresh``, else to ``right``;
    a leaf points to itself and holds ``value``."""
    feat: np.ndarray     # (T, M) int32
    thresh: np.ndarray   # (T, M) float32
    left: np.ndarray     # (T, M) int32
    right: np.ndarray    # (T, M) int32
    value: np.ndarray    # (T, M) float32
    base: float
    max_depth: int


@dataclasses.dataclass
class Cascade(ivf_patience.Reference):
    features: torch.Tensor   # (B, F) the classifier's inputs after tau
    margin: torch.Tensor     # (B,) the forest's margin on them
    clf_exit: torch.Tensor   # (B,) bool: the classifier says Exit
    split_gap: torch.Tensor  # (B,) nearest |feature - threshold| on the path


def n_features(dim: int, tau: int) -> int:
    return dim + tau + 4 + 2 * (tau - 1)


def guard(x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``|x| > EPS``, else ``sign(x) EPS + EPS``."""
    return torch.where(x.abs() > EPS, x, torch.sign(x) * EPS + EPS)


def walk(forest: Forest, x: torch.Tensor):
    """The forest on the rows of ``x``: (B,) margins in ``x``'s type and
    (B,) the nearest distance, over every split on each row's paths,
    between the feature and the threshold (inf where no split was
    passed).  Plain: one tree and one level at a time."""
    dev, fdt = x.device, x.dtype
    x32 = x.float()
    margin = torch.full((x.shape[0],), float(forest.base), dtype=fdt,
                        device=dev)
    gap = torch.full((x.shape[0],), float("inf"), dtype=torch.float64,
                     device=dev)
    rows = torch.arange(x.shape[0], device=dev)
    feat, left, right = (torch.as_tensor(a.astype(np.int64), device=dev)
                         for a in (forest.feat, forest.left, forest.right))
    thr = torch.as_tensor(forest.thresh, device=dev)
    value = torch.as_tensor(forest.value, device=dev).to(fdt)
    for t in range(feat.shape[0]):
        node = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
        for _ in range(forest.max_depth):
            f = feat[t, node]
            inner = f >= 0
            col = f.clamp(min=0)
            d = (x[rows, col].double() - thr[t, node].double()).abs()
            gap = torch.where(inner, torch.minimum(gap, d), gap)
            nxt = torch.where(x32[rows, col] <= thr[t, node], left[t, node],
                              right[t, node])
            node = torch.where(inner, nxt, node)
        margin = margin + value[t, node]
    return margin, gap


def features(queries, cs, run_s, kept_hist, held_hist) -> torch.Tensor:
    """The Table-1 matrix (the module's docstring) from the queries, the
    first ``tau`` centroid scores, the top-k scores after probe ``tau``
    and the two history blocks, as shares of ``k``."""
    s = torch.where(torch.isfinite(run_s), run_s, torch.zeros_like(run_s))
    s1, sk = s[:, 0], s[:, -1]
    return torch.cat([queries, cs, s1[:, None], sk[:, None],
                      (s1 / guard(sk))[:, None],
                      (s1 / guard(cs[:, 0]))[:, None], kept_hist, held_hist],
                     1)


def search(queries, docs, doc_ids, offsets, sizes, centroids,
           forest: Optional[Forest], *, k: int, n_probe: int, delta: int,
           phi: float, tau: int, threshold: float, list_pad: int,
           tf32: bool = False, block: int = 256) -> Cascade:
    """The cascade search of every query over all ``n_probe`` probes, the
    top-k kept after each probe, the exit probe count, the features
    after ``tau`` and the classifier's reading of them.  Without a
    ``forest`` the classifier never says Exit (its margin reads -inf):
    the features alone, as the trainer wants them."""
    dev = queries.device
    order = ivf_patience.centroid_order(queries, centroids, n_probe,
                                        tf32=tf32)
    c = _cast(centroids, tf32)
    lane = torch.arange(list_pad, device=dev)
    fdt = torch.float32 if tf32 else torch.float64
    outs = []
    with exact_f32():
        for s0 in range(0, queries.shape[0], block):
            q = _cast(queries[s0:s0 + block], tf32)
            b = q.shape[0]
            cs = (q[:, None, :] * c[order[s0:s0 + b, :tau]]).sum(-1)
            run_s = torch.full((b, k), NEG, dtype=fdt, device=dev)
            run_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
            ctr = torch.zeros(b, dtype=torch.int64, device=dev)
            probes = torch.full((b,), n_probe, dtype=torch.int64,
                                device=dev)
            done = torch.zeros(b, dtype=torch.bool, device=dev)
            kept_hist = torch.zeros(b, tau - 1, dtype=fdt, device=dev)
            held_hist = torch.zeros(b, tau - 1, dtype=fdt, device=dev)
            snap_i, snap_s = [], []
            for h in range(n_probe):
                sc, ids = list_scores(q, order[s0:s0 + b, h], docs, doc_ids,
                                      offsets, sizes, lane, tf32)
                run_s, run_i, old = _merge(run_s, run_i, sc, ids, k)
                ctr = patience(ctr, old, run_i, h, k, phi)
                if h == 0:
                    rs1 = run_i
                elif h < tau:
                    kept = (old & (run_i >= 0)).sum(1)
                    held = ((rs1[:, :, None] == run_i[:, None, :])
                            & (rs1 >= 0)[:, :, None]).any(2).sum(1)
                    kept_hist[:, h - 1] = kept.to(fdt) / k
                    held_hist[:, h - 1] = held.to(fdt) / k
                stage = h + 1 == tau
                if stage:
                    x = features(q, cs, run_s, kept_hist, held_hist)
                    if forest is None:
                        margin = torch.full((b,), NEG, dtype=fdt,
                                            device=dev)
                        gap = torch.full((b,), float("inf"),
                                         dtype=torch.float64, device=dev)
                    else:
                        margin, gap = walk(forest, x)
                    says_exit = torch.sigmoid(margin) >= threshold
                clf = says_exit if stage else torch.zeros_like(done)
                exit_now = ~done & (clf | ((ctr >= delta) & (h + 1 >= tau))
                                    | (h + 1 >= n_probe))
                probes = torch.where(exit_now, h + 1, probes)
                done |= exit_now
                snap_i.append(run_i)
                snap_s.append(run_s)
            outs.append((probes, torch.stack(snap_i, 1),
                         torch.stack(snap_s, 1), x, margin, says_exit, gap))
    cat = [torch.cat(z) for z in zip(*outs)]
    return Cascade(order, *cat)
