# Frozen copy of src/repro_torch/trees/gbdt.py, the program's NumPy
# trainer, kept in the benchmark so that the exit trees it trains from
# the seed do not move when the program changes.  Copied as it was, code
# and docstrings alike, but for this header and the split search in
# ``_build_tree``: it scores 32 columns at once in place of one, the
# same sums in the same order, so the same trees bit for bit, in about
# half the time at 800 features.
"""Histogram gradient-boosted trees (numpy) — the LightGBM stand-in.

The paper trains "small additive forests of 100 trees using LightGBM";
LightGBM is not available offline, so we implement the same algorithm
class: quantile-binned histograms, level-wise growth, L2 / logistic
objectives, instance weights (the classifier's Exit-class weight ``w``),
and early stopping on a validation set. Inference runs in PyTorch via
``repro_torch.trees.torch_infer``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

# columns scored together in the split search (a block's histograms stay
# in the cache)
COLUMN_BLOCK = 32


@dataclass
class Tree:
    feat: np.ndarray     # (M,) int32; -1 = leaf
    thresh: np.ndarray   # (M,) f32 raw-unit threshold, go left if x <= thr
    left: np.ndarray     # (M,) int32
    right: np.ndarray    # (M,) int32
    value: np.ndarray    # (M,) f32; nonzero only at leaves


@dataclass
class Forest:
    trees: List[Tree]
    base: float
    best_iteration: int = -1


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))


def _bin_data(x: np.ndarray, n_bins: int
              ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Quantile binning. Returns (binned uint16 (N,F), edges per feature)."""
    n, f = x.shape
    sample = x if n <= 50_000 else x[np.random.default_rng(0).choice(
        n, 50_000, replace=False)]
    binned = np.empty((n, f), np.uint16)
    edges: List[np.ndarray] = []
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    for j in range(f):
        e = np.unique(np.quantile(sample[:, j], qs))
        e = e[np.isfinite(e)]
        edges.append(e.astype(np.float32))
        binned[:, j] = np.searchsorted(e, x[:, j], side="left").astype(np.uint16)
    return binned, edges


class GBDT:
    """Level-wise histogram GBDT. objective: 'l2' | 'logistic'."""

    def __init__(self, objective: str = "l2", n_trees: int = 100,
                 learning_rate: float = 0.1, max_depth: int = 6,
                 n_bins: int = 64, reg_lambda: float = 1.0,
                 min_child_weight: float = 1.0, min_gain: float = 1e-6,
                 early_stopping: int = 10, seed: int = 0,
                 colsample: float = 1.0):
        assert objective in ("l2", "logistic")
        self.objective = objective
        self.n_trees = n_trees
        self.lr = learning_rate
        self.max_depth = max_depth
        self.n_bins = n_bins
        self.reg_lambda = reg_lambda
        self.min_child_weight = min_child_weight
        self.min_gain = min_gain
        self.early_stopping = early_stopping
        self.seed = seed
        self.colsample = colsample

    # -- objective ---------------------------------------------------------
    def _init_base(self, y, w):
        mean = float(np.average(y, weights=w))
        if self.objective == "logistic":
            mean = min(max(mean, 1e-6), 1 - 1e-6)
            return float(np.log(mean / (1 - mean)))
        return mean

    def _grad_hess(self, margin, y, w):
        if self.objective == "logistic":
            p = _sigmoid(margin)
            return (p - y) * w, np.maximum(p * (1 - p), 1e-6) * w
        return (margin - y) * w, w.copy()

    def _loss(self, margin, y, w):
        if self.objective == "logistic":
            p = _sigmoid(margin)
            ll = y * np.log(np.clip(p, 1e-9, 1)) + \
                (1 - y) * np.log(np.clip(1 - p, 1e-9, 1))
            return float(-np.average(ll, weights=w))
        return float(np.average((margin - y) ** 2, weights=w))

    # -- training ----------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray,
            sample_weight: Optional[np.ndarray] = None,
            eval_set: Optional[Tuple[np.ndarray, np.ndarray]] = None
            ) -> Forest:
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float64)
        n, f = x.shape
        w = np.ones(n) if sample_weight is None else \
            np.asarray(sample_weight, np.float64)
        rng = np.random.default_rng(self.seed)
        binned, edges = _bin_data(x, self.n_bins)
        base = self._init_base(y, w)
        margin = np.full(n, base)
        trees: List[Tree] = []
        ev = None
        if eval_set is not None:
            ev_x = np.asarray(eval_set[0], np.float32)
            ev_y = np.asarray(eval_set[1], np.float64)
            ev_margin = np.full(ev_x.shape[0], base)
            ev_w = np.ones(ev_x.shape[0])
            best_loss, best_iter, since = np.inf, -1, 0
            ev = True
        for it in range(self.n_trees):
            g, h = self._grad_hess(margin, y, w)
            cols = np.arange(f) if self.colsample >= 1.0 else \
                np.sort(rng.choice(f, max(1, int(f * self.colsample)),
                                   replace=False))
            tree = self._build_tree(binned, edges, g, h, cols)
            trees.append(tree)
            margin += _predict_tree(tree, x)
            if ev:
                ev_margin += _predict_tree(tree, ev_x)
                loss = self._loss(ev_margin, ev_y, ev_w)
                if loss < best_loss - 1e-9:
                    best_loss, best_iter, since = loss, it, 0
                else:
                    since += 1
                    if since >= self.early_stopping:
                        trees = trees[: best_iter + 1]
                        return Forest(trees, base, best_iter)
        return Forest(trees, base, len(trees) - 1)

    def _build_tree(self, binned, edges, g, h, cols) -> Tree:
        n = binned.shape[0]
        binned_t = np.ascontiguousarray(binned.T)
        nb = self.n_bins
        max_nodes = 2 ** (self.max_depth + 1) - 1
        feat = np.full(max_nodes, -1, np.int32)
        thresh = np.zeros(max_nodes, np.float32)
        thresh_bin = np.zeros(max_nodes, np.int32)
        left = np.zeros(max_nodes, np.int32)
        right = np.zeros(max_nodes, np.int32)
        value = np.zeros(max_nodes, np.float32)
        node_of = np.zeros(n, np.int32)      # heap index per sample
        settled = np.zeros(n, bool)          # sample reached a leaf

        for depth in range(self.max_depth):
            level_off = 2 ** depth - 1
            n_level = 2 ** depth
            act = ~settled
            if not act.any():
                break
            rel = node_of[act] - level_off
            g_a, h_a = g[act], h[act]
            # totals per node
            gtot = np.bincount(rel, weights=g_a, minlength=n_level)
            htot = np.bincount(rel, weights=h_a, minlength=n_level)
            best_gain = np.full(n_level, 0.0)
            best_feat = np.full(n_level, -1, np.int32)
            best_bin = np.zeros(n_level, np.int32)
            lam = self.reg_lambda
            parent_score = gtot ** 2 / (htot + lam)
            # the split search, COLUMN_BLOCK columns at a time: column
            # j's entries fill bins of their own in the row order of a
            # bincount of that column alone, so each sum, gain and pick
            # is the column-by-column loop's, bit for bit
            use = np.array([j for j in cols if len(edges[j])], np.int64)
            b_act = binned_t[use][:, act]
            width = n_level * nb
            base = rel.astype(np.int64) * nb
            g_t = np.tile(g_a, COLUMN_BLOCK)
            h_t = np.tile(h_a, COLUMN_BLOCK)
            nodes = np.arange(n_level)
            for j0 in range(0, use.size, COLUMN_BLOCK):
                m = min(COLUMN_BLOCK, use.size - j0)
                idx = (np.arange(m)[:, None] * width + base[None, :]
                       + b_act[j0:j0 + m]).ravel()
                hg = np.bincount(idx, weights=g_t[:idx.size],
                                 minlength=m * width).reshape(m, n_level, nb)
                hh = np.bincount(idx, weights=h_t[:idx.size],
                                 minlength=m * width).reshape(m, n_level, nb)
                gl = np.cumsum(hg, 2)[:, :, :-1]
                hl = np.cumsum(hh, 2)[:, :, :-1]
                gr = gtot[None, :, None] - gl
                hr = htot[None, :, None] - hl
                ok = (hl >= self.min_child_weight) & \
                     (hr >= self.min_child_weight)
                gain = np.where(
                    ok, gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam)
                    - parent_score[None, :, None], -np.inf)
                jbest = np.argmax(gain, 2)
                jgain = np.take_along_axis(gain, jbest[:, :, None], 2)[:, :, 0]
                # the block's first column of its best gain, kept where it
                # beats the best so far, as the loop's strict ">" keeps it
                first = np.argmax(jgain, 0)
                top = jgain[first, nodes]
                upd = top > best_gain
                best_gain = np.where(upd, top, best_gain)
                best_feat = np.where(upd, use[j0 + first], best_feat)
                best_bin = np.where(upd, jbest[first, nodes], best_bin)
            for r in range(n_level):
                node = level_off + r
                if htot[r] <= 0:
                    continue
                if best_feat[r] < 0 or best_gain[r] <= self.min_gain:
                    value[node] = -self.lr * gtot[r] / (htot[r] + lam)
                    sel = act & (node_of == node)
                    settled[sel] = True
                    continue
                j, b = int(best_feat[r]), int(best_bin[r])
                feat[node] = j
                thresh_bin[node] = b
                e = edges[j]
                thresh[node] = e[min(b, len(e) - 1)]
                left[node] = 2 * node + 1
                right[node] = 2 * node + 2
                sel = act & (node_of == node)
                goes_left = binned[sel, j] <= b
                child = np.where(goes_left, 2 * node + 1, 2 * node + 2)
                node_of[sel] = child
        # terminal level leaves
        act = ~settled
        if act.any():
            lam = self.reg_lambda
            for node in np.unique(node_of[act]):
                sel = act & (node_of == node)
                gg, hh_ = g[sel].sum(), h[sel].sum()
                value[node] = -self.lr * gg / (hh_ + lam)
        used = max_nodes
        return Tree(feat[:used], thresh[:used], left[:used], right[:used],
                    value[:used])

    def predict_margin(self, forest: Forest, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        out = np.full(x.shape[0], forest.base)
        for t in forest.trees:
            out += _predict_tree(t, x)
        return out

    def predict(self, forest: Forest, x: np.ndarray) -> np.ndarray:
        m = self.predict_margin(forest, x)
        return _sigmoid(m) if self.objective == "logistic" else m


def _predict_tree(tree: Tree, x: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    node = np.zeros(n, np.int32)
    for _ in range(32):  # depth bound
        f = tree.feat[node]
        inner = f >= 0
        if not inner.any():
            break
        xi = x[np.arange(n), np.maximum(f, 0)]
        go_left = xi <= tree.thresh[node]
        nxt = np.where(go_left, tree.left[node], tree.right[node])
        node = np.where(inner, nxt, node)
    return tree.value[node]
