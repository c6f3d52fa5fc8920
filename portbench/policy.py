"""The exit trees of a configuration with a ``policy`` block: the
deployment's weights, trained at set-up from ``--seed`` by the
benchmark's own trainer, the same for every version of the program.

A ``policy`` block reads::

    {"kind": "cascade_patience", "tau": 10, "clf_threshold": 0.5,
     "exit_weight": 3.0,
     "train": {"queries": 2048, "valid": 512, "n_trees": 100,
               "max_depth": 6, "n_bins": 64}}

The recipe, each step on the reference's side and nothing of the
program's:

- queries: ``train.queries + train.valid`` of them, drawn by the pool's
  recipe (``corpus.queries``) from a second generator seeded by the run's
  seed and :data:`SALT`, once ``corpus.make`` has returned, so the
  corpus and the pool are what they are without a policy;
- labels: C_N(q), the 1-based probe rank, in the reference's float64
  centroid order, of the list that holds the best document among the
  query's first N lists.  A departure from the paper's C(q), which
  counts probes to the exact 1-NN: that needs a float64 brute force of
  every training query over the corpus at set-up;
- features: the reference's float64 Table-1 matrix after ``tau``
  probes (``reference/ivf_cascade.py``);
- fit: Exit where C_N <= tau; SMOTE on the smaller class, then the
  Exit class weighted by ``exit_weight``, one logistic forest of
  ``n_trees`` trees of depth ``max_depth`` on ``n_bins`` bins, early
  stopped on the validation queries; the frozen NumPy trainer under
  ``reference/`` (``gbdt.py``, ``smote.py``).

The forest comes back as host arrays stacked one row a tree, leaves
pointing to themselves (``ivf_cascade.Forest``).
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from . import corpus as corpus_mod
from .reference import ivf_cascade, ivf_patience
from .reference.gbdt import GBDT, Forest as GbdtForest
from .reference.smote import smote

# mixed with the run's seed into the training queries' generator
SALT = 0x7C45CADE


def stream_seed(seed: int) -> int:
    """The training stream's seed (63 bits) from the run's seed."""
    state = np.random.SeedSequence([seed & (2**64 - 1), SALT])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def training_queries(c: corpus_mod.Corpus, cfg: dict, seed: int
                     ) -> torch.Tensor:
    """``train.queries + train.valid`` queries by the pool's recipe, from
    the training stream."""
    tr = cfg["policy"]["train"]
    dev = c.pool.device
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed))
    live_rows = torch.nonzero(c.doc_ids >= 0)[:, 0]
    return corpus_mod.queries(cfg, tr["queries"] + tr["valid"], c.centroids,
                              c.docs, live_rows, corpus_mod.spread(cfg), g,
                              dev)


def best_list_rank(q: torch.Tensor, c: corpus_mod.Corpus, cfg: dict,
                   block: int = 256) -> np.ndarray:
    """C_N(q) of each query (the module's docstring); of two lists whose
    best documents tie, the earlier."""
    n, dev = cfg["n_probe"], q.device
    order = ivf_patience.centroid_order(q, c.centroids, n)
    lane = torch.arange(c.list_pad, device=dev)
    out = []
    with ivf_patience.exact_f32():
        for s0 in range(0, q.shape[0], block):
            qd = q[s0:s0 + block].double()
            best = torch.full((qd.shape[0],), ivf_patience.NEG,
                              dtype=torch.float64, device=dev)
            rank = torch.zeros(qd.shape[0], dtype=torch.int64, device=dev)
            for h in range(n):
                sc, _ = ivf_patience.list_scores(
                    qd, order[s0:s0 + block, h], c.docs, c.doc_ids,
                    c.offsets, c.sizes, lane, False)
                top = sc.amax(1)
                better = top > best
                best = torch.where(better, top, best)
                rank = torch.where(better, h + 1, rank)
            out.append(rank)
    return torch.cat(out).cpu().numpy()


def stack(forest: GbdtForest, max_depth: int) -> ivf_cascade.Forest:
    """The trees padded to one width and stacked, leaves pointing to
    themselves, as the program's ``from_numpy_forest`` stacks them."""
    m = max(t.feat.shape[0] for t in forest.trees)

    def pad(name, fill, dtype):
        out = np.full((len(forest.trees), m), fill, dtype)
        for i, tree in enumerate(forest.trees):
            arr = getattr(tree, name)
            out[i, :arr.shape[0]] = arr
        return out

    feat = pad("feat", -1, np.int32)
    left, right = pad("left", 0, np.int32), pad("right", 0, np.int32)
    for i, tree in enumerate(forest.trees):
        leaves = np.nonzero(tree.feat == -1)[0]
        left[i, leaves] = leaves
        right[i, leaves] = leaves
    return ivf_cascade.Forest(feat, pad("thresh", 0.0, np.float32), left,
                              right, pad("value", 0.0, np.float32),
                              float(np.float32(forest.base)), max_depth)


def train(c: corpus_mod.Corpus, cfg: dict, seed: int
          ) -> Tuple[ivf_cascade.Forest, Dict[str, float]]:
    """The forest of ``cfg``'s policy for the corpus ``c`` made from
    ``seed``, and what its training took: seconds of the labels, the
    features and the fit, the trees kept and the training queries'
    Exit share."""
    pol, tr = cfg["policy"], cfg["policy"]["train"]
    tau, n = pol["tau"], tr["queries"]
    dev = c.pool.device

    def now():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    q = training_queries(c, cfg, seed)
    t0 = now()
    labels = best_list_rank(q, c, cfg)
    t1 = now()
    x = ivf_cascade.search(
        q, c.docs, c.doc_ids, c.offsets, c.sizes, c.centroids, None,
        k=cfg["k"], n_probe=tau, delta=cfg["n_probe"] + 1,
        phi=cfg["patience_phi"], tau=tau, threshold=pol["clf_threshold"],
        list_pad=c.list_pad).features.cpu().numpy()
    t2 = now()
    y = (labels <= tau).astype(np.float64)
    fit_seed = stream_seed(seed)
    xs, ys = smote(x[:n], y[:n], seed=fit_seed)
    w = np.where(ys == 1.0, pol["exit_weight"], 1.0)
    model = GBDT("logistic", n_trees=tr["n_trees"], max_depth=tr["max_depth"],
                 n_bins=tr["n_bins"], seed=fit_seed)
    fit = model.fit(xs, ys, sample_weight=w, eval_set=(x[n:], y[n:]))
    t3 = time.perf_counter()
    return stack(fit, tr["max_depth"]), {
        "labels_s": t1 - t0, "features_s": t2 - t1, "fit_s": t3 - t2,
        "trees": len(fit.trees), "exit_share": float(y[:n].mean()),
        "mean_c_n": float(labels.mean())}
