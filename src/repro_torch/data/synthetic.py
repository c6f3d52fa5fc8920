"""Synthetic retrieval corpus (NumPy only; same generator as
``repro.data.synthetic.clustered_corpus``, so one seed gives the same
corpus in both packages).

``clustered_corpus`` replaces the MS-MARCO + {STAR, Contriever, TAS-B}
embedding collections: an anisotropic Gaussian mixture with power-law
component sizes. Queries mix *easy* (noisy copies of docs — the ~50% of
queries whose 1-NN sits in the first probed cluster) and *hard*
(interpolations between components — the long power-law tail). The
"encoder" knob ``spread`` emulates harder encoders (Contriever/TAS-B
need larger N in the paper).

``token_stream`` and ``click_log`` are the reference's LM and recsys
generators, copied as they are (same seed, same arrays).  The graph
generator waits for the GNN models.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class Corpus:
    docs: np.ndarray       # (n_docs, dim) f32, L2-normalised
    queries: np.ndarray    # (n_q, dim)
    relevant: np.ndarray   # (n_q,) int32 — "human label" doc per query


def _components(rng: np.random.Generator, n_docs: int, n_components: int,
                dim: int):
    """Zipf (s=1.1) component sizes and unit component centres."""
    w = 1.0 / np.arange(1, n_components + 1) ** 1.1
    w /= w.sum()
    sizes = rng.multinomial(n_docs, w)
    centers = rng.normal(0, 1, (n_components, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return sizes, centers


def component_centers(n_docs: int = 100_000, dim: int = 128,
                      n_components: int = 512, *, seed: int = 0
                      ) -> np.ndarray:
    """The unit centres ``clustered_corpus`` draws with these arguments
    (its generator replayed as far as the centres), for more queries of
    the same mix by ``query_mix``."""
    return _components(np.random.default_rng(seed), n_docs, n_components,
                       dim)[1]


def query_mix(rng: np.random.Generator, docs: np.ndarray,
              centers: np.ndarray, n_queries: int, *, spread: float,
              hard_frac: float = 0.35) -> np.ndarray:
    """``n_queries`` unit queries in random order: easy ones are noisy
    copies of docs, hard ones interpolate between two component centres
    plus noise."""
    dim = docs.shape[1]
    n_hard = int(n_queries * hard_frac)
    n_easy = n_queries - n_hard
    # easy: perturbed docs (1-NN almost surely in the home cluster)
    src = rng.integers(0, docs.shape[0], n_easy)
    easy = docs[src] + rng.normal(0, 0.15 * spread, (n_easy, dim))
    # hard: interpolations between two components + noise
    c1 = rng.integers(0, centers.shape[0], n_hard)
    c2 = rng.integers(0, centers.shape[0], n_hard)
    t = rng.random((n_hard, 1)).astype(np.float32)
    hard = centers[c1] * t + centers[c2] * (1 - t) + \
        rng.normal(0, spread, (n_hard, dim))
    queries = np.concatenate([easy, hard]).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    perm = rng.permutation(n_queries)
    return queries[perm]


def clustered_corpus(n_docs: int = 100_000, dim: int = 128,
                     n_components: int = 512, n_queries: int = 4096,
                     *, spread: float = 0.25, hard_frac: float = 0.35,
                     seed: int = 0) -> Corpus:
    rng = np.random.default_rng(seed)
    sizes, centers = _components(rng, n_docs, n_components, dim)
    scales = (0.5 + rng.random(n_components)) * spread
    docs = np.empty((n_docs, dim), np.float32)
    pos = 0
    for c, s in enumerate(sizes):
        if s == 0:
            continue
        docs[pos: pos + s] = centers[c] + rng.normal(0, scales[c], (s, dim))
        pos += s
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    queries = query_mix(rng, docs, centers, n_queries, spread=spread,
                        hard_frac=hard_frac)
    return Corpus(docs, queries, relevant_docs(queries, docs))


def relevant_docs(queries: np.ndarray, docs: np.ndarray,
                  block: int = 256) -> np.ndarray:
    """"Relevant" doc = exact 1-NN of a noisy variant (proxy for
    qrels): a host matmul over the whole corpus, in query blocks."""
    relevant = np.empty(queries.shape[0], np.int32)
    for s in range(0, queries.shape[0], block):
        e = min(s + block, queries.shape[0])
        relevant[s:e] = np.argmax(queries[s:e] @ docs.T, 1)
    return relevant


# ---------------------------------------------------------------------------
# LM / recsys generators
# ---------------------------------------------------------------------------


def token_stream(n_tokens: int, vocab: int, seed: int = 0,
                 zipf_s: float = 1.2) -> np.ndarray:
    """Zipf-distributed token ids (realistic embedding-gather skew)."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf_s, n_tokens)
    return np.minimum(ranks - 1, vocab - 1).astype(np.int32)


def click_log(batch: int, n_dense: int, n_sparse: int, rows_per_field: int,
              seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    dense = rng.normal(0, 1, (batch, max(n_dense, 1))).astype(np.float32)
    ranks = rng.zipf(1.2, (batch, n_sparse))
    sparse = np.minimum(ranks - 1, rows_per_field - 1).astype(np.int32)
    # click prob depends on a random linear model over fields (learnable)
    logits = 0.1 * dense.sum(1) + 0.01 * (sparse % 17).sum(1) - 1.0
    y = (rng.random(batch) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    if n_dense == 0:
        dense = np.zeros((batch, 0), np.float32)
    return {"dense": dense, "sparse": sparse, "label": y}
