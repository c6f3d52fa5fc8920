"""Deterministic, restart-safe input pipelines (a copy of
``repro.data.pipeline``: NumPy only, the same batches from the same
seed; ``recsys_batcher`` draws from this package's ``click_log``).

Every batch is a pure function of (seed, step) — after a fault-restart
the pipeline replays the identical stream.  A background prefetch
thread overlaps host batch synthesis with device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class DeterministicBatcher:
    """batch(step) = f(seed, step); stateless between calls."""

    def __init__(self, make_batch: Callable[[np.random.Generator], Dict],
                 seed: int = 0):
        self.make_batch = make_batch
        self.seed = seed

    def batch(self, step: int) -> Dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        return self.make_batch(rng)


def lm_batcher(vocab: int, batch: int, seq: int, seed: int = 0
               ) -> DeterministicBatcher:
    def mk(rng: np.random.Generator) -> Dict:
        ranks = rng.zipf(1.2, (batch, seq + 1))
        toks = np.minimum(ranks - 1, vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return DeterministicBatcher(mk, seed)


def recsys_batcher(n_dense: int, n_sparse: int, rows_per_field: int,
                   batch: int, seed: int = 0) -> DeterministicBatcher:
    from repro_torch.data.synthetic import click_log

    def mk(rng: np.random.Generator) -> Dict:
        s = int(rng.integers(0, 2 ** 31 - 1))
        return click_log(batch, n_dense, n_sparse, rows_per_field, seed=s)
    return DeterministicBatcher(mk, seed)


def pair_batcher(corpus_docs: np.ndarray, batch: int, noise: float = 0.1,
                 seed: int = 0) -> DeterministicBatcher:
    """Contrastive (query, positive-doc) pairs for retriever training."""
    n, d = corpus_docs.shape

    def mk(rng: np.random.Generator) -> Dict:
        idx = rng.integers(0, n, batch)
        pos = corpus_docs[idx]
        q = pos + rng.normal(0, noise, pos.shape).astype(np.float32)
        return {"query": q.astype(np.float32), "doc": pos,
                "doc_id": idx.astype(np.int32)}
    return DeterministicBatcher(mk, seed)


class Prefetcher:
    """Background-thread prefetch of the deterministic stream."""

    def __init__(self, batcher: DeterministicBatcher, start_step: int,
                 depth: int = 2):
        self.batcher = batcher
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            b = self.batcher.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
