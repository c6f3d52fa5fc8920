"""Straggler mitigation for the serving path (a copy of
``repro.runtime.straggler``: NumPy only, so the port carries it as it
is).

A serving *wave* fans a query batch over shards; a shard missing the
deadline gets its slice *re-dispatched* to the fastest shard of the next
wave (speculative retry), bounding p99 by ~2 wave times rather than the
slowest shard.  ``run_waves`` simulates that control-plane policy; the
:class:`RetryPolicy` backoff schedule defined here is shared with the
*real* data plane (``repro_torch.core.distributed_ivf.search_with_retry``),
where a faulting shard probe is retried with exponential backoff and
finally skipped so the wave degrades instead of dying.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule for shard probe retries.

    ``jitter="none"`` (default) keeps the classic deterministic
    exponential schedule.  ``jitter="decorrelated"`` switches
    :meth:`next_backoff` to decorrelated jitter — each sleep is drawn
    uniformly from ``[base_ms, 3 * previous_sleep]`` (capped at
    ``max_ms``) — which de-synchronises retry storms: when a shard
    fault hits many queries at once, deterministic backoff re-dispatches
    them all on the same beat, re-spiking the shard, while decorrelated
    draws spread the herd across the window.

    ``budget_ms`` is a PER-QUERY cap on *total* backoff sleep across
    all shards: once a query has burned its budget waiting, a faulting
    shard is skipped immediately (lost clusters accounted, rung
    "budget") instead of waiting out more retries — total stall is
    bounded even when every shard is sick.  ``inf`` (default) keeps
    pre-budget behavior.
    """
    max_retries: int = 3         # attempts = max_retries + 1
    base_ms: float = 1.0
    multiplier: float = 2.0
    max_ms: float = 1000.0
    jitter: str = "none"         # "none" | "decorrelated"
    budget_ms: float = float("inf")

    def __post_init__(self):
        if self.max_retries < 0 or self.base_ms < 0 \
                or self.multiplier < 1.0:
            raise ValueError(
                f"invalid RetryPolicy(max_retries={self.max_retries}, "
                f"base_ms={self.base_ms}, multiplier={self.multiplier})")
        if self.jitter not in ("none", "decorrelated"):
            raise ValueError(
                f"jitter must be 'none' or 'decorrelated', got "
                f"{self.jitter!r}")
        if self.budget_ms <= 0:
            raise ValueError(
                f"budget_ms must be positive (use inf for unbounded), "
                f"got {self.budget_ms}")

    def backoff_ms(self, attempt: int) -> float:
        """Deterministic backoff before retry ``attempt`` (0-based
        first retry) — the ``jitter="none"`` schedule."""
        return min(self.base_ms * self.multiplier ** attempt,
                   self.max_ms)

    def next_backoff(self, attempt: int, prev_ms: float,
                     rng: Optional[np.random.Generator] = None) -> float:
        """Backoff before retry ``attempt`` given the previous sleep.

        With ``jitter="none"`` this is exactly :meth:`backoff_ms`
        (``prev_ms``/``rng`` ignored), so existing deterministic
        callers and tests are unchanged.  With
        ``jitter="decorrelated"`` it draws uniform
        ``[base_ms, 3 * prev_ms]`` (AWS decorrelated jitter), seeded
        by the caller's ``rng``; ``prev_ms <= 0`` (first retry) starts
        the chain at ``base_ms``.
        """
        if self.jitter == "none":
            return self.backoff_ms(attempt)
        if rng is None:
            rng = np.random.default_rng(0)
        lo = self.base_ms
        hi = max(lo, 3.0 * (prev_ms if prev_ms > 0 else lo))
        return min(float(rng.uniform(lo, hi)), self.max_ms)


@dataclass
class WaveStats:
    waves: int = 0
    redispatches: int = 0
    completed: int = 0
    pending: int = 0             # queries still unserved at max_waves
    p50_ms: float = 0.0
    p99_ms: float = 0.0


def run_waves(n_queries: int, n_shards: int,
              latency_sampler: Callable[[np.random.Generator, int], float],
              *, deadline_ms: float, wave_size: int, seed: int = 0,
              max_waves: int = 10_000) -> WaveStats:
    """Simulate wave dispatch with straggler re-dispatch.

    latency_sampler(rng, shard) -> per-wave shard latency (ms). A query
    slice completes when some wave's owning shard meets the deadline.
    """
    rng = np.random.default_rng(seed)
    pending = list(range(n_queries))
    done_at: Dict[int, float] = {}
    t = 0.0
    stats = WaveStats()
    while pending and stats.waves < max_waves:
        wave = pending[: wave_size * n_shards]
        pending = pending[wave_size * n_shards:]
        slices = np.array_split(np.asarray(wave), n_shards)
        lat = np.array([latency_sampler(rng, s) for s in range(n_shards)])
        wave_t = min(np.max(lat), deadline_ms)
        for s, sl in enumerate(slices):
            if lat[s] <= deadline_ms:
                for q in sl:
                    done_at[q] = t + lat[s]
            else:
                stats.redispatches += len(sl)
                pending = list(sl) + pending     # retry first, next wave
        t += wave_t
        stats.waves += 1
    lats = np.array(list(done_at.values()))
    stats.completed = len(done_at)
    # queries still pending when max_waves ran out would otherwise
    # silently vanish from the completion stats — surface them
    stats.pending = len(pending)
    if len(lats):
        stats.p50_ms = float(np.percentile(lats, 50))
        stats.p99_ms = float(np.percentile(lats, 99))
    return stats
