"""Sharded IVF search with per-shard retry (port of the host-coordinated
part of ``repro.core.distributed_ivf``).

Each shard owns ~C/S clusters (round-robin by size rank, which balances
list bytes).  ``search_with_retry`` fans a query batch over the shards
on one device: each shard scans its top-``ceil(n_probe/S)`` local
clusters, a faulting shard is retried with backoff and finally skipped,
and the per-shard top-k candidates are merged on the host's call.  The
mesh search (``make_distributed_search``), ``quantize_sharded`` and
``abstract_sharded`` come with the distributed slice of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.ivf import IVFIndex, _as_queries, _merge_topk, top_k
from repro_torch.kernels.ivf_scan import score_rows
from repro_torch.runtime.straggler import RetryPolicy


@dataclasses.dataclass
class ShardedIVF:
    """Host-side container of per-shard stacked arrays (leading S dim)."""
    centroids: np.ndarray   # (S, Cs, d); padding centroids = +inf-far
    docs: np.ndarray        # (S, n_pad, d) f32
    doc_ids: np.ndarray     # (S, n_pad)
    offsets: np.ndarray     # (S, Cs)
    sizes: np.ndarray       # (S, Cs)
    list_pad: int
    n_shards: int


def shard_index(index: IVFIndex, n_shards: int) -> ShardedIVF:
    """The index's lists dealt round-robin by size rank over
    ``n_shards``, each shard's lists packed back to back (no ``blk_l``
    alignment), as host arrays."""
    cent = index.centroids.cpu().numpy()
    docs = index.docs.cpu().numpy()
    ids = index.doc_ids.cpu().numpy()
    offs = index.cluster_offsets.cpu().numpy()
    sizes = index.cluster_sizes.cpu().numpy()
    c, d = cent.shape
    lp = index.list_pad
    # round-robin by size rank -> balanced bytes per shard
    order = np.argsort(-sizes, kind="stable")
    shard_of = np.empty(c, np.int32)
    shard_of[order] = np.arange(c) % n_shards
    cs = int(np.ceil(c / n_shards))
    np_rows = int(max(sizes[shard_of == s].sum()
                      for s in range(n_shards))) + lp
    s_cent = np.full((n_shards, cs, d), -1e30, np.float32)
    s_docs = np.zeros((n_shards, np_rows, d), np.float32)
    s_ids = np.full((n_shards, np_rows), -1, np.int32)
    s_offs = np.zeros((n_shards, cs), np.int32)
    s_sizes = np.zeros((n_shards, cs), np.int32)
    for s in range(n_shards):
        mine = np.nonzero(shard_of == s)[0]
        row = 0
        for j, cid in enumerate(mine):
            sz = int(sizes[cid])
            s_cent[s, j] = cent[cid]
            s_offs[s, j] = row
            s_sizes[s, j] = sz
            s_docs[s, row: row + sz] = docs[offs[cid]: offs[cid] + sz]
            s_ids[s, row: row + sz] = ids[offs[cid]: offs[cid] + sz]
            row += sz
    return ShardedIVF(s_cent, s_docs, s_ids, s_offs, s_sizes, lp, n_shards)


# -- fault-tolerant shard fan-out (host-coordinated data plane) -------------

class ShardFault(RuntimeError):
    """A shard probe failed or timed out (real or injected)."""


@dataclasses.dataclass
class ShardRetryReport:
    attempts: int = 0                  # total shard dispatches issued
    retries: int = 0                   # dispatches beyond the first try
    skipped_shards: list = dataclasses.field(default_factory=list)
    lost_clusters: int = 0             # clusters owned by skipped shards
    backoff_ms: float = 0.0            # cumulative backoff slept
    budget_ms: float = float("inf")    # per-query total-backoff budget
    budget_exhausted: bool = False     # the budget ran dry this query
    budget_skips: int = 0              # shards skipped WITHOUT waiting
    #                                    out retries once it ran dry


def _shard_local_topk(centroids, docs, doc_ids, offsets, sizes, queries,
                      *, k: int, n_local: int, list_pad: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's top-k over its ``n_local`` best local clusters.

    The shard packs its lists without ``blk_l`` alignment, so no list
    kernel applies: rows are scored by the plain ``score_rows`` and
    merged by the plain ``_merge_topk``, as the reference scores them
    outside its kernels."""
    csims = queries @ centroids.T                       # (B, Cs)
    n_rank = min(n_local, centroids.shape[0])
    _, rank = top_k(csims, n_rank)
    b = queries.shape[0]
    dev = queries.device
    ts = torch.full((b, k), float("-inf"), device=dev)
    ti = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(list_pad, device=dev)
    last = docs.shape[0] - list_pad     # a slice's start stays in bounds
    for h in range(n_rank):
        cids = rank[:, h].long()
        rows = offsets[cids].long().clamp(0, last)[:, None] + lane
        ids = doc_ids[rows]
        m = (lane[None, :] < sizes[cids][:, None]) & (ids >= 0)
        sc = torch.where(m, score_rows(queries, docs, rows), float("-inf"))
        ids = torch.where(m, ids, -1)
        ts, ti = _merge_topk(ts, ti, sc, ids, k)
    return ts, ti


def search_with_retry(sharded: ShardedIVF, queries, *, k: int,
                      n_probe: int, retry=None,
                      fault: Optional[Callable[[int, int], None]] = None,
                      sleep: Optional[Callable[[float], None]] = None,
                      rng=None, device: DeviceLike = None
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 ShardRetryReport]:
    """Fan a query batch over IVF shards with per-shard retry + skip,
    on ``device`` (CUDA unless ``device="cpu"``).

    Each shard scans its top-``ceil(n_probe/S)`` local clusters; a shard
    whose dispatch raises :class:`ShardFault` (or ``TimeoutError``) is
    retried with the backoff schedule of ``retry`` (a
    ``repro_torch.runtime.straggler.RetryPolicy``) and, after
    ``max_retries``, skipped — its clusters drop out of the candidate
    set and the loss is recorded in the returned
    :class:`ShardRetryReport` — so the wave *degrades* rather than
    dies.  Any other error (a failed launch raises ``RuntimeError``)
    propagates: it is never taken for a skipped shard.

    With ``retry.jitter="decorrelated"`` each backoff is a jittered
    draw (de-synchronising retry storms across concurrent queries);
    ``rng`` seeds it (``np.random.Generator``, defaults to a fixed
    seed for reproducibility).  ``retry.budget_ms`` caps the TOTAL
    backoff this query may sleep across all shards: once spent, a
    faulting shard is skipped immediately (``budget_skips``) instead
    of waiting out its remaining retries, so a multi-shard outage
    costs bounded latency.

    ``fault(shard, attempt)`` is the injection hook (chaos harness);
    ``sleep(ms)`` is injectable so tests and simulations don't block.
    Each shard's arrays are copied to the device once, before its
    attempts.
    """
    retry = retry or RetryPolicy()
    sleep = sleep if sleep is not None \
        else (lambda ms: time.sleep(ms / 1000.0))
    if rng is None:
        rng = np.random.default_rng(0)
    dev = resolve_device(device)
    q = _as_queries(queries, dev)
    n_local = -(-n_probe // sharded.n_shards)
    report = ShardRetryReport(budget_ms=retry.budget_ms)
    parts_s, parts_i = [], []
    for s in range(sharded.n_shards):
        arrays = [torch.as_tensor(np.asarray(a[s]), device=dev) for a in
                  (sharded.centroids, sharded.docs, sharded.doc_ids,
                   sharded.offsets, sharded.sizes)]
        arrays[:2] = [a.float() for a in arrays[:2]]
        got = None
        prev_ms = 0.0
        for attempt in range(retry.max_retries + 1):
            if attempt > 0 and report.budget_exhausted:
                # budget ran dry: degrade to skip-shard NOW rather
                # than sleeping out the remaining retries
                report.budget_skips += 1
                break
            report.attempts += 1
            if attempt > 0:
                report.retries += 1
                ms = retry.next_backoff(attempt - 1, prev_ms, rng)
                remaining = retry.budget_ms - report.backoff_ms
                if ms >= remaining:
                    ms = max(remaining, 0.0)
                    report.budget_exhausted = True
                prev_ms = ms
                report.backoff_ms += ms
                sleep(ms)
            try:
                if fault is not None:
                    fault(s, attempt)
                got = _shard_local_topk(*arrays, q, k=k, n_local=n_local,
                                        list_pad=sharded.list_pad)
                break
            except (ShardFault, TimeoutError):
                continue
        if got is None:
            report.skipped_shards.append(s)
            report.lost_clusters += int(
                (np.asarray(sharded.sizes[s]) > 0).sum())
            continue
        parts_s.append(got[0])
        parts_i.append(got[1])
    if not parts_s:
        b = q.shape[0]
        return (np.full((b, k), -np.inf, np.float32),
                np.full((b, k), -1, np.int32), report)
    cat_s = torch.cat(parts_s, dim=1)
    cat_i = torch.cat(parts_i, dim=1)
    ts, idx = top_k(cat_s, k)
    ti = torch.gather(cat_i, 1, idx.long())
    return ts.cpu().numpy(), ti.cpu().numpy(), report
