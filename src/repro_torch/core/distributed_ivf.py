"""Sharded IVF search (port of ``repro.core.distributed_ivf``):
clusters sharded over ``model``, queries over the DP axes.

Each shard owns ~C/S clusters (round-robin by size rank, which balances
list bytes).  Two data planes read the same ``ShardedIVF``:

- ``search_with_retry`` fans a query batch over the shards on one
  device: each shard scans its top-``ceil(n_probe/S)`` local clusters,
  a faulting shard is retried with backoff and finally skipped, and the
  per-shard top-k candidates are merged on the host's call.
- ``make_distributed_search`` is the mesh search over
  ``torch.distributed``: the rank at model index m holds shard m, and
  one *distributed probe step* probes each shard's next ``probe_width``
  local clusters; the per-shard top-k candidates are all-gathered over
  the model group (k entries each — tiny) and merged identically on
  every rank, so patience decisions match the single-host semantics on
  the merged result set.

``quantize_sharded`` stores the docs as int8 rows with a scale each;
``abstract_sharded`` gives the shapes and dtypes on the ``meta`` device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.ivf import (IVFIndex, as_queries, intersection_pct,
                                  merge_topk, top_k)
from repro_torch.distributed.collectives import all_gather, all_reduce
from repro_torch.kernels.ivf_scan import score_rows
from repro_torch.launch.mesh import axis_group, axis_index, local_block
from repro_torch.runtime.straggler import RetryPolicy


@dataclasses.dataclass
class ShardedIVF:
    """Host-side container of per-shard stacked arrays (leading S dim)."""
    centroids: np.ndarray   # (S, Cs, d); padding centroids = +inf-far
    docs: np.ndarray        # (S, n_pad, d) f32/bf16/int8
    doc_ids: np.ndarray     # (S, n_pad)
    offsets: np.ndarray     # (S, Cs)
    sizes: np.ndarray       # (S, Cs)
    list_pad: int
    n_shards: int
    doc_scales: "np.ndarray | None" = None  # (S, n_pad) int8 row scales


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


def abstract_sharded(n_docs: int, dim: int, n_clusters: int, list_pad: int,
                     n_shards: int, dtype: torch.dtype = torch.float32
                     ) -> ShardedIVF:
    """The stacked arrays' shapes and dtypes as ``meta`` tensors (no
    storage): ``n_docs // S + 2 * list_pad`` rows a shard, bf16
    centroids and f32 row scales when the docs are int8."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    cs = int(np.ceil(n_clusters / n_shards))
    rows = n_docs // n_shards + 2 * list_pad
    int8 = dtype == torch.int8
    return ShardedIVF(
        meta((n_shards, cs, dim), torch.bfloat16 if int8 else dtype),
        meta((n_shards, rows, dim), dtype),
        meta((n_shards, rows), torch.int32),
        meta((n_shards, cs), torch.int32),
        meta((n_shards, cs), torch.int32), list_pad, n_shards,
        meta((n_shards, rows), torch.float32) if int8 else None)


def quantize_sharded(sh: ShardedIVF) -> ShardedIVF:
    """Symmetric per-row int8 quantisation of the doc store: scores are
    corrected by the row scale *after* the dot, so the doc stream is 4x
    smaller than f32.  NumPy, as the reference computes it (``np.round``
    rounds half to even), so the arrays equal the reference's."""
    docs = np.asarray(sh.docs, np.float32)
    scale = np.maximum(np.abs(docs).max(-1), 1e-8) / 127.0
    q = np.clip(np.round(docs / scale[..., None]), -127, 127) \
        .astype(np.int8)
    return ShardedIVF(sh.centroids.astype(np.float32), q, sh.doc_ids,
                      sh.offsets, sh.sizes, sh.list_pad, sh.n_shards,
                      scale.astype(np.float32))


class DistSearchResult(NamedTuple):
    topk_scores: torch.Tensor   # (B, k)
    topk_ids: torch.Tensor      # (B, k)
    probes: torch.Tensor        # (B,) clusters scanned (global count)


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
    merged by the plain ``merge_topk``, as the reference scores them
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
        ts, ti = merge_topk(ts, ti, sc, ids, k)
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
    q = as_queries(queries, dev)
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


# -- the mesh search ----------------------------------------------------------

def local_shard(sh: ShardedIVF, mesh, model_axis: Union[str, Sequence[str]]
                = "model") -> ShardedIVF:
    """This rank's shard of ``sh``: the (1, ...) block of every stacked
    array at the rank's index along ``model_axis``, as a ``shard_map``
    in_spec partitioned over ``model`` hands it one device, copied into
    memory: of memory-mapped arrays only that block is read.  Every rank
    of the mesh calls it."""
    model = axis_group(mesh, model_axis)
    if model.size() != sh.n_shards:
        raise ValueError(f"{sh.n_shards} shards on a model axis of "
                         f"{model.size()} ranks")

    def block(x):
        return None if x is None else np.array(local_block(x, model))

    return ShardedIVF(block(sh.centroids), block(sh.docs),
                      block(sh.doc_ids), block(sh.offsets), block(sh.sizes),
                      sh.list_pad, 1, block(sh.doc_scales))


def make_distributed_search(mesh, *, n_probe: int, k: int,
                            patience_delta: Optional[int] = None,
                            patience_phi: float = 95.0,
                            list_pad: int,
                            model_axis: Union[str, Sequence[str]] = "model",
                            dp_axes: Sequence[str] = ("data",),
                            unroll_steps: Optional[int] = None,
                            probe_width: int = 1,
                            int8_docs: bool = False,
                            device: DeviceLike = None):
    """The adaptive search over a (data x model) ``DeviceMesh``, on
    ``device`` (CUDA unless ``device="cpu"``).  ``patience_delta=None``
    is the fixed-N baseline.  Every rank of the mesh calls this and then
    the returned

        fn(centroids, docs, doc_ids, offsets, sizes, queries,
           doc_scales=None) -> DistSearchResult

    with its shard's (1, ...) blocks (``local_shard``; host arrays or
    tensors, copied to ``device``; ``doc_scales`` with ``int8_docs``)
    and the whole (B, d) query batch, B a multiple of the DP ranks.
    Each DP rank searches its block of B / n_dp queries; the result
    comes back whole, (B, k) and (B,), on every rank, as the
    reference's ``out_specs`` assemble it.

    Each step every shard scans its next ``probe_width`` local clusters
    (one gather and product), merges them into its running top-k, and
    the model group all-gathers those (B, k) sets and merges them
    ``(S, B, k) -> (B, S k)`` with the stable ``top_k`` (ties to the
    lower position, as ``lax.top_k``); patience runs on the merged set.
    The steps end, as the reference's ``while_loop`` does, when every
    query exited or the budget is spent; the flag is reduced over the
    model group, so every rank takes the same decision even if their
    flags disagree.
    ``unroll_steps`` runs that many steps with no exit.  Per call,
    ``fn.stats`` counts the steps and the bytes each rank received by
    all-gather and sent to all-reduce."""
    dev = resolve_device(device)
    model = axis_group(mesh, model_axis)
    dp = axis_group(mesh, dp_axes)
    s_total = model.size()
    w = probe_width
    n_steps = int(np.ceil(n_probe / (s_total * w)))

    def tensor(x):
        return torch.as_tensor(x, device=dev)

    def fn(centroids, docs, doc_ids, offsets, sizes, queries,
           doc_scales=None) -> DistSearchResult:
        if (doc_scales is not None) != int8_docs:
            raise ValueError("doc_scales goes with int8_docs=True, and only "
                             "with it")
        blocks = [centroids, docs, doc_ids, offsets, sizes] + \
            ([doc_scales] if int8_docs else [])
        if any(x.shape[0] != 1 for x in blocks):
            raise ValueError("pass this rank's (1, ...) shard blocks "
                             "(local_shard)")
        # local blocks keep the sharded leading dim as size 1 — squeeze
        centroids, docs, doc_ids, offsets, sizes = (
            tensor(x[0]) for x in blocks[:5])
        scales = tensor(doc_scales[0]) if int8_docs else None
        q = local_block(tensor(queries), dp)
        b = q.shape[0]
        cs = centroids.shape[0]
        last = docs.shape[0] - list_pad     # a slice's start stays in bounds
        lane = torch.arange(list_pad, device=dev)
        # queries in the centroids' dtype; bf16 products are exact in f32
        q = q.to(centroids.dtype).float()
        csims = q @ centroids.float().T                       # (b, Cs)
        n_rank = min(n_steps, max(cs // w, 1))
        _, rank = top_k(csims, min(n_rank * w, cs))
        stats = dict(steps=0, gather_bytes=0, reduce_bytes=0)

        def probe(h: int):
            # probe_width clusters per step: one merge and all-gather
            # amortised over w scans; the clamp repeats the last ranked
            # cluster when Cs < w, as the reference does
            base = (h * w + torch.arange(w, device=dev)).clamp(
                max=rank.shape[1] - 1)
            cids = rank[:, base].long()                        # (b, w)
            rows = offsets[cids].long().clamp(0, last)[..., None] + lane
            szs = sizes[cids]
            ids = doc_ids[rows]                                # (b, w, L)
            m = lane < szs[..., None]
            tiles = docs[rows]                                 # (b,w,L,d)
            if int8_docs:
                # int8 -> bf16 is exact, as are products of two bf16
                # values in f32: the reference's bf16 dot with f32
                # accumulation; the row scale is applied after the dot
                sc = torch.einsum("bwld,bd->bwl",
                                  tiles.to(torch.bfloat16).float(),
                                  q.to(torch.bfloat16).float())
                sc = sc * scales[rows]
            else:
                sc = torch.einsum("bwld,bd->bwl", tiles.float(), q)
            sc = torch.where(m, sc, float("-inf")).reshape(b, w * list_pad)
            ids = torch.where(m, ids, -1).reshape(b, w * list_pad)
            return sc, ids, (szs > 0).sum(1)

        def merge_global(scores, ids):
            # (b, k) local -> all-gather the tiny candidate sets (scores
            # and ids bit-packed in one f32 buffer) -> (b, k)
            packed = torch.cat([scores, ids.view(torch.float32)], 1)
            g = all_gather(packed, model)                    # (S, b, 2k)
            stats["gather_bytes"] += g.numel() * 4
            gs = g[..., :k].movedim(0, 1).reshape(b, -1)
            gi = g[..., k:].contiguous().view(torch.int32) \
                .movedim(0, 1).reshape(b, -1)
            ts, idx = top_k(gs, k)
            return ts, torch.gather(gi, 1, idx.long())

        lsc = torch.full((b, k), float("-inf"), device=dev)
        lid = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        gi = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        ctr = torch.zeros(b, dtype=torch.int32, device=dev)
        active = torch.ones(b, dtype=torch.bool, device=dev)
        probes = torch.zeros(b, dtype=torch.int32, device=dev)
        h = 0
        while (h < unroll_steps if unroll_steps is not None
               else h < n_rank):
            sc, ids, scanned = probe(min(h, n_rank - 1))
            nls, nli = merge_topk(lsc, lid, sc, ids, k)
            lsc = torch.where(active[:, None], nls, lsc)
            lid = torch.where(active[:, None], nli, lid)
            gprev, (_, gi) = gi, merge_global(lsc, lid)
            phi = intersection_pct(gprev, gi)
            if patience_delta is not None:
                ctr = torch.where((h >= 1) & (phi >= patience_phi),
                                  ctr + 1, 0)
                exited = ctr >= patience_delta
            else:
                exited = torch.zeros_like(active)
            new_active = active & ~exited & (h + 1 < n_rank)
            # one all-reduce a step: the clusters scanned (the global
            # count) and the number of ranks with a query that goes on.
            # The ranks merge the same gathered sets, so their flags
            # agree; deciding on the reduced count keeps a disagreement
            # from leaving one rank waiting in a collective
            part = torch.cat([scanned.to(torch.int32) * active,
                              new_active.any().reshape(1)])
            red = all_reduce(part.to(torch.int32), model)
            stats["reduce_bytes"] += red.numel() * 4
            probes = probes + torch.where(active, red[:b], 0)
            active = new_active
            h += 1
            if unroll_steps is None and not bool(red[b]):
                break
        stats["steps"] = h
        gs, gi = merge_global(lsc, lid)
        # the DP blocks back into the whole batch, on every rank
        out = all_gather(torch.cat([gs, gi.view(torch.float32),
                                    probes.view(torch.float32)[:, None]],
                                   1), dp).flatten(0, 1)
        fn.stats = stats
        return DistSearchResult(out[:, :k].contiguous(),
                                out[:, k: 2 * k].contiguous()
                                .view(torch.int32),
                                out[:, 2 * k].contiguous().view(torch.int32))

    fn.stats = None
    return fn
