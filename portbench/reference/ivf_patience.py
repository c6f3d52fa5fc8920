"""The plain patience IVF search: what the served answers are held to.

A frozen restatement of the paper's semantics (Busolin et al., CIKM'24,
patience exit), written from the description and independent of the
program: plain PyTorch, in float64 by default.

For each query: rank the centroids by inner product (ties to the lower
list), then probe lists in that order.  Probe ``h`` (0-based) scores
the list's live rows (ids >= 0) and merges them into the running top-k
(by score, then by id, both descending).  ``kept`` counts the entries of
the running top-k before the probe that hold a document and are still
in it after; phi = 100 * kept / k.  The patience counter grows by one
when ``h >= 1`` and phi >= Phi, and is reset to 0 otherwise.  The search
exits after probe ``h`` when the counter reaches Delta or ``h + 1``
reaches N; it reports ``h + 1`` probes and the top-k as it stands.

It imports nothing of the program; it reads only the corpus and the
queries the benchmark made.  It works in blocks of queries, so the
tiles of a block are the most it holds at once.

``tf32=True`` computes in TF32 instead: every input rounded to TF32's
10-bit mantissa, products and sums in float32 with TF32 matmuls off.
That is the control: the nearest precision below the float32 the
configurations state.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

NEG = float("-inf")


@dataclasses.dataclass
class Reference:
    order: torch.Tensor      # (B, N) int64 lists in probe order
    probes: torch.Tensor     # (B,) int64 probes at the patience exit
    ids: torch.Tensor        # (B, N, k) int64 top-k after each probe
    scores: torch.Tensor     # (B, N, k) top-k scores after each probe


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    kept in f32."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


@contextmanager
def exact_f32():
    """float32 products without TF32, whatever the process set."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _cast(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    return round_tf32(x) if tf32 else x.double()


def centroid_order(queries, centroids, n_probe: int, *, tf32=False,
                   block: int = 1024) -> torch.Tensor:
    """(B, n_probe) int64: lists by descending inner product, ties to
    the lower list."""
    out = []
    c = _cast(centroids, tf32)
    with exact_f32():
        for s in range(0, queries.shape[0], block):
            sims = _cast(queries[s:s + block], tf32) @ c.T
            _, idx = torch.sort(sims, dim=1, descending=True, stable=True)
            out.append(idx[:, :n_probe])
    return torch.cat(out)


def _merge(run_s, run_i, new_s, new_i, k):
    """Top-k of the running and the new entries by (score, id) both
    descending; returns the top-k and which of them were running."""
    s = torch.cat([run_s, new_s], 1)
    i = torch.cat([run_i, new_i], 1)
    old = torch.zeros_like(i, dtype=torch.bool)
    old[:, :run_i.shape[1]] = run_i >= 0
    by_id = torch.argsort(i, dim=1, descending=True, stable=True)
    s, i, old = (t.gather(1, by_id) for t in (s, i, old))
    by_s = torch.argsort(s, dim=1, descending=True, stable=True)[:, :k]
    return s.gather(1, by_s), i.gather(1, by_s), old.gather(1, by_s)


def list_scores(q, lists, docs, doc_ids, offsets, sizes, lane, tf32: bool):
    """Each query of ``q`` (already cast) against the live rows of its
    list of ``lists``: (b, list_pad) scores, -inf past the list and on
    ids -1, and the ids there, -1 likewise."""
    rows = offsets[lists].long()[:, None] + lane
    ids = doc_ids[rows].long()
    live = (lane < sizes[lists].long()[:, None]) & (ids >= 0)
    tile = _cast(docs[rows], tf32)                     # (b, pad, d)
    sc = torch.bmm(tile, q[:, :, None])[:, :, 0]
    return torch.where(live, sc, NEG), torch.where(live, ids, -1)


def patience(ctr, old, run_i, h: int, k: int, phi: float):
    """The patience counter after probe ``h``: one more where ``h >= 1``
    and phi = 100 kept / k >= Phi, else 0; ``kept`` counts the entries of
    the running top-k before the probe that hold a document and are
    still in it (``old`` from :func:`_merge`)."""
    kept = (old & (run_i >= 0)).sum(1)
    ok = (h >= 1) & (100.0 * kept / k >= phi)
    return torch.where(ok, ctr + 1, 0)


def search(queries, docs, doc_ids, offsets, sizes, centroids, *, k: int,
           n_probe: int, delta: int, phi: float, list_pad: int,
           tf32: bool = False, block: int = 256) -> Reference:
    """Patience search of every query over all ``n_probe`` probes, the
    top-k kept after each probe, the exit probe count beside it."""
    dev = queries.device
    order = centroid_order(queries, centroids, n_probe, tf32=tf32)
    lane = torch.arange(list_pad, device=dev)
    fdt = torch.float32 if tf32 else torch.float64
    all_ids, all_s, all_p = [], [], []
    with exact_f32():
        for s0 in range(0, queries.shape[0], block):
            q = _cast(queries[s0:s0 + block], tf32)
            b = q.shape[0]
            run_s = torch.full((b, k), NEG, dtype=fdt, device=dev)
            run_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
            ctr = torch.zeros(b, dtype=torch.int64, device=dev)
            probes = torch.full((b,), n_probe, dtype=torch.int64,
                                device=dev)
            done = torch.zeros(b, dtype=torch.bool, device=dev)
            snap_i, snap_s = [], []
            for h in range(n_probe):
                sc, ids = list_scores(q, order[s0:s0 + b, h], docs, doc_ids,
                                      offsets, sizes, lane, tf32)
                run_s, run_i, old = _merge(run_s, run_i, sc, ids, k)
                ctr = patience(ctr, old, run_i, h, k, phi)
                exit_now = ~done & ((ctr >= delta) | (h + 1 >= n_probe))
                probes = torch.where(exit_now, h + 1, probes)
                done |= exit_now
                snap_i.append(run_i)
                snap_s.append(run_s)
            all_ids.append(torch.stack(snap_i, 1))
            all_s.append(torch.stack(snap_s, 1))
            all_p.append(probes)
    return Reference(order, torch.cat(all_p), torch.cat(all_ids),
                     torch.cat(all_s))


@dataclasses.dataclass
class Margins:
    boundary: torch.Tensor   # (B, N) k-th less (k+1)-th best score so far
    centroid: torch.Tensor   # (B, N) a probe's centroid score less the next


def margins(queries, docs, doc_ids, offsets, sizes, centroids, *, k: int,
            n_probe: int, list_pad: int) -> Margins:
    """Float64 margins within which rounding can change the search.
    ``boundary``: after each probe, the k-th best score over the lists
    probed so far less the (k+1)-th (inf while fewer than k+1 documents
    were seen); under the rounding of a float32 inner product, a float32
    search can keep another top-k there, and so count another ``kept``.
    ``centroid``: each probe's centroid score less the next list's;
    under that rounding it can probe the two in the other order."""
    r = search(queries, docs, doc_ids, offsets, sizes, centroids, k=k + 1,
               n_probe=n_probe, delta=n_probe + 1, phi=101.0,
               list_pad=list_pad)
    s = r.scores
    boundary = torch.where(torch.isinf(s[:, :, k]), float("inf"),
                           s[:, :, k - 1] - s[:, :, k])
    return Margins(boundary, centroid_gaps(queries, centroids, n_probe))


def centroid_gaps(queries, centroids, n_probe: int) -> torch.Tensor:
    """(B, n_probe) float64: each probe's centroid score less the next
    list's."""
    with exact_f32():
        sims = queries.double() @ centroids.double().T
    top = torch.topk(sims, min(n_probe + 1, sims.shape[1]), dim=1).values
    return (top[:, :-1] - top[:, 1:])[:, :n_probe]


def doc_scores(queries, docs, id_rows, ids) -> torch.Tensor:
    """(B, k) float64 inner products of each query with the documents
    ``ids`` names; -inf where the id is -1."""
    valid = ids >= 0
    rows = id_rows[ids.clamp(min=0)]
    with exact_f32():
        s = torch.bmm(docs[rows].double(),
                      queries.double()[:, :, None])[:, :, 0]
    return torch.where(valid, s, NEG)
