"""The plain patience IVF search over a live corpus: what the answers of
a live cell are held to.

A live cell mutates the corpus between the waves of its ``serve()``
calls (``portbench/mutations.py``).  Waves are counted over the whole
run; a mutation made after wave ``g`` is published then, so every probe
from wave ``g + 1`` on sees it.  The reference replays that overlay.
Probe ``h`` of a query admitted at wave ``a`` runs in wave
``v = a + h // chunk`` (a lane advances ``chunk`` probes a wave) and
scores

- the base rows of its list whose id was not deleted before ``v``;
- the added vectors assigned to its list (nearest centroid: the largest
  x.c - |c|^2 / 2 in float64, ties to the lower list) that were added
  before ``v`` and not deleted before ``v``;

and at the top of each wave (``h % chunk == 0``) the running top-k drops
every id deleted before ``v``.  All else is ``ivf_patience.search``: the
probe order, the merge rule and the patience rule, in float64, or in
TF32 for the control.  With an empty overlay it is
``ivf_patience.search`` bit for bit.

It imports nothing of the program.  The overlay holds what the benchmark
made, the added vectors regenerated from the seed, and the waves of the
mutations, taken from the stream's log of ids.
"""
from __future__ import annotations

import dataclasses

import torch

from .ivf_patience import (NEG, Margins, Reference, _cast, _merge,
                           centroid_gaps, centroid_order, exact_f32,
                           patience)

# the wave of a mutation that was never made
NEVER = 2 ** 62


@dataclasses.dataclass
class Overlay:
    """The mutations of a run as the reference reads them."""
    vecs: torch.Tensor      # (A, d) f32 added vectors, the i-th id n_base + i
    added: torch.Tensor     # (A,) int64 wave after which each was added
    deleted: torch.Tensor   # (n_base + A,) int64 wave after which each id
    #                         was deleted, NEVER where it was not
    n_base: int

    @property
    def n_ids(self) -> int:
        return self.deleted.shape[0]


def assign(vecs, centroids, *, tf32: bool = False, block: int = 4096):
    """(A,) int64 nearest centroid of each vector (ties to the lower
    list), (A,) float64 the margin to the next nearest (inf with one
    centroid) and (A,) int64 that next nearest."""
    c = _cast(centroids, tf32)
    half = 0.5 * (c * c).sum(1)
    best, margin, runner = [], [], []
    dev = vecs.device
    with exact_f32():
        for s in range(0, vecs.shape[0], block):
            sims = _cast(vecs[s:s + block], tf32) @ c.T - half
            best.append(torch.max(sims, dim=1).indices)
            if sims.shape[1] < 2:
                margin.append(torch.full((sims.shape[0],), float("inf"),
                                         dtype=torch.float64, device=dev))
                runner.append(best[-1])
                continue
            top = torch.topk(sims, 2, dim=1)
            margin.append((top.values[:, 0] - top.values[:, 1]).double())
            runner.append(torch.where(top.indices[:, 0] == best[-1],
                                      top.indices[:, 1], top.indices[:, 0]))
    if not best:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.float64, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    return torch.cat(best), torch.cat(margin), torch.cat(runner)


def by_list(lists: torch.Tensor, n_lists: int) -> torch.Tensor:
    """(L, m) int64: the adds assigned to each list in id order, -1
    past its count (m the most any list holds)."""
    dev = lists.device
    order = torch.sort(lists, stable=True).indices
    cnt = torch.bincount(lists, minlength=n_lists)
    m = int(cnt.max()) if lists.numel() else 0
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(lists.numel(), device=dev) - start[lists[order]]
    table = torch.full((n_lists, m), -1, dtype=torch.int64, device=dev)
    table[lists[order], rank] = order
    return table


def search(queries, admit, docs, doc_ids, offsets, sizes, centroids,
           overlay: Overlay, *, k: int, n_probe: int, delta: int,
           phi: float, list_pad: int, chunk: int, tf32: bool = False,
           block: int = 256) -> Reference:
    """Patience search of each query, admitted at wave ``admit`` ((B,)
    int64), over all ``n_probe`` probes of the corpus each probe saw;
    the top-k kept after each probe, the exit probe count beside it."""
    dev = queries.device
    order = centroid_order(queries, centroids, n_probe, tf32=tf32)
    lane = torch.arange(list_pad, device=dev)
    fdt = torch.float32 if tf32 else torch.float64
    table = by_list(assign(overlay.vecs, centroids, tf32=tf32)[0],
                    centroids.shape[0])
    added, deleted = overlay.added, overlay.deleted
    all_ids, all_s, all_p = [], [], []
    with exact_f32():
        for s0 in range(0, queries.shape[0], block):
            q = _cast(queries[s0:s0 + block], tf32)
            b = q.shape[0]
            wave0 = admit[s0:s0 + block].to(dev)[:, None]
            run_s = torch.full((b, k), NEG, dtype=fdt, device=dev)
            run_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
            ctr = torch.zeros(b, dtype=torch.int64, device=dev)
            probes = torch.full((b,), n_probe, dtype=torch.int64,
                                device=dev)
            done = torch.zeros(b, dtype=torch.bool, device=dev)
            snap_i, snap_s = [], []
            for h in range(n_probe):
                v = wave0 + h // chunk                         # (b, 1)
                if h % chunk == 0:
                    gone = (run_i >= 0) & (deleted[run_i.clamp(min=0)] < v)
                    run_s = torch.where(gone, NEG, run_s)
                    run_i = torch.where(gone, -1, run_i)
                lists = order[s0:s0 + b, h]
                rows = offsets[lists].long()[:, None] + lane
                ids = doc_ids[rows].long()
                live = (lane < sizes[lists].long()[:, None]) & (ids >= 0) \
                    & (deleted[ids.clamp(min=0)] >= v)
                tile = _cast(docs[rows], tf32)             # (b, pad, d)
                sc = torch.bmm(tile, q[:, :, None])[:, :, 0]
                sc = torch.where(live, sc, NEG)
                ids = torch.where(live, ids, -1)
                if table.shape[1]:
                    j = table[lists]                        # (b, m)
                    jc = j.clamp(min=0)
                    aid = overlay.n_base + jc
                    seen = (j >= 0) & (added[jc] < v) & (deleted[aid] >= v)
                    asc = torch.bmm(_cast(overlay.vecs[jc], tf32),
                                    q[:, :, None])[:, :, 0]
                    sc = torch.cat([sc, torch.where(seen, asc, NEG)], 1)
                    ids = torch.cat([ids, torch.where(seen, aid, -1)], 1)
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


def margins(queries, admit, docs, doc_ids, offsets, sizes, centroids,
            overlay: Overlay, *, k: int, n_probe: int, list_pad: int,
            chunk: int) -> Margins:
    """``ivf_patience.margins`` over the corpus each probe saw."""
    r = search(queries, admit, docs, doc_ids, offsets, sizes, centroids,
               overlay, k=k + 1, n_probe=n_probe, delta=n_probe + 1,
               phi=101.0, list_pad=list_pad, chunk=chunk)
    s = r.scores
    boundary = torch.where(torch.isinf(s[:, :, k]), float("inf"),
                           s[:, :, k - 1] - s[:, :, k])
    return Margins(boundary, centroid_gaps(queries, centroids, n_probe))


def doc_scores(queries, docs, id_rows, overlay: Overlay, ids
               ) -> torch.Tensor:
    """(B, k) float64 inner products of each query with the documents
    ``ids`` names, base or added; -inf where the id is -1."""
    valid = ids >= 0
    n_base, n_add = overlay.n_base, overlay.vecs.shape[0]
    vecs = docs[id_rows[ids.clamp(0, n_base - 1)]]
    if n_add:
        extra = overlay.vecs[(ids - n_base).clamp(0, n_add - 1)]
        vecs = torch.where((ids >= n_base)[..., None], extra, vecs)
    with exact_f32():
        s = torch.bmm(vecs.double(), queries.double()[:, :, None])[:, :, 0]
    return torch.where(valid, s, NEG)
