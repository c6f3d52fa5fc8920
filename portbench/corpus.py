"""The cell's corpus, index layout and query pool, made on the device
from ``--seed``.

The recipe is ``clustered_corpus``'s Gaussian mixture with one
component per inverted list: one unit centre per list, each document its
list's centre plus isotropic noise of the list's scale, L2-normalised,
filed under the list it was drawn around.  A configuration's noise is
small enough that each document lies nearest its own centre, so the
lists are the nearest-centroid partition an IVF index holds; set-up
checks that on a sample.  List sizes follow a
lognormal law scaled to the corpus's mean, cut to ``[min, list_pad]``
and summed exactly to ``n_docs``.  The layout is ``build_index``'s:
lists cluster-major, each starting at a multiple of ``align`` rows, gap
rows id -1 and zero, ``list_pad`` spare rows at the end.  Doc ids are a
seeded permutation of ``0..n_docs-1``.  Queries mix easy ones (a
document plus small noise) and hard ones (between two centres plus
noise), as ``query_mix`` does.

Everything is drawn by one ``torch.Generator`` on the device in a fixed
sequence of calls, so a seed gives the same tensors on the same card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

# rows generated per call while the documents are filled
FILL_ROWS = 1 << 18


@dataclasses.dataclass
class Corpus:
    centroids: torch.Tensor   # (L, d) f32 unit centres
    docs: torch.Tensor        # (rows, d) f32 cluster-major
    doc_ids: torch.Tensor     # (rows,) int32, -1 on gap rows
    offsets: torch.Tensor     # (L,) int32 first row of each list
    sizes: torch.Tensor       # (L,) int32 live rows of each list
    list_pad: int
    id_rows: torch.Tensor     # (n_docs,) int64 row of each doc id
    pool: torch.Tensor        # (P, d) f32 unit queries
    scale: Optional[torch.Tensor] = None   # (L,) f32 noise std of each list

    @property
    def n_docs(self) -> int:
        return self.id_rows.shape[0]


def spread(cfg: dict) -> float:
    """Noise std per coordinate: ``spread_at_64`` at d=64 (the reference
    CLI's 0.25), rescaled so the noise norm (8 ``spread_at_64``) is the
    same at every width."""
    c = cfg["corpus"]
    return c["spread_at_64"] * math.sqrt(64 / cfg["dim"])


def list_sizes(cfg: dict, g: torch.Generator, dev) -> torch.Tensor:
    """(L,) int64 sizes in ``[min, list_pad]`` summing to ``n_docs``."""
    n, lists, top = cfg["n_docs"], cfg["n_lists"], cfg["list_pad"]
    low = cfg["corpus"]["list_size_min"]
    if not lists * low <= n <= lists * top:
        raise ValueError(f"{n} docs do not fit {lists} lists of "
                         f"{low}..{top}")
    w = torch.exp(cfg["corpus"]["list_size_sigma"]
                  * torch.randn(lists, generator=g, device=dev,
                                dtype=torch.float64))
    sizes = torch.round(w / w.mean() * (n / lists)).clamp(low, top).long()
    order = torch.randperm(lists, generator=g, device=dev)
    for _ in range(64):
        diff = n - int(sizes.sum())
        if diff == 0:
            return sizes
        room = (top - sizes) if diff > 0 else (sizes - low)
        share = room * abs(diff) // int(room.sum())
        sizes = sizes + (1 if diff > 0 else -1) * share
        left = abs(n - int(sizes.sum()))
        # the remainder, one each, to the first lists with room in a
        # seeded order
        room = ((top - sizes) if diff > 0 else (sizes - low))[order]
        take = order[(room > 0).nonzero()[:left, 0]]
        sizes[take] += 1 if diff > 0 else -1
    raise RuntimeError("list sizes did not converge")


def make(cfg: dict, pool_size: int, seed: int, dev) -> Corpus:
    d, lists, pad = cfg["dim"], cfg["n_lists"], cfg["list_pad"]
    align, n = cfg["align"], cfg["n_docs"]
    sd = spread(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    centres = torch.randn(lists, d, generator=g, device=dev)
    centres /= centres.norm(dim=1, keepdim=True)
    sizes = list_sizes(cfg, g, dev)
    lo, hi = cfg["corpus"]["scale_range"]
    scale = (lo + (hi - lo) * torch.rand(lists, generator=g, device=dev)) * sd
    aligned = (sizes + align - 1) // align * align
    offsets = torch.cumsum(aligned, 0) - aligned
    rows = int(aligned.sum()) + pad
    docs = torch.zeros(rows, d, device=dev)
    row_list = torch.repeat_interleave(
        torch.arange(lists, device=dev), aligned)
    live = (torch.arange(row_list.shape[0], device=dev)
            - offsets[row_list]) < sizes[row_list]
    for r0 in range(0, row_list.shape[0], FILL_ROWS):
        rl = row_list[r0:r0 + FILL_ROWS]
        x = torch.randn(rl.shape[0], d, generator=g, device=dev)
        x.mul_(scale[rl, None]).add_(centres[rl])
        x /= x.norm(dim=1, keepdim=True)
        x[~live[r0:r0 + FILL_ROWS]] = 0
        docs[r0:r0 + rl.shape[0]] = x
        del x
    live_rows = live.nonzero()[:, 0]
    perm = torch.randperm(n, generator=g, device=dev)
    doc_ids = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    doc_ids[live_rows] = perm.to(torch.int32)
    id_rows = torch.empty(n, dtype=torch.int64, device=dev)
    id_rows[perm] = live_rows
    pool = queries(cfg, pool_size, centres, docs, live_rows, sd, g, dev)
    return Corpus(centres, docs, doc_ids, offsets.to(torch.int32),
                  sizes.to(torch.int32), pad, id_rows, pool, scale)


def queries(cfg, m, centres, docs, live_rows, sd, g, dev) -> torch.Tensor:
    """``m`` unit queries in a seeded order: easy ones are noisy copies
    of documents, hard ones lie between two centres plus noise."""
    q = cfg["queries"]
    d = docs.shape[1]
    n_hard = int(m * q["hard_frac"])
    n_easy = m - n_hard
    src = live_rows[torch.randint(live_rows.shape[0], (n_easy,),
                                  generator=g, device=dev)]
    easy = docs[src] + q["easy_noise"] * sd * torch.randn(
        n_easy, d, generator=g, device=dev)
    c = torch.randint(centres.shape[0], (2, n_hard), generator=g,
                      device=dev)
    t = torch.rand(n_hard, 1, generator=g, device=dev)
    hard = centres[c[0]] * t + centres[c[1]] * (1 - t) \
        + sd * torch.randn(n_hard, d, generator=g, device=dev)
    out = torch.cat([easy, hard])
    out /= out.norm(dim=1, keepdim=True)
    return out[torch.randperm(m, generator=g, device=dev)].contiguous()


def own_centre_share(c: Corpus, sample: int, seed: int) -> float:
    """Share of a seeded sample of documents whose nearest centre is the
    one they were drawn around: how far filing by centre is a
    nearest-centroid assignment."""
    dev = c.docs.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ids = torch.randint(c.n_docs, (sample,), generator=g, device=dev)
    rows = c.id_rows[ids]
    own = torch.searchsorted(c.offsets.long(), rows, right=True) - 1
    near = (c.docs[rows] @ c.centroids.T).argmax(1)
    return float((near == own).float().mean())


def checksum(c: Corpus) -> tuple:
    """Exact sums of the bits of every input both sides read, to see
    afterwards that the program changed none of them (in row blocks:
    the documents are most of the card)."""
    def bits(t: torch.Tensor) -> int:
        v = t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
            else t
        v = v.reshape(v.shape[0], -1)
        return sum(int(v[r:r + FILL_ROWS].sum(dtype=torch.int64))
                   for r in range(0, v.shape[0], FILL_ROWS))
    return tuple(bits(t) for t in (c.centroids, c.docs, c.doc_ids,
                                   c.offsets, c.sizes, c.id_rows, c.pool))
