"""Batched Lloyd k-means in PyTorch (the IVF coarse quantizer).

Port of ``repro.core.kmeans``.  The assignment step is a blocked
matmul; the update step sums each cluster's rows in a fixed order: a
stable sort by assignment followed by ``torch.segment_reduce``, which
adds every segment's rows one after another.  Unlike ``index_add_``
on CUDA (atomics, an order that changes from run to run) this gives
the same centroids bit for bit on every run, which ``retrain``
promises.  ``sharded_assign_step`` distributes the assignment over the
``data`` axis of a ``DeviceMesh`` for corpus-scale builds.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.distributed.collectives import all_gather, all_reduce
from repro_torch.launch.mesh import axis_group


def _assign_block(x: torch.Tensor, centroids: torch.Tensor,
                  block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment by inner product, blocked over rows.
    Ties go to the first maximum, as ``jnp.argmax`` does."""
    n = x.shape[0]
    c_sq = torch.sum(centroids * centroids, dim=1)
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    best = torch.empty(n, dtype=x.dtype, device=x.device)
    for s in range(0, n, max(1, min(block, n))):
        xb = x[s: s + block]
        # squared L2 = |x|^2 - 2 x.c + |c|^2 ; |x|^2 constant per row
        sims = xb @ centroids.T - 0.5 * c_sq[None, :]
        best[s: s + block], a = torch.max(sims, dim=1)
        assign[s: s + block] = a.to(torch.int32)
    return assign, best


def _partial_stats(x: torch.Tensor, assign: torch.Tensor, n_clusters: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each cluster's (sum of rows, count), the rows summed in order."""
    order = torch.sort(assign, stable=True).indices
    counts = torch.bincount(assign, minlength=n_clusters)
    sums = torch.segment_reduce(x[order], "sum", lengths=counts, axis=0)
    return sums, counts


def _new_centroids(sums: torch.Tensor, counts: torch.Tensor,
                   centroids: torch.Tensor) -> torch.Tensor:
    """Means from (sum, count); empty clusters keep their old centroid."""
    new = sums / torch.clamp_min(counts.to(sums.dtype), 1.0)[:, None]
    return torch.where((counts > 0)[:, None], new, centroids)


def _update(x: torch.Tensor, assign: torch.Tensor,
            centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd update; empty clusters keep their old centroid."""
    return _new_centroids(*_partial_stats(x, assign, centroids.shape[0]),
                          centroids)


def kmeans_fit(x: torch.Tensor, init: torch.Tensor, *, n_clusters: int,
               n_iters: int = 10, block: int = 4096
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations from ``init`` centroids. Returns (centroids,
    assign) on ``x``'s device."""
    if init.shape[0] != n_clusters:
        raise ValueError(f"init has {init.shape[0]} rows, expected "
                         f"{n_clusters}")
    centroids = init
    for _ in range(n_iters):
        assign, _ = _assign_block(x, centroids, block)
        centroids = _update(x, assign, centroids)
    assign, _ = _assign_block(x, centroids, block)
    return centroids, assign


def kmeans(x: torch.Tensor, n_clusters: int, *, n_iters: int = 10,
           seed: int = 0, block: int = 4096
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random-sample init (FAISS default, numpy ``default_rng(seed)``,
    as the reference draws it) + Lloyd on ``x``'s device."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = rng.choice(n, size=min(n_clusters, n), replace=False)
    init = x[torch.as_tensor(idx, device=x.device)]
    if init.shape[0] < n_clusters:  # corpus smaller than C: jitter duplicates
        pick = rng.integers(0, init.shape[0], n_clusters - init.shape[0])
        jitter = rng.normal(0, 1e-3, (pick.size, x.shape[1]))
        extra = init.cpu().numpy()[pick] + jitter.astype(np.float32)
        init = torch.cat([init, torch.as_tensor(extra, device=x.device)])
    return kmeans_fit(x, init, n_clusters=n_clusters, n_iters=n_iters,
                      block=block)


def retrain(x: torch.Tensor, centroids: torch.Tensor, *, n_iters: int = 4,
            block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warm-start Lloyd re-fit for background re-clustering: starts from
    the serving centroids and keeps the cluster count fixed (no
    ``split_oversized``).  Deterministic: the same (corpus, centroids,
    n_iters) always yields the same result.  An empty corpus returns
    the input centroids unchanged."""
    if x.shape[0] == 0:
        return centroids.clone(), torch.zeros(0, dtype=torch.int32,
                                              device=x.device)
    return kmeans_fit(x, centroids, n_clusters=centroids.shape[0],
                      n_iters=n_iters, block=block)


def sharded_assign_step(mesh, data_axis: str = "data"):
    """The assignment and partial-statistics step of corpus-scale k-means
    over a ``DeviceMesh``.  Every rank of the mesh calls this and then
    the returned ``step(x, centroids) -> (new_centroids, assign)`` with
    its block of rows (``launch.mesh.local_block`` over the data group)
    and the whole (C, d) centroids: it assigns its rows, computes the
    partial (sum, count) statistics, all-reduces them over ``data_axis``
    and returns the global Lloyd update and the whole assignment, on
    every rank.  On one rank it is ``_update(x, _assign_block(x, c)[0],
    c)`` bit for bit."""
    data = axis_group(mesh, data_axis)

    def step(x: torch.Tensor, centroids: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        assign, _ = _assign_block(x, centroids, 4096)
        sums, counts = _partial_stats(x, assign, centroids.shape[0])
        sums = all_reduce(sums, data)
        counts = all_reduce(counts, data)
        return (_new_centroids(sums, counts, centroids),
                all_gather(assign, data).reshape(-1))

    return step


def split_oversized(x: np.ndarray, centroids: np.ndarray, assign: np.ndarray,
                    max_size: int, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Recursively 2-means-split clusters larger than ``max_size`` (host
    NumPy, as in the reference), so every inverted list fits one
    ``(list_pad, d)`` tile."""
    rng = np.random.default_rng(seed)
    centroids = list(np.asarray(centroids))
    assign = np.asarray(assign).copy()
    counts = np.bincount(assign, minlength=len(centroids))
    queue = [int(c) for c in np.nonzero(counts > max_size)[0]]
    while queue:
        c = queue.pop()
        members = np.nonzero(assign == c)[0]
        if members.size <= max_size:
            continue
        pts = x[members]
        # cheap 2-means: two random seeds, 4 Lloyd iterations
        seeds = pts[rng.choice(pts.shape[0], 2, replace=False)].copy()
        for _ in range(4):
            d0 = ((pts - seeds[0]) ** 2).sum(1)
            d1 = ((pts - seeds[1]) ** 2).sum(1)
            m1 = d1 < d0
            if m1.all() or (~m1).all():   # degenerate: split in half
                m1 = np.zeros(pts.shape[0], bool)
                m1[: pts.shape[0] // 2] = True
            seeds[0] = pts[~m1].mean(0)
            seeds[1] = pts[m1].mean(0)
        new_id = len(centroids)
        centroids[c] = seeds[0]
        centroids.append(seeds[1])
        assign[members[m1]] = new_id
        n1 = int(m1.sum())
        for cc, size in ((c, members.size - n1), (new_id, n1)):
            if size > max_size:
                queue.append(cc)
    return np.stack(centroids).astype(np.float32), assign
