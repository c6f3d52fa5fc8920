"""IVF two-level index + batched adaptive (early-exit) A-kNN search.

Port of ``repro.core.ivf``, with the live index's delta overlay
(``search(delta=...)``; the buffer itself is in ``repro_torch.index``).
Document embeddings are stored cluster-major and every inverted list
is at most ``list_pad`` rows (oversized k-means clusters are 2-means
split at build time), so one probe scores one contiguous
``(list_pad, d)`` tile per query and merges it into the running top-k.  The reference's
``lax.while_loop`` becomes a host loop over probe chunks with a
per-query *active* mask; the loop ends when every query exited or the
probe budget is spent.

The index names the device: ``search`` runs where ``index.docs`` lies
and never copies the index.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import kmeans as km
from repro_torch.core.features import (FeatureExtras, base_columns,
                                       feature_matrix)
from repro_torch.core.policies import Policy, policy_step
from repro_torch.kernels import ops as kops
from repro_torch.kernels import row_topk as _rt
from repro_torch.kernels.delta_scan import delta_scan_plain
from repro_torch.kernels.ivf_scan import score_rows


@dataclasses.dataclass
class IVFIndex:
    """Cluster-major IVF index; every tensor on one device."""

    centroids: torch.Tensor        # (C, d) f32
    docs: torch.Tensor             # (n_pad, d) cluster-major, zero tail
    doc_ids: torch.Tensor          # (n_pad,) int32, -1 on padding
    cluster_offsets: torch.Tensor  # (C,) int32 row offset of each list
    cluster_sizes: torch.Tensor    # (C,) int32
    list_pad: int                  # tile rows streamed per probe

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]


class DeltaView(NamedTuple):
    """Device view of the live index's delta buffer
    (``repro_torch.index``).

    Fixed-capacity tensors on the index's device; empty (or tombstoned)
    slots carry id -1.  ``assign`` is the nearest-centroid cluster each
    buffered vector will be merged into, which gates *when* it becomes
    visible to a query: a delta vector is merged into the running top-k
    at the probe of its assigned cluster, so results are bit-identical
    to a rebuilt index holding the same net corpus for every exit
    policy.
    """
    vecs: torch.Tensor     # (cap, d) f32
    ids: torch.Tensor      # (cap,) int32 external doc ids, -1 empty
    assign: torch.Tensor   # (cap,) int32 assigned cluster, -1 empty

    def burn_dead(self, dead: torch.Tensor) -> "DeltaView":
        """This view with the ids that the (id_capacity,) bool tombstone
        lookup ``dead`` marks burnt to -1, so every path masks them like
        empty slots."""
        return self._replace(
            ids=torch.where(_is_dead(self.ids, dead), -1, self.ids))


def check_same_device(dev: torch.device, what: str, *tensors) -> None:
    """Raise unless every tensor lies on ``dev``: nothing is copied."""
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what} lies on {t.device}, the index on "
                             f"{dev}; build it there")


def index_device(index: IVFIndex, device: DeviceLike = None) -> torch.device:
    """The device ``index`` lives on; raises if ``device`` names another.
    Nothing here moves the index."""
    dev = index.docs.device
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or (want.index is not None
                                     and want.index != dev.index):
            raise ValueError(f"the index lies on {dev} but device={want} "
                             f"was asked for; build the index there")
    return dev


def as_queries(queries, dev: torch.device) -> torch.Tensor:
    """Queries as f32 on the index's device: host arrays are copied
    there, tensors must already lie there."""
    if isinstance(queries, torch.Tensor):
        if queries.device != dev:
            raise ValueError(f"queries lie on {queries.device}, the index "
                             f"on {dev}")
        return queries.to(torch.float32)
    return torch.as_tensor(np.asarray(queries, np.float32), device=dev)


def validate_alignment(index: IVFIndex, *, blk_l: int = 64) -> None:
    """Eagerly enforce the kernels' layout contract: ``list_pad`` a
    ``blk_l`` multiple, every list offset ``blk_l`` aligned, and a full
    tile in bounds at every offset.  Raises ``ValueError`` pointing at
    ``build_index`` instead of letting a kernel score the wrong rows."""
    if blk_l <= 0:
        raise ValueError(f"blk_l must be positive, got {blk_l}")
    if index.list_pad % blk_l:
        raise ValueError(
            f"list_pad={index.list_pad} is not a multiple of blk_l="
            f"{blk_l}; rebuild with build_index(list_pad=<{blk_l}"
            f"-multiple>) or pass a compatible blk_l")
    offs = index.cluster_offsets.cpu().numpy()
    bad = np.nonzero(offs % blk_l)[0]
    if bad.size:
        raise ValueError(
            f"{bad.size} inverted-list offsets are not blk_l={blk_l} "
            f"aligned (first bad cluster {int(bad[0])}, offset "
            f"{int(offs[bad[0]])}); the scan kernels would stream "
            f"misaligned tiles and compute garbage. Rebuild the index "
            f"with build_index(align={blk_l}) (or a multiple).")
    if offs.size and int(offs.max()) + index.list_pad > index.docs.shape[0]:
        raise ValueError(
            f"a list_pad={index.list_pad} tile at offset {int(offs.max())} "
            f"runs past the {index.docs.shape[0]} index rows; build_index "
            f"leaves list_pad spare rows at the end")


def build_index(docs: np.ndarray, n_clusters: int, *, list_pad: int = 256,
                n_iters: int = 10, seed: int = 0, align: int = 64,
                device: DeviceLike = None) -> IVFIndex:
    """k-means -> oversize split -> cluster-major re-layout, on
    ``device`` (CUDA unless ``device="cpu"``).

    ``align``: every inverted list starts at a multiple of ``align``
    rows (gap rows id=-1), so the scan kernels can read (align, d)
    tiles at block-aligned offsets.
    """
    dev = resolve_device(device)
    if align <= 0:
        raise ValueError(f"align must be positive, got {align}")
    if list_pad % align:
        raise ValueError(
            f"list_pad={list_pad} must be a multiple of align={align} "
            f"so list offsets stay tile-aligned for the scan kernels")
    docs = np.asarray(docs, np.float32)
    x = torch.as_tensor(docs, device=dev)
    centroids, assign = km.kmeans(x, n_clusters, n_iters=n_iters, seed=seed)
    del x
    centroids, assign = km.split_oversized(
        docs, centroids.cpu().numpy(), assign.cpu().numpy(), list_pad,
        seed=seed)
    c = centroids.shape[0]
    sizes = np.bincount(assign, minlength=c).astype(np.int32)
    aligned = ((sizes + align - 1) // align) * align
    offsets = np.zeros(c, np.int32)
    offsets[1:] = np.cumsum(aligned)[:-1].astype(np.int32)
    total = int(aligned.sum()) + list_pad
    order = np.argsort(assign, kind="stable")
    # row of each doc in the cluster-major layout: its list's offset plus
    # its rank inside the list (docs keep corpus order within a list)
    starts = np.zeros(c, np.int64)
    starts[1:] = np.cumsum(sizes)[:-1]
    srt = assign[order]
    rows = offsets[srt].astype(np.int64) + np.arange(order.size) - starts[srt]
    sorted_docs = np.zeros((total, docs.shape[1]), np.float32)
    sorted_ids = np.full(total, -1, np.int32)
    sorted_docs[rows] = docs[order]
    sorted_ids[rows] = order
    return index_from_arrays(centroids, sorted_docs, sorted_ids, offsets,
                             sizes, list_pad, device=dev)


def index_from_arrays(centroids, docs, doc_ids, cluster_offsets,
                      cluster_sizes, list_pad: int, *,
                      device: DeviceLike = None) -> IVFIndex:
    """An :class:`IVFIndex` on ``device`` (CUDA unless ``device="cpu"``)
    from host arrays laid out as ``build_index`` lays them out — for
    example the arrays of a reference ``repro`` index."""
    dev = resolve_device(device)

    def put(a, dtype):
        # a copy: the index never aliases the caller's (or a read-only
        # reference) array
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    return IVFIndex(put(centroids, np.float32), put(docs, np.float32),
                    put(doc_ids, np.int32), put(cluster_offsets, np.int32),
                    put(cluster_sizes, np.int32), int(list_pad))


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


class SearchResult(NamedTuple):
    topk_scores: torch.Tensor
    topk_ids: torch.Tensor
    probes: torch.Tensor          # (B,) int32
    phi_hist: torch.Tensor        # (B, tau-1) — for diagnostics/benchmarks
    # (B, F) Table-1 features with intersections that a learned policy's
    # stages read at tau (None for fixed and patience)
    features: Optional[torch.Tensor] = None


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis of a float32 tensor: ties to the
    lower position (``torch.topk`` promises no tie order), and the two
    part only on the sign of a zero or a NaN (``kernels/row_topk.py``).
    On the card the ``row_topk`` kernel ranks, and raises where it cannot
    run; elsewhere (the CPU, the dry run's meta tensors) the stable sort.
    A row narrower than ``k`` is kept whole."""
    if not x.is_cuda:
        return _rt.row_topk_plain(x, k)
    w = x.shape[-1]
    k = min(k, w)
    s, i = kops.row_topk(x.reshape(-1, w), k)
    return s.reshape(*x.shape[:-1], k), i.reshape(*x.shape[:-1], k)


def centroid_rank(index: IVFIndex, queries: torch.Tensor, n_rank: int, *,
                  per_row: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n_rank) centroid sims in probe order and the clusters they
    name.

    ``per_row`` scores the centroids through ``delta_scan`` (each sim
    reduced on its own: the kernel's ``row_dot`` order on the card,
    ``score_rows`` on the CPU), so a query's sims, its probe order and
    its Table-1 group-2 features have the same bits whatever batch it
    rides in.  The learned stages need that: their trees are trained on
    features built in other batches.  Otherwise one matmul scores them,
    and its reduction order may depend on the batch's shape."""
    if per_row:
        sims = kops.delta_scan(queries, index.centroids)
    else:
        sims = queries @ index.centroids.T
    return top_k(sims, n_rank)


def intersection_pct(a_ids: torch.Tensor, b_ids: torch.Tensor
                     ) -> torch.Tensor:
    """100*|A ∩ B|/k for padded id sets (-1 = empty slot). (B,k)x(B,k)->(B,)"""
    k = a_ids.shape[-1]
    eq = (a_ids[..., :, None] == b_ids[..., None, :]) \
        & (a_ids[..., :, None] >= 0)
    return 100.0 * eq.sum(dim=(-2, -1)).to(torch.float32) / k


def _probe_rows(index: IVFIndex, cids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows of each query's probed tile: (B, L) rows, ids (-1 past the
    list size) and the candidate mask."""
    lp = index.list_pad
    offs = index.cluster_offsets[cids].long()
    sizes = index.cluster_sizes[cids]
    rows = offs[:, None] + torch.arange(lp, device=offs.device)
    mask = torch.arange(lp, device=offs.device)[None, :] < sizes[:, None]
    ids = torch.where(mask, index.doc_ids[rows], -1)
    # stored id -1 inside a list == tombstoned doc: mask it like padding
    return rows, ids, mask & (ids >= 0)


def _probe_tiles(index: IVFIndex, cids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each query's cluster tile: (B,L,d) docs, (B,L) ids, (B,L) mask."""
    rows, ids, mask = _probe_rows(index, cids)
    return index.docs[rows], ids, mask


def _is_dead(ids: torch.Tensor, dead: torch.Tensor) -> torch.Tensor:
    """Which ids the (id_capacity,) bool tombstone lookup marks."""
    return dead[ids.clamp(0, dead.shape[0] - 1).long()] & (ids >= 0)


def scrub_dead(scores: torch.Tensor, ids: torch.Tensor, dead: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask candidates whose external id is tombstoned.

    ``dead`` is the cumulative (id_capacity,) bool lookup from
    ``repro_torch.index``; needed when a running top-k can carry ids
    that were deleted *after* they were merged (version swaps
    mid-query)."""
    gone = _is_dead(ids, dead)
    return (torch.where(gone, float("-inf"), scores),
            torch.where(gone, -1, ids))


def merge_topk(scores: torch.Tensor, ids: torch.Tensor,
               new_scores: torch.Tensor, new_ids: torch.Tensor, k: int,
               use_kernel: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k of a running (B, k) top-k and (B, n) candidates: the
    ``topk_merge`` kernel with ``use_kernel``, else ``top_k`` of their
    concatenation."""
    if use_kernel:
        return kops.topk_merge(scores, ids, new_scores, new_ids, k)
    cat_s = torch.cat([scores, new_scores], dim=1)
    cat_i = torch.cat([ids, new_ids], dim=1)
    top_s, idx = top_k(cat_s, k)
    return top_s, torch.gather(cat_i, 1, idx.long())


# ---------------------------------------------------------------------------
# Probe steps: the fused kernel's and the kernel pair's calling conventions,
# shared by ``search`` and ``core.serving.WaveScheduler``
# ---------------------------------------------------------------------------


def scan_merge_chunk(index: IVFIndex, queries: torch.Tensor,
                     cids: torch.Tensor, slot_ok: torch.Tensor,
                     topk_scores: torch.Tensor, topk_ids: torch.Tensor,
                     delta: Optional[DeltaView] = None, *, k: int,
                     chunk: int, blk_l: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ``ivf_scan_merge`` launch over a chunk of probes: (B, chunk)
    probed clusters ``cids`` merged into the running (B, k) top-k.

    ``slot_ok`` (a bool mask that broadcasts to (B, chunk)) says which
    slots merge: a masked slot streams no list rows and gates the delta
    stream on -2, a cluster no buffer entry names (an empty slot's
    assign is -1, a real cluster >= 0), so it merges nothing.  ``delta``
    rides the kernel as its delta stream, each entry merged at the slot
    of its assigned cluster.  Returns ``ivf_scan_merge``'s (B, chunk, k)
    snapshot scores and ids and (B, chunk) new-entry counts."""
    sizes = torch.where(slot_ok, index.cluster_sizes[cids], 0)
    dargs = () if delta is None else (
        *delta, torch.where(slot_ok, cids, -2))
    return kops.ivf_scan_merge(
        queries, index.docs, index.doc_ids, index.cluster_offsets[cids],
        sizes, topk_scores, topk_ids, *dargs, k=k, list_pad=index.list_pad,
        chunk=chunk, blk_l=blk_l)


def probe_candidates(index: IVFIndex, queries: torch.Tensor,
                     cids: torch.Tensor, *, use_kernel: bool,
                     delta: Optional[DeltaView] = None,
                     delta_scores: Optional[torch.Tensor] = None,
                     blk_l: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """One probe's candidates for ``merge_topk``: each row's (B,) probed
    cluster scored by the ``ivf_scan`` kernel (``use_kernel``) or
    ``score_rows``, -inf and id -1 outside the list and on tombstoned
    rows.  With ``delta`` and its (B, cap) raw ``delta_scores``
    (``delta_scan``, once a search or a wave) the buffer's entries
    follow, each live only at the probe of its assigned cluster."""
    rows, ids, mask = _probe_rows(index, cids)
    if use_kernel:
        sc = kops.ivf_scan(queries, index.docs, index.cluster_offsets[cids],
                           index.cluster_sizes[cids],
                           list_pad=index.list_pad, blk_l=blk_l)
    else:
        sc = score_rows(queries, index.docs, rows)
    sc = torch.where(mask, sc, float("-inf"))
    if delta is None:
        return sc, ids
    gate = (delta.ids >= 0)[None, :] \
        & (delta.assign[None, :] == cids[:, None])
    return (torch.cat([sc, torch.where(gate, delta_scores, float("-inf"))],
                      1),
            torch.cat([ids, torch.where(gate, delta.ids, -1)], 1))


def search(index: IVFIndex, queries, policy: Policy, *,
           delta: Optional[DeltaView] = None,
           use_scan_kernel: bool = False, use_topk_kernel: bool = False,
           use_fused_kernel: bool = False, chunk: int = 1,
           blk_l: int = 64, device: DeviceLike = None) -> SearchResult:
    """Batched adaptive A-kNN: probe clusters in similarity order with
    per-query early exit, on the index's device.

    ``chunk`` probes are advanced per loop iteration; the exit policy
    is still evaluated at per-probe granularity, so results and probe
    counts equal ``chunk=1`` for every policy (a learned stage fires on
    the exact probe ``tau`` even inside a chunk).  ``use_scan_kernel`` /
    ``use_topk_kernel`` route each probe through the ``ivf_scan`` and
    ``topk_merge`` kernels; ``use_fused_kernel`` routes each chunk
    through one ``ivf_scan_merge`` launch, and phi comes from its
    per-probe new-entry counts.

    A learned policy (REG, classifier, cascade) ranks the centroids by
    ``centroid_rank(per_row=True)`` and reads the Table-1 features at
    ``tau`` (returned as ``SearchResult.features``), built by the same
    slot update as ``extract_features``'s.  Its trees must lie on the
    index's device.

    ``delta`` (live index, ``repro_torch.index``): a fixed-capacity
    buffer of recently added vectors, on the index's device.  It is
    scored once per call — by ``delta_scan`` on the per-probe paths (the
    kernel with ``use_scan_kernel``, its plain version otherwise), or
    inside the fused kernel as its delta stream — and each entry is
    merged into the running top-k at the probe of its *assigned*
    cluster, so phi/patience accounting — and therefore the result — is
    bit-identical to searching a rebuilt index that physically contains
    the delta docs in those lists.  Tombstoned docs carry id -1 and are
    masked on every path.
    """
    return _search(index, queries, policy, delta=delta,
                   use_scan_kernel=use_scan_kernel,
                   use_topk_kernel=use_topk_kernel,
                   use_fused_kernel=use_fused_kernel, chunk=chunk,
                   blk_l=blk_l, device=device, features=policy.learned)


def _search(index: IVFIndex, queries, policy: Policy, *,
            delta: Optional[DeltaView], use_scan_kernel: bool,
            use_topk_kernel: bool, use_fused_kernel: bool, chunk: int,
            blk_l: int, device: DeviceLike, features: bool) -> SearchResult:
    """``search``; with ``features`` the centroids are ranked per row,
    phi against RS_1 is kept while it is recorded (probes 2..tau), and
    the Table-1 matrix is built after probe ``min(tau, n_rank)``."""
    dev = index_device(index, device)
    if delta is not None:
        check_same_device(dev, "the delta view", *delta)
    for tree in (policy.reg, policy.clf):
        if tree is not None:
            check_same_device(dev, "a tree of the policy", tree.feat,
                              tree.thresh, tree.left, tree.right,
                              tree.value, tree.base)
    if use_fused_kernel or use_scan_kernel:
        # the kernels trust blk_l-aligned offsets: fail loudly up front
        validate_alignment(index, blk_l=blk_l)
    queries = as_queries(queries, dev)
    B = queries.shape[0]
    k, N, tau = policy.k, policy.n_probe, policy.tau
    n_rank = min(N, index.n_clusters)
    chunk = max(1, min(chunk, n_rank))

    rank_sims, cluster_rank = centroid_rank(index, queries, n_rank,
                                            per_row=features)  # (B, N)
    cluster_rank = cluster_rank.long()
    centroid_sims = rank_sims[:, :tau]

    d_sc = None
    if delta is not None and not use_fused_kernel:
        # one scan of the whole buffer; each entry is *merged* only at
        # the probe of its assigned cluster
        d_sc = kops.delta_scan(queries, delta.vecs) if use_scan_kernel \
            else delta_scan_plain(queries, delta.vecs)          # (B, cap)

    topk_scores = torch.full((B, k), float("-inf"), device=dev)
    topk_ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    hist_w = max(tau - 1, 1)
    phi_hist = torch.zeros((B, hist_w), device=dev)
    phi1_hist = torch.zeros((B, hist_w), device=dev)
    rs1_ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    patience_ctr = torch.zeros(B, dtype=torch.int32, device=dev)
    target = torch.full((B,), N, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    probes = torch.zeros(B, dtype=torch.int32, device=dev)
    hist_cols = torch.arange(hist_w, device=dev)
    at_tau = min(tau, n_rank) - 1       # the probe the features describe
    fm = None

    def slot_update(h, m_s, m_i, phi_pre):
        """One probe's state transition given its merged top-k and, on
        the fused path, the kernel-derived phi (None -> recompute)."""
        nonlocal topk_scores, topk_ids, phi_hist, phi1_hist, rs1_ids, \
            patience_ctr, target, active, probes, fm
        act = active[:, None]
        new_ids = torch.where(act, m_i, topk_ids)
        phi = intersection_pct(topk_ids, new_ids) if phi_pre is None \
            else phi_pre
        topk_scores = torch.where(act, m_s, topk_scores)
        topk_ids = new_ids
        if features and h == 0:
            rs1_ids = torch.where(act, topk_ids, rs1_ids)
        # record stability history rows h-1 in [0, tau-2]
        if 1 <= h <= tau - 1:
            upd = (hist_cols == h - 1)[None, :] & act
            phi_hist = torch.where(upd, phi[:, None], phi_hist)
            if features:
                phi1 = intersection_pct(rs1_ids, topk_ids)
                phi1_hist = torch.where(upd, phi1[:, None], phi1_hist)
        if features and h == at_tau:
            fm = feature_matrix(FeatureExtras(
                queries=queries, centroid_sims=centroid_sims,
                topk_scores=topk_scores, phi_hist=phi_hist,
                phi1_hist=phi1_hist), with_intersections=True)
        exit_, patience_ctr, target = policy_step(
            policy, h=h, phi=phi, patience_ctr=patience_ctr, target=target,
            features=fm)
        exit_now = active & exit_ & (h + 1 >= policy.min_probes)
        probes = torch.where(active, h + 1, probes)
        active = active & ~exit_now & (h + 1 < n_rank)

    h = 0
    while h < n_rank and bool(active.any()):
        if use_fused_kernel:
            # one fused launch scores+merges the whole probe chunk;
            # slots past n_rank merge nothing
            rel = torch.arange(chunk, device=dev)
            cids = cluster_rank[:, (h + rel).clamp(max=n_rank - 1)]
            slot_ok = (h + rel < n_rank)[None, :]
            snap_s, snap_i, cnts = scan_merge_chunk(
                index, queries, cids, slot_ok, topk_scores, topk_ids, delta,
                k=k, chunk=chunk, blk_l=blk_l)
            for t in range(chunk):
                phi = 100.0 * (k - cnts[:, t]).to(torch.float32) / k
                slot_update(h, snap_s[:, t], snap_i[:, t], phi)
                h += 1
        else:
            for _ in range(chunk):
                new_scores, new_ids = probe_candidates(
                    index, queries, cluster_rank[:, min(h, n_rank - 1)],
                    use_kernel=use_scan_kernel, delta=delta,
                    delta_scores=d_sc, blk_l=blk_l)
                m_s, m_i = merge_topk(topk_scores, topk_ids, new_scores,
                                      new_ids, k, use_topk_kernel)
                slot_update(h, m_s, m_i, None)
                h += 1
    return SearchResult(topk_scores, topk_ids, probes, phi_hist, fm)


# the path ``extract_features`` builds its features on; on the card the
# fused kernel's scores equal the kernel pair's bit for bit (and differ
# from the plain per-probe path's), and the chunk changes no bit
FEATURE_CHUNK = 4


def extract_features(index: IVFIndex, queries, *, tau: int, k: int,
                     with_intersections: bool = True,
                     device: DeviceLike = None) -> torch.Tensor:
    """Run exactly ``tau`` probes and build the Table-1 feature matrix.

    The probes run through ``search``'s own loop on the fused kernel
    (one ``ivf_scan_merge`` launch per ``FEATURE_CHUNK`` probes), with
    the centroids ranked per row, so offline (training) features equal
    the online (serving) features at ``tau`` bit for bit, whatever the
    batch sizes of the two.  With ``with_intersections=False`` the
    matrix stops before the two history blocks (REG's groups 1-3).
    """
    res = _search(index, queries, Policy(k=k, n_probe=tau, tau=tau,
                                         name="features"),
                  delta=None, use_scan_kernel=False, use_topk_kernel=False,
                  use_fused_kernel=True, chunk=FEATURE_CHUNK, blk_l=64,
                  device=device, features=True)
    return res.features if with_intersections else \
        base_columns(res.features, tau)


def brute_force(docs: torch.Tensor, queries: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN oracle (id space = row index), ties to the lower id."""
    return top_k(queries @ docs.T, k)


def probe_trace(index: IVFIndex, queries, n_probe: int, k: int, *,
                per_row: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Reference (non-exiting) scan returning the full top-k trajectory:
    ids after every probe h=1..N. Used for C(q) labels, Figure 1 and
    policy oracles. Returns (ids_traj (N,B,k), phi (N-1,B)).
    ``per_row`` ranks the centroids as a learned policy's search does
    (``centroid_rank``)."""
    dev = index_device(index)
    queries = as_queries(queries, dev)
    B = queries.shape[0]
    n = min(n_probe, index.n_clusters)
    _, cluster_rank = centroid_rank(index, queries, n, per_row=per_row)
    scores = torch.full((B, k), float("-inf"), device=dev)
    ids = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    traj, phi = [], []
    for h in range(n):
        cids = cluster_rank[:, h].long()
        sc, tids = probe_candidates(index, queries, cids, use_kernel=False)
        scores, new_ids = merge_topk(scores, ids, sc, tids, k)
        if h:
            phi.append(intersection_pct(ids, new_ids).cpu().numpy())
        ids = new_ids
        traj.append(ids.cpu().numpy())
    return np.stack(traj), np.stack(phi) if phi else np.zeros((0, B),
                                                             np.float32)


def min_probes_labels(traj_ids: np.ndarray, exact_top1: np.ndarray,
                      n_probe: int) -> np.ndarray:
    """C(q): minimal h such that RS_h contains the exact 1-NN (else N)."""
    found = (traj_ids == exact_top1[None, :, None]).any(-1)  # (N, B)
    any_found = found.any(0)
    first = np.argmax(found, axis=0) + 1
    return np.where(any_found, first, n_probe).astype(np.int32)
