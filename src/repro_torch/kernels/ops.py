"""Public wrappers around the kernels (port of ``repro.kernels.ops``).

Each wrapper runs the CUDA kernel on CUDA tensors and the kernel's
plain PyTorch version on CPU tensors (see the kernel modules).  What
the reference's ``ops`` layer does around its kernels happens here:
the -inf masking of ``ivf_scan``, the -1 padding of ``ids2d``, offsets
in ``blk_l`` units, the sentinel -> -inf map of ``ivf_scan_merge``, and
contiguous inputs and int32 ids for ``flash_attention`` and
``embedding_bag``, which run under autograd (their ``Function``s: the
kernel forward, a plain PyTorch backward).
The delta buffer needs no padding here: the CUDA kernels take any
capacity, where the Pallas kernel wanted ``blk_dl`` multiples.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import delta_scan as _ds
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ivf_scan as _scan
from repro_torch.kernels import ivf_scan_merge as _sm
from repro_torch.kernels import row_topk as _rt
from repro_torch.kernels import slot_roll as _sr
from repro_torch.kernels import topk_merge as _tm


def flash_attention(q, k, v, *, causal: bool = True,
                    chunk: int = 512) -> torch.Tensor:
    """q, k (BH, S, dqk), v (BH, S, dv) -> (BH, S, dv) in q's dtype; any
    S.  Differentiable: the gradients are those of the reference's
    chunked attention at query blocks of ``chunk``
    (``flash_attention.flash_attention_backward_plain``)."""
    return _fa.FlashAttentionFunction.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal, chunk)


def _block_offsets(offsets: torch.Tensor, blk_l: int) -> torch.Tensor:
    return torch.div(offsets, blk_l, rounding_mode="floor") \
        .to(torch.int32).reshape(-1).contiguous()


def ivf_scan(queries, docs, offsets, sizes, *, list_pad: int,
             blk_l: int = 64) -> torch.Tensor:
    """Cluster-tile scoring; -inf outside each true list size."""
    raw = _scan.ivf_scan(queries, docs, _block_offsets(offsets, blk_l),
                         list_pad=list_pad, blk_l=blk_l)
    mask = torch.arange(list_pad, device=raw.device)[None, :] \
        < sizes[:, None]
    return torch.where(mask, raw, float("-inf"))


def ivf_scan_merge(queries, docs, doc_ids, offsets, sizes, run_scores,
                   run_ids, delta_vecs=None, delta_ids=None,
                   delta_assign=None, gate_cids=None, *, k: int,
                   list_pad: int, chunk: int, blk_l: int = 64
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused multi-probe scan -> running top-k merge (one launch per
    ``chunk`` probes).

    offsets/sizes: (B, chunk) row offsets (blk_l aligned) and true list
    sizes per probed cluster; run_scores/run_ids: (B, k) incoming
    running top-k.  Returns ((B, chunk, k) snapshot scores with -inf
    empty slots, (B, chunk, k) snapshot ids, (B, chunk) new-entry
    counts with phi = 100 * (k - count) / k).

    Live-index overlay (all four together or none): delta_vecs (cap, d)
    / delta_ids / delta_assign (cap,) — the delta buffer, id -1 on empty
    or tombstoned slots — and gate_cids (B, chunk), the probed cluster
    of each slot or -2 past the probe budget.  The buffer is scored in
    the kernel and each entry merges at its assigned cluster's slot.
    """
    if gate_cids is not None:
        gate_cids = gate_cids.to(torch.int32).reshape(-1).contiguous()
    tail = (-doc_ids.shape[0]) % blk_l
    if tail:
        doc_ids = torch.nn.functional.pad(doc_ids, (0, tail), value=-1)
    out_s, out_i, cnt = _sm.ivf_scan_merge(
        queries, docs, doc_ids.reshape(-1, blk_l),
        _block_offsets(offsets, blk_l),
        sizes.to(torch.int32).reshape(-1).contiguous(),
        run_scores.contiguous(), run_ids.contiguous(), k=k,
        list_pad=list_pad, chunk=chunk, blk_l=blk_l, delta_vecs=delta_vecs,
        delta_ids=delta_ids, delta_assign=delta_assign, gate_cids=gate_cids)
    # sentinel -> -inf so empty slots match the plain merge convention
    return torch.where(out_s > _sm.VALID_MIN, out_s, float("-inf")), \
        out_i, cnt


def delta_scan(queries, vecs) -> torch.Tensor:
    """Raw (B, cap) scores of the delta buffer; callers mask empty and
    tombstoned slots by ``ids >= 0``."""
    return _ds.delta_scan(queries.contiguous(), vecs.contiguous())


def topk_merge(scores, ids, new_scores, new_ids,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _tm.topk_merge(scores.contiguous(), ids.contiguous(),
                          new_scores.contiguous(), new_ids.contiguous(), k)


def row_topk(x, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, W) float32 -> each row's first k values and int32 positions,
    in a stable descending sort's order (``core.ivf.top_k``)."""
    return _rt.row_topk(x.contiguous(), k)


def slot_roll(snap_s, snap_i, cnts, lanes, lane_delta, lane_cap, *, k: int,
              chunk: int, phi: float, min_probes: int = 1) -> _sr.Lanes:
    """Roll the lanes' fields (``slot_roll.Lanes``) through the fused
    kernel's (W, chunk, k) snapshots and (W, chunk) new-entry counts:
    per slot, the patience exit rule with phi threshold ``phi``, no
    patience exit before ``min_probes`` probes, and the per-lane (W,)
    ``lane_delta``/``lane_cap``."""
    return _sr.slot_roll(snap_s.contiguous(), snap_i.contiguous(),
                         cnts.contiguous(),
                         _sr.Lanes(*(t.contiguous() for t in lanes)),
                         lane_delta.contiguous(), lane_cap.contiguous(),
                         k=k, chunk=chunk, phi=phi, min_probes=min_probes)


def embedding_bag(table, ids) -> torch.Tensor:
    """table (R, D) f32; ids (B, F) -> (B, D) sum-combined bags (int64
    ids are converted to int32).  Differentiable in ``table``: the
    deterministic dense (R, D) gradient of ``embedding_bag.rows_grad``."""
    return _eb.EmbeddingBagFunction.apply(table.contiguous(),
                                          ids.to(torch.int32).contiguous())
