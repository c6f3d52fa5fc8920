"""IVF cluster-scan: raw scores of each query against its probed
cluster's ``(list_pad, d)`` tile of the cluster-major doc matrix.

Port of ``repro.kernels.ivf_scan``.  On a CUDA tensor the wrapper
launches ``csrc/ivf_scan.cu``; on a CPU tensor it runs
:func:`ivf_scan_plain`.  Offsets come in ``blk_l`` units (the index
aligns every list to ``blk_l`` rows); masking by the true list size
happens in ``kernels/ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def score_rows(queries: torch.Tensor, docs: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """(B, d) queries against ``docs[rows]`` for (B, L) row indices ->
    (B, L) f32: the plain scoring every IVF path shares.

    Products, then a sum over d: each score is reduced on its own, so a
    row scores the same bits whatever the batch shape and its position
    in it (a batched matmul picks its summation order by shape).  That
    keeps the plain paths' "live overlay == rebuilt index" bit-exact: a
    buffered doc and the same doc in a list score alike."""
    return (docs[rows] * queries[:, None, :]).sum(-1)


def ivf_scan_plain(queries: torch.Tensor, docs: torch.Tensor,
                   block_offsets: torch.Tensor, *, list_pad: int,
                   blk_l: int) -> torch.Tensor:
    lane = torch.arange(list_pad, device=queries.device)
    rows = block_offsets.long()[:, None] * blk_l + lane
    return score_rows(queries, docs, rows)


def ivf_scan(queries: torch.Tensor, docs: torch.Tensor,
             block_offsets: torch.Tensor, *, list_pad: int,
             blk_l: int = 64) -> torch.Tensor:
    """queries (B, d) f32; docs (n, d) f32 cluster-major; block_offsets
    (B,) int32 in ``blk_l`` units -> raw scores (B, list_pad) f32."""
    if blk_l <= 0 or list_pad % blk_l:
        raise ValueError(f"list_pad={list_pad} must be a positive "
                         f"multiple of blk_l={blk_l}")
    b, d = queries.shape
    dev = _build.check_inputs(
        "ivf_scan", queries=(queries, torch.float32, (b, d)),
        docs=(docs, torch.float32, (None, d)),
        block_offsets=(block_offsets, torch.int32, (b,)))
    if dev.type == "cpu":
        return ivf_scan_plain(queries, docs, block_offsets,
                              list_pad=list_pad, blk_l=blk_l)
    if d * 4 > 48 * 1024:
        raise ValueError(f"ivf_scan: d={d} does not fit shared memory")
    out = torch.empty((b, list_pad), dtype=torch.float32, device=dev)
    if b:
        _build.launch("ivf_scan", dev, queries.data_ptr(), docs.data_ptr(),
                      block_offsets.data_ptr(), out.data_ptr(), b, d,
                      list_pad, blk_l)
        ivf_scan.launches += 1
    return out


ivf_scan.launches = 0
