"""Row top-k: the first k (value, position) pairs of each row of a
float32 (B, W) matrix, in the order of a stable descending sort.

Replaces no TPU kernel: the reference ranks with ``lax.top_k``, which
XLA lowers itself, and ``core.ivf.top_k`` ran a full stable sort of
every row to keep its first k.  On a CUDA tensor the wrapper launches
``csrc/row_topk.cu``, a filter by the running k-th record that reads each
row once and whose shared memory grows with k only (:func:`smem_bytes`),
or raises; on a CPU tensor it runs :func:`row_topk_plain`, that stable
sort.  Both give the same bits: values descending, every NaN above
+inf, -0.0 equal to +0.0, and equal values to the lower position.
``lax.top_k`` agrees on every finite nonzero value, on +-inf and on
ties, but ranks by the total order: +0.0 above -0.0, a negative NaN
last.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

# survivors the kernel holds between merges (csrc/row_topk.cu: kBuf)
BUF = 512


def smem_bytes(k: int) -> int:
    """The kernel's dynamic shared memory for top-k ``k``: the running
    top-k, its merge scratch and the survivors."""
    return 8 * (2 * k + BUF)


def row_topk_plain(x: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first k of a stable descending sort along the last axis
    (ties to the lower position; ``torch.topk`` promises no tie order)."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k].to(torch.int32)


def row_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, W) float32 -> the (B, k) values and int32 positions of each
    row's first k; 0 < k <= W."""
    dev = _build.check_inputs("row_topk", x=(x, torch.float32, (None, None)))
    b, w = x.shape
    if not 0 < k <= w:
        raise ValueError(f"row_topk: k={k} outside (0, {w}]")
    if dev.type == "cpu":
        return row_topk_plain(x, k)
    _build.check_smem("row_topk", dev, smem_bytes(k), f"k={k}")
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b:
        _build.launch("row_topk", dev, x.data_ptr(), out_v.data_ptr(),
                      out_i.data_ptr(), b, w, k)
        row_topk.launches += 1
    return out_v, out_i


row_topk.launches = 0
