"""Top-k merge: the first k of (running-k ++ new-L) in packed order.

Port of ``repro.kernels.topk_merge``.  On a CUDA tensor the wrapper
launches ``csrc/topk_merge.cu``, a filtered rank merge whose shared
memory grows with k only (:func:`smem_bytes`), so any L fits; on a CPU
tensor it runs :func:`topk_merge_plain`, the reference's packed sort
over all ``next_pow2(k0 + L)`` records.  Non-finite scores become the
-1e30 sentinel first, and scores at or below -1e29 come back as -inf,
so empty slots match the plain per-probe merge exactly.  The kernel
writes the -inf itself: a call is one launch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, sort

NEG = -1e30
# survivors the kernel holds between merges (csrc/topk_merge.cu: kBuf)
BUF = 512


def smem_bytes(k: int) -> int:
    """The kernel's dynamic shared memory for top-k ``k``: the running
    top-k and its merge scratch, the survivors and their ranks."""
    return 16 * (k + BUF)


def topk_merge_plain(scores: torch.Tensor, ids: torch.Tensor,
                     new_scores: torch.Tensor, new_ids: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    s = torch.cat([scores, new_scores], dim=1)
    i = torch.cat([ids, new_ids], dim=1)
    pad = sort.next_pow2(s.shape[1]) - s.shape[1]
    s = torch.nn.functional.pad(s, (0, pad), value=NEG)
    i = torch.nn.functional.pad(i, (0, pad), value=-1)
    # NaN/±inf clamp BEFORE the key map, so NaNs cannot sort above +inf
    s = torch.where(torch.isfinite(s), s, NEG)
    out = sort.bitonic_desc_packed(sort.pack(sort.score_to_key(s), i))
    # the network runs on the -1e30 sentinel; map it back to -inf
    top = sort.key_to_score(out[:, 0, :k])
    return torch.where(top > -1e29, top, float("-inf")), out[:, 1, :k]


def topk_merge(scores: torch.Tensor, ids: torch.Tensor,
               new_scores: torch.Tensor, new_ids: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge running (B, k0) scores/ids with (B, L) new ones; returns
    the (B, k) top-k, -inf / -1 on empty slots."""
    b, k0 = scores.shape
    n_new = new_scores.shape[1]
    dev = _build.check_inputs(
        "topk_merge", scores=(scores, torch.float32, (b, k0)),
        ids=(ids, torch.int32, (b, k0)),
        new_scores=(new_scores, torch.float32, (b, n_new)),
        new_ids=(new_ids, torch.int32, (b, n_new)))
    m_pad = sort.next_pow2(k0 + n_new)
    if not 0 < k <= m_pad:
        raise ValueError(f"topk_merge: k={k} outside (0, {m_pad}]")
    if dev.type == "cpu":
        return topk_merge_plain(scores, ids, new_scores, new_ids, k)
    _build.check_smem("topk_merge", dev, smem_bytes(k), f"k={k}")
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b:
        _build.launch("topk_merge", dev, scores.data_ptr(), ids.data_ptr(),
                      new_scores.data_ptr(), new_ids.data_ptr(),
                      out_s.data_ptr(), out_i.data_ptr(), b, k0, n_new, k,
                      m_pad)
        topk_merge.launches += 1
    return out_s, out_i


topk_merge.launches = 0
