"""EmbeddingBag: per bag, the sum of its F gathered table rows.

Port of ``repro.kernels.embedding_bag``.  On a CUDA tensor the wrapper
launches ``csrc/embedding_bag.cu``; on a CPU tensor it runs
:func:`embedding_bag_plain`.  Both add a bag's rows in f32 in the order
f = 0..F-1, as the Pallas kernel's revisited output block does, so the
three agree bit for bit.  Ids must lie in ``[0, R)``: the kernel does
not check them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def embedding_bag_plain(table: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """``out = 0; out += table[ids[:, f]]`` for f = 0..F-1, in f32."""
    out = torch.zeros((ids.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for f in range(ids.shape[1]):
        out += table[ids[:, f].long()].float()
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (R, D) f32; ids (B, F) int32 -> (B, D) f32 bag sums."""
    b, f = ids.shape
    r, d = table.shape
    dev = _build.check_inputs(
        "embedding_bag", table=(table, torch.float32, (r, d)),
        ids=(ids, torch.int32, (b, f)))
    if dev.type == "cpu":
        return embedding_bag_plain(table, ids)
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b and d:
        _build.launch("embedding_bag", dev, table.data_ptr(), ids.data_ptr(),
                      out.data_ptr(), b, f, d)
        embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
