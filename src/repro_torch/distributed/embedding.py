"""Model-parallel embedding lookup over a ``DeviceMesh`` (port of
``repro.distributed.embedding``).

Tables are row-sharded over ``model``: every rank resolves the ids that
fall in its row range, zeroes the others, and an all-reduce over the
model group combines them, so the table is never gathered (the failure
mode of naive gathers on 10^8-row tables).  Ids arrive whole on every
rank; each DP rank looks up its block of rows and the result comes back
whole on every rank.
"""
from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

from repro_torch.distributed.collectives import all_gather, all_reduce
from repro_torch.launch.mesh import axis_group, axis_index, local_block


def make_sharded_lookup(mesh, rows_total: int, *,
                        model_axis: Union[str, Sequence[str]] = "model",
                        dp_axes: Sequence[str] = ("data",)
                        ) -> Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]:
    """Returns ``lookup(table_shard, flat_ids) -> (B, F, D)``.

    ``table_shard``: this rank's ``ceil(rows_total / S)`` rows of the
    (rows_total, D) table (``launch.mesh.local_block`` over the model
    group); ``flat_ids``: the whole (B, F) batch of combined-table ids,
    B a multiple of the DP ranks.  Every rank of the mesh calls it."""
    model = axis_group(mesh, model_axis)
    dp = axis_group(mesh, dp_axes)
    rows_local = -(-rows_total // model.size())
    r0 = axis_index(model) * rows_local

    def lookup(table_shard: torch.Tensor, ids: torch.Tensor
               ) -> torch.Tensor:
        ids = local_block(ids.to(table_shard.device), dp)
        loc = ids.long() - r0
        ok = (loc >= 0) & (loc < table_shard.shape[0])
        emb = table_shard[loc.clamp(0, table_shard.shape[0] - 1)]
        emb = emb * ok[..., None].to(emb.dtype)
        emb = all_reduce(emb, model)
        return all_gather(emb, dp).flatten(0, 1)

    return lookup


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, *, combine: str = "sum"
                  ) -> torch.Tensor:
    """Single-host EmbeddingBag oracle over ragged multi-hot bags.

    ids: (nnz,) row ids; offsets: (B+1,) bag boundaries -> (B, D).  Id
    i goes to the bag ``searchsorted(offsets[1:], i, right)``, as the
    reference assigns it (ids past ``offsets[-1]`` go to none); each
    bag's rows are summed in order by ``segment_reduce``, the same bits
    on every device.  ``combine="mean"`` divides by the bag's size (at
    least 1)."""
    nnz = ids.shape[0]
    b = offsets.shape[0] - 1
    seg = torch.searchsorted(offsets[1:].contiguous(),
                             torch.arange(nnz, device=ids.device),
                             right=True)
    counts = torch.bincount(seg, minlength=b + 1)[:b]
    kept = int(counts.sum())            # seg is sorted: the dropped ids
    #                                     are the tail
    out = torch.segment_reduce(table[ids[:kept].long()], "sum",
                               lengths=counts, axis=0)
    if combine == "mean":
        out = out / torch.clamp_min(counts.to(table.dtype), 1.0)[:, None]
    return out
