"""EmbeddingBag: per bag, the sum of its F gathered table rows.

Port of ``repro.kernels.embedding_bag``.  On a CUDA tensor the wrapper
launches ``csrc/embedding_bag.cu``; on a CPU tensor it runs
:func:`embedding_bag_plain`.  Both add a bag's rows in f32 in the order
f = 0..F-1, as the Pallas kernel's revisited output block does, so the
three agree bit for bit.  Ids must lie in ``[0, R)``: the kernel does
not check them.

:class:`EmbeddingBagFunction` puts the wrapper under autograd.  Its
backward is the table gradient ``grad[ids[b, f]] += g[b]``, dense
(R, D) as the gradient of the reference's ``jnp.take``, in plain
PyTorch (the reference has no backward kernel): :func:`rows_grad`, a
sort and a segment sum that adds each row's terms in their order with
no atomics, so the card gives the same bits on every run, and the same
bits as the reference's serial scatter-add on the CPU.
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


def rows_grad(ids: torch.Tensor, grads: torch.Tensor,
              n_rows: int) -> torch.Tensor:
    """(n_rows, D) sums of the (N, D) ``grads`` into rows ``ids``
    (N,): row r is ``0 + grads[i0] + grads[i1] + ...`` over the i with
    ids[i] == r in increasing i.  A stable sort groups each row's terms
    in that order and ``segment_reduce`` adds each group serially: no
    atomics, the same bits on every run and on either device; in
    ``grads``' dtype."""
    ids = ids.reshape(-1).long()
    out = grads.new_zeros((n_rows, grads.shape[1]))
    if ids.numel():
        order = torch.argsort(ids, stable=True)
        rows, counts = torch.unique_consecutive(ids[order],
                                                return_counts=True)
        out[rows] = torch.segment_reduce(grads[order], "sum",
                                         lengths=counts, axis=0)
    return out


class EmbeddingBagFunction(torch.autograd.Function):
    """:func:`embedding_bag` with the table gradient of its sums (the ids
    get none)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return embedding_bag(table, ids)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        b, f = ids.shape
        # term (b, f) of row ids[b, f] is g[b]: (b, f) in row-major order,
        # the reference's scatter order
        per_id = g.float()[:, None, :].expand(b, f, g.shape[1]) \
            .reshape(b * f, -1)
        return rows_grad(ids, per_id, ctx.n_rows), None


class EmbeddingBagPlainFunction(EmbeddingBagFunction):
    """:func:`embedding_bag_plain` under the same backward: the plain path
    the kernel's is held against, on either device."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return embedding_bag_plain(table, ids)
