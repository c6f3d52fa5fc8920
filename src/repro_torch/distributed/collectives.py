"""Collectives over ``torch.distributed`` groups (port of
``repro.distributed.collectives``): int8 error-feedback gradient
compression, bucketed gradient all-reduce, ring all-gather by
point-to-point hops, and the plain ``all_gather``/``all_reduce`` the
port's mesh code runs on.

The reference names a mesh axis; here a collective takes the axis's
process group (``repro_torch.launch.mesh.axis_group``).

Gloo's ``all_gather`` and point-to-point sends take host tensors only
(PyTorch's backend table), so, one rule for every collective of this
module, a CUDA tensor on a gloo group is staged through host memory:
copied to the host, reduced or gathered there, copied back to its card.
NCCL groups take CUDA tensors as they are.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist

Pytree = Any


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor on a group whose backend takes host memory only."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(S, *x.shape): every rank's ``x``, stacked in group-rank order."""
    src = x.contiguous()
    if _staged(src, group):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(group.size())]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(x.device)


def all_reduce(x: torch.Tensor, group,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of every rank's ``x`` (a new tensor; ``x`` is left
    as it was)."""
    buf = x.cpu() if _staged(x, group) else x.clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """(S, *shape) ``x`` -> (*shape): the sum over the group's ranks of
    their ``x[r]``, on rank r."""
    src = x.contiguous()
    if _staged(src, group):
        src = src.cpu()
    out = src.new_empty(src.shape[1:])
    dist.reduce_scatter_tensor(out, src.reshape((-1,) + tuple(src.shape[2:])),
                               group=group)
    return out.to(x.device)


# --- the same collectives under autograd -------------------------------------
# A mesh program's gradient is that of the sum of its DP ranks' losses:
# ranks of a DP group hold other tokens, ranks of a model group hold
# replicas of one computation, each running its own block of it.


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, replicas):
        ctx.group, ctx.replicas = group, replicas
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicas:
            return g[dist.get_rank(ctx.group)], None, None
        return reduce_scatter(g, ctx.group), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def gather_shards(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather`` of each rank's shard of a weight (FSDP); the
    gradient reduce-scatters: each rank's shard gets the sum of every
    rank's gradient of it."""
    return _Gather.apply(x, group, False)


def gather_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather`` of each replica's block of one result; the gradient
    of a rank's block is its block of the gathered gradient."""
    return _Gather.apply(x, group, True)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce`` (sum) whose gradient is summed over the group too."""
    return _Sum.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, where each replica of the group uses its own block
    of it: the gradient sums the replicas' partial gradients."""
    return _Copy.apply(x, group)


# --- int8 error-feedback gradient compression --------------------------------


def compress_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g + carried error) -> (int8 payload, scale, new error).

    1-bit/8-bit SGD style error feedback: the quantization residual is
    carried to the next step.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so the payload and the error equal the
    reference's op-by-op results bit for bit (under ``jit`` XLA fuses the
    error's multiply and subtract into one rounding)."""
    x = g.to(torch.float32) + err
    scale = torch.clamp_min(torch.max(torch.abs(x)) / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean of ``g`` over ``group`` from int8 payloads, and this
    rank's new error.  Each rank's payload is dequantized with its own
    scale before the sum (the scales differ per rank), as the
    reference's psum of the widened payload does."""
    q, scale, new_err = compress_int8(g, err)
    summed = all_reduce(decompress_int8(q, scale), group)
    return (summed / float(group.size())).to(g.dtype), new_err


# --- bucketed gradient reduction ----------------------------------------------


def _flatten(tree: Pytree) -> Tuple[List[torch.Tensor], Any]:
    """Leaves in ``jax.tree_util`` order (dict keys sorted, lists and
    tuples in order) and what ``_unflatten`` needs to rebuild ``tree``."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([l for ls, _ in parts for l in ls],
                ("dict", keys, [s for _, s in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        return ([l for ls, _ in parts for l in ls],
                (type(tree), None, [s for _, s in parts]))
    return [tree], None


def _unflatten(spec: Any, leaves: List[torch.Tensor]) -> Pytree:
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        vals = [build(c) for c in subs]
        if kind == "dict":
            return dict(zip(keys, vals))
        return kind(vals) if kind in (list, tuple) else kind(*vals)

    return build(spec)


def bucketed_psum(grads: Pytree, group, bucket_bytes: int = 1 << 25
                  ) -> Pytree:
    """All-reduce (sum) ``grads`` over ``group`` in buckets of at most
    ``bucket_bytes``, leaves taken in the reference's order: each
    bucket's leaves are flattened into one buffer per dtype, reduced by
    one ``all_reduce`` and split back.  Distinct buckets let the
    reductions of early buckets overlap later backward work."""
    leaves, spec = _flatten(grads)
    out: List[torch.Tensor] = []
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, leaf in enumerate(bucket):
            by_dtype.setdefault(leaf.dtype, []).append(i)
        reduced: List[torch.Tensor] = [None] * len(bucket)
        for idx in by_dtype.values():
            flat = all_reduce(torch.cat([bucket[i].reshape(-1)
                                         for i in idx]), group)
            for i, part in zip(idx, torch.split(
                    flat, [bucket[i].numel() for i in idx])):
                reduced[i] = part.view(bucket[i].shape)
        out.extend(reduced)
        bucket, size = [], 0

    for leaf in leaves:
        nbytes = leaf.numel() * leaf.element_size()
        if size + nbytes > bucket_bytes and bucket:
            flush()
        bucket.append(leaf)
        size += nbytes
    if bucket:
        flush()
    return _unflatten(spec, out)


# --- ring all-gather ----------------------------------------------------------


def ring_all_gather(x: torch.Tensor, group, axis_size: int) -> torch.Tensor:
    """All-gather as ``axis_size - 1`` hops of a ring (each rank sends to
    the next and receives from the previous, one
    ``batch_isend_irecv`` a hop), each hop free to overlap consumer
    compute; the chunks come back stacked in group-rank order, as
    ``all_gather`` gives them."""
    if axis_size != group.size():
        raise ValueError(f"axis_size {axis_size} != group size "
                         f"{group.size()}")
    idx = dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (idx + 1) % axis_size)
    prv = dist.get_global_rank(group, (idx - 1) % axis_size)
    cur = x.contiguous()
    if _staged(cur, group):
        cur = cur.cpu()
    chunks = [cur]
    for _ in range(axis_size - 1):
        buf = torch.empty_like(cur)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)]):
            req.wait()
        cur = buf
        chunks.append(cur)
    # chunk j holds the block of group rank (idx - j) mod S
    return torch.stack([chunks[(idx - r) % axis_size]
                        for r in range(axis_size)]).to(x.device)
