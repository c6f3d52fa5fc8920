"""GAT (and mean/sum/max aggregators) over an edge list (port of
``repro.models.gnn``).

The reference builds message passing from ``jax.ops.segment_sum`` /
``segment_max`` over the edge index (no CSR SpMM):
  SDDMM  = per-edge attention logits (gather src/dst features)
  softmax= segment_max + segment_sum over incoming edges per dst
  SpMM   = alpha-weighted segment_sum of source features.
XLA lowers those ops itself: no Pallas kernel is on this path, so the
port is plain PyTorch on either device.

Segment ops here are ``torch.segment_reduce`` over the edges sorted by
destination, which adds each node's incoming terms serially in their
edge order, as the reference's scatter-add does.  Each graph's edges
are sorted once (a stable sort by destination, and a stable sort of the
sources for the gradient of the source gather; cached per edge tensor,
so a training loop over one graph sorts once), and every gather and
segment reduction is an autograd ``Function`` whose backward is the
other one over the same sort: no ``index_add_``, ``scatter_add_`` or
``h[idx]`` backward, which add by atomics on the card, so a step gives
the same bits on every run.  A tie in a segment max splits its gradient
evenly between the tied edges, as JAX's does.

Under a mesh announced with ``distributed.context.activation_mesh``,
the graph's edges are this rank's block (the reference's production
cells shard the edges over every mesh axis) and the node arrays and
params are whole on every rank: each segment reduction all-reduces its
(N, ...) partials over the mesh (sum or max), and each gather's
backward all-reduces its partial node cotangent, so every rank holds
the whole forward and the whole parameter gradients.  This is the
program XLA's partitioner makes of the reference's sharded edges.

Shapes: full-graph (Cora / ogbn-products), sampled minibatch blocks
(fanout sampler in ``repro_torch.data.graph_sampler``), and batched
small graphs (disjoint-union batching) all share this one layer.
``init_params`` and ``params_from_numpy`` run on the card unless given
``device="cpu"``; the forwards and losses run where their inputs lie.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import GNNConfig
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed.collectives import all_reduce
from repro_torch.models.layers import (cross_entropy_loss, from_numpy,
                                       normal, tree_map)

Params = Dict[str, torch.Tensor]


class Graph(NamedTuple):
    feat: torch.Tensor       # (N, F)
    edge_src: torch.Tensor   # (E,) int32
    edge_dst: torch.Tensor   # (E,) int32
    label: torch.Tensor      # (N,) int32, -1 = unlabeled
    edge_mask: Optional[torch.Tensor] = None  # (E,) bool for padded edges


# ---------------------------------------------------------------------------
# segment ops over a sorted edge list
# ---------------------------------------------------------------------------


class _Index:
    """An (E,) index into N rows, with the stable permutation that groups
    equal entries (``order``; None when ``idx`` is sorted already) and
    each row's count: what a gather's backward and a segment reduction
    need.  With a ``group``, ``idx`` is this rank's block of the edges
    and every (N, ...) reduction is all-reduced over the group."""

    def __init__(self, idx: torch.Tensor, n: int, sorted_: bool,
                 group=None):
        self.idx = idx
        self.group = group
        self.order = None if sorted_ else torch.argsort(idx, stable=True)
        keys = idx if sorted_ else idx.index_select(0, self.order)
        bounds = torch.searchsorted(
            keys, torch.arange(n + 1, device=idx.device, dtype=idx.dtype))
        self.counts = bounds[1:] - bounds[:-1]

    def reduce(self, data: torch.Tensor, how: str) -> torch.Tensor:
        """(N, ...) per-row ``how`` ("sum" or "max") of (E, ...) ``data``,
        each row's terms in edge order; an empty row is 0 or -inf."""
        if self.order is not None:
            data = data.index_select(0, self.order)
        out = torch.segment_reduce(data, how, lengths=self.counts, axis=0,
                                   unsafe=True)
        if self.group is not None:
            op = dist.ReduceOp.MAX if how == "max" else dist.ReduceOp.SUM
            out = all_reduce(out, self.group, op=op)
        return out

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(v, self)

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        return _SegmentSum.apply(data, self)

    def max(self, data: torch.Tensor) -> torch.Tensor:
        return _SegmentMax.apply(data, self)


class _Gather(torch.autograd.Function):
    """``v[idx]``; its gradient is the segment sum of the cotangent."""

    @staticmethod
    def forward(ctx, v, ix):
        ctx.ix = ix
        return v.index_select(0, ix.idx)

    @staticmethod
    def backward(ctx, g):
        return ctx.ix.reduce(g, "sum"), None


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ix):
        ctx.ix = ix
        return ix.reduce(data, "sum")

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.ix.idx), None


class _SegmentMax(torch.autograd.Function):
    """Per-row max; the cotangent of a row is split evenly between the
    edges that reach its max."""

    @staticmethod
    def forward(ctx, data, ix):
        out = ix.reduce(data, "max")
        ctx.ix = ix
        ctx.save_for_backward(data, out)
        return out

    @staticmethod
    def backward(ctx, g):
        data, out = ctx.saved_tensors
        ix = ctx.ix
        tie = data == out.index_select(0, ix.idx)
        share = g / ix.reduce(tie.to(g.dtype), "sum")
        return torch.where(tie, share.index_select(0, ix.idx), 0.0), None


class _Edges(NamedTuple):
    """A graph's edges in destination order (stable), with the index
    structures of its gathers and segment reductions."""
    src: _Index
    dst: _Index
    mask: Optional[torch.Tensor]


_EDGES = WeakTensorKeyDictionary()


def _mesh_group():
    """The group of every axis of the announced mesh, or None."""
    mesh = mesh_ctx.current_mesh()
    if mesh is None:
        return None
    return mesh_ctx.axis_group_of(tuple(mesh.mesh_dim_names))


def _edges(g: Graph, n_nodes: int) -> _Edges:
    """``g``'s edges sorted by destination, built once per edge tensor."""
    group = _mesh_group()
    cached = _EDGES.get(g.edge_dst)
    if cached is not None and cached[0] == n_nodes and all(
            a is b for a, b in zip(cached[1:4],
                                   (g.edge_src, g.edge_mask, group))):
        return cached[4]
    dst = g.edge_dst.long()
    order = torch.argsort(dst, stable=True)
    mask = None if g.edge_mask is None else g.edge_mask.index_select(0, order)
    e = _Edges(_Index(g.edge_src.long().index_select(0, order), n_nodes,
                      sorted_=False, group=group),
               _Index(dst.index_select(0, order), n_nodes, sorted_=True,
                      group=group),
               mask)
    _EDGES[g.edge_dst] = (n_nodes, g.edge_src, g.edge_mask, group, e)
    return e


# ---------------------------------------------------------------------------
# layer
# ---------------------------------------------------------------------------


def gat_layer_init(gen: torch.Generator, d_in: int, d_out: int,
                   n_heads: int) -> Params:
    s = 1.0 / np.sqrt(d_in)
    return {
        "w": normal(gen, (d_in, n_heads, d_out)) * s,
        "a_src": normal(gen, (n_heads, d_out)) * 0.1,
        "a_dst": normal(gen, (n_heads, d_out)) * 0.1,
        "b": torch.zeros((n_heads, d_out), dtype=torch.float32,
                         device=gen.device),
    }


def gat_layer(p: Params, g: Graph, x: torch.Tensor, *, n_nodes: int,
              aggregator: str = "attn", final: bool = False) -> torch.Tensor:
    """x: (N, F) -> (N, heads*d_out) (concat) or (N, d_out) (final mean)."""
    e = _edges(g, n_nodes)
    h = torch.einsum("nf,fhd->nhd", x, p["w"])           # (N, H, D)
    src_h = e.src.gather(h)                              # (E, H, D)
    if aggregator == "attn":
        # SDDMM: edge logits
        e_src = e.src.gather(torch.einsum("nhd,hd->nh", h, p["a_src"]))
        e_dst = e.dst.gather(torch.einsum("nhd,hd->nh", h, p["a_dst"]))
        logits = F.leaky_relu(e_src + e_dst, 0.2)        # (E, H)
        if e.mask is not None:
            logits = torch.where(e.mask[:, None], logits, -1e30)
        # segment softmax over incoming edges of each dst
        mx = e.dst.max(logits)
        ex = torch.exp(logits - e.dst.gather(mx))
        if e.mask is not None:
            ex = torch.where(e.mask[:, None], ex, 0.0)
        den = e.dst.sum(ex)
        alpha = ex / torch.clamp_min(e.dst.gather(den), 1e-9)
        msg = src_h * alpha[..., None]
        out = e.dst.sum(msg)
    elif aggregator in ("mean", "sum"):
        m = src_h if e.mask is None else src_h * e.mask[:, None, None]
        out = e.dst.sum(m)
        if aggregator == "mean":
            ones = torch.ones(e.dst.idx.shape, dtype=x.dtype,
                              device=x.device) if e.mask is None \
                else e.mask.to(x.dtype)
            deg = e.dst.sum(ones)
            out = out / torch.clamp_min(deg, 1.0)[:, None, None]
    elif aggregator == "max":
        m = src_h if e.mask is None else \
            torch.where(e.mask[:, None, None], src_h, -1e30)
        out = e.dst.max(m)
        out = torch.clamp_min(out, -1e29)
    else:
        raise ValueError(aggregator)
    out = out + p["b"]
    if final:
        return out.mean(dim=1)                           # average heads
    return F.elu(out).reshape(n_nodes, -1)               # concat heads


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def init_params(cfg: GNNConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights at ``cfg``'s shapes, drawn from a ``torch.Generator``
    seeded with ``seed`` on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Params = {}
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        p[f"layer_{i}"] = gat_layer_init(gen, d_in, d_out, cfg.n_heads)
        d_in = cfg.d_hidden * cfg.n_heads
    return p


def params_from_numpy(cfg: GNNConfig, tree: Params,
                      device: DeviceLike = None) -> Params:
    """The reference's parameter tree (numpy arrays) as the port's params
    on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: from_numpy(a, dev), tree)


def forward(cfg: GNNConfig, params: Params, g: Graph) -> torch.Tensor:
    n = g.feat.shape[0]
    x = g.feat
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        x = gat_layer(params[f"layer_{i}"], g, x, n_nodes=n,
                      aggregator=cfg.aggregator, final=last)
    return x                                             # (N, n_classes)


def forward_blocks(cfg: GNNConfig, params: Params, feats: torch.Tensor,
                   blocks: Sequence[Dict[str, torch.Tensor]],
                   n_outs: Tuple[int, ...]) -> torch.Tensor:
    """Minibatch path over sampled blocks (outermost-first list of
    tensor-dicts; see repro_torch.data.graph_sampler). feats: features
    of blocks[-1].nodes; n_outs: per-block output-prefix sizes."""
    x = feats
    for i in range(cfg.n_layers):
        b = blocks[-1 - i]              # innermost block = first layer
        n_in = x.shape[0]
        g = Graph(feat=x, edge_src=b["edge_src"], edge_dst=b["edge_dst"],
                  label=torch.zeros((n_in,), dtype=torch.int32,
                                    device=x.device),
                  edge_mask=b["edge_mask"])
        last = i == cfg.n_layers - 1
        x = gat_layer(params[f"layer_{i}"], g, x, n_nodes=n_in,
                      aggregator=cfg.aggregator, final=last)
        x = x[: n_outs[len(blocks) - 1 - i]]
    return x


def _ce_acc(logits: torch.Tensor, labels: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict]:
    labels = labels.long()
    mask = (labels >= 0).float()
    ce = cross_entropy_loss(logits, labels.clamp_min(0), mask)
    acc = torch.sum((logits.argmax(-1) == labels) * mask) / \
        torch.clamp_min(mask.sum(), 1.0)
    return ce, {"acc": acc}


def loss_blocks(cfg: GNNConfig, params: Params, feats: torch.Tensor,
                blocks: Sequence[Dict[str, torch.Tensor]],
                labels: torch.Tensor,
                n_outs: Tuple[int, ...]) -> Tuple[torch.Tensor, Dict]:
    return _ce_acc(forward_blocks(cfg, params, feats, blocks, n_outs),
                   labels)


def loss_fn(cfg: GNNConfig, params: Params, g: Graph
            ) -> Tuple[torch.Tensor, Dict]:
    return _ce_acc(forward(cfg, params, g), g.label)
