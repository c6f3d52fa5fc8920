"""Dry-run cell construction: one Cell per (arch × shape × mesh) (port of
``repro.launch.cells``).

A Cell carries a program and its arguments for rank 0 of the production
mesh, on ``meta`` tensors (shapes and dtypes, no storage):
``launch.dryrun`` runs it under a ``"fake"`` process group of the
mesh's size and counts it (``launch.cost_analysis``).

- **What the reference leaves to XLA's partitioner** (the LM's
  parameter rules, the recsys models' row-sharded tables and towers)
  runs as ``DTensor``s placed by ``distributed.sharding``'s specs, and
  ``DTensor`` inserts the collectives.  The programs run under
  ``implicit_replication`` (a plain tensor made inside the model, such
  as the positions, counts as replicated), with attention on its plain
  chunked path, which is what the reference's dry run lowers (it lowers
  no Pallas kernel); DeepFM's bags on ``meta`` tensors are the sums of
  the gathered rows.
- **What the port runs with explicit mesh code** runs that code:
  ``core.distributed_ivf.make_distributed_search`` and
  ``core.kmeans.sharded_assign_step`` on rank 0's shard blocks, and the
  GAT's mesh path (``models.gnn``: this rank's block of the edges, every
  segment reduction all-reduced), since ``DTensor`` has no sharding rule
  for ``segment_reduce``.  The LM's programs take their blocks as an
  argument (``models.transformer.Blocks``): its MoE layers run
  ``moe_forward``'s mesh path on local blocks, and its attention blocks
  and decode steps run data parallel.
- The IVF search runs its whole step budget (``unroll_steps``): its
  early exit reads the scores, which storage-less tensors do not have.
  The reference costs it by unrolled 1- and 2-step programs too.
- ``cost_variants`` is gone: XLA counts a ``while`` body once, so the
  reference costs scanned programs by an unrolled L1/L2 delta; an eager
  program runs every layer and is counted directly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.configs.base import get_arch, shape_for
from repro_torch.distributed import sharding as shd
from repro_torch.launch.train import value_and_grad
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tf
from repro_torch.models.attention import plain_attention
from repro_torch.models.layers import tree_map
from repro_torch.optim.optimizers import adamw, warmup_cosine

META = torch.device("meta")


@dataclass
class Cell:
    name: str
    fn: Callable
    args: Tuple
    model_flops: float = 0.0               # global MODEL_FLOPS (6ND etc.)
    note: str = ""


def meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _abstract(init: Callable):
    """The tree ``init(device="cpu")`` builds, as ``meta`` tensors: it is
    drawn under ``FakeTensorMode``, so nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = init(device="cpu")
    return tree_map(lambda t: meta(t.shape, t.dtype), tree)


_GATHER_RULE: list = []


def _register_gather_rule() -> None:
    """``torch.gather`` on ``DTensor``s: the gathered dim whole, any other
    dim sharded alike in input, index and output (registered once per
    process).  ``DTensor``'s own rule answers a gather along a sharded
    dim with a masked partial sum whose mask fails on the LM loss's
    (B, S, 1) index of the vocab-sharded logits; this rule all-gathers
    the vocab dim instead."""
    if _GATHER_RULE:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.gather.default)
    def rule(x, dim, index, *rest):
        d = dim % x.ndim
        none = [None] * len(rest)
        out = [([Replicate()], [Replicate(), None, Replicate()] + none)]
        out += [([Shard(i)], [Shard(i), None, Shard(i)] + none)
                for i in range(x.ndim) if i != d]
        return out

    _GATHER_RULE.append(rule)


def _sharded_rows(op_call, args, kwargs):
    """``aten.embedding`` on a ``DTensor`` table, by the rule of
    ``distributed.embedding.make_sharded_lookup``: the table's row
    shards stay where they are (any other sharding of the table is
    gathered), each rank looks up the ids that fall in its rows and
    zeroes the others, and a sum over the mesh dims that shard the rows
    combines them.  The result keeps the placements of the ids (a
    tensor counts as replicated), gathered on the mesh dims that shard
    the rows.  ``DTensor``'s own rule masks the lookup by the ids'
    values, which storage-less tensors do not have."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate

    table, ids = args[0], args[1]
    mesh = table.device_mesh
    rows = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    table = table.redistribute(mesh, [p if i in rows else Replicate()
                                      for i, p in enumerate(table.placements)])
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim)
    ids = ids.redistribute(mesh, [Replicate() if i in rows else p
                                  for i, p in enumerate(ids.placements)])
    local, loc_ids = table.to_local(), ids.to_local()
    n = local.shape[0]
    coord = mesh.get_coordinate()
    r0 = 0
    for i in rows:                      # this rank's first row
        r0 = r0 * mesh.size(i) + coord[i]
    loc = loc_ids - r0 * n
    ok = (loc >= 0) & (loc < n)
    emb = F.embedding(loc.clamp(0, n - 1), local) * ok[..., None]
    out = [Partial() if i in rows else p
           for i, p in enumerate(ids.placements)]
    shape = tuple(ids.shape) + (local.shape[1],)
    return DTensor.from_local(emb, mesh, out, shape=shape,
                              stride=_contiguous(shape)) \
        .redistribute(mesh, ids.placements)


_META_RULES: list = []


def _register_meta_rules() -> None:
    """The rules of storage-less programs (registered once per process):
    ``aten::bincount`` on ``meta`` tensors, which has no meta kernel,
    gives ``minlength`` bins (a storage-less tensor holds no ids, and
    every bin count of the cells' programs, k-means' cluster counts,
    sets ``minlength`` to the number of ids it can hold); ``DTensor``
    looks rows up by :func:`_sharded_rows`."""
    if _META_RULES:
        return
    from torch.distributed.tensor import DTensor

    lib = torch.library.Library("aten", "IMPL")

    def bincount(x, weights=None, minlength=0):
        dtype = torch.int64 if weights is None else \
            torch.promote_types(weights.dtype, torch.float32)
        return x.new_empty((minlength,), dtype=dtype)

    lib.impl("bincount", bincount, "Meta")
    DTensor._op_dispatcher._custom_op_handlers[
        torch.ops.aten.embedding.default] = _sharded_rows
    _META_RULES.append(lib)


def _moe_on_local_blocks(p, x, cfg):
    """An MoE layer of a ``DTensor`` program run by ``moe_forward``'s mesh
    path, as the reference's ``shard_map`` runs it: where the DP ranks
    split the batch, ``x`` as this rank's block of it and the expert
    weights as their block of dim 1 over the DP axes; where they do not
    (a B=1 decode), the batch and the weights whole, which
    ``moe_forward`` runs as ``_moe_core``; the rest of the weights whole,
    the output back as a ``DTensor`` placed as ``x``'s block.  Under
    autograd the mesh path reduce-scatters the expert weights' gradients
    back to their DP shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.context import activation_mesh
    from repro_torch.models import moe as moe_lib

    mesh = x.device_mesh
    dp = shd.dp_axes(mesh)
    whole = [Replicate()] * mesh.ndim
    split = x.shape[0] % _size(mesh, dp) == 0
    rows = _rows(mesh) if split else whole
    xl = x.redistribute(mesh, rows).to_local()
    fsdp = [Shard(1) if n in dp else Replicate()
            for n in mesh.mesh_dim_names]
    pl = {k: tree_map(lambda w, k=k: w.redistribute(
        mesh, fsdp if split and k in moe_lib.EXPERT_WEIGHTS else whole)
        .to_local(), v) for k, v in p.items()}
    with activation_mesh(mesh):
        out, aux = moe_lib.moe_forward(pl, xl, cfg)
    return (DTensor.from_local(out, mesh, rows, shape=x.shape,
                               stride=_contiguous(x.shape)),
            DTensor.from_local(aux, mesh, whole, shape=aux.shape,
                               stride=aux.stride()))


def _rows(mesh):
    """Placements of a tensor split by rows over the DP axes, whole over
    the others."""
    from torch.distributed.tensor import Replicate, Shard

    dp = set(shd.dp_axes(mesh))
    return [Shard(0) if n in dp else Replicate() for n in mesh.mesh_dim_names]


def _contiguous(shape):
    return tuple(int(math.prod(shape[i + 1:])) for i in range(len(shape)))


def _data_parallel(fn):
    """``fn(p, x, cfg, *rest, **kw)``, an attention block or decode step,
    run on this rank's block of the batch (the whole batch when it does
    not split over the DP axes) with its weights gathered whole: the
    block is data parallel and replicated over the model axis.  The
    reference's partitioner splits the heads over the model axis, padding
    heads it does not divide (StarCoder2's 24 and 2, Qwen's and
    MiniCPM3's 40 over 16); ``DTensor`` picks head splits freely and
    cannot view an uneven split of (H * hd) as (H, hd), so here the
    attention blocks do not use the model axis.  A ``DTensor`` in
    ``rest`` (a layer's cache) is gathered the same way and written back
    after the call, as the decode steps write their caches in place; a
    tensor in ``rest`` (the positions) is cut to this rank's rows."""
    from torch.distributed.tensor import DTensor, Replicate

    def run(p, x, cfg, *rest, **kw):
        mesh = x.device_mesh
        whole = [Replicate()] * mesh.ndim
        split = x.shape[0] % _size(mesh, shd.dp_axes(mesh)) == 0
        rows = _rows(mesh) if split else whole
        xl = x.redistribute(mesh, rows).to_local()
        pl = tree_map(lambda w: w.redistribute(mesh, whole).to_local(), p)
        b = xl.shape[0]
        args = [a.redistribute(mesh, rows).to_local()
                if isinstance(a, DTensor) else
                a[:b] if isinstance(a, torch.Tensor) else a for a in rest]
        out = fn(pl, xl, cfg, *args, **kw)
        for a, loc in zip(rest, args):
            if isinstance(a, DTensor):
                a.copy_(DTensor.from_local(loc, mesh, rows, shape=a.shape,
                                           stride=_contiguous(a.shape)))

        def wrap(o):
            shape = (x.shape[0],) + tuple(o.shape[1:])
            return DTensor.from_local(o, mesh, rows, shape=shape,
                                      stride=_contiguous(shape))

        return tuple(wrap(o) for o in out) if isinstance(out, tuple) \
            else wrap(out)

    return run


def _mesh_blocks() -> tf.Blocks:
    """The LM's blocks in a ``DTensor`` program: the attention blocks and
    decode steps data parallel (:func:`_data_parallel`), the MoE layers
    ``moe_forward``'s mesh path (:func:`_moe_on_local_blocks`)."""
    from repro_torch.models import attention as attn

    return tf.Blocks(_data_parallel(attn.gqa_forward),
                     _data_parallel(attn.mla_forward),
                     _data_parallel(attn.gqa_decode),
                     _data_parallel(attn.mla_decode), _moe_on_local_blocks)


@contextlib.contextmanager
def program():
    """The context every cell's program runs in: plain tensors made inside
    a ``DTensor`` program count as replicated, and attention takes its plain
    chunked path."""
    from torch.distributed.tensor.experimental import implicit_replication

    _register_gather_rule()
    _register_meta_rules()
    with implicit_replication(), plain_attention():
        yield


def _dp(mesh) -> Tuple[str, ...]:
    return shd.dp_axes(mesh)


def _size(mesh, axes) -> int:
    return math.prod(shd._axes(mesh)[a] for a in axes)


def _make_opt():
    return adamw(warmup_cosine(3e-4, 100, 10_000))


def _train_step(loss, opt, params, opt_state, step_idx, batches):
    """Gradient accumulation over the micro-batches (f32 sums, then the
    mean), then the optimizer's in-place update."""
    total, grads = None, None
    for mb in batches:
        lv, g = value_and_grad(functools.partial(loss, batch=mb), params)
        g = tree_map(lambda t: t.float(), g)
        total = lv if total is None else total + lv
        grads = g if grads is None else tree_map_pair(torch.add, grads, g)
    if len(batches) > 1:
        total = total / len(batches)
        grads = tree_map(lambda t: t / len(batches), grads)
    opt.update(grads, opt_state, params, step_idx)
    return params, opt_state, total


def tree_map_pair(fn, a, b):
    if isinstance(a, dict):
        return {k: tree_map_pair(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [tree_map_pair(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _microbatches(cfg, mesh, batch_size, seq) -> int:
    """Gradient-accumulation depth: keep per-shard microbatch around
    <=16k tokens (activation memory), power of two, divides B/dp."""
    dp_size = _size(mesh, _dp(mesh))
    rows_per_shard = max(batch_size // dp_size, 1)
    m = 1
    while (rows_per_shard // m) * seq > 16384 and m < rows_per_shard \
            and (rows_per_shard // m) % 2 == 0:
        m *= 2
    return m


def _lm_params(cfg, mesh):
    p = _abstract(functools.partial(tf.init_params, cfg))
    return shd.distribute(p, shd.lm_param_specs(p, mesh), mesh)


def _tokens(mesh, bs, seq, spec):
    return shd.distribute(meta((bs, seq), torch.int32), spec, mesh)


def _lm_train_cell(spec, shape, mesh) -> Cell:
    cfg = spec.model
    bs, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    m = _microbatches(cfg, mesh, bs, seq)
    params = _lm_params(cfg, mesh)
    opt = _make_opt()
    opt_state = opt.init(params)
    # the (B, S) batch as m micro-batches of each DP rank's rows
    batches = [{k: _tokens(mesh, bs // m, seq, (_dp(mesh), None))
                for k in ("tokens", "labels")} for _ in range(m)]
    fn = functools.partial(_train_step, functools.partial(
        tf.loss_fn, cfg, blocks=_mesh_blocks()), opt)
    return Cell(
        name=f"{spec.arch_id}:{shape.name}", fn=fn,
        args=(params, opt_state, meta((), torch.int32), batches),
        model_flops=6.0 * cfg.active_param_count() * bs * seq,
        note=f"train_step = fwd+bwd+AdamW; remat/layer; "
             f"{m} microbatches")


def _lm_prefill_cell(spec, shape, mesh) -> Cell:
    cfg = spec.model
    bs, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    return Cell(
        name=f"{spec.arch_id}:{shape.name}",
        fn=functools.partial(tf.prefill, cfg, blocks=_mesh_blocks()),
        args=(_lm_params(cfg, mesh), _tokens(mesh, bs, seq,
                                             (_dp(mesh), None))),
        model_flops=2.0 * cfg.active_param_count() * bs * seq,
        note="prefill: chunked-causal attention, returns KV cache")


def _lm_decode_cell(spec, shape, mesh) -> Cell:
    cfg = spec.model
    bs, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    long = shape.kind == "long_decode"
    cache = tf.init_cache(cfg, bs, seq, device=META)
    specs = shd.lm_cache_specs(cache, mesh, seq_sharded=long)
    cache = tf.LMCache(cache.kind, shd.distribute(cache.data, specs, mesh))
    tok_spec = (None, None) if bs == 1 else (_dp(mesh), None)

    def fn(params, cache, token, pos):
        return tf.decode_step(cfg, params, cache, token, pos,
                              blocks=_mesh_blocks())

    return Cell(
        name=f"{spec.arch_id}:{shape.name}", fn=fn,
        args=(_lm_params(cfg, mesh), cache, _tokens(mesh, bs, 1, tok_spec),
              seq - 1),
        model_flops=2.0 * cfg.active_param_count() * bs,
        note=("long-context decode: KV cache sequence-sharded over all "
              "mesh axes" if long else
              f"decode: KV cache {cfg.kv_cache_dtype}, heads over model"))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _edge_block(e: int, mesh) -> int:
    """Rank 0's block of ``e`` edges sharded over every mesh axis."""
    return e // _size(mesh, shd._axes(mesh))


def _gnn_cell(spec, shape, mesh) -> Cell:
    from repro_torch.distributed.context import activation_mesh

    cfg0 = spec.model
    dims = shape.dims
    d_feat = dims.get("d_feat", cfg0.d_in)
    cfg = dataclasses.replace(cfg0, d_in=d_feat)
    params = _abstract(functools.partial(gnn_lib.init_params, cfg))
    opt = _make_opt()
    opt_state = opt.init(params)

    if shape.kind == "minibatch":
        from repro_torch.data.graph_sampler import block_shapes
        fanouts = (dims["fanout0"], dims["fanout1"])
        bn = dims["batch_nodes"]
        shapes = block_shapes(bn, fanouts)
        n_outs = tuple(o for (_, _, o) in shapes)
        blocks = [{"edge_src": meta((_edge_block(e, mesh),), torch.int32),
                   "edge_dst": meta((_edge_block(e, mesh),), torch.int32),
                   "edge_mask": meta((_edge_block(e, mesh),), torch.bool)}
                  for (e, _, _) in shapes]
        feats = meta((shapes[-1][1], d_feat))
        labels = meta((bn,), torch.int32)

        def loss(params, batch):
            return gnn_lib.loss_blocks(cfg, params, feats, batch, labels,
                                       n_outs)

        batch = blocks
        note = f"sampled minibatch, fanout {fanouts}"
    else:
        if shape.kind == "batched_graphs":
            bsz = dims["batch"]
            n = dims["n_nodes"] * bsz
            e = dims["n_edges"] * bsz
            note = f"disjoint union of {bsz} molecule graphs"
        else:
            n, e = dims["n_nodes"], dims["n_edges"]
            note = "full-graph training; edges sharded over all axes"
        e = ((e + 1023) // 1024) * 1024   # pad: inputs must shard evenly
        el = _edge_block(e, mesh)
        batch = gnn_lib.Graph(feat=meta((n, d_feat)),
                              edge_src=meta((el,), torch.int32),
                              edge_dst=meta((el,), torch.int32),
                              label=meta((n,), torch.int32))

        def loss(params, batch):
            return gnn_lib.loss_fn(cfg, params, batch)

    def fn(params, opt_state, step_idx, batch):
        with activation_mesh(mesh):
            return _train_step(loss, opt, params, opt_state, step_idx,
                               [batch])

    # GAT flops ~ 3*(edges*heads*d_hidden)*2 per layer fwd, x3 for bwd
    e_total = dims.get("n_edges", 0) * dims.get("batch", 1)
    mf = 6.0 * 3 * e_total * cfg.n_heads * cfg.d_hidden
    return Cell(name=f"{spec.arch_id}:{shape.name}", fn=fn,
                args=(params, opt_state, meta((), torch.int32), batch),
                model_flops=mf, note=note)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _recsys_flops(cfg, bsz: int) -> float:
    d_in = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    f = 0.0
    dims = (d_in,) + cfg.mlp + ((1,) if cfg.mlp else ())
    for a, b in zip(dims[:-1], dims[1:]):
        f += 2.0 * a * b
    for i, hk in enumerate(cfg.cin_layers):
        prev = cfg.n_sparse if i == 0 else cfg.cin_layers[i - 1]
        f += 2.0 * hk * prev * cfg.n_sparse * cfg.embed_dim
    if cfg.n_cross_layers:
        f += cfg.n_cross_layers * 2.0 * d_in * d_in
    if cfg.tower_mlp:
        dt = (cfg.n_sparse // 2) * cfg.embed_dim
        dims = (dt,) + cfg.tower_mlp
        for a, b in zip(dims[:-1], dims[1:]):
            f += 2.0 * 2.0 * a * b
    return f * bsz


def _recsys_batch(cfg, mesh, bsz, row_spec):
    dist = functools.partial(shd.distribute, mesh=mesh)
    return {"dense": dist(meta((bsz, max(cfg.n_dense, 0))),
                          (row_spec, None)),
            "sparse": dist(meta((bsz, cfg.n_sparse), torch.int32),
                           (row_spec, None)),
            "label": dist(meta((bsz,)), (row_spec,))}


def _recsys_cell(spec, shape, mesh) -> Cell:
    cfg = spec.model
    dp = _dp(mesh)
    dims = shape.dims
    p = _abstract(functools.partial(rec_lib.init_params, cfg))
    params = shd.distribute(p, shd.recsys_param_specs(p, mesh), mesh)
    name = f"{spec.arch_id}:{shape.name}"

    if shape.kind == "retrieval":
        nc = dims["n_candidates"]
        all_axes = tuple(shd._axes(mesh))
        if cfg.tower_mlp:
            # two-tower: dot the query against the candidate store
            d = cfg.tower_mlp[-1]
            cand_spec = shd.fit((all_axes, None), (nc, d), mesh)
            if cand_spec == (None, None):   # 1e6 % 256 != 0: fall back
                cand_spec = shd.fit((dp, None), (nc, d), mesh)
            q = shd.distribute(meta((max(dims["batch"], 1), d)),
                               (None, None), mesh)
            cand = shd.distribute(meta((nc, d)), cand_spec, mesh)
            return Cell(name=name,
                        fn=functools.partial(rec_lib.score_candidates,
                                             k=100),
                        args=(q, cand), model_flops=2.0 * nc * d,
                        note="brute-force candidate scoring (baseline); "
                             "see the :retrieval_cand_ivf cell for the "
                             "paper's early-exit path")
        # CTR models: pointwise-score 1M candidate items for one user
        # context, return the top-100
        rows = shd.fit((dp, None), (nc, cfg.n_sparse), mesh)[0]

        def fn(params, batch):
            return torch.topk(rec_lib.serve_logits(cfg, params, batch), 100)

        return Cell(name=name, fn=fn,
                    args=(params, _recsys_batch(cfg, mesh, nc, rows)),
                    model_flops=_recsys_flops(cfg, nc),
                    note="CTR pointwise scoring of 1M candidates + "
                         "top-100")

    bsz = dims["batch"]
    batch = _recsys_batch(cfg, mesh, bsz, dp)
    if shape.kind == "train_batch":
        opt = _make_opt()
        fn = functools.partial(_train_step,
                               functools.partial(rec_lib.loss_fn, cfg), opt)

        def step(params, opt_state, step_idx, batch):
            return fn(params, opt_state, step_idx, [batch])

        return Cell(name=name, fn=step,
                    args=(params, opt.init(params), meta((), torch.int32),
                          batch),
                    model_flops=_recsys_flops(cfg, bsz) * 3,
                    note="train_step; embedding tables row-sharded over "
                         "model")
    return Cell(name=name, fn=functools.partial(rec_lib.serve_logits, cfg),
                args=(params, batch), model_flops=_recsys_flops(cfg, bsz),
                note=f"pointwise scoring batch={bsz}")


# ---------------------------------------------------------------------------
# IVF (paper) cells
# ---------------------------------------------------------------------------


def _ivf_cell(spec, shape, mesh, *, arch_override=None) -> Cell:
    from repro_torch.core import distributed_ivf as divf
    from repro_torch.launch.mesh import axis_group, local_block

    cfg = arch_override or spec.model
    dp = _dp(mesh)
    model_size = shd._axes(mesh)["model"]
    if shape.kind == "ivf_build":
        from repro_torch.core.kmeans import sharded_assign_step
        n = shape.dims["sample"]
        step = sharded_assign_step(mesh, "data")
        rows = local_block(meta((n, cfg.dim)), axis_group(mesh, "data"))
        x = meta(rows.shape)            # its own storage: rank 0's block
        return Cell(name=f"{spec.arch_id}:{shape.name}", fn=step,
                    args=(x, meta((cfg.n_clusters, cfg.dim))),
                    model_flops=2.0 * n * cfg.n_clusters * cfg.dim,
                    note="one distributed Lloyd step (IVF build)")

    b = shape.dims["batch"]
    storage = getattr(cfg, "storage_dtype", "float32")
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}[storage]
    sh = divf.abstract_sharded(cfg.n_docs, cfg.dim, cfg.n_clusters,
                               cfg.list_pad, model_size, dtype=dt)
    if b % _size(mesh, dp):
        dp = ()                              # tiny batch: replicate
    w_ = getattr(cfg, "probe_width", 1)
    steps = int(np.ceil(cfg.n_probe / (model_size * w_)))
    fn = divf.make_distributed_search(
        mesh, n_probe=cfg.n_probe, k=cfg.k,
        patience_delta=cfg.patience_delta, patience_phi=cfg.patience_phi,
        list_pad=cfg.list_pad, dp_axes=dp, unroll_steps=steps,
        probe_width=w_, int8_docs=storage == "int8", device=META)
    # rank 0's (1, ...) shard blocks, each its own storage
    blocks = [meta((1,) + tuple(x.shape[1:]), x.dtype)
              for x in (sh.centroids, sh.docs, sh.doc_ids, sh.offsets,
                        sh.sizes, sh.doc_scales) if x is not None]
    # MODEL_FLOPS: centroid ranking happens once; the tile scan runs
    # `steps` times across all model shards.
    scan_flops = 2.0 * b * cfg.list_pad * cfg.dim * model_size * w_
    rank_flops = 2.0 * b * cfg.n_clusters * cfg.dim
    return Cell(
        name=f"{spec.arch_id}:{shape.name}",
        fn=lambda *a: fn(*a[:6], *(a[6:] or [None])),
        args=(*blocks[:5], meta((b, cfg.dim)), *blocks[5:]),
        model_flops=scan_flops * steps + rank_flops,
        note=f"patience search, {model_size} clusters/step, {steps} steps "
             f"(the whole budget: no exit on storage-less scores)")


def _retrieval_ivf_cell(spec, shape, mesh) -> Cell:
    """The paper's technique serving the two-tower candidate store."""
    cfg = spec.model
    rc = cb.RetrievalConfig(
        name="two-tower-ivf", n_docs=shape.dims["n_candidates"],
        dim=cfg.tower_mlp[-1], n_clusters=4096, n_probe=64, k=100,
        tau=10, patience_delta=7, list_pad=512)
    cell = _ivf_cell(spec, cb.ShapeSpec("retrieval_cand_ivf", "ivf_serve",
                                        {"batch": max(shape.dims["batch"],
                                                      1)}),
                     mesh, arch_override=rc)
    cell.note = "paper technique on the 1M-candidate store: " + cell.note
    return cell


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, mesh, spec=None) -> Cell:
    """``arch_id``'s cell at ``shape_name`` for rank 0 of ``mesh``
    (``spec``, an ``ArchSpec``, in place of the registry's: a reduced
    config)."""
    spec = spec or get_arch(arch_id)
    if shape_name == "retrieval_cand_ivf":
        return _retrieval_ivf_cell(spec, shape_for(spec, "retrieval_cand"),
                                   mesh)
    shape = shape_for(spec, shape_name)
    if spec.family == "lm":
        if shape.kind == "train":
            return _lm_train_cell(spec, shape, mesh)
        if shape.kind == "prefill":
            return _lm_prefill_cell(spec, shape, mesh)
        return _lm_decode_cell(spec, shape, mesh)
    if spec.family == "gnn":
        return _gnn_cell(spec, shape, mesh)
    if spec.family == "recsys":
        return _recsys_cell(spec, shape, mesh)
    if spec.family == "ivf":
        return _ivf_cell(spec, shape, mesh)
    raise ValueError(spec.family)


def all_cells() -> Tuple[Tuple[str, str], ...]:
    """The 40 assigned cells + the paper's own cells + the IVF-backed
    retrieval variant."""
    out = []
    for arch in cb.list_archs():
        spec = get_arch(arch)
        for s in spec.shapes:
            out.append((arch, s.name))
        if spec.family == "recsys" and spec.model.n_candidates:
            out.append((arch, "retrieval_cand_ivf"))
    return tuple(out)
