"""Parameter / activation partition rules per model family (port of
``repro.distributed.sharding``).

Mesh axes (``launch/mesh.py``): optional "pod" (cross-pod DP), "data"
(FSDP), "model" (TP/EP).  LM params are TP-sharded on head/ff/vocab
dims over ``model`` and FSDP-sharded on the complementary dim over
``data`` (ZeRO-3-alike — optimizer moments inherit the same specs).

A spec is a tuple with one entry per tensor dim, as a
``PartitionSpec``'s: ``None`` (replicated), an axis name, or a tuple of
axis names (the dim split over them, the first one major).  Specs
compare entry by entry with the reference's.  The port's LM keeps its
layers in a list, where the reference stacks them on a leading scan
axis: a layer leaf's spec is the reference's without that leading
``None``.  :func:`placements` turns a spec into ``DTensor`` placements
and :func:`distribute` places a tree by its specs.

``mesh`` is a ``DeviceMesh`` or, for the rules alone, a ``(shape,
names)`` pair such as ``launch.mesh.production_mesh_shape()`` returns.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

Pytree = Any
Spec = Tuple[Any, ...]


def _axes(mesh) -> Dict[str, int]:
    """The mesh's axis sizes by name, in mesh order."""
    if isinstance(mesh, tuple):
        shape, names = mesh
        return dict(zip(names, shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    """All data-parallel axes present in the mesh ("pod" included)."""
    return tuple(a for a in _axes(mesh) if a in ("pod", "data"))


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = _axes(mesh)
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= sizes[a]
        return n
    return sizes[entry]


def fit(spec: Spec, shape, mesh) -> Spec:
    """Drop sharding on dims the shape does not divide evenly — program
    inputs must shard exactly.  E.g. minicpm's vocab 73448 is not
    divisible by model=16, so its embedding falls back to
    replicated-on-vocab."""
    shape = tuple(shape)
    entries = [_canonical(e) for e in spec] + [None] * (len(shape)
                                                         - len(spec))
    return tuple(e if e is not None and dim % _axis_size(mesh, e) == 0
                 else None for dim, e in zip(shape, entries))


def _canonical(entry):
    """An entry as ``PartitionSpec`` keeps it: a one-axis tuple is that
    axis, an empty one None."""
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


def _map_with_path(fn, tree, path=""):
    """``fn(keystr, leaf)`` over a tree of dicts, lists and tuples, keyed
    as ``jax.tree_util.keystr`` keys a dict (``['name']``) and a
    sequence (``[i]``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_map_with_path(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def fit_tree(specs, tree, mesh):
    """:func:`fit` of every spec to its leaf's shape (``tree`` a tree of
    tensors, ``specs`` the same tree of specs)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return fit(specs, tree.shape, mesh)
    if isinstance(tree, dict):
        return {k: fit_tree(specs[k], tree[k], mesh) for k in tree}
    return type(tree)(fit_tree(s, t, mesh) for s, t in zip(specs, tree))


# --- LM ---------------------------------------------------------------------

_LM_RULES = [
    # (path regex, spec builder given leaf ndim)
    (r"\['embed'\]$",                lambda n: ("model", "data")),
    (r"\['out'\]\['w'\]$",           lambda n: ("data", "model")),
    (r"\['out'\]\['b'\]$",           lambda n: ("model",)),
    (r"\['attn'\]\['w[qkv]'\]\['w'\]$", lambda n: ("data", "model")),
    (r"\['attn'\]\['w[qkv]'\]\['b'\]$", lambda n: ("model",)),
    (r"\['attn'\]\['wo'\]\['w'\]$",  lambda n: ("model", "data")),
    (r"\['attn'\]\['wo'\]\['b'\]$",  lambda n: (None,)),
    # MLA
    (r"\['wq_a'\]\['w'\]$",          lambda n: ("data", None)),
    (r"\['wq_b'\]\['w'\]$",          lambda n: (None, "model")),
    (r"\['wkv_a'\]\['w'\]$",         lambda n: ("data", None)),
    (r"\['wk_b'\]\['w'\]$",          lambda n: (None, "model")),
    (r"\['wv_b'\]\['w'\]$",          lambda n: (None, "model")),
    # dense MLP
    (r"\['mlp'\]\['w[ig]'\]\['w'\]$", lambda n: ("data", "model")),
    (r"\['mlp'\]\['wo'\]\['w'\]$",   lambda n: ("model", "data")),
    # MoE
    (r"\['moe'\]\['router'\]\['w'\]$", lambda n: (None, None)),
    # expert weights: EP on E + FSDP on d/ff; the MoE mesh path
    # all-gathers them on use (ZeRO-3) — see models/moe.py
    (r"\['moe'\]\['w[ig]'\]$",       lambda n: ("model", "data", None)),
    (r"\['moe'\]\['wo'\]$",          lambda n: ("model", "data", None)),
    (r"\['moe'\]\['shared'\]\['w[ig]'\]\['w'\]$",
     lambda n: (None, "model")),
    (r"\['moe'\]\['shared'\]\['wo'\]\['w'\]$",
     lambda n: ("model", None)),
]


def lm_param_specs(params: Pytree, mesh=None) -> Pytree:
    """A spec for every leaf of the port's LM params (fitted to the leaf
    when ``mesh`` is given); norms and small leftovers replicate."""
    def spec_for(ks, leaf):
        for pat, mk in _LM_RULES:
            if re.search(pat, ks):
                s = mk(leaf.dim())
                return fit(s, leaf.shape, mesh) if mesh is not None else s
        return ()

    return _map_with_path(spec_for, params)


def lm_cache_specs(cache, mesh, *, seq_sharded: bool) -> Tuple[Spec, ...]:
    """Specs of an ``LMCache``'s tensors, in ``cache.data``'s order. KV
    caches (L, B, S, KV, hd): batch over DP; KV heads over model when
    they divide evenly (deepseek kv=16 @ TP16), else the sequence dim
    carries the model sharding (qwen kv=40, dbrx kv=8, starcoder2 kv=2 —
    S is always a power of two). long-context (B=1) shards S over every
    axis."""
    dp = dp_axes(mesh)
    ms = _axes(mesh)["model"]
    all_axes = tuple(_axes(mesh))

    def spec_for(leaf):
        if leaf is None:
            return None
        shape = tuple(leaf.shape)
        if len(shape) == 5:      # gqa k/v (L,B,S,KV,hd)
            b, kv = shape[1], shape[3]
            if b == 1:
                return fit((None, None, all_axes, None, None), shape, mesh)
            if kv % ms == 0:
                return fit((None, dp, None, "model", None), shape, mesh)
            return fit((None, dp, "model", None, None), shape, mesh)
        if len(shape) == 4:      # int8 scales (L,B,S,KV)
            b, kv = shape[1], shape[3]
            if b == 1:
                return fit((None, None, all_axes, None), shape, mesh)
            if kv % ms == 0:
                return fit((None, dp, None, "model"), shape, mesh)
            return fit((None, dp, "model", None), shape, mesh)
        if len(shape) == 3:      # mla (L,B,S,r)
            b = shape[1]
            if b == 1:
                return fit((None, None, all_axes, None), shape, mesh)
            return fit((None, dp, "model", None), shape, mesh)
        return ()

    data = cache.data if hasattr(cache, "data") else cache
    return tuple(spec_for(t) for t in data)


# --- GNN ---------------------------------------------------------------------

def gnn_param_specs(params: Pytree) -> Pytree:
    return _map_with_path(lambda _, __: (), params)


def gnn_input_specs(mesh) -> Any:
    """Edges sharded over every mesh axis; node arrays replicated."""
    from repro_torch.models.gnn import Graph
    all_axes = tuple(_axes(mesh))
    return Graph(feat=(), edge_src=(all_axes,), edge_dst=(all_axes,),
                 label=(), edge_mask=None)


# --- RecSys -------------------------------------------------------------------

def recsys_param_specs(params: Pytree, mesh=None) -> Pytree:
    def spec_for(ks, leaf):
        s: Spec = ()
        if re.search(r"\['(table|linear_table)'\]$", ks):
            s = ("model", None)          # row-sharded embedding tables
        elif re.search(r"\['l\d+'\]\['w'\]$", ks) and leaf.dim() == 2 \
                and leaf.shape[0] >= 512:
            s = ("data", "model")        # big tower/mlp matrices
        return fit(s, leaf.shape, mesh) if mesh is not None else s

    return _map_with_path(spec_for, params)


# --- DTensor placement --------------------------------------------------------

def placements(spec: Optional[Spec], mesh) -> Tuple:
    """The ``DTensor`` placements of ``spec`` on a ``DeviceMesh``: on
    each mesh dim, ``Shard(i)`` for the tensor dim ``i`` whose entry
    names it, ``Replicate()`` elsewhere.  A dim named by several axes is
    split over them in mesh order, which is the spec's major-first
    order for the production meshes' axis orders."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dim = None
        for i, e in enumerate(spec or ()):
            if e == name or (isinstance(e, tuple) and name in e):
                dim = i
        out.append(Shard(dim) if dim is not None else Replicate())
    return tuple(out)


def distribute(tree: Pytree, specs: Pytree, mesh) -> Pytree:
    """Every tensor of ``tree`` (dicts, lists, tuples and NamedTuples of
    tensors) as a ``DTensor`` on ``mesh``, placed by the spec at the
    same place in ``specs``."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, placements(specs, mesh))
    if isinstance(tree, dict):
        return {k: distribute(tree[k], specs[k], mesh) for k in tree}
    parts = [distribute(t, s, mesh) for t, s in zip(tree, specs)]
    return type(tree)(*parts) if hasattr(tree, "_fields") \
        else type(tree)(parts)
