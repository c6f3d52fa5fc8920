"""Atomic, async checkpointing of tensor trees (port of
``repro.checkpoint.manager``).

Layout (one directory per step), the reference's exactly:
    <root>/step_00000123.tmp/  -> written, fsync'd, then renamed to
    <root>/step_00000123/      -> atomic publish (crash-safe)
        index.json             -> tree structure, keys, dtypes, shapes
        arr_00000.npy ...      -> one file per leaf (host copy)

A tree is nested dicts, lists, tuples and named tuples over tensors or
arrays.  Its leaves are written in JAX's flatten order (dict keys
sorted) under the key ``jax.tree_util.keystr`` gives them
(``"['centroids']"`` for a dict key, ``"[0]"`` for a list index,
``".name"`` for a named-tuple field), so either package reads a step the
other wrote.  ``restore(..., mesh=, placements=)`` places each leaf
on a ``DeviceMesh`` by its placements (``Shard(dim)`` / ``Replicate()``,
``torch.distributed.tensor``): the elastic restore of
``runtime.elastic`` onto a mesh of any size, since a step holds the
global arrays.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

Tree = Any


class CheckpointError(RuntimeError):
    """A checkpoint on disk is missing, truncated, or corrupt.

    Raised instead of raw ``KeyError``/``json``/``numpy`` tracebacks so
    the message always carries the offending path and the expected
    layout (``index.json`` + one ``arr_NNNNN.npy`` per leaf)."""


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _leaf_paths(tree: Tree, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) pairs in JAX's flatten order; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kl for k in sorted(tree)
                for kl in _leaf_paths(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kl for name in tree._fields
                for kl in _leaf_paths(getattr(tree, name), f"{path}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [kl for i, v in enumerate(tree)
                for kl in _leaf_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def _treedef_str(tree: Tree) -> str:
    """The tree's structure as ``str(jax.tree_util.tree_structure)``
    spells it (recorded in index.json, read by no loader)."""
    def s(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {s(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(s(v) for v in t) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(s(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(s(v) for v in t) \
                + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({s(tree)})"


def _unflatten(template: Tree, leaves) -> Tree:
    """``template``'s structure with its leaves taken from ``leaves``
    (an iterator) in flatten order."""
    if template is None:
        return None
    if isinstance(template, dict):
        vals = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: vals[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _to_host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        # a copy even on the CPU: the caller may write into the tensor
        # while the writer thread runs
        return v.detach().to("cpu", copy=True).numpy()
    return np.asarray(v)


def _read_index(path: str) -> Dict[str, Any]:
    """Parse <ckpt dir>/index.json with actionable failure modes."""
    idx_path = os.path.join(path, "index.json")
    if not os.path.isdir(path):
        raise CheckpointError(
            f"checkpoint directory {path!r} does not exist — expected a "
            f"published step dir (step_NNNNNNNN/) containing index.json "
            f"plus one arr_NNNNN.npy per leaf")
    if not os.path.exists(idx_path):
        raise CheckpointError(
            f"checkpoint {path!r} has no index.json — the directory is "
            f"incomplete (torn write? partial copy?); expected "
            f"index.json with keys 'step'/'keys'/'treedef' plus one "
            f"arr_NNNNN.npy per leaf")
    try:
        with open(idx_path) as f:
            index = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"{idx_path!r} is truncated or corrupt ({e}); the snapshot "
            f"cannot be trusted — restore an older step or delete this "
            f"directory") from e
    for key in ("step", "keys"):
        if key not in index:
            raise CheckpointError(
                f"{idx_path!r} is missing required field {key!r} — "
                f"expected schema {{'step': int, 'keys': [{{'key', "
                f"'file', 'dtype', 'shape'}}...], 'treedef': str}}")
    return index


def _load_leaf(path: str, entry: Dict[str, Any]) -> np.ndarray:
    fn = os.path.join(path, entry["file"])
    try:
        arr = np.load(fn, allow_pickle=False)
    except FileNotFoundError as e:
        raise CheckpointError(
            f"checkpoint {path!r} is missing array file "
            f"{entry['file']!r} for leaf {entry.get('key', '?')!r} "
            f"(expected dtype={entry.get('dtype')}, "
            f"shape={entry.get('shape')})") from e
    except (ValueError, EOFError, OSError) as e:
        raise CheckpointError(
            f"array file {fn!r} for leaf {entry.get('key', '?')!r} is "
            f"truncated or corrupt ({e}); expected "
            f"dtype={entry.get('dtype')}, shape={entry.get('shape')} — "
            f"restore an older step") from e
    want = entry.get("shape")
    if want is not None and list(arr.shape) != list(want):
        raise CheckpointError(
            f"array file {fn!r} for leaf {entry.get('key', '?')!r} has "
            f"shape {list(arr.shape)} but index.json recorded {want} — "
            f"the snapshot is internally inconsistent")
    return arr


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Tree) -> str:
        self.wait()
        # copy to host *before* handing to the writer thread, so the
        # caller may overwrite its device tensors at once
        host = [(k, _to_host(v)) for k, v in _leaf_paths(tree)]
        treedef = _treedef_str(tree)
        path = os.path.join(self.root, f"step_{step:08d}")

        def write():
            tmp = path + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            index = {"step": step, "keys": [], "treedef": treedef}
            for i, (k, v) in enumerate(host):
                fn = f"arr_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), v)
                index["keys"].append({"key": k, "file": fn,
                                      "dtype": str(v.dtype),
                                      "shape": list(v.shape)})
            with open(os.path.join(tmp, "index.json"), "w") as f:
                json.dump(index, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)            # atomic publish
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> Tuple[int, str]:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return step, os.path.join(self.root, f"step_{step:08d}")

    def restore(self, template: Tree, step: Optional[int] = None, *,
                device: DeviceLike = None, mesh=None,
                placements: Optional[Tree] = None) -> Tuple[int, Tree]:
        """Load into the structure of ``template``, every leaf a tensor
        on ``device`` (CUDA unless ``device="cpu"``).  With ``mesh`` and
        ``placements`` (a tree like ``template`` whose leaves are each a
        sequence of one placement per mesh dimension), every leaf is
        instead a ``DTensor`` distributed over ``mesh`` from the global
        array, which every rank reads: each rank of the mesh must call
        this."""
        if placements is not None:
            return self._restore_placed(template, step, mesh, placements)
        dev = resolve_device(device)
        step, path = self._step_dir(step)
        index = _read_index(path)
        arrays = [_load_leaf(path, e) for e in index["keys"]]
        n_leaves = len(_leaf_paths(template))
        if n_leaves != len(arrays):
            raise ValueError(
                f"checkpoint has {len(arrays)} leaves, template has "
                f"{n_leaves}")
        tensors = (torch.from_numpy(a).to(dev) for a in arrays)
        return step, _unflatten(template, tensors)

    def _restore_placed(self, template, step, mesh, placements):
        from torch.distributed.tensor import Placement, distribute_tensor

        def leaves(tree):
            if isinstance(tree, (list, tuple)) and tree and all(
                    isinstance(p, Placement) for p in tree):
                return [tuple(tree)]
            if isinstance(tree, dict):
                return [x for k in sorted(tree) for x in leaves(tree[k])]
            if isinstance(tree, (list, tuple)):
                return [x for v in tree for x in leaves(v)]
            raise ValueError(f"placements: {tree!r} is not a sequence of "
                             f"Placement")

        specs = leaves(placements)
        dev = "cpu" if mesh.device_type == "cpu" else None
        step, local = self.restore(template, step, device=dev)
        tensors = [t for _, t in _leaf_paths(local)]
        if len(specs) != len(tensors):
            raise ValueError(f"{len(specs)} placements for {len(tensors)} "
                             f"leaves")
        placed = (distribute_tensor(t, mesh, spec)
                  for t, spec in zip(tensors, specs))
        return step, _unflatten(template, placed)

    def load_arrays(self, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, np.ndarray]]:
        """Load a checkpoint as ``{key: host array}`` without a template.
        A dict tree saves ``"['name']"``; the surrounding quoting is
        stripped so callers see plain ``name``."""
        step, path = self._step_dir(step)
        index = _read_index(path)
        out: Dict[str, np.ndarray] = {}
        for e in index["keys"]:
            key = e["key"].strip("[]'\"")
            out[key] = _load_leaf(path, e)
        return step, out
