"""Mesh context (port of ``repro.distributed.context``): the launcher
announces its ``DeviceMesh`` and model code asks for its axes and their
process groups; with no mesh announced, model code runs on one device.

The reference's ``act`` (a sharding constraint on an activation) has no
meaning in eager PyTorch, where each rank holds its own block of every
tensor, and is not carried.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

from repro_torch.launch.mesh import axis_group

_STATE = threading.local()


@contextlib.contextmanager
def activation_mesh(mesh):
    """Announce ``mesh`` (a ``DeviceMesh`` over the initialised group,
    ``launch.mesh.make_local_mesh``) to model code inside the block."""
    prev = (getattr(_STATE, "mesh", None), getattr(_STATE, "groups", None))
    _STATE.mesh, _STATE.groups = mesh, {}
    try:
        yield
    finally:
        _STATE.mesh, _STATE.groups = prev


def current_mesh():
    return getattr(_STATE, "mesh", None)


def dp_axes() -> Optional[Tuple[str, ...]]:
    m = current_mesh()
    if m is None:
        return None
    return tuple(a for a in m.mesh_dim_names if a in ("pod", "data")) or None


def model_axis() -> Optional[str]:
    m = current_mesh()
    if m is None or "model" not in m.mesh_dim_names:
        return None
    return "model"


def model_size() -> int:
    m = current_mesh()
    if m is None or "model" not in m.mesh_dim_names:
        return 1
    return m.mesh.shape[m.mesh_dim_names.index("model")]


def axis_group_of(axes: Sequence[str]):
    """The process group of this rank along ``axes`` of the current mesh
    (several axes flattened row-major, as ``shard_map`` splits a dim over
    them), built once per ``activation_mesh`` block: every rank must ask
    for the same axes in the same order."""
    axes = tuple(axes)
    groups = _STATE.groups
    if axes not in groups:
        groups[axes] = axis_group(current_mesh(), axes)
    return groups[axes]

