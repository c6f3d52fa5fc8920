"""Elastic scaling (port of ``repro.runtime.elastic``): checkpoints hold
global arrays, so a job restarted on another number of devices places
each leaf on its new mesh as it restores (``CheckpointManager.restore(
..., mesh=, placements=)``).  A leaf's placements are one per mesh
dimension, ``Shard(dim)`` or ``Replicate()`` from
``torch.distributed.tensor``: the reference's ``PartitionSpec``
``P("data", None)`` on a ``("data", "model")`` mesh is
``(Shard(0), Replicate())``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.mesh import _mesh_device_type

Tree = Any


def remesh(n_devices: int, *, model_parallel: int,
           axis_names: Tuple[str, ...] = ("data", "model")):
    """The (data, model) ``DeviceMesh`` of ``n_devices`` ranks: the
    initialised process group, which must hold that many."""
    from torch.distributed.device_mesh import init_device_mesh

    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model_parallel={model_parallel}")
    if dist.get_world_size() != n_devices:
        raise ValueError(f"the process group holds {dist.get_world_size()} "
                         f"ranks, not {n_devices}")
    return init_device_mesh(_mesh_device_type(),
                            (n_devices // model_parallel, model_parallel),
                            mesh_dim_names=axis_names)


def elastic_restore(ckpt: CheckpointManager, template: Tree, new_mesh,
                    pspecs: Tree, step: Optional[int] = None
                    ) -> Tuple[int, Tree]:
    """Restore a checkpoint onto a mesh of any size (scale up or down):
    every leaf a ``DTensor`` placed by its entry of ``pspecs``.  Every
    rank of ``new_mesh`` calls it."""
    return ckpt.restore(template, step, mesh=new_mesh, placements=pspecs)
