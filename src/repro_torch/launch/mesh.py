"""Device meshes over ``torch.distributed`` (port of
``repro.launch.mesh``) and a launcher for a mesh of local ranks.

The reference names its mesh axes ``("data", "model")`` (and ``"pod"``
across pods) and builds them with ``jax.make_mesh``; here each rank of an
initialised process group builds the same ``DeviceMesh`` with
``init_device_mesh``.  Functions only: importing this module touches no
process group and no device.

``launch`` is this package's counterpart of the reference tests'
``xla_force_host_platform_device_count``: it spawns ``world_size`` ranks
on this host, each joined to the group through a ``FileStore`` in a
fresh temporary directory (no fixed port, so launches run side by side),
with a per-operation ``timeout`` and a deadline for the whole launch, so
a rank that diverges fails the launch instead of hanging it.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device

Axes = Union[str, Sequence[str]]


def production_mesh_shape(multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production mesh's shape and axis names: one pod of 16 x 16 =
    256 chips ``("data", "model")``, or 2 pods x 256 = 512 chips
    ``("pod", "data", "model")``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _mesh_device_type() -> str:
    """NCCL meshes hold CUDA ranks; any other backend's hold host ranks
    (their collectives take CUDA tensors through host memory: see
    ``repro_torch.distributed.collectives``)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` over the initialised group, which
    must hold 256 (or 512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = production_mesh_shape(multi_pod)
    return init_device_mesh(_mesh_device_type(), shape,
                            mesh_dim_names=names)


def make_local_mesh(data: int = 2, model: int = 4):
    """A (data, model) ``DeviceMesh`` over the initialised group of
    ``data * model`` ranks (``launch`` starts them)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_mesh_device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def axis_group(mesh, axes: Axes):
    """The process group of this rank's ranks along ``axes`` (one mesh
    axis, or several flattened row-major, as ``jax.lax.axis_index``
    flattens them).  Several axes build new groups: every rank of the
    mesh must call this with the same ``axes``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} must follow the mesh's order "
                         f"{tuple(names)}")
    rest = [d for d in range(mesh.ndim) if d not in dims]
    size = math.prod(mesh.mesh.shape[d] for d in dims)
    layout = mesh.mesh.permute(*rest, *dims).reshape(-1, size)
    group, _ = dist.new_subgroups_by_enumeration(layout.tolist())
    return group


def axis_index(group) -> int:
    """This rank's index along a group's axes: its rank in the group,
    which is also its place in the group's ``all_gather``."""
    return dist.get_group_rank(group, dist.get_rank())


def local_block(x, group):
    """This rank's block of ``x`` split along dim 0 over ``group``: the
    slice a ``shard_map`` in_spec partitioned over the group's axes hands
    one device.  Reads only that block of a memory-mapped array.  Like
    ``shard_map``, it needs dim 0 to divide evenly."""
    n = group.size()
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split "
                         f"evenly over {n} ranks")
    c = x.shape[0] // n
    i = axis_index(group)
    return x[i * c: (i + 1) * c]


# -- launching a local mesh ---------------------------------------------------

def _rank_main(rank: int, world_size: int, backend: str, device: str,
               timeout: float, tmp: str) -> None:
    # every rank is on this host: talk over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device == "cpu":
        # one intra-op thread a rank: the ranks share the host's cores
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    with open(Path(tmp) / "call.pkl", "rb") as f:
        fn, args = pickle.load(f)
    dist.init_process_group(
        backend, store=dist.FileStore(str(Path(tmp) / "store"), world_size),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def launch(fn: Callable, world_size: int, *args: Any,
           backend: Optional[str] = None, device: DeviceLike = None,
           timeout: float = 60.0, deadline: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned
    ranks of one new process group and return each rank's result, in
    rank order.

    ``fn`` and ``args`` are pickled once into a file every rank reads
    (``fn`` by its import path: a module-level function), so the ranks
    start side by side whatever the size of ``args``; each result comes
    back through a pickle file the rank writes.  The ranks run on the
    card unless given ``device="cpu"`` (without a card that raises):
    ``"cuda"`` puts rank r on card r mod the card count, ``"cpu"`` gives
    each rank one intra-op thread.  ``backend`` defaults to NCCL on the
    card and gloo on the CPU.
    ``timeout`` (s) bounds each collective of the group; ``deadline``
    (s) the whole launch, after which every rank is killed and
    ``TimeoutError`` raised.  A rank that raises fails the launch with
    its traceback (``torch.multiprocessing.ProcessRaisedException``)
    and the other ranks are stopped."""
    import torch.multiprocessing as mp

    device = resolve_device(device).type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        with open(Path(tmp) / "call.pkl", "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(
            _rank_main, args=(world_size, backend, device, timeout, tmp),
            nprocs=world_size, join=False, start_method="spawn")
        end = time.monotonic() + deadline
        try:
            while not ctx.join(timeout=max(0.1, end - time.monotonic())):
                if time.monotonic() >= end:
                    raise TimeoutError(f"{world_size} ranks did not finish "
                                       f"within {deadline} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        outs = []
        for r in range(world_size):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
        return outs
