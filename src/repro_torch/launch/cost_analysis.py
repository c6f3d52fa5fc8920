"""One device's cost of a program, counted while it runs on storage-less
tensors: the port's counterpart of ``repro.launch.hlo_analysis``.

The reference lowers a cell for the production mesh and reads XLA's
partitioned per-device program: ``cost_analysis()`` (flops, bytes
accessed), ``memory_analysis()`` and the result shapes of its
collectives.  Here rank 0 of a ``"fake"`` process group of the mesh's
size runs the program on ``meta`` tensors (no storage, so nothing is
allocated), with its parameters and inputs placed as ``DTensor``s or
as its own blocks, and :class:`CostCounter`, a dispatch mode, counts
every operation that runs on rank 0's local tensors:

- **flops:** ``torch.utils.flop_counter``'s formulas (the registry
  ``FlopCounterMode`` reads), so products, convolutions and attention.
  XLA's ``cost_analysis`` also counts elementwise and reduction flops,
  and counts after fusion; so the two ``flops`` differ by definition:
  the port's is the matrix-unit work only.
- **bytes:** each operation's tensor operands read and results written,
  views excluded.  XLA counts a fusion's operands and results once, so
  the unfused eager count is larger: an upper bound on traffic.
- **memory:** the bytes of the program's arguments, its results (those
  that are arguments written in place: ``alias``), and the peak of the
  storages the run creates that are alive at once (``temp``, outputs
  excluded), followed by weak references to each new storage.  Peak =
  argument + output + temp - alias, as the reference's.
- **collectives:** the result bytes and counts of every collective on
  the local tensors, by the reference's five kind names: the c10d
  functional collectives ``DTensor`` issues and the ``c10d`` ops the
  port's ``distributed/collectives.py`` issues (sends and receives count
  as ``collective-permute``).  Collectives are not in ``bytes``.

``DTensor``'s own sharding propagation runs on ``FakeTensor``s; those
operations are not the device's and are not counted.  The reference
counts a ``while`` body once, so it costs scanned programs by an
unrolled L1/L2 delta; an eager program runs and counts every layer, so
every record here is ``cost_method: "direct"``.  :func:`roofline_terms`
turns the counts into three times at the H100 SXM's data-sheet rates.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op name (without namespace and overload) -> the reference's kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_NOT_WORK = {"wait_tensor", "_wrap_tensor_autograd", "empty", "empty_like",
             "empty_strided", "detach", "alias", "lift_fresh"}

# --- hardware constants (NVIDIA H100 SXM data sheet) --------------------------

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # NVLink bytes/s per card, one direction


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float
                   ) -> Dict[str, float]:
    """All inputs are per-device quantities; outputs in seconds."""
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": hbm_bytes / HBM_BW,
             "collective_s": coll_bytes / LINK_BW}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]
                              if k.endswith("_s") else -1.0)
    return terms


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, n_bytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + n_bytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def to_dict(self) -> Dict:
        return {"bytes_by_kind": self.bytes_by_kind,
                "count_by_kind": self.count_by_kind,
                "total_bytes": self.total_bytes}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local block; any other tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _storage(t: torch.Tensor):
    return _local(t).untyped_storage()


def _key(storage) -> int:
    return storage._cdata


def storage_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """The bytes of the distinct (local) storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        s = _storage(t)
        seen[_key(s)] = s.nbytes()
    return sum(seen.values())


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class CostCounter(TorchDispatchMode):
    """Counts one device's flops, bytes, collectives and live storages
    while open (see the module docstring).  Operations on ``DTensor``s
    are handed to ``DTensor`` (``NotImplemented``), which runs them as
    operations on the local blocks: those are counted."""

    def __init__(self, arguments: Iterable[torch.Tensor] = ()):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_fns = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveStats()
        self.argument_bytes = storage_bytes(arguments)
        self._args = {_key(_storage(t)) for t in arguments}
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.n_ops = 0

    # -- live storages -------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        k = _key(s)
        if k in self._live or k in self._args:
            return
        n = s.nbytes()
        self._live[k] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(s, self._free, k)

    def _free(self, k: int) -> None:
        self.live_bytes -= self._live.pop(k, 0)

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(_is_dtensor(t) for t in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(_is_fake(t) for t in ins + outs):
            return out                  # DTensor's sharding propagation
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            res = outs if name not in ("send",) else ins
            self.collectives.add(kind, sum(t.numel() * t.element_size()
                                           for t in res))
            return out
        if name in _NOT_WORK or getattr(func, "is_view", False):
            return out
        self.n_ops += 1
        fn = self._flop_fns.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._track(t)
        return out

    def memory(self, outputs: Iterable[torch.Tensor]) -> Dict[str, float]:
        """The reference's memory record (GB) for a run whose results are
        ``outputs``."""
        outputs = list(outputs)
        out_b = storage_bytes(outputs)
        alias_b = storage_bytes(t for t in outputs
                                if _key(_storage(t)) in self._args)
        new_out = out_b - alias_b
        temp_b = max(self.peak_live_bytes - new_out, 0)
        return {"argument_gb": self.argument_bytes / 1e9,
                "output_gb": out_b / 1e9,
                "temp_gb": temp_b / 1e9,
                "alias_gb": alias_b / 1e9,
                "peak_gb": (self.argument_bytes + out_b + temp_b
                            - alias_b) / 1e9}

    def cost(self) -> Dict[str, float]:
        return {"flops": float(self.flops), "bytes": float(self.bytes)}


def count(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a :class:`CostCounter` whose
    arguments are ``args``' tensors; returns (result, counter)."""
    counter = CostCounter(_tensors((args, kwargs)))
    with counter:
        out = fn(*args, **kwargs)
    return out, counter
