"""Delta buffer + tombstone set: the mutable half of the live index
(port of ``repro.index.delta``).

* :class:`DeltaBuffer` — a fixed-capacity, append-only staging area for
  recently added vectors, resident on the index's device.  Every entry
  records the cluster the vector will be merged into (nearest centroid,
  the rule ``merge_delta`` uses), which is what lets the overlay search
  stay bit-identical to a rebuilt index.  Slots are never reordered:
  within a cluster, merge order == insertion order == the order a
  rebuilt list would hold.  The id -> slot map stays on the host.
* :class:`Tombstones` — the cumulative set of deleted external doc ids
  (a host bool array), plus a dense device lookup used to scrub running
  top-k state that predates a deletion (mid-flight queries across
  version swaps).

Views and lookups are copies made on the device, so a published
version never changes under a later mutation.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.ivf import DeltaView
from repro_torch.core.kmeans import _assign_block


class DeltaFull(RuntimeError):
    """The delta buffer is out of slots — run ``merge_delta()``."""


def assign_clusters(vecs: torch.Tensor, centroids: torch.Tensor
                    ) -> torch.Tensor:
    """Nearest-centroid assignment, the rule of the k-means builder
    (``kmeans._assign_block``): argmax of x.c - 0.5|c|^2, on the
    centroids' device.  Returns (m,) int32."""
    return _assign_block(vecs, centroids)[0]


def _on(dev: torch.device, x, dtype: torch.dtype, what: str) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``dev``: host arrays are copied
    there, tensors must already lie there."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(f"{what} lies on {x.device}, the live index "
                             f"on {dev}")
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


class DeltaBuffer:
    def __init__(self, dim: int, capacity: int = 1024, *,
                 round_to: int = 128, device: DeviceLike = None):
        dev = resolve_device(device)
        cap = max(round_to, -(-capacity // round_to) * round_to)
        self.capacity = cap
        self.device = dev
        self.vecs = torch.zeros((cap, dim), dtype=torch.float32, device=dev)
        self.ids = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        self.assign = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        self.count = 0                      # slots consumed (append ptr)
        self._slot_of = {}                  # live external id -> slot
        self._view: Optional[DeltaView] = None

    def __len__(self) -> int:
        return len(self._slot_of)

    def occupancy(self) -> float:
        return self.count / self.capacity

    def ensure_room(self, m: int) -> None:
        if self.count + m > self.capacity:
            raise DeltaFull(
                f"delta buffer full ({self.count}/{self.capacity} slots "
                f"used, {m} more requested): call merge_delta() first")

    def add(self, vecs, ids, assign) -> None:
        vecs = _on(self.device, vecs, torch.float32, "vecs")
        ids_np = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                            else ids, np.int32)
        m = vecs.shape[0]
        self.ensure_room(m)
        sl = slice(self.count, self.count + m)
        self.vecs[sl] = vecs
        self.ids[sl] = _on(self.device, ids_np, torch.int32, "ids")
        self.assign[sl] = _on(self.device, assign, torch.int32, "assign")
        for j, i in enumerate(ids_np.tolist()):
            self._slot_of[i] = self.count + j
        self.count += m
        self._view = None

    def delete(self, doc_id: int) -> bool:
        """Tombstone a buffered entry in place (slot stays consumed so
        insertion order of the survivors is preserved)."""
        slot = self._slot_of.pop(int(doc_id), None)
        if slot is None:
            return False
        self.ids[slot] = -1
        self._view = None
        return True

    def live_slots(self) -> np.ndarray:
        """Slots holding a live entry, in insertion order (from the host
        map: no device read)."""
        return np.sort(np.fromiter(self._slot_of.values(), np.int64,
                                   len(self._slot_of)))

    def compact_keep(self, slots) -> None:
        """Drop everything except ``slots`` (merge spill-back): the
        kept entries move to the front, preserving their order."""
        slots = np.asarray(slots, np.int64)
        m = slots.size
        sl = torch.as_tensor(slots, device=self.device)
        self.vecs[:m] = self.vecs[sl]
        self.ids[:m] = self.ids[sl]
        self.assign[:m] = self.assign[sl]
        self.vecs[m:] = 0.0
        self.ids[m:] = -1
        self.assign[m:] = -1
        self.count = m
        self._slot_of = {i: s for s, i in enumerate(self.ids[:m].tolist())
                         if i >= 0}
        self._view = None

    def view(self) -> DeltaView:
        """Fixed-shape device view, cached until the next mutation.  A
        copy on the device: later mutations write the buffer in place and
        must not reach a version that is being served."""
        if self._view is None:
            self._view = DeltaView(self.vecs.clone(), self.ids.clone(),
                                   self.assign.clone())
        return self._view


class Tombstones:
    def __init__(self, id_capacity: int, *, round_to: int = 4096,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._cap = max(round_to, -(-id_capacity // round_to) * round_to)
        self._dead = np.zeros(self._cap, bool)
        self._round = round_to
        self.count = 0
        self._lookup: Optional[torch.Tensor] = None

    def ensure_capacity(self, n_ids: int) -> None:
        if n_ids <= self._cap:
            return
        cap = -(-n_ids // self._round) * self._round
        grown = np.zeros(cap, bool)
        grown[: self._cap] = self._dead
        self._dead, self._cap = grown, cap
        self._lookup = None

    def add(self, ids: Iterable[int]) -> None:
        for i in ids:
            if not self._dead[int(i)]:
                self._dead[int(i)] = True
                self.count += 1
        self._lookup = None

    def __contains__(self, doc_id: int) -> bool:
        i = int(doc_id)
        return 0 <= i < self._cap and bool(self._dead[i])

    def dead_ids(self) -> np.ndarray:
        return np.nonzero(self._dead)[0].astype(np.int32)

    def lookup(self) -> torch.Tensor:
        """(id_capacity,) bool device tensor for running-top-k scrubs: a
        copy, cached until the next change."""
        if self._lookup is None:
            self._lookup = torch.tensor(self._dead, device=self.device)
        return self._lookup
