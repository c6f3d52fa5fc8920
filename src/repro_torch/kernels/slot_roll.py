"""Slot roll: a wave's lane state rolled through the fused advance's
per-probe snapshots, slot by slot, with the patience exit rule.

Replaces no TPU kernel: the reference rolls with ``jnp`` ops
(``src/repro/core/serving.py:141-180``), which XLA fuses under ``jit``.
On a CUDA tensor the wrapper launches ``csrc/slot_roll.cu``, one launch
for all slots of all lanes; on a CPU tensor it runs
:func:`slot_roll_plain`, the same roll as a chain of PyTorch ops (one
:func:`slot_step` a slot, some twenty ops each).  Run on the card, the
chain gives the kernel's bits: the kernel computes phi with the float32
operations that PyTorch's CUDA ops make (see the source).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build


class Lanes(NamedTuple):
    """The lane fields a slot moves (``core.serving.LaneState.lanes``)."""
    h: torch.Tensor             # (W,) int32 probes taken
    patience: torch.Tensor      # (W,) int32
    active: torch.Tensor        # (W,) bool
    topk_scores: torch.Tensor   # (W, k) float32
    topk_ids: torch.Tensor      # (W, k) int32


def slot_step(st: Lanes, ms: torch.Tensor, mi: torch.Tensor,
              phi_v: torch.Tensor, *, phi: float, lane_delta: torch.Tensor,
              lane_cap: torch.Tensor, min_probes: int = 1) -> Lanes:
    """One probe slot: active lanes take the merged top-k (ms, mi) and
    step h; patience counts slots whose phi_v reaches ``phi`` (from the
    second probe on) and resets elsewhere, inactive lanes included; a
    lane exits once patience reaches its ``lane_delta`` with h at least
    ``min_probes``, or once h reaches its ``lane_cap``."""
    act = st.active[:, None]
    ts = torch.where(act, ms, st.topk_scores)
    ti = torch.where(act, mi, st.topk_ids)
    ctr = torch.where(st.active & (st.h >= 1) & (phi_v >= phi),
                      st.patience + 1, 0)
    h = torch.where(st.active, st.h + 1, st.h)
    patient = ctr >= lane_delta
    if min_probes > 1:
        # an active lane's h is at least 1 here: the gate is void at 1
        patient = patient & (h >= min_probes)
    exited = st.active & (patient | (h >= lane_cap))
    return Lanes(h=h, patience=ctr, active=st.active & ~exited,
                 topk_scores=ts, topk_ids=ti)


def slot_roll_plain(snap_s: torch.Tensor, snap_i: torch.Tensor,
                    cnts: torch.Tensor, lanes: Lanes,
                    lane_delta: torch.Tensor, lane_cap: torch.Tensor, *,
                    k: int, chunk: int, phi: float,
                    min_probes: int = 1) -> Lanes:
    """``chunk`` calls of :func:`slot_step`, slot t's phi from its
    new-entry count, 100 (k - cnt) / k."""
    st = lanes
    for t in range(chunk):
        phi_v = 100.0 * (k - cnts[:, t]).to(torch.float32) / k
        st = slot_step(st, snap_s[:, t], snap_i[:, t], phi_v, phi=phi,
                       lane_delta=lane_delta, lane_cap=lane_cap,
                       min_probes=min_probes)
    return st


def slot_roll(snap_s: torch.Tensor, snap_i: torch.Tensor,
              cnts: torch.Tensor, lanes: Lanes, lane_delta: torch.Tensor,
              lane_cap: torch.Tensor, *, k: int, chunk: int,
              phi: float, min_probes: int = 1) -> Lanes:
    """(W, chunk, k) snapshot scores and int32 ids, (W, chunk) int32
    new-entry counts, the lanes' fields and (W,) int32 exit knobs -> the
    lanes' fields after ``chunk`` slots, in new tensors.  The patience
    exit waits for ``min_probes`` probes (a cascade's ``tau``)."""
    if k <= 0 or chunk <= 0:
        raise ValueError(f"slot_roll: k={k} and chunk={chunk} must be > 0")
    w = lanes.h.shape[0] if lanes.h.dim() else -1
    vec = (w,)
    dev = _build.check_inputs(
        "slot_roll", snap_s=(snap_s, torch.float32, (w, chunk, k)),
        snap_i=(snap_i, torch.int32, (w, chunk, k)),
        cnts=(cnts, torch.int32, (w, chunk)),
        h=(lanes.h, torch.int32, vec),
        patience=(lanes.patience, torch.int32, vec),
        active=(lanes.active, torch.bool, vec),
        topk_scores=(lanes.topk_scores, torch.float32, (w, k)),
        topk_ids=(lanes.topk_ids, torch.int32, (w, k)),
        lane_delta=(lane_delta, torch.int32, vec),
        lane_cap=(lane_cap, torch.int32, vec))
    if dev.type == "cpu":
        return slot_roll_plain(snap_s, snap_i, cnts, lanes, lane_delta,
                               lane_cap, k=k, chunk=chunk, phi=phi,
                               min_probes=min_probes)
    out = Lanes(*(torch.empty_like(t) for t in lanes))
    if w:
        _build.launch("slot_roll", dev, snap_s.data_ptr(), snap_i.data_ptr(),
                      cnts.data_ptr(), *(t.data_ptr() for t in lanes),
                      lane_delta.data_ptr(), lane_cap.data_ptr(),
                      *(t.data_ptr() for t in out), w, chunk, k,
                      min_probes, phi)
        slot_roll.launches += 1
    return out


slot_roll.launches = 0
