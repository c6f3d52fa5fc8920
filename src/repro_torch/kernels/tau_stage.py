"""The learned exit's stage in one fused wave of the wave scheduler: the
lanes' Table-1 history, their features at probe ``tau``, the tree walk
and the Exit, in one launch.

Replaces no TPU kernel: the reference runs the stage as ``jnp`` under
``jit`` (``src/repro/core/policies.py:225-235``), which XLA fuses.  On
CUDA tensors the wrapper launches ``csrc/tau_stage.cu``, one launch for
all lanes of a wave; on CPU tensors it runs :func:`tau_stage_plain`, the
chain of PyTorch ops the scheduler ran before (``feature_matrix``,
then ``predict_margin``, then the sigmoid against the threshold), 169
launches at the benchmark's wave on the card.  Run on the card, the
chain gives the kernel's bits: the kernel makes the float32 operations
that PyTorch's CUDA ops make, in their order (see the source).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.features import FeatureExtras, feature_matrix
from repro_torch.kernels import _build
from repro_torch.trees.torch_infer import TreeEnsemble, predict_margin


class TauStageOut(NamedTuple):
    """What a wave's stage moves (``core.serving.TauLanes``' tensors)."""
    rs1_ids: torch.Tensor      # (W, k) int32 top-k after probe 1
    phi_hist: torch.Tensor     # (W, hist_w) f32 phi at probes 2..tau
    phi1_hist: torch.Tensor    # (W, hist_w) f32 % of RS_1 kept, same
    clf_exits: torch.Tensor    # () int64, the input counted in place
    lane_cap: torch.Tensor     # (W,) int32, tau where the trees exit


def tau_stage_plain(snap_s, snap_i, cnts, h, active, qvec, centroid_sims,
                    rs1_ids, phi_hist, phi1_hist, clf_exits, lane_cap,
                    clf: TreeEnsemble, *, tau: int, k: int, chunk: int,
                    n_probe: int, threshold: float) -> TauStageOut:
    """The stage as a chain of PyTorch ops, every lane at once: RS_1,
    the history columns of the chunk's slots, the Table-1 matrix at each
    lane's tau slot, the tree walk, and Exit where the stage falls in
    this wave."""
    from repro_torch.core.ivf import intersection_pct

    dev = h.device
    h0 = h[:, None]
    # the slots that merged: an active lane's, inside the probe budget
    ok = (h0 + torch.arange(chunk, device=dev)[None, :] < n_probe) \
        & active[:, None]
    rs1 = torch.where((ok[:, 0] & (h == 0))[:, None], snap_i[:, 0], rs1_ids)
    if tau > 1:
        # history column c holds probe c + 2 (0-based c + 1): slot c + 1 - h
        slot = torch.arange(phi_hist.shape[1], device=dev)[None, :] + 1 - h0
        at = slot.clamp(0, chunk - 1)
        upd = (slot >= 0) & (slot < chunk) & torch.gather(ok, 1, at)
        phi = 100.0 * (k - cnts).to(torch.float32) / k
        phi1 = intersection_pct(rs1[:, None, :], snap_i)
        phi_hist = torch.where(upd, torch.gather(phi, 1, at), phi_hist)
        phi1_hist = torch.where(upd, torch.gather(phi1, 1, at), phi1_hist)
    t_tau = tau - 1 - h
    stage = active & (t_tau >= 0) & (t_tau < chunk)
    rows = torch.arange(h.shape[0], device=dev)
    fm = feature_matrix(FeatureExtras(
        queries=qvec, centroid_sims=centroid_sims,
        topk_scores=snap_s[rows, t_tau.clamp(0, chunk - 1).long()],
        phi_hist=phi_hist, phi1_hist=phi1_hist), with_intersections=True)
    exits = stage & (torch.sigmoid(predict_margin(clf, fm)) >= threshold)
    return TauStageOut(rs1, phi_hist, phi1_hist,
                       clf_exits.add_(exits.sum()),
                       torch.where(exits, tau, lane_cap))


def smem_bytes(k: int, tau: int, n_trees: int) -> int:
    """A block's shared memory: its lane's RS_1, two history rows and
    twice its trees padded to a power of two, 4 bytes each."""
    pow2 = 1 << max(n_trees - 1, 0).bit_length()
    return 4 * (k + 2 * max(tau - 1, 1) + 2 * pow2)


def check_trees(clf: TreeEnsemble, d: int, tau: int) -> None:
    """Raise unless every split feature of ``clf`` lies in the Table-1
    layout of (``d``, ``tau``), ``feature_matrix``'s columns with the
    history: the kernel reads a feature by its index.  The trees are
    read once (``TreeEnsemble.max_feature``)."""
    width = d + tau + 4 + 2 * max(tau - 1, 1)
    if clf.max_feature >= width:
        raise ValueError(f"tau_stage: a tree splits on feature "
                         f"{clf.max_feature}, past the {width} Table-1 "
                         f"features of dim {d} at tau {tau}")


def tau_stage(snap_s, snap_i, cnts, h, active, qvec, centroid_sims, rs1_ids,
              phi_hist, phi1_hist, clf_exits, lane_cap, clf: TreeEnsemble,
              *, tau: int, k: int, chunk: int, n_probe: int,
              threshold: float) -> TauStageOut:
    """A wave's (W, chunk, k) snapshot scores and int32 ids and (W,
    chunk) int32 new-entry counts, the lanes' (W,) int32 ``h`` and bool
    ``active``, their (W, d) queries, (W, tau) centroid sims, (W, k)
    int32 RS_1, (W, max(tau - 1, 1)) f32 history rows and (W,) int32
    probe caps, the () int64 exit count and the Exit/Continue trees ->
    the lanes' RS_1, history rows and caps in new tensors, and the exits
    counted into ``clf_exits`` in place.  Every split feature of
    ``clf`` must lie in the Table-1 layout of (d, tau)
    (:func:`check_trees`)."""
    for name, v in (("tau", tau), ("k", k), ("chunk", chunk),
                    ("n_probe", n_probe)):
        if v <= 0:
            raise ValueError(f"tau_stage: {name}={v} must be > 0")
    if clf.max_depth < 0 or clf.feat.dim() != 2 or 0 in clf.feat.shape:
        raise ValueError(f"tau_stage: the trees need max_depth >= 0 "
                         f"(got {clf.max_depth}) and (T, M) nodes, T and "
                         f"M > 0 (got {tuple(clf.feat.shape)})")
    w = h.shape[0] if h.dim() else -1
    d = qvec.shape[1] if qvec.dim() == 2 else -1
    hist = (w, max(tau - 1, 1))
    nodes = tuple(clf.feat.shape)
    dev = _build.check_inputs(
        "tau_stage", snap_s=(snap_s, torch.float32, (w, chunk, k)),
        snap_i=(snap_i, torch.int32, (w, chunk, k)),
        cnts=(cnts, torch.int32, (w, chunk)), h=(h, torch.int32, (w,)),
        active=(active, torch.bool, (w,)),
        qvec=(qvec, torch.float32, (w, None)),
        centroid_sims=(centroid_sims, torch.float32, (w, tau)),
        rs1_ids=(rs1_ids, torch.int32, (w, k)),
        phi_hist=(phi_hist, torch.float32, hist),
        phi1_hist=(phi1_hist, torch.float32, hist),
        clf_exits=(clf_exits, torch.int64, ()),
        lane_cap=(lane_cap, torch.int32, (w,)),
        feat=(clf.feat, torch.int32, nodes),
        thresh=(clf.thresh, torch.float32, nodes),
        left=(clf.left, torch.int32, nodes),
        right=(clf.right, torch.int32, nodes),
        value=(clf.value, torch.float32, nodes),
        base=(clf.base, torch.float32, ()))
    check_trees(clf, d, tau)
    kw = dict(tau=tau, k=k, chunk=chunk, n_probe=n_probe,
              threshold=threshold)
    if dev.type == "cpu":
        return tau_stage_plain(snap_s, snap_i, cnts, h, active, qvec,
                               centroid_sims, rs1_ids, phi_hist, phi1_hist,
                               clf_exits, lane_cap, clf, **kw)
    _build.check_smem("tau_stage", dev, smem_bytes(k, tau, nodes[0]),
                      f"k={k}, tau={tau} and {nodes[0]} trees")
    out = TauStageOut(torch.empty_like(rs1_ids), torch.empty_like(phi_hist),
                      torch.empty_like(phi1_hist), clf_exits,
                      torch.empty_like(lane_cap))
    if w:
        _build.launch(
            "tau_stage", dev, snap_s.data_ptr(), snap_i.data_ptr(),
            cnts.data_ptr(), h.data_ptr(), active.data_ptr(),
            qvec.data_ptr(), centroid_sims.data_ptr(), rs1_ids.data_ptr(),
            phi_hist.data_ptr(), phi1_hist.data_ptr(), lane_cap.data_ptr(),
            clf.feat.data_ptr(), clf.thresh.data_ptr(), clf.left.data_ptr(),
            clf.right.data_ptr(), clf.value.data_ptr(), clf.base.data_ptr(),
            out.rs1_ids.data_ptr(), out.phi_hist.data_ptr(),
            out.phi1_hist.data_ptr(), out.lane_cap.data_ptr(),
            clf_exits.data_ptr(), w, chunk, k, d, tau, n_probe, nodes[0],
            nodes[1], clf.max_depth, threshold)
        tau_stage.launches += 1
    return out


tau_stage.launches = 0
