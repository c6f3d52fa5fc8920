"""Tree-ensemble inference in PyTorch: level-wise gather descent.

Port of ``repro.trees.jax_infer``.  LightGBM-style additive forests
become five stacked tensors; prediction is ``max_depth`` rounds of
vectorised child selection with no data-dependent control flow, so the
ensemble runs inside the search loop on the index's device.  The tree
walk is plain PyTorch, as the reference's is plain ``jnp``: no Pallas
kernel to port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


@dataclasses.dataclass
class TreeEnsemble:
    """Stacked trees, every tensor on one device."""

    feat: torch.Tensor    # (T, M) int32 split feature, -1 at leaves
    thresh: torch.Tensor  # (T, M) f32 split threshold
    left: torch.Tensor    # (T, M) int32 child if x[f] <= thr (self at leaf)
    right: torch.Tensor   # (T, M) int32
    value: torch.Tensor   # (T, M) f32 leaf value (lr folded in), 0 inner
    base: torch.Tensor    # () f32 initial prediction
    max_depth: int

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]


def predict_margin(ens: TreeEnsemble, x: torch.Tensor) -> torch.Tensor:
    """(B, F) -> (B,) raw margin (sum of leaf values + base).

    Leaves self-loop, so ``max_depth`` rounds reach every leaf.  The
    leaf values are summed pairwise over the trees in a fixed order, by
    elementwise adds only, so a row's margin has the same bits whatever
    the batch (a reduction kernel may pick its order by shape)."""
    t, m = ens.feat.shape
    b = x.shape[0]
    flat_feat = ens.feat.reshape(-1)
    flat_thr = ens.thresh.reshape(-1)
    flat_l = ens.left.reshape(-1)
    flat_r = ens.right.reshape(-1)
    toff = (torch.arange(t, device=x.device) * m)[None, :]      # (1, T)
    node = torch.zeros((b, t), dtype=torch.long, device=x.device)
    for _ in range(ens.max_depth):
        gidx = toff + node                                       # (B, T)
        f = flat_feat[gidx]
        xv = torch.gather(x, 1, f.clamp(min=0).long())
        nxt = torch.where(xv <= flat_thr[gidx], flat_l[gidx], flat_r[gidx])
        node = torch.where(f >= 0, nxt.long(), node)             # leaves stay
    vals = ens.value.reshape(-1)[toff + node]
    while vals.shape[1] > 1:
        if vals.shape[1] % 2:
            vals = torch.nn.functional.pad(vals, (0, 1))
        vals = vals[:, 0::2] + vals[:, 1::2]
    return vals[:, 0] + ens.base


def predict_proba(ens: TreeEnsemble, x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(predict_margin(ens, x))


def ensemble_from_arrays(feat, thresh, left, right, value, base,
                         max_depth: int, *,
                         device: DeviceLike = None) -> TreeEnsemble:
    """A :class:`TreeEnsemble` on ``device`` (CUDA unless
    ``device="cpu"``) from host arrays stacked as ``from_numpy_forest``
    stacks them — for example the leaves of a reference ``repro``
    ensemble."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    return TreeEnsemble(put(feat, np.int32), put(thresh, np.float32),
                        put(left, np.int32), put(right, np.int32),
                        put(value, np.float32), put(base, np.float32),
                        int(max_depth))


def from_numpy_forest(forest, max_depth: int, *,
                      device: DeviceLike = None) -> TreeEnsemble:
    """Pack ``repro_torch.trees.gbdt.Forest`` into stacked tensors on
    ``device`` (CUDA unless ``device="cpu"``)."""
    m = max(t.feat.shape[0] for t in forest.trees)
    t = len(forest.trees)

    def pad(a, fill, dtype):
        out = np.full((t, m), fill, dtype)
        for i, tree in enumerate(forest.trees):
            arr = getattr(tree, a)
            out[i, : arr.shape[0]] = arr
        return out

    # leaves self-loop so extra descent steps are no-ops
    left = pad("left", 0, np.int32)
    right = pad("right", 0, np.int32)
    feat = pad("feat", -1, np.int32)
    for i, tree in enumerate(forest.trees):
        leaves = np.nonzero(tree.feat == -1)[0]
        left[i, leaves] = leaves
        right[i, leaves] = leaves
    return ensemble_from_arrays(feat, pad("thresh", 0.0, np.float32), left,
                                right, pad("value", 0.0, np.float32),
                                np.float32(forest.base), max_depth,
                                device=device)
