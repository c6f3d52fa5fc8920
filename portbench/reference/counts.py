"""The work a served query needs, and the least time the card could
take for it.

The count is of what the algorithm needs, not of what an implementation
does, so it reads the same whatever implements the scan:

- scan bytes: for each of a query's first C probes (C as served), the
  probed list's live rows times (4 d + 4) bytes, an f32 row and its
  int32 id, the lists in the reference's probe order;
- ranking operations: 2 d L a query, the centroid product;
- the centroid table's bytes, once per window.

Slots scanned past a lane's exit are waste and are not counted.
``bound`` is ``chip_smoke.py``'s arithmetic: the larger of the bytes at
the memory rate and the operations at the f32 peak (H100 SXM data sheet,
at its 700 W power limit).
"""
from __future__ import annotations

import torch

from . import ivf_patience

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM f32, outside the tensor cores


def bound_s(n_bytes: float, n_flops: float,
            flops_per_s: float = F32_FLOPS_PER_S) -> float:
    """The least seconds for the work: bytes over the memory rate or
    operations over the peak rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s)


def live_rows_by_probes(queries, centroids, sizes, n_probe: int
                        ) -> torch.Tensor:
    """(B, n_probe + 1) int64: live rows in each query's first c lists,
    for c = 0..n_probe, in the reference's probe order."""
    order = ivf_patience.centroid_order(queries, centroids, n_probe)
    rows = sizes.long()[order]
    return torch.cat([torch.zeros_like(rows[:, :1]), rows.cumsum(1)], 1)


def scan_bytes(live_rows: int, dim: int) -> int:
    return live_rows * (4 * dim + 4)


def ranking_flops(n_queries: int, dim: int, n_lists: int) -> int:
    return 2 * dim * n_lists * n_queries


def table_bytes(n_lists: int, dim: int) -> int:
    return 4 * dim * n_lists
