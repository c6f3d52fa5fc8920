"""Delta-buffer scan: raw scores of every query against every slot of
the live index's delta buffer.

Port of ``repro.kernels.delta_scan``.  On a CUDA tensor the wrapper
launches ``csrc/delta_scan.cu``; on a CPU tensor it runs
:func:`delta_scan_plain`.  Every slot is scored, empty and tombstoned
ones included: callers mask by ``ids >= 0`` and by the cluster gate.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan import score_rows

# shared memory of a CTA (csrc/delta_scan.cu kSmemBytes): five stages
# of 32 query and 32 slot rows x 128 floats, whatever d
_SMEM = 5 * 64 * 128 * 4


def delta_scan_plain(queries: torch.Tensor,
                     vecs: torch.Tensor) -> torch.Tensor:
    """``queries @ vecs.T``, each score through :func:`score_rows`, so a
    buffered doc scores the same bits as in a list."""
    rows = torch.arange(vecs.shape[0], device=vecs.device)
    return score_rows(queries, vecs, rows.expand(queries.shape[0], -1))


def delta_scan(queries: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """queries (B, d) f32 x delta vecs (cap, d) f32 -> (B, cap) f32."""
    b, d = queries.shape
    cap = vecs.shape[0]
    dev = _build.check_inputs(
        "delta_scan", queries=(queries, torch.float32, (b, d)),
        vecs=(vecs, torch.float32, (cap, d)))
    if dev.type == "cpu":
        return delta_scan_plain(queries, vecs)
    _build.check_smem("delta_scan", dev, _SMEM, "32 queries x 32 slots in 5 stages")
    out = torch.empty((b, cap), dtype=torch.float32, device=dev)
    if b and cap:
        _build.launch("delta_scan", dev, queries.data_ptr(), vecs.data_ptr(),
                      out.data_ptr(), b, cap, d)
        delta_scan.launches += 1
    return out


delta_scan.launches = 0
