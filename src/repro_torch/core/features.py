"""Table 1 feature extraction (port of ``repro.core.features``), shared
by training (``core.ivf.extract_features``) and the search loop.

Feature layout (order is part of the model contract):
  [0, d)                      query vector                       (group 1)
  [d, d+tau)                  similarity to h-th closest centroid (group 2)
  [d+tau]                     sigma_tau(q, d_1)   max doc sim     (group 3)
  [d+tau+1]                   sigma_tau(q, d_k)   k-th doc sim
  [d+tau+2]                   sigma(d_1)/sigma(d_k)
  [d+tau+3]                   sigma(d_1)/sigma(c_1)
  [d+tau+4, d+tau+4+(tau-1))  |RS_{h-1} ∩ RS_h|/k, h=2..tau      (group 4)
  [.., +(tau-1))              |RS_1 ∩ RS_h|/k,     h=2..tau
REG (Li et al.) uses groups 1-3 only; REG+int and the Classifier use all.
The matrix without intersections is the one with them, stopped before
the two history blocks (``base_columns``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FeatureExtras(NamedTuple):
    queries: torch.Tensor        # (B, d)
    centroid_sims: torch.Tensor  # (B, tau)
    topk_scores: torch.Tensor    # (B, k) current result-set scores
    phi_hist: torch.Tensor       # (B, tau-1) consecutive intersections (%)
    phi1_hist: torch.Tensor      # (B, tau-1) intersections with RS_1 (%)


def n_features(dim: int, tau: int, with_intersections: bool) -> int:
    base = dim + tau + 4
    return base + 2 * (tau - 1) if with_intersections else base


def _guard(x: torch.Tensor, eps: float) -> torch.Tensor:
    """A denominator kept off zero, as the reference keeps it."""
    return torch.where(x.abs() > eps, x, torch.sign(x) * eps + eps)


def feature_matrix(extras: FeatureExtras, *, with_intersections: bool
                   ) -> torch.Tensor:
    """(B, F) feature matrix; safe under -inf placeholder scores."""
    q = extras.queries.to(torch.float32)
    cs = extras.centroid_sims.to(torch.float32)
    scores = extras.topk_scores.to(torch.float32)
    scores = torch.where(torch.isfinite(scores), scores, 0.0)
    s1 = scores[:, 0]
    sk = scores[:, -1]
    eps = 1e-6
    r_1k = s1 / _guard(sk, eps)
    c1 = cs[:, 0]
    r_1c = s1 / _guard(c1, eps)
    cols = [q, cs, s1[:, None], sk[:, None], r_1k[:, None], r_1c[:, None]]
    if with_intersections:
        # the reference's "/ 100.0" runs under jit, where XLA turns a
        # division by a constant into a product with its f32 reciprocal:
        # 10 / 100.0 is 0.1 rounded, 10 * 0.01 one ulp below it, and the
        # trees' thresholds are learned on the latter
        cols += [extras.phi_hist * 0.01, extras.phi1_hist * 0.01]
    return torch.cat(cols, dim=1)


def base_columns(fm, tau: int):
    """Groups 1-3 of a matrix (tensor or array) built with intersections:
    what ``feature_matrix(..., with_intersections=False)`` gives.  The two
    history blocks are ``max(tau - 1, 1)`` columns each."""
    return fm[:, :fm.shape[1] - 2 * max(tau - 1, 1)]
