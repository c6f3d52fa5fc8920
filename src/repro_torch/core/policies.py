"""Early-exit policies (paper §2): port of ``repro.core.policies``.

One :class:`Policy` configures the adaptive search:

  fixed(N)                     A-kNN_95 baseline — no early exit
  patience(delta, phi)         the paper's unsupervised heuristic
  regression(reg)              REG  [Li et al., SIGMOD'20]  (groups 1-3)
  regression(reg, +int)        REG+int (adds stability features)
  classifier(clf)              Exit/Continue at tau, survivors run to N
  cascade(clf, patience|reg)   paper §2 "Cascade Approach"

The learned stages' trees (``reg``, ``clf``) are tensors on one device;
``search`` runs them where the index lies and refuses trees that lie
elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.features import base_columns
from repro_torch.trees.torch_infer import TreeEnsemble, predict_margin


@dataclasses.dataclass(frozen=True)
class Policy:
    k: int = 100
    n_probe: int = 80
    tau: int = 10
    min_probes: int = 1
    use_patience: bool = False
    use_reg: bool = False
    reg_with_intersections: bool = False
    use_classifier: bool = False
    name: str = "fixed"
    delta: int = 7
    phi: float = 95.0
    clf_threshold: float = 0.5
    reg: Optional[TreeEnsemble] = None
    clf: Optional[TreeEnsemble] = None

    @property
    def learned(self) -> bool:
        """Whether a learned stage (REG or the classifier) fires at tau."""
        return self.use_reg or self.use_classifier


# -- constructors -----------------------------------------------------------

def fixed(n_probe: int, k: int = 100, tau: int = 10) -> Policy:
    return Policy(k=k, n_probe=n_probe, tau=tau, name=f"aknn{n_probe}")


def patience(n_probe: int, delta: int, phi: float = 95.0, k: int = 100,
             tau: int = 10, min_probes: int = 1) -> Policy:
    return Policy(k=k, n_probe=n_probe, tau=tau, use_patience=True,
                  min_probes=min_probes, delta=int(delta), phi=float(phi),
                  name=f"patience{delta}")


def regression(n_probe: int, reg: TreeEnsemble, *, with_intersections: bool,
               k: int = 100, tau: int = 10) -> Policy:
    return Policy(k=k, n_probe=n_probe, tau=tau, use_reg=True,
                  reg_with_intersections=with_intersections, reg=reg,
                  min_probes=tau,
                  name="reg+int" if with_intersections else "reg")


def classifier(n_probe: int, clf: TreeEnsemble, *, threshold: float = 0.5,
               k: int = 100, tau: int = 10) -> Policy:
    return Policy(k=k, n_probe=n_probe, tau=tau, use_classifier=True,
                  clf=clf, min_probes=tau, clf_threshold=float(threshold),
                  name="classifier")


def cascade_patience(n_probe: int, clf: TreeEnsemble, delta: int,
                     phi: float = 95.0, *, threshold: float = 0.5,
                     k: int = 100, tau: int = 10) -> Policy:
    return Policy(k=k, n_probe=n_probe, tau=tau, use_classifier=True,
                  use_patience=True, clf=clf, min_probes=tau,
                  delta=int(delta), phi=float(phi),
                  clf_threshold=float(threshold),
                  name=f"cascade+patience{delta}")


def cascade_regression(n_probe: int, clf: TreeEnsemble, reg: TreeEnsemble,
                       *, threshold: float = 0.5, k: int = 100,
                       tau: int = 10) -> Policy:
    return Policy(k=k, n_probe=n_probe, tau=tau, use_classifier=True,
                  use_reg=True, reg_with_intersections=True, clf=clf,
                  reg=reg, min_probes=tau, clf_threshold=float(threshold),
                  name="cascade+reg")


# -- step -------------------------------------------------------------------


class PolicyDecision(NamedTuple):
    exit: torch.Tensor          # (B,) bool — policy wants to stop this query
    patience_ctr: torch.Tensor  # (B,) int32
    target: torch.Tensor        # (B,) int32 probe budget


def policy_step(policy: Policy, *, h: int, phi: torch.Tensor,
                patience_ctr: torch.Tensor, target: torch.Tensor,
                features: Optional[torch.Tensor] = None) -> PolicyDecision:
    """Evaluate exit logic after probe ``h`` (0-based; probes done = h+1).

    ``phi`` is an f32 tensor, so the thresholds are compared in f32, as
    the reference compares them.  ``features`` is the (B, F) Table-1
    matrix with intersections, which the learned stages read once, when
    ``h + 1 == tau`` (the reference's ``lax.cond``); REG without
    intersections reads its ``base_columns``.
    """
    probes_done = h + 1
    no = torch.zeros_like(phi, dtype=torch.bool)
    if policy.use_patience:
        ctr = torch.where((phi >= policy.phi) & (h >= 1), patience_ctr + 1,
                          torch.zeros_like(patience_ctr))
        exit_pat = ctr >= policy.delta
    else:
        ctr, exit_pat = patience_ctr, no
    exit_clf = no
    if policy.learned and probes_done == policy.tau:
        if features is None:
            raise ValueError("a learned policy needs the feature matrix at "
                             "tau")
        if policy.use_classifier:
            p_exit = torch.sigmoid(predict_margin(policy.clf, features))
            exit_clf = p_exit >= policy.clf_threshold
        if policy.use_reg:
            x = features if policy.reg_with_intersections else \
                base_columns(features, policy.tau)
            pred = predict_margin(policy.reg, x)
            target = torch.round(pred).clamp(policy.tau, policy.n_probe) \
                .to(torch.int32)
    exit_tgt = probes_done >= target if policy.use_reg else no
    return PolicyDecision(exit_pat | exit_clf | exit_tgt, ctr, target)
