"""Fault-tolerant training loop: checkpoint/restart + deterministic
replay (port of ``repro.runtime.fault``).  Failures (node loss,
preemption) surface as exceptions from the step function; the trainer
restores the latest checkpoint and replays the deterministic data
stream from the restored step, so the loss trajectory is bit for bit
the uninterrupted run's.  That needs a step that gives the same bits
from the same state and batch: the port's training path sums repeated
rows without atomics (``kernels.embedding_bag.rows_grad``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import DeviceLike
from repro_torch.checkpoint.manager import CheckpointManager, _leaf_paths
from repro_torch.data.pipeline import DeterministicBatcher

Tree = Any


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclass
class TrainerReport:
    losses: List[float] = field(default_factory=list)
    steps_run: int = 0
    restarts: int = 0
    wall_s: float = 0.0


class FaultTolerantTrainer:
    """step_fn(state, batch) -> (state, loss).  state is any tree (params
    + opt state + step counter live inside).

    ``init_state`` is the initial state, or a function that builds it.
    The port's optimizers update the state in place, so after a step the
    initial state is gone: give such a trainer a function, which it
    calls at every start that finds no checkpoint.  Checkpoints restore
    onto ``device`` (by default the device of the state's first
    tensor)."""

    def __init__(self, step_fn: Callable, init_state: Tree,
                 batcher: DeterministicBatcher, ckpt: CheckpointManager,
                 *, ckpt_every: int = 10, device: DeviceLike = None):
        self.step_fn = step_fn
        self.init_state = init_state
        self.batcher = batcher
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.device = device
        self._template: Optional[Tree] = None

    def _fresh(self) -> Tree:
        state = self.init_state() if callable(self.init_state) \
            else self.init_state
        if self._template is None:
            # the state's structure, for restores
            self._template = _placeholders(state)
            if self.device is None:
                self.device = next(t.device for _, t in _leaf_paths(state)
                                   if isinstance(t, torch.Tensor))
        return state

    def _restore_or_init(self) -> Tuple[int, Tree]:
        if self.ckpt.latest_step() is not None:
            if self._template is None:
                self._fresh()       # built for its structure, then dropped
            return self.ckpt.restore(self._template, device=self.device)
        return 0, self._fresh()

    def run(self, n_steps: int, *,
            fail_at: Optional[Dict[int, int]] = None,
            max_restarts: int = 8) -> TrainerReport:
        """fail_at: {global_step: times} -> raise SimulatedFailure that
        many times when reaching the step (before it completes)."""
        report = TrainerReport()
        fail_budget = dict(fail_at or {})
        t0 = time.time()
        restarts = 0
        while True:
            start, state = self._restore_or_init()
            try:
                for step in range(start, n_steps):
                    if fail_budget.get(step, 0) > 0:
                        fail_budget[step] -= 1
                        raise SimulatedFailure(f"injected @ step {step}")
                    batch = self.batcher.batch(step)
                    state, loss = self.step_fn(state, batch)
                    report.losses.append(float(loss))
                    report.steps_run += 1
                    if (step + 1) % self.ckpt_every == 0:
                        self.ckpt.save(step + 1, state)
                break
            except SimulatedFailure:
                state = None
                restarts += 1
                if restarts > max_restarts:
                    raise
                # truncate the loss log to the restore point so the
                # reported trajectory matches what a fresh run would see
                # (after the writer thread has published its step)
                self.ckpt.wait()
                restored = self.ckpt.latest_step() or 0
                report.losses = report.losses[:restored]
        self.ckpt.wait()
        report.restarts = restarts
        report.wall_s = time.time() - t0
        return report


def _placeholders(tree: Tree) -> Tree:
    """``tree``'s structure with every leaf replaced by 0: a restore
    template that holds no tensor."""
    if isinstance(tree, dict):
        return {k: _placeholders(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_placeholders(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_placeholders(v) for v in tree)
    return None if tree is None else 0
