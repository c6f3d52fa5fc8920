"""Injected failures (port of ``repro.runtime.fault``, its
``SimulatedFailure`` only).  The reference's ``FaultTolerantTrainer``
(checkpoint/restart with deterministic replay of the data stream) needs
the training step and ``data/pipeline.py``, which come with the rest of
the model zoo (ROADMAP Queue 1 item 6)."""
from __future__ import annotations


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""
