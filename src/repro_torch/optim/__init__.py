"""Optimizers and schedules (port of ``repro.optim``)."""
