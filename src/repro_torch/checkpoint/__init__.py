"""Snapshot persistence (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager
