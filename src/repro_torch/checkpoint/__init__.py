"""Checkpoint substrate: atomic saves, retention, restore onto the
template's devices (counterpart of ``repro.checkpoint``)."""
from .manager import CheckpointInfo, CheckpointManager

__all__ = ["CheckpointInfo", "CheckpointManager"]
