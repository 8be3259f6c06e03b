"""Optimizer substrate: AdamW, schedules, clipping, gradient compression
(counterpart of ``repro.optim``)."""
from .adamw import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_at,
    tree_leaves,
    tree_map,
)
from .compression import COMPRESSIONS, compress_grads, compression_init

__all__ = [n for n in dir() if not n.startswith("_")]
