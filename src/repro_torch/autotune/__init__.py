"""ACTS applied to the port's own CUDA kernels: launch-config autotuning.

Counterpart of ``repro.autotune``:

    from repro_torch import autotune
    autotune.autotune_kernel("flash_attention",
                             {"B": 1, "S": 4096, "SK": 4096, "H": 16,
                              "KV": 16, "D": 256},
                             dtype="bfloat16", budget=16)

tunes the kernel's launch knobs with the ordinary ACTS tuner (timing it
on the card) and persists the winner; afterwards every
``repro_torch.kernels.ops`` call with that problem shape on that card
picks the tuned knobs up.
"""
from .api import (
    autotune_kernel,
    backend_name,
    cached_blocks,
    ensure_tuned,
    resolve_blocks,
)
from .cache import (AutotuneCache, SCHEMA_VERSION, default_cache,
                    generation, mesh_sig, parse_mesh_sig,
                    reset_default_cache)
from .space import KERNELS, KernelSpace, shape_sig
from .sut import KernelSUT, smem_limit

__all__ = [
    "AutotuneCache",
    "KERNELS",
    "KernelSUT",
    "KernelSpace",
    "SCHEMA_VERSION",
    "autotune_kernel",
    "backend_name",
    "cached_blocks",
    "default_cache",
    "ensure_tuned",
    "generation",
    "mesh_sig",
    "parse_mesh_sig",
    "reset_default_cache",
    "resolve_blocks",
    "shape_sig",
    "smem_limit",
]
