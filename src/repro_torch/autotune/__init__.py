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
picks the tuned knobs up.  The joint co-tuning mode
(``python -m repro_torch.launch.tune --joint``) persists its serve and
train winners in the same cache (``put_serve_config``,
``put_train_config``).
"""
from .api import (
    SERVE_SYSTEM,
    TRAIN_SYSTEM,
    autotune_kernel,
    backend_name,
    cached_blocks,
    cached_serve_config,
    cached_train_config,
    ensure_tuned,
    nearest_mesh_serve_config,
    put_serve_config,
    put_train_config,
    resolve_blocks,
    serve_config_candidates,
)
from .cache import (AutotuneCache, SCHEMA_VERSION, default_cache,
                    generation, mesh_distance, mesh_sig, nearest_mesh,
                    parse_mesh_sig, reset_default_cache)
from .space import KERNELS, KernelSpace, shape_sig
from .sut import KernelSUT, smem_limit

__all__ = [
    "AutotuneCache",
    "SERVE_SYSTEM",
    "TRAIN_SYSTEM",
    "KERNELS",
    "KernelSUT",
    "KernelSpace",
    "SCHEMA_VERSION",
    "autotune_kernel",
    "backend_name",
    "cached_blocks",
    "cached_serve_config",
    "cached_train_config",
    "default_cache",
    "ensure_tuned",
    "generation",
    "mesh_distance",
    "mesh_sig",
    "nearest_mesh",
    "nearest_mesh_serve_config",
    "parse_mesh_sig",
    "put_serve_config",
    "put_train_config",
    "reset_default_cache",
    "resolve_blocks",
    "serve_config_candidates",
    "shape_sig",
    "smem_limit",
]
