"""ACTS-driven kernel autotuning: tune, persist, resolve.

Counterpart of ``repro.autotune.api``.  The flow mirrors the paper's
architecture end to end:

    tune:     ``autotune_kernel`` runs the ordinary ACTS ``Tuner`` (LHS +
              RRS under a test budget) over a ``KernelSpace`` with a
              ``KernelSUT``, then persists the winner.
    persist:  ``AutotuneCache`` keys the result by (kernel, shape
              signature, dtype, backend) in one JSON file.
    resolve:  ``resolve_blocks`` is the cheap read path the kernel entry
              points (``repro_torch.kernels.ops``) call when no explicit
              knob is given — cache hit wins, builtin default otherwise.

The backend component is ``backend_name(device)``: ``cuda-sm90`` on an
H100, ``model-sm90`` for the Hopper cost model (CPU-side work).  The
reference writes ``cpu`` for its own cost model into the same file, so
the two never overwrite each other's winners.  The reference's serve and train
entries (``put_serve_config`` and the rest) come with ``--joint``
(ROADMAP queue 1: co-tuning).
"""
from __future__ import annotations

import functools
import logging
from typing import Any, Dict, Optional, Union

import torch

from .cache import AutotuneCache, default_cache
from .space import KernelSpace, shape_sig
from .sut import KernelSUT

__all__ = ["autotune_kernel", "ensure_tuned", "resolve_blocks",
           "cached_blocks", "backend_name"]

logger = logging.getLogger("repro_torch.autotune")

# cache paths already warned about (resolve_blocks warns once per path)
_warned_cache_paths: set = set()


@functools.lru_cache(maxsize=None)
def _cuda_backend(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    return f"cuda-sm{major}{minor}"


def backend_name(device: Union[str, torch.device] = "cuda") -> str:
    """The cache's backend component for work on ``device``:
    ``cuda-sm<major><minor>`` from the card's compute capability
    (``cuda-sm90`` on an H100), ``model-sm90`` on the CPU: the Hopper cost
    model's predictions, kept apart from the reference's ``cpu`` entries
    (``jax.default_backend()`` on a CPU host: TPU-roofline winners) in the
    file both packages share.  The default asks for the card and raises
    without one."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "model-sm90"
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(device)!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' for the cost model's entries")
    return _cuda_backend(dev.index if dev.index is not None
                         else torch.cuda.current_device())


def cached_blocks(kernel: str, dims: Dict[str, int], dtype: str,
                  cache: Optional[AutotuneCache] = None,
                  backend: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The tuned launch config for this problem, or None if never tuned.
    ``backend`` defaults to the card's (``backend_name()``)."""
    sig = shape_sig(KernelSpace(kernel).validate_dims(dims))
    # not `or`: an empty cache is falsy (__len__)
    cache = default_cache() if cache is None else cache
    return cache.get_config(kernel, sig, dtype, backend or backend_name())


def resolve_blocks(kernel: str, dims: Dict[str, int], dtype: str,
                   defaults: Dict[str, Any],
                   cache: Optional[AutotuneCache] = None,
                   backend: Optional[str] = None) -> Dict[str, Any]:
    """Tuned config if the cache has one, else the builtin defaults.

    A failed *lookup* (unreadable or structurally corrupt cache entry)
    falls back to the defaults — but loudly, once per cache path.  Caller
    errors (unknown kernel, missing signature dims) are validated up front
    and propagate, as does anything outside the expected lookup-failure
    set.
    """
    # surface call-site programming errors before touching the cache
    KernelSpace(kernel).validate_dims(dims)
    backend = backend or backend_name()
    # not `or`: an empty cache is falsy (__len__)
    cache = default_cache() if cache is None else cache
    try:
        tuned = cached_blocks(kernel, dims, dtype, cache=cache,
                              backend=backend)
    except (OSError, KeyError, ValueError, TypeError) as exc:
        if cache.path not in _warned_cache_paths:
            _warned_cache_paths.add(cache.path)
            logger.warning(
                "autotune cache lookup failed for kernel %r (%s: %s); "
                "falling back to builtin launch defaults — check the "
                "cache file at %s", kernel, type(exc).__name__, exc,
                cache.path)
        return dict(defaults)
    if tuned:
        out = dict(defaults)
        out.update({k: tuned[k] for k in defaults if k in tuned})
        return out
    return dict(defaults)


def autotune_kernel(
    kernel: str,
    dims: Dict[str, int],
    dtype: str = "float32",
    budget: int = 16,
    device: Union[str, torch.device] = "cuda",
    mode: Optional[str] = None,
    seed: int = 0,
    cache: Optional[AutotuneCache] = None,
    optimizer: str = "rrs",
    verbose: bool = False,
) -> Dict[str, Any]:
    """Run ACTS over one kernel × problem signature and persist the
    winner under ``backend_name(device)``.

    Returns a summary dict {kernel, sig, dtype, backend, config, value,
    default_value, n_tests, n_infeasible_pruned, mode}; values are
    seconds.
    """
    from repro_torch.core.tuner import Tuner

    sut = KernelSUT(kernel, dims, dtype=dtype, device=device, mode=mode,
                    seed=seed)
    report = Tuner(sut.space(), sut, budget=budget, optimizer=optimizer,
                   seed=seed, verbose=verbose).run()
    # not `or`: an empty cache is falsy (__len__)
    cache = default_cache() if cache is None else cache
    sig = shape_sig(sut.dims)
    summary = {
        "kernel": kernel,
        "sig": sig,
        "dtype": dtype,
        "backend": backend_name(device),
        "config": dict(report.best_config),
        "default_config": dict(report.default_config),
        "value": report.best_metric.value,
        "default_value": report.default_metric.value,
        "n_tests": report.n_tests,
        "n_infeasible_pruned": report.n_infeasible_pruned,
        "mode": sut.mode,
    }
    cache.put(kernel, sig, dtype, summary["backend"], summary["config"],
              summary["value"],
              meta={"mode": sut.mode, "n_tests": report.n_tests,
                    "n_infeasible_pruned": report.n_infeasible_pruned,
                    "default_value": summary["default_value"]})
    return summary


def ensure_tuned(kernel: str, dims: Dict[str, int], dtype: str = "float32",
                 budget: int = 16, cache: Optional[AutotuneCache] = None,
                 device: Union[str, torch.device] = "cuda",
                 **kw: Any) -> Dict[str, Any]:
    """Cache hit → return it; miss → tune now and persist."""
    # not `or`: an empty cache is falsy (__len__)
    cache = default_cache() if cache is None else cache
    tuned = cached_blocks(kernel, dims, dtype, cache=cache,
                          backend=backend_name(device))
    if tuned is not None:
        return tuned
    return autotune_kernel(kernel, dims, dtype=dtype, budget=budget,
                           cache=cache, device=device, **kw)["config"]
