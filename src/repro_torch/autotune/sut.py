"""The kernel-under-tune: an ACTS ``TunableSystem`` over CUDA launch
configurations.

Counterpart of ``repro.autotune.sut``.  A ``KernelSUT`` scores one launch
configuration for one problem signature.  Two measurement modes:

* ``"time"``  — launch the CUDA kernel on the card (``device="cuda"``,
  the default): one warm-up call, which also absorbs the kernel's build,
  then the minimum of ``timing_iters`` calls, each timed with CUDA events
  on the current stream (the reference's statistic);
* ``"model"`` — the deterministic Hopper roofline cost model of
  ``repro_torch.autotune.space`` (``device="cpu"``: a CPU time says
  nothing of the card).

Either way the metric is seconds (lower is better), so the unmodified ACTS
``Tuner`` — budget, duplicate-config cache, report — drives the search.
A config the feasibility model admits that fails to launch raises; it is
never scored ``inf``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.params import Config, ParameterSpace
from repro_torch.core.tuner import PerfMetric

from .space import KernelSpace, shape_sig

__all__ = ["KernelSUT", "smem_limit"]


@functools.lru_cache(maxsize=None)
def _device_smem_limit(index: int) -> int:
    from repro_torch.kernels import build

    # every kernel library exports the device query (csrc/common.cuh)
    limit = build.load("flash_attention").repro_max_smem_per_block(index)
    if limit <= 0:
        raise RuntimeError(f"cannot read the shared memory per block of "
                           f"cuda:{index}")
    return limit


def smem_limit(device: Union[str, torch.device]) -> Optional[int]:
    """The opt-in maximum of shared memory per block of a CUDA device
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``), or None for the CPU,
    where the cost model's datasheet figure holds."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return _device_smem_limit(
        dev.index if dev.index is not None else torch.cuda.current_device())


class KernelSUT:
    def __init__(
        self,
        kernel: str,
        dims: Dict[str, int],
        dtype: str = "float32",
        device: Union[str, torch.device] = "cuda",
        mode: Optional[str] = None,  # None = time on a card, model on cpu
        timing_iters: int = 3,
        seed: int = 0,
    ):
        self.kspace = KernelSpace(kernel)
        self.kernel = kernel
        self.dims = self.kspace.validate_dims(dims)
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not "
                "available; pass device='cpu' to tune on the cost model")
        if mode is None:
            mode = "time" if self.device.type == "cuda" else "model"
        if mode not in ("time", "model"):
            raise ValueError(f"mode must be time|model, got {mode!r}")
        if mode == "time" and self.device.type != "cuda":
            raise ValueError("mode='time' times the CUDA kernel: it needs "
                             "device='cuda'")
        self.mode = mode
        self.timing_iters = timing_iters
        self.seed = seed
        self._inputs = None
        self.name = f"kernel[{kernel}×{shape_sig(self.dims)}]"

    def space(self) -> ParameterSpace:
        return self.kspace.space()

    @property
    def feasibility_model(self):
        """Static feasibility of a launch config on this problem signature.

        Auto-detected by the ``Tuner``: a config whose block needs more
        shared memory than the device allows (the datasheet figure in
        ``mode="model"``) is pruned before it burns a test.  Built on the
        same ``smem_footprint`` the cost model evaluates, so pruning never
        disagrees with cost-model finiteness.
        """
        from repro_torch.analysis.feasibility import kernel_feasibility

        limit = smem_limit(self.device) if self.mode == "time" else None
        return kernel_feasibility(self.kernel, self.dims, self.dtype,
                                  smem_limit=limit)

    # ------------------------------------------------------------------
    def _get_inputs(self):
        if self._inputs is None:
            rng = np.random.default_rng(self.seed)
            self._inputs = self.kspace.definition.make_inputs(
                self.dims, self.dtype, rng, self.device)
        return self._inputs

    def test(self, config: Config) -> PerfMetric:
        d = self.kspace.definition
        if self.mode == "model":
            cost = float(d.model_cost(config, self.dims, self.dtype))
            return PerfMetric(value=cost, higher_is_better=False,
                              metrics={"mode": "model",
                                       "config": dict(config)})
        inputs = self._get_inputs()
        d.call(inputs, config)  # warm-up: builds the kernel, first launch
        stream = torch.cuda.current_stream(self.device)
        best = float("inf")
        for _ in range(self.timing_iters):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            d.call(inputs, config)
            stop.record(stream)
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / 1e3)
        return PerfMetric(value=best, higher_is_better=False,
                          metrics={"mode": "time", "config": dict(config)})

    def test_batch(self, configs) -> list:
        """One evaluator call per candidate round (BatchEvaluator protocol).

        A plain loop — value-identical to per-config ``test`` — but the
        batched tuner still dispatches the whole round in a single call.
        """
        return [self.test(c) for c in configs]
