"""The PyTorch runtime's train step as an ACTS system-under-tune.

Counterpart of the live half of ``repro.core.sut_jax``: the shared
wall-clock methodology of the live (``--joint --real``) co-tuning path
(``median_wall_clock``), the real train step as a system under tune
(``TrainStepSUT``) and the reference's measured steps-per-second system
(``TorchMeasuredSUT``, the counterpart of ``JaxMeasuredSUT``).  Applying
a configuration rebuilds the model, its optimizer state and the step
under the new knobs — the paper's apply-config-and-restart — and runs the
workload on the device.  The reference's dry-run system-under-tune
(``JaxDryRunSUT``, ``knob_space``) comes with ROADMAP queue 1: dry-run
and roofline.
"""
from __future__ import annotations

import time
from typing import Union

import torch

from repro_torch.core.params import (BoolParam, Config, EnumParam,
                                     ParameterSpace)
from repro_torch.core.tuner import PerfMetric

__all__ = ["TrainStepSUT", "TorchMeasuredSUT", "median_wall_clock", "sync"]


def sync(device: Union[str, torch.device]) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU, whose
    ops return when done)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measured_train_setup(cfg, knobs, seq_len: int, global_batch: int,
                          n_batches: int, seed: int,
                          device: Union[str, torch.device]):
    """Shared scaffolding for wall-clock train-step SUTs: build the model
    on ``device``, init its state from ``seed``, build the step under the
    knobs, and materialize the batch list.  Returns (step_fn, params,
    opt_state, batches)."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models import Model
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train.step import init_train_state, make_train_step

    model = Model(cfg, device=device)
    params, opt_state = init_train_state(model, seed, knobs)
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed))
    step_fn = make_train_step(model, OptimizerConfig(), knobs)
    batches = [
        {k: torch.from_numpy(v).to(model.device)
         for k, v in data.batch_at(i).items()}
        for i in range(n_batches)
    ]
    return step_fn, params, opt_state, batches


def median_wall_clock(fn, warmup: int = 1, repeats: int = 3) -> float:
    """Median wall-clock seconds of ``fn()`` after trimming warmup runs.

    ``warmup`` untimed calls absorb kernel builds and cache effects, then
    the median of ``repeats`` timed calls rejects scheduler-noise outliers
    that a mean (or a single run) would leak into the tuner's objective.
    ``fn`` must block until its work is done: on the card it ends in a
    device sync (``sync``), since PyTorch returns before the device
    finishes.
    """
    for _ in range(max(0, warmup)):
        fn()
    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


class TrainStepSUT:
    """The REAL train step as a system-under-tune (live co-tuning member).

    Each test applies the candidate knobs (``repro_torch.train.space``):
    it builds a fresh model and optimizer state on ``device`` and the step
    under the knobs, then wall-clocks a short training loop: ``warmup``
    untimed loops, then the median of ``repeats`` timed loops of ``steps``
    steps each, every loop ended by a device sync.  The metric is training
    tokens/sec (higher is better); step seconds and the final loss ride
    along as provenance.
    """

    def __init__(self, cfg, seq_len: int = 32, global_batch: int = 8,
                 steps: int = 2, warmup: int = 1, repeats: int = 3,
                 seed: int = 0, rules_preset: str = "dp",
                 device: Union[str, torch.device] = "cuda"):
        from repro_torch.models.common import resolve_device

        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.steps = steps
        self.warmup = warmup
        self.repeats = repeats
        self.seed = seed
        self.rules_preset = rules_preset
        self.device = resolve_device(device)
        self.name = f"train-step[{cfg.name}]"

    def space(self) -> ParameterSpace:
        from repro_torch.train.space import train_knob_space

        return train_knob_space(max_microbatches=self.global_batch)

    def test(self, config: Config) -> PerfMetric:
        from repro_torch.train.space import apply_train_knobs
        from repro_torch.train.step import RunKnobs

        knobs = apply_train_knobs(
            config, RunKnobs(rules_preset=self.rules_preset))
        if self.device.type == "cuda":
            # the last test's model and state are gone; return their
            # cached blocks so this test's larger ones need not fit
            # between the fragments
            torch.cuda.empty_cache()
        step_fn, params, opt_state, batches = _measured_train_setup(
            self.cfg, knobs, self.seq_len, self.global_batch, self.steps,
            self.seed, self.device)
        state = {"params": params, "opt": opt_state, "m": None}
        del params, opt_state

        def loop():
            p, o = state.pop("params"), state.pop("opt")
            for b in batches:
                p, o, m = step_fn(p, o, b)
            sync(self.device)
            state.update(params=p, opt=o, m=m)

        sec = median_wall_clock(loop, self.warmup, self.repeats) / self.steps
        tput = self.seq_len * self.global_batch / sec
        return PerfMetric(
            value=tput, higher_is_better=True,
            metrics={"step_seconds": sec, "tokens_per_sec": tput,
                     "loss": float(state["m"]["loss"]),
                     "warmup": self.warmup, "repeats": self.repeats})


class TorchMeasuredSUT:
    """Real measured tuning: config -> training tokens/sec on ``device``.

    The paper's loop (apply config, restart the system, run the workload,
    measure) end to end, over the reference's space: ``remat``,
    ``microbatches``, ``loss_chunk``, ``donate`` and ``scan_unroll``.
    The last two stay in the space, inert (the eager step reads neither),
    so the tuner draws the reference's trial stream.  Each test builds
    the model and state, runs ``warmup`` untimed steps (kernel builds
    included) and times ``steps`` steps, each span ended by a device
    sync.
    """

    def __init__(self, cfg, seq_len: int = 128, global_batch: int = 8,
                 steps: int = 6, warmup: int = 2, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        from repro_torch.models.common import resolve_device

        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.steps = steps
        self.warmup = warmup
        self.seed = seed
        self.device = resolve_device(device)
        self.name = f"torch-measured[{cfg.name}]"

    def space(self) -> ParameterSpace:
        return ParameterSpace([
            EnumParam("remat", ("full", "dots", "none"), "full"),
            EnumParam("microbatches", (1, 2, 4), 1),
            EnumParam("loss_chunk", (0, 32, 64), 0),
            BoolParam("donate", True),
            EnumParam("scan_unroll", (1, 2), 1),
        ])

    def test(self, config: Config) -> PerfMetric:
        from repro_torch.train.step import RunKnobs

        knobs = RunKnobs(
            remat=config["remat"], microbatches=config["microbatches"],
            loss_chunk=config["loss_chunk"], donate=config["donate"],
            scan_unroll=config["scan_unroll"], rules_preset="dp")
        if self.device.type == "cuda":
            torch.cuda.empty_cache()  # the last test's state is gone
        step_fn, params, opt_state, batches = _measured_train_setup(
            self.cfg, knobs, self.seq_len, self.global_batch,
            self.warmup + self.steps, self.seed, self.device)
        m = None
        for i in range(self.warmup):
            params, opt_state, m = step_fn(params, opt_state, batches[i])
        sync(self.device)
        t0 = time.perf_counter()
        for i in range(self.warmup, self.warmup + self.steps):
            params, opt_state, m = step_fn(params, opt_state, batches[i])
        sync(self.device)
        dt = (time.perf_counter() - t0) / self.steps
        tput = self.seq_len * self.global_batch / dt
        return PerfMetric(value=tput, higher_is_better=True,
                          metrics={"step_seconds": dt,
                                   "tokens_per_sec": tput,
                                   "loss": float(m["loss"])})
