"""Fault-tolerant training loop.

Counterpart of ``repro.train.loop``:

* auto-resume from the newest valid checkpoint (params + optimizer + step),
* atomic periodic checkpoints (async optional; ``checkpoint.manager``
  copies the state to the host before the next step writes it),
* restart-safe data (batches are a pure function of the step),
* simulated failure injection (tests kill the loop mid-run and resume),
* per-step metrics with throughput accounting, each step ended by a
  device sync so its seconds are the device's.

The step runs eagerly (the reference jits it); ``knobs.donate`` is
inert, as it is in ``train.step``.  One edge differs: a run resumed at
its last step runs nothing and saves nothing (the reference reports one
step more than it reached and saves the restored state under that
step).  Elastic restore onto another mesh
raises (ROADMAP queue 1: multi-device).  The model runs on ``device``,
whose default ``"cuda"`` raises without a card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ModelConfig
from repro_torch.core.sut_torch import sync
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import Model
from repro_torch.optim import OptimizerConfig
from repro_torch.train.step import RunKnobs, init_train_state, make_train_step

__all__ = ["TrainLoopConfig", "SimulatedFailure", "train"]


class SimulatedFailure(RuntimeError):
    """Raised by failure injection; tests treat it as a node crash."""


@dataclass
class TrainLoopConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = False
    fail_at_step: Optional[int] = None  # failure injection (tests)
    opt: OptimizerConfig = field(default_factory=OptimizerConfig)
    knobs: RunKnobs = field(default_factory=lambda: RunKnobs(loss_chunk=0))


def train(cfg: ModelConfig, loop: TrainLoopConfig,
          callbacks: Optional[List[Callable[[int, Dict], None]]] = None,
          device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    model = Model(cfg, device=device)
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=loop.seq_len,
        global_batch=loop.global_batch, seed=loop.seed))

    params, opt_state = init_train_state(model, loop.seed, loop.knobs)

    manager = None
    start_step = 0
    if loop.ckpt_dir:
        manager = CheckpointManager(loop.ckpt_dir, keep=loop.ckpt_keep,
                                    async_save=loop.ckpt_async)
        if manager.latest() is not None:
            start_step, state = manager.restore(
                {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(model, loop.opt, loop.knobs)

    history: List[Dict[str, float]] = []
    tokens_per_step = loop.seq_len * loop.global_batch
    t_start = time.time()
    done = start_step  # steps completed
    try:
        for step in range(start_step, loop.steps):
            if loop.fail_at_step is not None and step == loop.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(v).to(model.device)
                     for k, v in data.batch_at(step).items()}
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            sync(model.device)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_seconds"] = time.time() - t0
            metrics["tokens_per_sec"] = tokens_per_step / max(
                metrics["step_seconds"], 1e-9)
            history.append(metrics)
            if callbacks:
                for cb in callbacks:
                    cb(step, metrics)
            if loop.log_every and (step + 1) % loop.log_every == 0:
                print(f"[train] step {step + 1}/{loop.steps} "
                      f"loss={metrics['loss']:.4f} "
                      f"acc={metrics['accuracy']:.3f} "
                      f"tok/s={metrics['tokens_per_sec']:.0f}")
            done = step + 1
            if manager and done % loop.ckpt_every == 0:
                manager.save(done, {"params": params, "opt": opt_state},
                             extra={"loss": metrics["loss"]})
    finally:
        if manager:
            manager.wait()

    if manager and done > start_step and done % loop.ckpt_every != 0:
        manager.save(done, {"params": params, "opt": opt_state})
        manager.wait()

    return {
        "params": params,
        "opt_state": opt_state,
        "history": history,
        "final_step": done,
        "wall_seconds": time.time() - t_start,
    }
