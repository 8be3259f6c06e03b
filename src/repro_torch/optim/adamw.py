"""AdamW with f32 moments, global-norm clipping and LR schedules.

Counterpart of ``repro.optim.adamw``: pure functions over the port's
parameter trees (nested dicts and lists of tensors, as ``Model.init``
makes them), returning new trees; the math runs in f32 whatever the
parameter dtype.  ``tree_map`` and ``tree_leaves`` stand in for
``jax.tree_util``.  The reference's ``opt_state_defs`` (sharding specs of
the optimizer state) comes with ROADMAP queue 1: multi-device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "lr_at",
           "global_norm", "clip_by_global_norm", "tree_map", "tree_leaves"]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping the nesting of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant
    min_lr_ratio: float = 0.1


def lr_at(cfg: OptimizerConfig,
          step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate at ``step`` (an f32 scalar tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.ones_like(step)
    return cfg.learning_rate * warm * decay


def adamw_init(params) -> Dict[str, Any]:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(zeros32, params),
        "nu": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def adamw_update(grads, opt_state, params, cfg: OptimizerConfig):
    """One AdamW step -> (new params, new state, lr).  grads may be any
    float dtype; the math runs in f32, in the reference's order of
    operations, and each new parameter is rounded once to its dtype.  The
    f32 moments are updated in place (the reference returns new arrays):
    at full width a second copy of them would not fit beside the first.
    A leaf at a time, so the f32 temporaries of one leaf are freed before
    the next."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf

    def upd(g, mu, nu, p):
        g32 = g.float()
        mu_n = mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        nu_n = nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
        del g32
        # mhat / (sqrt(vhat) + eps), each temporary freed once consumed
        delta = (mu_n / b1c) / (torch.sqrt(nu_n / b2c) + cfg.eps)
        p32 = p.float()
        p_n = p32 - lr * (delta + cfg.weight_decay * p32)
        return p_n.to(p.dtype), mu_n, nu_n

    out = tree_map(upd, grads, opt_state["mu"], opt_state["nu"], params)
    return (_unzip(out, 0), {"mu": _unzip(out, 1), "nu": _unzip(out, 2),
                             "step": step}, lr)


def _unzip(tree, i):
    """Element ``i`` of every tuple leaf of ``tree``."""
    return tree_map(lambda t: t[i], tree)
