"""Dense gated MLP: SwiGLU (llama-family) and GeGLU (gemma).

Counterpart of ``repro.models.mlp`` for the gated activations.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models.common import dtype_of, fan_in_init

__all__ = ["mlp_defs", "mlp"]


def mlp_defs(cfg: ModelConfig):
    """{name: (shape, init)} for one block's MLP weights."""
    if cfg.activation not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"activation {cfg.activation!r}: only the gated MLPs (swiglu, "
            "geglu) are ported (ROADMAP queue 1, item 7)")
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "wi": ((d, ff), fan_in_init(0)),
        "wg": ((d, ff), fan_in_init(0)),
        "wo": ((ff, d), fan_in_init(0)),
    }


def _act(name: str, g: torch.Tensor) -> torch.Tensor:
    if name in ("swiglu", "silu"):
        return F.silu(g)
    if name in ("geglu", "gelu"):
        return F.gelu(g, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: ModelConfig) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    x = x.to(cdt)
    h = x @ params["wi"].to(cdt)
    g = x @ params["wg"].to(cdt)
    h = _act(cfg.activation, g) * h
    return h @ params["wo"].to(cdt)
