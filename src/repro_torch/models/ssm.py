"""Mamba2 (SSD) block: state-space duality on top of the GLA core.

Counterpart of ``repro.models.ssm``: the full-sequence block, the
decode step and its cache:

    [z | x | B | C | dt] = in_proj(u)
    x,B,C <- causal depthwise conv (k=4) + SiLU
    dt = softplus(dt_raw + dt_bias);  g = -exp(A_log) · dt   (per head)
    h_t = exp(g_t)·h_{t-1} + dt_t·B_t x_tᵀ ;  y_t = C_tᵀ h_t + D·x_t
    out = out_proj( RMSNorm(y) * SiLU(z) )

B/C are shared across heads (single group), x is split into heads of
size ``head_dim = d_inner / ssm_heads``; the recurrence is chunked GLA
with q=C, k=B, v=dt·x, q and k passed as head broadcasts (no copies).
``cfg.gla_impl`` picks the plain ``models.gla.chunked_gla`` ("jnp") or
the CUDA kernel through ``kernels.ops.gla`` ("pallas").  Serving keeps
a cache of the conv window's last ``ssm_conv - 1`` inputs and the f32
SSM state a layer (``mamba2_cache_defs``); ``mamba2_decode`` advances
both by one token through ``models.gla.gla_step``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (dtype_of, fan_in_init, normal_init,
                                       ones_init, rms_norm, zeros_init)
from repro_torch.models.gla import chunked_gla, gla_step

__all__ = ["mamba2_defs", "mamba2_cache_defs", "mamba2_block",
           "mamba2_decode"]


def _gla(cfg: ModelConfig, q, k, v, log_g):
    """Chunked-GLA dispatch: the plain core or the CUDA kernel.  The chunk
    is passed explicitly, as the reference does, so the model path never
    reads the autotune cache for it."""
    if cfg.gla_impl == "pallas":
        return ops.gla(q, k, v, log_g, chunk=cfg.ssm_chunk)
    return chunked_gla(q, k, v, log_g, chunk=cfg.ssm_chunk)


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = cfg.ssm_heads or max(1, d_inner // 64)
    hd = d_inner // nh
    ds = cfg.ssm_state
    return d_inner, nh, hd, ds


def _neg_A_init(gen, shape, dtype, device):
    # A in [1, 16] -> A_log = log(A)
    a = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=device) * 15.0 + 1.0
    return torch.log(a).to(dtype)


def _dt_bias_init(gen, shape, dtype, device):
    # dt in [1e-3, 1e-1] after softplus: store its inverse softplus
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(u * (hi - lo) + lo)
    return (dt + torch.log(-torch.expm1(-dt))).to(dtype)


def mamba2_defs(cfg: ModelConfig):
    """{name: (shape, init, dtype)} for one block's mixer weights; dtype
    None is the config's param dtype."""
    d = cfg.d_model
    d_inner, nh, hd, ds = _dims(cfg)
    conv_dim = d_inner + 2 * ds
    f32 = torch.float32
    return {
        "in_proj": ((d, 2 * d_inner + 2 * ds + nh), fan_in_init(0), None),
        "conv_w": ((cfg.ssm_conv, conv_dim), normal_init(0.1), None),
        "conv_b": ((conv_dim,), zeros_init(), None),
        "A_log": ((nh,), _neg_A_init, f32),
        "D": ((nh,), ones_init(), f32),
        "dt_bias": ((nh,), _dt_bias_init, f32),
        "norm_scale": ((d_inner,), ones_init(), f32),
        "out_proj": ((d_inner, d), fan_in_init(0), None),
    }


def mamba2_cache_defs(cfg: ModelConfig, batch: int):
    """{name: (shape, dtype)} of one layer's decode cache: the conv
    window's last ``ssm_conv - 1`` inputs and the SSM state, both f32."""
    d_inner, nh, hd, ds = _dims(cfg)
    conv_dim = d_inner + 2 * ds
    return {"conv": ((batch, cfg.ssm_conv - 1, conv_dim), torch.float32),
            "state": ((batch, nh, ds, hd), torch.float32)}


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, nh, hd, ds = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * ds, nh], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via k shifted adds. xBC: (B, S, D); w: (k, D)."""
    kk = w.shape[0]
    xp = F.pad(xBC, (0, 0, kk - 1, 0))
    S = xBC.shape[1]
    out = sum(xp[:, j:j + S, :] * w[j] for j in range(kk)) + b
    return F.silu(out)


def _ssd_inputs(cfg: ModelConfig, params, xBC, dt_raw):
    d_inner, nh, hd, ds = _dims(cfg)
    x, Bm, Cm = torch.split(xBC, [d_inner, ds, ds], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())  # (..., nh)
    log_g = -torch.exp(params["A_log"].float()) * dt
    return x, Bm, Cm, dt, log_g


def mamba2_block(params: Dict[str, torch.Tensor], u: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """u: (B, S, d_model) -> (B, S, d_model). Full-sequence (train/prefill)."""
    B, S, d = u.shape
    d_inner, nh, hd, ds = _dims(cfg)
    cdt = dtype_of(cfg.compute_dtype)

    zxbcdt = u.to(cdt) @ params["in_proj"].to(cdt)
    z, xBC, dt_raw = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC.float(), params["conv_w"].float(),
                       params["conv_b"].float())
    x, Bm, Cm, dt, log_g = _ssd_inputs(cfg, params, xBC, dt_raw)

    xh = x.reshape(B, S, nh, hd)
    # one (B, S, ds) row per step, broadcast over the heads (stride 0)
    q = Cm[:, :, None, :].expand(B, S, nh, ds)
    k = Bm[:, :, None, :].expand(B, S, nh, ds)
    v = xh * dt[..., None]
    y, _ = _gla(cfg, q, k, v, log_g)
    y = y + xh * params["D"].float()[None, None, :, None]
    y = y.reshape(B, S, d_inner)

    y = rms_norm(y, params["norm_scale"], cfg.norm_eps) * F.silu(z.float())
    return y.to(cdt) @ params["out_proj"].to(cdt)


def mamba2_decode(params: Dict[str, torch.Tensor], u: torch.Tensor,
                  cache: Dict[str, torch.Tensor], cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent step, O(1) a token: u (B, 1, d_model) ->
    (out (B, 1, d_model), the new {"conv", "state"})."""
    B, S, d = u.shape
    if S != 1:
        raise ValueError(f"mamba2_decode takes one token a row; got {S}")
    d_inner, nh, hd, ds = _dims(cfg)
    cdt = dtype_of(cfg.compute_dtype)

    zxbcdt = u.to(cdt) @ params["in_proj"].to(cdt)
    z, xBC, dt_raw = _split_proj(cfg, zxbcdt)
    xBC = xBC[:, 0].float()  # (B, conv_dim)

    # conv window update
    window = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)  # (B, k, D)
    conv_out = F.silu(torch.einsum("bkd,kd->bd", window,
                                   params["conv_w"].float())
                      + params["conv_b"].float())

    x, Bm, Cm, dt, log_g = _ssd_inputs(cfg, params, conv_out[:, None, :],
                                       dt_raw)
    xh = x[:, 0].reshape(B, nh, hd)
    q = Cm[:, 0, None, :].expand(B, nh, ds)
    k = Bm[:, 0, None, :].expand(B, nh, ds)
    v = xh * dt[:, 0, :, None]
    y, state = gla_step(q, k, v, log_g[:, 0], cache["state"])
    y = y + xh * params["D"].float()[None, :, None]
    y = y.reshape(B, 1, d_inner)

    y = rms_norm(y, params["norm_scale"], cfg.norm_eps) * F.silu(z.float())
    out = y.to(cdt) @ params["out_proj"].to(cdt)
    return out, {"conv": window[:, 1:], "state": state}
