"""Plain PyTorch oracles for the ported kernels (the allclose references).

Counterpart of ``repro.kernels.ref``: ``attention_ref`` (the plain
version of the flash attention kernel, and the dense attention the decode
kernels are checked against), ``rmsnorm_ref`` and ``gla_ref`` (the
O(S²) oracle of gated linear attention; the GLA kernel's plain version is
the chunked ``models.gla.chunked_gla``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["attention_ref", "rmsnorm_ref", "gla_ref", "cumsum_f32"]


def cumsum_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumsum along ``dim`` added left to right in f32: the
    order of the reference's ``jnp.cumsum`` on the CPU over the reduced
    configs' chunk of 16 steps (XLA blocks longer scans).  ``torch.cumsum``
    on the CPU accumulates in f64, and a GLA decay exp(c_t - c_s) of two
    large cumsums magnifies the difference (an f32 ulp of |c| ~ 150 is
    1.5e-5).  On the card ``torch.cumsum`` accumulates in f32 already, so
    it is used there: the loop would cost a launch a step."""
    x = x.float()
    if x.device.type != "cpu":
        return torch.cumsum(x, dim)
    out = [x.select(dim, 0)]
    for i in range(1, x.shape[dim]):
        out.append(out[-1] + x.select(dim, i))
    return torch.stack(out, dim=dim)


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Materialized-logits GQA attention, f32 softmax."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float() / math.sqrt(D)
    kf = k.float()
    vf = v.float()
    qg = qf.reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kf)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask[None, None, None], -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, vf)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Mean of squares in f32, ``x * rsqrt(var + eps) * scale``, cast
    back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def gla_ref(
    q: torch.Tensor,  # (B, S, H, dk)
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    log_g: torch.Tensor,  # (B, S, H)  (<= 0)
    initial_state: Optional[torch.Tensor] = None,  # (B, H, dk, dv)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(S²) direct evaluation of gated linear attention:
    y_t = Σ_{s≤t} exp(c_t − c_s) (q_t·k_s) v_s + exp(c_t)·q_tᵀS₀."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    c = cumsum_f32(log_g, dim=1)  # (B, S, H)
    dmat = c[:, :, None, :] - c[:, None, :, :]  # (B, t, s, H)
    tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~tri[None, :, :, None], float("-inf"))
    att = torch.einsum("bthd,bshd->btsh", qf, kf) * torch.exp(dmat)
    y = torch.einsum("btsh,bshv->bthv", att, vf)
    S0 = (initial_state.float() if initial_state is not None
          else torch.zeros((B, H, dk, dv), dtype=torch.float32,
                           device=q.device))
    y = y + torch.einsum("bthd,bhdv->bthv", qf * torch.exp(c)[..., None], S0)
    cL = c[:, -1, :]
    k_decay = torch.exp(cL[:, None, :] - c)
    state = torch.exp(cL)[:, :, None, None] * S0 + torch.einsum(
        "bshd,bshv->bhdv", kf * k_decay[..., None], vf)
    return y.to(v.dtype), state
