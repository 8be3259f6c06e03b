"""GQA self-attention with RoPE over a KV cache, for the serve paths.

Counterpart of ``repro.models.attention`` on the paths the paged
continuous engine runs:

* the scalar-``cache_index`` cache path (chunked prefill): append the
  chunk's K/V into a dense cache view, then dense causal attention
  (``attend(impl="dense")``);
* the paged single-token decode path: append each slot's token through
  its page-table row, then the paged decode kernel
  (``kernels.ops.paged_flash_decode``).

Unlike the reference, whose arrays are immutable, the cache tensors are
updated in place; the returned cache is the same dict.  Cache-free
(training) attention, the vector-``cache_index`` dense layout, sliding
windows, speculative verify and cross-attention are later slices and
raise ``NotImplementedError``.  All softmax math runs in f32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_rope, dtype_of, fan_in_init,
                                       rope_freqs)

__all__ = ["attention_defs", "self_attention", "attend"]

NEG_INF = -1e30


def attention_defs(cfg: ModelConfig):
    """{name: (shape, init)} for one block's attention weights."""
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "wq": ((d, H, Dh), fan_in_init(0)),
        "wk": ((d, KV, Dh), fan_in_init(0)),
        "wv": ((d, KV, Dh), fan_in_init(0)),
        "wo": ((H, Dh, d), fan_in_init(1)),
    }


# ---------------------------------------------------------------------------
# inner attention
# ---------------------------------------------------------------------------
def _gqa_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,D), k: (B,Sk,KV,D) -> logits (B,H,Sq,Sk) without
    materializing repeated KV heads."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    return logits.reshape(B, KV * G, Sq, k.shape[1])


def _gqa_out(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weights: (B,H,Sq,Sk), v: (B,Sk,KV,D) -> (B,Sq,H,D)."""
    B, H, Sq, Sk = weights.shape
    KV = v.shape[2]
    G = H // KV
    wg = weights.reshape(B, KV, G, Sq, Sk)
    out = torch.einsum("bkgqs,bskd->bqkgd", wg, v.float())
    return out.reshape(B, Sq, H, v.shape[-1])


def _frame(x: Union[int, torch.Tensor]) -> Union[int, torch.Tensor]:
    """A scalar stays a host int (no device copy); a (B,) vector becomes
    (B, 1, 1) for the (B-or-1, Sq, Sk) mask frame."""
    return x.reshape(-1, 1, 1) if isinstance(x, torch.Tensor) else x


def _dense_attend(q, k, v, *, causal: bool, window: int,
                  q_offset: Union[int, torch.Tensor],
                  kv_len: Optional[Union[int, torch.Tensor]]
                  ) -> torch.Tensor:
    """Materialized-logits attention.  ``q_offset`` and ``kv_len`` may be
    scalars or (B,)-vectors; the mask is built in a (B-or-1, Sq, Sk)
    frame so both shapes share one code path."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    logits = _gqa_logits(q, k) / math.sqrt(D)
    qpos = torch.arange(Sq, device=dev)[None, :, None] + _frame(q_offset)
    kpos = torch.arange(Sk, device=dev)[None, None, :]
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    if kv_len is not None:
        mask = mask & (kpos < _frame(kv_len))
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return _gqa_out(weights, v).to(v.dtype)


def attend(q, k, v, *, cfg: ModelConfig, causal: bool = True,
           window: int = 0, impl: Optional[str] = None,
           q_offset: Union[int, torch.Tensor] = 0,
           kv_len: Optional[Union[int, torch.Tensor]] = None
           ) -> torch.Tensor:
    """Dispatch to an inner attention implementation (``dense`` only in
    this slice; the reference's blocked/local/flash paths are later)."""
    if impl != "dense":
        raise NotImplementedError(
            f"attention impl {impl!r}: only 'dense' is ported (the flash "
            "attention kernel is ROADMAP queue 2, item 2)")
    return _dense_attend(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, kv_len=kv_len)


# ---------------------------------------------------------------------------
# block-level wrapper
# ---------------------------------------------------------------------------
def _project_qkv(params, x, cfg: ModelConfig):
    cdt = dtype_of(cfg.compute_dtype)
    B, S, d = x.shape
    src = x.to(cdt)
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    q = (src @ wq.reshape(d, -1).to(cdt)).reshape(B, S, *wq.shape[1:])
    k = (src @ wk.reshape(d, -1).to(cdt)).reshape(B, S, *wk.shape[1:])
    v = (src @ wv.reshape(d, -1).to(cdt)).reshape(B, S, *wv.shape[1:])
    return q, k, v


def self_attention(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,  # (S,) or (B, S) absolute positions of x
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Union[int, torch.Tensor, None] = None,  # int or (B,)
    page_table: Optional[torch.Tensor] = None,  # (B, MAXG) int32
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Causal self-attention that appends ``x``'s K/V to ``cache``.

    With ``page_table`` the cache is a (groups, group_tokens, KV, D) pool
    and ``cache_index`` a (B,) vector: every slot appends its single token
    at its own position through its table row, then attends with the
    paged decode kernel.  With an int ``cache_index`` the cache is a
    dense (B, S, KV, D) buffer: the chunk lands at ``cache_index`` and
    attends causally over the first ``cache_index + S`` positions.
    """
    if cache is None:
        raise NotImplementedError(
            "cache-free attention (forward/train) is not ported "
            "(ROADMAP queue 1, items 1 and 6)")
    q, k, v = _project_qkv(params, x, cfg)
    cos, sin = rope_freqs(positions, cfg.head_dim_, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    ck, cv = cache["k"], cache["v"]
    S_new = k.shape[1]
    if page_table is not None:
        if S_new != 1:
            raise NotImplementedError(
                "multi-token paged append (speculative verify) is not "
                "ported (ROADMAP queue 1, item 3)")
        B = x.shape[0]
        T = ck.shape[1]
        pos = torch.as_tensor(cache_index, device=x.device).long()
        gid = page_table[torch.arange(B, device=x.device), pos // T].long()
        off = pos % T
        ck[gid, off] = k[:, 0].to(ck.dtype)
        cv[gid, off] = v[:, 0].to(cv.dtype)
        y = _paged_decode_attend(q, ck, cv, page_table,
                                 (pos + 1).to(torch.int32))
    else:
        if not isinstance(cache_index, int):
            raise NotImplementedError(
                "per-slot cache_index on a dense cache (the dense "
                "continuous layout) is not ported (ROADMAP queue 1, item 3)")
        ck[:, cache_index:cache_index + S_new] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S_new] = v.to(cv.dtype)
        y = attend(q, ck, cv, cfg=cfg, causal=True, window=0, impl="dense",
                   kv_len=cache_index + S_new, q_offset=cache_index)

    cdt = dtype_of(cfg.compute_dtype)
    B, S, H, Dh = y.shape
    out = y.reshape(B, S, H * Dh).to(cdt) @ params["wo"].reshape(
        H * Dh, -1).to(cdt)
    return out, cache


def _paged_decode_attend(q, k_pages, v_pages, page_table, lengths):
    """Decode attention over a paged pool (single-step q): the CUDA kernel
    for CUDA tensors, its plain PyTorch version for CPU tensors."""
    out = ops.paged_flash_decode(q[:, 0].contiguous(), k_pages, v_pages,
                                 page_table, lengths)
    return out[:, None].to(v_pages.dtype)
