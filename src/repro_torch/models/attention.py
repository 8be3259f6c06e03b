"""GQA self-attention with RoPE, with and without a KV cache.

Counterpart of ``repro.models.attention`` on these paths:

* cache-free full-sequence attention (``Model.forward`` / ``loss``),
  through ``attend`` with the reference's inner implementations:
  ``dense`` (materialized logits), ``blocked`` (flash-style online
  softmax over KV blocks in plain PyTorch), ``pallas`` (the CUDA
  flash-attention kernel, ``kernels.ops.flash_attention``) and ``auto``
  (the reference's rules choosing among them);
* the dense cache path (``init_attn_cache_defs``' (B, S, KV, D)
  buffers): with a scalar ``cache_index`` (chunked prefill, the wave
  runtime's decode step) append the chunk's K/V at it, with a (B,)
  vector (the dense continuous layout) append each slot's token(s) at
  its own index; then dense causal attention (``attend(impl="dense")``);
* the paged decode path: append each slot's token through its
  page-table row, then the paged decode kernel
  (``kernels.ops.paged_flash_decode``); with C > 1 tokens a slot (the
  speculative verify of n-gram drafts) append all C and attend with
  ``_paged_verify_attend``, plain PyTorch as in the reference.

Unlike the reference, whose arrays are immutable, the cache tensors are
updated in place; the returned cache is the same dict.  The banded
``local`` implementation and the ring cache of sliding windows, and
cross-attention, are later slices and raise ``NotImplementedError``.
All softmax math runs in f32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (apply_rope, dtype_of, fan_in_init,
                                       rope_freqs)

__all__ = ["attention_defs", "init_attn_cache_defs", "self_attention",
           "attend"]

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


def init_attn_cache_defs(cfg: ModelConfig, batch: int, max_seq: int):
    """{name: (shape, dtype)} of one block's dense KV-cache buffers."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    dt = dtype_of(cfg.compute_dtype)
    return {"k": (shape, dt), "v": (shape, dt)}


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


def _blocked_attend(q, k, v, *, causal: bool, block_q: int, block_kv: int,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash-style two-level loop: memory O(block_q x block_kv).  Every KV
    block is visited (masked ones too), as in the reference's scan."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    pad_q = (-Sq) % block_q
    pad_k = (-Sk) % block_kv
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_kv
    qb = qp.reshape(B, nq, block_q, KV, G, D).float() / math.sqrt(D)
    kb = kp.reshape(B, nk, block_kv, KV, D).float()
    vb = vp.reshape(B, nk, block_kv, KV, D).float()

    qpos = (q_offset + torch.arange(nq * block_q, device=dev)).reshape(
        nq, block_q)
    kpos = torch.arange(nk * block_kv, device=dev).reshape(nk, block_kv)
    kvalid = (torch.arange(nk * block_kv, device=dev) < Sk).reshape(
        nk, block_kv)

    outs = []
    for qi in range(nq):
        qblk, qp_blk = qb[:, qi], qpos[qi]  # (B, bq, KV, G, D), (bq,)
        m = torch.full((B, KV, G, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, block_q, D), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            logits = torch.einsum("bqkgd,bskd->bkgqs", qblk, kb[:, ki])
            mask = kvalid[ki][None, :]
            if causal:
                mask = mask & (kpos[ki][None, :] <= qp_blk[:, None])
            logits = logits.masked_fill(~mask[None, None, None], NEG_INF)
            new_m = torch.maximum(m, logits.amax(-1))
            scale = torch.exp(m - new_m)
            p = torch.exp(logits - new_m[..., None])
            l = l * scale + p.sum(-1)
            acc = acc * scale[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vb[:, ki])
            m = new_m
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,KV,G,bq,D)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, bq, KV, G, D)
    out = torch.stack(outs, dim=1).reshape(B, nq * block_q, H, D)
    return out[:, :Sq].to(v.dtype)


def attend(q, k, v, *, cfg: ModelConfig, causal: bool = True,
           window: int = 0, impl: Optional[str] = None,
           q_offset: Union[int, torch.Tensor] = 0,
           kv_len: Optional[Union[int, torch.Tensor]] = None
           ) -> torch.Tensor:
    """Dispatch to an inner attention implementation: ``impl`` or else
    ``cfg.attn_impl``, with the reference's ``auto`` rules."""
    impl = impl or cfg.attn_impl
    Sq, Sk = q.shape[1], k.shape[1]
    if window and causal and Sq == Sk and Sk <= window:
        window = 0  # the window covers the whole causal context: no-op
    if impl == "auto":
        if Sq == 1 or kv_len is not None:
            impl = "dense"  # decode: one query row, einsum over the cache
        elif window and causal and Sq == Sk and Sk > 2 * window:
            impl = "local"
        elif Sk >= 2 * cfg.attn_block_kv:
            impl = "blocked"
        else:
            impl = "dense"
    if impl == "pallas":
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "local":
        raise NotImplementedError(
            "attention impl 'local' (banded sliding-window attention) is "
            "not ported (ROADMAP queue 1: other model families)")
    if impl == "blocked":
        if window:  # blocked path is exact only without a window
            raise ValueError("blocked impl does not support sliding window")
        return _blocked_attend(q, k, v, causal=causal,
                               block_q=cfg.attn_block_q,
                               block_kv=cfg.attn_block_kv,
                               q_offset=q_offset)
    if impl == "dense":
        return _dense_attend(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len)
    raise ValueError(f"unknown attention impl {impl!r}")


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
    """Causal self-attention; appends ``x``'s K/V to ``cache`` when one is
    given.

    Without a cache: full-sequence (forward / train) attention through
    ``attend`` with ``cfg.attn_impl``; the cache returned is None.  With
    ``page_table`` the cache is a (groups, group_tokens, KV, D) pool and
    ``cache_index`` a (B,) vector: every slot appends its token(s) at its
    own position through its table row, then attends with the paged
    decode kernel (one token) or ``_paged_verify_attend`` (C > 1).
    Otherwise the cache is a dense (B, S, KV, D) buffer: with an int
    ``cache_index`` the chunk lands at ``cache_index`` and attends
    causally over the first ``cache_index + S`` positions; with a (B,)
    vector each slot's token(s) land at its own index and attend over its
    own prefix.
    """
    q, k, v = _project_qkv(params, x, cfg)
    cos, sin = rope_freqs(positions, cfg.head_dim_, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        y = attend(q, k, v, cfg=cfg)
    elif page_table is not None:
        ck, cv = cache["k"], cache["v"]
        B, S_new = k.shape[:2]
        T = ck.shape[1]
        rows = torch.arange(B, device=x.device)
        pos = torch.as_tensor(cache_index, device=x.device).long()
        if S_new == 1:
            gid = page_table[rows, pos // T].long()
            off = pos % T
            ck[gid, off] = k[:, 0].to(ck.dtype)
            cv[gid, off] = v[:, 0].to(cv.dtype)
            y = _paged_decode_attend(q, ck, cv, page_table,
                                     (pos + 1).to(torch.int32))
        else:
            # Speculative verify: C tokens a slot at pos..pos+C-1.  The
            # reference routes columns past the page table (a draft chain
            # overrunning max_seq on a request that finishes first) out of
            # range and drops them in the scatter; indexed assignment
            # would raise there, so they are masked out of the write.
            # Columns past a slot's reservation land in the scratch
            # entries of its row.  Either way no accepted column reads
            # them.
            MAXG = page_table.shape[1]
            ppos = pos[:, None] + torch.arange(S_new, device=x.device)
            lg = ppos // T
            keep = lg < MAXG
            gid = page_table[rows[:, None], lg.clamp(max=MAXG - 1)].long()
            off = ppos % T
            ck[gid[keep], off[keep]] = k[keep].to(ck.dtype)
            cv[gid[keep], off[keep]] = v[keep].to(cv.dtype)
            y = _paged_verify_attend(q, ck, cv, page_table, pos)
    elif isinstance(cache_index, torch.Tensor):
        # The dense continuous layout: each slot appends its token(s) at
        # its own index.  S_new > 1 is the speculative-verify chain; the
        # reference drops the columns past the buffer (a draft chain
        # overrunning max_seq on a request that finishes first) in its
        # scatter, and indexed assignment would raise there, so they are
        # masked out of the write.  No accepted column reads them.
        ck, cv = cache["k"], cache["v"]
        B, S_new = k.shape[:2]
        idx = cache_index.long()
        rows = torch.arange(B, device=x.device)
        if S_new == 1:
            ck[rows, idx] = k[:, 0].to(ck.dtype)
            cv[rows, idx] = v[:, 0].to(cv.dtype)
        else:
            ppos = idx[:, None] + torch.arange(S_new, device=x.device)
            keep = ppos < ck.shape[1]
            rows = rows[:, None].expand_as(ppos)[keep]
            ck[rows, ppos[keep]] = k[keep].to(ck.dtype)
            cv[rows, ppos[keep]] = v[keep].to(cv.dtype)
        y = attend(q, ck, cv, cfg=cfg, causal=True, window=0, impl="dense",
                   kv_len=idx + S_new, q_offset=idx)
    else:
        ck, cv = cache["k"], cache["v"]
        S_new = k.shape[1]
        ck[:, cache_index:cache_index + S_new] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S_new] = v.to(cv.dtype)
        y = attend(q, ck, cv, cfg=cfg, causal=True, window=0, impl="dense",
                   kv_len=cache_index + S_new, q_offset=cache_index)

    return out_proj(params, y, cfg), cache


def out_proj(params, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, H, Dh) attention output -> (B, S, d) through ``wo``."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, H, Dh = y.shape
    return y.reshape(B, S, H * Dh).to(cdt) @ params["wo"].reshape(
        H * Dh, -1).to(cdt)


def _paged_decode_attend(q, k_pages, v_pages, page_table, lengths):
    """Decode attention over a paged pool (single-step q): the CUDA kernel
    for CUDA tensors, its plain PyTorch version for CPU tensors."""
    out = ops.paged_flash_decode(q[:, 0].contiguous(), k_pages, v_pages,
                                 page_table, lengths)
    return out[:, None].to(v_pages.dtype)


def _paged_verify_attend(q, k_pages, v_pages, page_table, base):
    """Multi-token decode attention over a paged pool (speculative
    verify), plain PyTorch on every device as in the reference: gather
    the pool into logical order through the whole page-table row, in
    f32, then masked attention where column i (absolute position
    ``base + i``) sees key positions up to ``base + i``.  Scratch-group
    and rejected-tail writes are masked out like stale pool tokens, so
    the accepted prefix attends exactly the KV a draft-free run would."""
    B, C, H, D = q.shape
    KV = k_pages.shape[2]
    table = page_table.long()
    k = k_pages[table].reshape(B, -1, KV, D).float()
    v = v_pages[table].reshape(B, -1, KV, D).float()
    qg = q.reshape(B, C, KV, H // KV, D).float() / math.sqrt(D)
    s = torch.einsum("bckgd,bskd->bkgcs", qg, k)
    kpos = torch.arange(k.shape[1], device=q.device)
    qpos = base.long()[:, None] + torch.arange(C, device=q.device)[None]
    mask = kpos[None, None, :] <= qpos[:, :, None]  # (B, C, S)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgcs,bskd->bckgd", w, v)
    return out.reshape(B, C, H, D).to(v_pages.dtype)
