"""Model assembly for the serve paths: embeddings, the ``attn`` block
stack, tied logits, chunked prefill and paged continuous-batching decode.

Counterpart of ``repro.models.transformer`` for ``superblock=("attn",)``
stacks.  The reference scans over parameters stacked along a leading
layer axis; PyTorch runs eagerly, so here the layers are a plain list of
per-layer dicts and the stack is a Python loop.  ``models.bridge`` turns
the reference's stacked pytree into this layout.

Parameters::

    {"embed": (V_pad, d),
     "blocks": [{"ln1": (d,), "attn": {"wq", "wk", "wv", "wo"},
                 "ln2": (d,), "mlp": {"wi", "wg", "wo"}}, ...],
     "final_norm": (d,)}

Caches hold ``{"blocks": [{"k", "v"}, ...]}`` per layer: dense
(B, S, KV, D) buffers for chunked prefill (plus an int ``"index"``), or
(groups, group_tokens, KV, D) pools under the paged layout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Union

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (dtype_of, normal_init, ones_init,
                                       resolve_device, rms_norm)

__all__ = ["Model"]


def _apply_block_decode(p: Dict[str, Any], x: torch.Tensor,
                        cache: Dict[str, torch.Tensor], ctx: Dict[str, Any],
                        cfg: ModelConfig) -> torch.Tensor:
    """One ``attn`` block with cache update (in place)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, _ = attn_mod.self_attention(
        p["attn"], h, cfg=cfg, positions=ctx["positions"], cache=cache,
        cache_index=ctx["index"], page_table=ctx.get("page_table"))
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_mod.mlp(p["mlp"], h, cfg)


def _stack_decode(blocks_params: List[Dict[str, Any]],
                  blocks_cache: List[Dict[str, torch.Tensor]],
                  x: torch.Tensor, ctx: Dict[str, Any],
                  cfg: ModelConfig) -> torch.Tensor:
    for p, c in zip(blocks_params, blocks_cache):
        x = _apply_block_decode(p, x, c, ctx, cfg)
    return x


class Model:
    """Functions of a ModelConfig over an explicit parameter dict.

    ``device`` is where ``init`` and the cache constructors place their
    tensors; the default ``"cuda"`` raises without a card.
    """

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        if any(kind != "attn" for kind in cfg.superblock):
            raise NotImplementedError(
                f"superblock {cfg.superblock}: only 'attn' blocks are "
                "ported (ROADMAP queue 1, item 7)")
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                "untied embeddings are not ported (ROADMAP queue 1, item 7)")
        self.cfg = cfg
        self.device = resolve_device(device)
        # fail at construction on a config the MLP cannot run
        mlp_mod.mlp_defs(cfg)

    # --- parameters -----------------------------------------------------
    def init(self, seed: int) -> Dict[str, Any]:
        """Random weights drawn from ``torch.Generator(device).manual_seed
        (seed)``, made directly on ``self.device``."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        pdt = dtype_of(cfg.param_dtype)
        d = cfg.d_model

        def make(defs):
            return {name: init(gen, shape, pdt, dev)
                    for name, (shape, init) in defs.items()}

        def norm():
            return ones_init()(gen, (d,), torch.float32, dev)

        blocks = [{"ln1": norm(), "attn": make(attn_mod.attention_defs(cfg)),
                   "ln2": norm(), "mlp": make(mlp_mod.mlp_defs(cfg))}
                  for _ in range(cfg.n_layers)]
        return {
            "embed": normal_init(0.02)(gen, (cfg.padded_vocab, d), pdt, dev),
            "blocks": blocks,
            "final_norm": norm(),
        }

    # --- embedding / head -------------------------------------------------
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        cdt = dtype_of(self.cfg.compute_dtype)
        x = params["embed"][tokens.long()].to(cdt)
        # the scale rounded to the compute dtype, as the reference has it,
        # and kept a host scalar (a device tensor would cost a copy a step)
        scale = torch.tensor(math.sqrt(self.cfg.d_model), dtype=cdt).item()
        return x * scale

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cdt = dtype_of(self.cfg.compute_dtype)
        return x.to(cdt) @ params["embed"].to(cdt).T  # tied (V, d)

    # --- chunked prefill --------------------------------------------------
    def prefill_chunk(self, params, batch, cache):
        """Append one prompt segment to dense KV caches (chunked prefill).

        ``batch["tokens"]``: (B, C), the next C prompt tokens;
        ``cache["index"]`` (an int) tokens are already resident.  Returns
        (last-token logits, cache) with the cache updated in place and its
        index advanced by C.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        C = tokens.shape[1]
        index = int(cache["index"])
        x = self._embed(params, tokens)
        ctx = {"positions": index + torch.arange(C, device=x.device),
               "index": index}
        x = _stack_decode(params["blocks"], cache["blocks"], x, ctx, cfg)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x[:, -1:, :])
        cache["index"] = index + C
        return logits, cache

    # --- continuous batching ----------------------------------------------
    def init_paged_cache(self, n_groups: int, group_tokens: int):
        """KV pools for the paged layout: ``{"blocks": [...]}`` with
        (n_groups, group_tokens, KV, D) pools per layer.  The page table
        and per-slot lengths live with the engine; group 0 is the
        allocator's scratch group (idle decode lanes write there)."""
        cfg = self.cfg
        shape = (n_groups, group_tokens, cfg.n_kv_heads, cfg.head_dim_)
        dt = dtype_of(cfg.compute_dtype)
        return {"blocks": [
            {"k": torch.zeros(shape, dtype=dt, device=self.device),
             "v": torch.zeros(shape, dtype=dt, device=self.device)}
            for _ in range(cfg.n_layers)]}

    def decode_step_multi(self, params, tokens, cache, lengths,
                          page_table):
        """Continuous-batching decode: one token per slot, each slot at its
        OWN cache length, through the paged pools.

        ``tokens``: (B, 1); ``lengths``: (B,) int32 tokens already resident
        per slot; ``page_table``: (B, MAXG) int32.  Idle slots are decoded
        too (their page rows point at the scratch group and the engine
        discards their outputs).  Returns (logits (B, 1, V_pad), cache).
        """
        cfg = self.cfg
        C = tokens.shape[1]
        if C != 1:
            raise NotImplementedError(
                "multi-column decode (speculative verify) is not ported "
                "(ROADMAP queue 1, item 3)")
        x = self._embed(params, tokens)
        ctx = {"positions": lengths.long()[:, None]
               + torch.arange(C, device=x.device)[None],
               "index": lengths,
               "page_table": page_table}
        x = _stack_decode(params["blocks"], cache["blocks"], x, ctx, cfg)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), cache

    def prefill_chunk_slot_paged(self, params, batch, cache, page_row,
                                 length: int):
        """Paged-layout slot prefill: gather, exact chunk, scatter back.

        The slot's groups are gathered through ``page_row`` (its page-table
        row, (MAXG,) int32) into a dense single-request view, the ordinary
        ``prefill_chunk`` runs on that view, and the C freshly appended
        positions are scattered back into the pools.  The view holds only
        the groups the chunk can attend to (positions below length + C);
        the reference gathers the whole row, whose tail its mask zeroes
        out, so both compute the same attention.
        """
        C = batch["tokens"].shape[1]
        T = cache["blocks"][0]["k"].shape[1]
        rows = page_row[:-(-(length + C) // T)].long()
        view = {"blocks": [
            {name: pool[rows].reshape(1, -1, *pool.shape[2:])
             for name, pool in layer.items()}
            for layer in cache["blocks"]],
            "index": length}
        logits, view = self.prefill_chunk(params, batch, view)
        pos = length + torch.arange(C, device=page_row.device)
        gid = page_row[pos // T].long()
        off = pos % T
        for layer, vlayer in zip(cache["blocks"], view["blocks"]):
            for name, pool in layer.items():
                pool[gid, off] = vlayer[name][0, length:length + C].to(
                    pool.dtype)
        return logits, cache
