"""Model assembly: embeddings, the block stack, tied logits, the
full-sequence forward and LM loss, whole-prompt and chunked prefill, and
decode over dense or paged KV caches.

Counterpart of ``repro.models.transformer`` for stacks of ``attn``,
``mamba2`` and ``shared`` blocks (Gemma-7B; Zamba2-1.2B's
``9×mamba2 + shared + 9×mamba2`` superblock).  The reference scans over
parameters stacked along a leading layer axis; PyTorch runs eagerly, so
here the layers are a plain list of per-layer dicts (layer
``sb * len(superblock) + i`` has kind ``superblock[i]``) and the stack
is a Python loop.  ``models.bridge`` turns the reference's stacked
pytree into this layout.

Parameters::

    {"embed": (V_pad, d),
     "blocks": [{"ln1": (d,), "attn": {"wq", "wk", "wv", "wo"},
                 "ln2": (d,), "mlp": {"wi", ["wg",] "wo"}}      # attn
                or {"ln1": (d,), "mixer": {...}}                # mamba2
                or {}, ...],                                    # shared
     "final_norm": (d,),
     ["shared": {"ln1", "attn", "ln2", "mlp"}]}  # the one shared block

Caches hold ``{"blocks": [...], "index": int}`` with one dict a layer:
dense (B, max_seq, KV, D) ``"k"``/``"v"`` buffers for ``attn`` layers
and each ``shared`` invocation, the conv tail and f32 SSM state
(``"conv"``, ``"state"``) for ``mamba2`` layers (``init_cache``); or,
under the paged layout, (groups, group_tokens, KV, D) pools for
attention stacks (``init_paged_cache``).  Caches are updated in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_rope, dtype_of, normal_init,
                                       ones_init, resolve_device, rms_norm,
                                       rope_freqs)
from repro_torch.models.gla import chunked_gla

__all__ = ["Model", "count_params"]

KINDS = ("attn", "mamba2", "shared")


def cache_block_defs(cfg: ModelConfig, kind: str, batch: int,
                     max_seq: int) -> Dict[str, Any]:
    """{name: (shape, dtype)} of one layer's serve cache: dense K/V
    buffers for an attention layer (each ``shared`` invocation has its
    own), the conv tail and SSM state for a Mamba2 layer."""
    if kind in ("attn", "shared"):
        return attn_mod.init_attn_cache_defs(cfg, batch, max_seq)
    if kind == "mamba2":
        return ssm_mod.mamba2_cache_defs(cfg, batch)
    raise ValueError(f"unknown block kind {kind!r}")


def paged_cache_block_defs(cfg: ModelConfig, kind: str, n_groups: int,
                           group_tokens: int) -> Dict[str, Any]:
    """{name: (shape, dtype)} of one layer's KV pools under the paged
    layout.  Only dense-cache attention kinds are pageable
    (``Model.supports_continuous_batching`` gates the rest to the wave
    runtime)."""
    if kind in ("attn", "shared"):
        shape = (n_groups, group_tokens, cfg.n_kv_heads, cfg.head_dim_)
        dt = dtype_of(cfg.compute_dtype)
        return {"k": (shape, dt), "v": (shape, dt)}
    raise ValueError(f"block kind {kind!r} has no paged cache layout")


def _apply_block_full(kind: str, p: Dict[str, Any], x: torch.Tensor,
                      ctx: Dict[str, Any], cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence (train / prefill-without-cache) application."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "shared":
        p = ctx["shared_params"]
        kind = "attn"
    if kind == "attn":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, _ = attn_mod.self_attention(p["attn"], h, cfg=cfg,
                                       positions=ctx["positions"])
        x = x + y
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + mlp_mod.mlp(p["mlp"], h, cfg), aux
    if kind == "mamba2":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        return x + ssm_mod.mamba2_block(p["mixer"], h, cfg), aux
    raise ValueError(f"unknown block kind {kind!r}")


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of matrix products, recompute everything else in the backward pass
    (the counterpart of ``jax.checkpoint_policies.checkpoint_dots``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _MATMUL_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_MATMUL_OPS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _remat_wrap(fn, remat: str):
    """``fn(x) -> (x, aux)`` run under the remat policy: ``"full"``
    recomputes the whole superblock in the backward pass, ``"dots"``
    keeps its matrix products and recomputes the rest (as
    ``jax.checkpoint`` and its ``checkpoint_dots`` policy do around the
    reference's superblock)."""
    if remat == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    if remat == "full":
        return lambda x: checkpoint(fn, x, use_reentrant=False)
    if remat == "dots":
        return lambda x: checkpoint(
            fn, x, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _save_matmuls))
    raise ValueError(f"unknown remat policy {remat!r}")


def _stack_forward(blocks_params: List[Dict[str, Any]], x: torch.Tensor,
                   ctx: Dict[str, Any], cfg: ModelConfig,
                   remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n = len(cfg.superblock)
    for s0 in range(0, len(blocks_params), n):
        def superblock(x, group=blocks_params[s0:s0 + n]):
            a_sb = torch.zeros((), dtype=torch.float32, device=x.device)
            for i, p in enumerate(group):
                x, a = _apply_block_full(cfg.superblock[i], p, x, ctx, cfg)
                a_sb = a_sb + a
            return x, a_sb

        x, a = _remat_wrap(superblock, remat)(x)
        aux = aux + a
    return x, aux


def _apply_block_decode(kind: str, p: Dict[str, Any], x: torch.Tensor,
                        cache: Dict[str, torch.Tensor], ctx: Dict[str, Any],
                        cfg: ModelConfig) -> torch.Tensor:
    """One block over new token(s) with its cache updated in place."""
    if kind == "shared":
        p = ctx["shared_params"]
        kind = "attn"
    if kind == "attn":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, _ = attn_mod.self_attention(
            p["attn"], h, cfg=cfg, positions=ctx["positions"], cache=cache,
            cache_index=ctx["index"], page_table=ctx.get("page_table"))
        x = x + y
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + mlp_mod.mlp(p["mlp"], h, cfg)
    if kind == "mamba2":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, new = ssm_mod.mamba2_decode(p["mixer"], h, cache, cfg)
        cache.update(new)
        return x + y
    raise ValueError(f"unknown block kind {kind!r}")


def _stack_decode(blocks_params: List[Dict[str, Any]],
                  blocks_cache: List[Dict[str, torch.Tensor]],
                  x: torch.Tensor, ctx: Dict[str, Any],
                  cfg: ModelConfig) -> torch.Tensor:
    n = len(cfg.superblock)
    for i, (p, c) in enumerate(zip(blocks_params, blocks_cache)):
        x = _apply_block_decode(cfg.superblock[i % n], p, x, c, ctx, cfg)
    return x


def _write_prefill_kv(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                      v: torch.Tensor, S: int) -> None:
    """Write a prompt's K/V into the head of a dense buffer (in place).
    The reference's ring-rolled write of sliding-window buffers comes
    with ``swa`` (ROADMAP queue 1: other model families)."""
    S_w = min(S, cache["k"].shape[1])
    cache["k"][:, :S_w] = k[:, :S_w].to(cache["k"].dtype)
    cache["v"][:, :S_w] = v[:, :S_w].to(cache["v"].dtype)


def _prefill_recurrent(kind: str, p: Dict[str, Any], x: torch.Tensor,
                       cfg: ModelConfig):
    """A recurrent block over the whole prompt, with the final state that
    decode continues from: (x + block(x), the layer's new cache)."""
    if kind != "mamba2":
        raise ValueError(kind)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, state = _mamba2_with_state(p["mixer"], h, cfg)
    return x + y, state


def _mamba2_with_state(params: Dict[str, torch.Tensor], u: torch.Tensor,
                       cfg: ModelConfig):
    """``ssm.mamba2_block`` that also returns the decode cache: the last
    ``ssm_conv - 1`` conv inputs and the final SSM state.  The scan is the
    plain ``chunked_gla`` whatever ``cfg.gla_impl`` says, as in the
    reference (a quirk kept: ROADMAP queue 3)."""
    B, S, d = u.shape
    d_inner, nh, hd, ds = ssm_mod._dims(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    zxbcdt = u.to(cdt) @ params["in_proj"].to(cdt)
    z, xBC, dt_raw = ssm_mod._split_proj(cfg, zxbcdt)
    xBC_f = xBC.float()
    tail = cfg.ssm_conv - 1
    conv_tail = F.pad(xBC_f, (0, 0, tail, 0))[:, -tail:]
    xBC_c = ssm_mod._causal_conv(xBC_f, params["conv_w"].float(),
                                 params["conv_b"].float())
    x, Bm, Cm, dt, log_g = ssm_mod._ssd_inputs(cfg, params, xBC_c, dt_raw)
    xh = x.reshape(B, S, nh, hd)
    q = Cm[:, :, None, :].expand(B, S, nh, ds)
    k = Bm[:, :, None, :].expand(B, S, nh, ds)
    v = xh * dt[..., None]
    y, state = chunked_gla(q, k, v, log_g, chunk=cfg.ssm_chunk)
    y = y + xh * params["D"].float()[None, None, :, None]
    y = y.reshape(B, S, d_inner)
    y = rms_norm(y, params["norm_scale"], cfg.norm_eps) * F.silu(z.float())
    out = y.to(cdt) @ params["out_proj"].to(cdt)
    return out, {"conv": conv_tail.contiguous(), "state": state}


def count_params(cfg: ModelConfig) -> int:
    """Parameters of the model ``cfg`` describes, counted from the shapes
    ``Model.init`` makes (no tensor is made): the padded embedding, each
    layer's weights and norms, the final norm and the one shared block."""
    def size(defs) -> int:
        return sum(math.prod(shape) for shape, *_ in defs.values())

    d = cfg.d_model
    attn_block = (size(attn_mod.attention_defs(cfg))
                  + size(mlp_mod.mlp_defs(cfg)) + 2 * d)
    per_kind = {"attn": attn_block, "shared": 0,
                "mamba2": (size(ssm_mod.mamba2_defs(cfg)) + d
                           if "mamba2" in cfg.superblock else 0)}
    n = cfg.padded_vocab * d + d
    n += sum(per_kind[cfg.superblock[i % len(cfg.superblock)]]
             for i in range(cfg.n_layers))
    if "shared" in cfg.superblock:
        n += attn_block
    return n


class Model:
    """Functions of a ModelConfig over an explicit parameter dict.

    ``device`` is where ``init`` and the cache constructors place their
    tensors; the default ``"cuda"`` raises without a card.
    """

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        if any(kind not in KINDS for kind in cfg.superblock):
            raise NotImplementedError(
                f"superblock {cfg.superblock}: only {KINDS} blocks are "
                "ported (ROADMAP queue 1: other model families)")
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                "untied embeddings are not ported (ROADMAP queue 1: other "
                "model families)")
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
            # (shape, init) in the param dtype, or (shape, init, dtype)
            return {name: init(gen, shape, (dt and dt[0]) or pdt, dev)
                    for name, (shape, init, *dt) in defs.items()}

        def norm():
            return ones_init()(gen, (d,), torch.float32, dev)

        def attn_block():
            return {"ln1": norm(), "attn": make(attn_mod.attention_defs(cfg)),
                    "ln2": norm(), "mlp": make(mlp_mod.mlp_defs(cfg))}

        blocks = []
        for i in range(cfg.n_layers):
            kind = cfg.superblock[i % len(cfg.superblock)]
            if kind == "attn":
                blocks.append(attn_block())
            elif kind == "mamba2":
                blocks.append({"ln1": norm(),
                               "mixer": make(ssm_mod.mamba2_defs(cfg))})
            else:  # shared: the weights live at the top level
                blocks.append({})
        params = {
            "embed": normal_init(0.02)(gen, (cfg.padded_vocab, d), pdt, dev),
            "blocks": blocks,
            "final_norm": norm(),
        }
        if "shared" in cfg.superblock:
            params["shared"] = attn_block()
        return params

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

    # --- full-sequence forward (train) -----------------------------------
    def forward(self, params, batch, *, remat: str = "none"):
        """batch: tokens (B, S) -> (hidden (B, S, d) after the final norm,
        aux_loss)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = self._embed(params, tokens)
        ctx = {"positions": torch.arange(S, device=x.device),
               "shared_params": params.get("shared")}
        x, aux = _stack_forward(params["blocks"], x, ctx, cfg, remat=remat)
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    def loss(self, params, batch, *, remat: str = "none",
             loss_chunk: int = 0, aux_weight: float = 0.01):
        """Causal LM loss over the true vocabulary (padded logits masked to
        -1e30).  ``loss_chunk > 0`` computes the cross-entropy in sequence
        chunks, so the full (B, S, V) logits never materialize.  Returns
        (total, {"loss", "aux_loss", "accuracy", "tokens"})."""
        cfg = self.cfg
        x, aux = self.forward(params, batch, remat=remat)
        labels = batch["labels"].long()
        mask = batch.get("loss_mask")
        mask = ((labels >= 0).float() if mask is None else mask.float())
        labels = labels.clamp(min=0)
        vocab_valid = (torch.arange(cfg.padded_vocab, device=x.device)
                       < cfg.vocab_size)

        def chunk_loss(x_c, labels_c, mask_c):
            logits = self._logits(params, x_c)
            logits = logits.masked_fill(~vocab_valid, -1e30)
            lg = logits.float()
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, labels_c[..., None])[..., 0]
            nll = (logz - gold) * mask_c
            acc = (lg.argmax(-1) == labels_c).float() * mask_c
            return nll.sum(), acc.sum()

        S = x.shape[1]
        if loss_chunk and S > loss_chunk and S % loss_chunk == 0:
            nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
            acc_sum = torch.zeros((), dtype=torch.float32, device=x.device)
            for c0 in range(0, S, loss_chunk):
                sl = slice(c0, c0 + loss_chunk)
                nll, acc = chunk_loss(x[:, sl], labels[:, sl], mask[:, sl])
                nll_sum = nll_sum + nll
                acc_sum = acc_sum + acc
        else:
            nll_sum, acc_sum = chunk_loss(x, labels, mask)
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = nll_sum / denom
        total = loss + aux_weight * aux
        return total, {"loss": loss, "aux_loss": aux,
                       "accuracy": acc_sum / denom, "tokens": denom}

    # --- serving ----------------------------------------------------------
    def _make_cache(self, defs_of) -> Dict[str, Any]:
        n = len(self.cfg.superblock)
        return {"blocks": [
            {name: torch.zeros(shape, dtype=dt, device=self.device)
             for name, (shape, dt) in defs_of(
                 self.cfg.superblock[i % n]).items()}
            for i in range(self.cfg.n_layers)]}

    def init_cache(self, batch: int, max_seq: int) -> Dict[str, Any]:
        """Dense serve caches for ``batch`` rows of ``max_seq`` tokens:
        ``{"blocks": [...], "index": 0}`` (``cache_block_defs`` a layer)."""
        cache = self._make_cache(lambda kind: cache_block_defs(
            self.cfg, kind, batch, max_seq))
        cache["index"] = 0
        return cache

    def prefill(self, params, batch, cache):
        """Run the whole prompt through the model, filling the caches.

        ``batch["tokens"]``: (B, S).  Attention runs in full-sequence mode
        through ``attend`` with ``cfg.attn_impl`` (``"pallas"``: the
        flash-attention kernel) and its K/V land in the dense buffers;
        Mamba2 layers run the full sequence and keep their final state.
        Returns (last-token logits, cache) with the cache updated in place
        and its index set to S.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        cos, sin = rope_freqs(torch.arange(S, device=x.device),
                              cfg.head_dim_, cfg.rope_theta)
        n = len(cfg.superblock)
        for i, (p, c) in enumerate(zip(params["blocks"], cache["blocks"])):
            kind = cfg.superblock[i % n]
            if kind == "shared":
                p = params["shared"]
            if kind == "mamba2":
                x, state = _prefill_recurrent(kind, p, x, cfg)
                c.update(state)
                continue
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = attn_mod._project_qkv(p["attn"], h, cfg)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            y = attn_mod.attend(q, k, v, cfg=cfg, causal=True, window=0)
            x = x + attn_mod.out_proj(p["attn"], y, cfg)
            _write_prefill_kv(c, k, v, S)
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp_mod.mlp(p["mlp"], h, cfg)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x[:, -1:, :])
        cache["index"] = S
        return logits, cache

    @property
    def supports_chunked_prefill(self) -> bool:
        """Whether a prompt can be prefilled in segments through the
        cache: exact for dense-cache attention blocks.  Recurrent mixers
        (mamba2) recompute their state from the full sequence and prefill
        whole prompts instead.  (The reference also admits moe, dec and
        cross, MoE only at drop-free router capacity; those kinds are not
        ported.)"""
        return set(self.cfg.superblock) <= {"attn", "shared"}

    @property
    def supports_continuous_batching(self) -> bool:
        """Continuous batching prefills admitted requests through the
        chunked-append path, so it is exact for precisely the stacks
        chunked prefill is exact for; the rest keep the wave loop."""
        return self.supports_chunked_prefill

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
               "index": index, "shared_params": params.get("shared")}
        x = _stack_decode(params["blocks"], cache["blocks"], x, ctx, cfg)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x[:, -1:, :])
        cache["index"] = index + C
        return logits, cache

    def decode_step(self, params, tokens, cache):
        """One decode step of the wave runtime: tokens (B, 1) at position
        ``cache["index"]`` -> (logits (B, 1, V_pad), cache), the cache
        updated in place and its index advanced by one: a one-token
        chunk."""
        return self.prefill_chunk(params, {"tokens": tokens}, cache)

    # --- continuous batching ----------------------------------------------
    def init_paged_cache(self, n_groups: int, group_tokens: int):
        """KV pools for the paged layout: ``{"blocks": [...]}`` with
        (n_groups, group_tokens, KV, D) pools per layer.  The page table
        and per-slot lengths live with the engine; group 0 is the
        allocator's scratch group (idle decode lanes write there).  A
        stack with a recurrent layer has no paged layout (ValueError)."""
        return self._make_cache(lambda kind: paged_cache_block_defs(
            self.cfg, kind, n_groups, group_tokens))

    def decode_step_multi(self, params, tokens, cache, lengths,
                          page_table=None):
        """Continuous-batching decode: C token(s) per slot, each slot at
        its OWN cache length.

        ``tokens``: (B, C); ``lengths``: (B,) int32 tokens already
        resident per slot.  Dense layout (``page_table=None``): the
        blocks are per-slot (B, max_seq, KV, D) buffers, appended by
        scatter, attended densely.  Paged layout: the blocks are pools and
        ``page_table`` (B, MAXG) int32 maps each slot's logical groups to
        physical ones; C == 1 is the paged decode kernel.  C > 1 is the
        speculative-verify dispatch: column i of slot b sits at position
        ``lengths[b] + i`` and the causal per-slot masks make each
        column's logits what C successive single-token steps would give.
        Idle slots are decoded too (the engine discards their outputs).
        Returns (logits (B, C, V_pad), cache).
        """
        cfg = self.cfg
        C = tokens.shape[1]
        x = self._embed(params, tokens)
        ctx = {"positions": lengths.long()[:, None]
               + torch.arange(C, device=x.device)[None],
               "index": lengths,
               "shared_params": params.get("shared"),
               "page_table": page_table}
        x = _stack_decode(params["blocks"], cache["blocks"], x, ctx, cfg)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x), cache

    def prefill_chunk_slot(self, params, batch, cache, slot: int,
                           length: int):
        """Append one prompt chunk for ONE slot of a batched dense cache.

        ``batch["tokens"]``: (1, C).  The slot's rows of every buffer are
        views, so the exact ``prefill_chunk`` path writes them in place
        while the other slots keep their state.  Returns (last-token
        logits, cache).
        """
        view = {"blocks": [{name: t[slot:slot + 1]
                            for name, t in layer.items()}
                           for layer in cache["blocks"]],
                "index": length}
        logits, _ = self.prefill_chunk(params, batch, view)
        return logits, cache

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
