"""The train step and its execution knobs.

Counterpart of ``repro.train.step``.  ``RunKnobs`` keeps every field and
default of the reference's (remat policy, microbatch count, loss
chunking, gradient compression, the sharding and attention overrides);
``make_train_step`` builds ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: ``Model.loss`` under autograd, the
microbatches as a loop with f32 gradient accumulation, then compression,
global-norm clipping and AdamW.  The step runs the plain attention paths
under autograd, as the reference's does (``attn_impl="auto"`` never
reaches the flash kernel, which has no backward pass in either package).

Knobs that only act on a mesh (``rules_preset`` and the sharding flags)
or on block kinds the port does not run (``moe_group``) are carried but
not read; ``axis_rules`` raises (ROADMAP queue 1: multi-device).  As in
the reference, ``attn_impl``, ``attn_block_*``, ``scan_unroll``,
``donate`` and ``kernel_autotune`` are not read by the step either.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.models import Model
from repro_torch.optim import (OptimizerConfig, adamw_init, adamw_update,
                               clip_by_global_norm, compress_grads,
                               compression_init, tree_leaves, tree_map)

__all__ = ["RunKnobs", "make_train_step", "init_train_state"]


@dataclass(frozen=True)
class RunKnobs:
    rules_preset: str = "fsdp_tp"  # dp | tp | fsdp_tp (sharding-rule preset)
    remat: str = "full"  # none | full | dots
    microbatches: int = 4
    loss_chunk: int = 512  # 0 = unchunked cross-entropy
    moe_group: int = 4096
    compression: str = "none"  # none | int8 | topk
    donate: bool = True
    seq_shard: bool = False  # sequence parallelism for long prefill
    sp_residual: bool = False  # Megatron-SP: shard residual stream on seq
    kv_seq_shard: bool = False  # shard decode KV cache along sequence
    expert_tp: bool = False  # TP inside experts (expert_ff -> model)
    pad_heads: bool = False  # pad query heads to a shardable multiple (16)
    head_dim_shard: bool = False  # shard attention on head_dim, not heads
    attn_impl: Optional[str] = None  # override ModelConfig.attn_impl
    attn_block_q: int = 0  # 0 = keep ModelConfig default
    attn_block_kv: int = 0
    scan_unroll: int = 1
    # consult the kernel-autotune cache for attention blocks
    kernel_autotune: bool = False

    def axis_rules(self):
        raise NotImplementedError(
            "RunKnobs.axis_rules: sharding-rule presets need ROADMAP queue "
            "1: multi-device, which is not ported yet")


def _by_weight(tree, n: int):
    """The tree with its per-layer blocks grouped as the reference stacks
    them: one entry per superblock position, each leaf the tuple of that
    weight's per-layer tensors (no copy)."""
    blocks = tree["blocks"]
    return dict(tree, blocks=[
        tree_map(lambda *ls: tuple(ls), blocks[i], *blocks[i + n::n])
        for i in range(n)])


def _per_layer(tree, n: int, n_sb: int):
    """Inverse of ``_by_weight``."""
    grouped = tree["blocks"]
    return dict(tree, blocks=[
        tree_map(lambda t: t[sb], grouped[i])
        for sb in range(n_sb) for i in range(n)])


def init_train_state(model: Model, seed: int, knobs: RunKnobs):
    """Random parameters from ``seed`` on the model's device, and the
    optimizer state (f32 moments, plus the error-feedback state under a
    compression)."""
    params = model.init(seed)
    opt_state = adamw_init(params)
    if knobs.compression != "none":
        opt_state["error"] = compression_init(params, knobs.compression)
    return params, opt_state


def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    knobs: RunKnobs) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  Microbatching runs as a loop with f32 gradient
    accumulation; the returned params are new tensors and the moments are
    updated in place (``adamw_update``).  Compression sees each block
    weight's per-layer gradients as one leaf, as the reference holds its
    parameters stacked along the layer axis, so an int8 scale or a top-k
    threshold covers every layer of one weight."""
    n_kinds = len(model.cfg.superblock)

    def grad_fn(params, mb):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        tracked = tree_map(lambda _: next(it), params)
        total, metrics = model.loss(tracked, mb, remat=knobs.remat,
                                    loss_chunk=knobs.loss_chunk)
        grads = torch.autograd.grad(total, live)
        it = iter(grads)
        return (total.detach(),
                {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(it), params))

    def train_step(params, opt_state, batch):
        k = knobs.microbatches
        if k <= 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % k:  # the reference's reshape(k, b // k, ...) raises
                raise ValueError(f"a batch of {b} rows does not split into "
                                 f"{k} microbatches")
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss, metrics = 0.0, None
            for i in range(k):
                mb = {name: x[i * (b // k):(i + 1) * (b // k)]
                      for name, x in batch.items()}
                l, m, g = grad_fn(params, mb)
                grads = tree_map(lambda a, gi: a + gi.float(), grads, g)
                loss = loss + l
                metrics = m if metrics is None else {
                    name: metrics[name] + m[name] for name in metrics}
            grads = tree_map(lambda g: g / k, grads)
            loss = loss / k
            metrics = {name: v / k for name, v in metrics.items()}

        with torch.no_grad():
            new_opt = dict(opt_state)
            if knobs.compression != "none":
                grads, _ = compress_grads(
                    _by_weight(grads, n_kinds),
                    _by_weight(opt_state["error"], n_kinds),
                    knobs.compression)
                grads = _per_layer(grads, n_kinds, model.cfg.n_superblocks)
            grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
            core_state = {k2: new_opt[k2] for k2 in ("mu", "nu", "step")}
            new_params, core_state, lr = adamw_update(grads, core_state,
                                                      params, opt_cfg)
            new_opt.update(core_state)
        metrics = dict(metrics, grad_norm=gnorm, learning_rate=lr,
                       total_loss=loss)
        return new_params, new_opt, metrics

    return train_step
