"""Architecture configs: the ``ModelConfig`` schema, the registry
(``--arch <id>``), the workload ``SHAPES`` and the ``reduced()`` transform
used by CPU tests.

Own copy of ``repro.configs`` cut to what the ported slices read:
decoder-only stacks of ``attn`` blocks (GQA self-attention with RoPE and
a gated or GELU MLP, tied embeddings) and the Mamba2 hybrid (``mamba2``
blocks and invocations of one weight-shared ``shared`` attention+MLP
block, as Zamba2 has them).  Fields of the reference schema that only
other block kinds, sharding or the dry-run read are left out; they come
back with the slices that port those paths.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "get_config",
           "list_configs", "reduced", "register"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    superblock: Tuple[str, ...] = ("attn",)
    activation: str = "swiglu"  # swiglu | geglu | gelu
    rope_theta: float = 10_000.0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    gla_impl: str = "jnp"  # jnp | pallas (the CUDA GLA kernel)
    # numerics
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    # attention implementation: dense | blocked | local | auto | pallas
    # (pallas = the CUDA flash-attention kernel)
    attn_impl: str = "auto"
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    notes: str = ""

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_superblocks(self) -> int:
        if self.n_layers % len(self.superblock):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"superblock of {len(self.superblock)}")
        return self.n_layers // len(self.superblock)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# the reference's workload shapes (``repro.configs.SHAPES``)
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}
_MODULES = ("gemma_7b", "zamba2_1_2b")


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    _load_all()
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, seed_width: int = 64) -> ModelConfig:
    """A tiny same-family config for CPU tests: same superblock pattern,
    2 superblocks, small widths, tiny vocab, f32 (the reference's
    ``reduced`` restricted to this schema's fields)."""
    n_sb = min(2, cfg.n_superblocks)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=len(cfg.superblock) * n_sb,
        d_model=seed_width,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=seed_width * 2 if cfg.d_ff else 0,
        vocab_size=512,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        ssm_chunk=16,
        param_dtype="float32",
        compute_dtype="float32",
        vocab_pad_multiple=64,
        attn_block_q=16,
        attn_block_kv=32,
    )
