"""Train-step knobs as an ACTS ``ParameterSpace``.

Counterpart of ``repro.train.space``: the subset of ``RunKnobs`` the live
co-tuning composite's "train" member sweeps (microbatch count, remat
policy, the attention block pair, gradient compression).  As in the
reference, the ``attn_block_*`` knobs are inert on the measured step:
``make_train_step`` never reads them (``Model.loss`` tiles attention by
the model config), so they only widen the space.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.params import Config, EnumParam, ParameterSpace

__all__ = ["train_knob_space", "apply_train_knobs"]


def train_knob_space(max_microbatches: int = 8) -> ParameterSpace:
    """The measured train step's tunable knobs (``RunKnobs`` fields).

    ``max_microbatches`` is the workload's global batch: microbatch counts
    must divide it, so only dividing powers of two up to it are offered.
    ``attn_block_* = 0`` keeps the model-config default.
    """
    mb_choices = tuple(m for m in (1, 2, 4, 8, 16)
                       if m <= max_microbatches and max_microbatches % m == 0)
    return ParameterSpace([
        # gradient-accumulation split of the global batch
        EnumParam("microbatches", mb_choices, 1),
        # activation rematerialization policy
        EnumParam("remat", ("none", "full", "dots"), "none"),
        # flash-attention tiling pair (0 = ModelConfig default; inert)
        EnumParam("attn_block_q", (0, 128, 256, 512), 0),
        EnumParam("attn_block_kv", (0, 256, 512, 1024), 0),
        # optimizer gradient compression (error-feedback variants)
        EnumParam("compression", ("none", "int8", "topk"), "none"),
    ])


def apply_train_knobs(config: Config, base: Optional[Any] = None):
    """Tuned train knobs -> a ``RunKnobs``.  ``base`` supplies the
    non-tuned fields; it defaults to data-parallel single-host knobs, the
    measured-SUT setting."""
    import dataclasses

    from repro_torch.train.step import RunKnobs

    base = base or RunKnobs(rules_preset="dp")
    return dataclasses.replace(
        base,
        microbatches=int(config["microbatches"]),
        remat=str(config["remat"]),
        attn_block_q=int(config["attn_block_q"]),
        attn_block_kv=int(config["attn_block_kv"]),
        compression=str(config["compression"]),
    )
