"""Weights from the reference: the ``repro`` parameter pytree, given as
numpy arrays, as this package's parameter dict on a device.

The reference stacks every block parameter along a leading layer axis
(one scan over superblocks); this package keeps one dict per layer.  The
bridge unstacks that axis (layer ``sb * len(superblock) + i`` is entry
``sb`` of block key ``f"{i}_{kind}"``; a ``shared`` block's entry is
empty, its weights are the top-level ``"shared"`` tree, which is not
stacked) and converts bfloat16 arrays bit for bit (f32 leaves such as
Mamba2's ``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` stay f32), so
parity tests start both sides from the same weights.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.configs import ModelConfig

__all__ = ["params_from_numpy"]


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":  # numpy has no bf16: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _unstack(tree, i: int, device):
    if isinstance(tree, dict):
        return {k: _unstack(v, i, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree)[i], device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device: Union[str, torch.device]) -> Dict[str, Any]:
    """``repro.models.Model.init`` output (leaves as numpy arrays) ->
    ``repro_torch.models.Model`` parameters on ``device``."""
    device = torch.device(device)
    expected = {"embed", "blocks", "final_norm"}
    if "shared" in cfg.superblock:
        expected.add("shared")
    if set(tree) != expected:
        raise ValueError(f"parameter tree keys {sorted(tree)} != "
                         f"{sorted(expected)} (only tied attn, mamba2 and "
                         "shared stacks are ported)")
    blocks = []
    for sb in range(cfg.n_superblocks):
        for i, kind in enumerate(cfg.superblock):
            blocks.append(_unstack(tree["blocks"][f"{i}_{kind}"], sb, device))
    params = {"embed": _tensor(tree["embed"], device),
              "blocks": blocks,
              "final_norm": _tensor(tree["final_norm"], device)}
    if "shared" in expected:
        params["shared"] = _convert(tree["shared"], device)
    return params
