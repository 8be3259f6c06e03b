"""Gradient compression with error feedback.

Counterpart of ``repro.optim.compression``.  Two schemes, both with
per-leaf f32 error-feedback accumulators so the bias is corrected over
steps (Karimireddy et al., "EF-SGD"):

* ``int8``  — per-tensor symmetric linear quantization,
* ``topk``  — keep the largest-|g| fraction, zero the rest.

A leaf is one tensor, or a tuple of tensors that count as one: the
per-layer slices of a weight the reference holds stacked along the layer
axis (``repro_torch.train.step`` groups them so), which share one int8
scale or one top-k threshold, as the stacked tensor does in the
reference.  The train step quantizes (grad + error), dequantizes for the
update and carries the residual; on one device no collective carries the
compressed form, so what the knob changes is the numerics (and the work
it adds).  The error state is updated in place (the reference returns
new arrays): at full width a second copy would not fit.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from .adamw import tree_map

__all__ = ["compression_init", "compress_grads", "COMPRESSIONS"]

COMPRESSIONS = ("none", "int8", "topk")


def compression_init(params, scheme: str):
    if scheme == "none":
        return None
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _int8_roundtrip(g32: Sequence[torch.Tensor]) -> list:
    scale = max(torch.max(torch.abs(g)) for g in g32) / 127.0 + 1e-30
    return [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            .to(torch.float32) * scale for g in g32]


def _topk_roundtrip(g32: Sequence[torch.Tensor], frac: float) -> list:
    flat = torch.cat([torch.abs(g).reshape(-1) for g in g32])
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat, k).values[-1]
    del flat
    zero = torch.zeros((), dtype=torch.float32, device=g32[0].device)
    return [torch.where(torch.abs(g) >= thresh, g, zero) for g in g32]


def compress_grads(
    grads, error: Optional[Any], scheme: str, topk_frac: float = 0.05
) -> Tuple[Any, Optional[Any]]:
    """Returns (decompressed grads to apply, the error-feedback state,
    updated in place)."""
    if scheme == "none":
        return grads, error

    def one(g, e):
        gs, es = (g, e) if isinstance(g, tuple) else ((g,), (e,))
        g32 = [gi.to(torch.float32) + ei for gi, ei in zip(gs, es)]
        if scheme == "int8":
            out = _int8_roundtrip(g32)
        elif scheme == "topk":
            out = _topk_roundtrip(g32, topk_frac)
        else:
            raise ValueError(f"unknown compression {scheme!r}")
        for ei, gi32, oi in zip(es, g32, out):
            torch.sub(gi32, oi, out=ei)
        dec = tuple(oi.to(gi.dtype) for oi, gi in zip(out, gs))
        return dec if isinstance(g, tuple) else dec[0]

    return tree_map(one, grads, error), error
