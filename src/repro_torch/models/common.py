"""Model substrate: device resolution, dtypes, init functions, norms,
rotary embeddings.

Counterpart of ``repro.models.common``.  Parameters are plain dicts of
tensors in the reference's layout (one dict per layer in place of the
reference's stacked layer axis); the init functions draw from an explicit
``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple, Union

import torch

__all__ = [
    "resolve_device",
    "dtype_of",
    "normal_init",
    "fan_in_init",
    "zeros_init",
    "ones_init",
    "rms_norm",
    "rope_freqs",
    "apply_rope",
]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA without a card
    is an error: nothing falls back to the CPU unless the caller says
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init functions: (generator, shape, dtype, device) -> tensor
# ---------------------------------------------------------------------------
InitFn = Callable[[torch.Generator, Tuple[int, ...], torch.dtype,
                   torch.device], torch.Tensor]


def normal_init(std: float) -> InitFn:
    def init(gen, shape, dtype, device):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * std).to(dtype)

    return init


def fan_in_init(axis: int = -2) -> InitFn:
    """Lecun-normal on the fan-in dimension: std = 1/sqrt(fan_in)."""

    def init(gen, shape, dtype, device):
        fan_in = shape[axis] if len(shape) >= 2 else shape[0]
        std = 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * std).to(dtype)

    return init


def zeros_init() -> InitFn:
    return lambda gen, shape, dtype, device: torch.zeros(
        shape, dtype=dtype, device=device)


def ones_init() -> InitFn:
    return lambda gen, shape, dtype, device: torch.ones(
        shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given integer positions: (..., head_dim/2)."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freq = float(theta) ** exponent  # a host scalar: no device copy
    angles = positions.float()[..., None] * freq  # (..., half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> broadcast over batch and heads
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:  # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    x32_1, x32_2 = x1.float(), x2.float()
    r1 = x32_1 * cos - x32_2 * sin
    r2 = x32_2 * cos + x32_1 * sin
    return torch.cat([r1, r2], dim=-1).to(x.dtype)
