"""PyTorch model stack for the serve paths (``attn`` superblocks)."""
from .transformer import Model

__all__ = ["Model"]
