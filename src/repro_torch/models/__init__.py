"""PyTorch model stack: ``attn`` stacks (forward, loss and the serve
paths) and the Mamba2 hybrid (forward and loss)."""
from .transformer import Model, count_params

__all__ = ["Model", "count_params"]
