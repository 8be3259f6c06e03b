"""Serving: the continuous-batching engine over a paged KV cache
(``engine``), its page-group allocator (``paging``) and its admission
scheduler (``scheduler``)."""
from .engine import (GenerationResult, OversubscriptionError, ServeConfig,
                     ServeEngine)

__all__ = ["GenerationResult", "OversubscriptionError", "ServeConfig",
           "ServeEngine"]
