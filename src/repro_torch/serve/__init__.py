"""Serving: the continuous-batching engine over a paged KV cache
(``engine``), its page-group allocator (``paging``), its admission
scheduler (``scheduler``) and its knobs as a tuning space with the
co-tuning surrogate and the live system under tune (``space``)."""
from .engine import (GenerationResult, OversubscriptionError, ServeConfig,
                     ServeEngine)

__all__ = ["GenerationResult", "OversubscriptionError", "ServeConfig",
           "ServeEngine"]
