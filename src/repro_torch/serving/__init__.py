"""Online serving: the adaptive FD-SQ/FQ-SD retrieval scheduler.

The retrieval scheduler speaks the request-first API (``repro_torch.api``):
streams of ``SearchRequest`` in, per-request ``SearchResult`` out.
``Request``/``Result`` are deprecated compatibility names. The LM decode
server of the JAX package (``DecodeServer``) is not part of the port yet.
"""
from repro_torch.api.types import SearchRequest, SearchResult
from repro_torch.serving.retrieval import (
    AdaptiveScheduler,
    Request,
    Result,
    RetrievalServer,
    bursty_requests,
)

__all__ = [
    "AdaptiveScheduler", "RetrievalServer",
    "SearchRequest", "SearchResult",
    "Request", "Result",
    "bursty_requests",
]
