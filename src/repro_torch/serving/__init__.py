"""Online serving: the adaptive FD-SQ/FQ-SD retrieval scheduler and LM decode.

The retrieval scheduler speaks the request-first API (``repro_torch.api``):
streams of ``SearchRequest`` in, per-request ``SearchResult`` out.
``Request``/``Result`` are deprecated compatibility names. ``DecodeServer``
serves an LM of ``repro_torch.models`` by continuous batching.
"""
from repro_torch.api.types import SearchRequest, SearchResult
from repro_torch.serving.retrieval import (
    AdaptiveScheduler,
    Request,
    Result,
    RetrievalServer,
    bursty_requests,
)
from repro_torch.serving.lm import DecodeServer

__all__ = [
    "AdaptiveScheduler", "RetrievalServer",
    "SearchRequest", "SearchResult",
    "Request", "Result",
    "DecodeServer", "bursty_requests",
]
