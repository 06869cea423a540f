"""Async network front end: multi-tenant serving over
:class:`repro_torch.api.Router` on the card's kernels.

Stdlib asyncio streams + a minimal HTTP/1.1 + WebSocket codec, numpy and
torch: no web framework. The stack, top to bottom:

- :mod:`repro_torch.server.app` — :class:`KnnServer`: endpoints, routing,
  the degradation ladder (4xx parse -> 429 admission -> 503 queue timeout
  -> shed envelope -> circuit breaker), one shared dispatch worker thread.
- :mod:`repro_torch.server.admission` — per-tenant sliding-window rate
  limits, inflight quotas, deadline-aware admission.
- :mod:`repro_torch.server.batching` — continuous (iteration-level)
  batching feeding :class:`repro_torch.serving.AdaptiveScheduler` on the
  worker thread.
- :mod:`repro_torch.server.protocol` — wire codec: HTTP parsing, JSON ->
  frozen :class:`repro_torch.api.types.SearchRequest` validation,
  WebSocket frames; answers encoded from CPU tensors only.
- :mod:`repro_torch.server.loadgen` — closed-/open-loop load generator and
  the acceptance soak (``python -m repro_torch.server.loadgen --selfhost``).

The port's copy of ``repro.server``, with the same ``__all__``.
"""
from repro_torch.server.admission import AdmissionController, Verdict
from repro_torch.server.app import KnnServer
from repro_torch.server.batching import ContinuousBatcher, ServerClosed
from repro_torch.server.protocol import (
    BadRequest,
    PayloadTooLarge,
    ProtocolError,
    encode_result,
    parse_search_request,
)

__all__ = [
    "AdmissionController",
    "BadRequest",
    "ContinuousBatcher",
    "KnnServer",
    "PayloadTooLarge",
    "ProtocolError",
    "ServerClosed",
    "Verdict",
    "encode_result",
    "parse_search_request",
]
