"""repro_torch.api — the request-first public search API.

    SearchRequest   one search call, fully described (queries, k, metric,
                    tier, mode_hint, deadline_ms, filter_mask, rid)
    SearchResult    one answer: TopK + exactness certificate + plan/kernel
                    stats
    Router          named multi-collection serving front: collection name ->
                    DatasetStore-backed engine, shared bounded executable
                    cache, per-collection stats

Entry points: ``ExactKNN.search(SearchRequest)`` for one engine,
``Router.search(name, SearchRequest)`` across collections, and
``serving.AdaptiveScheduler`` for policy-scheduled streams of requests.
``AUTO_FDSQ_MAX_BATCH`` stays importable from ``repro_torch.api.types``.
"""
from repro_torch.api.router import Router
from repro_torch.api.types import SearchRequest, SearchResult

__all__ = ("SearchRequest", "SearchResult", "Router")
