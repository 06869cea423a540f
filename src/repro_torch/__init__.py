"""repro_torch — the PyTorch + CUDA port of the exact kNN search engine.

A second package beside the JAX reference ``repro``: the same engine,
planner, executors and request API on torch tensors, with the fused
distance + top-k queue kernel written by hand in CUDA C++ for Hopper
(``sm_90a``, ``kernels/csrc``). It never imports JAX or ``repro``.

    from repro_torch import ExactKNN, SearchRequest
    eng = ExactKNN(k=10, backend="cuda").fit(x)        # runs on the card
    res = eng.search(SearchRequest(queries=q))

Backends: ``"cuda"`` (the kernel) and ``"torch"`` (plain tensor ops).
Entry points run on a CUDA device unless the caller passes
``device="cpu"``.
"""
from repro_torch.api.types import SearchRequest, SearchResult
from repro_torch.core.engine import ExactKNN

__all__ = ["ExactKNN", "SearchRequest", "SearchResult"]
