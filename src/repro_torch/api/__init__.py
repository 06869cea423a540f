"""repro_torch.api — the request-first public search API."""
from repro_torch.api.types import AUTO_FDSQ_MAX_BATCH, SearchRequest, SearchResult

__all__ = ["SearchRequest", "SearchResult", "AUTO_FDSQ_MAX_BATCH"]
