"""repro_torch.data — seeded synthetic datasets and query streams."""
from repro_torch.data.synthetic import query_stream, vector_dataset

__all__ = ["vector_dataset", "query_stream"]
