"""repro_torch.data — seeded synthetic data and the double-buffered input pipeline."""
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import click_log_stream, query_stream, token_stream, vector_dataset

__all__ = [
    "token_stream", "click_log_stream", "vector_dataset", "query_stream",
    "DataPipeline",
]
