"""repro_torch.store — the dataset layer (in-memory single shard)."""
from repro_torch.store.store import DatasetStore

__all__ = ["DatasetStore"]
