"""Seeded synthetic data (numpy), for training, the tests and the card check.

Real corpora are unavailable offline; these generators reproduce the
structure the system cares about — shapes, dtypes, id distributions,
cluster structure with many near-ties — deterministically from a seed,
with the reference's draws (``repro.data.synthetic``).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def token_stream(
    vocab: int, batch: int, seq_len: int, seed: int = 0,
    zipf_a: float = 1.2,
) -> Iterator[dict]:
    """Endless LM batches with a Zipfian token distribution (real-text-like
    marginals, so embedding-gather traffic patterns are realistic)."""
    rng = np.random.default_rng(seed)
    while True:
        z = rng.zipf(zipf_a, size=(batch, seq_len + 1))
        tokens = np.minimum(z - 1, vocab - 1).astype(np.int32)
        yield {"tokens": tokens}


def click_log_stream(
    table_sizes: tuple[int, ...], n_dense: int, batch: int, seed: int = 0,
    ctr: float = 0.25,
) -> Iterator[dict]:
    """Recsys impressions: Zipfian categorical ids, log-normal dense
    features, label with a planted logistic signal on feature 0."""
    rng = np.random.default_rng(seed)
    while True:
        dense = rng.lognormal(0.0, 1.0, size=(batch, n_dense)).astype(np.float32)
        cols = []
        for size in table_sizes:
            z = rng.zipf(1.1, size=(batch, 1))
            cols.append(np.minimum(z - 1, size - 1))
        sparse = np.concatenate(cols, axis=1).astype(np.int32)
        logit = 1.5 * np.tanh(dense[:, 0] - 1.0) + rng.normal(0, 1, batch)
        label = (logit > np.quantile(logit, 1 - ctr)).astype(np.float32)
        yield {"dense": dense, "sparse": sparse, "label": label}


def vector_dataset(
    n: int, d: int, n_clusters: int = 64, seed: int = 0, dtype=np.float32
) -> np.ndarray:
    """Clustered vectors (GIST/MSMARCO-like local structure): kNN results
    are dominated by intra-cluster neighbours, so the queue sees realistic
    score distributions (many near-ties)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(dtype) * 2.0
    assign = rng.integers(0, n_clusters, n)
    x = centers[assign] + rng.standard_normal((n, d)).astype(dtype) * 0.5
    return x.astype(dtype)


def query_stream(
    dataset: np.ndarray, n_queries: int, seed: int = 0, noise: float = 0.3
) -> np.ndarray:
    """Queries near dataset points (in-distribution, as the paper's use
    cases query)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dataset.shape[0], n_queries)
    q = dataset[idx] + rng.standard_normal((n_queries, dataset.shape[1])) * noise
    return q.astype(dataset.dtype)
