"""The 95th percentile of the same latencies as latency_p50_ms. Also reads
``latency_p95_ms.open_traced``, the open cell's tail, per layer."""
from knnbench.stats import percentile


def read(rec):
    return percentile(rec.latencies_ms, 95)
