"""The median over all requests of the window of the time from when each was
due until its answer was on the host (host clock); a failed request counts
with the time until the benchmark stopped waiting for it. Also reads
``latency_p50_ms.open``."""
from knnbench.stats import percentile


def read(rec):
    return percentile(rec.latencies_ms, 50)
