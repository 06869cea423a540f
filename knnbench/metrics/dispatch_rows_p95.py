"""The 95th percentile of the query rows a batcher dispatch carried in the
window: the large dispatches that set an open loop's latency tail (a
dispatch padded past the scan's query block takes far longer)."""
from knnbench.stats import percentile


def read(rec):
    return percentile(rec.searches, 95) if rec.dispatches else None
