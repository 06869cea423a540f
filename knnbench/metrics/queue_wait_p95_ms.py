"""The 95th percentile (nearest rank) of a request's wait in the batcher's
queue in the traced window: the program's ``batcher.wait`` spans, from
``ContinuousBatcher.submit`` until the worker thread starts the dispatch
that serves the request. Reads every ``queue_wait_p95_ms.<group>``."""
from knnbench import program_spans
from knnbench.stats import percentile


def read(rec):
    return percentile(program_spans.durations_ms("batcher.wait"), 95)
