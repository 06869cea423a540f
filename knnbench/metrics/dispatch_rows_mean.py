"""Requests answered in the window over the batcher's dispatches in it
(ContinuousBatcher.dispatched_batches, a counter of the program)."""


def read(rec):
    return rec.queries / rec.dispatches if rec.dispatches else None
