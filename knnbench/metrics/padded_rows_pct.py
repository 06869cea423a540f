"""The share of the query rows the scheduler's dispatches scanned in the
traced window that were padding: the program's counters
``scheduler.padded_rows`` over ``scheduler.rows`` + ``scheduler.padded_rows``
(a dispatch of b rows is padded to the next power of two), in %."""
from knnbench import program_spans


def read(rec):
    rows = program_spans.counter("scheduler.rows")
    if not rows:
        return None
    pad = program_spans.counter("scheduler.padded_rows") or 0
    return 100.0 * pad / (rows + pad)
