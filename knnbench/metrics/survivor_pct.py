"""The share of the f32 scan's lanes (query rows × dataset rows) that its
survivor filter admitted in the traced window, each admitted batch sorted
and merged into the queues: the program's counters ``scan.survivors`` over
``scan.lanes``, in %. A program without them gives nothing. Reads every
``survivor_pct.<group>``."""
from knnbench import program_spans


def read(rec):
    lanes = program_spans.counter("scan.lanes")
    if not lanes:
        return None
    return 100.0 * (program_spans.counter("scan.survivors") or 0) / lanes
