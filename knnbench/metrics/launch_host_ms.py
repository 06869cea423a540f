"""The host time to enqueue a search's kernels in the traced window: the
``executor.launch`` spans around the executor of each plan (a resident
plan returns before the card finishes), summed, over the ``engine.search``
spans. Reads every ``launch_host_ms.<group>``."""
from knnbench import program_spans


def read(rec):
    searches = len(program_spans.spans("engine.search"))
    if not searches:
        return None
    return sum(program_spans.durations_ms("executor.launch")) / searches
