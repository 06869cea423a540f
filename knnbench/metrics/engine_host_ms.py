"""The engine's own host time a search in the traced window: each
``engine.search`` span (``ExactKNN.search``: options, planning, the
queries' padding, the result's stats) less its ``executor.launch``,
averaged over the searches. Reads every ``engine_host_ms.<group>``."""
from knnbench import program_spans


def read(rec):
    return program_spans.mean(program_spans.self_ms("engine.search", ("executor.launch",)))
