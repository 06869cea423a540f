"""The host time of a ring step in the traced window: the program's
``ring.step`` spans (``repro_torch.core.sharded.fqsd_ring``: queueing one
step's block copies and every position's scans), averaged. Where it
approaches a step's device time, one host thread paces the cards. Reads
every ``ring_step_host_ms.<group>``."""
from knnbench import program_spans


def read(rec):
    return program_spans.mean(program_spans.durations_ms("ring.step"))
