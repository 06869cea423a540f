"""The scheduler's own host time a dispatch in the traced window: each
``scheduler.dispatch`` span (stacking and padding, the breaker, the answer
copies, the accounting) less its ``engine.search`` and its
``scheduler.device_wait`` (the wait for the card before the copies),
averaged over the dispatches. Reads every ``scheduler_host_ms.<group>``."""
from knnbench import program_spans


def read(rec):
    return program_spans.mean(program_spans.self_ms(
        "scheduler.dispatch", ("engine.search", "scheduler.device_wait")))
