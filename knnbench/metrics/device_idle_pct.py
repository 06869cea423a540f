"""The share of the traced window in which no kernel, copy or memset runs on
the card (torch.profiler's device events). Reads every
``device_idle_pct.<group>`` (batch, streamed, open, single)."""


def read(rec):
    t = rec.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
