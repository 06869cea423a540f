"""Bytes copied host to device in the traced window (the profiler's
``Memcpy HtoD`` events), over the window's seconds, in GB/s."""


def read(rec):
    t = rec.trace
    if t is None or t["h2d_bytes"] <= 0:
        return None
    return t["h2d_bytes"] / t["window_s"] / 1e9
