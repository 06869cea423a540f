"""Queries answered in the window, their answers on the host, over the
window's seconds (host clock). Also reads ``queries_per_s.streamed``."""


def read(rec):
    return rec.queries / rec.window_s if rec.queries and rec.window_s > 0 else None
