"""The cell's own exact-search work over the device-kernel time of the
traced window, every kernel whatever its name: for each search of m queries
in the window the least time it can take (roofline.search_bound_s: the
unpadded rows read once plus queries and answers over the memory rate, or
2 m N d operations over the f32 peak, whichever is larger), summed, over the
summed kernel time. Reads every ``kernel_roofline_pct.<group>``."""
from knnbench import roofline


def read(rec):
    t = rec.trace
    if t is None or t["kernel_s"] <= 0 or not rec.searches:
        return None
    n, d = rec.cfg["n"], rec.cfg["d"]
    work = sum(roofline.search_bound_s(n, d, m, rec.k) for m in rec.searches)
    return 100.0 * work / t["kernel_s"]
