"""The one general generator of request streams: it reads a traffic mix's
parameters (``traffic/<mix>.json``) and says what each request carries and,
for an open loop, when it is due.

A mix is data alone. Its keys:

    dataset            how the rows are held: the name of ``stores/<name>.py``
                       ("device": resident; "pinned_host": streamed from
                       pinned host memory through ``fit_store(...,
                       resident=False)``)
    store              keyword arguments of that store (optional)
    engine             more keyword arguments of ``ExactKNN`` (optional;
                       k, metric, backend and device come from the
                       configuration and the mix)
    entry              the program's entry the requests go through: the name
                       of ``entries/<name>.py`` ("search": ``ExactKNN.search``
                       from the caller's thread; "batcher":
                       ``ContinuousBatcher.submit`` over an
                       ``AdaptiveScheduler``, as ``KnnServer`` runs it)
    scheduler          keyword arguments of the entry's scheduler (optional)
    loop               how requests are sent: the name of ``loops/<name>.py``
                       ("closed": ``callers`` callers, each sending its next
                       request when the last is answered; "open": each
                       request sent when due, whatever is pending)
    callers            concurrent callers of a closed loop (default 1)
    arrivals           the open loop's arrival laws, superposed: a list of
                       {"law": "poisson", "rate_per_s": r, "order_seed": s}
                       (exponential gaps) and {"law": "periodic", "every_s": t,
                       "burst": b, "offset_s": o} (b requests at o, o + t,
                       o + 2t, ...)
    queries_per_request  rows of each request; 1 sends one (d,) vector
    query_pool         distinct queries made in set-up; requests take them
                       in turn and wrap around
    request            the ``SearchRequest`` fields every request carries:
                       ``k`` (required), and any of ``mode_hint``, ``tier``,
                       ``deadline_ms``, ... as the program names them

Every seed gets the same Poisson gaps in the same cycle (the quantiles of
the exponential law, shuffled once by the law's ``order_seed``, 0 if
absent), entered at a point the seed picks: runs differ in which request
comes when, not in how much arrives nor in how it bunches: a tail
latency then depends on the program, not on which seed drew a burstier
order.
"""
from __future__ import annotations

import numpy as np


def _poisson(law: dict, seconds: float, rng) -> np.ndarray:
    rate = float(law["rate_per_s"])
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng(int(law.get("order_seed", 0))).permutation(gaps)
    gaps = np.roll(gaps, -int(rng.integers(n)))
    return np.cumsum(gaps) - gaps


def _periodic(law: dict, seconds: float, rng) -> np.ndarray:
    every, burst = float(law["every_s"]), int(law.get("burst", 1))
    starts = np.arange(float(law.get("offset_s", 0.0)), seconds, every)
    return np.repeat(starts, burst)


LAWS = {"poisson": _poisson, "periodic": _periodic}


def arrivals(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Due times in seconds from the window's start, ascending, all below
    ``seconds``: the superposition of the mix's arrival laws."""
    rng = np.random.default_rng(int(seed))
    due = []
    for law in mix["arrivals"]:
        if law["law"] not in LAWS:
            raise ValueError(f"unknown arrival law {law['law']!r}; known: {sorted(LAWS)}")
        due.append(LAWS[law["law"]](law, seconds, rng))
    return np.sort(np.concatenate(due), kind="stable")


def pool_rows(mix: dict, request: int) -> tuple[int, int]:
    """(first pool row, rows) of request number ``request``."""
    m = mix["queries_per_request"]
    per_pool = mix["query_pool"] // m
    return (request % per_pool) * m, m


def pool_index(mix: dict, requests) -> np.ndarray:
    """The pool rows of the given requests, (len(requests), m)."""
    m = mix["queries_per_request"]
    first = np.asarray([pool_rows(mix, int(r))[0] for r in requests], dtype=np.int64)
    return first[:, None] + np.arange(m)[None, :]


def queries_of(mix: dict, pool: np.ndarray, request: int) -> np.ndarray:
    """The queries request number ``request`` carries: (m, d), or one (d,)
    vector where the mix sends one row a request."""
    lo, m = pool_rows(mix, request)
    return pool[lo] if m == 1 else pool[lo: lo + m]


def k(mix: dict) -> int:
    return int(mix["request"]["k"])
