"""The program's own spans and counters, for the readers of the
``program_span`` and ``program_counter`` metrics that read them.

The port records them (``repro_torch.runtime.tracing``) only while a torch
profiler records, so in a traced run the record holds the window's spans
alone; an untraced run records none. A program without the recorder gives
None, and its readers leave their metric out.
"""
from __future__ import annotations

from collections import defaultdict


def record() -> tuple[list, dict] | None:
    """(spans, counters) of the program's recorder; None where it has none.
    A span has ``name``, ``start`` and ``end`` (host seconds), ``id`` and
    ``parent``."""
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    return tracing.spans(), tracing.counters()


def spans(name: str) -> list:
    rec = record()
    return [] if rec is None else [s for s in rec[0] if s.name == name]


def durations_ms(name: str) -> list[float]:
    return [(s.end - s.start) * 1e3 for s in spans(name)]


def self_ms(name: str, children: tuple[str, ...]) -> list[float]:
    """Each ``name`` span's duration less the part of it that its child
    spans of the ``children`` names cover, in ms."""
    rec = record()
    if rec is None:
        return []
    kids = defaultdict(list)
    for s in rec[0]:
        if s.name in children and s.parent is not None:
            kids[s.parent].append((s.start, s.end))
    out = []
    for s in rec[0]:
        if s.name != name:
            continue
        covered, reach = 0.0, s.start
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, reach), min(b, s.end)
            if b > a:
                covered += b - a
                reach = b
        out.append((s.end - s.start - covered) * 1e3)
    return out


def mean(values: list[float]) -> float | None:
    return sum(values) / len(values) if values else None


def counter(name: str) -> int | None:
    rec = record()
    return None if rec is None else rec[1].get(name)
