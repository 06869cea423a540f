"""Spans and counters at the layer boundaries of the search path, recorded
while a torch profiler records.

Recording is on exactly while ``torch.profiler`` (or the autograd profiler)
records: every site reads the process-wide flag
``torch.autograd.profiler._is_profiler_enabled``, which every thread sees,
the batcher's dispatch worker too. Off, a site costs its call and that one
read: ``span`` and ``handoff`` return one shared no-op context, ``count``
and ``begin`` return at once; nothing is allocated and no clock is read.
There is no other switch.

On, a span records its name, its start and end on ``time.perf_counter`` (the
host clock a benchmark ties to the profiler's trace), the thread it opened
on, its own id, its parent's id (the innermost span open on its thread) and
the id of the request or dispatch it belongs to (a root span's own id,
which its descendants share). Each span also enters
``torch.profiler.record_function(name)``, so where the profiler sees the
thread the span sits on the trace's own timeline as well.

A request's wait in a queue crosses threads: :func:`begin` opens it where
the request is queued, :func:`handoff` closes it on the thread that serves
it, and the first span opened there inside the ``handoff`` block is the
parent the waits name.

Spans stay in memory in a bounded ring of tuples of atoms (the garbage
collector does not walk them), newest last; :func:`spans` and
:func:`counters` snapshot them, :func:`clear` empties both.

The spans and counters of the search path, and what each stands for:

=========================  ==============================================
``batcher.wait``           a request's time in ``ContinuousBatcher``'s
                           queue, from ``submit`` until the worker thread
                           starts the dispatch that serves it
``scheduler.dispatch``     one ``AdaptiveScheduler`` dispatch, from its
                           start until its results are built (attrs:
                           rows, padded_rows, mode, tier)
``scheduler.device_wait``  inside a dispatch, waiting for the card before
                           the answers are copied to the host
``engine.search``          one ``ExactKNN.search``, entry to return
``executor.launch``        the host time to enqueue one plan's kernels
``scheduler.rows``         counter: query rows a dispatch carried
``scheduler.padded_rows``  counter: rows the dispatch padded them with
``scan.survivors``         counter: lanes the f32 scan's survivor filter
                           admitted (``kernels.knn.kernel.knn_fused``; a
                           count on the card, read with the counters)
``scan.lanes``             counter: the lanes that scan scored
=========================  ==============================================

A site that must not wait for the card counts a tensor on it
(:func:`count`); the recorder adds it to one tensor a counter on the card
and reads that when :func:`counters` is called. :func:`recording` tells a
site whether to gather what it counts.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["RING", "Recorder", "Span", "begin", "clear", "count", "counters",
           "handoff", "recording", "span", "spans"]

#: spans the ring keeps; the oldest fall out beyond it
RING = 1 << 20


class Span(NamedTuple):
    """One recorded span. ``start`` and ``end`` are ``time.perf_counter``
    seconds; ``parent`` is None for a root; ``attrs`` a dict of atoms."""
    name: str
    start: float
    end: float
    thread: int
    id: int
    parent: int | None
    request: int
    attrs: dict


class _Off:
    """The one no-op context a site gets while nothing records; false."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


_OFF = _Off()


class _Span:
    """An open span on its thread's stack."""
    __slots__ = ("rec", "name", "start", "id", "parent", "request", "attrs", "_rf", "_stack")

    def __init__(self, rec: "Recorder", name: str, start: float | None):
        self.rec, self.name, self.start = rec, name, start
        self.attrs = {}

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        if stack:
            self.id = next(rec._ids)
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            reserved, rec._local.reserved = getattr(rec._local, "reserved", None), None
            self.id = reserved if reserved is not None else next(rec._ids)
            self.parent, self.request = None, self.id
        self._stack = stack
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self.start is None:
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self._rf.__exit__(*exc)
        self._stack.pop()
        self.rec._spans.append((self.name, self.start, end, threading.get_ident(), self.id,
                                self.parent, self.request, self.attrs))
        return False


class _Handoff:
    """Closes queue waits on the serving thread (:func:`handoff`)."""
    __slots__ = ("rec",)

    def __init__(self, rec: "Recorder"):
        self.rec = rec

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.rec._local.reserved = None
        return False


class Recorder:
    """A bounded record of spans and counters (the module's functions use
    one for the whole process)."""

    def __init__(self, ring: int = RING):
        self._spans: deque = deque(maxlen=ring)
        self._counters: dict[str, int] = {}
        self._unread: dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, start: float | None = None):
        """A context that records the span ``name`` while recording is on
        (``start``: a ``time.perf_counter`` reading the caller took already;
        None reads the clock on entry). Its ``attrs`` dict takes what the
        site knows; the no-op context is false, so ``if sp:`` guards work
        done only for the record."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name, start)

    def count(self, name: str, n) -> None:
        """Add ``n`` to the counter ``name`` while recording is on. A tensor
        ``n`` (one integer, on any device) is added on its device to the
        counter's unread sum, read when the counters are read, so the site
        does not wait for the card."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        with self._lock:
            if isinstance(n, torch.Tensor):
                acc = self._unread.get(name)
                if acc is None:
                    self._unread[name] = n.detach().to(torch.int64).clone()
                else:
                    acc.add_(n.to(acc.device))
            else:
                self._counters[name] = self._counters.get(name, 0) + int(n)

    def begin(self, name: str) -> tuple | None:
        """Open ``name`` on this thread, to be closed by :meth:`handoff` on
        another: (name, start, id, thread), or None while recording is off.
        Its id is its request's."""
        if not _autograd_profiler._is_profiler_enabled:
            return None
        return name, time.perf_counter(), next(self._ids), threading.get_ident()

    def handoff(self, opened):
        """Close the spans :meth:`begin` opened (None entries skipped) now,
        on the thread that serves them; the first root span opened on this
        thread inside the block takes the id they name as their parent."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        end = time.perf_counter()
        parent = next(self._ids)
        for o in opened:
            if o is not None:
                name, start, sid, thread = o
                self._spans.append((name, start, end, thread, sid, parent, sid, {}))
        self._local.reserved = parent
        return _Handoff(self)

    def spans(self) -> list[Span]:
        """The recorded spans, oldest first."""
        return [Span(*s) for s in list(self._spans)]

    def counters(self) -> dict[str, int]:
        """The counters, the tensors counted so far read into them."""
        with self._lock:
            for name, acc in self._unread.items():
                self._counters[name] = self._counters.get(name, 0) + int(acc)
            self._unread.clear()
            return dict(self._counters)

    def clear(self) -> None:
        self._spans.clear()
        with self._lock:
            self._counters.clear()
            self._unread.clear()


def recording() -> bool:
    """Whether the sites record now (a torch profiler records)."""
    return _autograd_profiler._is_profiler_enabled


_RECORDER = Recorder()
span = _RECORDER.span
count = _RECORDER.count
begin = _RECORDER.begin
handoff = _RECORDER.handoff
spans = _RECORDER.spans
counters = _RECORDER.counters
clear = _RECORDER.clear
