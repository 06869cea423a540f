"""Deterministic, seedable fault injection for the search path (the
port's own copy of the reference's fault layer: the same plans fire the
same faults in both packages).

A `FaultPlan` describes a mixture of storage and transfer faults — shard
read ``IOError``, byte corruption, slow-shard stragglers, device-put
failures, gather failures — and a `FaultInjector` fires them from hooks
inside `store.DatasetStore` and `core.streaming`, deterministically per
``(op, shard, occurrence)``.

Determinism contract
    Every decision is drawn from ``np.random.default_rng`` seeded by
    ``(plan.seed, op, key, occurrence)``. The same plan over the same call
    sequence injects the same faults — chaos runs are replayable by seed,
    and a plan replayed through either package fires the same ``events``.

Convergence contract
    Transient faults are bounded: one ``(op, key)`` site fails at most
    ``plan.max_failures_per_op`` times *consecutively*, then the next call
    is forced to succeed. A reader retrying at least that many times
    always converges, so a chaos soak with ``max_retries >=
    max_failures_per_op`` can assert zero crashes. Shards listed in
    ``plan.fail_shards`` are *persistent* failures (every read raises) —
    the quarantine / ``allow_partial`` machinery, not retry, must absorb
    those.

The injector is either installed per store (``store.fault_injector =
inj``) or process-wide (`install` / the `installed` context manager —
this is what reaches the `device_put_partition` hook, which has no store
in scope).

Crash-point injection (durability faults)
    A plan can also arm exactly one *crash point*: a named site in the
    store's write paths (journal append, compactor — see
    :data:`CRASH_SITES`) at which the k-th visit dies. The fields are kept
    so that plans are interchangeable between the packages; the port's
    read-side store visits no crash site. Two modes:

    * ``crash_mode="exit"`` — the process hard-exits via ``os._exit``
      (no Python cleanup, no buffer flush: what a power cut / SIGKILL
      leaves behind); only a subprocess harness may arm it.
    * ``crash_mode="raise"`` — raises :class:`InjectedCrash` (a
      ``BaseException``, so ordinary ``except Exception`` recovery code
      cannot accidentally absorb it).

    The ``*.torn`` journal site additionally truncates the record being
    written to ``torn_fraction`` of its bytes before dying.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import Counter

import numpy as np

__all__ = [
    "FaultError",
    "ShardReadError",
    "ShardCorruptError",
    "InjectedCrash",
    "FaultPlan",
    "FaultInjector",
    "CRASH_SITES",
    "CRASH_EXIT_CODE",
    "install",
    "uninstall",
    "active",
    "installed",
]


class FaultError(OSError):
    """Base class for injected / detected search-path storage faults."""

    def __init__(self, message: str, shard_id: int = -1, tier: str = ""):
        super().__init__(message)
        self.shard_id = int(shard_id)
        self.tier = str(tier)


class ShardReadError(FaultError):
    """A shard's bytes could not be read (torn file, flaky disk, ...)."""


class ShardCorruptError(FaultError):
    """A shard's bytes were read but failed their CRC32 check."""


class InjectedCrash(BaseException):
    """An in-process simulated crash (``crash_mode="raise"``).

    Deliberately a ``BaseException``: recovery machinery written as
    ``except Exception`` must not be able to absorb a simulated process
    death — only the test harness catches this, then reopens the store
    exactly as a fresh process would.
    """

    def __init__(self, site: str):
        super().__init__(f"injected crash at {site}")
        self.site = site


#: Exit status the hard crash mode dies with (``os._exit``); the
#: subprocess kill-and-reopen matrix asserts on it to distinguish an
#: injected crash from an accidental one.
CRASH_EXIT_CODE = 43

#: Every named crash site in the store's write paths, in protocol order.
#: Journal sites fire inside ``store.journal.Journal.append`` (one durable
#: mutation); compactor sites fire inside ``DatasetStore.compact`` (one
#: generation build + atomic pointer swap). The kill-and-reopen matrix
#: iterates this tuple — adding a write-path site without listing it here
#: leaves it untested, so keep them in sync.
CRASH_SITES = (
    "journal.append.begin",        # nothing written -> mutation absent
    "journal.append.torn",         # partial record bytes -> tail discarded
    "journal.append.after_write",  # full bytes, fsync pending
    "journal.append.after_fsync",  # durable, ack never returned
    "compact.begin",               # nothing built -> old generation serves
    "compact.after_shards",        # new shards on disk, no manifest
    "compact.after_manifest",      # new manifest, pointer still old
    "compact.before_current",      # tail journal written, pointer still old
    "compact.after_current",       # pointer swapped, old gen not yet GC'd
    "compact.after_gc",            # fully complete
)

_TIER_CODES = {"f32": 0, "int8": 1, "int8_meta": 2, "": 3}
_OP_CODES = {"read": 0, "corrupt": 1, "slow": 2, "put": 3, "gather": 4,
             "crash": 5}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One replayable mixture of search-path faults.

    Rates are per-call probabilities in ``[0, 1]``. ``fail_shards`` lists
    shard ids that fail *persistently* (optionally restricted to
    ``fail_tier``); everything else is transient and bounded by
    ``max_failures_per_op`` consecutive failures per site.
    """

    seed: int = 0
    read_error_rate: float = 0.0   # shard read raises ShardReadError
    corrupt_rate: float = 0.0      # shard bytes get one flipped byte
    slow_rate: float = 0.0         # shard read sleeps slow_s (straggler)
    slow_s: float = 0.01
    put_error_rate: float = 0.0    # device_put_partition raises
    gather_error_rate: float = 0.0 # gather_rows raises
    fail_shards: tuple = ()        # persistent: these shards always fail
    fail_tier: str | None = None   # restrict fail_shards to one tier
    max_failures_per_op: int = 2   # consecutive transient failures cap
    crash_site: str = ""           # "" = no crash point armed
    crash_occurrence: int = 1      # die on the k-th visit of crash_site
    crash_mode: str = "raise"      # "raise" (InjectedCrash) | "exit" (os._exit)
    torn_fraction: float = 0.5     # bytes written before a *.torn crash

    def __post_init__(self):
        for f in ("read_error_rate", "corrupt_rate", "slow_rate",
                  "put_error_rate", "gather_error_rate"):
            v = getattr(self, f)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v!r}")
        if self.slow_s < 0:
            raise ValueError(f"slow_s must be >= 0, got {self.slow_s!r}")
        if self.max_failures_per_op < 0:
            raise ValueError("max_failures_per_op must be >= 0, got "
                             f"{self.max_failures_per_op!r}")
        if self.fail_tier is not None and self.fail_tier not in ("f32", "int8"):
            raise ValueError(f"fail_tier must be 'f32'|'int8'|None, got "
                             f"{self.fail_tier!r}")
        if self.crash_site and self.crash_site not in CRASH_SITES:
            raise ValueError(
                f"unknown crash_site {self.crash_site!r}; known: "
                + ", ".join(CRASH_SITES))
        if self.crash_occurrence < 1:
            raise ValueError("crash_occurrence must be >= 1, got "
                             f"{self.crash_occurrence!r}")
        if self.crash_mode not in ("raise", "exit"):
            raise ValueError("crash_mode must be 'raise'|'exit', got "
                             f"{self.crash_mode!r}")
        if not 0.0 < float(self.torn_fraction) < 1.0:
            raise ValueError("torn_fraction must be in (0, 1), got "
                             f"{self.torn_fraction!r}")


class FaultInjector:
    """Fires a `FaultPlan`'s faults from the store/streaming hooks.

    Thread-safe: the speculative-gather thread calls `on_gather`
    concurrently with shard reads on the dispatch thread. Every injected
    fault is appended to ``events`` (``{"op", "shard", "tier"}``) so tests
    can reconcile injections against the `health` stats that surface them.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._calls: Counter = Counter()   # (op, key) -> call count
        self._consec: Counter = Counter()  # (op, key) -> consecutive fails

    # ------------------------------------------------------------- internals
    def _uniform(self, op: str, key: tuple, call: int) -> float:
        seq = [int(self.plan.seed) & 0x7FFFFFFF, _OP_CODES[op]]
        seq += [int(k) & 0x7FFFFFFF for k in key]
        seq.append(int(call) & 0x7FFFFFFF)
        return float(np.random.default_rng(seq).random())

    def _fire(self, op: str, key: tuple, rate: float) -> bool:
        """Deterministic bounded coin flip for one (op, site) call."""
        if rate <= 0.0:
            return False
        site = (op, key)
        with self._lock:
            self._calls[site] += 1
            call = self._calls[site]
            if self._consec[site] >= self.plan.max_failures_per_op:
                # forced success: bounded retries always converge
                self._consec[site] = 0
                return False
            if self._uniform(op, key, call) < rate:
                self._consec[site] += 1
                return True
            self._consec[site] = 0
            return False

    def _log(self, op: str, shard: int, tier: str) -> None:
        with self._lock:
            self.events.append({"op": op, "shard": int(shard), "tier": tier})

    # ----------------------------------------------------------------- hooks
    def on_shard_read(self, shard_id: int, tier: str) -> None:
        """Called by ``DatasetStore.read_shard`` before touching bytes."""
        p = self.plan
        if shard_id in p.fail_shards and (p.fail_tier is None
                                          or p.fail_tier == tier):
            self._log("read", shard_id, tier)
            raise ShardReadError(
                f"injected persistent read failure on shard {shard_id} "
                f"({tier} tier)", shard_id, tier)
        tkey = (int(shard_id), _TIER_CODES.get(tier, 3))
        if self._fire("slow", tkey, p.slow_rate):
            self._log("slow", shard_id, tier)
            time.sleep(p.slow_s)
        if self._fire("read", tkey, p.read_error_rate):
            self._log("read", shard_id, tier)
            raise ShardReadError(
                f"injected transient read failure on shard {shard_id} "
                f"({tier} tier)", shard_id, tier)

    def maybe_corrupt(self, arr: np.ndarray, shard_id: int,
                      tier: str) -> np.ndarray:
        """Return ``arr``, or a copy with one deterministic byte flipped."""
        tkey = (int(shard_id), _TIER_CODES.get(tier, 3))
        if not self._fire("corrupt", tkey, self.plan.corrupt_rate):
            return arr
        self._log("corrupt", shard_id, tier)
        out = np.array(arr, copy=True)
        flat = out.view(np.uint8).reshape(-1)
        with self._lock:
            pos = int(self._uniform("corrupt", tkey, self._calls[
                ("corrupt", tkey)]) * flat.size) % flat.size
        flat[pos] ^= 0xFF
        return out

    def on_device_put(self, base_index: int) -> None:
        """Called by ``core.streaming.device_put_partition`` per transfer."""
        key = (max(int(base_index), 0),)
        if self._fire("put", key, self.plan.put_error_rate):
            self._log("put", base_index, "")
            raise RuntimeError(
                f"injected device_put failure (partition base {base_index})")

    def on_gather(self, n_ids: int) -> None:
        """Called by ``DatasetStore.gather_rows`` before reading rows."""
        if self._fire("gather", (), self.plan.gather_error_rate):
            self._log("gather", -1, "f32")
            raise ShardReadError(
                f"injected gather failure ({n_ids} candidate rows)")

    # ------------------------------------------------------- crash points
    def _site_armed(self, site: str) -> bool:
        """True iff this visit of `site` is the one the plan kills.

        Each site keeps its own visit counter, so ``crash_occurrence=k``
        deterministically targets the k-th durable write through that
        site no matter what other sites fired in between."""
        if site != self.plan.crash_site:
            return False
        with self._lock:
            self._calls[("crash", site)] += 1
            return self._calls[("crash", site)] == self.plan.crash_occurrence

    def crash_now(self, site: str) -> None:
        """Unconditionally die at `site` (mode per plan). Write-path code
        calls this after :meth:`torn_write_armed` said to tear a write."""
        self._log("crash", -1, site)
        if self.plan.crash_mode == "exit":
            os._exit(CRASH_EXIT_CODE)  # no flush, no atexit: a real crash
        raise InjectedCrash(site)

    def crash_point(self, site: str) -> None:
        """Ordered crash hook for the store's write paths: dies iff the
        plan armed this `site` and this is its k-th visit."""
        if self._site_armed(site):
            self.crash_now(site)

    def torn_write_armed(self, site: str) -> float | None:
        """Arm a torn write: returns the fraction of the record's bytes the
        caller must write before calling :meth:`crash_now`, or None to
        write normally. Torn sites model a crash *mid*-write — the bytes
        on disk are a prefix of a valid record, which replay must discard."""
        if self._site_armed(site):
            return float(self.plan.torn_fraction)
        return None

    # ------------------------------------------------------------- reporting
    def counts(self) -> dict:
        """Injected-event totals per op (for reconciling against health)."""
        with self._lock:
            c: Counter = Counter(e["op"] for e in self.events)
        return {op: int(c.get(op, 0)) for op in _OP_CODES}


# ------------------------------------------------------- process-wide hookup
_ACTIVE: FaultInjector | None = None
_ACTIVE_LOCK = threading.Lock()


def install(inj: FaultInjector) -> None:
    """Install a process-wide injector (reaches the device_put hook)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = inj


def uninstall() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None


def active() -> FaultInjector | None:
    return _ACTIVE


@contextlib.contextmanager
def installed(inj: FaultInjector):
    """``with installed(inj): ...`` — scoped process-wide injection."""
    install(inj)
    try:
        yield inj
    finally:
        uninstall()
