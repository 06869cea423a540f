"""Admission control: per-tenant sliding-window rate limits + quotas and
deadline-aware queue admission for the live front end (the port's copy of
``repro.server.admission``, unchanged but for this docstring).

The degradation ladder starts here: a request is first
checked against its tenant's sliding-window rate limit and inflight quota,
then against the server-wide inflight bound, then against its own deadline
— if the continuous batcher's backlog already predicts a start time past
the request's deadline, the server answers **429 + Retry-After now**
instead of queueing work it provably cannot serve in time (queueing it
would only be shed later, after burning a queue slot on it). Everything
admitted is accounted as inflight until :meth:`AdmissionController.release`
— the slot is released in the handler's ``finally``, so disconnects and
timeouts can never leak it.

This layer is synchronous, allocation-light, and owns no locks: it runs on
the event loop only. The scheduler's shed/circuit-breaker machinery sits
*below* it — admission rejects work before it enters the queue, shedding
answers work that expired inside it, the breaker degrades work that keeps
failing after dispatch.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque

__all__ = ["AdmissionController", "Verdict"]


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One admission decision. ``admitted=False`` carries the HTTP status
    (always 429 here), a machine-readable reason bucket, and the
    Retry-After hint in seconds."""

    admitted: bool
    status: int = 200
    reason: str = ""
    retry_after_s: float = 0.0


class _Tenant:
    __slots__ = ("arrivals", "inflight", "admitted", "rejected")

    def __init__(self):
        self.arrivals: deque[float] = deque()
        self.inflight = 0
        self.admitted = 0
        self.rejected = 0


class AdmissionController:
    """Sliding-window rate limits, quotas, and deadline-aware admission.

    max_inflight         server-wide bound on admitted-but-unanswered
                         requests (the bounded queue; None = unbounded).
    tenant_qps           per-tenant sustained request rate over a sliding
                         ``window_s`` window (None = unlimited). The
                         window admits ``ceil(tenant_qps * window_s)``
                         arrivals, so short bursts above the rate pass as
                         long as the window average holds.
    tenant_max_inflight  per-tenant inflight quota (None = unlimited).
    window_s             sliding-window width in seconds.
    clock                injectable monotonic clock (tests).
    """

    def __init__(
        self,
        max_inflight: int | None = 256,
        tenant_qps: float | None = None,
        tenant_max_inflight: int | None = None,
        window_s: float = 1.0,
        clock=time.monotonic,
    ):
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if tenant_qps is not None and tenant_qps <= 0:
            raise ValueError(f"tenant_qps must be > 0, got {tenant_qps}")
        if tenant_max_inflight is not None and tenant_max_inflight < 1:
            raise ValueError(
                f"tenant_max_inflight must be >= 1, got {tenant_max_inflight}"
            )
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.max_inflight = max_inflight
        self.tenant_qps = tenant_qps
        self.tenant_max_inflight = tenant_max_inflight
        self.window_s = float(window_s)
        self._clock = clock
        self._tenants: dict[str, _Tenant] = {}
        self.inflight = 0
        self.admitted = 0
        self.rejected = {"rate_limit": 0, "quota": 0, "capacity": 0,
                         "deadline": 0}

    # ------------------------------------------------------------- decisions
    def _tenant(self, tenant: str) -> _Tenant:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = _Tenant()
        return t

    def try_admit(
        self,
        tenant: str,
        deadline_ms: float | None = None,
        predicted_wait_s: float = 0.0,
    ) -> Verdict:
        """Admit or reject one request, in ladder order: tenant rate limit,
        tenant quota, server capacity, deadline feasibility.

        ``predicted_wait_s`` is the batcher's estimate of time-to-first-
        dispatch given the current backlog; a request whose deadline cannot
        survive that wait is rejected *now* with Retry-After instead of
        being queued only to be shed at dispatch.
        """
        t = self._tenant(tenant)
        now = self._clock()
        horizon = now - self.window_s
        while t.arrivals and t.arrivals[0] <= horizon:
            t.arrivals.popleft()

        def reject(reason: str, retry_after_s: float) -> Verdict:
            t.rejected += 1
            self.rejected[reason] += 1
            return Verdict(False, 429, reason,
                           max(retry_after_s, 1e-3))

        if self.tenant_qps is not None:
            allowance = max(1, math.ceil(self.tenant_qps * self.window_s))
            if len(t.arrivals) >= allowance:
                # retry once the oldest arrival slides out of the window
                return reject("rate_limit",
                              t.arrivals[0] + self.window_s - now)
        if (self.tenant_max_inflight is not None
                and t.inflight >= self.tenant_max_inflight):
            return reject("quota", predicted_wait_s or self.window_s)
        if self.max_inflight is not None and self.inflight >= self.max_inflight:
            return reject("capacity", predicted_wait_s or self.window_s)
        if (deadline_ms is not None
                and predicted_wait_s * 1e3 > deadline_ms):
            # cannot meet the deadline given the backlog: reject instead of
            # queueing a guaranteed shed
            return reject("deadline", predicted_wait_s)

        t.arrivals.append(now)
        t.inflight += 1
        t.admitted += 1
        self.inflight += 1
        self.admitted += 1
        return Verdict(True)

    def release(self, tenant: str) -> None:
        """Return one admitted request's slot (handler ``finally``)."""
        t = self._tenants.get(tenant)
        if t is not None and t.inflight > 0:
            t.inflight -= 1
        if self.inflight > 0:
            self.inflight -= 1

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "inflight": self.inflight,
            "admitted": self.admitted,
            "rejected": dict(self.rejected),
            "limits": {
                "max_inflight": self.max_inflight,
                "tenant_qps": self.tenant_qps,
                "tenant_max_inflight": self.tenant_max_inflight,
                "window_s": self.window_s,
            },
            "tenants": {
                name: {"inflight": t.inflight, "admitted": t.admitted,
                       "rejected": t.rejected}
                for name, t in sorted(self._tenants.items())
            },
        }
