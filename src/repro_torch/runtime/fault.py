"""Fault-tolerant training supervision: straggler detection, crash
recovery, failure injection for tests.

The supervisor wraps the step loop, as the reference's
(``repro.runtime.fault``) does:

* every step is timed; an EWMA + deviation tracker flags steps slower than
  `straggler_factor` x the running mean, and the policy hook fires;
* on an exception the loop restores the latest checkpoint and replays —
  `max_restarts` bounds the retry budget;
* `FailureInjector` deterministically raises at chosen steps to exercise
  the recovery path in tests.

The port's step functions update their state in place (``optim.adamw``),
so the state a failed step leaves behind is not the one it started from,
and a failure before the first checkpoint has no file to go back to. The
supervisor therefore keeps a host copy of ``init_state`` until the first
checkpoint exists and restores every restart into the live state's tensors
in place: from the newest checkpoint, or from that copy. The card holds
one copy of the state throughout; the host holds a second one only until
the first save.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.tree import reference_layout, tree_leaves


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time outlier detection (per host or global)."""

    alpha: float = 0.2
    straggler_factor: float = 2.0
    warmup: int = 3
    mean: float = 0.0
    count: int = 0
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float, host: int = 0) -> bool:
        self.count += 1
        if self.count <= self.warmup:
            # warm-up steps are excluded from the baseline
            self.mean = seconds if self.mean == 0 else self.mean
            return False
        is_straggler = seconds > self.straggler_factor * self.mean
        if is_straggler:
            self.flagged.append({"step": step, "host": host, "seconds": seconds,
                                 "mean": self.mean})
        else:
            self.mean = (1 - self.alpha) * self.mean + self.alpha * seconds
        return is_straggler


class FailureInjector:
    """Raises RuntimeError at the given steps (once each) — the chaos monkey
    of the tests."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)

    def maybe_fail(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class SupervisorReport:
    steps_done: int
    restarts: int
    stragglers: list
    losses: list


def _host_copy(state) -> list:
    """The state's leaves (reference layout) copied to the host, in the
    form ``ckpt.restore`` writes back."""
    out = []
    for x in tree_leaves(reference_layout(state)):
        a = ckpt.host_array(x)
        out.append((a.shape, ckpt.dtype_name(x), lambda a=a: a))
    return out


def supervised_train(
    step_fn: Callable,  # (state, batch) -> (state, metrics)
    init_state: Any,
    batches: Callable[[int], Any],  # step -> batch
    n_steps: int,
    manager: CheckpointManager,
    injector: FailureInjector | None = None,
    detector: StragglerDetector | None = None,
    max_restarts: int = 3,
    on_straggler: Callable[[dict], None] | None = None,
) -> tuple[Any, SupervisorReport]:
    """Run n_steps with checkpoint/restart fault tolerance.

    The loop is deterministic given `batches`: after a restart the state is
    restored from the newest checkpoint (or, before the first one, from the
    initial state) and the step counter rewinds with it, so recovered
    training is step-for-step identical to an unfailed run. ``init_state``
    is trained in place when ``step_fn`` updates in place.
    """
    detector = detector or StragglerDetector()
    restarts = 0
    losses: list[float] = []

    state, step = manager.restore_latest(init_state)
    initial = _host_copy(state) if step == 0 else None
    while step < n_steps:
        try:
            t0 = time.perf_counter()
            if injector is not None:
                injector.maybe_fail(step)
            state, metrics = step_fn(state, batches(step))
            dt = time.perf_counter() - t0
            if detector.observe(step, dt) and on_straggler:
                on_straggler(detector.flagged[-1])
            losses.append(float(metrics.get("loss", 0.0)))
            step += 1
            if manager.save(step, state, {"losses_len": len(losses)}) is not None:
                initial = None  # a checkpoint to go back to from now on
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            restored, step = manager.restore_latest(init_state)
            if step == 0 and initial is not None:
                ckpt.restore(init_state, initial)
            state = restored
    manager.save(n_steps, state, force=True)
    manager.finalize()
    return state, SupervisorReport(
        steps_done=step, restarts=restarts,
        stragglers=list(detector.flagged), losses=losses,
    )
