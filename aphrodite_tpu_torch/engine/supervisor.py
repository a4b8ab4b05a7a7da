"""Engine supervision: fault classification and the health state
machine behind the supervised serving loop.

Before this layer, one exception anywhere in ``engine.step()``
permanently killed the background loop and every in-flight request,
and ``check_health()`` only knew "task not done". The supervised loop
(`AsyncAphrodite.engine_step`) now consults two pieces that live
here:

- :func:`classify_failure` sorts a step failure into one of three
  failure classes with distinct blast radii:

  * ``REQUEST`` — bad params, tokenizer/decode failures, per-sequence
    sampler errors: abort only the culprit request and propagate the
    exception to that stream alone.
  * ``TRANSIENT`` — engine-scoped but recoverable (device RPC blips,
    injected transient faults): the step is rolled back by the crash
    barrier (`Scheduler.crash_rollback`) and retried with bounded
    exponential backoff (``APHRODITE_STEP_RETRIES`` /
    ``APHRODITE_STEP_BACKOFF_S``).
  * ``FATAL`` — everything else, plus watchdog timeouts: the engine
    attempts a bounded **reincarnation** (``APHRODITE_REINCARNATIONS``
    rebuilds of the executor/model-runner/KV pool, restorable requests
    back to ``waiting`` with streams intact) and only when that budget
    is exhausted moves to the terminal DEAD state where pending and
    new requests fail fast with ``AsyncEngineDeadError``.

- :class:`HealthMonitor` is the RUNNING/DEGRADED/DRAINING/REBUILDING/
  DEAD state machine: a monotonic heartbeat stamped per completed
  step, failure/recovery/reincarnation counters, graceful-drain
  bookkeeping, and a :class:`HealthReport` every frontend's
  ``/health`` endpoint serializes (state, last-step age, retry and
  lifecycle totals).

This module imports only ``common`` pieces so both the sync engine
and the async wrapper can use it without cycles.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Dict, Optional

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.common.faultinject import InjectedFault

__all__ = [
    "EngineState", "FaultClass", "HealthMonitor", "HealthReport",
    "RequestLostOnRebuild", "StaleEngineStepError", "StepTimeoutError",
    "classify_failure", "reincarnation_policy", "retry_policy",
]


class StepTimeoutError(RuntimeError):
    """The watchdog expired while a step ran off-loop. The executor
    thread is still wedged inside the step (a hung XLA compile or
    device call cannot be interrupted from Python), so this is always
    FATAL: retrying would double-execute the round. Reincarnation IS
    allowed — the rebuild replaces the executor the wedged thread
    holds, and the engine's epoch guard discards that thread's results
    if it ever wakes up."""


class StaleEngineStepError(RuntimeError):
    """A step that outlived an engine reincarnation (typically a
    watchdog-abandoned thread that finally woke up) tried to commit
    its results against the rebuilt engine. Its outputs are discarded
    — the rebuilt engine already restored or errored every request the
    stale step was computing."""


class RequestLostOnRebuild(RuntimeError):
    """An engine reincarnation could not restore this request (forked
    beam KV or swapped-out pages are not recomputable from tokens);
    surfaced typed on exactly that request's stream."""


class EngineState(enum.Enum):
    RUNNING = "RUNNING"
    DEGRADED = "DEGRADED"
    DRAINING = "DRAINING"
    REBUILDING = "REBUILDING"
    DEAD = "DEAD"

    @property
    def code(self) -> int:
        """Stable numeric code for the Prometheus state gauge."""
        return _STATE_CODES[self.value]


_STATE_CODES = {"RUNNING": 0, "DEGRADED": 1, "DRAINING": 2,
                "REBUILDING": 3, "DEAD": 4}


class FaultClass(enum.Enum):
    REQUEST = enum.auto()    # abort the culprit request only
    TRANSIENT = enum.auto()  # roll back + retry the step
    FATAL = enum.auto()      # terminal: engine goes DEAD


#: Lowercased substrings marking transient device/RPC failures (the
#: classes a retry can plausibly clear: runtime RPC deadlines,
#: temporary unavailability, transient resource pressure).
_TRANSIENT_MARKERS = (
    "deadline_exceeded",
    "deadline exceeded",
    "unavailable",
    "connection reset",
    "temporarily",
    "try again",
)


def classify_failure(exc: BaseException,
                     default: FaultClass = FaultClass.FATAL
                     ) -> FaultClass:
    """Failure class of one exception; `default` applies when nothing
    matches (step-level callers default to FATAL — an unknown failure
    must fail fast, not loop — while per-request output processing
    passes REQUEST, where the blast radius is one stream)."""
    if isinstance(exc, InjectedFault):
        return {
            "transient": FaultClass.TRANSIENT,
            "request": FaultClass.REQUEST,
            "fatal": FaultClass.FATAL,
        }[exc.kind]
    if isinstance(exc, StepTimeoutError):
        return FaultClass.FATAL
    text = f"{type(exc).__name__}: {exc}".lower()
    if any(marker in text for marker in _TRANSIENT_MARKERS):
        return FaultClass.TRANSIENT
    return default


def retry_policy() -> tuple:
    """(max_retries, base_backoff_s) from the flag registry, read per
    step so operators can tune a live server via the environment."""
    return (flags.get_int("APHRODITE_STEP_RETRIES"),
            flags.get_float("APHRODITE_STEP_BACKOFF_S"))


def reincarnation_policy() -> tuple:
    """(max_rebuilds, base_backoff_s) for FATAL-fault recovery, read
    per fault so a live server can be tuned via the environment."""
    return (flags.get_int("APHRODITE_REINCARNATIONS"),
            flags.get_float("APHRODITE_REINCARNATION_BACKOFF_S"))


@dataclasses.dataclass
class HealthReport:
    """One /health snapshot (serialized verbatim by the endpoint)."""
    state: str
    last_step_age_s: Optional[float]
    steps_completed: int
    retries_total: int
    recovered_steps: int
    consecutive_failures: int
    dead_reason: Optional[str] = None
    sheds_total: int = 0
    # Lifecycle section: reincarnation counters (FATAL-fault rebuilds)
    # and graceful-drain state, so load balancers can distinguish a
    # replica that is coming back (REBUILDING) from one going away
    # (DRAINING) before either is DEAD.
    reincarnations_total: int = 0
    requests_restored: int = 0
    requests_lost: int = 0
    last_rebuild_s: Optional[float] = None
    draining: bool = False
    drain_deadline_remaining_s: Optional[float] = None
    # Overload-control section (queue depth, queued prefill tokens,
    # shed/expired counters, throughput EWMAs — the engine/metrics.py
    # rider) so load balancers can act on DEGRADED-while-shedding
    # before the replica is DEAD.
    overload: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        body = dataclasses.asdict(self)
        if self.last_step_age_s is not None:
            body["last_step_age_s"] = round(self.last_step_age_s, 3)
        if self.last_rebuild_s is not None:
            body["last_rebuild_s"] = round(self.last_rebuild_s, 3)
        if self.drain_deadline_remaining_s is not None:
            body["drain_deadline_remaining_s"] = round(
                self.drain_deadline_remaining_s, 3)
        if self.overload is None:
            body.pop("overload")
        return body


class HealthMonitor:
    """RUNNING/DEGRADED/DRAINING/REBUILDING/DEAD state machine with a
    per-step heartbeat.

    DEGRADED means "alive but limping": the loop is mid-retry
    (consecutive failures > 0), the admission controller shed a
    request within the last `SHED_DEGRADED_WINDOW_S` seconds
    (overload — the replica is up but turning work away), or, with
    the watchdog enabled, the last completed step is older than the
    step timeout while work is in flight. DRAINING means the replica
    is going away: admission rejects new work with 503 while in-flight
    requests run to completion under the drain deadline (it outranks
    every non-DEAD state — load balancers must stop routing here).
    REBUILDING means a FATAL fault is being recovered by a
    reincarnation (executor/KV rebuild); the replica will serve again.
    DEAD is terminal — nothing un-deads an engine short of a process
    restart (the reincarnation budget is spent, or the process holds
    a wedged executor thread)."""

    #: Seconds after the last load-shed during which the state reads
    #: DEGRADED (long enough for a load balancer's probe interval to
    #: observe a shedding burst, short enough to recover promptly).
    SHED_DEGRADED_WINDOW_S = 5.0

    def __init__(self) -> None:
        self._last_step_at: Optional[float] = None
        self._steps_completed = 0
        self._retries_total = 0
        self._recovered_steps = 0
        self._consecutive_failures = 0
        self._dead_reason: Optional[str] = None
        self._sheds_total = 0
        self._last_shed_at: Optional[float] = None
        # Lifecycle: reincarnation (FATAL-fault rebuild) bookkeeping.
        self._rebuilding = False
        self._reincarnations_total = 0
        self._requests_restored_total = 0
        self._requests_lost_total = 0
        self._last_rebuild_s: Optional[float] = None
        # Graceful drain: set once, never unset (a draining replica is
        # on its way out; un-draining is a process restart).
        self._draining = False
        self._drain_deadline: Optional[float] = None  # monotonic

    # -- transitions (called by the supervised loop) --

    def beat(self) -> None:
        """One step completed: stamp the monotonic heartbeat."""
        self._last_step_at = time.monotonic()
        self._steps_completed += 1
        self._consecutive_failures = 0

    def record_failure(self, exc: BaseException) -> None:
        """A step attempt failed and will be retried."""
        self._retries_total += 1
        self._consecutive_failures += 1

    def record_recovery(self) -> None:
        """A retried step succeeded."""
        self._recovered_steps += 1

    def record_shed(self) -> None:
        """Admission shed a request: DEGRADED-while-shedding for the
        next SHED_DEGRADED_WINDOW_S seconds."""
        self._sheds_total += 1
        self._last_shed_at = time.monotonic()

    def begin_rebuild(self) -> None:
        """A FATAL fault is being recovered: REBUILDING until
        `end_rebuild` (the executor/KV teardown + rebuild window)."""
        self._rebuilding = True

    def end_rebuild(self, success: bool, restored: int = 0,
                    lost: int = 0,
                    duration_s: Optional[float] = None) -> None:
        self._rebuilding = False
        if success:
            self._reincarnations_total += 1
            self._requests_restored_total += restored
            self._requests_lost_total += lost
            self._last_rebuild_s = duration_s
            # The fault streak died with the old executor.
            self._consecutive_failures = 0

    def mark_draining(self, deadline: Optional[float]) -> None:
        """Enter the terminal-ish DRAINING state: admission rejects
        new work, in-flight work runs until `deadline` (monotonic;
        None = unbounded). Idempotent — the first deadline wins."""
        if not self._draining:
            self._draining = True
            self._drain_deadline = deadline

    def mark_dead(self, reason: BaseException | str) -> None:
        if self._dead_reason is None:
            self._dead_reason = (reason if isinstance(reason, str)
                                 else f"{type(reason).__name__}: "
                                      f"{reason}")

    # -- queries --

    @property
    def is_dead(self) -> bool:
        return self._dead_reason is not None

    @property
    def dead_reason(self) -> Optional[str]:
        return self._dead_reason

    @property
    def retries_total(self) -> int:
        return self._retries_total

    @property
    def recovered_steps(self) -> int:
        return self._recovered_steps

    @property
    def sheds_total(self) -> int:
        return self._sheds_total

    @property
    def is_draining(self) -> bool:
        return self._draining

    @property
    def is_rebuilding(self) -> bool:
        return self._rebuilding

    @property
    def reincarnations_total(self) -> int:
        return self._reincarnations_total

    @property
    def requests_restored_total(self) -> int:
        return self._requests_restored_total

    @property
    def requests_lost_total(self) -> int:
        return self._requests_lost_total

    @property
    def last_rebuild_s(self) -> Optional[float]:
        return self._last_rebuild_s

    @property
    def drain_remaining_s(self) -> Optional[float]:
        """Seconds until the drain deadline force-aborts in-flight
        work; None when not draining OR draining without a deadline
        (check `is_draining` to distinguish)."""
        if not self._draining or self._drain_deadline is None:
            return None
        return self._drain_deadline - time.monotonic()

    def state(self, in_flight: bool = False) -> EngineState:
        if self.is_dead:
            return EngineState.DEAD
        if self._draining:
            # Outranks everything non-terminal: the replica is going
            # away, load balancers must route elsewhere NOW.
            return EngineState.DRAINING
        if self._rebuilding:
            return EngineState.REBUILDING
        if self._consecutive_failures > 0:
            return EngineState.DEGRADED
        if self._last_shed_at is not None and \
                time.monotonic() - self._last_shed_at < \
                self.SHED_DEGRADED_WINDOW_S:
            # Shedding load: alive, making progress, but turning work
            # away — load balancers should route around the replica.
            return EngineState.DEGRADED
        timeout = flags.get_float("APHRODITE_STEP_TIMEOUT_S")
        if (timeout and in_flight and self._last_step_at is not None
                and time.monotonic() - self._last_step_at > timeout):
            # The watchdog only observes COMPLETED steps; a step that
            # never returns shows up here as a stale heartbeat.
            return EngineState.DEGRADED
        return EngineState.RUNNING

    def report(self, in_flight: bool = False,
               overload: Optional[Dict[str, Any]] = None) -> HealthReport:
        age = None
        if self._last_step_at is not None:
            age = time.monotonic() - self._last_step_at
        remaining = self.drain_remaining_s
        return HealthReport(
            state=self.state(in_flight=in_flight).value,
            last_step_age_s=age,
            steps_completed=self._steps_completed,
            retries_total=self._retries_total,
            recovered_steps=self._recovered_steps,
            consecutive_failures=self._consecutive_failures,
            dead_reason=self._dead_reason,
            sheds_total=self._sheds_total,
            reincarnations_total=self._reincarnations_total,
            requests_restored=self._requests_restored_total,
            requests_lost=self._requests_lost_total,
            last_rebuild_s=self._last_rebuild_s,
            draining=self._draining,
            drain_deadline_remaining_s=(max(0.0, remaining)
                                        if remaining is not None
                                        else None),
            overload=overload,
        )
