"""Per-replica state the fleet router routes on (port of
`aphrodite_tpu/fleet/replica.py`, copied).

A :class:`ReplicaHandle` is the router's view of one engine server:
its base URL, the last polled :class:`ReplicaSnapshot` (the
``/health?probe=1`` fast path: lifecycle state + overload snapshot),
circuit-breaker bookkeeping, and the rollout cordon. All state here
is owned and mutated by the router's event loop only — there is no
step thread in the router process, so no cross-world hazards.

The load score deliberately mirrors what single-replica admission
sheds on: backlog depth plus the predicted prefill wait derived from
the replica's own throughput EWMA. A replica that would shed the
request scores high enough that the router routes around it first.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

#: Snapshot states a request may be routed to. DRAINING/DEAD are
#: never picked on purpose (stale snapshots are handled separately).
ROUTABLE_STATES = ("RUNNING", "DEGRADED")

#: Snapshots older than this many poll intervals are STALE: their
#: load numbers are history, not signal.
STALE_POLL_MULTIPLE = 4.0


@dataclasses.dataclass
class ReplicaSnapshot:
    """One parsed ``/health?probe=1`` response."""
    state: str
    draining: bool
    inflight: int
    queue_depth: int
    waiting_prefill_tokens: int
    ewma_prefill_tok_s: float
    polled_at: float            # monotonic receive stamp

    @classmethod
    def from_probe(cls, body: Dict[str, Any],
                   polled_at: Optional[float] = None
                   ) -> "ReplicaSnapshot":
        overload = body.get("overload") or {}
        return cls(
            state=str(body.get("state", "DEAD")),
            draining=bool(body.get("draining", False)),
            inflight=int(body.get("inflight", 0) or 0),
            queue_depth=int(overload.get("queue_depth", 0) or 0),
            waiting_prefill_tokens=int(
                overload.get("waiting_prefill_tokens", 0) or 0),
            ewma_prefill_tok_s=float(
                overload.get("ewma_prefill_tok_s", 0.0) or 0.0),
            polled_at=(time.monotonic() if polled_at is None
                       else polled_at))

    def load_score(self) -> float:
        """Backlog in ~request units plus the predicted prefill wait
        (seconds) the queued tokens imply at this replica's own
        measured prefill rate — the same signal its admission
        controller sheds on."""
        score = float(self.inflight + self.queue_depth)
        if self.waiting_prefill_tokens > 0:
            rate = self.ewma_prefill_tok_s
            if rate <= 0.0:
                rate = 4096.0       # no EWMA yet: assume a fast one
            score += self.waiting_prefill_tokens / rate
        return score


class ReplicaHandle:
    """The router's bookkeeping for one replica server."""

    def __init__(self, url: str, name: Optional[str] = None,
                 admin_key: Optional[str] = None) -> None:
        self.url = url.rstrip("/")
        self.name = name or self.url
        #: Bearer key for the replica's POST /admin/drain.
        self.admin_key = admin_key
        self.snapshot: Optional[ReplicaSnapshot] = None
        #: Rollout cordon: excluded from picks while being rolled.
        self.cordoned = False
        #: Circuit breaker: excluded from picks until this monotonic
        #: time; re-armed by every connection-level failure and by
        #: DEAD health reports, cleared by a routable health report.
        self.broken_until = 0.0
        self.consecutive_failures = 0
        #: Monotonic pick counter (stats + round-robin tiebreak).
        self.picks = 0
        self.proxied_ok = 0
        self.proxied_failed = 0

    # -- poll-loop transitions ---------------------------------------

    def record_health(self, snap: ReplicaSnapshot,
                      cb_window_s: float) -> None:
        self.snapshot = snap
        self.consecutive_failures = 0
        if snap.state == "DEAD":
            # Keep the breaker armed while the replica reports DEAD;
            # recovery (a routable report) clears it below.
            self.broken_until = snap.polled_at + cb_window_s
        elif snap.state in ROUTABLE_STATES or snap.state == "REBUILDING":
            self.broken_until = 0.0

    def record_failure(self, cb_window_s: float,
                       now: Optional[float] = None) -> None:
        """A poll or proxied request failed at the connection level."""
        self.consecutive_failures += 1
        self.broken_until = (time.monotonic() if now is None
                             else now) + cb_window_s

    def mark_draining_seen(self) -> None:
        """A proxied request came back 503-draining before the poll
        loop noticed: stop picking the replica immediately."""
        if self.snapshot is not None:
            self.snapshot = dataclasses.replace(
                self.snapshot, state="DRAINING", draining=True)

    # -- pick-time queries -------------------------------------------

    def circuit_broken(self, now: Optional[float] = None) -> bool:
        return (time.monotonic() if now is None
                else now) < self.broken_until

    def snapshot_age_s(self, now: Optional[float] = None
                       ) -> Optional[float]:
        if self.snapshot is None:
            return None
        return (time.monotonic() if now is None
                else now) - self.snapshot.polled_at

    def is_stale(self, poll_interval_s: float,
                 now: Optional[float] = None) -> bool:
        age = self.snapshot_age_s(now)
        return age is None or \
            age > STALE_POLL_MULTIPLE * max(poll_interval_s, 1e-3)

    def describe(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One /fleet/stats row."""
        age = self.snapshot_age_s(now)
        return {
            "url": self.url,
            "state": (self.snapshot.state if self.snapshot is not None
                      else None),
            "load_score": (round(self.snapshot.load_score(), 3)
                           if self.snapshot is not None else None),
            "snapshot_age_s": (round(age, 3) if age is not None
                               else None),
            "circuit_broken": self.circuit_broken(now),
            "cordoned": self.cordoned,
            "consecutive_failures": self.consecutive_failures,
            "picks": self.picks,
            "proxied_ok": self.proxied_ok,
            "proxied_failed": self.proxied_failed,
        }
