"""Fleet layer: compose N engine replicas into one service (port of
`aphrodite_tpu/fleet/`, copied with its import paths rewritten).

One replica is already operable — deadline-aware admission with
Retry-After, a full RUNNING/DEGRADED/REBUILDING/DRAINING/DEAD
lifecycle exported via ``/health``, graceful drain, chaos-kill-proven
reincarnation. This package is the composition step from "a fast
replica" to "a service":

- :mod:`aphrodite_tpu_torch.fleet.replica` — per-replica bookkeeping:
  the polled health snapshot (the ``/health?probe=1`` fast path), the
  load score, circuit-breaker state, and rollout cordoning.
- :mod:`aphrodite_tpu_torch.fleet.router` — the async HTTP router:
  health-aware balancing on each replica's real overload snapshot,
  prefix-affinity routing (rendezvous hash with load-based spill),
  transparent bounded-backoff retry of requests rejected before any
  token streamed, circuit-breaking of DEAD replicas, and the
  zero-downtime ``POST /admin/rollout`` rolling deploy.
- :mod:`aphrodite_tpu_torch.fleet.launcher` — asyncio subprocess
  manager for real replica server processes (spawn, readiness, restart,
  chaos kill) used by the rollout hook and the fleet bench.
"""
from aphrodite_tpu_torch.fleet.replica import ReplicaHandle, ReplicaSnapshot
from aphrodite_tpu_torch.fleet.router import FleetRouter, RouterStats

__all__ = ["FleetRouter", "ReplicaHandle", "ReplicaSnapshot",
           "RouterStats"]
