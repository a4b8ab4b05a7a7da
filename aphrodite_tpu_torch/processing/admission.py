"""Overload control: deadline-aware admission and load shedding.

Under genuine overload an unbounded queue produces the classic
goodput-collapse shape: every request eventually misses its deadline
instead of most requests meeting it (SERVING_r05: 84% of offered
tokens served at rate 8.0, and it only degrades from there). The fix
is to shed work we cannot finish in time AT ADMISSION — cheaply,
predictably, and before it touches the tracker or the allocator:

- **Hard caps**: queued prefill tokens (`APHRODITE_MAX_WAITING_TOKENS`)
  and waiting-queue depth (`APHRODITE_MAX_QUEUE_DEPTH`) bound the
  promise backlog regardless of deadlines. 0 means "derived": 8 full
  prefill rounds of tokens / 16x max_num_seqs entries — deep enough
  that no sane TTFT target survives past them anyway.
- **Deadline-aware shedding**: an EWMA of recent prefill throughput
  predicts the TTFT a new arrival would see behind the current
  backlog; a request whose predicted TTFT already exceeds its
  deadline (`SamplingParams.ttft_slo_s`, default
  `APHRODITE_DEFAULT_TTFT_SLO_S`) is rejected immediately with a
  `Retry-After` estimate instead of queueing to death.
- **Queue-side expiry**: requests that were admitted but miss their
  deadline while still sitting in `waiting` (never computed — the
  abort is free) are expired by the scheduler and surface a typed
  :class:`RequestTimeoutError` on their stream.

Rejected requests raise :class:`RequestRejectedError` (HTTP 429 +
``Retry-After`` at the OpenAI/Kobold frontends); shedding flips the
health state machine to DEGRADED so load balancers can act
before the replica is DEAD.

This module imports only ``common`` pieces (no engine/scheduler
imports) so the endpoints, the async wrapper, and the sync engine can
all use it without cycles.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)

#: EWMA smoothing factor for the throughput estimators (per update,
#: updates are rate-limited to _MIN_OBSERVE_DT_S so pipelined rounds
#: don't each contribute a near-zero-dt spike).
_EWMA_ALPHA = 0.25

#: Minimum wall-time between EWMA updates; rounds inside the window
#: accumulate their token counts into the next update.
_MIN_OBSERVE_DT_S = 0.1

#: A window longer than this is an idle gap (the loop only steps while
#: requests exist): rates computed over it would wildly underestimate,
#: so the window restarts instead.
_MAX_OBSERVE_GAP_S = 2.0

#: Retry-After clamp: never tell a client "now" (it would immediately
#: re-offer the load we just shed) and never more than a minute (the
#: estimate is an EWMA projection, not a reservation).
_RETRY_AFTER_MIN_S = 0.5
_RETRY_AFTER_MAX_S = 60.0


class RequestRejectedError(RuntimeError):
    """The admission controller shed this request at arrival.

    `retry_after_s` is the controller's estimate of when re-offering
    the request has a chance of being admitted (serialized as the
    HTTP `Retry-After` header by the frontends). The request never
    touched the tracker or the allocator — rejection is O(queue
    inspection), no KV pages move.
    """

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class RequestTimeoutError(RuntimeError):
    """An admitted request missed its TTFT deadline while still in
    the waiting queue (it was never computed, so the abort was free).
    Surfaced typed on the request's `AsyncStream`."""


class EngineDrainingError(RuntimeError):
    """The replica is draining for shutdown (SIGTERM / admin drain):
    new work is rejected so a rolling restart can complete. Distinct
    from :class:`RequestRejectedError` on purpose — the frontends map
    draining to HTTP 503 (route to another replica) and overload to
    429 (back off and retry here), and the two must never blur.

    Also delivered mid-stream to in-flight requests the drain deadline
    force-aborted. `retry_after_s` estimates when a replacement
    replica should be taking traffic.
    """

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def _clamp_retry(value: float) -> float:
    return max(_RETRY_AFTER_MIN_S, min(_RETRY_AFTER_MAX_S, value))


@dataclasses.dataclass
class AdmissionSnapshot:
    """One /health-report view of the overload controller (the
    engine/metrics.py rider serializes this into the report and the
    Prometheus gauges)."""
    queue_depth: int
    waiting_prefill_tokens: int
    sheds_total: int
    expired_total: int
    ewma_prefill_tok_s: float
    ewma_decode_tok_s: float
    # Pages pinned by the prefix cache: held on purpose, not leaked —
    # dashboards and the bench's zero-leak check subtract them from
    # the free-page delta instead of fuzzing the invariant.
    prefix_pinned_pages: int = 0

    def to_json(self) -> Dict[str, Any]:
        body = dataclasses.asdict(self)
        body["ewma_prefill_tok_s"] = round(self.ewma_prefill_tok_s, 1)
        body["ewma_decode_tok_s"] = round(self.ewma_decode_tok_s, 1)
        return body


class AdmissionController:
    """Bounded admission with deadline-aware load shedding.

    The controller owns only its own counters and throughput EWMAs;
    queue state (depth, queued prefill tokens) is passed in per
    decision by the engine, which reads it off the scheduler. All
    methods are cheap and lock-free: the async frontend calls
    :meth:`admit_or_raise` on the event loop while the engine step
    mutates queues off-loop, and the worst a stale read costs is one
    borderline admission either way.
    """

    def __init__(self) -> None:
        self._ewma_prefill_tok_s = 0.0
        self._ewma_decode_tok_s = 0.0
        self._acc_prefill_tokens = 0
        self._acc_decode_tokens = 0
        self._last_observe: Optional[float] = None
        self.sheds_total = 0
        self.expired_total = 0

    # -- throughput observation (called by the engine per round) -----

    def observe_round(self, prefill_tokens: int, decode_tokens: int,
                      now: Optional[float] = None) -> None:
        """Fold one processed round's token counts into the EWMAs.

        Token counts accumulate until `_MIN_OBSERVE_DT_S` wall time
        has passed (pipelined builder rounds land microseconds apart;
        per-round instantaneous rates would be meaningless spikes).
        Idle gaps do not decay the estimate: the EWMA answers "how
        fast do we prefill when we are prefilling", which is the rate
        a queued arrival will actually experience under load.
        """
        if now is None:
            now = time.monotonic()
        self._acc_prefill_tokens += max(0, prefill_tokens)
        self._acc_decode_tokens += max(0, decode_tokens)
        if self._last_observe is None:
            self._last_observe = now
            return
        dt = now - self._last_observe
        if dt < _MIN_OBSERVE_DT_S:
            return
        if dt > _MAX_OBSERVE_GAP_S:
            # Idle gap: restart the window, carrying the just-run
            # round's tokens into it (they were produced now, not
            # spread over the gap).
            self._last_observe = now
            return
        if self._acc_prefill_tokens > 0:
            rate = self._acc_prefill_tokens / dt
            self._ewma_prefill_tok_s = rate if \
                self._ewma_prefill_tok_s <= 0 else (
                    _EWMA_ALPHA * rate +
                    (1 - _EWMA_ALPHA) * self._ewma_prefill_tok_s)
        if self._acc_decode_tokens > 0:
            rate = self._acc_decode_tokens / dt
            self._ewma_decode_tok_s = rate if \
                self._ewma_decode_tok_s <= 0 else (
                    _EWMA_ALPHA * rate +
                    (1 - _EWMA_ALPHA) * self._ewma_decode_tok_s)
        self._acc_prefill_tokens = 0
        self._acc_decode_tokens = 0
        self._last_observe = now

    @property
    def ewma_prefill_tok_s(self) -> float:
        return self._ewma_prefill_tok_s

    @property
    def ewma_decode_tok_s(self) -> float:
        return self._ewma_decode_tok_s

    def predicted_ttft_s(self, queued_tokens: int,
                         own_tokens: int) -> Optional[float]:
        """Predicted TTFT for a new arrival: the whole queued prefill
        backlog plus its own prompt, at the EWMA prefill rate. None
        while the estimator is cold (never reject on a guess we
        don't have)."""
        if self._ewma_prefill_tok_s <= 0:
            return None
        return (queued_tokens + own_tokens) / self._ewma_prefill_tok_s

    # -- the decision ------------------------------------------------

    def admit_or_raise(self, *, num_tokens: int,
                       deadline_s: Optional[float],
                       queue_depth: int, queued_tokens: int,
                       max_depth: int, max_tokens: int) -> None:
        """Admit (return) or shed (raise RequestRejectedError).

        Ordering is cheapest-check-first: queue depth (O(1)), queued
        tokens (already computed by the caller), then the EWMA
        deadline prediction. A rejection increments `sheds_total` —
        the caller flips health to DEGRADED-while-shedding.
        """
        if max_depth > 0 and queue_depth >= max_depth:
            self._shed()
            raise RequestRejectedError(
                f"server overloaded: waiting queue is full "
                f"({queue_depth} >= APHRODITE_MAX_QUEUE_DEPTH="
                f"{max_depth}); retry later",
                retry_after_s=self._drain_estimate(queued_tokens))
        if max_tokens > 0 and queued_tokens + num_tokens > max_tokens:
            self._shed()
            raise RequestRejectedError(
                f"server overloaded: queued prefill backlog "
                f"({queued_tokens} + {num_tokens} tokens) exceeds "
                f"APHRODITE_MAX_WAITING_TOKENS={max_tokens}; "
                "retry later",
                retry_after_s=self._drain_estimate(
                    queued_tokens + num_tokens - max_tokens))
        if deadline_s is not None and deadline_s > 0:
            predicted = self.predicted_ttft_s(queued_tokens, num_tokens)
            if predicted is not None and predicted > deadline_s:
                self._shed()
                raise RequestRejectedError(
                    f"server overloaded: predicted TTFT "
                    f"{predicted:.2f}s already exceeds the request's "
                    f"{deadline_s:.2f}s deadline; retry later",
                    retry_after_s=_clamp_retry(predicted - deadline_s))

    def _drain_estimate(self, excess_tokens: int) -> float:
        """Seconds until `excess_tokens` of backlog drain at the EWMA
        prefill rate (1 s flat while the estimator is cold)."""
        if self._ewma_prefill_tok_s <= 0:
            return 1.0
        return _clamp_retry(excess_tokens / self._ewma_prefill_tok_s)

    def _shed(self) -> None:
        self.sheds_total += 1

    def record_expired(self, n: int = 1) -> None:
        """Count deadline expiries the scheduler performed in
        `waiting` (queue-side shedding of already-admitted work)."""
        self.expired_total += n

    # -- reporting ---------------------------------------------------

    def snapshot(self, queue_depth: int, waiting_tokens: int,
                 prefix_pinned_pages: int = 0) -> AdmissionSnapshot:
        return AdmissionSnapshot(
            queue_depth=queue_depth,
            waiting_prefill_tokens=waiting_tokens,
            sheds_total=self.sheds_total,
            expired_total=self.expired_total,
            ewma_prefill_tok_s=self._ewma_prefill_tok_s,
            ewma_decode_tok_s=self._ewma_decode_tok_s,
            prefix_pinned_pages=prefix_pinned_pages)
