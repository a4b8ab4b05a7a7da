"""Prometheus metrics + periodic stdout throughput log.

Reference: `aphrodite/engine/metrics.py` (Metrics `:18`, Stats `:90`,
StatLogger `:110`); same metric names under the `aphrodite:` namespace so
existing Grafana dashboards (reference `examples/monitoring/`) work
unchanged.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List

from prometheus_client import Counter, Gauge, Histogram, REGISTRY

from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)

_LOCAL_LOGGING_INTERVAL_SEC = 5.0

_LATENCY_BUCKETS = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.2, 0.3,
    0.4, 0.5, 0.75, 1.0, 2.5
]


def _get_or_create(cls, name, documentation, labelnames=(), **kw):
    """Idempotent metric creation (tests build multiple engines)."""
    try:
        return cls(name, documentation, labelnames=labelnames, **kw)
    except ValueError:
        return REGISTRY._names_to_collectors[name]


class Metrics:

    def __init__(self, labelnames: List[str]):
        self.gauge_scheduler_running = _get_or_create(
            Gauge, "aphrodite:num_requests_running",
            "Number of requests currently running on TPU.", labelnames)
        self.gauge_scheduler_swapped = _get_or_create(
            Gauge, "aphrodite:num_requests_swapped",
            "Number of requests swapped to CPU.", labelnames)
        self.gauge_scheduler_waiting = _get_or_create(
            Gauge, "aphrodite:num_requests_waiting",
            "Number of requests waiting to be processed.", labelnames)
        self.gauge_gpu_cache_usage = _get_or_create(
            Gauge, "aphrodite:gpu_cache_usage_perc",
            "Device KV-cache usage. 1 means 100 percent usage.",
            labelnames)
        self.gauge_cpu_cache_usage = _get_or_create(
            Gauge, "aphrodite:cpu_cache_usage_perc",
            "CPU KV-cache usage. 1 means 100 percent usage.", labelnames)
        self.counter_prompt_tokens = _get_or_create(
            Counter, "aphrodite:prompt_tokens_total",
            "Number of prefill tokens processed.", labelnames)
        self.counter_generation_tokens = _get_or_create(
            Counter, "aphrodite:generation_tokens_total",
            "Number of generation tokens processed.", labelnames)
        self.histogram_time_to_first_token = _get_or_create(
            Histogram, "aphrodite:time_to_first_token_seconds",
            "Histogram of time to first token in seconds.", labelnames,
            buckets=_LATENCY_BUCKETS)
        self.histogram_time_per_output_token = _get_or_create(
            Histogram, "aphrodite:time_per_output_token_seconds",
            "Histogram of time per output token in seconds.", labelnames,
            buckets=_LATENCY_BUCKETS)
        self.histogram_e2e_request_latency = _get_or_create(
            Histogram, "aphrodite:e2e_request_latency_seconds",
            "Histogram of end to end request latency in seconds.",
            labelnames,
            buckets=[1.0, 2.5, 5.0, 10.0, 15.0, 20.0, 30.0, 40.0, 50.0,
                     60.0])
        # Overload-control gauges/counters (processing/admission.py):
        # the same numbers ride in the /health report so load
        # balancers can act on DEGRADED-while-shedding before DEAD.
        self.gauge_waiting_prefill_tokens = _get_or_create(
            Gauge, "aphrodite:queued_prefill_tokens",
            "Prefill tokens queued across the waiting queue.",
            labelnames)
        self.gauge_ewma_prefill = _get_or_create(
            Gauge, "aphrodite:ewma_prefill_tokens_per_s",
            "EWMA prefill throughput driving admission TTFT "
            "prediction.", labelnames)
        self.gauge_ewma_decode = _get_or_create(
            Gauge, "aphrodite:ewma_decode_tokens_per_s",
            "EWMA decode throughput.", labelnames)
        self.gauge_prefix_pinned = _get_or_create(
            Gauge, "aphrodite:prefix_pinned_pages",
            "KV pages pinned by the prefix cache (held on purpose; "
            "subtracted by the zero-leak accounting).", labelnames)
        self.counter_requests_shed = _get_or_create(
            Counter, "aphrodite:num_requests_shed",
            "Requests rejected at admission by overload control.",
            labelnames)
        self.counter_requests_expired = _get_or_create(
            Counter, "aphrodite:num_requests_expired",
            "Requests expired in the waiting queue past their TTFT "
            "deadline.", labelnames)
        # Lifecycle gauges/counters (engine/supervisor.py): drain and
        # reincarnation state, mirrored in the /health report so load
        # balancers and dashboards see the same numbers.
        self.gauge_engine_state = _get_or_create(
            Gauge, "aphrodite:engine_lifecycle_state",
            "Engine lifecycle state code (0=RUNNING 1=DEGRADED "
            "2=DRAINING 3=REBUILDING 4=DEAD).", labelnames)
        self.gauge_inflight = _get_or_create(
            Gauge, "aphrodite:num_requests_inflight",
            "Unfinished requests owned by the engine (waiting + "
            "prefilling + running + swapped).", labelnames)
        self.gauge_drain_remaining = _get_or_create(
            Gauge, "aphrodite:drain_deadline_remaining_seconds",
            "Seconds before a draining engine force-aborts in-flight "
            "work (-1 = no drain deadline ticking).", labelnames)
        self.counter_reincarnations = _get_or_create(
            Counter, "aphrodite:reincarnations_total",
            "Engine rebuilds (executor/KV teardown + restore) after "
            "FATAL step faults.", labelnames)
        self.counter_requests_restored = _get_or_create(
            Counter, "aphrodite:requests_restored_total",
            "Requests restored into the waiting queue across engine "
            "rebuilds.", labelnames)
        self.counter_requests_lost = _get_or_create(
            Counter, "aphrodite:requests_lost_on_rebuild_total",
            "Requests an engine rebuild could not restore (typed "
            "errors delivered to their streams).", labelnames)


@dataclass
class Stats:
    """Snapshot of engine state for one logging tick."""
    now: float
    num_running: int
    num_waiting: int
    num_swapped: int
    gpu_cache_usage: float
    cpu_cache_usage: float
    num_prompt_tokens: int
    num_generation_tokens: int
    time_to_first_tokens: List[float]
    time_per_output_tokens: List[float]
    time_e2e_requests: List[float]
    # Overload-control snapshot (cumulative counters; the logger
    # tracks deltas for the Prometheus counters).
    num_waiting_tokens: int = 0
    prefix_pinned_pages: int = 0
    sheds_total: int = 0
    expired_total: int = 0
    ewma_prefill_tok_s: float = 0.0
    ewma_decode_tok_s: float = 0.0
    # Lifecycle snapshot (provided by the async wrapper's
    # lifecycle_source; cumulative counters get delta-exported).
    state_code: int = 0
    inflight: int = 0
    drain_remaining_s: float = -1.0
    reincarnations_total: int = 0
    restored_total: int = 0
    lost_total: int = 0


class StatLogger:
    """Aggregates across steps; logs locally every 5 s; drives Prometheus."""

    def __init__(self, local_interval: float = _LOCAL_LOGGING_INTERVAL_SEC,
                 labels: Dict[str, str] = None) -> None:
        self.last_local_log = time.monotonic()
        self.local_interval = local_interval
        self.labels = labels or {}
        self.num_prompt_tokens: List[int] = []
        self.num_generation_tokens: List[int] = []
        # Cumulative counts already exported, for counter deltas.
        self._sheds_exported = 0
        self._expired_exported = 0
        self._reinc_exported = 0
        self._restored_exported = 0
        self._lost_exported = 0
        self.metrics = Metrics(labelnames=list(self.labels.keys()))

    def _throughput(self, tracked: List[int], now: float) -> float:
        elapsed = now - self.last_local_log
        return sum(tracked) / elapsed if elapsed > 0 else 0.0

    def log(self, stats: Stats) -> None:
        m = self.metrics
        labeled = (lambda metric: metric.labels(**self.labels)) \
            if self.labels else (lambda metric: metric)
        labeled(m.gauge_scheduler_running).set(stats.num_running)
        labeled(m.gauge_scheduler_swapped).set(stats.num_swapped)
        labeled(m.gauge_scheduler_waiting).set(stats.num_waiting)
        labeled(m.gauge_gpu_cache_usage).set(stats.gpu_cache_usage)
        labeled(m.gauge_cpu_cache_usage).set(stats.cpu_cache_usage)
        labeled(m.counter_prompt_tokens).inc(stats.num_prompt_tokens)
        labeled(m.counter_generation_tokens).inc(
            stats.num_generation_tokens)
        labeled(m.gauge_waiting_prefill_tokens).set(
            stats.num_waiting_tokens)
        labeled(m.gauge_prefix_pinned).set(stats.prefix_pinned_pages)
        labeled(m.gauge_ewma_prefill).set(stats.ewma_prefill_tok_s)
        labeled(m.gauge_ewma_decode).set(stats.ewma_decode_tok_s)
        labeled(m.counter_requests_shed).inc(
            max(0, stats.sheds_total - self._sheds_exported))
        self._sheds_exported = max(self._sheds_exported,
                                   stats.sheds_total)
        labeled(m.counter_requests_expired).inc(
            max(0, stats.expired_total - self._expired_exported))
        self._expired_exported = max(self._expired_exported,
                                     stats.expired_total)
        labeled(m.gauge_engine_state).set(stats.state_code)
        labeled(m.gauge_inflight).set(stats.inflight)
        labeled(m.gauge_drain_remaining).set(stats.drain_remaining_s)
        labeled(m.counter_reincarnations).inc(
            max(0, stats.reincarnations_total - self._reinc_exported))
        self._reinc_exported = max(self._reinc_exported,
                                   stats.reincarnations_total)
        labeled(m.counter_requests_restored).inc(
            max(0, stats.restored_total - self._restored_exported))
        self._restored_exported = max(self._restored_exported,
                                      stats.restored_total)
        labeled(m.counter_requests_lost).inc(
            max(0, stats.lost_total - self._lost_exported))
        self._lost_exported = max(self._lost_exported,
                                  stats.lost_total)
        for t in stats.time_to_first_tokens:
            labeled(m.histogram_time_to_first_token).observe(t)
        for t in stats.time_per_output_tokens:
            labeled(m.histogram_time_per_output_token).observe(t)
        for t in stats.time_e2e_requests:
            labeled(m.histogram_e2e_request_latency).observe(t)

        self.num_prompt_tokens.append(stats.num_prompt_tokens)
        self.num_generation_tokens.append(stats.num_generation_tokens)

        now = time.monotonic()
        if now - self.last_local_log >= self.local_interval:
            prompt_tps = self._throughput(self.num_prompt_tokens, now)
            gen_tps = self._throughput(self.num_generation_tokens, now)
            logger.info(
                "Avg prompt throughput: %.1f tokens/s, Avg generation "
                "throughput: %.1f tokens/s, Running: %d reqs, Swapped: "
                "%d reqs, Pending: %d reqs, device KV cache usage: %.1f%%, "
                "host KV cache usage: %.1f%%",
                prompt_tps, gen_tps, stats.num_running, stats.num_swapped,
                stats.num_waiting, stats.gpu_cache_usage * 100,
                stats.cpu_cache_usage * 100)
            self.num_prompt_tokens = []
            self.num_generation_tokens = []
            self.last_local_log = now
