"""Shared helpers for the aiohttp frontends: disconnect detection and
the engine lifecycle surface (health probe, graceful drain).

Every frontend (OpenAI/Kobold/Ooba) wires the SAME lifecycle pieces via
:func:`install_lifecycle`, so a load balancer can probe any of them for
DRAINING/REBUILDING/DEAD and an operator can roll any of them the same
way:

- ``GET /health`` — the supervisor's :class:`HealthReport` as JSON.
  200 while the replica serves (RUNNING/DEGRADED/REBUILDING included:
  a rebuilding engine will serve again, queued work is kept), 503 once
  it is DRAINING (with ``Retry-After``) or DEAD, so balancers eject it.
- ``POST /admin/drain`` — authed (``--admin-key``) graceful drain:
  moves the engine to DRAINING, new requests get 503 + Retry-After,
  in-flight requests run to completion under the drain deadline.
  Body: optional ``{"deadline_s": <float>}``.
- ``SIGTERM`` — same drain, then a clean process exit once the replica
  is idle (or the deadline force-aborts stragglers). A second SIGTERM
  exits immediately. This is the rolling-restart contract: deploy
  systems send SIGTERM and no accepted request is dropped.
"""
from __future__ import annotations

import asyncio
import datetime
import email.utils
import json
import math
import signal
from typing import List, Optional, Sequence

from aiohttp import web

from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)

#: Request header the fleet router sets on proxied token streams to
#: ask the frontend for journal records (see :class:`StreamJournal`).
JOURNAL_HEADER = "X-Aphrodite-Stream-Journal"
#: Request header carrying the admin key that authorizes the
#: continuation (resume) extension — deliberately separate from the
#: client-facing ``Authorization`` header, which is proxied verbatim.
RESUME_KEY_HEADER = "X-Aphrodite-Resume-Key"
#: Wire prefix of a journal record line. SSE clients ignore ":"
#: comment lines by spec, and the router strips them before any byte
#: reaches the client, so the records are invisible on every frontend
#: protocol (including Ooba's bare newline-delimited JSON).
JOURNAL_LINE_PREFIX = b": aphrodite-journal "

_SIGTERM_INSTALLED = web.AppKey("aphrodite_sigterm_installed", bool)
#: The in-flight SIGTERM drain task, retained on the app so it cannot
#: be garbage-collected mid-drain (a collected task silently stops
#: draining AND swallows its exception).
_DRAIN_TASK = web.AppKey("aphrodite_drain_task", object)


async def request_disconnected(request: web.Request) -> bool:
    """True when the client hung up (abort-on-disconnect checks)."""
    return request.transport is None or request.transport.is_closing()


def retry_after_seconds(seconds: float) -> int:
    """`Retry-After` wire value: whole seconds, at least 1. The ONE
    place the rounding rule lives — every frontend emits through it
    and the fleet router's parser assumes it."""
    return max(1, int(math.ceil(seconds)))


def retry_after_headers(seconds: float) -> dict:
    """`Retry-After` header dict (whole seconds, at least 1)."""
    return {"Retry-After": str(retry_after_seconds(seconds))}


def parse_retry_after(headers) -> Optional[float]:
    """Inverse of :func:`retry_after_headers`: the `Retry-After` value
    of a response header mapping as seconds, or None when absent or
    malformed. Both RFC 7231 wire forms parse: delta-seconds (what
    these frontends emit) and HTTP-date (an intermediate proxy can
    legally rewrite the header to one; it must not silently become
    "no hint"). The fleet router uses this to pace its retries."""
    raw = headers.get("Retry-After") if headers is not None else None
    if raw is None:
        return None
    text = str(raw).strip()
    try:
        return max(0.0, float(text))
    except ValueError:
        pass
    try:
        when = email.utils.parsedate_to_datetime(text)
    except (TypeError, ValueError):
        return None
    if when is None:
        return None
    if when.tzinfo is None:     # RFC 5322 "-0000": treat as UTC
        when = when.replace(tzinfo=datetime.timezone.utc)
    now = datetime.datetime.now(datetime.timezone.utc)
    return max(0.0, (when - now).total_seconds())


# --------------------------------------------------------------------
# Mid-stream failover: the journal / resume wire contract
# (router-internal — see README "Fleet · failover semantics").
#
# Journaled stream: when a request carries ``JOURNAL_HEADER``, the
# streaming handler precedes every token-bearing write with ONE
# journal record line::
#
#     : aphrodite-journal {"t":[<new ids>],"n":<joint count>[,"fin":r]}
#
# The router commits a record to its per-stream journal only once the
# record's data line was actually forwarded to the client, so the
# journal is exactly the set of tokens the client received.
#
# Continuation: on mid-stream replica death the router re-issues the
# ORIGINAL request body plus ``{"aphrodite_resume": {"emitted_token_ids":
# [...]}}`` (and ``RESUME_KEY_HEADER``) to a healthy peer; the handler
# rebuilds the request as a continuation (engine resume seam) and
# streams only the deltas past the resumed baseline.
# --------------------------------------------------------------------


class StreamJournal:
    """Per-stream journal-record emitter for a frontend's token
    stream. Tracks how many output tokens have been recorded so each
    :meth:`record` carries only the NEW ids (a resumed stream starts
    at its continuation baseline)."""

    def __init__(self, start: int = 0) -> None:
        self._sent = int(start)

    def record(self, token_ids: Sequence[int],
               finish_reason: Optional[str] = None) -> bytes:
        """The journal line to write immediately BEFORE the data
        chunk that delivers `token_ids[self._sent:]`."""
        new = [int(t) for t in token_ids[self._sent:]]
        self._sent = len(token_ids)
        rec = {"t": new, "n": self._sent}
        if finish_reason is not None:
            rec["fin"] = finish_reason
        return JOURNAL_LINE_PREFIX + json.dumps(
            rec, separators=(",", ":")).encode() + b"\n"


def stream_journal(request: web.Request,
                   resumed_tokens: int = 0) -> Optional[StreamJournal]:
    """A :class:`StreamJournal` when the request asked for one (the
    fleet router's ``JOURNAL_HEADER``), else None."""
    if request.headers.get(JOURNAL_HEADER, "") not in ("", "0"):
        return StreamJournal(start=resumed_tokens)
    return None


def resume_token_ids(body) -> Optional[List[int]]:
    """The continuation extension's emitted token ids from a parsed
    request body, or None when the body carries no extension. Raises
    ValueError on a malformed extension (the caller maps it to a 4xx
    — a garbled resume must never silently restart from scratch)."""
    if not isinstance(body, dict):
        return None
    ext = body.get("aphrodite_resume")
    if ext is None:
        return None
    ids = ext.get("emitted_token_ids") if isinstance(ext, dict) else None
    if not isinstance(ids, list) or \
            not all(isinstance(t, int) and not isinstance(t, bool)
                    for t in ids):
        raise ValueError(
            "aphrodite_resume must be "
            "{\"emitted_token_ids\": [<int>, ...]}")
    return list(ids)


def resume_denied(request: web.Request,
                  admin_keys: Optional[List[str]]
                  ) -> Optional[web.Response]:
    """Gate for the continuation extension: it is router-internal,
    never public — 403 when the server has no admin keys, 401 when
    the request's ``RESUME_KEY_HEADER`` does not match. None = allowed."""
    if not admin_keys:
        return web.json_response(
            {"detail": "stream resume is disabled: start the server "
                       "with --admin-key"}, status=403)
    key = request.headers.get(RESUME_KEY_HEADER, "").strip()
    if key not in admin_keys:
        return web.json_response({"detail": "invalid resume key"},
                                 status=401)
    return None


def probe_body(engine) -> dict:
    """The `GET /health?probe=1` fast path: lifecycle state + overload
    snapshot only — none of the full report's counters — so a router
    polling N replicas at a short interval stays cheap on both ends."""
    in_flight = engine.engine.has_unfinished_requests()
    try:
        overload = engine.engine.overload_snapshot().to_json()
    except RuntimeError:
        # Mid-rebuild the scheduler object is being swapped off-loop;
        # report one probe without a snapshot rather than 500.
        overload = None
    return {
        "state": engine.health.state(in_flight=in_flight).value,
        "draining": engine.health.is_draining,
        "inflight": engine.engine.get_num_unfinished_requests(),
        "overload": overload,
    }


async def health_response(engine, probe: bool = False) -> web.Response:
    """Serialize the engine's HealthReport with load-balancer-ready
    status codes (shared by all three frontends' /health routes).
    `probe=True` (the `?probe=1` query) serializes only lifecycle
    state + overload snapshot — same status-code contract, a fraction
    of the payload — for high-rate router polls."""
    from aphrodite_tpu_torch.engine.async_aphrodite import AsyncEngineDeadError
    if probe:
        body = probe_body(engine)
        if body["state"] == "DEAD":
            return web.json_response(body, status=503)
        if body["state"] == "DRAINING":
            rem = engine.health.drain_remaining_s
            return web.json_response(
                body, status=503,
                headers=retry_after_headers(
                    rem if rem is not None else 30))
        return web.json_response(body)
    try:
        report = await engine.check_health()
    except AsyncEngineDeadError as e:
        body = engine.health.report().to_json()
        body["state"] = "DEAD"
        body["error"] = str(e)
        return web.json_response(body, status=503)
    body = report.to_json()
    if report.state == "DRAINING":
        # 503 turns balancers away; Retry-After says when a
        # replacement replica should be taking the traffic.
        rem = engine.health.drain_remaining_s
        return web.json_response(
            body, status=503,
            headers=retry_after_headers(rem if rem is not None else 30))
    return web.json_response(body)


def _admin_drain_handler(engine, admin_keys: Optional[List[str]]):
    async def admin_drain(request: web.Request) -> web.Response:
        if not admin_keys:
            return web.json_response(
                {"detail": "admin drain is disabled: start the server "
                           "with --admin-key"}, status=403)
        token = request.headers.get("Authorization", "")\
            .removeprefix("Bearer ").strip()
        if token not in admin_keys:
            return web.json_response({"detail": "invalid admin key"},
                                     status=401)
        try:
            body = await request.json()
        except Exception:
            body = {}
        deadline_s = body.get("deadline_s")
        granted = engine.start_drain(
            float(deadline_s) if deadline_s is not None else None,
            reason="admin drain request")
        return web.json_response({"state": "DRAINING",
                                  "drain_deadline_s": granted})
    return admin_drain


def _raise_graceful_exit() -> None:
    # SystemExit-derived: propagates out of run_forever and shuts
    # web.run_app down through its normal cleanup path.
    raise web.GracefulExit()


async def _drain_then_exit(engine) -> None:
    engine.start_drain(reason="SIGTERM")
    clean = await engine.drained()
    logger.info("Drain %s; exiting.",
                "complete" if clean
                else "deadline-forced (stragglers got typed errors)")
    asyncio.get_running_loop().call_soon(_raise_graceful_exit)


def _log_drain_outcome(task: "asyncio.Task") -> None:
    """Done-callback for the SIGTERM drain task: a drain that dies
    mid-shutdown must be LOUD — the process is about to exit on the
    assumption that in-flight work was handled."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.error("SIGTERM drain task failed; in-flight requests "
                     "may not have drained cleanly: %s: %s",
                     type(exc).__name__, exc)


def install_lifecycle(app: web.Application, engine,
                      admin_keys: Optional[List[str]] = None) -> None:
    """Wire the shared lifecycle surface onto one frontend app:
    GET /health, the authed POST /admin/drain, and a SIGTERM handler
    that drains before exiting (see module docstring)."""

    async def health(request: web.Request) -> web.Response:
        probe = request.query.get("probe", "") not in ("", "0")
        return await health_response(engine, probe=probe)

    app.router.add_get("/health", health)
    app.router.add_post("/admin/drain",
                        _admin_drain_handler(engine, admin_keys))

    async def on_startup(started_app: web.Application) -> None:
        loop = asyncio.get_running_loop()

        def on_term() -> None:
            if engine.is_draining:
                logger.warning("Second SIGTERM: exiting immediately.")
                _raise_graceful_exit()
            logger.info("SIGTERM: draining before exit.")
            # Retain the task on the app (a bare create_task can be
            # GC'd mid-drain) and log — never swallow — its failure.
            task = loop.create_task(_drain_then_exit(engine))
            task.add_done_callback(_log_drain_outcome)
            started_app[_DRAIN_TASK] = task

        try:
            # Replaces aiohttp's default immediate-exit SIGTERM
            # binding with drain-then-exit.
            loop.add_signal_handler(signal.SIGTERM, on_term)
            started_app[_SIGTERM_INSTALLED] = True
        except (NotImplementedError, RuntimeError) as e:
            # Non-unix platform or a non-main-thread loop: drains are
            # still available via /admin/drain.
            logger.warning("SIGTERM drain handler unavailable: %s", e)

    async def on_cleanup(stopped_app: web.Application) -> None:
        if stopped_app.get(_SIGTERM_INSTALLED):
            asyncio.get_running_loop().remove_signal_handler(
                signal.SIGTERM)

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
