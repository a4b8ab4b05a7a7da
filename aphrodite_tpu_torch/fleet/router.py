"""Health-aware fleet router: N engine replicas behind one endpoint
(port of `aphrodite_tpu/fleet/router.py`, copied with its import paths
rewritten).

The router is pure event-loop code (aiohttp server + client, no step
thread) composing four behaviors:

1. **Health-aware balancing.** A poll loop samples every replica's
   ``GET /health?probe=1`` fast path (lifecycle state + overload
   snapshot) every ``APHRODITE_ROUTER_POLL_S`` seconds. Requests go
   to the replica with the lowest load score (backlog depth plus
   predicted prefill wait from the replica's own throughput EWMA) —
   the same signal single-replica admission sheds on. Snapshots
   older than 4 poll intervals are STALE: the router stops trusting
   their load numbers and falls back to round-robin over
   non-circuit-broken replicas rather than black-holing the fleet on
   a slow poll.

2. **Prefix affinity.** Requests carrying a prompt prefix (or an
   explicit ``X-Aphrodite-Session`` header) are rendezvous-hashed to
   a preferred replica so multi-turn sessions keep hitting the
   replica that holds their prefix pool — the per-process prefix
   cache becomes a fleet-level hit-rate multiplier. Affinity spills
   to the least-loaded replica when the preferred one's load exceeds
   the fleet minimum by ``APHRODITE_ROUTER_SPILL`` (a prefix hit is
   worth a bounded imbalance, not an unbounded one).

3. **Transparent retry + circuit breaking.** A request rejected
   BEFORE any token reached the client — 503 from a draining
   replica, connection refused/reset, a replica 5xx — is retried on
   a different replica with bounded exponential backoff
   (``APHRODITE_ROUTER_RETRIES`` / ``APHRODITE_ROUTER_BACKOFF_S``),
   total time capped by the request's ``ttft_slo_s``. The retry is
   idempotent by construction: rejection happens before any tokens
   stream (the client response is not even prepared until the first
   upstream chunk arrives). Replicas that fail at the connection
   level (or report DEAD) are circuit-broken out of rotation for
   ``APHRODITE_ROUTER_CB_WINDOW_S`` and re-admitted when their
   ``/health`` recovers.

3b. **Mid-stream failover (journal + splice).** Once streaming has
   begun a plain re-issue is forbidden (it would double-bill tokens
   or splice two different generations) — so generation streams are
   JOURNALED instead: the router asks the replica for interleaved
   journal records (one ``: aphrodite-journal {...}`` comment line
   per token-bearing chunk, stripped before any byte reaches the
   client) and commits each record only once its data chunk was
   actually forwarded, making the journal exactly the set of tokens
   the client received. When the upstream dies mid-stream, the
   router re-issues the ORIGINAL request plus the admin-key-gated
   ``aphrodite_resume`` continuation extension to a healthy peer;
   the peer rebuilds the context through chunked prefill (seeded
   sampling continues bit-identically — the per-row PRNG salt is the
   output position) and the router splices the new stream into the
   client response EXACTLY ONCE, deduping on emitted count. Bounds:
   ``APHRODITE_ROUTER_JOURNAL_TOKENS`` per stream and
   ``APHRODITE_ROUTER_JOURNAL_STREAMS`` fleet-wide; past either (or
   past the retry budget) the stream falls back to today's truthful
   truncation, counted in ``truncated_client_streams``.

4. **Zero-downtime rolling deploy.** Authed ``POST /admin/rollout``
   walks the fleet one replica at a time: cordon (no new picks) →
   ``POST /admin/drain`` on the replica → wait for its in-flight
   count to hit zero → restart it (the launcher-provided
   ``restart_cb``) → wait for ``/health`` to report a routable state
   again → uncordon. The rest of the fleet keeps serving throughout;
   requests that race a drain are retried transparently by (3).

Router-local surface: ``GET /health`` (fleet aggregate),
``GET /fleet/stats`` (counters + per-replica state),
``POST /admin/rollout``. Everything else (``/v1/*``, ``/metrics``,
...) is proxied; ``/admin/*`` is deliberately NOT proxied — replica
admin surfaces are reached directly or via the rollout.
"""
from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import aiohttp
from aiohttp import web

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.endpoints.utils import (JOURNAL_HEADER,
                                                 JOURNAL_LINE_PREFIX,
                                                 RESUME_KEY_HEADER,
                                                 parse_retry_after,
                                                 retry_after_headers)
from aphrodite_tpu_torch.fleet.replica import (ROUTABLE_STATES, ReplicaHandle,
                                               ReplicaSnapshot)

logger = init_logger(__name__)

#: Per-attempt connection timeout. Request TOTAL time is unbounded —
#: generations stream for as long as they stream.
CONNECT_TIMEOUT_S = 5.0

#: Headers never forwarded in either direction (hop-by-hop, or owned
#: by the HTTP stack on each hop).
_HOP_HEADERS = frozenset({
    "connection", "keep-alive", "transfer-encoding", "te", "upgrade",
    "proxy-authorization", "proxy-authenticate", "host",
    "content-length",
})

#: Upstream statuses the router treats as "this replica cannot take
#: the request right now" — retry on a peer when nothing has been
#: sent to the client yet. 503 is the draining/fleet signal and
#: additionally carries Retry-After; the rest mark replica failure.
_RETRYABLE_STATUSES = frozenset({500, 502, 503, 504})


@dataclasses.dataclass
class RouterStats:
    """Event-loop-owned counters; serialized by GET /fleet/stats."""
    requests_total: int = 0
    picks_load: int = 0
    picks_affinity_keyed: int = 0
    affinity_hits: int = 0
    affinity_spills: int = 0
    picks_rebuilding: int = 0
    picks_stale_fallback: int = 0
    retries_conn: int = 0
    retries_503: int = 0
    retries_5xx: int = 0
    served_streaming: int = 0
    served_buffered: int = 0
    failed_mid_stream: int = 0
    resumed_mid_stream: int = 0
    truncated_client_streams: int = 0
    rejected_no_replica: int = 0
    exhausted_relayed: int = 0
    rollouts_total: int = 0

    @property
    def retries_total(self) -> int:
        return self.retries_conn + self.retries_503 + self.retries_5xx

    def affinity_hit_rate(self) -> Optional[float]:
        if self.picks_affinity_keyed == 0:
            return None
        return self.affinity_hits / self.picks_affinity_keyed

    def to_json(self) -> Dict[str, Any]:
        body = dataclasses.asdict(self)
        body["retries_total"] = self.retries_total
        rate = self.affinity_hit_rate()
        body["affinity_hit_rate"] = (round(rate, 4)
                                     if rate is not None else None)
        return body


@dataclasses.dataclass
class _Attempt:
    """Outcome of one proxied attempt: a final client response, or a
    retryable failure (optionally carrying the upstream's status/body
    for a truthful relay if the budget runs out)."""
    response: Optional[web.StreamResponse] = None
    retry_after_s: Optional[float] = None
    relay_status: Optional[int] = None
    relay_body: bytes = b""
    relay_headers: Optional[Dict[str, str]] = None
    kind: str = "final"          # "final" | "conn" | "503" | "5xx"


def _rendezvous_score(key: str, name: str) -> int:
    digest = hashlib.blake2b(f"{key}\x00{name}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big")


#: Proxied paths whose streamed responses are token streams the
#: router journals for mid-stream failover (OpenAI completions/chat,
#: Kobold's SSE stream, Ooba's newline-JSON stream).
_GENERATION_PATHS = frozenset({
    "/v1/completions", "/v1/chat/completions",
    "/api/extra/generate/stream",
    "/api/v1/generate", "/api/latest/generate",
})


@dataclasses.dataclass
class _JournalContext:
    """Everything a mid-stream failover needs to re-issue a request
    as a continuation: the parsed original body, the target path, the
    affinity key, and the per-stream token bound."""
    body: Dict[str, Any]
    rel_url: str
    key: Optional[str]
    max_tokens: int


class _JournalTail:
    """Router-side journal state + line parser for one proxied token
    stream.

    Splits the upstream byte stream into complete lines, siphons off
    ``: aphrodite-journal`` records, and returns everything else for
    verbatim forwarding. A record is COMMITTED (its token ids join
    the journal) only when its data line is actually forwarded, so
    ``tokens`` is exactly what the client received — the state a
    continuation resumes from. Partial trailing lines are held back:
    a mid-line death never leaks a torn event to the client, and the
    regenerated token re-emits the event whole.

    Exactly-once dedupe: a record whose cumulative count ``n`` is not
    past the committed journal re-delivers tokens the client already
    has (a replayed continuation); its data lines are suppressed.
    """

    def __init__(self, max_tokens: int) -> None:
        # bounded-by: max_tokens (APHRODITE_ROUTER_JOURNAL_TOKENS);
        # overflow flips `overflowed` and journaling stops.
        self.tokens: List[int] = []
        self.fin: Optional[str] = None
        self.active = False          # >=1 committed record seen
        self.overflowed = False
        self.max_tokens = max_tokens
        self._pending: Optional[Dict[str, Any]] = None
        self._buf = b""
        self._suppress = False

    def feed(self, chunk: bytes) -> bytes:
        self._buf += chunk
        out = bytearray()
        while True:
            cut = self._buf.find(b"\n")
            if cut < 0:
                break
            line, self._buf = self._buf[:cut + 1], self._buf[cut + 1:]
            if line.startswith(JOURNAL_LINE_PREFIX):
                self._on_record(line)
                continue
            if self._suppress and line.strip():
                continue            # already delivered before failover
            out += line
            stripped = line.lstrip()
            if self._pending is not None and (
                    stripped.startswith(b"data:")
                    or stripped.startswith(b"{")):
                self._commit(self._pending)
                self._pending = None
        return bytes(out)

    def flush(self) -> bytes:
        """Any held-back tail (clean EOF without a final newline)."""
        tail, self._buf = self._buf, b""
        return tail if not self._suppress else b""

    def _on_record(self, line: bytes) -> None:
        try:
            rec = json.loads(line[len(JOURNAL_LINE_PREFIX):])
        except ValueError:
            return                  # malformed record: ignore
        if not isinstance(rec, dict):
            return
        if rec.get("t") and int(rec.get("n", 0)) <= len(self.tokens):
            # Replayed tokens (the continuation overlapped the
            # journal): drop their data lines — exactly-once splice.
            self._suppress = True
            self._pending = None
            return
        self._suppress = False
        self._pending = rec

    def _commit(self, rec: Dict[str, Any]) -> None:
        self.active = True
        try:
            self.tokens.extend(int(t) for t in rec.get("t") or ())
        except (TypeError, ValueError):
            pass
        if rec.get("fin"):
            self.fin = str(rec["fin"])
        if len(self.tokens) > self.max_tokens:
            self.overflowed = True


class FleetRouter:
    """Async HTTP router over N replica servers. Single-event-loop
    object: construct, ``await start()``, serve ``build_app()``."""

    def __init__(self, replicas: Sequence,
                 admin_keys: Optional[List[str]] = None,
                 restart_cb=None,
                 prefix_key_chars: int = 256,
                 prefix_key_tokens: int = 64,
                 name: Optional[str] = None) -> None:
        self._replicas: List[ReplicaHandle] = [
            r if isinstance(r, ReplicaHandle) else ReplicaHandle(r)
            for r in replicas]
        self._admin_keys = admin_keys
        #: async callable(replica) that restarts the replica's server
        #: process (provided by the launcher); rollouts without one
        #: rely on an external supervisor to restart after drain.
        self._restart_cb = restart_cb
        self._prefix_key_chars = prefix_key_chars
        self._prefix_key_tokens = prefix_key_tokens
        #: Router identity for the deterministic poll phase offsets
        #: (two routers with different names probe a given replica at
        #: different points of the poll interval).
        self._name = name or f"router-{os.getpid()}"
        self.stats = RouterStats()
        self._session: Optional[aiohttp.ClientSession] = None
        # bounded-by: one poll task per replica, created once in
        # start() and cancelled in stop()
        self._poll_tasks: List[asyncio.Task] = []
        #: Streams currently carrying a journal, capped fleet-wide by
        #: APHRODITE_ROUTER_JOURNAL_STREAMS.
        self._journals_active = 0
        self._closed = False
        self._rollout_lock = asyncio.Lock()

    @property
    def replicas(self) -> List[ReplicaHandle]:
        return list(self._replicas)

    # -- lifecycle ----------------------------------------------------

    async def start(self) -> None:
        if self._session is None:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(
                    total=None, sock_connect=CONNECT_TIMEOUT_S))
        loop = asyncio.get_running_loop()
        for replica in self._replicas:
            task = loop.create_task(self._poll_replica_loop(replica))
            task.add_done_callback(_log_poll_exit)
            self._poll_tasks.append(task)

    async def stop(self) -> None:
        self._closed = True
        tasks, self._poll_tasks = self._poll_tasks, []
        for task in tasks:
            task.cancel()
        if tasks:
            # gather(return_exceptions) swallows the CancelledError we
            # caused without an except clause that could mask others.
            await asyncio.gather(*tasks, return_exceptions=True)
        session = self._session
        self._session = None
        if session is not None:
            await session.close()

    # -- health polling ----------------------------------------------

    async def _probe(self, replica: ReplicaHandle
                     ) -> Optional[Dict[str, Any]]:
        """One /health?probe=1 sample; None on any transport failure
        (the 503-DRAINING/DEAD probe BODY still parses — status codes
        are for dumb balancers, the router reads the state field)."""
        try:
            async with self._session.get(
                    replica.url + "/health", params={"probe": "1"},
                    timeout=aiohttp.ClientTimeout(
                        total=CONNECT_TIMEOUT_S)) as resp:
                return await resp.json()
        except (aiohttp.ClientError, asyncio.TimeoutError,
                ValueError):
            return None

    async def _poll_once(self) -> None:
        """Probe every replica NOW (rollout readiness, tests); the
        background cadence lives in the per-replica loops."""
        cb_window = flags.get_float("APHRODITE_ROUTER_CB_WINDOW_S")
        bodies = await asyncio.gather(
            *(self._probe(r) for r in self._replicas))
        for replica, body in zip(self._replicas, bodies):
            self._record_probe(replica, body, cb_window)

    @staticmethod
    def _record_probe(replica: ReplicaHandle,
                      body: Optional[Dict[str, Any]],
                      cb_window: float) -> None:
        if body is None:
            replica.record_failure(cb_window)
        else:
            replica.record_health(
                ReplicaSnapshot.from_probe(body), cb_window)

    def poll_phase(self, replica: ReplicaHandle) -> float:
        """Deterministic per-(router, replica) phase offset in [0, 1)
        poll intervals. N routers polling M replicas each probe at a
        different point of the interval instead of firing a
        synchronized ``/health?probe=1`` storm at every tick — same
        aggregate rate, no thundering herd on any replica."""
        return (_rendezvous_score(self._name, replica.name)
                % 4096) / 4096.0

    async def _poll_replica_loop(self, replica: ReplicaHandle) -> None:
        """One replica's health-poll cadence: fire at this replica's
        deterministic phase offset within each poll interval."""
        await asyncio.sleep(
            self.poll_phase(replica) *
            flags.get_float("APHRODITE_ROUTER_POLL_S"))
        while not self._closed:
            try:
                cb_window = flags.get_float(
                    "APHRODITE_ROUTER_CB_WINDOW_S")
                self._record_probe(replica, await self._probe(replica),
                                   cb_window)
            except Exception as e:
                logger.warning("fleet health poll of %s failed: %s: %s",
                               replica.name, type(e).__name__, e)
            await asyncio.sleep(
                flags.get_float("APHRODITE_ROUTER_POLL_S"))

    # -- replica selection -------------------------------------------

    def pick(self, key: Optional[str] = None,
             exclude: Iterable[ReplicaHandle] = ()
             ) -> Optional[ReplicaHandle]:
        """Choose a replica for one request (or retry attempt).

        Fresh routable snapshots are load-scored (with prefix
        affinity + spill when `key` is given); fresh REBUILDING
        replicas are a second choice (they will serve again — queued
        work is kept); stale/never-polled replicas are the
        staleness-aware fallback, picked round-robin. Cordoned and
        circuit-broken replicas are never picked."""
        now = time.monotonic()
        poll_s = flags.get_float("APHRODITE_ROUTER_POLL_S")
        excluded = set(id(r) for r in exclude)
        cands = [r for r in self._replicas
                 if id(r) not in excluded and not r.cordoned
                 and not r.circuit_broken(now)]
        fresh = [r for r in cands if not r.is_stale(poll_s, now)]
        routable = [r for r in fresh
                    if r.snapshot.state in ROUTABLE_STATES]
        if routable:
            return self._pick_scored(routable, key)
        rebuilding = [r for r in fresh
                      if r.snapshot.state == "REBUILDING"]
        if rebuilding:
            chosen = min(rebuilding, key=lambda r: r.picks)
            self.stats.picks_rebuilding += 1
            chosen.picks += 1
            return chosen
        stale = [r for r in cands if r.is_stale(poll_s, now)]
        if stale:
            chosen = min(stale, key=lambda r: r.picks)
            self.stats.picks_stale_fallback += 1
            chosen.picks += 1
            return chosen
        return None

    def _pick_scored(self, routable: List[ReplicaHandle],
                     key: Optional[str]) -> ReplicaHandle:
        scores = {id(r): r.snapshot.load_score() for r in routable}
        floor = min(scores.values())
        if key is not None:
            self.stats.picks_affinity_keyed += 1
            preferred = max(
                routable,
                key=lambda r: _rendezvous_score(key, r.name))
            spill = flags.get_float("APHRODITE_ROUTER_SPILL")
            if scores[id(preferred)] - floor <= spill:
                self.stats.affinity_hits += 1
                preferred.picks += 1
                return preferred
            self.stats.affinity_spills += 1
        chosen = min(routable,
                     key=lambda r: (scores[id(r)], r.picks))
        self.stats.picks_load += 1
        chosen.picks += 1
        return chosen

    # -- affinity keys -----------------------------------------------

    def affinity_key(self, headers, body_json) -> Optional[str]:
        """The prefix key a request hashes on: an explicit
        ``X-Aphrodite-Session`` header wins; otherwise the leading
        slice of the prompt (chars for text, ids for token prompts,
        the first message for chat) — multi-turn continuations share
        their beginning, so they share a key."""
        explicit = headers.get("X-Aphrodite-Session") \
            if headers is not None else None
        if explicit:
            return f"session:{explicit}"
        if not isinstance(body_json, dict):
            return None
        prompt = body_json.get("prompt")
        if isinstance(prompt, str) and prompt:
            return "text:" + prompt[:self._prefix_key_chars]
        if isinstance(prompt, list) and prompt:
            head = prompt[0] if isinstance(prompt[0], list) else prompt
            if head and isinstance(head[0], int):
                ids = head[:self._prefix_key_tokens]
                return "ids:" + ",".join(map(str, ids))
            if isinstance(head, str) and head:
                return "text:" + head[:self._prefix_key_chars]
            if isinstance(prompt[0], str) and prompt[0]:
                return "text:" + prompt[0][:self._prefix_key_chars]
        messages = body_json.get("messages")
        if isinstance(messages, list) and messages and \
                isinstance(messages[0], dict):
            first = messages[0]
            return "chat:" + json.dumps(
                [first.get("role"),
                 str(first.get("content", ""))[:self._prefix_key_chars]],
                separators=(",", ":"))
        if isinstance(messages, str) and messages:
            return "text:" + messages[:self._prefix_key_chars]
        return None

    # -- app ----------------------------------------------------------

    def build_app(self) -> web.Application:
        app = web.Application()
        app.router.add_get("/health", self._health_handler)
        app.router.add_get("/fleet/stats", self._stats_handler)
        app.router.add_post("/admin/rollout", self._rollout_handler)
        app.router.add_route("*", "/{tail:.+}", self._proxy_handler)
        return app

    async def _health_handler(self, request: web.Request
                              ) -> web.Response:
        now = time.monotonic()
        poll_s = flags.get_float("APHRODITE_ROUTER_POLL_S")
        serving = [
            r for r in self._replicas
            if not r.cordoned and not r.circuit_broken(now)
            and not r.is_stale(poll_s, now)
            and r.snapshot.state in ROUTABLE_STATES]
        body = {
            "state": "RUNNING" if serving else "UNAVAILABLE",
            "replicas_total": len(self._replicas),
            "replicas_serving": len(serving),
            "replicas": {r.name: r.describe(now)
                         for r in self._replicas},
        }
        if serving:
            return web.json_response(body)
        return web.json_response(
            body, status=503, headers=retry_after_headers(
                max(1.0, 2 * poll_s)))

    async def _stats_handler(self, request: web.Request
                             ) -> web.Response:
        now = time.monotonic()
        return web.json_response({
            "router": self.stats.to_json(),
            "replicas": {r.name: r.describe(now)
                         for r in self._replicas},
        })

    # -- proxy + transparent retry -----------------------------------

    def _upstream_headers(self, headers) -> Dict[str, str]:
        return {k: v for k, v in headers.items()
                if k.lower() not in _HOP_HEADERS}

    @staticmethod
    def _relay_headers(upstream_headers) -> Dict[str, str]:
        return {k: v for k, v in upstream_headers.items()
                if k.lower() not in _HOP_HEADERS}

    async def _proxy_handler(self, request: web.Request
                             ) -> web.StreamResponse:
        if request.path.startswith("/admin/"):
            # Replica admin surfaces are never reachable through the
            # router; the rollout is the fleet-level admin verb.
            return web.json_response(
                {"detail": "replica admin endpoints are not proxied"},
                status=404)
        raw = await request.read()
        body_json = None
        if raw:
            try:
                body_json = json.loads(raw)
            except ValueError:
                body_json = None
        key = self.affinity_key(request.headers, body_json)
        deadline = None
        if isinstance(body_json, dict):
            slo = body_json.get("ttft_slo_s")
            if isinstance(slo, (int, float)) and slo > 0:
                # ttft_slo_s caps TOTAL router time across retries:
                # a request that cannot start within its SLO should
                # fail fast, not crawl the whole fleet.
                deadline = time.monotonic() + float(slo)
        self.stats.requests_total += 1
        journal_ctx = self._journal_context(request, body_json, key)
        return await self._proxy_with_retry(request, raw, key,
                                            deadline, journal_ctx)

    def _journal_context(self, request: web.Request, body_json,
                         key: Optional[str]
                         ) -> Optional[_JournalContext]:
        """A :class:`_JournalContext` when this request's stream is
        journaled for mid-stream failover: a single-sequence
        generation stream, within the per-stream and fleet-wide
        journal bounds. None = plain relay (mid-stream death falls
        back to truthful truncation)."""
        if request.method != "POST" or not isinstance(body_json, dict):
            return None
        path = request.path
        if path not in _GENERATION_PATHS:
            return None
        if path != "/api/extra/generate/stream" and \
                not body_json.get("stream"):
            return None
        if (body_json.get("n") or 1) != 1 or \
                (body_json.get("best_of") or 1) > 1 or \
                body_json.get("use_beam_search"):
            return None             # resume is single-sequence only
        if "aphrodite_resume" in body_json:
            return None             # never wrap a continuation again
        max_tokens = flags.get_int("APHRODITE_ROUTER_JOURNAL_TOKENS")
        if max_tokens <= 0:
            return None
        if self._journals_active >= \
                flags.get_int("APHRODITE_ROUTER_JOURNAL_STREAMS"):
            return None
        return _JournalContext(body=body_json,
                               rel_url=str(request.rel_url),
                               key=key, max_tokens=max_tokens)

    async def _proxy_with_retry(self, request: web.Request,
                                raw: bytes, key: Optional[str],
                                deadline: Optional[float],
                                journal_ctx: Optional[_JournalContext]
                                = None) -> web.StreamResponse:
        retries = flags.get_int("APHRODITE_ROUTER_RETRIES")
        backoff = flags.get_float("APHRODITE_ROUTER_BACKOFF_S")
        headers = self._upstream_headers(request.headers)
        tried: List[ReplicaHandle] = []
        last: Optional[_Attempt] = None
        for attempt in range(retries + 1):
            replica = self.pick(key, exclude=tried)
            if replica is None and tried:
                # Every replica has been tried once; a circuit may
                # have cleared or a drain may have finished — allow a
                # repeat pick rather than failing with budget left.
                replica = self.pick(key)
            if replica is None:
                break
            result = await self._attempt(request, replica, raw,
                                         headers, journal_ctx)
            if result.response is not None:
                return result.response
            last = result
            tried.append(replica)
            if result.kind == "conn":
                self.stats.retries_conn += 1
            elif result.kind == "503":
                self.stats.retries_503 += 1
            else:
                self.stats.retries_5xx += 1
            if attempt >= retries:
                break
            delay = backoff * (2 ** attempt)
            if result.retry_after_s is not None:
                # The draining replica's hint says when a REPLACEMENT
                # takes its traffic; the retry goes to a DIFFERENT
                # replica, so stretch toward the hint but bounded.
                delay = max(delay, min(result.retry_after_s, 1.0))
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                delay = min(delay, remaining)
            if delay > 0:
                await asyncio.sleep(delay)
        # Budget, deadline, or fleet exhausted: relay the last
        # upstream rejection truthfully, or emit the router's own 503.
        if last is not None and last.relay_status is not None:
            self.stats.exhausted_relayed += 1
            return web.Response(status=last.relay_status,
                                body=last.relay_body,
                                headers=last.relay_headers or {})
        self.stats.rejected_no_replica += 1
        poll_s = flags.get_float("APHRODITE_ROUTER_POLL_S")
        return web.json_response(
            {"detail": "no replica available to serve the request"},
            status=503,
            headers=retry_after_headers(max(1.0, 4 * poll_s)))

    async def _attempt(self, request: web.Request,
                       replica: ReplicaHandle, raw: bytes,
                       headers: Dict[str, str],
                       journal_ctx: Optional[_JournalContext] = None
                       ) -> _Attempt:
        cb_window = flags.get_float("APHRODITE_ROUTER_CB_WINDOW_S")
        url = replica.url + str(request.rel_url)
        if journal_ctx is not None:
            headers = dict(headers)
            headers[JOURNAL_HEADER] = "1"
        try:
            upstream = await self._session.request(
                request.method, url, data=raw if raw else None,
                headers=headers)
        except aiohttp.ClientError:
            replica.record_failure(cb_window)
            replica.proxied_failed += 1
            return _Attempt(kind="conn")
        try:
            return await self._relay(request, replica, upstream,
                                     cb_window, journal_ctx)
        finally:
            upstream.release()

    async def _relay(self, request: web.Request,
                     replica: ReplicaHandle,
                     upstream: aiohttp.ClientResponse,
                     cb_window: float,
                     journal_ctx: Optional[_JournalContext] = None
                     ) -> _Attempt:
        status = upstream.status
        if status in _RETRYABLE_STATUSES:
            retry_after = parse_retry_after(upstream.headers)
            try:
                body = await upstream.read()
            except aiohttp.ClientError:
                body = b""
            replica.proxied_failed += 1
            if status == 503:
                # Draining (or briefly unavailable): stop picking it
                # now instead of waiting for the next poll tick.
                replica.mark_draining_seen()
                kind = "503"
            else:
                replica.record_failure(cb_window)
                kind = "5xx"
            return _Attempt(kind=kind, retry_after_s=retry_after,
                            relay_status=status, relay_body=body,
                            relay_headers=self._relay_headers(
                                upstream.headers))
        if upstream.headers.get("Content-Length") is not None:
            # Bounded body: buffer fully, so an upstream failure here
            # is still retryable (nothing sent to the client yet).
            try:
                body = await upstream.read()
            except aiohttp.ClientError:
                replica.record_failure(cb_window)
                replica.proxied_failed += 1
                return _Attempt(kind="conn")
            replica.proxied_ok += 1
            self.stats.served_buffered += 1
            return _Attempt(response=web.Response(
                status=status, body=body,
                headers=self._relay_headers(upstream.headers)))
        # Unbounded (streaming) body — SSE token streams. The client
        # response is NOT prepared until the first upstream chunk
        # arrives: a replica that dies before its first token leaves
        # the request fully retryable. After the first chunk a plain
        # re-issue stays forbidden; journaled generation streams
        # failover via the continuation splice instead.
        if journal_ctx is not None:
            return await self._relay_journaled(request, replica,
                                               upstream, cb_window,
                                               journal_ctx)
        try:
            first = await upstream.content.readany()
        except aiohttp.ClientError:
            replica.record_failure(cb_window)
            replica.proxied_failed += 1
            return _Attempt(kind="conn")
        response = web.StreamResponse(
            status=status,
            headers=self._relay_headers(upstream.headers))
        await response.prepare(request)
        truncated = False
        try:
            if first:
                await response.write(first)
            while True:
                chunk = await upstream.content.readany()
                if not chunk:
                    break
                await response.write(chunk)
        except aiohttp.ClientError as e:
            # Mid-stream upstream failure AFTER tokens reached the
            # client: truthful truncation (no silent re-issue).
            truncated = True
            self.stats.truncated_client_streams += 1
            logger.warning(
                "stream from %s truncated mid-flight: %s: %s",
                replica.name, type(e).__name__, e)
        except (ConnectionResetError, OSError):
            # The CLIENT hung up; nothing further to deliver.
            truncated = True
        if truncated:
            replica.proxied_failed += 1
            self.stats.failed_mid_stream += 1
        else:
            replica.proxied_ok += 1
            self.stats.served_streaming += 1
            try:
                await response.write_eof()
            except (ConnectionResetError, OSError):
                pass
        return _Attempt(response=response)

    # -- mid-stream failover: journal + splice ------------------------

    async def _relay_journaled(self, request: web.Request,
                               replica: ReplicaHandle,
                               upstream: aiohttp.ClientResponse,
                               cb_window: float,
                               ctx: _JournalContext) -> _Attempt:
        """Relay a journaled generation stream, splicing in
        continuations from healthy peers on mid-stream replica death.

        The journal commits a token only once its data line was
        forwarded, so a continuation resumes from exactly what the
        client received; dedupe on emitted count makes the splice
        exactly-once even against a replaying upstream. Truthful
        truncation survives only as the post-retry-budget (or
        journal-overflow / non-journaling-upstream) fallback.
        """
        tail = _JournalTail(max_tokens=ctx.max_tokens)
        response: Optional[web.StreamResponse] = None
        current, cur_replica = upstream, replica
        opened: List[aiohttp.ClientResponse] = []
        self._journals_active += 1
        try:
            while True:
                upstream_died = False
                try:
                    while True:
                        chunk = await current.content.readany()
                        if not chunk:
                            break
                        out = tail.feed(chunk)
                        if not out:
                            continue
                        if response is None:
                            response = web.StreamResponse(
                                status=current.status,
                                headers=self._relay_headers(
                                    current.headers))
                            await response.prepare(request)
                        await response.write(out)
                except aiohttp.ClientError as e:
                    upstream_died = True
                    logger.warning(
                        "journaled stream from %s died mid-flight "
                        "(%d tokens delivered): %s: %s",
                        cur_replica.name, len(tail.tokens),
                        type(e).__name__, e)
                except (ConnectionResetError, OSError):
                    # The CLIENT hung up; nothing further to deliver
                    # (and nothing to retry — the final response may
                    # never reach anyone).
                    cur_replica.proxied_failed += 1
                    self.stats.failed_mid_stream += 1
                    return _Attempt(response=response if response
                                    is not None else
                                    web.Response(status=204))
                if not upstream_died:
                    break
                cur_replica.record_failure(cb_window)
                cur_replica.proxied_failed += 1
                if response is None:
                    # Died before anything reached the client: the
                    # whole request is still retryable upstream of us.
                    return _Attempt(kind="conn")
                self.stats.failed_mid_stream += 1
                resumed = None
                if tail.active and not tail.overflowed:
                    resumed = await self._issue_continuation(
                        ctx, tail, exclude=[cur_replica],
                        cb_window=cb_window)
                if resumed is None:
                    self.stats.truncated_client_streams += 1
                    logger.warning(
                        "stream could not be resumed; truthful "
                        "truncation after %d tokens", len(tail.tokens))
                    return _Attempt(response=response)
                cur_replica, current = resumed
                opened.append(current)
                self.stats.resumed_mid_stream += 1
            # Clean upstream EOF.
            cur_replica.proxied_ok += 1
            self.stats.served_streaming += 1
            try:
                left = tail.flush()
                if response is None:
                    response = web.StreamResponse(
                        status=current.status,
                        headers=self._relay_headers(current.headers))
                    await response.prepare(request)
                if left:
                    await response.write(left)
                await response.write_eof()
            except (ConnectionResetError, OSError):
                pass
            return _Attempt(response=response)
        finally:
            self._journals_active -= 1
            for resp in opened:
                resp.release()

    async def _issue_continuation(self, ctx: _JournalContext,
                                  tail: _JournalTail,
                                  exclude: List[ReplicaHandle],
                                  cb_window: float):
        """Re-issue the journaled request as a continuation on a
        healthy peer: original body + the admin-key-gated
        ``aphrodite_resume`` extension carrying the delivered token
        ids. Returns (replica, streaming upstream) or None once the
        retry budget / fleet is exhausted."""
        body = dict(ctx.body)
        body["aphrodite_resume"] = {
            "emitted_token_ids": list(tail.tokens)}
        raw = json.dumps(body).encode()
        retries = flags.get_int("APHRODITE_ROUTER_RETRIES")
        backoff = flags.get_float("APHRODITE_ROUTER_BACKOFF_S")
        tried: List[ReplicaHandle] = list(exclude)
        for attempt in range(retries + 1):
            replica = self.pick(ctx.key, exclude=tried)
            if replica is None and len(tried) > len(exclude):
                # Every peer tried once; allow a repeat pick (a drain
                # may have finished) rather than truncating early.
                replica = self.pick(ctx.key, exclude=exclude)
            if replica is None:
                return None
            headers = {"Content-Type": "application/json",
                       JOURNAL_HEADER: "1"}
            if replica.admin_key:
                headers[RESUME_KEY_HEADER] = replica.admin_key
            try:
                upstream = await self._session.request(
                    "POST", replica.url + ctx.rel_url, data=raw,
                    headers=headers)
            except aiohttp.ClientError:
                replica.record_failure(cb_window)
                tried.append(replica)
                await asyncio.sleep(backoff * (2 ** attempt))
                continue
            if upstream.status != 200:
                if upstream.status == 503:
                    replica.mark_draining_seen()
                else:
                    replica.record_failure(cb_window)
                body_text = b""
                try:
                    body_text = await upstream.read()
                except aiohttp.ClientError:
                    pass
                logger.warning(
                    "continuation on %s rejected with %d: %s",
                    replica.name, upstream.status, body_text[:200])
                upstream.release()
                tried.append(replica)
                await asyncio.sleep(backoff * (2 ** attempt))
                continue
            return replica, upstream
        return None

    # -- rolling deploy ----------------------------------------------

    def _admin_authorized(self, request: web.Request
                          ) -> Optional[web.Response]:
        if not self._admin_keys:
            return web.json_response(
                {"detail": "rollout is disabled: start the router "
                           "with admin keys"}, status=403)
        token = request.headers.get("Authorization", "")\
            .removeprefix("Bearer ").strip()
        if token not in self._admin_keys:
            return web.json_response({"detail": "invalid admin key"},
                                     status=401)
        return None

    async def _rollout_handler(self, request: web.Request
                               ) -> web.Response:
        denied = self._admin_authorized(request)
        if denied is not None:
            return denied
        if self._rollout_lock.locked():
            return web.json_response(
                {"detail": "a rollout is already in progress"},
                status=409)
        try:
            body = await request.json()
        except Exception:
            body = {}
        drain_deadline_s = float(body.get("deadline_s", 30.0))
        ready_timeout_s = float(body.get("ready_timeout_s", 120.0))
        async with self._rollout_lock:
            report = await self._run_rollout(drain_deadline_s,
                                             ready_timeout_s)
        status = 200 if report["ok"] else 500
        return web.json_response(report, status=status)

    async def _run_rollout(self, drain_deadline_s: float,
                           ready_timeout_s: float) -> Dict[str, Any]:
        t0 = time.monotonic()
        results = []
        for replica in list(self._replicas):
            results.append(await self._roll_one(
                replica, drain_deadline_s, ready_timeout_s))
        self.stats.rollouts_total += 1
        return {
            "ok": all(r["ready"] for r in results),
            "replicas": results,
            "duration_s": round(time.monotonic() - t0, 3),
        }

    async def _roll_one(self, replica: ReplicaHandle,
                        drain_deadline_s: float,
                        ready_timeout_s: float) -> Dict[str, Any]:
        """One rollout step: cordon → drain → restart → wait RUNNING
        → uncordon. On failure the replica is uncordoned anyway — the
        circuit breaker and its (non-routable) health snapshot keep
        it out of rotation, and recovery re-admits it through the
        same /health-driven path as any other replica."""
        t0 = time.monotonic()
        drain, restarted, ready = "error", False, False
        replica.cordoned = True
        try:
            drain = await self._drain_replica(replica,
                                              drain_deadline_s)
            if self._restart_cb is not None:
                try:
                    await self._restart_cb(replica)
                    restarted = True
                except Exception as e:
                    logger.error("restart of %s failed: %s: %s",
                                 replica.name, type(e).__name__, e)
            ready = await self._await_ready(replica, ready_timeout_s)
        finally:
            replica.cordoned = False
        return {
            "replica": replica.name,
            "drain": drain,
            "restarted": restarted,
            "ready": ready,
            "duration_s": round(time.monotonic() - t0, 3),
        }

    async def _drain_replica(self, replica: ReplicaHandle,
                             deadline_s: float) -> str:
        """POST the replica's authed /admin/drain and wait until its
        in-flight count reaches zero (drained), the process goes away
        (exited — SIGTERM-style deploys exit after drain), or the
        deadline passes."""
        headers = {}
        if replica.admin_key:
            headers["Authorization"] = f"Bearer {replica.admin_key}"
        try:
            async with self._session.post(
                    replica.url + "/admin/drain",
                    json={"deadline_s": deadline_s},
                    headers=headers,
                    timeout=aiohttp.ClientTimeout(
                        total=CONNECT_TIMEOUT_S)) as resp:
                if resp.status >= 400:
                    return f"drain-rejected-{resp.status}"
        except (aiohttp.ClientError, asyncio.TimeoutError):
            return "unreachable"
        t_end = time.monotonic() + deadline_s + CONNECT_TIMEOUT_S
        while time.monotonic() < t_end:
            body = await self._probe(replica)
            if body is None:
                return "exited"
            if int(body.get("inflight", 0) or 0) == 0:
                return "drained"
            await asyncio.sleep(0.05)
        return "deadline-expired"

    async def _await_ready(self, replica: ReplicaHandle,
                           timeout_s: float) -> bool:
        """Poll the restarted replica until /health reports a
        routable state; record the fresh snapshot so picks resume the
        moment it is ready."""
        cb_window = flags.get_float("APHRODITE_ROUTER_CB_WINDOW_S")
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            body = await self._probe(replica)
            if body is not None:
                snap = ReplicaSnapshot.from_probe(body)
                if snap.state in ROUTABLE_STATES:
                    replica.record_health(snap, cb_window)
                    replica.broken_until = 0.0
                    return True
            await asyncio.sleep(0.1)
        return False


def _log_poll_exit(task: "asyncio.Task") -> None:
    """Done-callback for the poll task: a poll loop that dies takes
    the fleet's load signal with it — that must be LOUD."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        logger.error("fleet health poll loop died: %s: %s",
                     type(exc).__name__, exc)
