"""The PyTorch port's fleet router over fake replica servers: mirrors
tests/fleet/test_router.py and tests/fleet/test_failover.py (the same
fakes and scenarios, the port's `fleet` and `endpoints.utils` in place
of the JAX package's), then holds the port against the JAX package and
drives it over real port servers.

- Parity: `_rendezvous_score`, `FleetRouter.affinity_key` and the
  `_JournalTail` parser give the JAX package's results on the same
  inputs (the same byte chunks, cut at random points).
- End to end, in process: the port's router over two port Kobold apps
  on CPU engines holding the JAX engine's weights. Replica A is stopped
  once the client has read its first token; the client's stream still
  carries the uninterrupted JAX app's greedy text, each token once.
- `FleetLauncher` spawns port replica processes: without `--device cpu`
  a replica exits at start on a machine without a card; the two-replica
  failover run is `slow`, as its JAX counterpart
  (tests/test_serving_bench.py) is.

Every network wait is bounded (`asyncio.wait_for`, client timeouts):
a hang fails the test.
"""
import asyncio
import json
import os
import random

import aiohttp
import pytest
from aiohttp import web

from aphrodite_tpu_torch.endpoints.utils import (JOURNAL_HEADER,
                                                 RESUME_KEY_HEADER)
from aphrodite_tpu_torch.fleet.replica import (ReplicaHandle,
                                               ReplicaSnapshot)
from aphrodite_tpu_torch.fleet.router import FleetRouter, _JournalTail

WAIT_S = 120                  # bound on any one test's network waits


def arun(coro):
    return asyncio.run(asyncio.wait_for(coro, WAIT_S))


def snap(state="RUNNING", inflight=0, depth=0, tokens=0,
         ewma=1000.0, age=0.0):
    import time
    return ReplicaSnapshot(
        state=state, draining=state == "DRAINING", inflight=inflight,
        queue_depth=depth, waiting_prefill_tokens=tokens,
        ewma_prefill_tok_s=ewma,
        polled_at=time.monotonic() - age)


class FakeReplica:
    """One configurable stand-in engine server on a real local port."""

    def __init__(self, name, admin_key="k"):
        self.name = name
        self.admin_key = admin_key
        self.state = "RUNNING"
        self.inflight = 0
        self.queue_depth = 0
        self.reject_503 = False          # completions answer 503
        self.sse_chunks = 3
        self.die_after_chunks = None     # abrupt close mid-stream
        self.requests = []               # recorded completion bodies
        self.drain_calls = 0
        self.url = None
        self._runner = None

    async def start(self):
        app = web.Application()
        app.router.add_get("/health", self._health)
        app.router.add_post("/admin/drain", self._drain)
        app.router.add_post("/v1/completions", self._completions)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        port = self._runner.addresses[0][1]
        self.url = f"http://127.0.0.1:{port}"

    async def stop(self):
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    def handle(self):
        return ReplicaHandle(self.url, name=self.name,
                             admin_key=self.admin_key)

    async def _health(self, request):
        body = {
            "state": self.state,
            "draining": self.state == "DRAINING",
            "inflight": self.inflight,
            "overload": {"queue_depth": self.queue_depth,
                         "waiting_prefill_tokens": 0,
                         "ewma_prefill_tok_s": 1000.0},
        }
        status = 503 if self.state in ("DRAINING", "DEAD") else 200
        return web.json_response(body, status=status)

    async def _drain(self, request):
        token = request.headers.get("Authorization", "")\
            .removeprefix("Bearer ").strip()
        if token != self.admin_key:
            return web.json_response({"detail": "bad key"}, status=401)
        self.drain_calls += 1
        self.state = "DRAINING"
        self.reject_503 = True
        self.inflight = 0
        return web.json_response({"state": "DRAINING"})

    async def _completions(self, request):
        body = await request.json()
        self.requests.append(body)
        if self.reject_503:
            return web.json_response(
                {"detail": "draining"}, status=503,
                headers={"Retry-After": "1"})
        if body.get("stream"):
            resp = web.StreamResponse(headers={
                "Content-Type": "text/event-stream"})
            await resp.prepare(request)
            for i in range(self.sse_chunks):
                if self.die_after_chunks is not None and \
                        i >= self.die_after_chunks:
                    # Abrupt death after `die_after_chunks` chunks
                    # (0 = before any data): close the socket with
                    # the chunked body unterminated.
                    request.transport.close()
                    return resp
                await resp.write(
                    f'data: {{"i": {i}, "replica": '
                    f'"{self.name}"}}\n\n'.encode())
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp
        return web.json_response({"replica": self.name, "ok": True})


async def _make_router(fakes, monkeypatch=None, **kw):
    handles = [f.handle() for f in fakes]
    router = FleetRouter(handles, **kw)
    # No background poll loop in tests: polls happen explicitly via
    # router._poll_once() so snapshot state is deterministic. The
    # session the poll loop would have created is still needed.
    router._session = aiohttp.ClientSession(
        timeout=aiohttp.ClientTimeout(total=None, sock_connect=5.0))
    return router, handles


async def _client_for(router):
    runner = web.AppRunner(router.build_app())
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    return runner, f"http://127.0.0.1:{port}"


# ------------------------------------------------------------------
# pick(): load awareness, affinity, staleness, circuit breaking
# ------------------------------------------------------------------

def test_load_aware_pick_avoids_saturated_replica():
    """Picks follow the polled load score, not round-robin: a
    saturated replica (deep queue, big backlog) is never chosen while
    an idle peer exists."""
    a, b, c = (ReplicaHandle(f"http://x{i}", name=f"r{i}")
               for i in range(3))
    router = FleetRouter([a, b, c])
    a.snapshot = snap(depth=40, inflight=16, tokens=65536, ewma=500.0)
    b.snapshot = snap(depth=1, inflight=2)
    c.snapshot = snap(depth=0, inflight=1)
    picks = [router.pick() for _ in range(10)]
    assert a not in picks
    assert c in picks           # least loaded gets traffic
    assert router.stats.picks_load == 10


def test_pick_skips_draining_dead_cordoned():
    a, b = (ReplicaHandle(f"http://x{i}", name=f"r{i}")
            for i in range(2))
    router = FleetRouter([a, b])
    a.snapshot = snap(state="DRAINING")
    b.snapshot = snap()
    assert router.pick() is b
    b.cordoned = True
    assert router.pick() is None      # a draining, b cordoned
    b.cordoned = False
    a.snapshot = snap(state="DEAD")
    assert router.pick() is b


def test_affinity_routes_sessions_and_spills_under_imbalance():
    """A keyed request sticks to its rendezvous replica while load is
    balanced, and spills to the least-loaded replica once the
    affinity target's load exceeds the spill threshold."""
    replicas = [ReplicaHandle(f"http://x{i}", name=f"r{i}")
                for i in range(3)]
    router = FleetRouter(replicas)
    for r in replicas:
        r.snapshot = snap()
    key = "ids:1,2,3,4"
    first = router.pick(key)
    for _ in range(5):
        assert router.pick(key) is first       # sticky while balanced
    assert router.stats.affinity_hits == 6
    assert router.stats.affinity_spills == 0
    # Saturate the affinity target past APHRODITE_ROUTER_SPILL (8.0
    # default): the key spills to the least-loaded replica.
    first.snapshot = snap(depth=30, inflight=10)
    spilled = router.pick(key)
    assert spilled is not first
    assert router.stats.affinity_spills == 1
    # Different keys spread across replicas (rendezvous, not modulo
    # anything): at least two distinct targets over a few keys.
    for r in replicas:
        r.snapshot = snap()
    targets = {router.pick(f"ids:{i}") for i in range(8)}
    assert len(targets) >= 2


def test_stale_snapshots_fall_back_to_round_robin(monkeypatch):
    """A poll outage must not black-hole the fleet: stale snapshots
    lose their load signal and picks degrade to round-robin over
    non-broken replicas."""
    monkeypatch.setenv("APHRODITE_ROUTER_POLL_S", "0.05")
    a, b = (ReplicaHandle(f"http://x{i}", name=f"r{i}")
            for i in range(2))
    router = FleetRouter([a, b])
    a.snapshot = snap(age=10.0)     # stale (>4x poll interval)
    b.snapshot = snap(age=10.0, depth=99)  # stale load is IGNORED
    picks = [router.pick() for _ in range(4)]
    assert picks.count(a) == 2 and picks.count(b) == 2
    assert router.stats.picks_stale_fallback == 4


def test_circuit_break_on_dead_and_readmit_on_recovery():
    a, b = (ReplicaHandle(f"http://x{i}", name=f"r{i}")
            for i in range(2))
    router = FleetRouter([a, b])
    b.snapshot = snap()
    # DEAD report: circuit-broken AND non-routable.
    a.record_health(snap(state="DEAD"), cb_window_s=60.0)
    assert a.circuit_broken()
    assert all(router.pick() is b for _ in range(4))
    # Recovery: a routable report clears the breaker immediately.
    a.record_health(snap(state="RUNNING"), cb_window_s=60.0)
    assert not a.circuit_broken()
    assert a in [router.pick() for _ in range(4)]


def test_connection_failures_break_circuit_until_window():
    import time
    a = ReplicaHandle("http://x0", name="r0")
    a.snapshot = snap()
    a.record_failure(cb_window_s=0.05)
    assert a.circuit_broken()
    time.sleep(0.06)
    assert not a.circuit_broken()


# ------------------------------------------------------------------
# proxy e2e: retry, streaming invariants
# ------------------------------------------------------------------

def test_transparent_retry_of_draining_replica():
    """A 503-DRAINING replica is invisible to the client: the router
    retries onto a healthy peer and serves 200 with zero
    client-visible errors."""
    async def go():
        a, b = FakeReplica("a"), FakeReplica("b")
        await a.start()
        await b.start()
        router, handles = await _make_router([a, b])
        # Make `a` the preferred pick, then have it reject.
        handles[0].snapshot = snap(depth=0)
        handles[1].snapshot = snap(depth=5)
        a.reject_503 = True
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(base + "/v1/completions",
                                         json={"n": 1})
                assert resp.status == 200
                body = await resp.json()
                assert body["replica"] == "b"
            assert router.stats.retries_503 == 1
            assert len(a.requests) == 1 and len(b.requests) == 1
            # The rejecting replica stops being picked immediately.
            assert handles[0].snapshot.state == "DRAINING"
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()
            await b.stop()

    arun(go())


def test_retry_on_connection_refused_and_circuit_break():
    """A kill-dead replica (connection refused) is retried onto a
    peer and circuit-broken out of rotation."""
    async def go():
        a, b = FakeReplica("a"), FakeReplica("b")
        await a.start()
        await b.start()
        dead_url = a.url
        await a.stop()      # port now refuses connections
        router, handles = await _make_router([a, b])
        handles[0].url = dead_url
        handles[0].snapshot = snap(depth=0)   # looks best on paper
        handles[1].snapshot = snap(depth=3)
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(base + "/v1/completions",
                                         json={"n": 1})
                assert resp.status == 200
                assert (await resp.json())["replica"] == "b"
            assert router.stats.retries_conn == 1
            assert handles[0].circuit_broken()
        finally:
            await runner.cleanup()
            await router.stop()
            await b.stop()

    arun(go())


def test_streaming_served_through_router():
    async def go():
        a = FakeReplica("a")
        await a.start()
        router, handles = await _make_router([a])
        handles[0].snapshot = snap()
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(
                    base + "/v1/completions",
                    json={"prompt": "hi", "stream": True})
                assert resp.status == 200
                text = (await resp.read()).decode()
                assert text.count("data:") == a.sse_chunks + 1
                assert "[DONE]" in text
            assert router.stats.served_streaming == 1
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()

    arun(go())


def test_no_retry_after_first_token():
    """The no-silent-reissue invariant: a replica that dies
    MID-STREAM (after tokens reached the client) is NOT retried — the
    client sees a truthfully truncated stream, and no peer ever sees
    the request."""
    async def go():
        a, b = FakeReplica("a"), FakeReplica("b")
        a.die_after_chunks = 1
        await a.start()
        await b.start()
        router, handles = await _make_router([a, b])
        handles[0].snapshot = snap(depth=0)     # a preferred
        handles[1].snapshot = snap(depth=5)
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(
                    base + "/v1/completions",
                    json={"n": 1, "stream": True})
                assert resp.status == 200
                try:
                    text = (await resp.read()).decode()
                except aiohttp.ClientError:
                    text = ""
                assert "[DONE]" not in text      # truncated, honest
            assert router.stats.failed_mid_stream == 1
            assert router.stats.retries_total == 0
            assert len(b.requests) == 0          # never re-issued
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()
            await b.stop()

    arun(go())


def test_retry_before_first_token_is_transparent():
    """The flip side: a streaming request whose replica dies BEFORE
    the first chunk is retried transparently — the client sees one
    clean 200 stream from the peer."""
    async def go():
        a, b = FakeReplica("a"), FakeReplica("b")
        a.die_after_chunks = 0      # close before any data
        await a.start()
        await b.start()
        router, handles = await _make_router([a, b])
        handles[0].snapshot = snap(depth=0)
        handles[1].snapshot = snap(depth=5)
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(
                    base + "/v1/completions",
                    json={"n": 1, "stream": True})
                assert resp.status == 200
                text = (await resp.read()).decode()
                assert "[DONE]" in text
                assert '"replica": "b"' in text
            assert router.stats.retries_conn == 1
            assert router.stats.failed_mid_stream == 0
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()
            await b.stop()

    arun(go())


def test_deadline_caps_total_retry_time(monkeypatch):
    """ttft_slo_s caps total router time across retries: with every
    replica rejecting, the request fails fast instead of walking the
    whole backoff ladder."""
    monkeypatch.setenv("APHRODITE_ROUTER_BACKOFF_S", "5.0")
    monkeypatch.setenv("APHRODITE_ROUTER_RETRIES", "3")

    async def go():
        import time
        a = FakeReplica("a")
        a.reject_503 = True
        await a.start()
        router, handles = await _make_router([a])
        handles[0].snapshot = snap()
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                t0 = time.monotonic()
                resp = await client.post(
                    base + "/v1/completions",
                    json={"prompt": "hi", "ttft_slo_s": 0.3})
                elapsed = time.monotonic() - t0
                # Truthful relay of the upstream rejection, well
                # before the 5s-base backoff ladder would finish.
                assert resp.status == 503
                assert elapsed < 2.0
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()

    arun(go())


def test_probe_parse_retry_after_roundtrip():
    """The router parses exactly what the frontends emit."""
    from aphrodite_tpu_torch.endpoints.utils import (parse_retry_after,
                                               retry_after_headers)
    assert parse_retry_after(retry_after_headers(2.3)) == 3.0
    assert parse_retry_after(retry_after_headers(0.0)) == 1.0
    assert parse_retry_after({}) is None
    assert parse_retry_after({"Retry-After": "nope"}) is None


def test_parse_retry_after_http_date_form():
    """RFC 7231 allows Retry-After as an HTTP-date, and an
    intermediate proxy can legally rewrite the delta-seconds form to
    one — it must parse to the remaining seconds, not None."""
    import email.utils
    import time as _time
    from aphrodite_tpu_torch.endpoints.utils import parse_retry_after

    future = email.utils.formatdate(_time.time() + 30, usegmt=True)
    got = parse_retry_after({"Retry-After": future})
    assert got is not None and 25.0 <= got <= 31.0
    # A date in the past clamps to 0 (retry immediately), like the
    # numeric form's negative clamp — never None, never negative.
    past = email.utils.formatdate(_time.time() - 30, usegmt=True)
    assert parse_retry_after({"Retry-After": past}) == 0.0
    # Non-GMT zoned dates are legal RFC 5322 and convert correctly.
    zoned = email.utils.formatdate(_time.time() + 60, localtime=True)
    got = parse_retry_after({"Retry-After": zoned})
    assert got is not None and 55.0 <= got <= 61.0
    # Garbage that is neither form still parses to None.
    assert parse_retry_after({"Retry-After": "Wed, banana"}) is None


def test_affinity_key_extraction():
    router = FleetRouter([ReplicaHandle("http://x", name="r")])
    key_ids = router.affinity_key({}, {"prompt": [1, 2, 3]})
    assert key_ids == "ids:1,2,3"
    assert router.affinity_key({}, {"prompt": [[1, 2], [3]]}) == \
        "ids:1,2"
    assert router.affinity_key({}, {"prompt": "hello"}) == \
        "text:hello"
    chat = {"messages": [{"role": "user", "content": "hi"}]}
    assert router.affinity_key({}, chat).startswith("chat:")
    assert router.affinity_key(
        {"X-Aphrodite-Session": "s1"}, None) == "session:s1"
    assert router.affinity_key({}, {"n": 2}) is None
    # Shared prefixes map to the SAME key (the fleet-level prefix
    # cache multiplier): truncation at the key length.
    long_a = {"prompt": list(range(100))}
    long_b = {"prompt": list(range(100)) + [999]}
    assert router.affinity_key({}, long_a) == \
        router.affinity_key({}, long_b)


# ------------------------------------------------------------------
# rolling deploy
# ------------------------------------------------------------------

def test_rolling_deploy_walks_fleet_with_zero_rejections():
    """POST /admin/rollout drains each replica via its authed
    /admin/drain, restarts it through the launcher hook, re-admits it
    only once /health is routable again — while concurrent client
    traffic sees zero rejected-without-retry requests."""
    async def go():
        fakes = [FakeReplica(f"r{i}") for i in range(3)]
        for f in fakes:
            await f.start()
        restarts = []

        async def restart_cb(handle):
            fake = next(f for f in fakes if f.url == handle.url)
            restarts.append(fake.name)
            fake.state = "RUNNING"
            fake.reject_503 = False

        router, handles = await _make_router(
            fakes, admin_keys=["roll-key"], restart_cb=restart_cb)
        await router._poll_once()
        runner, base = await _client_for(router)
        stop_traffic = asyncio.Event()
        outcomes = {"ok": 0, "bad": 0}

        async def traffic(client):
            while not stop_traffic.is_set():
                try:
                    resp = await client.post(
                        base + "/v1/completions",
                        json={"prompt": "hi"})
                    if resp.status == 200:
                        outcomes["ok"] += 1
                    else:
                        outcomes["bad"] += 1
                    await resp.read()
                except aiohttp.ClientError:
                    outcomes["bad"] += 1
                await asyncio.sleep(0.01)

        try:
            async with aiohttp.ClientSession() as client:
                # Unauthed rollout is rejected.
                resp = await client.post(base + "/admin/rollout",
                                         json={})
                assert resp.status == 401
                t = asyncio.get_running_loop().create_task(
                    traffic(client))
                t.add_done_callback(lambda _: None)
                resp = await client.post(
                    base + "/admin/rollout",
                    json={"deadline_s": 5.0, "ready_timeout_s": 5.0},
                    headers={"Authorization": "Bearer roll-key"})
                report = await resp.json()
                assert resp.status == 200, report
                stop_traffic.set()
                await asyncio.gather(t, return_exceptions=True)
            assert report["ok"] is True
            assert [r["replica"] for r in report["replicas"]] == \
                ["r0", "r1", "r2"]
            assert all(r["drain"] == "drained"
                       for r in report["replicas"])
            assert all(r["ready"] for r in report["replicas"])
            assert restarts == ["r0", "r1", "r2"]
            assert all(f.drain_calls == 1 for f in fakes)
            assert not any(h.cordoned for h in handles)
            # Zero-downtime contract: every concurrent request was
            # served (rejected-without-retry count is zero).
            assert outcomes["ok"] >= 1
            assert outcomes["bad"] == 0, outcomes
            assert router.stats.rollouts_total == 1
        finally:
            await runner.cleanup()
            await router.stop()
            for f in fakes:
                await f.stop()

    arun(go())


def test_rollout_rejects_concurrent_and_bad_body():
    async def go():
        fake = FakeReplica("r0")
        await fake.start()
        router, handles = await _make_router(
            [fake], admin_keys=["roll-key"])
        await router._poll_once()
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                first = asyncio.get_running_loop().create_task(
                    client.post(
                        base + "/admin/rollout",
                        json={"deadline_s": 2.0,
                              "ready_timeout_s": 2.0},
                        headers={"Authorization":
                                 "Bearer roll-key"}))
                first.add_done_callback(lambda _: None)
                await asyncio.sleep(0.05)
                second = await client.post(
                    base + "/admin/rollout", json={},
                    headers={"Authorization": "Bearer roll-key"})
                assert second.status == 409
                resp = await first
                assert resp.status in (200, 500)
        finally:
            await runner.cleanup()
            await router.stop()
            await fake.stop()

    arun(go())


def test_fleet_health_aggregate():
    async def go():
        a, b = FakeReplica("a"), FakeReplica("b")
        await a.start()
        await b.start()
        a.state = "DEAD"
        router, handles = await _make_router([a, b])
        await router._poll_once()
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.get(base + "/health")
                body = await resp.json()
                assert resp.status == 200
                assert body["state"] == "RUNNING"
                assert body["replicas_serving"] == 1
                assert body["replicas"]["a"]["circuit_broken"]
                b.state = "DEAD"
                await router._poll_once()
                resp = await client.get(base + "/health")
                assert resp.status == 503
                assert "Retry-After" in resp.headers
                resp = await client.get(base + "/fleet/stats")
                stats = await resp.json()
                assert "router" in stats and "replicas" in stats
                # /admin/* is never proxied to replicas.
                resp = await client.post(base + "/admin/drain",
                                         json={})
                assert resp.status == 404
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()
            await b.stop()

    arun(go())

# ==================================================================
# Mid-stream failover (tests/fleet/test_failover.py)
# ==================================================================

class JournalingReplica:
    """A fake engine server that speaks the journal/resume contract
    for a deterministic 8-token stream."""

    TOTAL = 8

    def __init__(self, name, admin_key="k", die_after=None,
                 replay_from_zero=False):
        self.name = name
        self.admin_key = admin_key
        #: Close the socket after emitting this many TOKEN chunks
        #: (continuations count from their resume point).
        self.die_after = die_after
        #: Buggy-upstream mode: a continuation re-emits the WHOLE
        #: stream from token 0 (the router must dedupe the overlap).
        self.replay_from_zero = replay_from_zero
        self.requests = []
        self.resume_keys = []
        self.url = None
        self._runner = None

    async def start(self):
        app = web.Application()
        app.router.add_get("/health", self._health)
        app.router.add_post("/v1/completions", self._completions)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        self.url = f"http://127.0.0.1:{self._runner.addresses[0][1]}"

    async def stop(self):
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    def handle(self):
        return ReplicaHandle(self.url, name=self.name,
                             admin_key=self.admin_key)

    async def _health(self, request):
        return web.json_response({
            "state": "RUNNING", "draining": False, "inflight": 0,
            "overload": {"queue_depth": 0,
                         "waiting_prefill_tokens": 0,
                         "ewma_prefill_tok_s": 1000.0}})

    async def _completions(self, request):
        body = await request.json()
        self.requests.append(body)
        journaled = request.headers.get(JOURNAL_HEADER) not in (None,
                                                                "", "0")
        resume = body.get("aphrodite_resume")
        start = 0
        if resume is not None:
            self.resume_keys.append(
                request.headers.get(RESUME_KEY_HEADER))
            start = len(resume["emitted_token_ids"])
            if self.replay_from_zero:
                start = 0
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream"})
        await resp.prepare(request)
        emitted = 0
        for i in range(start, self.TOTAL):
            if self.die_after is not None and emitted >= self.die_after:
                request.transport.close()
                return resp
            fin = ',"fin":"length"' if i == self.TOTAL - 1 else ""
            if journaled:
                await resp.write(
                    f': aphrodite-journal {{"t":[{100 + i}],'
                    f'"n":{i + 1}{fin}}}\n'.encode())
            await resp.write(
                f'data: {{"text": "t{i} ", "replica": '
                f'"{self.name}"}}\n\n'.encode())
            emitted += 1
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp


async def _make_journal_router(fakes, **kw):
    handles = [f.handle() for f in fakes]
    router = FleetRouter(handles, name="test-router", **kw)
    router._session = aiohttp.ClientSession(
        timeout=aiohttp.ClientTimeout(total=None, sock_connect=5.0))
    for h in handles:
        h.snapshot = snap()
    return router, handles


def _texts(raw: bytes):
    """Token texts of the client-visible stream, asserting no journal
    record ever leaks to the client."""
    assert b"aphrodite-journal" not in raw
    texts, done = [], False
    for line in raw.split(b"\n"):
        if not line.startswith(b"data: "):
            continue
        payload = line[len(b"data: "):]
        if payload.strip() == b"[DONE]":
            done = True
            continue
        texts.append(json.loads(payload)["text"])
    return texts, done


# Keyless (no prompt → no affinity key) so the load-based pick is
# what routes, making the "preferred" fake deterministic in tests.
STREAM_BODY = {"stream": True, "max_tokens": 8}


def test_mid_stream_death_resumes_exactly_once():
    """The headline splice: replica a dies after 3 tokens; the router
    re-issues a continuation (original body + the journaled ids +
    the admin resume key) to b and splices — the client sees all 8
    tokens exactly once and a clean [DONE]."""
    async def go():
        a = JournalingReplica("a", die_after=3)
        b = JournalingReplica("b")
        await a.start()
        await b.start()
        router, handles = await _make_journal_router([a, b])
        handles[0].snapshot = snap(depth=0)     # a preferred
        handles[1].snapshot = snap(depth=5)
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(base + "/v1/completions",
                                         json=STREAM_BODY)
                assert resp.status == 200
                texts, done = _texts(await resp.read())
            assert texts == [f"t{i} " for i in range(8)]
            assert done
            assert router.stats.resumed_mid_stream == 1
            assert router.stats.truncated_client_streams == 0
            assert router.stats.failed_mid_stream == 1
            assert router.stats.served_streaming == 1
            # The continuation carried exactly the delivered ids and
            # the replica's admin key, on the original path.
            cont = b.requests[-1]
            assert cont["aphrodite_resume"]["emitted_token_ids"] == \
                [100, 101, 102]
            assert cont["max_tokens"] == STREAM_BODY["max_tokens"]
            assert b.resume_keys == ["k"]
            assert router._journals_active == 0
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()
            await b.stop()

    arun(go())


def test_double_death_double_resume():
    """A second mid-stream death resumes again: a → b → c, all
    spliced into one exactly-once client stream."""
    async def go():
        a = JournalingReplica("a", die_after=2)
        b = JournalingReplica("b", die_after=3)
        c = JournalingReplica("c")
        fakes = [a, b, c]
        for f in fakes:
            await f.start()
        router, handles = await _make_journal_router(fakes)
        handles[0].snapshot = snap(depth=0)
        handles[1].snapshot = snap(depth=1)
        handles[2].snapshot = snap(depth=2)
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(base + "/v1/completions",
                                         json=STREAM_BODY)
                assert resp.status == 200
                texts, done = _texts(await resp.read())
            assert texts == [f"t{i} " for i in range(8)]
            assert done
            assert router.stats.resumed_mid_stream == 2
            assert router.stats.truncated_client_streams == 0
        finally:
            await runner.cleanup()
            await router.stop()
            for f in fakes:
                await f.stop()

    arun(go())


def test_replaying_continuation_dedupes_on_emitted_count():
    """Exactly-once against a buggy/replaying upstream: the
    continuation re-emits the whole stream from token 0; the router
    suppresses every already-delivered record's data lines."""
    async def go():
        a = JournalingReplica("a", die_after=3)
        b = JournalingReplica("b", replay_from_zero=True)
        await a.start()
        await b.start()
        router, handles = await _make_journal_router([a, b])
        handles[0].snapshot = snap(depth=0)
        handles[1].snapshot = snap(depth=5)
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(base + "/v1/completions",
                                         json=STREAM_BODY)
                assert resp.status == 200
                texts, done = _texts(await resp.read())
            assert texts == [f"t{i} " for i in range(8)]
            assert done
            assert router.stats.resumed_mid_stream == 1
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()
            await b.stop()

    arun(go())


def test_truncation_fallback_when_no_peer():
    """Retry-budget/fleet exhaustion keeps truthful truncation: with
    no healthy peer the client sees the delivered prefix and no
    [DONE], counted in truncated_client_streams."""
    async def go():
        a = JournalingReplica("a", die_after=3)
        await a.start()
        router, handles = await _make_journal_router([a])
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(base + "/v1/completions",
                                         json=STREAM_BODY)
                assert resp.status == 200
                try:
                    raw = await resp.read()
                except aiohttp.ClientError:
                    raw = b""
                texts, done = _texts(raw)
            # a was re-picked for the continuation and died again
            # (each attempt re-delivers nothing new past the dedupe);
            # eventually the budget runs out and the stream truncates.
            assert not done
            assert router.stats.truncated_client_streams == 1
            assert router.stats.served_streaming == 0
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()

    arun(go())


def test_journal_disabled_falls_back_to_truncation(monkeypatch):
    """APHRODITE_ROUTER_JOURNAL_TOKENS=0 turns the feature off: a
    mid-stream death truncates exactly like the pre-journal router,
    and no peer ever sees a continuation."""
    monkeypatch.setenv("APHRODITE_ROUTER_JOURNAL_TOKENS", "0")

    async def go():
        a = JournalingReplica("a", die_after=3)
        b = JournalingReplica("b")
        await a.start()
        await b.start()
        router, handles = await _make_journal_router([a, b])
        handles[0].snapshot = snap(depth=0)
        handles[1].snapshot = snap(depth=5)
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(base + "/v1/completions",
                                         json=STREAM_BODY)
                assert resp.status == 200
                try:
                    raw = await resp.read()
                except aiohttp.ClientError:
                    raw = b""
                _texts(raw)     # journal lines still never leak
            assert router.stats.truncated_client_streams == 1
            assert router.stats.resumed_mid_stream == 0
            assert len(b.requests) == 0
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()
            await b.stop()

    arun(go())


def test_journal_overflow_falls_back_to_truncation(monkeypatch):
    """A stream past the per-stream journal bound stops journaling:
    replica death then truncates instead of resuming with a partial
    journal (which would lose tokens)."""
    monkeypatch.setenv("APHRODITE_ROUTER_JOURNAL_TOKENS", "2")

    async def go():
        a = JournalingReplica("a", die_after=5)
        b = JournalingReplica("b")
        await a.start()
        await b.start()
        router, handles = await _make_journal_router([a, b])
        handles[0].snapshot = snap(depth=0)
        handles[1].snapshot = snap(depth=5)
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(base + "/v1/completions",
                                         json=STREAM_BODY)
                assert resp.status == 200
                try:
                    raw = await resp.read()
                except aiohttp.ClientError:
                    raw = b""
                texts, done = _texts(raw)
            assert texts == [f"t{i} " for i in range(5)]
            assert not done
            assert router.stats.truncated_client_streams == 1
            assert router.stats.resumed_mid_stream == 0
            assert len(b.requests) == 0
        finally:
            await runner.cleanup()
            await router.stop()
            await a.stop()
            await b.stop()

    arun(go())


def test_multi_sequence_and_nonstream_requests_not_journaled():
    """Journal eligibility: non-streaming bodies and multi-sequence
    requests (resume cannot represent them) are never journaled."""
    async def go():
        a = JournalingReplica("a")
        await a.start()
        router, handles = await _make_journal_router([a])
        assert router._journal_context(_FakeReq("POST",
                                                "/v1/completions"),
                                       {"stream": True}, None) \
            is not None
        assert router._journal_context(
            _FakeReq("POST", "/v1/completions"),
            {"stream": True, "n": 2}, None) is None
        assert router._journal_context(
            _FakeReq("POST", "/v1/completions"),
            {"stream": True, "best_of": 4}, None) is None
        assert router._journal_context(
            _FakeReq("POST", "/v1/completions"), {}, None) is None
        assert router._journal_context(
            _FakeReq("POST", "/v1/chat/completions"),
            {"stream": True, "use_beam_search": True}, None) is None
        assert router._journal_context(
            _FakeReq("POST", "/metrics"), {"stream": True}, None) \
            is None
        # Kobold's stream path is always a token stream.
        assert router._journal_context(
            _FakeReq("POST", "/api/extra/generate/stream"),
            {"prompt": "x"}, None) is not None
        # A continuation is never wrapped again.
        assert router._journal_context(
            _FakeReq("POST", "/v1/completions"),
            {"stream": True,
             "aphrodite_resume": {"emitted_token_ids": []}},
            None) is None
        await router.stop()
        await a.stop()

    arun(go())


class _FakeReq:
    def __init__(self, method, path):
        self.method = method
        self.path = path
        self.rel_url = path


# ------------------------------------------------------------------
# journal tail parser units
# ------------------------------------------------------------------

def test_journal_tail_commits_only_forwarded_data():
    """A record commits only once its data line is forwarded — a kill
    between record and data line must NOT count the token as
    delivered (the continuation regenerates it)."""
    tail = _JournalTail(max_tokens=100)
    out = tail.feed(b': aphrodite-journal {"t":[7],"n":1}\n')
    assert out == b""
    assert tail.tokens == []          # record pending, not committed
    out = tail.feed(b'data: {"x": 1}\n\n')
    assert out == b'data: {"x": 1}\n\n'
    assert tail.tokens == [7]
    assert tail.active


def test_journal_tail_holds_partial_lines():
    """Torn lines are held back until complete — a mid-line death
    never leaks a partial event to the client."""
    tail = _JournalTail(max_tokens=100)
    assert tail.feed(b'data: {"par') == b""
    assert tail.feed(b'tial": 1}\n') == b'data: {"partial": 1}\n'
    tail2 = _JournalTail(max_tokens=100)
    assert tail2.feed(b': aphrodite-journal {"t":[1],"n"') == b""
    assert tail2.tokens == []


def test_journal_tail_dedupes_replayed_records():
    tail = _JournalTail(max_tokens=100)
    tail.feed(b': aphrodite-journal {"t":[1],"n":1}\ndata: a\n\n')
    tail.feed(b': aphrodite-journal {"t":[2],"n":2}\ndata: b\n\n')
    assert tail.tokens == [1, 2]
    # Replay of token 2 (n == already delivered): suppressed.
    out = tail.feed(
        b': aphrodite-journal {"t":[2],"n":2}\ndata: b\n\n')
    assert b"data: b" not in out
    # The next NEW record resumes forwarding.
    out = tail.feed(
        b': aphrodite-journal {"t":[3],"n":3}\ndata: c\n\n')
    assert b"data: c" in out
    assert tail.tokens == [1, 2, 3]


def test_journal_tail_kobold_event_line_does_not_commit():
    """Kobold writes 'event: message' before its data line; only the
    data line commits the pending record."""
    tail = _JournalTail(max_tokens=100)
    tail.feed(b': aphrodite-journal {"t":[5],"n":1}\n')
    out = tail.feed(b"event: message\n")
    assert out == b"event: message\n"
    assert tail.tokens == []
    tail.feed(b'data: {"token": "x"}\n\n')
    assert tail.tokens == [5]


def test_journal_tail_ooba_json_line_commits():
    tail = _JournalTail(max_tokens=100)
    tail.feed(b': aphrodite-journal {"t":[9],"n":1,"fin":"stop"}\n')
    tail.feed(b'{"results": [{"text": "x"}]}\n\n')
    assert tail.tokens == [9]
    assert tail.fin == "stop"


# ------------------------------------------------------------------
# health-poll jitter
# ------------------------------------------------------------------

def test_poll_phase_deterministic_and_spread():
    """Per-(router, replica) phase offsets are deterministic, lie in
    [0, 1), and de-synchronize both across replicas and across
    routers — no fleet-wide /health?probe=1 storm at each tick."""
    replicas = [ReplicaHandle(f"http://x{i}", name=f"r{i}")
                for i in range(8)]
    r1 = FleetRouter(replicas, name="router-A")
    r2 = FleetRouter(replicas, name="router-A")
    r3 = FleetRouter(replicas, name="router-B")
    phases1 = [r1.poll_phase(r) for r in replicas]
    assert phases1 == [r2.poll_phase(r) for r in replicas]
    assert all(0.0 <= p < 1.0 for p in phases1)
    assert len(set(phases1)) >= 6       # spread, not clustered
    phases3 = [r3.poll_phase(r) for r in replicas]
    assert phases1 != phases3           # routers de-synchronized


# ==================================================================
# Parity with the JAX package's router
# ==================================================================

def _affinity_inputs():
    rng = random.Random(7)
    long_ids = [rng.randrange(32000) for _ in range(300)]
    bodies = [
        None, "not a dict", {}, {"n": 2}, {"prompt": ""},
        {"prompt": "hello"}, {"prompt": "x" * 1000},
        {"prompt": [1, 2, 3]}, {"prompt": long_ids},
        {"prompt": [[1, 2], [3]]}, {"prompt": [long_ids, [4]]},
        {"prompt": ["first text", "second"]}, {"prompt": [""]},
        {"prompt": [[]]},
        {"messages": [{"role": "user", "content": "hi"}]},
        {"messages": [{"role": "system", "content": "y" * 900},
                      {"role": "user", "content": "q"}]},
        {"messages": [{"role": "user"}]}, {"messages": "raw chat"},
        {"messages": []},
    ]
    headers = [None, {}, {"X-Aphrodite-Session": "s1"},
               {"X-Aphrodite-Session": ""}]
    return bodies, headers


def test_rendezvous_and_affinity_key_match_jax():
    """The same keys hash to the same replicas, and the same requests
    give the same affinity keys, in both packages."""
    from aphrodite_tpu.fleet import router as jax_router
    from aphrodite_tpu.fleet.replica import ReplicaHandle as JaxHandle
    from aphrodite_tpu_torch.fleet.router import _rendezvous_score
    bodies, headers = _affinity_inputs()
    port = FleetRouter([ReplicaHandle("http://x", name="r")])
    ref = jax_router.FleetRouter([JaxHandle("http://x", name="r")])
    keys = []
    for h in headers:
        for b in bodies:
            key = port.affinity_key(h, b)
            assert key == ref.affinity_key(h, b), (h, b)
            keys.append(key)
    assert len({k for k in keys if k is not None}) >= 10
    names = [f"replica-{i}" for i in range(6)] + ["a", "b", ""]
    for key in [k for k in keys if k is not None] + ["", "ids:1,2"]:
        for name in names:
            assert _rendezvous_score(key, name) == \
                jax_router._rendezvous_score(key, name)
    # The same preferred replica for every key, fleet of six.
    replicas = [ReplicaHandle(f"http://x{i}", name=n)
                for i, n in enumerate(names[:6])]
    jax_replicas = [JaxHandle(f"http://x{i}", name=n)
                    for i, n in enumerate(names[:6])]
    for r in replicas + jax_replicas:
        r.snapshot = snap()
    port, ref = FleetRouter(replicas), jax_router.FleetRouter(jax_replicas)
    for key in [k for k in keys if k is not None]:
        assert port.pick(key).name == ref.pick(key).name


def _journal_stream(rng):
    """One upstream body mixing all three frontends' framings: OpenAI
    SSE, Kobold's `event: message` lines, Ooba's newline-JSON, a
    replayed record, a malformed one and a finishing one."""
    lines, n = [], 0
    for i in range(40):
        kind = rng.choice(("sse", "kobold", "ooba"))
        if i in (12, 13):               # replay of what was delivered
            lines.append(f': aphrodite-journal {{"t":[{100 + n - 1}],'
                         f'"n":{n}}}\n')
        else:
            n += 1
            fin = ',"fin":"length"' if i == 39 else ""
            lines.append(f': aphrodite-journal {{"t":[{100 + n}],'
                         f'"n":{n}{fin}}}\n')
        if i == 20:
            lines.append(": aphrodite-journal {not json\n")
        if kind == "kobold":
            lines.append("event: message\n")
            lines.append(f'data: {{"token": "t{i} "}}\n\n')
        elif kind == "ooba":
            lines.append(f'{{"results": [{{"text": "t{i}"}}]}}\n\n')
        else:
            lines.append(f'data: {{"i": {i}}}\n\n')
    lines.append("data: [DONE]")           # no final newline: flush()
    return "".join(lines).encode()


@pytest.mark.parametrize("seed,max_tokens", [(0, 100), (1, 100), (2, 7)])
def test_journal_tail_matches_jax(seed, max_tokens):
    """The same byte chunks, cut at random points (mid-line included),
    give the same forwarded bytes, commits, finish reason and overflow
    in both packages' `_JournalTail`."""
    from aphrodite_tpu.fleet.router import _JournalTail as JaxJournalTail
    rng = random.Random(seed)
    raw = _journal_stream(rng)
    cuts = sorted(rng.sample(range(1, len(raw)), 60))
    chunks = [raw[a:b] for a, b in zip([0] + cuts, cuts + [len(raw)])]
    port, ref = _JournalTail(max_tokens), JaxJournalTail(max_tokens)
    for chunk in chunks:
        assert port.feed(chunk) == ref.feed(chunk)
        assert port.tokens == ref.tokens
        assert (port.fin, port.active, port.overflowed) == \
            (ref.fin, ref.active, ref.overflowed)
    assert port.flush() == ref.flush() == b"data: [DONE]"
    assert port.tokens == list(range(101, 101 + len(port.tokens)))
    assert len(port.tokens) == 38
    assert port.overflowed == (max_tokens < 38)


# ==================================================================
# End to end over port servers
# ==================================================================

ENGINE_KW = dict(load_format="dummy", dtype="float32", block_size=16,
                 max_model_len=256, max_num_seqs=8, swap_space=0.01,
                 disable_log_stats=True, disable_log_requests=True)
ADMIN_KEY = "fleet-key"


@pytest.fixture
def _no_injected_faults(monkeypatch):
    from aphrodite_tpu.common import faultinject as jax_faults
    from aphrodite_tpu_torch.common import faultinject
    monkeypatch.delenv("APHRODITE_FAULT", raising=False)
    monkeypatch.delenv("APHRODITE_FAULT_SEED", raising=False)
    jax_faults.reset()
    faultinject.reset()


def _port_engines_on_jax_weights(model_dir, n):
    """A JAX AsyncAphrodite and `n` port ones holding its weights."""
    import jax
    import numpy as np
    import torch
    from aphrodite_tpu.engine.args_tools import (
        AsyncEngineArgs as JaxAsyncEngineArgs)
    from aphrodite_tpu.engine.async_aphrodite import (
        AsyncAphrodite as JaxAsyncAphrodite)
    from aphrodite_tpu_torch.engine.args_tools import AsyncEngineArgs
    from aphrodite_tpu_torch.engine.async_aphrodite import AsyncAphrodite
    from aphrodite_tpu_torch.modeling.convert import (params_from_jax,
                                                      to_device)
    jax_engine = JaxAsyncAphrodite.from_engine_args(JaxAsyncEngineArgs(
        model=model_dir, **ENGINE_KW))
    host = jax.tree_util.tree_map(np.asarray,
                                  jax_engine.engine.executor.params)
    ports = []
    for _ in range(n):
        port = AsyncAphrodite.from_engine_args(AsyncEngineArgs(
            model=model_dir, device="cpu", **ENGINE_KW))
        params = to_device(params_from_jax(host), torch.device("cpu"),
                           torch.float32)
        port.engine.executor.params = params
        port.engine.executor.model_runner.params = params
        ports.append(port)
    return jax_engine, ports


async def _serve(app):
    """(runner, url) of `app` on a free localhost port; the runner's
    cleanup cancels in-flight handlers after 10 ms (a timeout of 0
    would wait for them without bound)."""
    runner = web.AppRunner(app, shutdown_timeout=0.01)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, f"http://127.0.0.1:{runner.addresses[0][1]}"


def test_router_resumes_a_port_kobold_stream_mid_way(tiny_model_dir,
                                                    _no_injected_faults):
    """Two port Kobold replicas behind the port's router, on engines
    holding the JAX engine's weights. Replica A is stopped (its runner
    cleaned up) once the client has read its first token event; the
    router resumes on B from the journal, and the client's events
    concatenate to the uninterrupted JAX app's greedy text, each token
    once. B's continuation carried exactly the JAX app's first ids."""
    import torch
    from aiohttp.test_utils import TestClient, TestServer
    from aphrodite_tpu.endpoints.kobold.api_server import (
        build_app as jax_kobold)
    from aphrodite_tpu_torch.endpoints.kobold.api_server import (
        build_app as port_kobold)
    body = {"prompt": "the quick brown fox jumps over the lazy dog",
            "max_length": 24, "max_context_length": 128,
            "temperature": 0.0}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_engine, (engine_a, engine_b) = _port_engines_on_jax_weights(
        tiny_model_dir, 2)
    # A steps slowly, so it is still streaming when it is stopped.
    real_step = engine_a.engine.step

    def slow_step():
        import time
        time.sleep(0.05)
        return real_step()
    engine_a.engine.step = slow_step

    continuations = []

    @web.middleware
    async def record(request, handler):
        body = await request.json()
        if "aphrodite_resume" in body:
            continuations.append(body["aphrodite_resume"])
        return await handler(request)

    async def go():
        ref = TestClient(TestServer(jax_kobold(jax_engine, "tiny")))
        await ref.start_server()
        r = await ref.post("/api/extra/generate/stream", json=body,
                           headers={JOURNAL_HEADER: "1"})
        raw = await r.read()
        await ref.close()
        want_ids = [t for line in raw.split(b"\n")
                    if line.startswith(b": aphrodite-journal ")
                    for t in json.loads(line[20:])["t"]]
        want_text = "".join(json.loads(line[6:])["token"]
                            for line in raw.split(b"\n")
                            if line.startswith(b"data: "))
        assert len(want_ids) == 24

        runner_a, url_a = await _serve(port_kobold(
            engine_a, "tiny", admin_keys=[ADMIN_KEY]))
        app_b = port_kobold(engine_b, "tiny", admin_keys=[ADMIN_KEY])
        app_b.middlewares.append(record)
        runner_b, url_b = await _serve(app_b)
        handles = [ReplicaHandle(url_a, name="a", admin_key=ADMIN_KEY),
                   ReplicaHandle(url_b, name="b", admin_key=ADMIN_KEY)]
        router = FleetRouter(handles, name="e2e-router")
        router._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=None, sock_connect=5.0))
        handles[0].snapshot = snap()
        handles[1].snapshot = snap(depth=30, inflight=10)   # A first
        runner, base = await _client_for(router)
        try:
            async with aiohttp.ClientSession() as client:
                resp = await client.post(
                    base + "/api/extra/generate/stream", json=body)
                assert resp.status == 200
                texts, stopped = [], False
                async for line in resp.content:
                    assert not line.startswith(b": aphrodite-journal")
                    if line.startswith(b"data: "):
                        texts.append(json.loads(line[6:])["token"])
                        if not stopped:
                            await runner_a.cleanup()
                            stopped = True
            assert "".join(texts) == want_text
            assert router.stats.resumed_mid_stream == 1
            assert router.stats.truncated_client_streams == 0
            assert len(continuations) == 1
            emitted = continuations[0]["emitted_token_ids"]
            assert 1 <= len(emitted) < 24
            assert emitted == want_ids[:len(emitted)]
        finally:
            await runner.cleanup()
            await router.stop()
            await runner_a.cleanup()
            await runner_b.cleanup()

    try:
        arun(go())
    finally:
        torch.set_num_threads(threads)


# ==================================================================
# FleetLauncher: port replica processes
# ==================================================================

def test_launcher_spawns_the_port_server():
    """The launcher's argv names the port's OpenAI server module."""
    from aphrodite_tpu_torch.fleet.launcher import FleetLauncher
    launcher = FleetLauncher("some/model", 2, admin_key="k",
                             extra_args=["--device", "cpu"],
                             ports=[1234, 1235])
    argv = launcher.processes[1].argv
    assert argv[1:3] == ["-m",
                         "aphrodite_tpu_torch.endpoints.openai.api_server"]
    assert argv[argv.index("--port") + 1] == "1235"
    assert argv[-2:] == ["--device", "cpu"]
    assert [h.url for h in launcher.handles()] == [
        "http://127.0.0.1:1234", "http://127.0.0.1:1235"]


def test_replica_without_device_cpu_exits_without_a_card(tiny_model_dir,
                                                         tmp_path):
    """A replica started without `--device cpu` takes `auto`, which
    needs a card: on a machine without one it exits at start, and
    `start_all` says so; it never serves on the CPU."""
    import torch
    from aphrodite_tpu_torch.fleet.launcher import FleetLauncher
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: `auto` would serve on it")
    launcher = FleetLauncher(
        tiny_model_dir, 1, admin_key="k", log_dir=str(tmp_path),
        extra_args=["--load-format", "dummy", "--dtype", "float32"])

    async def go():
        try:
            with pytest.raises(RuntimeError, match="exited during startup"):
                await launcher.start_all(ready_timeout_s=90.0)
        finally:
            await launcher.shutdown()
    arun(go())
    log = (tmp_path / "replica-0.log").read_text()
    assert "needs a CUDA card" in log


@pytest.mark.slow
def test_launcher_failover_over_port_replicas(tiny_model_dir, tmp_path,
                                              monkeypatch):
    """Two port replica processes (`--device cpu --load-format dummy`)
    behind the port's router with its poll loop running: SIGKILL one,
    and every later request is still served, by the other."""
    from aphrodite_tpu_torch.fleet.launcher import FleetLauncher
    monkeypatch.setenv("APHRODITE_ROUTER_POLL_S", "0.2")
    monkeypatch.delenv("APHRODITE_FAULT", raising=False)
    launcher = FleetLauncher(
        tiny_model_dir, 2, admin_key=ADMIN_KEY, log_dir=str(tmp_path),
        extra_args=["--device", "cpu", "--load-format", "dummy",
                    "--dtype", "float32", "--max-model-len", "256",
                    "--max-num-seqs", "4", "--swap-space", "0.01"])
    body = {"model": "fleet", "prompt": [11, 23, 37, 41], "max_tokens": 4,
            "temperature": 0.0, "ignore_eos": True}

    async def go():
        router = None
        try:
            await launcher.start_all(ready_timeout_s=180.0)
            router = FleetRouter(launcher.handles(), admin_keys=[ADMIN_KEY],
                                 restart_cb=launcher.restart)
            await router.start()
            runner, base = await _client_for(router)
            try:
                async with aiohttp.ClientSession(
                        timeout=aiohttp.ClientTimeout(total=60)) as client:
                    first = []
                    for _ in range(2):
                        resp = await client.post(base + "/v1/completions",
                                                 json=body)
                        assert resp.status == 200, await resp.text()
                        first.append((await resp.json())["choices"])
                    launcher.kill(0)
                    await launcher.processes[0].wait_exit(30.0)
                    for _ in range(4):
                        resp = await client.post(base + "/v1/completions",
                                                 json=body)
                        assert resp.status == 200, await resp.text()
                        assert (await resp.json())["choices"][0]["text"] \
                            == first[0][0]["text"]
                stats = router.stats
                assert stats.retries_conn >= 1 or \
                    launcher.handles()[0].circuit_broken()
            finally:
                await runner.cleanup()
        finally:
            if router is not None:
                await router.stop()
            await launcher.shutdown()
    asyncio.run(asyncio.wait_for(go(), 300))
