"""Async serving engine: per-request streams over a SUPERVISED
background step loop (port of `aphrodite_tpu/engine/async_aphrodite.py`,
copied with its import paths rewritten).

Reference: `aphrodite/engine/async_aphrodite.py` (AsyncStream `:41`,
RequestTracker `:73`, _AsyncAphrodite.step_async `:175`, AsyncAphrodite
`:280`, run_engine_loop `:404`, generate `:469`, abort `:569`).

The engine step is dispatched from a thread-pool executor so the
asyncio loop stays responsive while the card runs: on a CUDA engine
every kernel launch comes from that worker thread. The kernels' first
build and load happen under a lock (`ops/cuda/build.py`), the launch
counters are locked, and a CUDA error raised in the step reaches the
awaiting streams through the supervisor below, never as a hang.

Supervision (engine/supervisor.py): step failures are classified by
blast radius — request-scoped failures error only the culprit stream,
transient engine failures are crash-rolled-back and retried with
bounded exponential backoff (`APHRODITE_STEP_RETRIES` /
`APHRODITE_STEP_BACKOFF_S`). FATAL failures trigger **reincarnation**
(`_try_reincarnate`): up to `APHRODITE_REINCARNATIONS` times, the
engine tears down and rebuilds its executor/model-runner/KV pool
under the REBUILDING health state, restores every restorable request
to the waiting queue with streams intact, and resumes the loop — only
an exhausted budget (or a failed rebuild) moves the engine to the
terminal DEAD state where in-flight, pending, and new requests all
fail fast with `AsyncEngineDeadError` instead of hanging. A watchdog
(`APHRODITE_STEP_TIMEOUT_S`) bounds the off-loop step so a hung build
or device call is detected rather than wedging forever behind a
healthy-looking `check_health`.

Lifecycle (graceful drain): `start_drain()` moves the replica to the
DRAINING health state — new requests are rejected with a typed
`EngineDrainingError` (HTTP 503 + Retry-After at the frontends, kept
deliberately distinct from overload's 429) while in-flight requests
run to completion under a drain deadline
(`APHRODITE_DRAIN_DEADLINE_S`); `drained()` resolves when the replica
is idle (or the deadline force-aborts the stragglers), letting
SIGTERM handlers exit the process without dropping accepted work.

Overload control (processing/admission.py): `add_request` consults
the engine's admission controller BEFORE enqueueing — requests past
the queue caps or whose predicted TTFT already exceeds their deadline
raise `RequestRejectedError` (HTTP 429 + Retry-After at the
frontends) and flip health to DEGRADED-while-shedding; disconnects
route through `AsyncStream.cancel()`/`__del__`/`GeneratorExit` into
`abort()` so hung-up clients release KV pages within one step.
"""
from __future__ import annotations

import asyncio
import functools
import time
from typing import (AsyncIterator, Callable, Dict, Iterable, List,
                    Optional, Set, Tuple, Type, Union)

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.outputs import RequestOutput
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
from aphrodite_tpu_torch.engine.args_tools import AsyncEngineArgs
from aphrodite_tpu_torch.engine.supervisor import (FaultClass, HealthMonitor,
                                             HealthReport,
                                             StepTimeoutError,
                                             classify_failure,
                                             reincarnation_policy,
                                             retry_policy)
from aphrodite_tpu_torch.processing.admission import (EngineDrainingError,
                                                RequestRejectedError)

logger = init_logger(__name__)


class AsyncEngineDeadError(RuntimeError):
    pass


def _consume_abandoned_step(fut) -> None:
    """Done-callback for a step the watchdog abandoned: retrieve its
    eventual result/exception so the loop never logs an unretrieved-
    exception warning for a thread we already declared dead."""
    if fut.cancelled():
        return
    exc = fut.exception()
    if exc is not None:
        logger.error("watchdog-abandoned engine step eventually "
                     "failed: %s: %s", type(exc).__name__, exc)
    else:
        logger.warning("watchdog-abandoned engine step eventually "
                       "completed; its outputs are discarded")


def _finalize_engine_loop(task: asyncio.Task,
                          request_tracker: "RequestTracker",
                          health: HealthMonitor,
                          idle_event: asyncio.Event) -> None:
    """Done-callback of the background loop. The loop exits cleanly
    after recording DEAD (engine_step handles its own failures), so an
    exception here means a bug in the loop itself — record it in the
    health state machine and fail the streams instead of re-raising
    into the event loop's unhandled-exception logger (noise nothing
    catches). Either way the idle event fires so a `drained()` waiter
    wakes and observes the death instead of waiting forever."""
    if task.cancelled():
        return
    exc = task.exception()
    idle_event.set()
    if exc is None:
        return                  # clean exit: DEAD already recorded
    logger.error("engine loop terminated unexpectedly: %s: %s",
                 type(exc).__name__, exc)
    health.mark_dead(exc)
    err = AsyncEngineDeadError(
        "Engine loop terminated unexpectedly "
        f"({type(exc).__name__}: {exc}). Restart the server.")
    err.__cause__ = exc
    request_tracker.fail_all(err)


class AsyncStream:
    """Per-request stream of RequestOutputs (reference `:41`).

    Disconnect propagation: a consumer that stops iterating (client
    hung up, response handler GC'd) must not leave the request
    running — `cancel()` (and, as a backstop, `__del__`) routes
    through the tracker's abort so the engine releases the request's
    KV pages within one step instead of at garbage-collection time.
    """

    def __init__(self, request_id: str,
                 abort_cb: Optional[Callable[[str], None]] = None
                 ) -> None:
        self.request_id = request_id
        # bounded-by: reader-paced; at most one item per engine round,
        # capped by the request's max_tokens outputs
        self._queue: asyncio.Queue = asyncio.Queue()
        self._finished = False
        self._abort_cb = abort_cb

    def put(self, item: Union[RequestOutput, Exception]) -> None:
        if self._finished:
            return
        self._queue.put_nowait(item)

    def finish(self) -> None:
        self._queue.put_nowait(StopAsyncIteration())
        self._finished = True
        self._abort_cb = None

    def cancel(self) -> None:
        """Consumer is gone: abort the underlying request so its KV
        pages free within one step. Idempotent; a finished stream is
        a no-op."""
        cb, self._abort_cb = self._abort_cb, None
        if cb is not None and not self._finished:
            cb(self.request_id)

    def __del__(self) -> None:
        # Backstop for consumers that drop the stream mid-request
        # without finish/cancel (the disconnect-storm leak this layer
        # exists to close). Best-effort: GC can run after the event
        # loop is gone.
        try:
            self.cancel()
        except Exception as e:
            logger.debug("stream %s cleanup abort failed: %s",
                         self.request_id, e)

    @property
    def finished(self) -> bool:
        return self._finished

    def __aiter__(self):
        return self

    async def __anext__(self) -> RequestOutput:
        result = await self._queue.get()
        if isinstance(result, Exception):
            raise result
        return result


class RequestTracker:
    """Synchronizes request arrival/abort between frontend coroutines and
    the engine loop (reference `:73`)."""

    def __init__(self) -> None:
        self._request_streams: Dict[str, AsyncStream] = {}
        # bounded-by: at most one entry per tracked request, drained
        # every engine_step
        self._finished_requests: asyncio.Queue = asyncio.Queue()
        # bounded-by: admission controller caps arrivals
        # (APHRODITE_MAX_QUEUE_DEPTH) before they reach this queue
        self._new_requests: asyncio.Queue = asyncio.Queue()
        self.new_requests_event: Optional[asyncio.Event] = None
        # Enqueued-but-not-yet-transferred load, counted by admission
        # so a same-tick burst cannot slip past the queue caps before
        # the engine loop moves it into the scheduler's queue.
        self._pending_new = 0
        self._pending_tokens = 0

    def pending_load(self) -> Tuple[int, int]:
        """(requests, estimated prompt tokens) enqueued but not yet
        handed to the engine."""
        return self._pending_new, self._pending_tokens

    def tracked_ids(self) -> List[str]:
        """Request ids with a live stream (drain force-abort scope)."""
        return list(self._request_streams)

    def __contains__(self, item) -> bool:
        return item in self._request_streams

    def init_event(self) -> None:
        self.new_requests_event = asyncio.Event()

    def propagate_exception(self, exc: Exception,
                            request_id: Optional[str] = None) -> None:
        if request_id is not None:
            # An abort can race a step error: the request may already
            # be untracked by the time its exception arrives. Dropping
            # is correct — the stream was finished by the abort — and
            # must not KeyError (that would kill the loop this call
            # was trying to save).
            stream = self._request_streams.get(request_id)
            if stream is not None:
                stream.put(exc)
        else:
            for stream in self._request_streams.values():
                stream.put(exc)

    def fail_all(self, exc: Exception) -> None:
        """Terminal failure: error every tracked stream AND every
        queued-but-not-yet-tracked request (a request enqueued just
        before the engine died must fail fast, not hang)."""
        while not self._new_requests.empty():
            stream, _ = self._new_requests.get_nowait()
            self._request_streams.setdefault(stream.request_id, stream)
        self.propagate_exception(exc)

    def process_request_output(self, request_output: RequestOutput,
                               *, verbose: bool = False) -> None:
        request_id = request_output.request_id
        if request_id not in self._request_streams:
            return          # already aborted
        self._request_streams[request_id].put(request_output)
        if request_output.finished:
            if verbose:
                logger.info("Finished request %s.", request_id)
            self.abort_request(request_id)

    def add_request(self, request_id: str,
                    **engine_add_request_kwargs) -> AsyncStream:
        if request_id in self._request_streams:
            raise KeyError(f"Request {request_id} already exists.")
        stream = AsyncStream(request_id, abort_cb=self.abort_request)
        self._new_requests.put_nowait(
            (stream, {"request_id": request_id,
                      **engine_add_request_kwargs}))
        self._pending_new += 1
        self._pending_tokens += AsyncAphrodite._estimate_prompt_tokens(
            engine_add_request_kwargs.get("prompt"),
            engine_add_request_kwargs.get("prompt_token_ids"),
            engine_add_request_kwargs.get("emitted_token_ids"))
        if self.new_requests_event is not None:
            self.new_requests_event.set()
        return stream

    def abort_request(self, request_id: str, *,
                      verbose: bool = False) -> None:
        if verbose:
            logger.info("Aborted request %s.", request_id)
        self._finished_requests.put_nowait(request_id)
        if request_id not in self._request_streams or \
                self._request_streams[request_id].finished:
            return
        self._request_streams[request_id].finish()

    def get_new_and_finished_requests(
            self) -> Tuple[List[dict], Set[str]]:
        new_requests: List[dict] = []
        finished_requests: Set[str] = set()
        while not self._finished_requests.empty():
            request_id = self._finished_requests.get_nowait()
            finished_requests.add(request_id)
            self._request_streams.pop(request_id, None)
        while not self._new_requests.empty():
            stream, request = self._new_requests.get_nowait()
            if stream.request_id in finished_requests:
                stream.finish()       # aborted before scheduling
                continue
            self._request_streams[stream.request_id] = stream
            new_requests.append(request)
        # The queue drained fully: the pending load is now visible to
        # admission through the scheduler's own queue.
        self._pending_new = 0
        self._pending_tokens = 0
        if self.new_requests_event is not None:
            self.new_requests_event.clear()
        return new_requests, finished_requests

    async def wait_for_new_requests(self) -> None:
        await self.new_requests_event.wait()


class AsyncAphrodite:
    """Async wrapper: background loop drives the sync engine
    (reference `:280`)."""

    def __init__(self, *args, log_requests: bool = True,
                 start_engine_loop: bool = True,
                 max_log_len: Optional[int] = None, **kwargs) -> None:
        self.engine = AphroditeEngine(*args, **kwargs)
        self.log_requests = log_requests
        self.max_log_len = max_log_len
        self.start_engine_loop = start_engine_loop
        self._request_tracker = RequestTracker()
        self.health = HealthMonitor()
        self.background_loop: Optional[asyncio.Future] = None
        self._background_loop_unshielded = None
        # Set while the replica is idle (no in-flight, no pending),
        # cleared on every arrival; `drained()` waits on it instead of
        # polling. Recreated per loop start so it binds to the live
        # loop; set on death so drain waiters wake.
        self._idle_event: asyncio.Event = asyncio.Event()
        self._idle_event.set()
        # Lifecycle gauges (state code, reincarnation counters, drain
        # remaining) ride the engine's per-round Stats into Prometheus.
        self.engine.lifecycle_source = self._lifecycle_stats

    @classmethod
    def from_engine_args(cls, engine_args: AsyncEngineArgs,
                         start_engine_loop: bool = True
                         ) -> "AsyncAphrodite":
        configs = engine_args.create_engine_configs()
        return cls(*configs,
                   log_stats=not engine_args.disable_log_stats,
                   skip_tokenizer_init=engine_args.skip_tokenizer_init,
                   log_requests=not engine_args.disable_log_requests,
                   max_log_len=engine_args.max_log_len,
                   start_engine_loop=start_engine_loop)

    @property
    def is_running(self) -> bool:
        return (self.background_loop is not None
                and not self.background_loop.done())

    def start_background_loop(self) -> None:
        if self.is_running:
            raise RuntimeError("Background loop is already running.")
        if self.health.is_dead:
            raise AsyncEngineDeadError(
                "Engine is DEAD and cannot be restarted in-process: "
                + (self.health.dead_reason or "unknown failure"))
        self._request_tracker.init_event()
        # get_running_loop, not get_event_loop: the engine may be
        # driven from a worker thread's loop (fleet mode), where the
        # deprecated API grabs — or creates — the wrong loop.
        loop = asyncio.get_running_loop()
        # Fresh per loop start: asyncio primitives bind lazily to the
        # loop that first waits on them, and a restarted engine must
        # not wait on an event bound to a dead loop.
        self._idle_event = asyncio.Event()
        self._idle_event.set()
        self._background_loop_unshielded = loop.create_task(
            self.run_engine_loop())
        self._background_loop_unshielded.add_done_callback(
            functools.partial(_finalize_engine_loop,
                              request_tracker=self._request_tracker,
                              health=self.health,
                              idle_event=self._idle_event))
        self.background_loop = asyncio.shield(
            self._background_loop_unshielded)

    async def _step_with_watchdog(self) -> List[RequestOutput]:
        """Run the (blocking, device-dispatching) step off-loop, bounded
        by APHRODITE_STEP_TIMEOUT_S when set. A timed-out step leaves
        its executor thread wedged (a hung kernel build or device call
        is uninterruptible from Python), so timeout is terminal — the
        point is detection instead of a forever-'healthy' hang."""
        loop = asyncio.get_running_loop()
        fut = loop.run_in_executor(None, self.engine.step)
        timeout = flags.get_float("APHRODITE_STEP_TIMEOUT_S")
        if not timeout or timeout <= 0:
            return await fut
        done, _ = await asyncio.wait({fut}, timeout=timeout)
        if done:
            return fut.result()
        fut.add_done_callback(_consume_abandoned_step)
        raise StepTimeoutError(
            f"engine step exceeded APHRODITE_STEP_TIMEOUT_S="
            f"{timeout:g}s; the step thread is wedged (likely a hung "
            "compile or device call)")

    def _propagate_step_faults(self) -> None:
        """Deliver request-scoped step failures to exactly the culprit
        streams (the engine quarantined and freed those requests)."""
        for request_id, exc in self.engine.drain_step_faults():
            self._request_tracker.propagate_exception(exc, request_id)
            self._request_tracker.abort_request(request_id)

    async def _try_reincarnate(self, exc: BaseException) -> bool:
        """Attempt a bounded engine rebuild after a FATAL step fault.

        Returns True when the engine was rebuilt and the loop should
        resume stepping (restorable requests are back in `waiting`,
        un-restorable streams got their typed errors); False when the
        budget is exhausted or the rebuild itself failed — the caller
        falls through to the terminal DEAD path.
        """
        max_rebuilds, base_backoff = reincarnation_policy()
        n = self.health.reincarnations_total + 1
        if n > max_rebuilds:
            if max_rebuilds > 0:
                logger.error(
                    "Reincarnation budget exhausted "
                    "(APHRODITE_REINCARNATIONS=%d); going DEAD.",
                    max_rebuilds)
            return False
        delay = base_backoff * (2 ** (n - 1)) if base_backoff else 0.0
        logger.warning(
            "FATAL engine fault (%s: %s): reincarnation %d/%d in "
            "%.2fs — rebuilding executor/KV pool and restoring the "
            "waiting queue.", type(exc).__name__, exc, n, max_rebuilds,
            delay)
        self.health.begin_rebuild()
        try:
            if delay:
                await asyncio.sleep(delay)
            t0 = time.monotonic()
            # Blocking (model load + cache init): off-loop, so the
            # event loop keeps answering /health with REBUILDING and
            # keeps queueing new arrivals for the rebuilt engine.
            outcome = await asyncio.get_running_loop().run_in_executor(
                None, self.engine.reincarnate)
        except Exception as rebuild_exc:
            logger.error("engine rebuild failed: %s: %s",
                         type(rebuild_exc).__name__, rebuild_exc)
            self.health.end_rebuild(success=False)
            return False
        self.health.end_rebuild(success=True, restored=outcome.restored,
                                lost=len(outcome.lost),
                                duration_s=time.monotonic() - t0)
        # Typed RequestLostOnRebuild for the casualties, delivered to
        # exactly those streams; restored streams just keep waiting.
        self._propagate_step_faults()
        logger.info(
            "Engine reincarnated in %.2fs: %d request(s) restored, "
            "%d lost (typed errors delivered).",
            self.health.last_rebuild_s or 0.0, outcome.restored,
            len(outcome.lost))
        return True

    def _die(self, exc: Exception) -> None:
        """Terminal transition: record DEAD, fail every in-flight and
        queued stream fast, and stop the loop."""
        self.health.mark_dead(exc)
        # Wake drained() waiters: they re-check and observe DEAD.
        self._idle_event.set()
        logger.error(
            "Engine is DEAD: %s: %s — in-flight and future requests "
            "will fail fast with AsyncEngineDeadError.",
            type(exc).__name__, exc)
        err = AsyncEngineDeadError(
            f"Engine loop is dead ({type(exc).__name__}: {exc}). "
            "Restart the server.")
        err.__cause__ = exc
        self._request_tracker.fail_all(err)
        raise err

    async def engine_step(self) -> bool:
        """Kick the engine; returns True if there is in-flight work.

        Supervision: transient step failures are retried (the engine's
        crash barrier already rolled the round back) with bounded
        exponential backoff; FATAL failures (and exhausted retries)
        attempt a bounded reincarnation — executor/KV rebuild with the
        waiting queue restored — before the terminal DEAD state."""
        new_requests, finished_requests = \
            self._request_tracker.get_new_and_finished_requests()

        for new_request in new_requests:
            try:
                self.engine.add_request(**new_request)
            except (ValueError, RuntimeError) as e:
                # Malformed request at admission (bad params, tokenizer
                # or LoRA failures — RuntimeErrors included): fail that
                # request, never the loop.
                request_id = new_request["request_id"]
                self._request_tracker.propagate_exception(e, request_id)
                self._request_tracker.abort_request(request_id)

        if finished_requests:
            self.engine.abort_request(finished_requests)

        max_retries, backoff = retry_policy()
        attempt = 0
        while True:
            try:
                request_outputs = await self._step_with_watchdog()
                break
            except Exception as exc:
                # Crash-barrier casualties first: their streams get the
                # rollback error even when the step itself is retried.
                self._propagate_step_faults()
                cls = classify_failure(exc)
                if cls is not FaultClass.FATAL and attempt < max_retries:
                    attempt += 1
                    self.health.record_failure(exc)
                    delay = backoff * (2 ** (attempt - 1))
                    logger.warning(
                        "Transient engine-step failure (attempt %d/%d,"
                        " retrying in %.3fs): %s: %s", attempt,
                        max_retries, delay, type(exc).__name__, exc)
                    await asyncio.sleep(delay)
                    continue
                # FATAL (or retries exhausted): the bigger hammer —
                # rebuild the engine and resume, budget permitting.
                if await self._try_reincarnate(exc):
                    attempt = 0     # fresh engine, fresh retry budget
                    continue
                self._die(exc)

        if attempt:
            self.health.record_recovery()
            logger.info("Engine step recovered after %d retr%s.",
                        attempt, "y" if attempt == 1 else "ies")
        self.health.beat()
        self._propagate_step_faults()
        for request_output in request_outputs:
            self._request_tracker.process_request_output(
                request_output, verbose=self.log_requests)
        # Idle accounting for drained(): the replica is idle when the
        # scheduler holds nothing and the tracker has no untransferred
        # arrivals. The event stays set while idle (no lost wakeups),
        # and add_request clears it on every arrival.
        if not self.engine.has_unfinished_requests() and \
                self._request_tracker.pending_load()[0] == 0:
            self._idle_event.set()
        else:
            self._idle_event.clear()
        # A chunked-prefill round can legitimately emit no outputs (it
        # only wrote prompt KV); the loop must keep stepping while any
        # request is mid-flight, not just while outputs flow.
        return (len(request_outputs) > 0
                or self.engine.has_unfinished_requests())

    async def run_engine_loop(self) -> None:
        has_requests_in_progress = False
        while True:
            if not has_requests_in_progress:
                await self._request_tracker.wait_for_new_requests()
            try:
                has_requests_in_progress = await self.engine_step()
            except AsyncEngineDeadError:
                # Terminal: streams already failed, health already
                # DEAD. Exit cleanly — the done-callback treats a
                # clean exit as 'already handled' (no event-loop
                # unhandled-exception noise).
                return
            await asyncio.sleep(0)

    async def add_request(
        self,
        request_id: str,
        prompt: Optional[str],
        sampling_params: SamplingParams,
        prompt_token_ids: Optional[List[int]] = None,
        arrival_time: Optional[float] = None,
        prefix_pos: Optional[int] = None,
        emitted_token_ids: Optional[List[int]] = None,
    ) -> AsyncStream:
        if self.log_requests:
            max_len = self.max_log_len if self.max_log_len is not None \
                else 80
            shortened = prompt
            if prompt and len(prompt) > max_len:
                shortened = prompt[:max_len] + ("…" if max_len else "")
            logger.info("Received request %s: prompt=%r params=%s",
                        request_id, shortened, sampling_params)
        if self.health.is_dead:
            # Fail fast BEFORE enqueueing: a dead engine's loop will
            # never drain the queue, and it must not be restarted over
            # a possibly-wedged step thread.
            raise AsyncEngineDeadError(
                "Engine is DEAD ("
                + (self.health.dead_reason or "unknown failure")
                + "); new requests fail fast. Restart the server.")
        if self.health.is_draining:
            # Drain gate, BEFORE the overload gate: a draining replica
            # answers 503 (go elsewhere), never 429 (retry here) — the
            # two must stay distinct for load balancers.
            rem = self.health.drain_remaining_s
            retry_after = 5.0 if rem is None else \
                max(1.0, min(rem + 1.0, 60.0))
            raise EngineDrainingError(
                "server is draining for shutdown; retry against "
                "another replica", retry_after_s=retry_after)
        # Overload gate: shed BEFORE enqueueing — a queue we cannot
        # drain in time is a promise we cannot keep. Rejected requests
        # never touch the tracker or the allocator; the frontends map
        # RequestRejectedError to HTTP 429 + Retry-After.
        if not self.health.is_rebuilding:
            # (During a rebuild the scheduler object is being swapped
            # off-loop; arrivals just queue in the tracker and face
            # admission again post-rebuild via pending_load.)
            pending_depth, pending_tokens = \
                self._request_tracker.pending_load()
            try:
                self.engine.try_admit(
                    self._estimate_prompt_tokens(prompt,
                                                 prompt_token_ids,
                                                 emitted_token_ids),
                    sampling_params, extra_depth=pending_depth,
                    extra_tokens=pending_tokens)
            except RequestRejectedError:
                self.health.record_shed()
                raise
        if not self.is_running:
            if self.start_engine_loop:
                self.start_background_loop()
            else:
                raise AsyncEngineDeadError(
                    "Background loop is not running. If it was running, "
                    "inspect the output to find the stacktrace of the "
                    "error that caused the background loop to stop "
                    "(AsyncEngineDeadError).")
        stream = self._request_tracker.add_request(
            request_id,
            prompt=prompt,
            sampling_params=sampling_params,
            prompt_token_ids=prompt_token_ids,
            # replay-ok: arrival stamp orders FCFS admission, never tokens
            # (token values derive from seed + output position alone)
            arrival_time=arrival_time or time.monotonic(),
            prefix_pos=prefix_pos,
            emitted_token_ids=emitted_token_ids)
        self._idle_event.clear()     # no longer idle: work arrived
        return stream

    async def generate(
        self,
        prompt: Optional[str],
        sampling_params: SamplingParams,
        request_id: str,
        prompt_token_ids: Optional[List[int]] = None,
        prefix_pos: Optional[int] = None,
        emitted_token_ids: Optional[List[int]] = None,
    ) -> AsyncIterator[RequestOutput]:
        """Stream RequestOutputs for one request (reference `:469`)."""
        try:
            stream = await self.add_request(
                request_id, prompt, sampling_params,
                prompt_token_ids=prompt_token_ids, prefix_pos=prefix_pos,
                emitted_token_ids=emitted_token_ids)
            async for request_output in stream:
                yield request_output
        except GeneratorExit:
            # Consumer dropped the generator without cancelling (the
            # client hung up and the handler was collected): abort so
            # the request's KV pages free within one step, not at GC
            # time.
            self._abort(request_id)
            raise
        except (Exception, asyncio.CancelledError) as e:
            self._abort(request_id)
            raise e

    async def abort(self, request_id: str) -> None:
        if not self.is_running:
            raise AsyncEngineDeadError("Background loop is not running.")
        self._abort(request_id)

    def abort_request(self, request_id: str) -> None:
        """Non-raising abort for disconnect/cleanup paths (the async
        `abort` raises once the loop is down; cleanup must not)."""
        self._abort(request_id)

    def _abort(self, request_id: str) -> None:
        self._request_tracker.abort_request(
            request_id, verbose=self.log_requests)

    # -- graceful drain (rolling restarts, SIGTERM) --------------------

    @property
    def is_draining(self) -> bool:
        return self.health.is_draining

    def start_drain(self, deadline_s: Optional[float] = None,
                    reason: str = "shutdown requested") -> float:
        """Enter DRAINING: new requests are rejected with a typed
        `EngineDrainingError` (HTTP 503 + Retry-After at the
        frontends) while in-flight work runs to completion. Returns
        the granted deadline in seconds (0 = unbounded). Idempotent —
        the first caller's deadline wins."""
        if self.health.is_draining:
            rem = self.health.drain_remaining_s
            return max(0.0, rem) if rem is not None else 0.0
        if deadline_s is None:
            deadline_s = flags.get_float("APHRODITE_DRAIN_DEADLINE_S")
        deadline = (time.monotonic() + deadline_s
                    if deadline_s and deadline_s > 0 else None)
        self.health.mark_draining(deadline)
        logger.info(
            "Draining (%s): new requests now get 503 + Retry-After; "
            "%s.", reason,
            f"in-flight work has {deadline_s:g}s to finish"
            if deadline is not None
            else "waiting for in-flight work without a deadline")
        return deadline_s if deadline is not None else 0.0

    async def drained(self) -> bool:
        """Resolve once the draining replica is idle. True = every
        in-flight request ran to completion; False = the drain
        deadline expired and the stragglers were aborted with a typed
        `EngineDrainingError` (or the engine died mid-drain). Safe to
        call from a SIGTERM handler task — the serving loop keeps
        running underneath.

        Event-driven, not polled: the engine loop keeps `_idle_event`
        set exactly while the replica is idle (and sets it on death),
        so this wakes the moment in-flight work hits zero; the only
        timer is the drain deadline itself. The event stays SET while
        idle, so there is no lost-wakeup window between the check and
        the wait."""
        while True:
            if self.health.is_dead:
                return False        # fail_all already errored streams
            if self._idle_event.is_set() or (
                    not self.engine.has_unfinished_requests() and
                    self._request_tracker.pending_load()[0] == 0):
                return True
            rem = self.health.drain_remaining_s
            if rem is not None and rem <= 0:
                err = EngineDrainingError(
                    "drain deadline exceeded; request aborted during "
                    "shutdown", retry_after_s=1.0)
                aborted = 0
                for rid in self._request_tracker.tracked_ids():
                    self._request_tracker.propagate_exception(err, rid)
                    self._abort(rid)
                    aborted += 1
                logger.warning(
                    "Drain deadline exceeded: aborted %d in-flight "
                    "request(s) with typed errors.", aborted)
                return False
            try:
                await asyncio.wait_for(self._idle_event.wait(),
                                       timeout=rem)
            except asyncio.TimeoutError:
                continue    # deadline hit: loop re-checks and aborts

    def _lifecycle_stats(self) -> dict:
        """Per-round lifecycle gauge values (merged into Stats by the
        sync engine; read from the step thread, so everything here is
        a cheap atomic read)."""
        h = self.health
        rem = h.drain_remaining_s
        return dict(
            state_code=h.state(in_flight=True).code,
            inflight=self.engine.get_num_unfinished_requests(),
            # -1 = no deadline ticking (not draining, or draining
            # unbounded — state_code distinguishes).
            drain_remaining_s=(-1.0 if rem is None else max(0.0, rem)),
            reincarnations_total=h.reincarnations_total,
            restored_total=h.requests_restored_total,
            lost_total=h.requests_lost_total)

    @staticmethod
    def _estimate_prompt_tokens(prompt: Optional[str],
                                prompt_token_ids: Optional[List[int]],
                                emitted_token_ids: Optional[List[int]]
                                = None) -> int:
        """Admission-sizing estimate (tokenization happens later, on
        the engine loop): exact for token-id prompts, ~4 chars/token
        for text. A continuation's emitted tokens prefill too, so they
        count. Admission caps are coarse backlog bounds, so the
        estimate only needs to be the right order of magnitude."""
        emitted = len(emitted_token_ids or ())
        if prompt_token_ids is not None:
            return len(prompt_token_ids) + emitted
        return max(1, len(prompt or "") // 4) + emitted

    async def get_model_config(self) -> ModelConfig:
        return self.engine.get_model_config()

    async def check_health(self) -> HealthReport:
        """RUNNING/DEGRADED/DRAINING/REBUILDING/DEAD report with
        last-step age, retry and lifecycle counters (surfaced by every
        frontend's /health endpoint); raises AsyncEngineDeadError when
        the engine can no longer serve."""
        if self.health.is_dead:
            raise AsyncEngineDeadError(
                "Engine is DEAD: "
                + (self.health.dead_reason or "unknown failure"))
        if not self.is_running and not self.start_engine_loop:
            # With lazy start the loop legitimately isn't running until
            # the first request — an idle fresh replica is healthy. A
            # crashed loop always records DEAD first (handled above).
            raise AsyncEngineDeadError("Background loop is stopped.")
        try:
            overload = self.engine.overload_snapshot().to_json()
        except RuntimeError as e:
            # Mid-rebuild the scheduler object is being swapped
            # off-loop; skip one snapshot rather than 500 the probe.
            logger.debug("overload snapshot unavailable: %s", e)
            overload = None
        return self.health.report(
            in_flight=self.engine.has_unfinished_requests(),
            overload=overload)
