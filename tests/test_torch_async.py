"""The PyTorch port's `AsyncAphrodite` and its engine's request
lifecycle, on the tiny model of tests/conftest.py in float32 on the CPU.
Mirrors the non-HTTP, non-disaggregated cases of
tests/engine/test_abort_storm.py, test_overload.py and
test_lifecycle.py, on the port's engines.

- Concurrent greedy and seeded streams (speculative decoding on, its
  default) equal the JAX `AsyncAphrodite`'s token for token, both given
  the JAX engine's dummy weights and the same pinned `num_gpu_blocks`.
- Aborts (before scheduling, mid-prefill, twice, a 100-request storm
  with and without injected transient faults) free every page and leave
  no ghost block table; so do dropped streams.
- Overload: a burst past the depth cap is shed in under 100 ms without
  touching the allocator; TTFT deadlines expire queued requests with
  the typed error, also during a drain.
- Lifecycle: a FATAL fault reincarnates the engine (the old executor's
  weights and pages released first) with outputs bit-equal to a
  fault-free run; an exhausted budget goes DEAD with typed errors; a
  kernel launch error in the step reaches the awaiting stream as the
  engine's typed error, never a hang; drains finish in-flight work and
  reject new work; the loop runs from a worker thread; `drained()` is
  event driven.
- The engine's profiler hooks write a torch.profiler trace.
"""
import asyncio
import gc
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from aphrodite_tpu_torch.common import faultinject
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.engine.supervisor import StaleEngineStepError
from aphrodite_tpu_torch.processing.admission import (EngineDrainingError,
                                                      RequestRejectedError,
                                                      RequestTimeoutError)

PROMPTS = [[(i * 7 + j * 3) % 90 + 5 for j in range(12)]
           for i in range(3)]
SP = dict(temperature=0.0, max_tokens=6, ignore_eos=True)
NUM_BLOCKS = 64

_LIFECYCLE_FLAGS = ("APHRODITE_REINCARNATIONS",
                    "APHRODITE_REINCARNATION_BACKOFF_S",
                    "APHRODITE_DRAIN_DEADLINE_S",
                    "APHRODITE_MAX_QUEUE_DEPTH",
                    "APHRODITE_FAULT", "APHRODITE_FAULT_SEED")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are too small to gain from
    more, and idle OpenMP threads spinning would slow the other test
    workers sharing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_lifecycle_state(monkeypatch):
    from aphrodite_tpu.common import faultinject as jax_faults
    for name in _LIFECYCLE_FLAGS:
        monkeypatch.delenv(name, raising=False)
    faultinject.reset()
    jax_faults.reset()
    yield
    faultinject.reset()


def _prompt(i, n=12):
    return [(i * 7 + j * 3) % 90 + 5 for j in range(n)]


def _engine_kw(model_dir, **kw):
    defaults = dict(model=model_dir, load_format="dummy", dtype="float32",
                    block_size=16, max_model_len=256, max_num_seqs=8,
                    swap_space=0.01, disable_log_stats=True,
                    skip_tokenizer_init=True, device="cpu")
    defaults.update(kw)
    return defaults


def _async_engine(model_dir, **kw):
    from aphrodite_tpu_torch.engine.args_tools import AsyncEngineArgs
    from aphrodite_tpu_torch.engine.async_aphrodite import AsyncAphrodite
    return AsyncAphrodite.from_engine_args(AsyncEngineArgs(
        disable_log_requests=True, **_engine_kw(model_dir, **kw)))


def _sync_engine(model_dir, **kw):
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    return AphroditeEngine.from_engine_args(
        EngineArgs(**_engine_kw(model_dir, **kw)))


async def _generate_all(engine, prompts, sp):
    async def one(i, p):
        final = None
        async for out in engine.generate(None, sp, f"req-{i}",
                                         prompt_token_ids=list(p)):
            final = out
        return final

    return await asyncio.gather(
        *(one(i, p) for i, p in enumerate(prompts)),
        return_exceptions=True)


def _run_async(model_dir, monkeypatch, spec):
    if spec:
        monkeypatch.setenv("APHRODITE_FAULT", spec)
    else:
        monkeypatch.delenv("APHRODITE_FAULT", raising=False)
    faultinject.reset()
    state = {}

    async def go():
        engine = _async_engine(model_dir)
        state["engine"] = engine
        return await _generate_all(engine, PROMPTS, SamplingParams(**SP))

    return asyncio.run(go()), state


def _assert_drained(engine, free0):
    sched = engine.scheduler
    assert not engine.has_unfinished_requests()
    assert (len(sched.waiting), len(sched.prefilling),
            len(sched.running), len(sched.swapped)) == (0, 0, 0, 0)
    assert sched.block_manager.get_num_free_gpu_blocks() == free0
    assert not sched.block_manager.block_tables, \
        "ghost block tables survived the aborts"


# ---------------------------------------------------------------------
# parity with the JAX AsyncAphrodite
# ---------------------------------------------------------------------

def test_concurrent_streams_match_jax_async(tiny_model_dir):
    """Eight concurrent streams of mixed prompt lengths, greedy and
    seeded, one with a prefix, with speculative decoding on (the
    default): each stream's tokens equal the JAX AsyncAphrodite's, and
    every page comes back."""
    from aphrodite_tpu.common.sampling_params import (
        SamplingParams as JaxSamplingParams)
    from aphrodite_tpu.engine.args_tools import (
        AsyncEngineArgs as JaxAsyncEngineArgs)
    from aphrodite_tpu.engine.async_aphrodite import (
        AsyncAphrodite as JaxAsyncAphrodite)
    from aphrodite_tpu_torch.engine.args_tools import AsyncEngineArgs
    from aphrodite_tpu_torch.engine.async_aphrodite import AsyncAphrodite
    from aphrodite_tpu_torch.modeling.convert import (params_from_jax,
                                                      to_device)
    kw = _engine_kw(tiny_model_dir)
    kw.pop("device")
    jcfg = JaxAsyncEngineArgs(**kw).create_engine_configs()
    jcfg[1].num_gpu_blocks = NUM_BLOCKS
    jax_engine = JaxAsyncAphrodite(*jcfg, log_requests=False,
                                   skip_tokenizer_init=True)
    tcfg = AsyncEngineArgs(device="cpu", **kw).create_engine_configs()
    tcfg[1].num_gpu_blocks = NUM_BLOCKS
    port = AsyncAphrodite(*tcfg, log_requests=False,
                          skip_tokenizer_init=True)
    host = jax.tree_util.tree_map(np.asarray,
                                  jax_engine.engine.executor.params)
    params = to_device(params_from_jax(host), torch.device("cpu"),
                       torch.float32)
    port.engine.executor.params = params
    port.engine.executor.model_runner.params = params

    pattern = [11, 23, 37, 41] * 5
    requests = [
        (pattern, dict(temperature=0.0, max_tokens=24), None),
        (_prompt(1, 5), dict(temperature=0.0, max_tokens=10), None),
        (_prompt(2, 40), dict(temperature=0.0, max_tokens=16), 32),
        (_prompt(3, 17), dict(temperature=1.0, seed=5, max_tokens=12),
         None),
        (pattern[:12], dict(temperature=0.8, seed=77, top_p=0.9,
                            max_tokens=20), None),
        (_prompt(4, 70), dict(temperature=0.0, max_tokens=8), None),
        (_prompt(5, 3), dict(temperature=0.0, max_tokens=14), None),
        (pattern + _prompt(6, 9), dict(temperature=0.0, max_tokens=18),
         None),
    ]

    async def serve(engine, sp_cls):
        async def one(i, prompt, sp, prefix_pos):
            final = None
            async for out in engine.generate(
                    None, sp_cls(ignore_eos=True, **sp), f"c{i}",
                    prompt_token_ids=list(prompt),
                    prefix_pos=prefix_pos):
                final = out
            return list(final.outputs[0].token_ids)
        return await asyncio.gather(*(one(i, *r)
                                      for i, r in enumerate(requests)))

    want = asyncio.run(serve(jax_engine, JaxSamplingParams))
    got = asyncio.run(serve(port, SamplingParams))
    assert got == want
    assert [len(t) for t in got] == [r[1]["max_tokens"] for r in requests]
    port.engine.scheduler.clear_prefixes()
    bm = port.engine.scheduler.block_manager
    assert bm.get_num_free_gpu_blocks() == NUM_BLOCKS
    assert not bm.block_tables


# ---------------------------------------------------------------------
# aborts (test_abort_storm.py)
# ---------------------------------------------------------------------

ABORT_SP = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)


def test_abort_before_schedule(tiny_model_dir):
    engine = _sync_engine(tiny_model_dir, max_num_seqs=128)
    free0 = engine.scheduler.block_manager.get_num_free_gpu_blocks()
    engine.add_request("a", None, ABORT_SP,
                       prompt_token_ids=list(range(5, 25)))
    engine.abort_request("a")
    _assert_drained(engine, free0)
    assert engine.step() == []


def test_abort_mid_prefill(tiny_model_dir):
    engine = _sync_engine(tiny_model_dir, max_num_seqs=128,
                          max_model_len=128, max_num_batched_tokens=128,
                          max_chunk_tokens=32, multi_step=1)
    free0 = engine.scheduler.block_manager.get_num_free_gpu_blocks()
    for i in range(3):
        engine.add_request(f"short{i}", None, ABORT_SP,
                           prompt_token_ids=list(range(5 + i, 21 + i)))
    engine.step()
    for r in range(2):
        engine.add_request(
            f"long{r}", None, ABORT_SP,
            prompt_token_ids=[(i * 7 + r) % 90 + 5 for i in range(120)])
    engine.step()
    assert engine.scheduler.prefilling
    free_mid = engine.scheduler.block_manager.get_num_free_gpu_blocks()
    engine.abort_request("long0")
    assert all(g.request_id != "long0"
               for g in engine.scheduler.prefilling)
    assert engine.scheduler.block_manager.get_num_free_gpu_blocks() \
        > free_mid
    assert not engine.scheduler.prefilling
    while engine.has_unfinished_requests():
        engine.step()
    _assert_drained(engine, free0)


def test_duplicate_abort_is_idempotent(tiny_model_dir):
    engine = _sync_engine(tiny_model_dir, max_num_seqs=128)
    free0 = engine.scheduler.block_manager.get_num_free_gpu_blocks()
    engine.add_request("a", None, ABORT_SP,
                       prompt_token_ids=list(range(5, 25)))
    engine.step()
    engine.abort_request("a")
    engine.abort_request("a")
    engine.abort_request("never-existed")
    _assert_drained(engine, free0)


@pytest.mark.parametrize("fault_spec", [
    "",
    "executor.execute_model:transient:0.3:3",
])
def test_100_request_abort_storm(tiny_model_dir, monkeypatch,
                                 fault_spec):
    if fault_spec:
        monkeypatch.setenv("APHRODITE_FAULT", fault_spec)
        faultinject.reset()
    engine = _sync_engine(tiny_model_dir, max_num_seqs=64)
    free0 = engine.scheduler.block_manager.get_num_free_gpu_blocks()
    ids = [f"storm-{i}" for i in range(100)]
    for i, rid in enumerate(ids):
        engine.add_request(
            rid, None, ABORT_SP,
            prompt_token_ids=[(i * 13 + j * 3) % 90 + 5
                              for j in range(8 + i % 17)])
    for _ in range(5):
        try:
            engine.step()
        except faultinject.InjectedTransientFault:
            pass
    for rid in ids[:50]:
        engine.abort_request(rid)
    try:
        engine.step()
    except faultinject.InjectedTransientFault:
        pass
    engine.abort_request(ids[50:])
    _assert_drained(engine, free0)
    engine.abort_request(ids)
    _assert_drained(engine, free0)


# ---------------------------------------------------------------------
# overload (test_overload.py)
# ---------------------------------------------------------------------

def test_overload_burst_sheds_and_serves(tiny_model_dir, monkeypatch):
    monkeypatch.setenv("APHRODITE_MAX_QUEUE_DEPTH", "4")
    engine = _async_engine(tiny_model_dir)
    bm = engine.engine.scheduler.block_manager
    free0 = bm.get_num_free_gpu_blocks()
    allocs = []
    real_allocate = bm.allocate

    def counting_allocate(group):
        allocs.append(group.request_id)
        return real_allocate(group)
    monkeypatch.setattr(bm, "allocate", counting_allocate)

    async def one(i):
        t0 = time.perf_counter()
        try:
            final = None
            async for out in engine.generate(
                    None, SamplingParams(**SP), f"burst-{i}",
                    prompt_token_ids=_prompt(i)):
                final = out
            return ("served", final, None)
        except RequestRejectedError as e:
            return ("shed", time.perf_counter() - t0, e)

    async def go():
        results = await asyncio.gather(*(one(i) for i in range(8)))
        shed = [r for r in results if r[0] == "shed"]
        served = [r for r in results if r[0] == "served"]
        assert len(shed) == 4 and len(served) == 4, results
        for _, dt, exc in shed:
            assert dt < 0.1, f"rejection took {dt * 1e3:.1f} ms"
            assert exc.retry_after_s > 0
        for _, final, _ in served:
            assert len(final.outputs[0].token_ids) == SP["max_tokens"]
        report = await engine.check_health()
        assert report.state == "DEGRADED"
        assert report.sheds_total == 4
        assert report.overload["sheds_total"] == 4
        assert report.overload["queue_depth"] == 0

    asyncio.run(go())
    assert sorted(allocs) == [f"burst-{i}" for i in range(4)]
    assert bm.get_num_free_gpu_blocks() == free0
    assert not bm.block_tables
    assert engine.engine.admission.sheds_total == 4


def test_deadline_expiry_in_waiting_is_free(tiny_model_dir):
    engine = _sync_engine(tiny_model_dir, max_num_seqs=1)
    free0 = engine.scheduler.block_manager.get_num_free_gpu_blocks()
    engine.add_request("A", None, SamplingParams(**SP),
                       prompt_token_ids=_prompt(0))
    engine.step()
    engine.add_request("B", None, SamplingParams(ttft_slo_s=0.01, **SP),
                       prompt_token_ids=_prompt(1))
    assert len(engine.scheduler.waiting) == 1
    time.sleep(0.05)
    expired = engine.scheduler.expire_waiting(time.monotonic())
    assert [g.request_id for g in expired] == ["B"]
    assert not engine.scheduler.waiting
    engine.add_request("B2", None, SamplingParams(ttft_slo_s=0.01, **SP),
                       prompt_token_ids=_prompt(2))
    time.sleep(0.05)
    engine.step()
    faults = engine.drain_step_faults()
    assert [rid for rid, _ in faults] == ["B2"]
    assert all(isinstance(exc, RequestTimeoutError) for _, exc in faults)
    assert engine.admission.expired_total >= 1
    while engine.has_unfinished_requests():
        engine.step()
    assert engine.scheduler.block_manager.get_num_free_gpu_blocks() \
        == free0


def test_deadline_expiry_surfaces_typed_error_on_stream(tiny_model_dir):
    engine = _async_engine(tiny_model_dir, max_num_seqs=1)

    async def go():
        async def long_req():
            final = None
            async for out in engine.generate(
                    None, SamplingParams(temperature=0.0, max_tokens=48,
                                         ignore_eos=True),
                    "long", prompt_token_ids=_prompt(0)):
                final = out
            return final

        async def doomed():
            async for _ in engine.generate(
                    None, SamplingParams(ttft_slo_s=0.005, **SP),
                    "doomed", prompt_token_ids=_prompt(1)):
                pass

        long_task = asyncio.create_task(long_req())
        await asyncio.sleep(0.05)
        with pytest.raises(RequestTimeoutError):
            await doomed()
        final = await long_task
        assert len(final.outputs[0].token_ids) == 48

    asyncio.run(go())


def test_disconnect_storm_zero_ghost_tables(tiny_model_dir):
    engine = _async_engine(tiny_model_dir)
    bm = engine.engine.scheduler.block_manager
    free0 = bm.get_num_free_gpu_blocks()

    async def one(i, hang_up):
        sp = SamplingParams(temperature=0.0, max_tokens=16,
                            ignore_eos=True)
        gen = engine.generate(None, sp, f"dc-{i}",
                              prompt_token_ids=_prompt(i))
        n, final = 0, None
        async for out in gen:
            final = out
            n += 1
            if hang_up and n >= 1:
                break
        del gen
        return final if not hang_up else None

    async def go():
        results = await asyncio.gather(
            *(one(i, hang_up=(i % 2 == 0)) for i in range(10)))
        for _ in range(200):
            gc.collect()
            await asyncio.sleep(0.02)
            if not engine.engine.has_unfinished_requests() and \
                    not bm.block_tables:
                break
        assert not engine.engine.has_unfinished_requests()
        for i, final in enumerate(results):
            if i % 2 == 1:
                assert len(final.outputs[0].token_ids) == 16

    asyncio.run(go())
    assert not bm.block_tables
    assert bm.get_num_free_gpu_blocks() == free0


def test_stream_del_and_cancel_route_through_abort():
    from aphrodite_tpu_torch.engine.async_aphrodite import AsyncStream
    aborted = []
    s = AsyncStream("r1", abort_cb=aborted.append)
    s.cancel()
    s.cancel()
    assert aborted == ["r1"]
    aborted.clear()
    s2 = AsyncStream("r2", abort_cb=aborted.append)
    del s2
    gc.collect()
    assert aborted == ["r2"]
    aborted.clear()
    s3 = AsyncStream("r3", abort_cb=aborted.append)
    s3.finish()
    s3.cancel()
    del s3
    gc.collect()
    assert aborted == []


# ---------------------------------------------------------------------
# lifecycle (test_lifecycle.py)
# ---------------------------------------------------------------------

def test_fatal_fault_reincarnates_bit_equal(tiny_model_dir, monkeypatch):
    """One FATAL fault mid-serving: every request completes with the
    fault-free run's tokens, the pool ends free and the rebuild is
    counted; the old executor released its weights and pages first."""
    from aphrodite_tpu_torch.executor.executor import GPUExecutor
    clean, _ = _run_async(tiny_model_dir, monkeypatch, "")
    assert not any(isinstance(o, Exception) for o in clean)
    released = []
    real = GPUExecutor.release

    def spy(self):
        released.append(self.model_runner.params is not None)
        return real(self)
    monkeypatch.setattr(GPUExecutor, "release", spy)
    monkeypatch.setenv("APHRODITE_REINCARNATIONS", "1")
    monkeypatch.setenv("APHRODITE_REINCARNATION_BACKOFF_S", "0.01")
    faulty, state = _run_async(tiny_model_dir, monkeypatch,
                               "executor.execute_model:fatal:1:1")
    assert not any(isinstance(o, Exception) for o in faulty), faulty
    assert [tuple(o.outputs[0].token_ids) for o in faulty] == \
        [tuple(o.outputs[0].token_ids) for o in clean]
    assert released == [True]
    engine = state["engine"]
    health = engine.health
    assert health.report().state == "RUNNING"
    assert health.reincarnations_total == 1
    assert health.requests_restored_total >= 1
    assert health.requests_lost_total == 0
    bm = engine.engine.scheduler.block_manager
    assert bm.get_num_free_gpu_blocks() == \
        engine.engine.cache_config.num_gpu_blocks
    assert not bm.block_tables


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def test_reincarnation_frees_the_old_executors_tensors(tiny_model_dir,
                                                       monkeypatch):
    """`release()` frees the old executor's weight and KV tensors while
    the engine still holds that executor, before the new one is built:
    weak references to every one of them (and to the model module) are
    dead after `gc.collect()` right after the call, so nothing else (the
    engine's in-flight handles, the sampler, the fault's traceback)
    keeps them, and on the card their memory goes back before the
    second copy is loaded."""
    import weakref
    from aphrodite_tpu_torch.executor.executor import GPUExecutor
    counts = []
    real = GPUExecutor.release

    def spy(self):
        held = list(_tensors(self.model_runner.params))
        held += list(_tensors(self.cache_engine.kv_caches))
        refs = [weakref.ref(t) for t in held]
        refs.append(weakref.ref(self.model_runner.model))
        del held
        real(self)
        gc.collect()
        counts.append((len(refs), sum(r() is not None for r in refs)))
    monkeypatch.setattr(GPUExecutor, "release", spy)
    monkeypatch.setenv("APHRODITE_REINCARNATIONS", "1")
    monkeypatch.setenv("APHRODITE_REINCARNATION_BACKOFF_S", "0.01")
    faulty, state = _run_async(tiny_model_dir, monkeypatch,
                               "executor.execute_model:fatal:1:1")
    assert not any(isinstance(o, Exception) for o in faulty), faulty
    assert state["engine"].health.reincarnations_total == 1
    [(n_refs, n_alive)] = counts
    assert n_refs > 10
    assert n_alive == 0, (f"{n_alive} of the old executor's {n_refs} "
                          "tensors / modules are still held after "
                          "release()")
    # The rebuilt executor serves with tensors of its own.
    new = state["engine"].engine.executor
    assert new.model_runner.params is not None
    assert new.cache_engine.kv_caches


def test_reincarnation_budget_exhaustion_goes_dead(tiny_model_dir,
                                                   monkeypatch):
    from aphrodite_tpu_torch.engine.async_aphrodite import (
        AsyncEngineDeadError)
    monkeypatch.setenv("APHRODITE_REINCARNATIONS", "1")
    monkeypatch.setenv("APHRODITE_REINCARNATION_BACKOFF_S", "0.01")
    faulty, state = _run_async(tiny_model_dir, monkeypatch,
                               "executor.execute_model:fatal:1:0")
    assert all(isinstance(o, AsyncEngineDeadError) for o in faulty), \
        faulty
    health = state["engine"].health
    assert health.report().state == "DEAD"
    assert health.reincarnations_total == 1


def test_kernel_launch_error_reaches_stream_typed(tiny_model_dir,
                                                  monkeypatch):
    """A kernel launch failure raised inside the worker-thread step (as
    a CUDA wrapper raises it) classifies FATAL; with no rebuild budget
    every awaiting stream gets the engine's typed AsyncEngineDeadError
    with the launch error as its cause, within the timeout."""
    from aphrodite_tpu_torch.engine.async_aphrodite import (
        AsyncEngineDeadError)
    from aphrodite_tpu_torch.ops.cuda.build import KernelLaunchError
    monkeypatch.setenv("APHRODITE_REINCARNATIONS", "0")

    async def go():
        engine = _async_engine(tiny_model_dir)

        def boom(*a, **kw):
            raise KernelLaunchError(
                "paged_decode_attention: launch failed with cudaError 719")
        engine.engine.executor.execute_model = boom
        engine.engine.executor.dispatch_prompt_round = boom
        return await asyncio.wait_for(
            _generate_all(engine, PROMPTS, SamplingParams(**SP)),
            timeout=60), engine

    outs, engine = asyncio.run(go())
    assert all(isinstance(o, AsyncEngineDeadError) for o in outs), outs
    assert all(isinstance(o.__cause__, KernelLaunchError) for o in outs)
    assert engine.health.report().state == "DEAD"


def test_sync_reincarnate_restores_waiting_fcfs(tiny_model_dir,
                                                monkeypatch):
    def run(spec):
        if spec:
            monkeypatch.setenv("APHRODITE_FAULT", spec)
        else:
            monkeypatch.delenv("APHRODITE_FAULT", raising=False)
        faultinject.reset()
        engine = _sync_engine(tiny_model_dir)
        sp = SamplingParams(**SP)
        free0 = engine.scheduler.block_manager.get_num_free_gpu_blocks()
        for i, p in enumerate(PROMPTS):
            engine.add_request(f"r{i}", None, sp, prompt_token_ids=list(p))
        results, reincarnated = {}, False
        while engine.has_unfinished_requests():
            try:
                outs = engine.step()
            except faultinject.InjectedFatalFault:
                outcome = engine.reincarnate()
                reincarnated = True
                assert outcome.restored == len(PROMPTS)
                assert outcome.lost == []
                assert not engine.drain_step_faults()
                assert [g.request_id for g in engine.scheduler.waiting] \
                    == [f"r{i}" for i in range(len(PROMPTS))]
                assert engine.scheduler.block_manager.\
                    get_num_free_gpu_blocks() == free0
                continue
            for o in outs:
                if o.finished:
                    results[o.request_id] = [tuple(c.token_ids)
                                             for c in o.outputs]
        assert engine.scheduler.block_manager.get_num_free_gpu_blocks() \
            == free0
        return results, reincarnated

    clean, hit0 = run("")
    assert not hit0
    faulty, hit = run("executor.execute_model:fatal:1:1")
    assert hit
    assert faulty == clean


def test_reincarnate_clears_stale_prefix_pins(tiny_model_dir):
    engine = _sync_engine(tiny_model_dir)
    sp = SamplingParams(**SP)
    free0 = engine.scheduler.block_manager.get_num_free_gpu_blocks()
    engine.add_request("pfx", None, sp, prompt_token_ids=_prompt(0, n=40),
                       prefix_pos=32)
    engine.step()
    assert engine.scheduler.prefix_pinned_pages() == 2
    old_sched = engine.scheduler
    outcome = engine.reincarnate()
    assert outcome.restored == 1 and outcome.lost == []
    assert old_sched.prefix_pinned_pages() == 0
    assert old_sched.block_manager.get_num_free_gpu_blocks() == free0
    assert engine.scheduler.prefix_pinned_pages() == 0
    (group,) = list(engine.scheduler.waiting)
    assert group.prefix is not None and not group.prefix.allocated
    while engine.has_unfinished_requests():
        engine.step()
    assert engine.scheduler.prefix_pinned_pages() == 2
    assert engine.scheduler.clear_prefixes() == 2
    assert engine.scheduler.block_manager.get_num_free_gpu_blocks() \
        == free0


def test_seeded_partial_request_restores_bit_equal(tiny_model_dir):
    sp = SamplingParams(temperature=1.0, seed=31337, max_tokens=12,
                        ignore_eos=True)

    def run(kill_at):
        engine = _sync_engine(tiny_model_dir, skip_tokenizer_init=False)
        engine.add_request("seeded", None, sp, prompt_token_ids=_prompt(0))
        emissions, killed, final = [], False, None
        while engine.has_unfinished_requests():
            if not killed and kill_at is not None:
                groups = list(engine.scheduler.running)
                if groups and \
                        groups[0].get_seqs()[0].get_output_len() >= kill_at:
                    outcome = engine.reincarnate()
                    assert outcome.restored == 1 and outcome.lost == []
                    killed = True
                    continue
            for out in engine.step():
                emissions.append(list(out.outputs[0].token_ids))
                if out.finished:
                    final = out
        assert killed == (kill_at is not None)
        return final, emissions

    clean, _ = run(None)
    faulty, emissions = run(4)
    assert list(faulty.outputs[0].token_ids) == \
        list(clean.outputs[0].token_ids)
    assert faulty.outputs[0].text == clean.outputs[0].text
    for prev, cur in zip(emissions, emissions[1:]):
        assert cur[:len(prev)] == prev and len(cur) > len(prev)


def test_async_restore_no_duplicate_chunks(tiny_model_dir, monkeypatch):
    monkeypatch.setenv("APHRODITE_REINCARNATIONS", "1")
    monkeypatch.setenv("APHRODITE_REINCARNATION_BACKOFF_S", "0.01")
    from aphrodite_tpu_torch.common.faultinject import InjectedFatalFault
    sp = SamplingParams(temperature=1.0, seed=7, max_tokens=12,
                        ignore_eos=True)

    async def go():
        engine = _async_engine(tiny_model_dir)
        armed = {"fire": False, "fired": False}
        executor = engine.engine.executor

        def wrap(real):
            def maybe_fail(*a, **kw):
                if armed["fire"] and not armed["fired"]:
                    armed["fired"] = True
                    raise InjectedFatalFault("mid-generation kill")
                return real(*a, **kw)
            return maybe_fail
        for name in ("execute_model", "execute_decode_burst",
                     "execute_spec_verify"):
            setattr(executor, name, wrap(getattr(executor, name)))
        emissions = []
        async for out in engine.generate(None, sp, "r0",
                                         prompt_token_ids=_prompt(0)):
            emissions.append(list(out.outputs[0].token_ids))
            if len(emissions[-1]) >= 4:
                armed["fire"] = True
        assert armed["fired"]
        assert engine.health.reincarnations_total == 1
        assert len(emissions[-1]) == 12
        for prev, cur in zip(emissions, emissions[1:]):
            assert cur[:len(prev)] == prev
        return emissions[-1]

    faulty = asyncio.run(go())

    async def clean_go():
        engine = _async_engine(tiny_model_dir)
        final = None
        async for out in engine.generate(None, sp, "r0",
                                         prompt_token_ids=_prompt(0)):
            final = out
        return list(final.outputs[0].token_ids)

    assert faulty == asyncio.run(clean_go())


def test_stale_step_cannot_commit_after_reincarnation(tiny_model_dir,
                                                      monkeypatch):
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    engine = _sync_engine(tiny_model_dir, multi_step=1)
    engine.add_request("r0", None, SamplingParams(**SP),
                       prompt_token_ids=list(PROMPTS[0]))
    engine.step()
    (group,) = engine.scheduler.running
    seq = group.get_seqs()[0]
    len_before = seq.get_output_len()
    real = engine.executor.execute_model

    def bump_then_run(*a, **kw):
        engine._epoch += 1
        return real(*a, **kw)
    monkeypatch.setattr(engine.executor, "execute_model", bump_then_run)
    with pytest.raises(StaleEngineStepError):
        engine.step()
    assert seq.get_output_len() == len_before


def test_drain_completes_inflight_rejects_new(tiny_model_dir):
    engine = _async_engine(tiny_model_dir)

    async def go():
        async def long_req():
            final = None
            async for out in engine.generate(
                    None, SamplingParams(temperature=0.0, max_tokens=200,
                                         ignore_eos=True),
                    "long", prompt_token_ids=_prompt(0)):
                final = out
            return final

        long_task = asyncio.create_task(long_req())
        await asyncio.sleep(0.05)
        assert engine.engine.has_unfinished_requests()
        engine.start_drain(deadline_s=30.0, reason="test drain")
        assert engine.is_draining
        with pytest.raises(EngineDrainingError) as ei:
            async for _ in engine.generate(
                    None, SamplingParams(**SP), "late",
                    prompt_token_ids=_prompt(1)):
                pass
        assert ei.value.retry_after_s >= 1.0
        assert await asyncio.wait_for(engine.drained(), timeout=30)
        final = await long_task
        assert len(final.outputs[0].token_ids) == 200
        report = await engine.check_health()
        assert report.state == "DRAINING" and report.draining
        assert report.drain_deadline_remaining_s is not None

    asyncio.run(go())
    assert not engine.engine.scheduler.block_manager.block_tables


def test_drain_deadline_force_aborts_with_typed_error(tiny_model_dir):
    engine = _async_engine(tiny_model_dir)
    bm = engine.engine.scheduler.block_manager
    free0 = bm.get_num_free_gpu_blocks()

    async def go():
        async def long_req():
            async for _ in engine.generate(
                    None, SamplingParams(temperature=0.0, max_tokens=200,
                                         ignore_eos=True),
                    "straggler", prompt_token_ids=_prompt(0)):
                pass

        long_task = asyncio.create_task(long_req())
        await asyncio.sleep(0.1)
        engine.start_drain(deadline_s=0.2, reason="deadline test")
        assert await asyncio.wait_for(engine.drained(), timeout=30) \
            is False
        with pytest.raises(EngineDrainingError):
            await long_task
        for _ in range(200):
            gc.collect()
            await asyncio.sleep(0.02)
            if not engine.engine.has_unfinished_requests() and \
                    not bm.block_tables:
                break
        assert not engine.engine.has_unfinished_requests()

    asyncio.run(go())
    assert not bm.block_tables
    assert bm.get_num_free_gpu_blocks() == free0


def test_expiry_still_fires_during_drain(tiny_model_dir):
    engine = _async_engine(tiny_model_dir, max_num_seqs=1)

    async def go():
        async def long_req():
            final = None
            async for out in engine.generate(
                    None, SamplingParams(temperature=0.0, max_tokens=48,
                                         ignore_eos=True),
                    "long", prompt_token_ids=_prompt(0)):
                final = out
            return final

        long_task = asyncio.create_task(long_req())
        await asyncio.sleep(0.1)

        async def doomed():
            async for _ in engine.generate(
                    None, SamplingParams(ttft_slo_s=0.02, **SP),
                    "doomed", prompt_token_ids=_prompt(1)):
                pass

        doomed_task = asyncio.create_task(doomed())
        await asyncio.sleep(0.01)
        engine.start_drain(deadline_s=30.0, reason="expiry test")
        with pytest.raises(RequestTimeoutError):
            await doomed_task
        assert await asyncio.wait_for(engine.drained(), timeout=30) \
            is True
        final = await long_task
        assert len(final.outputs[0].token_ids) == 48

    asyncio.run(go())


def test_engine_loop_from_worker_thread(tiny_model_dir):
    import threading
    engine = _async_engine(tiny_model_dir)
    result, errors = {}, []

    def worker():
        async def go():
            final = None
            async for out in engine.generate(
                    None, SamplingParams(**SP), "threaded",
                    prompt_token_ids=_prompt(0)):
                final = out
            result["tokens"] = list(final.outputs[0].token_ids)
            engine.start_drain(deadline_s=10.0, reason="thread test")
            result["drained"] = await asyncio.wait_for(
                engine.drained(), timeout=20)
        try:
            asyncio.run(go())
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "worker-thread engine loop hung"
    assert not errors, errors
    assert len(result["tokens"]) == SP["max_tokens"]
    assert result["drained"] is True


def test_drained_is_event_driven(tiny_model_dir):
    engine = _async_engine(tiny_model_dir)

    async def go():
        assert await asyncio.wait_for(engine.drained(), timeout=1) is True
        final = None
        async for out in engine.generate(
                None, SamplingParams(**SP), "one",
                prompt_token_ids=_prompt(1)):
            final = out
        assert final is not None
        t0 = time.monotonic()
        assert await asyncio.wait_for(engine.drained(), timeout=5) is True
        assert time.monotonic() - t0 < 0.05
        assert engine._idle_event.is_set()
        stream = await engine.add_request(
            "two", None, SamplingParams(**SP), prompt_token_ids=_prompt(2))
        assert not engine._idle_event.is_set()
        async for _ in stream:
            pass

    asyncio.run(go())


# ---------------------------------------------------------------------
# counters and the profiler hooks
# ---------------------------------------------------------------------

def test_launch_counters_exact_across_threads():
    """The launch counters stay exact with launches from more threads
    than cores at once (the async engine's worker thread beside others),
    with the interpreter switching threads as often as it can: a lost
    read-modify-write would leave the count short."""
    import sys
    import threading
    from aphrodite_tpu_torch.ops.cuda.build import LaunchCounter
    counter = LaunchCounter("threads")
    workers = len(os.sched_getaffinity(0)) + 2

    def work():
        for _ in range(5000):
            counter.add()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counter.count == 5000 * workers


def test_profile_hooks_write_a_torch_trace(tiny_model_dir, tmp_path):
    """start_profile / stop_profile around async serving write a Chrome
    trace of the engine's steps, taken on the worker thread; a second
    start while running and a stop while idle raise."""
    engine = _async_engine(tiny_model_dir)
    engine.engine.start_profile(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        engine.engine.start_profile(str(tmp_path))
    outs = asyncio.run(_generate_all(engine, PROMPTS[:2],
                                     SamplingParams(**SP)))
    assert all(len(o.outputs[0].token_ids) == SP["max_tokens"]
               for o in outs)
    path = engine.engine.stop_profile()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names), sorted(names)[:20]
    with pytest.raises(RuntimeError, match="not running"):
        engine.engine.stop_profile()
