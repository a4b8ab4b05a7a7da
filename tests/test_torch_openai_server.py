"""The PyTorch port's OpenAI-compatible server over a real aiohttp app,
on the tiny model of tests/conftest.py (tokenizer included) in float32
on the CPU. Mirrors tests/endpoints/test_openai_server.py and the
OpenAI cases of tests/endpoints/test_stream_resume.py.

The port's app and the JAX package's are built side by side, the port
given the JAX engine's dummy weights (`params_from_jax`) and both the
same pinned `num_gpu_blocks`. Tolerance: greedy and seeded completions'
token ids (read from the stream journal) and texts equal to the JAX
app's. Speculative decoding runs as both packages default it (on).

Also held: /health (full report, probe fast path, DEAD after an
unrecoverable fault), /v1/models, /v1/tokenize, completions (n
choices, logprobs, streaming, logit bias, grammar), chat completions,
/metrics, the torch.profiler trace routes, and the resume extension
(journal records, a bit-equal continuation, its admin-key gating, no
role prelude on a resumed chat stream).
"""
import asyncio
import json
import os

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from aphrodite_tpu_torch.endpoints.openai.api_server import build_app
from aphrodite_tpu_torch.endpoints.utils import (JOURNAL_HEADER,
                                                 RESUME_KEY_HEADER)
from aphrodite_tpu_torch.engine.args_tools import AsyncEngineArgs
from aphrodite_tpu_torch.engine.async_aphrodite import AsyncAphrodite

MODEL_KEY = "tiny"
ADMIN_KEY = "resume-key"
NUM_BLOCKS = 64
PROMPT = "the quick brown fox jumps over the lazy dog"
ENGINE_KW = dict(load_format="dummy", dtype="float32", block_size=16,
                 max_model_len=256, max_num_seqs=8, swap_space=0.01)


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
def _no_injected_faults(monkeypatch):
    from aphrodite_tpu.common import faultinject as jax_faults
    from aphrodite_tpu_torch.common import faultinject
    monkeypatch.delenv("APHRODITE_FAULT", raising=False)
    monkeypatch.delenv("APHRODITE_FAULT_SEED", raising=False)
    jax_faults.reset()
    faultinject.reset()


def _engines(model_dir):
    """The JAX AsyncAphrodite and the port's, the port given the JAX
    engine's weights and both the same pool."""
    from aphrodite_tpu.engine.args_tools import (
        AsyncEngineArgs as JaxAsyncEngineArgs)
    from aphrodite_tpu.engine.async_aphrodite import (
        AsyncAphrodite as JaxAsyncAphrodite)
    from aphrodite_tpu_torch.modeling.convert import (params_from_jax,
                                                      to_device)
    jcfg = JaxAsyncEngineArgs(model=model_dir,
                              **ENGINE_KW).create_engine_configs()
    jcfg[1].num_gpu_blocks = NUM_BLOCKS
    jax_engine = JaxAsyncAphrodite(*jcfg, log_requests=False,
                                   log_stats=True)
    tcfg = AsyncEngineArgs(model=model_dir, device="cpu",
                           **ENGINE_KW).create_engine_configs()
    tcfg[1].num_gpu_blocks = NUM_BLOCKS
    port = AsyncAphrodite(*tcfg, log_requests=False, log_stats=True)
    host = jax.tree_util.tree_map(np.asarray,
                                  jax_engine.engine.executor.params)
    params = to_device(params_from_jax(host), torch.device("cpu"),
                       torch.float32)
    port.engine.executor.params = params
    port.engine.executor.model_runner.params = params
    return jax_engine, port


@pytest.fixture(scope="module")
def server_ctx(tiny_model_dir):
    """Both apps on one module-owned loop: (loop, {"port", "jax"})."""
    from aphrodite_tpu.endpoints.openai.api_server import (
        build_app as jax_build_app)
    loop = asyncio.new_event_loop()
    jax_engine, port = _engines(tiny_model_dir)

    async def setup():
        clients = {}
        for name, build, engine in (("port", build_app, port),
                                    ("jax", jax_build_app, jax_engine)):
            client = TestClient(TestServer(build(
                engine, MODEL_KEY, admin_keys=[ADMIN_KEY])))
            await client.start_server()
            clients[name] = client
        return clients

    clients = loop.run_until_complete(setup())
    yield loop, clients

    async def teardown():
        for client in clients.values():
            await client.close()
    loop.run_until_complete(teardown())
    loop.close()


def run(server_ctx, coro_fn, which="port"):
    loop, clients = server_ctx
    return loop.run_until_complete(coro_fn(clients[which]))


def parse_sse(raw: bytes):
    """(journal records, data payload lines) of one SSE body."""
    records, datas = [], []
    for line in raw.split(b"\n"):
        if line.startswith(b": aphrodite-journal "):
            records.append(json.loads(line[len(b": aphrodite-journal "):]))
        elif line.startswith(b"data: "):
            datas.append(line[len(b"data: "):])
    return records, datas


def sse_text(datas, chat=False):
    text = ""
    for d in datas:
        if d.strip() == b"[DONE]":
            continue
        payload = json.loads(d)
        if "error" in payload:
            raise AssertionError(payload)
        choice = payload["choices"][0]
        text += choice["delta"].get("content") or "" if chat \
            else choice["text"]
    return text


async def _journaled(client, path, body, headers=None):
    """(token ids, text) of one journaled stream."""
    r = await client.post(path, json=body,
                          headers={JOURNAL_HEADER: "1", **(headers or {})})
    assert r.status == 200, await r.text()
    records, datas = parse_sse(await r.read())
    return ([t for rec in records for t in rec["t"]],
            sse_text(datas, chat="chat" in path))


# ---- parity with the JAX app ----

@pytest.mark.parametrize("body", [
    dict(prompt=PROMPT, max_tokens=12, temperature=0.0),
    dict(prompt="hello world", max_tokens=20, temperature=0.0),
    dict(prompt=[11, 23, 37, 41] * 5, max_tokens=24, temperature=0.0),
    dict(prompt=PROMPT, max_tokens=10, temperature=1.0, seed=777),
    dict(prompt="sampling with top p", max_tokens=10, temperature=0.8,
         seed=5, top_p=0.9, top_k=20),
])
def test_completion_token_ids_match_jax_app(server_ctx, body):
    """Streamed completions: the journal's token ids and the text equal
    the JAX app's; the non-streamed completion's text too."""
    body = dict(body, model=MODEL_KEY, ignore_eos=True, stream=True)

    async def stream(client):
        return await _journaled(client, "/v1/completions", body)

    async def whole(client):
        r = await client.post("/v1/completions",
                              json=dict(body, stream=False))
        assert r.status == 200
        return (await r.json())["choices"][0]["text"]
    want, got = run(server_ctx, stream, "jax"), run(server_ctx, stream)
    assert len(got[0]) == body["max_tokens"]
    assert got == want
    assert run(server_ctx, whole) == run(server_ctx, whole, "jax") \
        == want[1]


def test_chat_completion_matches_jax_app(server_ctx):
    body = {"model": MODEL_KEY, "max_tokens": 8, "temperature": 0.0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": "say hi"}]}

    async def go(client):
        r = await client.post("/v1/chat/completions", json=body)
        assert r.status == 200
        out = await r.json()
        ids, text = await _journaled(client, "/v1/chat/completions",
                                     dict(body, stream=True))
        return out["choices"][0]["message"]["content"], ids, text
    want, got = run(server_ctx, go, "jax"), run(server_ctx, go)
    assert got == want and got[0] == got[2] and len(got[1]) == 8


# ---- the surface (test_openai_server.py) ----

def test_health(server_ctx):
    async def go(client):
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "hi", "max_tokens": 1,
            "ignore_eos": True})
        assert r.status == 200, await r.text()
        r = await client.get("/health")
        assert r.status == 200
        body = await r.json()
        assert body["state"] == "RUNNING"
        assert body["steps_completed"] >= 1
        assert body["last_step_age_s"] >= 0
        assert body["consecutive_failures"] == 0
        assert body["dead_reason"] is None
    run(server_ctx, go)


def test_health_probe_fast_path(server_ctx):
    async def go(client):
        r = await client.get("/health", params={"probe": "1"})
        assert r.status == 200
        body = await r.json()
        assert set(body) == {"state", "draining", "inflight", "overload"}
        assert body["state"] in ("RUNNING", "DEGRADED")
        assert body["draining"] is False
        assert isinstance(body["inflight"], int)
        assert "queue_depth" in body["overload"]
        assert "steps_completed" not in body
        r = await client.get("/health")
        full = await r.json()
        assert "steps_completed" in full and "retries_total" in full
    run(server_ctx, go)


def test_health_reports_dead_after_fatal_fault(tiny_model_dir,
                                               monkeypatch):
    from aphrodite_tpu_torch.common import faultinject
    monkeypatch.setenv("APHRODITE_REINCARNATIONS", "0")
    monkeypatch.setenv("APHRODITE_FAULT", "executor.execute_model:fatal:1:1")
    faultinject.reset()

    async def go():
        engine = AsyncAphrodite.from_engine_args(AsyncEngineArgs(
            model=tiny_model_dir, device="cpu", max_num_seqs=4,
            disable_log_stats=True, disable_log_requests=True,
            **{k: v for k, v in ENGINE_KW.items() if k != "max_num_seqs"}))
        client = TestClient(TestServer(build_app(engine, MODEL_KEY)))
        await client.start_server()
        try:
            r = await client.post("/v1/completions", json={
                "model": MODEL_KEY, "prompt": "hi", "max_tokens": 2,
                "ignore_eos": True})
            assert r.status >= 500
            r = await client.get("/health")
            assert r.status == 503
            body = await r.json()
            assert body["state"] == "DEAD"
            assert "fatal" in body["error"] or \
                "fatal" in (body["dead_reason"] or "")
            r = await asyncio.wait_for(client.post("/v1/completions", json={
                "model": MODEL_KEY, "prompt": "hi", "max_tokens": 2,
                "ignore_eos": True}), timeout=10)
            assert r.status >= 500
        finally:
            await client.close()
            faultinject.reset()

    asyncio.run(go())


def test_models(server_ctx):
    async def go(client):
        r = await client.get("/v1/models")
        body = await r.json()
        assert r.status == 200 and body["data"][0]["id"] == MODEL_KEY
    run(server_ctx, go)


def test_tokenize(server_ctx):
    async def go(client):
        r = await client.post("/v1/tokenize", json={"prompt": "hello world"})
        body = await r.json()
        assert r.status == 200
        assert body["count"] == len(body["tokens"]) > 0
        assert body["max_model_len"] == 256
        return body["tokens"]
    assert run(server_ctx, go) == run(server_ctx, go, "jax")


def test_completion_basic(server_ctx):
    async def go(client):
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "the quick brown",
            "max_tokens": 6, "temperature": 0.0, "ignore_eos": True})
        body = await r.json()
        assert r.status == 200, body
        assert body["object"] == "text_completion"
        assert len(body["choices"]) == 1
        assert body["choices"][0]["finish_reason"] == "length"
        assert body["usage"]["completion_tokens"] == 6
    run(server_ctx, go)


def test_completion_wrong_model_404(server_ctx):
    async def go(client):
        r = await client.post("/v1/completions", json={
            "model": "nope", "prompt": "x", "max_tokens": 1})
        assert r.status == 404
    run(server_ctx, go)


def test_completion_n_choices(server_ctx):
    async def go(client):
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "hello", "max_tokens": 4,
            "n": 2, "best_of": 2, "seed": 5, "ignore_eos": True})
        body = await r.json()
        assert r.status == 200, body
        assert len(body["choices"]) == 2
    run(server_ctx, go)


def test_completion_logprobs(server_ctx):
    async def go(client):
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "hello", "max_tokens": 3,
            "temperature": 0.0, "logprobs": 2, "ignore_eos": True})
        body = await r.json()
        assert r.status == 200, body
        lp = body["choices"][0]["logprobs"]
        assert len(lp["tokens"]) == 3 and len(lp["top_logprobs"]) == 3
        assert all(len(d) >= 2 for d in lp["top_logprobs"])
        return lp["tokens"]
    assert run(server_ctx, go) == run(server_ctx, go, "jax")


def test_completion_streaming(server_ctx):
    async def go(client):
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "the quick", "max_tokens": 5,
            "temperature": 0.0, "stream": True, "ignore_eos": True})
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/event-stream")
        chunks, done = [], False
        async for line in r.content:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                done = True
                break
            chunks.append(json.loads(payload))
        assert done and chunks
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    run(server_ctx, go)


def test_chat_streaming(server_ctx):
    async def go(client):
        r = await client.post("/v1/chat/completions", json={
            "model": MODEL_KEY,
            "messages": [{"role": "user", "content": "hello"}],
            "max_tokens": 4, "stream": True, "ignore_eos": True})
        assert r.status == 200
        saw_role = saw_done = False
        async for line in r.content:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                saw_done = True
                break
            delta = json.loads(payload)["choices"][0]["delta"]
            saw_role = saw_role or delta.get("role") == "assistant"
        assert saw_role and saw_done
    run(server_ctx, go)


def test_logit_bias_forces_token(server_ctx):
    """A host logits processor keeps the round off the verify path;
    +100 on token 42 wins every greedy step."""
    async def go(client):
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "hello", "max_tokens": 3,
            "temperature": 0.0, "logit_bias": {"42": 100.0},
            "logprobs": 0, "ignore_eos": True})
        body = await r.json()
        assert r.status == 200, body
        assert len(set(body["choices"][0]["logprobs"]["tokens"])) == 1
    run(server_ctx, go)


def test_logit_bias_out_of_vocab_rejected(server_ctx):
    async def go(client):
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "hello", "max_tokens": 2,
            "logit_bias": {"99999999": 5.0}})
        assert r.status == 400
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "hi", "max_tokens": 1,
            "ignore_eos": True})
        assert r.status == 200
    run(server_ctx, go)


def test_metrics_endpoint(server_ctx):
    async def go(client):
        r = await client.get("/metrics")
        assert r.status == 200
        assert "aphrodite" in await r.text()
    run(server_ctx, go)


def test_grammar_constrained_completion(server_ctx):
    """The port's own grammar module builds the processor; the output
    follows the grammar and equals the JAX app's."""
    grammar = '\nstart: "(" NUMBER ")"\nNUMBER: /[0-9]+/\n'

    async def go(client):
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "the", "max_tokens": 8,
            "temperature": 0.0, "grammar": grammar})
        assert r.status == 200, await r.text()
        text = (await r.json())["choices"][0]["text"]
        from aphrodite_tpu_torch.common.grammar import GrammarMatcher
        m = GrammarMatcher(grammar)
        state = m.root
        for ch in text:
            state = m.advance(state, ch)
            assert state is not None, f"output {text!r} broke grammar"
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "the", "max_tokens": 4,
            "grammar": "start: !!not a grammar"})
        assert r.status == 400
        return text
    assert run(server_ctx, go) == run(server_ctx, go, "jax")


def test_profile_endpoints(server_ctx, tmp_path):
    """POST /start_profile + /stop_profile wrap a torch.profiler trace
    around live requests; the trace file holds the steps' host ops."""
    trace_dir = str(tmp_path / "trace")

    async def go(client):
        r = await client.post("/start_profile",
                              json={"trace_dir": trace_dir})
        assert r.status == 200, await r.text()
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": "hi", "max_tokens": 2,
            "ignore_eos": True})
        assert r.status == 200
        r = await client.post("/stop_profile", json={})
        assert r.status == 200
        path = (await r.json())["trace"]
        r = await client.post("/stop_profile", json={})
        assert r.status == 400
        return path
    path = run(server_ctx, go)
    assert os.path.dirname(path) == trace_dir
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("aten::" in n for n in names)


# ---- the resume extension (test_stream_resume.py, OpenAI cases) ----

def test_openai_journal_and_resume_bit_equal(server_ctx):
    body = {"model": MODEL_KEY, "prompt": PROMPT, "max_tokens": 8,
            "ignore_eos": True, "stream": True, "temperature": 1.0,
            "seed": 777}

    async def go(client):
        r = await client.post("/v1/completions", json=body,
                              headers={JOURNAL_HEADER: "1"})
        assert r.status == 200
        records, datas = parse_sse(await r.read())
        full_text = sse_text(datas)
        tokens = [t for rec in records for t in rec["t"]]
        assert len(tokens) == 8
        assert records[-1]["n"] == 8 and records[-1]["fin"] == "length"
        assert [r0["n"] for r0 in records] == \
            sorted({r0["n"] for r0 in records})
        cont = dict(body, aphrodite_resume={"emitted_token_ids":
                                            tokens[:3]})
        r = await client.post(
            "/v1/completions", json=cont,
            headers={JOURNAL_HEADER: "1", RESUME_KEY_HEADER: ADMIN_KEY})
        assert r.status == 200
        rec2, datas2 = parse_sse(await r.read())
        assert [t for rec in rec2 for t in rec["t"]] == tokens[3:]
        assert rec2[0]["n"] > 3 and rec2[-1]["n"] == 8
        delta_text = sse_text(datas2)
        assert delta_text != ""
        assert full_text[:len(full_text) - len(delta_text)] + \
            delta_text == full_text
        done = dict(body, aphrodite_resume={"emitted_token_ids": tokens})
        r = await client.post(
            "/v1/completions", json=done,
            headers={JOURNAL_HEADER: "1", RESUME_KEY_HEADER: ADMIN_KEY})
        assert r.status == 200
        rec3, datas3 = parse_sse(await r.read())
        assert [t for rec in rec3 for t in rec["t"]] == []
        assert sse_text(datas3) == ""
        assert datas3[-1].strip() == b"[DONE]"
        return tokens, full_text
    assert run(server_ctx, go) == run(server_ctx, go, "jax")


def test_journal_absent_without_header(server_ctx):
    async def go(client):
        r = await client.post("/v1/completions", json={
            "model": MODEL_KEY, "prompt": PROMPT, "max_tokens": 4,
            "ignore_eos": True, "stream": True})
        assert r.status == 200
        assert b"aphrodite-journal" not in await r.read()
    run(server_ctx, go)


def test_resume_gating(server_ctx):
    async def go(client):
        body = {"model": MODEL_KEY, "prompt": PROMPT, "max_tokens": 4,
                "stream": True,
                "aphrodite_resume": {"emitted_token_ids": [1, 2]}}
        r = await client.post("/v1/completions", json=body)
        assert r.status == 401
        r = await client.post("/v1/completions", json=body,
                              headers={RESUME_KEY_HEADER: "wrong"})
        assert r.status == 401
        for bad in (dict(body, stream=False), dict(body, n=2, best_of=2),
                    dict(body, aphrodite_resume={
                        "emitted_token_ids": ["x"]})):
            r = await client.post("/v1/completions", json=bad,
                                  headers={RESUME_KEY_HEADER: ADMIN_KEY})
            assert r.status == 400
    run(server_ctx, go)


def test_resume_403_without_admin_keys(tiny_model_dir):
    async def go():
        engine = AsyncAphrodite.from_engine_args(AsyncEngineArgs(
            model=tiny_model_dir, device="cpu", disable_log_stats=True,
            disable_log_requests=True, **ENGINE_KW))
        client = TestClient(TestServer(build_app(engine, MODEL_KEY)))
        await client.start_server()
        try:
            r = await client.post("/v1/completions", json={
                "model": MODEL_KEY, "prompt": PROMPT, "max_tokens": 2,
                "stream": True,
                "aphrodite_resume": {"emitted_token_ids": [1]}},
                headers={RESUME_KEY_HEADER: "anything"})
            assert r.status == 403
        finally:
            await client.close()
    asyncio.run(go())


def test_chat_resume_skips_role_prelude(server_ctx):
    body = {"model": MODEL_KEY,
            "messages": [{"role": "user", "content": PROMPT}],
            "max_tokens": 6, "ignore_eos": True, "stream": True,
            "temperature": 0.0}

    async def go(client):
        r = await client.post("/v1/chat/completions", json=body,
                              headers={JOURNAL_HEADER: "1"})
        assert r.status == 200
        records, datas = parse_sse(await r.read())
        tokens = [t for rec in records for t in rec["t"]]
        assert len(tokens) == 6
        assert len([d for d in datas if b'"role":"assistant"' in d]) == 1
        cont = dict(body, aphrodite_resume={"emitted_token_ids":
                                            tokens[:2]})
        r = await client.post(
            "/v1/chat/completions", json=cont,
            headers={JOURNAL_HEADER: "1", RESUME_KEY_HEADER: ADMIN_KEY})
        assert r.status == 200
        rec2, datas2 = parse_sse(await r.read())
        assert [t for rec in rec2 for t in rec["t"]] == tokens[2:]
        assert not any(b'"role":"assistant"' in d for d in datas2)
        return tokens
    assert run(server_ctx, go) == run(server_ctx, go, "jax")
