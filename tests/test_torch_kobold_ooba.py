"""The PyTorch port's KoboldAI and Ooba servers over real aiohttp apps,
on the tiny model of tests/conftest.py (tokenizer included) in float32
on the CPU. Mirrors tests/endpoints/test_kobold_ooba.py and
`test_kobold_and_ooba_journal_and_resume` of
tests/endpoints/test_stream_resume.py.

The port's apps and the JAX package's are built side by side, the port
given the JAX engine's dummy weights (`params_from_jax`) and both the
same pinned `num_gpu_blocks`. Tolerance: none. Token ids (read from the
stream journal), texts and stream events of greedy and seeded
generations (Kobold's `sampler_seed`, Ooba's `seed`) equal the JAX
app's, and so do Ooba's `min_length` / `ban_eos_token` path, the
Kobold badword lists and what a seed of 2**63 or more does to the
engine.
"""
import asyncio
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from aphrodite_tpu_torch.endpoints.kobold.api_server import (
    build_app as build_kobold)
from aphrodite_tpu_torch.endpoints.ooba.api_server import (
    build_app as build_ooba)
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
EOS = 1                       # the tiny tokenizer's "</s>"
WAIT_S = 120                  # bound on any one HTTP exchange


@pytest.fixture(autouse=True)
def _one_torch_thread():
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
                                   log_stats=False)
    tcfg = AsyncEngineArgs(model=model_dir, device="cpu",
                           **ENGINE_KW).create_engine_configs()
    tcfg[1].num_gpu_blocks = NUM_BLOCKS
    port = AsyncAphrodite(*tcfg, log_requests=False, log_stats=False)
    host = jax.tree_util.tree_map(np.asarray,
                                  jax_engine.engine.executor.params)
    params = to_device(params_from_jax(host), torch.device("cpu"),
                       torch.float32)
    port.engine.executor.params = params
    port.engine.executor.model_runner.params = params
    return jax_engine, port


@pytest.fixture(scope="module")
def servers(tiny_model_dir):
    """Kobold and Ooba apps of both packages on one module-owned loop:
    (loop, {("port" | "jax", "kobold" | "ooba"): client})."""
    from aphrodite_tpu.endpoints.kobold.api_server import (
        build_app as jax_kobold)
    from aphrodite_tpu.endpoints.ooba.api_server import (
        build_app as jax_ooba)
    loop = asyncio.new_event_loop()
    jax_engine, port = _engines(tiny_model_dir)

    async def setup():
        clients = {}
        for pkg, engine, kobold, ooba in (
                ("port", port, build_kobold, build_ooba),
                ("jax", jax_engine, jax_kobold, jax_ooba)):
            for name, build in (("kobold", kobold), ("ooba", ooba)):
                client = TestClient(TestServer(build(
                    engine, MODEL_KEY, admin_keys=[ADMIN_KEY])))
                await client.start_server()
                clients[pkg, name] = client
        return clients

    clients = loop.run_until_complete(setup())
    yield loop, clients

    async def teardown():
        for client in clients.values():
            await client.close()
    loop.run_until_complete(teardown())
    loop.close()


def run(servers, coro_fn, front, pkg="port"):
    loop, clients = servers
    return loop.run_until_complete(
        asyncio.wait_for(coro_fn(clients[pkg, front]), WAIT_S))


def both(servers, coro_fn, front):
    """(JAX app's result, port app's result) of one exchange."""
    return (run(servers, coro_fn, front, "jax"),
            run(servers, coro_fn, front))


def parse_stream(raw: bytes):
    """(journal records, payload lines) of a Kobold SSE or an Ooba
    newline-JSON body."""
    records, datas = [], []
    for line in raw.split(b"\n"):
        if line.startswith(b": aphrodite-journal "):
            records.append(json.loads(line[len(b": aphrodite-journal "):]))
        elif line.startswith(b"data: "):
            datas.append(line[len(b"data: "):])
        elif line.startswith(b"{"):
            datas.append(line)
    return records, datas


async def _journaled(client, path, body, headers=None):
    """(token ids, finish reason, payloads) of one journaled stream."""
    r = await client.post(path, json=body,
                          headers={JOURNAL_HEADER: "1", **(headers or {})})
    assert r.status == 200, await r.text()
    records, datas = parse_stream(await r.read())
    return ([t for rec in records for t in rec["t"]],
            records[-1].get("fin") if records else None,
            [json.loads(d) for d in datas])


def kobold_body(**kw):
    return dict(dict(prompt=PROMPT, max_length=8, max_context_length=128),
                **kw)


# ---- parity with the JAX apps ----

@pytest.mark.parametrize("body", [
    kobold_body(temperature=0.0),
    kobold_body(prompt="hello world", max_length=12, temperature=0.0),
    kobold_body(temperature=1.0, sampler_seed=777),
    kobold_body(prompt="sampling with top p", temperature=0.8,
                sampler_seed=5, top_p=0.9, top_k=20, rep_pen=1.1),
    kobold_body(temperature=1.0, sampler_seed=3,
                use_default_badwordsids=True),
])
def test_kobold_matches_jax_app(servers, body):
    """Kobold streams: journaled token ids and every `event: message`
    payload equal the JAX app's; the non-streamed text is their
    concatenation in both."""
    async def go(client):
        ids, fin, events = await _journaled(
            client, "/api/extra/generate/stream", body)
        r = await client.post("/api/v1/generate", json=body)
        assert r.status == 200
        return ids, fin, events, (await r.json())["results"][0]["text"]
    want, got = both(servers, go, "kobold")
    assert got == want
    ids, _, events, text = got
    assert ids and len(ids) <= body["max_length"]
    assert "".join(e["token"] for e in events) == text


@pytest.mark.parametrize("body", [
    dict(prompt=PROMPT, max_new_tokens=8, temperature=0.0),
    dict(prompt="hello world", max_new_tokens=12, temperature=0.0,
         stopping_strings=["zzz"]),
    dict(prompt=PROMPT, max_new_tokens=8, temperature=1.0, seed=777),
    dict(prompt="sampling with top p", max_new_tokens=8,
         temperature=0.8, seed=5, top_p=0.9, top_k=0),
])
def test_ooba_matches_jax_app(servers, body):
    """Ooba streams cumulative text: the journaled ids and every chunk
    equal the JAX app's, and the non-streamed text is the last chunk."""
    async def go(client):
        ids, fin, chunks = await _journaled(
            client, "/api/v1/generate", dict(body, stream=True))
        r = await client.post("/api/v1/generate", json=body)
        assert r.status == 200
        return ids, fin, chunks, (await r.json())["results"][0]["text"]
    want, got = both(servers, go, "ooba")
    assert got == want
    ids, _, chunks, text = got
    assert ids and chunks[-1]["results"][0]["text"] == text


@pytest.mark.parametrize("extra,at_least", [
    ({}, 0),
    ({"min_length": 6}, 6),
    ({"ban_eos_token": True}, 10),
])
def test_ooba_min_length_and_ban_eos_match_jax_app(servers, tiny_model_dir,
                                                   extra, at_least):
    """`min_length` and `ban_eos_token` go through the host
    `BanEOSUntil` processor: with only EOS and one other token allowed,
    EOS ends the stream early without them and never before
    `min_length` with them, token for token as in the JAX app."""
    with open(os.path.join(tiny_model_dir, "config.json")) as f:
        vocab = json.load(f)["vocab_size"]
    body = dict(prompt=PROMPT, max_new_tokens=10, temperature=1.0,
                seed=11, custom_token_bans=[
                    t for t in range(vocab) if t not in (EOS, 42)],
                stream=True, **extra)

    async def go(client):
        ids, fin, _ = await _journaled(client, "/api/v1/generate", body)
        return ids, fin
    want, (ids, fin) = both(servers, go, "ooba")
    assert (ids, fin) == want
    assert len(ids) >= at_least and ids[:at_least] == [42] * at_least
    assert set(ids) <= {42, EOS}
    if not extra:
        assert fin == "stop" and ids[-1] == EOS and len(ids) < 10


@pytest.mark.parametrize("raw", [
    None, [5, 7], [[5], [7, 8]],
])
def test_set_badwords_matches_jax(tmp_path, tiny_model_dir, raw):
    """`_set_badwords` over each package's config of the same file: a
    flat `bad_words_ids`, a nested one, and none (the vocab's bracket
    tokens plus EOS)."""
    from aphrodite_tpu.endpoints.kobold.api_server import (
        _set_badwords as jax_set_badwords)
    from aphrodite_tpu.transformers_utils.config import (
        get_config as jax_get_config)
    from aphrodite_tpu_torch.endpoints.kobold.api_server import (
        _set_badwords)
    from aphrodite_tpu_torch.transformers_utils.config import get_config
    from aphrodite_tpu_torch.transformers_utils.tokenizer import (
        get_tokenizer)
    path = tmp_path / "model"
    shutil.copytree(tiny_model_dir, path)
    with open(os.path.join(tiny_model_dir, "config.json")) as f:
        cfg = json.load(f)
    if raw is not None:
        cfg["bad_words_ids"] = raw
    (path / "config.json").write_text(json.dumps(cfg))
    tokenizer = get_tokenizer(str(path))
    got = _set_badwords(tokenizer, get_config(str(path)))
    want = jax_set_badwords(tokenizer, jax_get_config(str(path)))
    if raw is None:
        # The vocab's order is the tokenizer's hash map's, call by call.
        assert sorted(got) == sorted(want)
        assert got[-1] == EOS and len(got) > 1
    else:
        assert got == want == ([5, 7] if raw == [5, 7] else [5, 7, 8])


def test_seed_past_int64_does_what_jax_does(tiny_model_dir):
    """Kobold takes `sampler_seed` up to 2**64 - 1, and both samplers
    write the seed into an int64 array: the step raises OverflowError,
    the engine reincarnates once, fails again and goes DEAD. The port's
    engine answers as the JAX one does, each on an engine of its own."""
    from aphrodite_tpu.endpoints.kobold.api_server import (
        build_app as jax_kobold)
    from aphrodite_tpu.engine.args_tools import (
        AsyncEngineArgs as JaxAsyncEngineArgs)
    from aphrodite_tpu.engine.async_aphrodite import (
        AsyncAphrodite as JaxAsyncAphrodite)

    async def go(engine, build):
        client = TestClient(TestServer(build(engine, MODEL_KEY)))
        await client.start_server()
        try:
            seen = []
            for seed in (2**63, 5):
                r = await client.post("/api/v1/generate", json=kobold_body(
                    temperature=1.0, sampler_seed=seed))
                health = await client.get("/health")
                report = await health.json()
                seen.append((r.status, health.status, report["state"],
                             report["dead_reason"],
                             report["reincarnations_total"]))
            return seen
        finally:
            await client.close()

    kw = dict(ENGINE_KW, disable_log_stats=True, disable_log_requests=True)
    jax_engine = JaxAsyncAphrodite.from_engine_args(JaxAsyncEngineArgs(
        model=tiny_model_dir, **kw))
    want = asyncio.run(asyncio.wait_for(go(jax_engine, jax_kobold), WAIT_S))
    port = AsyncAphrodite.from_engine_args(AsyncEngineArgs(
        model=tiny_model_dir, device="cpu", **kw))
    got = asyncio.run(asyncio.wait_for(go(port, build_kobold), WAIT_S))
    assert got == want
    assert got[0][:3] == (500, 503, "DEAD")
    assert got[0][3].startswith("OverflowError")


# ---- the surface (test_kobold_ooba.py) ----

def test_kobold_generate(servers):
    async def go(client):
        r = await client.post("/api/v1/generate", json={
            "prompt": "the quick brown", "max_length": 6,
            "max_context_length": 128, "temperature": 0.0})
        body = await r.json()
        assert r.status == 200, body
        assert len(body["results"]) == 1
        assert isinstance(body["results"][0]["text"], str)
        return body
    want, got = both(servers, go, "kobold")
    assert got == want


def test_kobold_generate_rejects_bad_context(servers):
    async def go(client):
        r = await client.post("/api/v1/generate", json={
            "prompt": "x", "max_length": 300, "max_context_length": 128})
        assert r.status == 422
        r = await client.post("/api/v1/generate", json={
            "prompt": "x", "max_length": 8, "max_context_length": 512})
        assert r.status == 422
        return (await r.json())["detail"]
    want, got = both(servers, go, "kobold")
    assert got == want and "max_model_len (256)" in got


def test_kobold_stream(servers):
    async def go(client):
        r = await client.post("/api/extra/generate/stream", json={
            "prompt": "hello", "max_length": 4,
            "max_context_length": 128, "temperature": 0.0})
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/event-stream")
        events, kinds = [], []
        async for line in r.content:
            line = line.decode().strip()
            if line.startswith("event: "):
                kinds.append(line)
            if line.startswith("data: "):
                events.append(json.loads(line[6:]))
        assert events and len(kinds) == len(events)
        assert all("token" in e for e in events)
        assert set(kinds) == {"event: message"}
        return events
    want, got = both(servers, go, "kobold")
    assert got == want


def test_kobold_info_routes(servers):
    async def go(client):
        out = []
        for route in ("/api/v1/info/version", "/api/v1/model",
                      "/api/latest/model", "/api/extra/version",
                      "/api/v1/config/max_context_length",
                      "/api/v1/config/max_length",
                      "/api/extra/true_max_context_length",
                      "/api/v1/config/soft_prompts_list",
                      "/api/v1/config/soft_prompt"):
            r = await client.get(route)
            assert r.status == 200, route
            out.append(await r.json())
        assert out[0]["result"]
        assert "tiny" in out[1]["result"]
        assert out[4]["value"] == 256 and out[5]["value"] == 128
        assert out[7]["values"] == []
        r = await client.put("/api/v1/config/soft_prompt", json={})
        assert r.status == 200
        r = await client.post("/api/extra/tokencount",
                              json={"prompt": "hello world"})
        value = (await r.json())["value"]
        assert value > 0
        return out, value
    want, got = both(servers, go, "kobold")
    assert got == want


def test_kobold_abort_noop(servers):
    async def go(client):
        r = await client.post("/api/extra/abort",
                              json={"genkey": "nonexistent"})
        assert r.status == 200
        r = await client.post("/api/extra/generate/check",
                              json={"genkey": "nonexistent"})
        assert r.status == 200
        return await r.json()
    want, got = both(servers, go, "kobold")
    assert got == want == {"results": [{"text": ""}]}


def test_kobold_check_polls_and_abort_ends_generation(servers):
    """`/api/extra/generate/check` reads the partial text of a running
    genkey, and `/api/extra/abort` by genkey ends it with the text so
    far; the polling cache is empty afterwards."""
    async def go(client):
        body = kobold_body(genkey="kai-poll", max_length=120,
                           max_context_length=256, temperature=0.0)
        task = asyncio.ensure_future(client.post("/api/v1/generate",
                                                 json=body))
        partial = ""
        for _ in range(2000):
            r = await client.post("/api/extra/generate/check",
                                  json={"genkey": "kai-poll"})
            partial = (await r.json())["results"][0]["text"]
            if partial:
                break
            await asyncio.sleep(0.005)
        r = await client.post("/api/extra/abort",
                              json={"genkey": "kai-poll"})
        assert r.status == 200
        r = await task
        assert r.status == 200
        final = (await r.json())["results"][0]["text"]
        r = await client.get("/api/extra/generate/check",
                             json={"genkey": "kai-poll"})
        return partial, final, (await r.json())["results"][0]["text"]
    partial, final, after = run(servers, go, "kobold")
    assert partial and final.startswith(partial)
    assert after == ""


def test_ooba_generate(servers):
    async def go(client):
        r = await client.post("/api/v1/generate", json={
            "prompt": "the quick", "max_new_tokens": 5,
            "temperature": 0.0, "ban_eos_token": True})
        body = await r.json()
        assert r.status == 200, body
        assert len(body["results"]) == 1
        r = await client.post("/api/v1/generate", json={"max_tokens": 2})
        assert r.status == 422
        return body
    want, got = both(servers, go, "ooba")
    assert got == want


def test_ooba_stream(servers):
    async def go(client):
        r = await client.post("/api/v1/generate", json={
            "prompt": "hello", "max_new_tokens": 4, "stream": True,
            "temperature": 0.0})
        chunks = []
        async for raw in r.content:
            raw = raw.decode().strip()
            if raw:
                chunks.append(json.loads(raw))
        assert chunks
        assert "results" in chunks[-1]
        texts = [c["results"][0]["text"] for c in chunks]
        assert all(b.startswith(a) for a, b in zip(texts, texts[1:]))
        return chunks
    want, got = both(servers, go, "ooba")
    assert got == want


def test_ooba_model_route(servers):
    async def go(client):
        r = await client.get("/api/v1/model")
        result = (await r.json())["result"]
        assert "tiny" in result
        return result
    want, got = both(servers, go, "ooba")
    assert got == want


# ---- the resume extension (test_stream_resume.py) ----

def test_kobold_and_ooba_journal_and_resume(servers):
    """Journaled token streams on both frontends; a continuation from
    the first two journaled tokens resumes with only the rest, bit-equal
    to the uninterrupted stream (seeded sampling included); a resume
    without the admin key is refused with 401."""
    async def kobold(client):
        out = []
        for extra in ({"temperature": 0.0},
                      {"temperature": 1.0, "sampler_seed": 99}):
            body = kobold_body(max_length=6, **extra)
            tokens, _, events = await _journaled(
                client, "/api/extra/generate/stream", body)
            assert len(tokens) == 6
            full = "".join(e["token"] for e in events)
            cont = dict(body, aphrodite_resume={
                "emitted_token_ids": tokens[:2]})
            rest, _, events2 = await _journaled(
                client, "/api/extra/generate/stream", cont,
                {RESUME_KEY_HEADER: ADMIN_KEY})
            assert rest == tokens[2:]
            delta = "".join(e["token"] for e in events2)
            assert full.endswith(delta) and delta
            r = await client.post("/api/extra/generate/stream", json=cont)
            assert r.status == 401
            r = await client.post("/api/extra/generate/stream", json=cont,
                                  headers={RESUME_KEY_HEADER: "wrong"})
            assert r.status == 401
            out.append((tokens, full, delta))
        return out

    async def ooba(client):
        out = []
        for extra in ({"temperature": 0.0},
                      {"temperature": 1.0, "seed": 99}):
            body = dict(prompt=PROMPT, max_new_tokens=6, ban_eos_token=True,
                        stream=True, **extra)
            tokens, _, chunks = await _journaled(client, "/api/v1/generate",
                                                 body)
            assert len(tokens) == 6
            full = chunks[-1]["results"][0]["text"]
            cont = dict(body, aphrodite_resume={
                "emitted_token_ids": tokens[:2]})
            rest, _, chunks2 = await _journaled(
                client, "/api/v1/generate", cont,
                {RESUME_KEY_HEADER: ADMIN_KEY})
            assert rest == tokens[2:]
            assert chunks2[-1]["results"][0]["text"] == full
            r = await client.post("/api/v1/generate", json=cont)
            assert r.status == 401
            out.append((tokens, full))
        return out

    want, got = both(servers, kobold, "kobold")
    assert got == want
    want, got = both(servers, ooba, "ooba")
    assert got == want


@pytest.mark.parametrize("server", ["openai", "kobold", "ooba"])
def test_server_without_device_cpu_raises_without_a_card(tiny_model_dir,
                                                         monkeypatch,
                                                         server):
    """Each server's `main()` takes `--device auto` unless told
    otherwise, which needs a card: without one it raises before serving,
    and never runs on the CPU on its own."""
    import importlib
    from aiohttp import web
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: `auto` would serve on it")
    module = importlib.import_module(
        f"aphrodite_tpu_torch.endpoints.{server}.api_server")

    def serve(*args, **kwargs):
        raise AssertionError("the server started")
    monkeypatch.setattr(web, "run_app", serve)
    monkeypatch.setattr("sys.argv", [
        "api_server", "--model", tiny_model_dir, "--load-format", "dummy",
        "--dtype", "float32", "--max-model-len", "128"])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        module.main()
