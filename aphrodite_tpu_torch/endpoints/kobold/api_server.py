"""KoboldAI United-compatible HTTP server on aiohttp (port of
`aphrodite_tpu/endpoints/kobold/api_server.py`, copied with its import
paths rewritten). Start it on the CPU with

    python -m aphrodite_tpu_torch.endpoints.kobold.api_server \
        --model <dir> --load-format dummy --device cpu

and on the card without `--device` (it defaults to `auto`).

Reference: `aphrodite/endpoints/kobold/api_server.py:141-311` — routes
/api/v1/generate, /api/extra/generate/stream (SSE `event: message`),
/api/extra/generate/check (poll), /api/extra/abort,
/api/extra/tokencount, version/model/config queries, softprompt stubs,
badwordsids EOS-ban handling (`_set_badwords :42`).
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Tuple

from aiohttp import web
from pydantic import ValidationError

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.utils import random_uuid
from aphrodite_tpu_torch.endpoints.kobold.protocol import (
    KAIGenerationInputSchema)
from aphrodite_tpu_torch.endpoints.utils import (install_lifecycle,
                                                 request_disconnected,
                                                 resume_denied,
                                                 resume_token_ids,
                                                 retry_after_headers,
                                                 stream_journal)
from aphrodite_tpu_torch.engine.args_tools import AsyncEngineArgs
from aphrodite_tpu_torch.engine.async_aphrodite import AsyncAphrodite
from aphrodite_tpu_torch.processing.admission import (EngineDrainingError,
                                                      RequestRejectedError,
                                                      RequestTimeoutError)

logger = init_logger(__name__)

_SAMPLING_EPS = 1e-5
KAI_VERSION = "1.2.4"          # KoboldAI United API version we speak


def _overloaded(e: RequestRejectedError) -> web.Response:
    """HTTP 429 + Retry-After for an admission-shed request."""
    return web.json_response(
        {"detail": str(e)}, status=429,
        headers=retry_after_headers(e.retry_after_s))


def _draining(e: EngineDrainingError) -> web.Response:
    """HTTP 503 + Retry-After: the replica is draining for shutdown
    (distinct from overload's 429 — clients should go elsewhere)."""
    return web.json_response({"detail": str(e)}, status=503,
                             headers=retry_after_headers(
                                 e.retry_after_s))


def _set_badwords(tokenizer, hf_config) -> List[int]:
    """Token ids banned under use_default_badwordsids (reference `:42`):
    any vocab token containing '[' or ']' plus EOS."""
    bad_words_ids = getattr(hf_config, "bad_words_ids", None)
    if bad_words_ids is not None:
        return [t for ids in bad_words_ids for t in ids] \
            if bad_words_ids and isinstance(bad_words_ids[0], list) \
            else list(bad_words_ids)
    ids = [
        v for k, v in tokenizer.get_vocab().items()
        if any(c in str(k) for c in "[]")
    ]
    if tokenizer.pad_token_id in ids:
        ids.remove(tokenizer.pad_token_id)
    if tokenizer.eos_token_id is not None:
        ids.append(tokenizer.eos_token_id)
    return ids


class KoboldServer:

    def __init__(self, engine: AsyncAphrodite, served_model: str,
                 admin_keys: Optional[List[str]] = None) -> None:
        self.engine = engine
        self.served_model = served_model
        self.admin_keys = admin_keys
        self.max_model_len = engine.engine.model_config.max_model_len
        self.tokenizer = engine.engine.tokenizer.tokenizer
        self.badwordsids = _set_badwords(
            self.tokenizer, engine.engine.model_config.hf_config)
        # genkey -> partial text, for /generate/check polling.
        self.gen_cache = {}

    def build_app(self) -> web.Application:
        app = web.Application()
        for prefix in ("/api/v1", "/api/latest"):
            app.router.add_post(f"{prefix}/generate", self.generate)
            app.router.add_get(f"{prefix}/info/version", self.get_version)
            app.router.add_get(f"{prefix}/model", self.get_model)
            app.router.add_get(f"{prefix}/config/soft_prompts_list",
                               self.get_softprompts)
            app.router.add_get(f"{prefix}/config/soft_prompt",
                               self.get_softprompt)
            app.router.add_put(f"{prefix}/config/soft_prompt",
                               self.set_softprompt)
            app.router.add_get(f"{prefix}/config/max_length",
                               self.get_max_length)
            app.router.add_get(f"{prefix}/config/max_context_length",
                               self.get_max_context_length)
        app.router.add_post("/api/extra/generate/stream",
                            self.generate_stream)
        app.router.add_post("/api/extra/generate/check", self.check)
        app.router.add_get("/api/extra/generate/check", self.check)
        app.router.add_post("/api/extra/abort", self.abort)
        app.router.add_post("/api/extra/tokencount", self.tokencount)
        app.router.add_get("/api/extra/true_max_context_length",
                           self.get_max_context_length)
        app.router.add_get("/api/extra/version", self.get_extra_version)
        # Shared lifecycle surface: /health (HealthReport JSON, 503
        # once DRAINING/DEAD), authed /admin/drain, SIGTERM drain.
        install_lifecycle(app, self.engine, admin_keys=self.admin_keys)
        return app

    # -- payload prep (reference prepare_engine_payload :84-140) --

    def _prepare(self, payload: KAIGenerationInputSchema
                 ) -> Tuple[SamplingParams, List[int]]:
        if not payload.genkey:
            payload.genkey = f"kai-{random_uuid()}"
        if payload.max_context_length > self.max_model_len:
            raise ValueError(
                f"max_context_length ({payload.max_context_length}) must "
                f"be less than or equal to max_model_len "
                f"({self.max_model_len})")

        # KAI: top_k == 0 means disabled; engine: -1 means disabled.
        top_k = payload.top_k if payload.top_k != 0 else -1
        tfs = max(_SAMPLING_EPS, payload.tfs)
        top_p, n = payload.top_p, payload.n
        if payload.temperature < _SAMPLING_EPS:
            n, top_p, top_k = 1, 1.0, -1

        sampling_params = SamplingParams(
            n=n,
            best_of=n,
            repetition_penalty=payload.rep_pen,
            temperature=payload.temperature,
            dynatemp_range=payload.dynatemp_range,
            dynatemp_exponent=payload.dynatemp_exponent,
            smoothing_factor=payload.smoothing_factor,
            tfs=tfs,
            top_p=top_p,
            top_k=top_k,
            top_a=payload.top_a,
            min_p=payload.min_p,
            typical_p=payload.typical,
            eta_cutoff=payload.eta_cutoff,
            epsilon_cutoff=payload.eps_cutoff,
            mirostat_mode=payload.mirostat,
            mirostat_tau=payload.mirostat_tau,
            mirostat_eta=payload.mirostat_eta,
            seed=payload.sampler_seed,
            stop=payload.stop_sequence,
            include_stop_str_in_output=payload.include_stop_str_in_output,
            custom_token_bans=self.badwordsids
            if payload.use_default_badwordsids else [],
            max_tokens=payload.max_length,
        )
        max_input_tokens = max(
            1, payload.max_context_length - payload.max_length)
        input_tokens = self.tokenizer(
            payload.prompt).input_ids[-max_input_tokens:]
        return sampling_params, input_tokens

    async def _parse(self, request: web.Request) -> KAIGenerationInputSchema:
        return KAIGenerationInputSchema(**await request.json())

    # -- generation routes --

    async def generate(self, request: web.Request) -> web.Response:
        try:
            payload = await self._parse(request)
            sampling_params, input_tokens = self._prepare(payload)
        except (ValidationError, ValueError) as e:
            return web.json_response({"detail": str(e)}, status=422)

        final = None
        try:
            async for res in self.engine.generate(None, sampling_params,
                                                  payload.genkey,
                                                  input_tokens):
                if await request_disconnected(request):
                    # Client hung up: free its KV pages within one
                    # step instead of waiting on GC.
                    await self.engine.abort(payload.genkey)
                    return web.json_response({"results": [{"text": ""}]})
                final = res
                self.gen_cache[payload.genkey] = res.outputs[0].text
        except RequestRejectedError as e:
            return _overloaded(e)
        except RequestTimeoutError as e:
            return web.json_response({"detail": str(e)}, status=408)
        except EngineDrainingError as e:
            return _draining(e)
        finally:
            # Cancellation/abort must not leak the polling cache entry.
            self.gen_cache.pop(payload.genkey, None)
        if final is None:
            # Aborted before the first token: KoboldAI expects an empty
            # result, not an error.
            return web.json_response({"results": [{"text": ""}]})
        return web.json_response({
            "results": [{"text": out.text} for out in final.outputs]
        })

    async def generate_stream(self,
                              request: web.Request) -> web.StreamResponse:
        try:
            raw_body = await request.json()
            payload = KAIGenerationInputSchema(**raw_body)
            sampling_params, input_tokens = self._prepare(payload)
            emitted = resume_token_ids(raw_body)
        except (ValidationError, ValueError) as e:
            return web.json_response({"detail": str(e)}, status=422)
        if emitted is not None:
            # Continuation (router-internal): admin-key-gated,
            # single-sequence only.
            denied = resume_denied(request, self.admin_keys)
            if denied is not None:
                return denied
            if (payload.n or 1) != 1:
                return web.json_response(
                    {"detail": "aphrodite_resume supports "
                               "single-sequence requests only"},
                    status=422)

        # Admit before the SSE prelude so sheds are real 429s.
        try:
            stream = await self.engine.add_request(
                payload.genkey, None, sampling_params,
                prompt_token_ids=input_tokens,
                emitted_token_ids=emitted)
        except RequestRejectedError as e:
            return _overloaded(e)
        except EngineDrainingError as e:
            return _draining(e)
        journal = stream_journal(request,
                                 resumed_tokens=len(emitted or ()))
        response = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })
        await response.prepare(request)
        previous_output = None
        try:
            async for res in stream:
                if await request_disconnected(request):
                    stream.cancel()
                    return response
                if previous_output is None:
                    previous_output = res.resumed_text if emitted else ""
                new_chunk = res.outputs[0].text[len(previous_output):]
                previous_output = res.outputs[0].text
                if journal is not None:
                    await response.write(journal.record(
                        res.outputs[0].token_ids,
                        res.outputs[0].finish_reason))
                await response.write(b"event: message\n")
                await response.write(
                    f"data: "
                    f"{json.dumps({'token': new_chunk})}\n\n".encode())
        except (RequestTimeoutError, EngineDrainingError) as e:
            await response.write(
                f"data: {json.dumps({'error': str(e)})}\n\n".encode())
        except BaseException:
            stream.cancel()
            raise
        await response.write_eof()
        return response

    async def check(self, request: web.Request) -> web.Response:
        text = ""
        try:
            body = await request.json()
            if "genkey" in body and body["genkey"] in self.gen_cache:
                text = self.gen_cache[body["genkey"]]
        except (json.JSONDecodeError, Exception):
            pass
        return web.json_response({"results": [{"text": text}]})

    async def abort(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
            if "genkey" in body:
                await self.engine.abort(body["genkey"])
        except Exception:
            pass
        return web.json_response({})

    async def tokencount(self, request: web.Request) -> web.Response:
        body = await request.json()
        ids = self.tokenizer(body["prompt"]).input_ids
        return web.json_response({"value": len(ids)})

    # -- info / config routes --

    async def get_version(self, request) -> web.Response:
        return web.json_response({"result": KAI_VERSION})

    async def get_extra_version(self, request) -> web.Response:
        return web.json_response({"result": "KoboldCpp", "version": "1.57"})

    async def get_model(self, request) -> web.Response:
        return web.json_response(
            {"result": f"aphrodite-tpu/{self.served_model}"})

    async def get_softprompts(self, request) -> web.Response:
        return web.json_response({"values": []})

    async def get_softprompt(self, request) -> web.Response:
        return web.json_response({"value": ""})

    async def set_softprompt(self, request) -> web.Response:
        return web.json_response({})

    async def get_max_length(self, request) -> web.Response:
        return web.json_response({"value": self.max_model_len // 2})

    async def get_max_context_length(self, request) -> web.Response:
        return web.json_response({"value": self.max_model_len})


def build_app(engine: AsyncAphrodite, served_model: str,
              admin_keys: Optional[List[str]] = None) -> web.Application:
    return KoboldServer(engine, served_model,
                        admin_keys=admin_keys).build_app()


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Aphrodite KoboldAI-compatible API server (PyTorch port)")
    parser.add_argument("--host", type=str, default=None)
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--served-model-name", type=str, default=None)
    parser.add_argument("--admin-key", type=str, default=None,
                        help="comma-separated keys accepted by the "
                             "POST /admin/drain lifecycle endpoint "
                             "(unset = endpoint disabled; SIGTERM "
                             "drain works regardless)")
    parser = AsyncEngineArgs.add_cli_args(parser)
    args = parser.parse_args()
    engine = AsyncAphrodite.from_engine_args(
        AsyncEngineArgs.from_cli_args(args))
    app = build_app(engine, args.served_model_name or args.model,
                    admin_keys=args.admin_key.split(",")
                    if args.admin_key else None)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
