"""text-generation-webui (Ooba)-compatible server on aiohttp (port of
`aphrodite_tpu/endpoints/ooba/api_server.py`, copied with its import
paths rewritten). Start it on the CPU with

    python -m aphrodite_tpu_torch.endpoints.ooba.api_server \
        --model <dir> --load-format dummy --device cpu

and on the card without `--device` (it defaults to `auto`).

Reference: `aphrodite/endpoints/ooba/api_server.py:45-159` —
/api/v1/generate with field aliases (stopping_strings -> stop,
max_new_tokens -> max_tokens, ban_eos_token -> ignore_eos, min_length ->
BanEOSUntil), newline-delimited JSON streaming, /api/v1/model, /health.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import fields as dataclass_fields
from typing import List, Optional

from aiohttp import web

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.logits_processor import BanEOSUntil
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.utils import random_uuid
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

_PARAM_NAMES = {f.name for f in dataclass_fields(SamplingParams)}


def _draining(e: EngineDrainingError) -> web.Response:
    """HTTP 503 + Retry-After: the replica is draining for shutdown
    (distinct from overload's 429 — clients should go elsewhere)."""
    return web.json_response({"detail": str(e)}, status=503,
                             headers=retry_after_headers(
                                 e.retry_after_s))


class OobaServer:

    def __init__(self, engine: AsyncAphrodite, served_model: str,
                 admin_keys: Optional[List[str]] = None) -> None:
        self.engine = engine
        self.served_model = served_model
        self.admin_keys = admin_keys
        self.tokenizer = engine.engine.tokenizer.tokenizer

    def build_app(self) -> web.Application:
        app = web.Application()
        app.router.add_post("/api/v1/generate", self.generate)
        app.router.add_get("/api/v1/model", self.get_model)
        # Shared lifecycle surface: /health (HealthReport JSON, 503
        # once DRAINING/DEAD), authed /admin/drain, SIGTERM drain.
        install_lifecycle(app, self.engine, admin_keys=self.admin_keys)
        return app

    async def generate(self, request: web.Request) -> web.Response:
        body = await request.json()
        try:
            prompt = body.pop("prompt")
        except KeyError:
            return web.json_response({"detail": "prompt is required"},
                                     status=422)
        stream = body.pop("stream", False)
        try:
            emitted = resume_token_ids(body)
        except ValueError as e:
            return web.json_response({"detail": str(e)}, status=422)
        body.pop("aphrodite_resume", None)
        if emitted is not None:
            # Continuation (router-internal): admin-key-gated,
            # streaming + single-sequence only.
            denied = resume_denied(request, self.admin_keys)
            if denied is not None:
                return denied
            if not stream or (body.get("n") or 1) != 1 or \
                    (body.get("best_of") or 1) > 1 or \
                    body.get("use_beam_search"):
                return web.json_response(
                    {"detail": "aphrodite_resume requires a streamed "
                               "single-sequence request"}, status=422)

        # Ooba field aliases (reference :59-68).
        if "stopping_strings" in body:
            body["stop"] = body.pop("stopping_strings")
        if "max_new_tokens" in body:
            body["max_tokens"] = body.pop("max_new_tokens")
        if "min_length" in body:
            body["min_tokens"] = body.pop("min_length")
        if "ban_eos_token" in body:
            body["ignore_eos"] = body.pop("ban_eos_token")
        if body.get("top_k") == 0:
            body["top_k"] = -1

        min_length = body.pop("min_tokens", 0)
        if body.get("ignore_eos", False):
            min_length = body.get("max_tokens", 16)
        processors = []
        eos_id = self.tokenizer.eos_token_id
        if min_length and eos_id is not None:
            processors.append(BanEOSUntil(min_length, eos_id))

        kwargs = {k: v for k, v in body.items() if k in _PARAM_NAMES}
        if processors:
            kwargs["logits_processors"] = processors
        try:
            sampling_params = SamplingParams(**kwargs)
        except Exception as err:
            return web.json_response({"detail": str(err)}, status=422)

        request_id = random_uuid()

        if stream:
            # Admit before streaming starts so sheds are real 429s.
            try:
                out_stream = await self.engine.add_request(
                    request_id, prompt, sampling_params,
                    emitted_token_ids=emitted)
            except RequestRejectedError as e:
                return web.json_response(
                    {"detail": str(e)}, status=429,
                    headers=retry_after_headers(e.retry_after_s))
            except EngineDrainingError as e:
                return _draining(e)
            journal = stream_journal(request,
                                     resumed_tokens=len(emitted or ()))
            response = web.StreamResponse()
            await response.prepare(request)
            try:
                async for request_output in out_stream:
                    if await request_disconnected(request):
                        out_stream.cancel()
                        return response
                    outs = request_output.outputs
                    if journal is not None and len(outs) == 1:
                        await response.write(journal.record(
                            outs[0].token_ids, outs[0].finish_reason))
                    ret = {"results": [{"text": out.text}
                                       for out in outs]}
                    await response.write(
                        (json.dumps(ret) + "\n\n").encode())
            except (RequestTimeoutError, EngineDrainingError) as e:
                await response.write(
                    (json.dumps({"detail": str(e)}) + "\n\n").encode())
            except BaseException:
                out_stream.cancel()
                raise
            await response.write_eof()
            return response

        final = None
        try:
            async for request_output in self.engine.generate(
                    prompt, sampling_params, request_id):
                if await request_disconnected(request):
                    await self.engine.abort(request_id)
                    return web.Response(status=499)
                final = request_output
        except RequestRejectedError as e:
            return web.json_response(
                {"detail": str(e)}, status=429,
                headers=retry_after_headers(e.retry_after_s))
        except RequestTimeoutError as e:
            return web.json_response({"detail": str(e)}, status=408)
        except EngineDrainingError as e:
            return _draining(e)
        assert final is not None
        return web.json_response(
            {"results": [{"text": out.text} for out in final.outputs]})

    async def get_model(self, request) -> web.Response:
        return web.json_response(
            {"result": f"aphrodite-tpu/{self.served_model}"})


def build_app(engine: AsyncAphrodite, served_model: str,
              admin_keys: Optional[List[str]] = None) -> web.Application:
    return OobaServer(engine, served_model,
                      admin_keys=admin_keys).build_app()


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Aphrodite Ooba-compatible API server (PyTorch port)")
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
