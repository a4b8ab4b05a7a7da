"""OpenAI-compatible HTTP server on aiohttp (port of
`aphrodite_tpu/endpoints/openai/api_server.py`, copied with its import
paths rewritten; the profile routes drive `torch.profiler` through the
engine's hooks). Start it on the CPU with

    python -m aphrodite_tpu_torch.endpoints.openai.api_server \
        --model <dir> --load-format dummy --device cpu

Reference: `aphrodite/endpoints/openai/api_server.py` (routes `:193-560`,
chat templates `:132`, API-key auth `:109`, /metrics `:104-106`, default
port 2242 `:55`). The reference uses FastAPI/uvicorn; this build uses
aiohttp (async-native, SSE streaming via chunked responses) — same
routes, same wire format:

  GET  /health            GET  /v1/models        POST /v1/tokenize
  POST /v1/completions    POST /v1/chat/completions   GET /metrics
  POST /admin/drain  (authed; also: SIGTERM = drain-then-exit)

Lifecycle (endpoints/utils.install_lifecycle, shared with the Kobold
and Ooba frontends): /health serializes the supervisor's report (503
once DRAINING/DEAD so load balancers eject the replica), /admin/drain
and SIGTERM start a graceful drain — new requests get 503 +
Retry-After (distinct from overload's 429), in-flight requests run to
completion under APHRODITE_DRAIN_DEADLINE_S, then the process exits
clean.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import tempfile
from typing import AsyncIterator, List, Optional

from aiohttp import web
from prometheus_client import generate_latest, CONTENT_TYPE_LATEST
from pydantic import ValidationError

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.logits_processor import BiasLogitsProcessor
from aphrodite_tpu_torch.common.outputs import RequestOutput
from aphrodite_tpu_torch.common.utils import random_uuid
from aphrodite_tpu_torch.endpoints.openai.protocol import (
    ChatCompletionRequest, ChatCompletionResponse,
    ChatCompletionResponseChoice, ChatCompletionResponseStreamChoice,
    ChatCompletionStreamResponse, ChatMessage, CompletionRequest,
    CompletionResponse, CompletionResponseChoice,
    CompletionResponseStreamChoice, CompletionStreamResponse,
    DeltaMessage, ErrorResponse, LogProbs, ModelCard, ModelList,
    ModelPermission, TokenizeRequest, TokenizeResponse, UsageInfo)
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

ENGINE_KEY = web.AppKey("engine", AsyncAphrodite)


def _error(message: str, err_type: str = "invalid_request_error",
           status: int = 400) -> web.Response:
    body = ErrorResponse(message=message, type=err_type).model_dump()
    return web.json_response(body, status=status)


def _overloaded(e: RequestRejectedError) -> web.Response:
    """HTTP 429 for an admission-shed request, with the controller's
    Retry-After estimate (whole seconds, at least 1)."""
    body = ErrorResponse(message=str(e), type="overloaded_error",
                         code="429").model_dump()
    return web.json_response(body, status=429,
                             headers=retry_after_headers(
                                 e.retry_after_s))


def _draining(e: EngineDrainingError) -> web.Response:
    """HTTP 503 for a request rejected (or force-aborted) because the
    replica is draining for shutdown — deliberately distinct from
    overload's 429: 503 means "go to another replica", 429 means
    "back off and retry here"."""
    body = ErrorResponse(message=str(e), type="draining_error",
                         code="503").model_dump()
    return web.json_response(body, status=503,
                             headers=retry_after_headers(
                                 e.retry_after_s))


def _timed_out(e: RequestTimeoutError) -> web.Response:
    """HTTP 408 for a request that expired in the waiting queue past
    its TTFT deadline."""
    body = ErrorResponse(message=str(e), type="timeout_error",
                         code="408").model_dump()
    return web.json_response(body, status=408)


def _make_logprobs(token_ids, id_logprobs, tokenizer,
                   initial_text_offset: int = 0) -> LogProbs:
    """Build OpenAI-style LogProbs from per-token {id: lp} dicts
    (reference create_logprobs, api_server.py:228-258)."""
    lp = LogProbs()
    last_token_len = 0
    lp.top_logprobs = []
    for token_id, step_lp in zip(token_ids, id_logprobs):
        token = tokenizer.convert_ids_to_tokens(token_id)
        lp.tokens.append(token)
        if step_lp is None:
            lp.token_logprobs.append(None)
            lp.top_logprobs.append(None)
        else:
            lp.token_logprobs.append(step_lp.get(token_id))
            lp.top_logprobs.append({
                tokenizer.convert_ids_to_tokens(i): p
                for i, p in step_lp.items()
            })
        if len(lp.text_offset) == 0:
            lp.text_offset.append(initial_text_offset)
        else:
            lp.text_offset.append(lp.text_offset[-1] + last_token_len)
        last_token_len = len(token)
    return lp


class OpenAIServer:
    """Route handlers bound to one AsyncAphrodite engine."""

    def __init__(self, engine: AsyncAphrodite, served_model: str,
                 response_role: str = "assistant",
                 chat_template: Optional[str] = None,
                 api_keys: Optional[List[str]] = None,
                 admin_keys: Optional[List[str]] = None) -> None:
        self.engine = engine
        self.served_model = served_model
        self.response_role = response_role
        self.api_keys = api_keys
        self.admin_keys = admin_keys
        self.max_model_len = \
            engine.engine.model_config.max_model_len
        self.vocab_size = engine.engine.model_config.get_vocab_size()
        self.tokenizer = engine.engine.tokenizer.tokenizer
        if chat_template is not None:
            self.tokenizer.chat_template = chat_template

    # ---- app assembly ----

    def build_app(self) -> web.Application:
        app = web.Application(middlewares=[self._auth_middleware])
        app[ENGINE_KEY] = self.engine
        # /health + authed /admin/drain + SIGTERM drain-then-exit,
        # shared with the Kobold/Ooba frontends.
        install_lifecycle(app, self.engine, admin_keys=self.admin_keys)
        app.router.add_post("/start_profile", self.start_profile)
        app.router.add_post("/stop_profile", self.stop_profile)
        app.router.add_get("/v1/models", self.show_models)
        app.router.add_post("/v1/tokenize", self.tokenize)
        app.router.add_post("/v1/completions", self.create_completion)
        app.router.add_post("/v1/chat/completions",
                            self.create_chat_completion)
        app.router.add_get("/metrics", self.metrics)
        return app

    @web.middleware
    async def _auth_middleware(self, request: web.Request, handler):
        protected = request.path.startswith("/v1") or \
            request.path in ("/start_profile", "/stop_profile")
        if self.api_keys and protected:
            auth = request.headers.get("Authorization", "")
            token = auth.removeprefix("Bearer ").strip()
            if token not in self.api_keys:
                return _error("Invalid API key", "authentication_error",
                              401)
        return await handler(request)

    # ---- simple routes ----

    async def start_profile(self, request: web.Request) -> web.Response:
        """Begin a torch.profiler trace (a Chrome trace, written by
        /stop_profile); body: {"trace_dir": "..."} (default
        aphrodite-profile under the temporary directory)."""
        try:
            body = await request.json()
        except Exception:
            body = {}
        trace_dir = body.get("trace_dir", os.path.join(
            tempfile.gettempdir(), "aphrodite-profile"))
        try:
            self.engine.engine.start_profile(trace_dir)
        except RuntimeError as e:
            return _error(str(e))
        return web.json_response({"status": "profiling",
                                  "trace_dir": trace_dir})

    async def stop_profile(self, request: web.Request) -> web.Response:
        try:
            path = self.engine.engine.stop_profile()
        except RuntimeError as e:
            return _error(str(e))
        return web.json_response({"status": "stopped", "trace": path})

    async def metrics(self, request: web.Request) -> web.Response:
        return web.Response(body=generate_latest(),
                            content_type=CONTENT_TYPE_LATEST.split(";")[0])

    async def show_models(self, request: web.Request) -> web.Response:
        cards = ModelList(data=[
            ModelCard(id=self.served_model, root=self.served_model,
                      permission=[ModelPermission()])
        ])
        return web.json_response(cards.model_dump())

    async def tokenize(self, request: web.Request) -> web.Response:
        try:
            body = TokenizeRequest(**await request.json())
        except (ValidationError, ValueError) as e:
            return _error(str(e))
        ids = self.tokenizer.encode(body.prompt)
        return web.json_response(TokenizeResponse(
            tokens=ids, count=len(ids),
            max_model_len=self.max_model_len).model_dump())

    # ---- completions ----

    def _check_model(self, model: str) -> Optional[web.Response]:
        if model != self.served_model:
            return _error(f"The model `{model}` does not exist.",
                          "model_not_found", 404)
        return None

    def _check_resume(self, request: web.Request, req):
        """(emitted_token_ids, None) for a valid continuation request,
        (None, None) for a plain one, (None, error response) when the
        resume extension is unauthorized or malformed. The extension
        is router-internal: admin-key-gated, streaming-only,
        single-sequence-only."""
        if req.aphrodite_resume is None:
            return None, None
        denied = resume_denied(request, self.admin_keys)
        if denied is not None:
            return None, denied
        try:
            emitted = resume_token_ids(
                {"aphrodite_resume": req.aphrodite_resume})
        except ValueError as e:
            return None, _error(str(e))
        if not req.stream:
            return None, _error("aphrodite_resume requires stream=true")
        if (req.n or 1) != 1 or (req.best_of or 1) > 1 or \
                req.use_beam_search:
            return None, _error("aphrodite_resume supports "
                                "single-sequence requests only")
        return emitted, None

    async def _build_processors(self, req) -> Optional[list]:
        processors = []
        if req.logit_bias:
            try:
                biases = {int(k): float(v)
                          for k, v in req.logit_bias.items()}
            except ValueError as e:
                raise ValueError(
                    f"Invalid logit_bias keys: {e}") from e
            for token_id in biases:
                # Out-of-vocab ids would crash the shared engine step.
                if not 0 <= token_id < self.vocab_size:
                    raise ValueError(
                        f"logit_bias token id {token_id} out of vocab "
                        f"range [0, {self.vocab_size})")
            processors.append(BiasLogitsProcessor(biases))
        if getattr(req, "grammar", None):
            import asyncio
            import functools as _ft

            from aphrodite_tpu_torch.common.grammar import (
                GrammarLogitsProcessor)
            try:
                # First use of a grammar compiles LALR tables and walks
                # the whole vocab — run off the event loop.
                processors.append(
                    await asyncio.get_running_loop().run_in_executor(
                        None, _ft.partial(GrammarLogitsProcessor,
                                          self.tokenizer, req.grammar)))
            except Exception as e:
                raise ValueError(f"Invalid grammar: {e}") from e
        return processors or None

    async def create_completion(self,
                                request: web.Request) -> web.Response:
        try:
            req = CompletionRequest(**await request.json())
        except (ValidationError, ValueError) as e:
            return _error(str(e))
        if (err := self._check_model(req.model)) is not None:
            return err
        if req.suffix is not None:
            return _error("suffix is not currently supported")
        if req.echo and req.stream:
            return _error("echo is not supported with streaming")

        # Prompt may be text, token ids, or a batch of either.
        prompts = req.prompt
        if isinstance(prompts, str):
            prompts = [prompts]
        elif prompts and isinstance(prompts[0], int):
            prompts = [prompts]
        if len(prompts) != 1 and req.stream:
            return _error("streaming supports a single prompt")

        try:
            sampling_params = req.to_sampling_params(
                req.max_tokens, await self._build_processors(req))
        except ValueError as e:
            return _error(str(e))

        emitted, err = self._check_resume(request, req)
        if err is not None:
            return err

        request_id = f"cmpl-{random_uuid()}"
        if req.stream:
            return await self._stream_completion(
                request, req, sampling_params, prompts[0], request_id,
                emitted=emitted)

        async def consume(i: int, prompt) -> Optional[RequestOutput]:
            """Drain one generator; all prompts run CONCURRENTLY so the
            engine continuous-batches them (a sequential drain would
            serialize the batch)."""
            kwargs = dict(prompt_token_ids=prompt) \
                if isinstance(prompt, list) else dict()
            text = None if isinstance(prompt, list) else prompt
            final: Optional[RequestOutput] = None
            async for output in self.engine.generate(
                    text, sampling_params, f"{request_id}-{i}", **kwargs):
                if await request_disconnected(request):
                    await self.engine.abort(f"{request_id}-{i}")
                    return None
                final = output
            return final

        try:
            finals = await asyncio.gather(
                *(consume(i, p) for i, p in enumerate(prompts)))
        except (RequestRejectedError, RequestTimeoutError,
                EngineDrainingError) as e:
            # Shed at admission (429 + Retry-After), expired in the
            # queue (408), or rejected/aborted by a draining replica
            # (503); siblings of a batch are aborted with it.
            for i in range(len(prompts)):
                self.engine.abort_request(f"{request_id}-{i}")
            if isinstance(e, EngineDrainingError):
                return _draining(e)
            return _overloaded(e) \
                if isinstance(e, RequestRejectedError) else _timed_out(e)
        if any(f is None for f in finals):
            return _error("Client disconnected", status=499)

        choices = []
        num_prompt_tokens = num_gen_tokens = 0
        for final in finals:
            for out in final.outputs:
                text = out.text
                if req.echo:
                    text = (final.prompt or "") + text
                logprobs = None
                if req.logprobs is not None:
                    logprobs = _make_logprobs(out.token_ids, out.logprobs,
                                              self.tokenizer)
                choices.append(CompletionResponseChoice(
                    index=len(choices), text=text, logprobs=logprobs,
                    finish_reason=out.finish_reason))
            num_prompt_tokens += len(final.prompt_token_ids)
            num_gen_tokens += sum(len(o.token_ids) for o in final.outputs)

        usage = UsageInfo(prompt_tokens=num_prompt_tokens,
                          completion_tokens=num_gen_tokens,
                          total_tokens=num_prompt_tokens + num_gen_tokens)
        resp = CompletionResponse(id=request_id, model=req.model,
                                  choices=choices, usage=usage)
        return web.json_response(resp.model_dump())

    async def _stream_completion(self, request, req, sampling_params,
                                 prompt, request_id,
                                 emitted=None) -> web.StreamResponse:
        kwargs = dict(prompt_token_ids=prompt) \
            if isinstance(prompt, list) else dict()
        text = None if isinstance(prompt, list) else prompt
        # Admit BEFORE preparing the SSE response: a shed request gets
        # a real HTTP 429 + Retry-After, not an error inside a 200
        # event stream.
        try:
            stream = await self.engine.add_request(
                request_id, text, sampling_params,
                emitted_token_ids=emitted, **kwargs)
        except RequestRejectedError as e:
            return _overloaded(e)
        except EngineDrainingError as e:
            return _draining(e)
        journal = stream_journal(request,
                                 resumed_tokens=len(emitted or ()))
        response = _sse_response()
        await response.prepare(request)
        previous_texts = {}
        try:
            async for output in stream:
                if await request_disconnected(request):
                    # Client hung up mid-stream: release its KV pages
                    # within one step instead of at GC time.
                    stream.cancel()
                    return response
                for out in output.outputs:
                    prev = previous_texts.get(out.index)
                    if prev is None:
                        # A continuation's baseline was already
                        # delivered by the pre-failover replica.
                        prev = output.resumed_text if emitted else ""
                    delta = out.text[len(prev):]
                    previous_texts[out.index] = out.text
                    if journal is not None and len(output.outputs) == 1:
                        await response.write(journal.record(
                            out.token_ids, out.finish_reason))
                    chunk = CompletionStreamResponse(
                        id=request_id, model=req.model,
                        choices=[CompletionResponseStreamChoice(
                            index=out.index, text=delta,
                            finish_reason=out.finish_reason)])
                    await _sse_send(response, chunk.model_dump())
            await _sse_done(response)
        except asyncio.CancelledError:
            stream.cancel()
            raise
        except RequestTimeoutError as e:
            # Expired in the queue after the SSE prelude: surface the
            # typed timeout in-band, then close.
            await _sse_send(response, {"error": {
                "message": str(e), "type": "timeout_error"}})
            await response.write_eof()
        except EngineDrainingError as e:
            # Drain deadline force-abort mid-stream: in-band typed
            # error, then close (the 503 ship has sailed).
            await _sse_send(response, {"error": {
                "message": str(e), "type": "draining_error"}})
            await response.write_eof()
        except Exception:
            stream.cancel()
            raise
        return response

    # ---- chat completions ----

    def _apply_chat_template(self, req: ChatCompletionRequest) -> str:
        if isinstance(req.messages, str):
            return req.messages
        try:
            return self.tokenizer.apply_chat_template(
                conversation=req.messages, tokenize=False,
                add_generation_prompt=req.add_generation_prompt)
        except Exception:
            # No template in tokenizer: simple role-prefixed fallback.
            parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
                     for m in req.messages]
            if req.add_generation_prompt:
                parts.append(f"{self.response_role}:")
            return "\n".join(parts)

    async def create_chat_completion(self,
                                     request: web.Request) -> web.Response:
        try:
            req = ChatCompletionRequest(**await request.json())
        except (ValidationError, ValueError) as e:
            return _error(str(e))
        if (err := self._check_model(req.model)) is not None:
            return err

        try:
            prompt = self._apply_chat_template(req)
            max_tokens = req.max_tokens
            if max_tokens is None:
                prompt_ids = self.tokenizer.encode(prompt)
                max_tokens = self.max_model_len - len(prompt_ids)
            sampling_params = req.to_sampling_params(
                max_tokens, await self._build_processors(req))
        except ValueError as e:
            return _error(str(e))

        emitted, resume_err = self._check_resume(request, req)
        if resume_err is not None:
            return resume_err

        request_id = f"chatcmpl-{random_uuid()}"
        if req.stream:
            return await self._stream_chat(request, req, sampling_params,
                                           prompt, request_id,
                                           emitted=emitted)

        final: Optional[RequestOutput] = None
        try:
            async for output in self.engine.generate(
                    prompt, sampling_params, request_id):
                if await request_disconnected(request):
                    await self.engine.abort(request_id)
                    return _error("Client disconnected", status=499)
                final = output
        except RequestRejectedError as e:
            return _overloaded(e)
        except RequestTimeoutError as e:
            return _timed_out(e)
        except EngineDrainingError as e:
            return _draining(e)
        assert final is not None
        choices = [
            ChatCompletionResponseChoice(
                index=i,
                message=ChatMessage(role=self.response_role,
                                    content=out.text),
                finish_reason=out.finish_reason)
            for i, out in enumerate(final.outputs)
        ]
        n_prompt = len(final.prompt_token_ids)
        n_gen = sum(len(o.token_ids) for o in final.outputs)
        resp = ChatCompletionResponse(
            id=request_id, model=req.model, choices=choices,
            usage=UsageInfo(prompt_tokens=n_prompt,
                            completion_tokens=n_gen,
                            total_tokens=n_prompt + n_gen))
        return web.json_response(resp.model_dump())

    async def _stream_chat(self, request, req, sampling_params, prompt,
                           request_id, emitted=None) -> web.StreamResponse:
        # Admit before the SSE prelude so sheds are real 429s.
        try:
            stream = await self.engine.add_request(
                request_id, prompt, sampling_params,
                emitted_token_ids=emitted)
        except RequestRejectedError as e:
            return _overloaded(e)
        except EngineDrainingError as e:
            return _draining(e)
        journal = stream_journal(request,
                                 resumed_tokens=len(emitted or ()))
        response = _sse_response()
        await response.prepare(request)
        if not emitted:
            # A continuation splices into a stream whose client
            # already received the role prelude — never re-send it.
            first = ChatCompletionStreamResponse(
                id=request_id, model=req.model,
                choices=[ChatCompletionResponseStreamChoice(
                    index=0,
                    delta=DeltaMessage(role=self.response_role))])
            await _sse_send(response, first.model_dump(exclude_unset=True))
        previous_texts = {}
        try:
            async for output in stream:
                if await request_disconnected(request):
                    stream.cancel()
                    return response
                for out in output.outputs:
                    prev = previous_texts.get(out.index)
                    if prev is None:
                        prev = output.resumed_text if emitted else ""
                    delta = out.text[len(prev):]
                    previous_texts[out.index] = out.text
                    if journal is not None and len(output.outputs) == 1:
                        await response.write(journal.record(
                            out.token_ids, out.finish_reason))
                    chunk = ChatCompletionStreamResponse(
                        id=request_id, model=req.model,
                        choices=[ChatCompletionResponseStreamChoice(
                            index=out.index,
                            delta=DeltaMessage(content=delta),
                            finish_reason=out.finish_reason)])
                    await _sse_send(response, chunk.model_dump())
            await _sse_done(response)
        except asyncio.CancelledError:
            stream.cancel()
            raise
        except RequestTimeoutError as e:
            await _sse_send(response, {"error": {
                "message": str(e), "type": "timeout_error"}})
            await response.write_eof()
        except EngineDrainingError as e:
            await _sse_send(response, {"error": {
                "message": str(e), "type": "draining_error"}})
            await response.write_eof()
        except Exception:
            stream.cancel()
            raise
        return response


# ---- SSE helpers ----

def _sse_response() -> web.StreamResponse:
    return web.StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "Connection": "keep-alive",
    })


async def _sse_send(response: web.StreamResponse, payload: dict) -> None:
    data = json.dumps(payload, separators=(",", ":"))
    await response.write(f"data: {data}\n\n".encode())


async def _sse_done(response: web.StreamResponse) -> None:
    await response.write(b"data: [DONE]\n\n")
    await response.write_eof()


# ---- CLI ----

def build_app(engine: AsyncAphrodite, served_model: str,
              **kwargs) -> web.Application:
    return OpenAIServer(engine, served_model, **kwargs).build_app()


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Aphrodite OpenAI-compatible API server (PyTorch port)")
    parser.add_argument("--host", type=str, default=None)
    parser.add_argument("--port", type=int, default=2242)
    parser.add_argument("--served-model-name", type=str, default=None)
    parser.add_argument("--chat-template", type=str, default=None)
    parser.add_argument("--response-role", type=str, default="assistant")
    parser.add_argument("--api-keys", type=str, default=None,
                        help="comma-separated accepted API keys")
    parser.add_argument("--admin-key", type=str, default=None,
                        help="comma-separated keys accepted by the "
                             "POST /admin/drain lifecycle endpoint "
                             "(unset = endpoint disabled; SIGTERM "
                             "drain works regardless)")
    parser = AsyncEngineArgs.add_cli_args(parser)
    args = parser.parse_args()

    engine_args = AsyncEngineArgs.from_cli_args(args)
    engine = AsyncAphrodite.from_engine_args(engine_args)
    served_model = args.served_model_name or args.model
    chat_template = None
    if args.chat_template:
        with open(args.chat_template) as f:
            chat_template = f.read()
    app = build_app(
        engine, served_model,
        response_role=args.response_role,
        chat_template=chat_template,
        api_keys=args.api_keys.split(",") if args.api_keys else None,
        admin_keys=args.admin_key.split(",") if args.admin_key
        else None)
    logger.info("Starting OpenAI-compatible server on %s:%d",
                args.host or "0.0.0.0", args.port)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
