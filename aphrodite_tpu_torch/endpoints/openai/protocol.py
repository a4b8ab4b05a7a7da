"""OpenAI-compatible API protocol models.

Reference: `aphrodite/endpoints/openai/protocol.py` (request models with
every custom sampler field `:55-137`, response models below). Field
surface is kept identical so existing clients work unchanged.
"""
from __future__ import annotations

import time
from typing import Dict, List, Literal, Optional, Union

from pydantic import BaseModel, Field

from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.utils import random_uuid


class ErrorResponse(BaseModel):
    object: str = "error"
    message: str
    type: str
    param: Optional[str] = None
    code: Optional[str] = None


class ModelPermission(BaseModel):
    id: str = Field(default_factory=lambda: f"modelperm-{random_uuid()}")
    object: str = "model_permission"
    created: int = Field(default_factory=lambda: int(time.time()))
    allow_create_engine: bool = False
    allow_sampling: bool = True
    allow_logprobs: bool = True
    allow_search_indices: bool = False
    allow_view: bool = True
    allow_fine_tuning: bool = False
    organization: str = "*"
    group: Optional[str] = None
    is_blocking: bool = False


class ModelCard(BaseModel):
    id: str
    object: str = "model"
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = "aphrodite-tpu"
    root: Optional[str] = None
    parent: Optional[str] = None
    permission: List[ModelPermission] = Field(default_factory=list)


class ModelList(BaseModel):
    object: str = "list"
    data: List[ModelCard] = Field(default_factory=list)


class UsageInfo(BaseModel):
    prompt_tokens: int = 0
    total_tokens: int = 0
    completion_tokens: Optional[int] = 0


class _SamplerFields(BaseModel):
    """Shared sampler knobs (reference protocol.py:55-137)."""
    temperature: Optional[float] = 1.0
    top_p: Optional[float] = 1.0
    top_k: Optional[int] = -1
    top_a: Optional[float] = 0.0
    min_p: Optional[float] = 0.0
    tfs: Optional[float] = 1.0
    eta_cutoff: Optional[float] = 0.0
    epsilon_cutoff: Optional[float] = 0.0
    typical_p: Optional[float] = 1.0
    mirostat_mode: Optional[int] = 0
    mirostat_tau: Optional[float] = 0.0
    mirostat_eta: Optional[float] = 0.0
    dynatemp_range: Optional[float] = 0.0
    dynatemp_exponent: Optional[float] = 1.0
    smoothing_factor: Optional[float] = 0.0
    presence_penalty: Optional[float] = 0.0
    frequency_penalty: Optional[float] = 0.0
    repetition_penalty: Optional[float] = 1.0
    ignore_eos: Optional[bool] = False
    use_beam_search: Optional[bool] = False
    length_penalty: Optional[float] = 1.0
    early_stopping: Optional[bool] = False
    stop: Optional[Union[str, List[str]]] = Field(default_factory=list)
    stop_token_ids: Optional[List[int]] = Field(default_factory=list)
    include_stop_str_in_output: Optional[bool] = False
    custom_token_bans: Optional[List[int]] = Field(default_factory=list)
    skip_special_tokens: Optional[bool] = True
    spaces_between_special_tokens: Optional[bool] = True
    logit_bias: Optional[Dict[str, float]] = None
    seed: Optional[int] = None
    # Aphrodite extension: per-request TTFT deadline (seconds).
    # Admission sheds the request with HTTP 429 + Retry-After when its
    # predicted TTFT already exceeds this; a queued request past its
    # deadline expires with a timeout error. Default:
    # APHRODITE_DEFAULT_TTFT_SLO_S.
    ttft_slo_s: Optional[float] = None
    n: Optional[int] = 1
    best_of: Optional[int] = None
    logprobs: Optional[int] = None
    prompt_logprobs: Optional[int] = None
    stream: Optional[bool] = False
    user: Optional[str] = None

    def to_sampling_params(self, max_tokens: Optional[int],
                           logits_processors=None) -> SamplingParams:
        return SamplingParams(
            n=self.n,
            best_of=self.best_of,
            presence_penalty=self.presence_penalty,
            frequency_penalty=self.frequency_penalty,
            repetition_penalty=self.repetition_penalty,
            temperature=self.temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            top_a=self.top_a,
            min_p=self.min_p,
            tfs=self.tfs,
            eta_cutoff=self.eta_cutoff,
            epsilon_cutoff=self.epsilon_cutoff,
            typical_p=self.typical_p,
            mirostat_mode=self.mirostat_mode,
            mirostat_tau=self.mirostat_tau,
            mirostat_eta=self.mirostat_eta,
            dynatemp_range=self.dynatemp_range,
            dynatemp_exponent=self.dynatemp_exponent,
            smoothing_factor=self.smoothing_factor,
            ignore_eos=self.ignore_eos,
            use_beam_search=self.use_beam_search,
            length_penalty=self.length_penalty,
            early_stopping=self.early_stopping,
            stop=self.stop,
            stop_token_ids=self.stop_token_ids,
            include_stop_str_in_output=self.include_stop_str_in_output,
            custom_token_bans=self.custom_token_bans,
            skip_special_tokens=self.skip_special_tokens,
            spaces_between_special_tokens=
            self.spaces_between_special_tokens,
            max_tokens=max_tokens,
            logprobs=self.logprobs,
            prompt_logprobs=self.prompt_logprobs,
            seed=self.seed,
            ttft_slo_s=self.ttft_slo_s,
            logits_processors=logits_processors,
        )


class ChatCompletionRequest(_SamplerFields):
    model: str
    messages: Union[str, List[Dict[str, str]]]
    max_tokens: Optional[int] = None
    add_generation_prompt: Optional[bool] = True
    echo: Optional[bool] = False
    temperature: Optional[float] = 0.7
    grammar: Optional[str] = None
    # Aphrodite extension (router-internal, admin-key-gated): resume a
    # journaled stream mid-generation on this replica. See
    # endpoints/utils.resume_token_ids for the shape.
    aphrodite_resume: Optional[Dict[str, object]] = None


class CompletionRequest(_SamplerFields):
    model: str
    # a string, array of strings, array of tokens, or array of token arrays
    prompt: Union[List[int], List[List[int]], str, List[str]]
    suffix: Optional[str] = None
    max_tokens: Optional[int] = 16
    echo: Optional[bool] = False
    grammar: Optional[str] = None
    # Aphrodite extension (router-internal, admin-key-gated): resume a
    # journaled stream mid-generation on this replica.
    aphrodite_resume: Optional[Dict[str, object]] = None


class LogProbs(BaseModel):
    text_offset: List[int] = Field(default_factory=list)
    token_logprobs: List[Optional[float]] = Field(default_factory=list)
    tokens: List[str] = Field(default_factory=list)
    top_logprobs: Optional[List[Optional[Dict[str, float]]]] = None


class CompletionResponseChoice(BaseModel):
    index: int
    text: str
    logprobs: Optional[LogProbs] = None
    finish_reason: Optional[Literal["stop", "length"]] = None


class CompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: f"cmpl-{random_uuid()}")
    object: str = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str
    choices: List[CompletionResponseChoice]
    usage: UsageInfo


class CompletionResponseStreamChoice(BaseModel):
    index: int
    text: str
    logprobs: Optional[LogProbs] = None
    finish_reason: Optional[Literal["stop", "length"]] = None


class CompletionStreamResponse(BaseModel):
    id: str = Field(default_factory=lambda: f"cmpl-{random_uuid()}")
    object: str = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str
    choices: List[CompletionResponseStreamChoice]
    usage: Optional[UsageInfo] = Field(default=None)


class ChatMessage(BaseModel):
    role: str
    content: str


class ChatCompletionResponseChoice(BaseModel):
    index: int
    message: ChatMessage
    finish_reason: Optional[Literal["stop", "length"]] = None


class ChatCompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: f"chatcmpl-{random_uuid()}")
    object: str = "chat.completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str
    choices: List[ChatCompletionResponseChoice]
    usage: UsageInfo


class DeltaMessage(BaseModel):
    role: Optional[str] = None
    content: Optional[str] = None


class ChatCompletionResponseStreamChoice(BaseModel):
    index: int
    delta: DeltaMessage
    finish_reason: Optional[Literal["stop", "length"]] = None


class ChatCompletionStreamResponse(BaseModel):
    id: str = Field(default_factory=lambda: f"chatcmpl-{random_uuid()}")
    object: str = "chat.completion.chunk"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str
    choices: List[ChatCompletionResponseStreamChoice]
    usage: Optional[UsageInfo] = Field(default=None)


class TokenizeRequest(BaseModel):
    prompt: str


class TokenizeResponse(BaseModel):
    tokens: List[int]
    count: int
    max_model_len: int
