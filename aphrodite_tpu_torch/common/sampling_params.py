"""Sampling parameters for text generation.

Same knob surface as the reference's `SamplingParams`
(`aphrodite/common/sampling_params.py:22-358`): the OpenAI-compatible core
plus the extended creative-writing sampler suite (top-a, min-p, tail-free,
eta/epsilon cutoffs, typical-p, mirostat v2, dynamic temperature, quadratic
smoothing, custom token bans). Implemented as a dataclass; validation
mirrors the reference's `_verify_args`/`_verify_beam_search`/
`_verify_greedy_sampling` semantics.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from enum import IntEnum
from functools import cached_property
from typing import Any, Callable, List, Optional, Union

_SAMPLING_EPS = 1e-5

# Called with (generated_token_ids, logits) -> adjusted logits. Logits are a
# host-side numpy/jax array; processors run on host between device steps.
LogitsProcessorFunc = Callable[[List[int], Any], Any]


class SamplingType(IntEnum):
    GREEDY = 0
    RANDOM = 1
    BEAM = 2


@dataclass
class SamplingParams:
    """Sampling parameters for one request.

    Follows the OpenAI completions API where applicable, extended with the
    additional samplers the reference supports. Defaults match the reference
    (`sampling_params.py:122-158`).
    """

    n: int = 1
    best_of: Optional[int] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    top_a: float = 0.0
    min_p: float = 0.0
    tfs: float = 1.0
    eta_cutoff: float = 0.0
    epsilon_cutoff: float = 0.0
    typical_p: float = 1.0
    mirostat_mode: int = 0
    mirostat_tau: float = 0.0
    mirostat_eta: float = 0.0
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    smoothing_factor: float = 0.0
    use_beam_search: bool = False
    length_penalty: float = 1.0
    early_stopping: Union[bool, str] = False
    stop: Union[None, str, List[str]] = None
    stop_token_ids: Optional[List[int]] = None
    include_stop_str_in_output: bool = False
    ignore_eos: bool = False
    max_tokens: Optional[int] = 16
    logprobs: Optional[int] = None
    prompt_logprobs: Optional[int] = None
    custom_token_bans: Optional[List[int]] = None
    skip_special_tokens: bool = True
    spaces_between_special_tokens: bool = True
    logits_processors: Optional[List[LogitsProcessorFunc]] = None
    seed: Optional[int] = None
    # TTFT service-level objective in seconds (None = the
    # APHRODITE_DEFAULT_TTFT_SLO_S default): admission sheds requests
    # whose predicted TTFT already exceeds it, and the scheduler
    # expires deadline-missed requests still sitting in `waiting`.
    ttft_slo_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.best_of is None:
            self.best_of = self.n
        if self.stop is None:
            self.stop = []
        elif isinstance(self.stop, str):
            self.stop = [self.stop]
        else:
            self.stop = list(self.stop)
        if self.stop_token_ids is None:
            self.stop_token_ids = []
        else:
            self.stop_token_ids = list(self.stop_token_ids)
        if self.custom_token_bans is None:
            self.custom_token_bans = []
        self._verify_args()
        if self.use_beam_search:
            self._verify_beam_search()
        else:
            self._verify_non_beam_search()
            if self.temperature < _SAMPLING_EPS:
                # Zero temperature means greedy: truncation filters collapse.
                self.top_p = 1.0
                self.top_k = -1
                self.min_p = 0.0
                self.top_a = 0.0
                self._verify_greedy_sampling()

    def _verify_args(self) -> None:
        if self.n < 1:
            raise ValueError(f"n must be at least 1, got {self.n}.")
        if self.best_of < self.n:
            raise ValueError(
                f"best_of must be greater than or equal to n, got n={self.n} "
                f"and best_of={self.best_of}.")
        if not -2.0 <= self.presence_penalty <= 2.0:
            raise ValueError("presence_penalty must be in [-2, 2], got "
                             f"{self.presence_penalty}.")
        if not -2.0 <= self.frequency_penalty <= 2.0:
            raise ValueError("frequency_penalty must be in [-2, 2], got "
                             f"{self.frequency_penalty}.")
        if self.repetition_penalty < 1.0:
            raise ValueError("repetition_penalty must be in [1, inf), got "
                             f"{self.repetition_penalty}.")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be non-negative, got {self.temperature}.")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}.")
        if self.top_k < -1 or self.top_k == 0:
            raise ValueError(f"top_k must be -1 (disable), or at least 1, "
                             f"got {self.top_k}.")
        if self.top_a < 0:
            raise ValueError(f"top_a must be non negative, got {self.top_a}.")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {self.min_p}.")
        if not 0.0 < self.tfs <= 1.0:
            raise ValueError(f"tfs must be in (0, 1], got {self.tfs}.")
        if self.epsilon_cutoff < 0.0 or self.epsilon_cutoff > 1000.0:
            raise ValueError("epsilon_cutoff must be in [0, 1000], got "
                             f"{self.epsilon_cutoff}.")
        if self.eta_cutoff < 0.0 or self.eta_cutoff > 1000.0:
            raise ValueError(
                f"eta_cutoff must be in [0, 1000], got {self.eta_cutoff}.")
        if not 0.0 < self.typical_p <= 1.0:
            raise ValueError(
                f"typical_p must be in (0, 1], got {self.typical_p}.")
        if self.mirostat_mode not in (0, 2):
            raise ValueError("Only Mirostat v2 (mode=2) is supported, got "
                             f"mode {self.mirostat_mode}.")
        if self.mirostat_tau < 0:
            raise ValueError(
                f"mirostat_tau must be non-negative, got {self.mirostat_tau}.")
        if self.mirostat_eta < 0:
            raise ValueError(
                f"mirostat_eta must be non-negative, got {self.mirostat_eta}.")
        if self.dynatemp_range < 0:
            raise ValueError("dynatemp_range must be non-negative, got "
                             f"{self.dynatemp_range}.")
        if self.dynatemp_exponent < 0:
            raise ValueError("dynatemp_exponent must be non-negative, got "
                             f"{self.dynatemp_exponent}.")
        if self.smoothing_factor < 0:
            raise ValueError("smoothing_factor must be non-negative, got "
                             f"{self.smoothing_factor}.")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(
                f"max_tokens must be at least 1, got {self.max_tokens}.")
        if self.logprobs is not None and self.logprobs < 0:
            raise ValueError(
                f"logprobs must be non-negative, got {self.logprobs}.")
        if self.prompt_logprobs is not None and self.prompt_logprobs < 0:
            raise ValueError("prompt_logprobs must be non-negative, got "
                             f"{self.prompt_logprobs}.")
        if self.ttft_slo_s is not None and self.ttft_slo_s <= 0:
            raise ValueError(
                f"ttft_slo_s must be positive, got {self.ttft_slo_s}.")

    def _verify_beam_search(self) -> None:
        if self.best_of == 1:
            raise ValueError("best_of must be greater than 1 when using beam "
                             f"search. Got {self.best_of}.")
        if self.temperature > _SAMPLING_EPS:
            raise ValueError("temperature must be 0 when using beam search.")
        if self.top_p < 1.0 - _SAMPLING_EPS:
            raise ValueError("top_p must be 1 when using beam search.")
        if self.top_k != -1:
            raise ValueError("top_k must be -1 when using beam search.")
        if self.early_stopping not in (True, False, "never"):
            raise ValueError(
                "early_stopping must be True, False, or 'never', got "
                f"{self.early_stopping}.")

    def _verify_non_beam_search(self) -> None:
        if self.early_stopping is not False:
            raise ValueError("early_stopping is not effective and must be "
                             "False when not using beam search.")
        if (self.length_penalty < 1.0 - _SAMPLING_EPS
                or self.length_penalty > 1.0 + _SAMPLING_EPS):
            raise ValueError(
                "length_penalty is not effective and must be the "
                "default value of 1.0 when not using beam search.")

    def _verify_greedy_sampling(self) -> None:
        if self.best_of > 1:
            raise ValueError("best_of must be 1 when using greedy sampling, "
                             f"got {self.best_of}.")

    @cached_property
    def sampling_type(self) -> SamplingType:
        if self.use_beam_search:
            return SamplingType.BEAM
        if self.temperature < _SAMPLING_EPS:
            return SamplingType.GREEDY
        return SamplingType.RANDOM

    def clone(self) -> "SamplingParams":
        return copy.deepcopy(self)
