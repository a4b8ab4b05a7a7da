"""KoboldAI United API schema (port of
`aphrodite_tpu/endpoints/kobold/protocol.py`, copied).

Reference: `aphrodite/endpoints/kobold/protocol.py:5-93`
(KAIGenerationInputSchema with kobold field aliases: rep_pen, max_length,
typical, eps_cutoff...).
"""
from __future__ import annotations

from typing import List, Optional

from pydantic import BaseModel, Field, conint, confloat, model_validator


class KAIGenerationInputSchema(BaseModel):
    genkey: Optional[str] = None
    prompt: str
    n: Optional[conint(ge=1, le=5)] = 1
    max_context_length: conint(gt=0)
    max_length: conint(gt=0)
    rep_pen: Optional[confloat(ge=1)] = 1.0
    rep_pen_range: Optional[conint(ge=0)] = None
    rep_pen_slope: Optional[confloat(ge=0)] = None
    top_k: Optional[conint(ge=0)] = 0
    top_a: Optional[confloat(ge=0)] = 0.0
    top_p: Optional[confloat(ge=0, le=1)] = 1.0
    min_p: Optional[confloat(ge=0, le=1)] = 0.0
    tfs: Optional[confloat(ge=0, le=1)] = 1.0
    eps_cutoff: Optional[confloat(ge=0, le=1000)] = 0.0
    eta_cutoff: Optional[confloat(ge=0)] = 0.0
    typical: Optional[confloat(ge=0, le=1)] = 1.0
    temperature: Optional[confloat(ge=0)] = 1.0
    dynatemp_range: Optional[confloat(ge=0)] = 0.0
    dynatemp_exponent: Optional[confloat(ge=0)] = 1.0
    smoothing_factor: Optional[confloat(ge=0)] = 0.0
    use_memory: Optional[bool] = None
    use_story: Optional[bool] = None
    use_authors_note: Optional[bool] = None
    use_world_info: Optional[bool] = None
    use_userscripts: Optional[bool] = None
    soft_prompt: Optional[str] = None
    disable_output_formatting: Optional[bool] = None
    frmtrmblln: Optional[bool] = None
    frmtrmspch: Optional[bool] = None
    singleline: Optional[bool] = None
    use_default_badwordsids: Optional[bool] = None
    mirostat: Optional[int] = 0
    mirostat_tau: Optional[float] = 0.0
    mirostat_eta: Optional[float] = 0.0
    disable_input_formatting: Optional[bool] = None
    frmtadsnsp: Optional[bool] = None
    quiet: Optional[bool] = None
    sampler_order: Optional[List[int]] = None
    sampler_seed: Optional[conint(ge=0, le=2**64 - 1)] = None
    sampler_full_determinism: Optional[bool] = None
    stop_sequence: Optional[List[str]] = None
    include_stop_str_in_output: Optional[bool] = False

    @model_validator(mode="after")
    def check_context(self):
        if self.max_length > self.max_context_length:
            raise ValueError(
                "max_length must not be larger than max_context_length")
        return self
