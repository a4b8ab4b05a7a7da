"""Qwen2 in PyTorch (port of `aphrodite_tpu/modeling/models/qwen2.py`):
the Llama architecture with biased q/k/v projections (no o_proj bias)
and, for the small checkpoints, tied embeddings.

Its window follows the config as the JAX package reads it: HF's
Qwen2Config keeps `sliding_window` only under `use_sliding_window`
(`transformers_utils/config.py`), so Qwen2-7B, whose file sets 131072
with `use_sliding_window: false`, serves without one."""
from __future__ import annotations

from typing import Optional

import torch

from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM


class Qwen2ForCausalLM(LlamaForCausalLM):

    def __init__(self, config, dtype: torch.dtype = torch.bfloat16,
                 linear_method: Optional[LinearMethod] = None) -> None:
        config.qkv_bias = True
        super().__init__(config, dtype=dtype, linear_method=linear_method)
