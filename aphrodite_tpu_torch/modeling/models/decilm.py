"""DeciLM in PyTorch (port of `aphrodite_tpu/modeling/models/decilm.py`):
Llama with a KV head count of its own in every layer
(`num_key_value_heads_per_layer`). The cache engine allocates each
layer's pages at its own row width (`executor/cache_engine.py`), and
each layer's attention, K1-K4 included, takes its own Hkv from them."""
from __future__ import annotations

import copy
from typing import Optional

import torch

from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
from aphrodite_tpu_torch.modeling.models.llama import (LlamaDecoderLayer,
                                                       LlamaForCausalLM,
                                                       LlamaMLP)


class DeciLMForCausalLM(LlamaForCausalLM):
    """Each decoder layer gets its own num_key_value_heads."""

    def __init__(self, config, dtype: torch.dtype = torch.bfloat16,
                 linear_method: Optional[LinearMethod] = None) -> None:
        kv_per_layer = list(config.num_key_value_heads_per_layer)
        # Built with a uniform config first, then each layer rebuilt
        # with its own kv-head count, as the JAX model does.
        config.num_key_value_heads = max(kv_per_layer)
        super().__init__(config, dtype=dtype, linear_method=linear_method)
        self.layers = []
        for i, kv_heads in enumerate(kv_per_layer):
            layer_config = copy.deepcopy(config)
            layer_config.num_key_value_heads = kv_heads
            self.layers.append(LlamaDecoderLayer(
                layer_config, i, dtype, linear_method,
                LlamaMLP(layer_config, f"model.layers.{i}", dtype,
                         linear_method)))
