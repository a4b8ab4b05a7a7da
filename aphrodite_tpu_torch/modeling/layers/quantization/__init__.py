"""Quantization plug-in registry of the PyTorch port (port of
`aphrodite_tpu/modeling/layers/quantization/__init__.py`).

The six methods of the JAX package: GPTQ, AWQ, GGUF, SqueezeLLM, int8
and QuIP#.
"""
from __future__ import annotations

from typing import Type

from aphrodite_tpu_torch.modeling.layers.quantization.awq import AWQConfig
from aphrodite_tpu_torch.modeling.layers.quantization.base_config import (
    QuantizationConfig)
from aphrodite_tpu_torch.modeling.layers.quantization.gguf import GGUFConfig
from aphrodite_tpu_torch.modeling.layers.quantization.gptq import GPTQConfig
from aphrodite_tpu_torch.modeling.layers.quantization.int8 import Int8Config
from aphrodite_tpu_torch.modeling.layers.quantization.quip import QuipConfig
from aphrodite_tpu_torch.modeling.layers.quantization.squeezellm import (
    SqueezeLLMConfig)

_QUANTIZATION_CONFIG_REGISTRY = {
    "awq": AWQConfig,
    "gguf": GGUFConfig,
    "gptq": GPTQConfig,
    "squeezellm": SqueezeLLMConfig,
    "int8": Int8Config,
    "quip": QuipConfig,
}


def get_quantization_config_cls(name: str) -> Type[QuantizationConfig]:
    if name not in _QUANTIZATION_CONFIG_REGISTRY:
        raise ValueError(f"Invalid quantization method: {name}")
    return _QUANTIZATION_CONFIG_REGISTRY[name]


def get_quantization_config(model_config) -> QuantizationConfig:
    """Build the quant config from the HF quantization_config dict."""
    cls = get_quantization_config_cls(model_config.quantization)
    hf_quant_config = getattr(model_config.hf_config,
                              "quantization_config", None)
    if hf_quant_config is not None:
        return cls.from_config(dict(hf_quant_config))
    return cls.default()
