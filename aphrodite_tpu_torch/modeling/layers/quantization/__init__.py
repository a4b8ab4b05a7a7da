"""Quantization plug-in registry of the PyTorch port (port of
`aphrodite_tpu/modeling/layers/quantization/__init__.py`).

GPTQ, AWQ and GGUF are ported so far; the other methods of the JAX
package (squeezellm, int8, quip) are refused by `ModelConfig` before a
model is built.
"""
from __future__ import annotations

from typing import Type

from aphrodite_tpu_torch.modeling.layers.quantization.awq import AWQConfig
from aphrodite_tpu_torch.modeling.layers.quantization.base_config import (
    QuantizationConfig)
from aphrodite_tpu_torch.modeling.layers.quantization.gguf import GGUFConfig
from aphrodite_tpu_torch.modeling.layers.quantization.gptq import GPTQConfig

_QUANTIZATION_CONFIG_REGISTRY = {
    "awq": AWQConfig,
    "gguf": GGUFConfig,
    "gptq": GPTQConfig,
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
