"""Abstract quantization config (port of
`aphrodite_tpu/modeling/layers/quantization/base_config.py`)."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List

import torch

from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod


def kernel_takes_dtype(x: torch.Tensor,
                       dtypes=(torch.bfloat16,)) -> bool:
    """Whether a quantized kernel that takes activations in `dtypes`
    serves `x`: on the CPU always (the wrappers run their plain versions
    in any dtype), elsewhere only in those dtypes. A layer it does not
    serve takes the dequantize-then-matmul route in x's dtype, as the
    JAX package does off the TPU."""
    return x.device.type == "cpu" or x.dtype in dtypes


class QuantizationConfig(ABC):

    @classmethod
    @abstractmethod
    def get_name(cls) -> str:
        ...

    @classmethod
    @abstractmethod
    def from_config(cls, config: Dict[str, Any]) -> "QuantizationConfig":
        ...

    @classmethod
    def default(cls) -> "QuantizationConfig":
        return cls.from_config({})

    @abstractmethod
    def get_linear_method(self) -> LinearMethod:
        ...

    @staticmethod
    def get_from_keys(config: Dict[str, Any], keys: List[str],
                      default=None):
        for key in keys:
            if key in config:
                return config[key]
        if default is not None:
            return default
        raise ValueError(f"Cannot find any of {keys} in the model's "
                         "quantization config.")
