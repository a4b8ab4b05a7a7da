"""SqueezeLLM 4-bit LUT (non-uniform) quantization, PyTorch port of
`aphrodite_tpu/modeling/layers/quantization/squeezellm.py`.

Checkpoint layout, kept as it is on the device:
  qweight       [in/8, out] int32 -- 8 nibbles along IN
  lookup_table  [out, 16] in the model dtype -- per-output-channel codebook

Dequant: w[i, j] = lookup_table[j, q[i, j]]. Every matmul goes through
K16 (`ops/cuda/quant_matmul.squeezellm_matmul`; its plain version for CPU
tensors, its bf16 or f32 decoders for bfloat16 or float32 activations on
the card) where its gate takes the layer's shape.
APHRODITE_DISABLE_PALLAS_QUANT=1 (read per call, as in the JAX package)
and a shape the gate refuses take the JAX package's dequantize-then-
matmul route in x's dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
from aphrodite_tpu_torch.modeling.layers.quantization.base_config import (
    QuantizationConfig, kernel_takes_dtype)
from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm


class SqueezeLLMConfig(QuantizationConfig):

    def __init__(self, weight_bits: int = 4) -> None:
        if weight_bits != 4:
            raise ValueError("SqueezeLLM supports 4-bit only, got "
                             f"{weight_bits}")
        self.weight_bits = weight_bits
        self.pack_factor = 32 // weight_bits

    @classmethod
    def get_name(cls) -> str:
        return "squeezellm"

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "SqueezeLLMConfig":
        return cls(weight_bits=cls.get_from_keys(config, ["wbits"], 4))

    def get_linear_method(self) -> "SqueezeLLMLinearMethod":
        return SqueezeLLMLinearMethod(self)


class SqueezeLLMLinearMethod(LinearMethod):

    def __init__(self, config: SqueezeLLMConfig) -> None:
        self.config = config

    def create_weights(self, in_features: int, out_features: int,
                       dtype: torch.dtype, bias: bool,
                       device: torch.device) -> Dict[str, torch.Tensor]:
        params = {
            "qweight": torch.empty(
                (in_features // self.config.pack_factor, out_features),
                dtype=torch.int32, device=device),
            "lookup_table": torch.empty((out_features, 16), dtype=dtype,
                                        device=device),
        }
        if bias:
            params["bias"] = torch.empty((out_features,), dtype=dtype,
                                         device=device)
        return params

    def dequantize(self, params: Dict[str, torch.Tensor],
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The weight [in, out] in `dtype` (the codebook gathered in f32,
        then rounded), as the JAX package's `dequantize`."""
        return qmm.squeezellm_dequantize_plain(
            params["qweight"], params["lookup_table"], dtype)

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        qweight = params["qweight"]
        in_features = qweight.shape[0] * self.config.pack_factor
        out_features = params["lookup_table"].shape[0]
        if flags.get_bool("APHRODITE_DISABLE_PALLAS_QUANT"):
            y = x @ self.dequantize(params, x.dtype)
        elif qmm.squeezellm_supported(in_features, out_features) and \
                kernel_takes_dtype(x, (torch.bfloat16, torch.float32)):
            lead = x.shape[:-1]
            y = qmm.squeezellm_matmul(
                x.reshape(-1, in_features).contiguous(), qweight,
                params["lookup_table"])
            y = y.reshape(*lead, out_features)
        else:
            y = x @ self.dequantize(params, x.dtype)
        if "bias" in params:
            y = y + params["bias"]
        return y

    def load_weight(self, params, name: str, hf_tensor) -> torch.Tensor:
        return hf_tensor

    def out_scale(self, name: str) -> int:
        return 1
