"""int8 weight-only quantization at load time, PyTorch port of
`aphrodite_tpu/modeling/layers/quantization/int8.py`.

Any float checkpoint is quantized as it loads: per output channel, the
absmax over 127 as an f32 scale (1 for an all-zero channel) and
round-half-to-even codes clipped to [-128, 127], stored [in, out] int8
with `scales` [out] beside it (handed to the linear loaders through
`pending_sidecar`, so merged layers place them with the same output
offsets). Every matmul goes through K17 (`ops/cuda/quant_matmul.
int8_matmul`; its plain version for CPU tensors) where its gate takes
the layer's shape and, on the card, the activations are bfloat16; the
other layers take the JAX package's XLA route, (x @ W in x's dtype) *
scales in x's dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
from aphrodite_tpu_torch.modeling.layers.quantization.base_config import (
    QuantizationConfig, kernel_takes_dtype)
from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm


class Int8Config(QuantizationConfig):

    @classmethod
    def get_name(cls) -> str:
        return "int8"

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "Int8Config":
        return cls()

    def get_linear_method(self) -> "Int8LinearMethod":
        return Int8LinearMethod(self)


class Int8LinearMethod(LinearMethod):

    def __init__(self, config: Int8Config) -> None:
        self.config = config
        self.pending_sidecar = None

    def create_weights(self, in_features: int, out_features: int,
                       dtype: torch.dtype, bias: bool,
                       device: torch.device) -> Dict[str, torch.Tensor]:
        params = {
            "weight": torch.empty((in_features, out_features),
                                  dtype=torch.int8, device=device),
            "scales": torch.empty((out_features,), dtype=torch.float32,
                                  device=device),
        }
        if bias:
            params["bias"] = torch.empty((out_features,), dtype=dtype,
                                         device=device)
        return params

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        w = params["weight"]
        in_features, out_features = w.shape
        if qmm.int8_supported(in_features, out_features) and \
                kernel_takes_dtype(x):
            lead = x.shape[:-1]
            # A real load casts the scales to the model dtype, as the JAX
            # package's loader does; K17 takes them in f32.
            y = qmm.int8_matmul(x.reshape(-1, in_features).contiguous(), w,
                                params["scales"].float())
            y = y.reshape(*lead, out_features)
        else:
            y = (x @ w.to(x.dtype)) * params["scales"].to(x.dtype)
        if "bias" in params:
            y = y + params["bias"]
        return y

    def load_weight(self, params, name: str, hf_tensor) -> torch.Tensor:
        """A float checkpoint weight [out, in] -> int8 [in, out], its
        scales left in `pending_sidecar` (the JAX package's arithmetic,
        in numpy)."""
        if name != "weight":
            return hf_tensor
        w = np.ascontiguousarray(
            hf_tensor.float().numpy().T).astype(np.float32)
        scales = np.abs(w).max(axis=0) / 127.0
        scales = np.where(scales == 0, 1.0, scales)
        q = np.clip(np.round(w / scales), -128, 127).astype(np.int8)
        self.pending_sidecar = {
            "scales": torch.from_numpy(scales.astype(np.float32))}
        return torch.from_numpy(q)

    def out_scale(self, name: str) -> int:
        return 1
