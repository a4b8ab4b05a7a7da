"""AWQ weight-only int4 (llm-awq checkpoint format), PyTorch port of
`aphrodite_tpu/modeling/layers/quantization/awq.py`.

Checkpoint layout, kept as it is on the device:
  qweight [in, out/8]       int32, 8 codes along OUT, interleaved: column
                            8j + e at shift 4 * AWQ_ORDER[e]
  qzeros  [in/group, out/8] int32, packed the same way, zero as stored
  scales  [in/group, out]   in the model dtype (float16 checkpoints are
                            cast on load)
Dequant: w = (q - z) * s.

A layer whose shape `AWQConfig.supports` (the JAX package's
`awq_supported`: in % group == 0, groups of 128-1024 rows, out % 1024
== 0) goes through the CUDA kernels of `ops/cuda/quant_matmul.py`
(their plain versions for CPU tensors), on the card for bfloat16
activations only: `awq_matmul` (K7's AWQ layout at m <= 64, else K10)
or, under APHRODITE_W4A8=1, `awq_matmul_a8` (K9, then K7's AWQ a8 arm
or K11). Every other layer takes the JAX package's dequantize-then-
matmul route in x's dtype, whatever APHRODITE_W4A8 says (so one model,
Qwen2-7B among them, may run some projections on each route). AWQ has
no g_idx, so both routes compute the same weight.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
from aphrodite_tpu_torch.modeling.layers.quantization.base_config import (
    QuantizationConfig, kernel_takes_dtype)
from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm


class AWQConfig(QuantizationConfig):

    def __init__(self, weight_bits: int = 4, group_size: int = 128,
                 zero_point: bool = True) -> None:
        if weight_bits != 4:
            raise ValueError("AWQ supports 4-bit only, got "
                             f"{weight_bits}")
        self.weight_bits = weight_bits
        self.group_size = group_size
        self.zero_point = zero_point
        self.pack_factor = 32 // weight_bits

    @classmethod
    def get_name(cls) -> str:
        return "awq"

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "AWQConfig":
        return cls(
            weight_bits=cls.get_from_keys(config, ["w_bit", "bits"], 4),
            group_size=cls.get_from_keys(config,
                                         ["q_group_size", "group_size"],
                                         128),
            zero_point=cls.get_from_keys(config, ["zero_point"], True))

    def get_linear_method(self) -> "AWQLinearMethod":
        return AWQLinearMethod(self)

    def supports(self, in_features: int, out_features: int) -> bool:
        """Whether the kernels take a layer of this shape."""
        return qmm.awq_supported(in_features, out_features,
                                 self.group_size)


class AWQLinearMethod(LinearMethod):

    def __init__(self, config: AWQConfig) -> None:
        self.config = config

    def create_weights(self, in_features: int, out_features: int,
                       dtype: torch.dtype, bias: bool,
                       device: torch.device) -> Dict[str, torch.Tensor]:
        cfg = self.config
        groups = max(1, in_features // cfg.group_size)
        params = {
            "qweight": torch.empty((in_features,
                                    out_features // cfg.pack_factor),
                                   dtype=torch.int32, device=device),
            "qzeros": torch.empty((groups, out_features // cfg.pack_factor),
                                  dtype=torch.int32, device=device),
            "scales": torch.empty((groups, out_features), dtype=dtype,
                                  device=device),
        }
        if bias:
            params["bias"] = torch.empty((out_features,), dtype=dtype,
                                         device=device)
        return params

    def dequantize(self, params: Dict[str, torch.Tensor],
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The weight [in, out] in `dtype`, as the JAX package's
        `dequantize` (a plain helper: no kernel): row k in group
        k // group_size."""
        q = qmm.unpack_awq(params["qweight"])
        z = qmm.unpack_awq(params["qzeros"])
        g = torch.arange(q.shape[0], device=q.device) // \
            self.config.group_size
        w = q.sub_(z[g]).float().mul_(params["scales"].float()[g])
        return w.to(dtype)

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        qw = params["qweight"]
        in_features, n_packed = qw.shape
        out_features = n_packed * self.config.pack_factor
        if self.uses_kernels(params, x):
            lead = x.shape[:-1]
            # APHRODITE_W4A8=1: int8 activations (the JAX bench's
            # default); AWQ is always 4-bit. Read per call.
            mm = qmm.awq_matmul_a8 if flags.get_bool("APHRODITE_W4A8") \
                else qmm.awq_matmul
            y = mm(x.reshape(-1, in_features).contiguous(), qw,
                   params["qzeros"], params["scales"],
                   group_size=self.config.group_size)
            y = y.reshape(*lead, out_features)
        else:
            y = x @ self.dequantize(params, x.dtype)
        if "bias" in params:
            y = y + params["bias"]
        return y

    def uses_kernels(self, params: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> bool:
        """The JAX package's route: the kernels serve a layer whose shape
        `AWQConfig.supports`; on the card only for bfloat16
        activations."""
        in_features, n_packed = params["qweight"].shape
        return self.config.supports(
            in_features, n_packed * self.config.pack_factor) and \
            kernel_takes_dtype(x)

    def load_weight(self, params, name: str,
                    hf_tensor: torch.Tensor) -> torch.Tensor:
        return hf_tensor

    def out_scale(self, name: str) -> int:
        """Divisor on output-dim offsets for merged-layer placement."""
        return self.config.pack_factor if name in ("qweight",
                                                   "qzeros") else 1
