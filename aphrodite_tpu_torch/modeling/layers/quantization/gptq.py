"""GPTQ weight-only int2/int4/int8 (AutoGPTQ checkpoint format), PyTorch
port of `aphrodite_tpu/modeling/layers/quantization/gptq.py`.

Checkpoint layout, kept as it is on the device:
  qweight [in/pack, out]  int32, pack = 32//bits codes along IN
  qzeros  [in/group, out/pack] int32, codes along OUT, stores z-1
  scales  [in/group, out] in the model dtype
  g_idx   [in] int32 group index per input row

Two routes, picked per layer and per call from the shape, the bits,
desc_act and the activation dtype alone, before anything launches (the
JAX package's `_use_pallas`):

- the CUDA kernels of `ops/cuda/quant_matmul.py` (their plain versions
  for CPU tensors) where `GPTQConfig.supports` holds (4 or 8 bits, no
  act-order, groups of 128-1024 rows dividing K, out % 128 == 0), on the
  card for bfloat16 activations only. Like the JAX package's Pallas
  kernels they take row k's group to be k // group_size and never read
  g_idx: real desc_act=False checkpoints store exactly that g_idx;
- everywhere else, and for every layer under
  APHRODITE_DISABLE_PALLAS_QUANT=1 (read per call), the JAX package's
  dequantize-then-matmul route: `dequantize` gathers scales[g_idx] and
  zeros[g_idx], so an act-order checkpoint's permuted group assignment
  is honoured; it uses x's dtype and no int8 activations, whatever
  APHRODITE_W4A8 says.

(The two routes agree only when g_idx == arange(in) // group_size,
which dummy weights, whose g_idx is zero, do not satisfy.)
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
from aphrodite_tpu_torch.modeling.layers.quantization.base_config import (
    QuantizationConfig, kernel_takes_dtype)
from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm


class GPTQConfig(QuantizationConfig):

    def __init__(self, weight_bits: int = 4, group_size: int = 128,
                 desc_act: bool = False) -> None:
        self.weight_bits = weight_bits
        self.group_size = group_size
        self.desc_act = desc_act
        if weight_bits not in (2, 4, 8):
            raise ValueError(
                f"GPTQ weight_bits must be 2/4/8, got {weight_bits}")
        self.pack_factor = 32 // weight_bits

    @classmethod
    def get_name(cls) -> str:
        return "gptq"

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "GPTQConfig":
        return cls(
            weight_bits=cls.get_from_keys(config, ["bits"], 4),
            group_size=cls.get_from_keys(config, ["group_size"], 128),
            desc_act=cls.get_from_keys(config, ["desc_act"], False))

    def get_linear_method(self) -> "GPTQLinearMethod":
        return GPTQLinearMethod(self)

    def supports(self, in_features: int, out_features: int) -> bool:
        """Whether the kernels take a layer of this shape."""
        return qmm.gptq_supported(in_features, out_features,
                                  self.weight_bits, self.group_size,
                                  self.desc_act)


class GPTQLinearMethod(LinearMethod):

    def __init__(self, config: GPTQConfig) -> None:
        self.config = config

    def create_weights(self, in_features: int, out_features: int,
                       dtype: torch.dtype, bias: bool,
                       device: torch.device) -> Dict[str, torch.Tensor]:
        cfg = self.config
        groups = max(1, in_features // cfg.group_size) \
            if cfg.group_size != -1 else 1
        params = {
            "qweight": torch.empty((in_features // cfg.pack_factor,
                                    out_features), dtype=torch.int32,
                                   device=device),
            "qzeros": torch.empty((groups, out_features // cfg.pack_factor),
                                  dtype=torch.int32, device=device),
            "scales": torch.empty((groups, out_features), dtype=dtype,
                                  device=device),
            "g_idx": torch.empty((in_features,), dtype=torch.int32,
                                 device=device),
        }
        if bias:
            params["bias"] = torch.empty((out_features,), dtype=dtype,
                                         device=device)
        return params

    def dequantize(self, params: Dict[str, torch.Tensor],
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The weight [in, out] in `dtype`, rows grouped by g_idx as the
        JAX package's `dequantize` does (a plain helper: no kernel)."""
        bits = self.config.weight_bits
        q = qmm.unpack_rows(params["qweight"], bits)
        z = qmm.unpack_cols(params["qzeros"], bits) + 1
        g = params["g_idx"].long()
        # (q - z[g]) in f32 times scales[g] in f32, in place: the same
        # values with two fewer [in, out] temporaries on the card.
        w = q.sub_(z[g]).float().mul_(params["scales"].float()[g])
        return w.to(dtype)

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        in_features = params["g_idx"].shape[0]
        out_features = params["scales"].shape[1]
        if self.uses_kernels(params, x):
            lead = x.shape[:-1]
            # APHRODITE_W4A8=1: int8 activations (the JAX bench's
            # default); 4-bit only, since 8-bit codes minus their zero
            # point overflow int8. Read per call.
            mm = qmm.gptq_matmul_a8 if (flags.get_bool("APHRODITE_W4A8")
                                        and cfg.weight_bits == 4) \
                else qmm.gptq_matmul
            y = mm(x.reshape(-1, in_features).contiguous(),
                   params["qweight"], params["qzeros"], params["scales"],
                   bits=cfg.weight_bits, group_size=cfg.group_size)
            y = y.reshape(*lead, out_features)
        else:
            y = x @ self.dequantize(params, x.dtype)
        if "bias" in params:
            y = y + params["bias"]
        return y

    def uses_kernels(self, params: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> bool:
        """The JAX package's `_use_pallas`: the kernels serve a layer
        their gate takes (which refuses act-order before any kernel could
        read rows in the wrong groups), unless
        APHRODITE_DISABLE_PALLAS_QUANT=1; on the card only for bfloat16
        activations."""
        return (not flags.get_bool("APHRODITE_DISABLE_PALLAS_QUANT") and
                self.config.supports(params["g_idx"].shape[0],
                                     params["scales"].shape[1]) and
                kernel_takes_dtype(x))

    def out_scale(self, name: str) -> int:
        """Divisor on output-dim offsets for merged-layer placement."""
        return self.config.pack_factor if name == "qzeros" else 1
