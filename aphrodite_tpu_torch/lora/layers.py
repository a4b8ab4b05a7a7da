"""LoRA-augmented linear execution (port of `aphrodite_tpu/lora/layers.py`).

`LoRALinearMethod` wraps any base `LinearMethod`, the quantized ones
included. A wrapped layer's bucket carries the adapters of every slot,
and when the step's per-row slots are injected (`LORA_IDX`) the forward
computes the JAX package's function

    y = base(x) + ((x @ A[idx]) @ B[idx]) * active

(alpha / rank folded into B when an adapter is loaded; a row whose idx
is -1 or out of range gets the base output only). Merged layers (qkv,
gate_up) carry one block-diagonal LoRA of rank packed_factor * max_rank.

The JAX package gathers each row's A and B (`jnp.take`), a per-row copy
of [in, rank] per layer call. Here the slots are concatenated instead,
A as [slots * R, in] and B as [out, slots * R] (torch's [out, in]
layout), and one product over every slot is masked to the row's own:

    h = x @ A_cat^T            [rows, slots * R]
    h = h * mask               the row's slot's R columns kept, others 0
    y = y + h @ B_cat^T        (one addmm)

which is the same function: the masked columns add exact zeros. Three
torch calls a projection, no per-row copy; the mask ([rows, 1, slots,
1] in the activations' dtype) is built once a step by the runner
(`LORA_MASK`), or here from `LORA_IDX` when absent. A bucket without
injected slots (LoRA off, or no row of the step has an adapter) gets
the base output untouched.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod, ParamDict

LORA_A = "lora_A_stacked"       # [slots * R, in]
LORA_B = "lora_B_stacked"       # [out, slots * R]
LORA_IDX = "lora_indices"       # [rows] int32 slot a row, -1 = none
LORA_MASK = "lora_mask"         # [rows, 1, slots, 1], activations' dtype


def slot_mask(idx: torch.Tensor, slots: int,
              dtype: torch.dtype) -> torch.Tensor:
    """[rows, 1, slots, 1] one-hot of each row's slot; a row whose idx is
    -1 or out of range matches no slot."""
    arange = torch.arange(slots, device=idx.device, dtype=idx.dtype)
    return (idx[:, None] == arange).to(dtype)[:, None, :, None]


class LoRALinearMethod(LinearMethod):
    """Base method + slot-stacked LoRA delta."""

    def __init__(self, base: LinearMethod, max_loras: int,
                 max_rank: int) -> None:
        self.base = base
        self.max_loras = max_loras
        self.max_rank = max_rank
        self.pending_rename: Optional[str] = None
        self.pending_sidecar: Optional[ParamDict] = None

    def create_weights(self, in_features: int, out_features: int,
                       dtype: torch.dtype, bias: bool,
                       device: torch.device) -> ParamDict:
        packed = getattr(self, "packed_factor", 1)
        self.base.packed_factor = packed
        params = self.base.create_weights(in_features, out_features,
                                          dtype, bias, device)
        rank = self.max_rank * packed
        params[LORA_A] = torch.zeros((self.max_loras * rank, in_features),
                                     dtype=dtype, device=device)
        params[LORA_B] = torch.zeros((out_features, self.max_loras * rank),
                                     dtype=dtype, device=device)
        return params

    def apply(self, params: ParamDict, x: torch.Tensor) -> torch.Tensor:
        y = self.base.apply(params, x)
        if LORA_A not in params or LORA_IDX not in params:
            return y
        mask = params.get(LORA_MASK)
        if mask is None:
            mask = slot_mask(params[LORA_IDX], self.max_loras, x.dtype)
        a, b = params[LORA_A], params[LORA_B]
        h = F.linear(x, a)                           # [rows, seq, S * R]
        h = (h.unflatten(-1, (self.max_loras, -1)) * mask).flatten(-2)
        out = y.shape[-1]
        return torch.addmm(y.reshape(-1, out), h.reshape(-1, h.shape[-1]),
                           b.t()).view(y.shape)

    def load_weight(self, params: ParamDict, name: str,
                    hf_tensor) -> torch.Tensor:
        converted = self.base.load_weight(params, name, hf_tensor)
        # Forward what the base leaves for the layer's loader: a rename
        # and derived tensors (GGUF's repacked blocks and scales).
        self.pending_rename = getattr(self.base, "pending_rename", None)
        self.pending_sidecar = getattr(self.base, "pending_sidecar", None)
        self.base.pending_rename = None
        self.base.pending_sidecar = None
        return converted

    def out_scale(self, name: str) -> int:
        return self.base.out_scale(name)
