"""Mixtral MoE in PyTorch.

Port of `aphrodite_tpu/modeling/models/mixtral.py`: Llama attention
(`LlamaAttention`) and, in every layer, a FusedMoE FFN with top-k
softmax routing, renormalized, over the `model.layers.N.block_sparse_moe`
bucket (router `gate`, stacks `w_gate` / `w_up` / `w_down` in
`layers/fused_moe.py`'s [E, out, in] layout). Everything else is the
Llama model's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from aphrodite_tpu_torch.modeling.layers.fused_moe import FusedMoE
from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM

Params = Dict[str, Dict[str, torch.Tensor]]


class MixtralMoE:
    """A layer's FFN: FusedMoE over its `block_sparse_moe` bucket."""

    def __init__(self, config, layer_prefix: str, dtype) -> None:
        self.key = f"{layer_prefix}.block_sparse_moe"
        self.moe = FusedMoE(
            num_experts=config.num_local_experts,
            top_k=config.num_experts_per_tok,
            hidden_size=config.hidden_size,
            intermediate_size=config.intermediate_size,
            renormalize=True, dtype=dtype)

    def linears(self) -> Dict[str, object]:
        return {}

    def init(self, device) -> Params:
        return {self.key: self.moe.init(device)}

    def __call__(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return self.moe(params[self.key], hidden)


class MixtralForCausalLM(LlamaForCausalLM):

    # HF expert tensor name -> stacked param (Mixtral's w1 = gate, w3 =
    # up, w2 = down).
    _EXPERT_MAP = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}

    def _make_mlp(self, config, layer_idx: int, dtype, linear_method):
        return MixtralMoE(config, f"model.layers.{layer_idx}", dtype)

    def _load_other(self, bucket, name: str, tensor: torch.Tensor
                    ) -> Optional[str]:
        if ".block_sparse_moe." not in name:
            return name
        layer_prefix, rest = name.split(".block_sparse_moe.")
        moe = self.layers[int(layer_prefix.rsplit(".", 1)[1])].mlp.moe
        params = bucket(f"{layer_prefix}.block_sparse_moe")
        if rest == "gate.weight":
            moe.load_gate_weight(params, tensor)
        else:                                   # experts.<id>.w{1,2,3}.weight
            _, expert_id, which, _ = rest.split(".")
            moe.load_expert_weight(params, self._EXPERT_MAP[which],
                                   int(expert_id), tensor)
        return None
