"""DeepSeek-MoE in PyTorch.

Port of `aphrodite_tpu/modeling/models/deepseek.py`: Llama attention and,
per layer, the JAX model's plan: a dense `LlamaMLP` up to
`first_k_dense_replace`, then a FusedMoE on every `moe_layer_freq`-th
layer (none without `n_routed_experts`), renormalized only under
`norm_topk_prob`, with the `n_shared_experts` shared experts as one
`LlamaMLP` of width `moe_intermediate_size * n_shared_experts` under
`model.layers.N.shared.mlp.*`, added to the routed output. The routed
experts live in the `model.layers.N.mlp_moe` bucket (`layers/
fused_moe.py`'s [E, out, in] layout).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from aphrodite_tpu_torch.modeling.layers.fused_moe import FusedMoE
from aphrodite_tpu_torch.modeling.models.llama import (LlamaForCausalLM,
                                                       LlamaMLP)

Params = Dict[str, Dict[str, torch.Tensor]]


class _MLPConfig:
    """The widths of the shared experts' `LlamaMLP`."""

    def __init__(self, hidden_size: int, intermediate_size: int) -> None:
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size


def is_moe_layer(config, layer_idx: int) -> bool:
    """The JAX model's layer plan (`models/deepseek.py:35-38`)."""
    return (getattr(config, "n_routed_experts", None) is not None
            and layer_idx >= config.first_k_dense_replace
            and layer_idx % config.moe_layer_freq == 0)


class DeepseekMoE:
    """A MoE layer's FFN: the routed experts plus the shared ones."""

    def __init__(self, config, layer_prefix: str, dtype,
                 linear_method) -> None:
        self.key = f"{layer_prefix}.mlp_moe"
        self.moe = FusedMoE(
            num_experts=config.n_routed_experts,
            top_k=config.num_experts_per_tok,
            hidden_size=config.hidden_size,
            intermediate_size=config.moe_intermediate_size,
            renormalize=getattr(config, "norm_topk_prob", False),
            dtype=dtype)
        n_shared = getattr(config, "n_shared_experts", 0) or 0
        self.shared = LlamaMLP(
            _MLPConfig(config.hidden_size,
                       config.moe_intermediate_size * n_shared),
            f"{layer_prefix}.shared", dtype, linear_method) \
            if n_shared else None

    def linears(self) -> Dict[str, object]:
        return self.shared.linears() if self.shared else {}

    def init(self, device) -> Params:
        params = {self.key: self.moe.init(device)}
        if self.shared:
            params.update(self.shared.init(device))
        return params

    def __call__(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        out = self.moe(params[self.key], hidden)
        if self.shared:
            out = out + self.shared(params, hidden)
        return out


class DeepseekForCausalLM(LlamaForCausalLM):

    _EXPERT_MAP = {"gate_proj": "w_gate", "up_proj": "w_up",
                   "down_proj": "w_down"}

    def _make_mlp(self, config, layer_idx: int, dtype, linear_method):
        prefix = f"model.layers.{layer_idx}"
        if is_moe_layer(config, layer_idx):
            return DeepseekMoE(config, prefix, dtype, linear_method)
        return LlamaMLP(config, prefix, dtype, linear_method)

    def _moe(self, layer_prefix: str) -> FusedMoE:
        return self.layers[int(layer_prefix.rsplit(".", 1)[1])].mlp.moe

    def _load_other(self, bucket, name: str, tensor: torch.Tensor
                    ) -> Optional[str]:
        if ".mlp.experts." in name:      # experts.<id>.{gate,up,down}_proj
            layer_prefix, rest = name.split(".mlp.experts.")
            expert_id, which, _ = rest.split(".")
            self._moe(layer_prefix).load_expert_weight(
                bucket(f"{layer_prefix}.mlp_moe"), self._EXPERT_MAP[which],
                int(expert_id), tensor)
            return None
        if name.endswith(".mlp.gate.weight"):
            layer_prefix = name[:-len(".mlp.gate.weight")]
            self._moe(layer_prefix).load_gate_weight(
                bucket(f"{layer_prefix}.mlp_moe"), tensor)
            return None
        # The shared experts -> their LlamaMLP's "<prefix>.shared.mlp.*".
        return name.replace(".mlp.shared_experts.", ".shared.mlp.")
