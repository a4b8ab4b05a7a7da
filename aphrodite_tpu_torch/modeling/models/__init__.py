"""Model zoo of the PyTorch port: HF `architectures` names -> classes,
resolved lazily. The same names and module names as the JAX package's
registry (`aphrodite_tpu/modeling/models/__init__.py`): the Llama
family, DeciLM and Qwen2 over `llama.py`, the two MoE families, OPT,
GPT-J, GPT-NeoX and Phi."""
from __future__ import annotations

import importlib
from typing import List, Optional, Type

_MODELS = {
    "LlamaForCausalLM": ("llama", "LlamaForCausalLM"),
    "LLaMAForCausalLM": ("llama", "LlamaForCausalLM"),
    "MistralForCausalLM": ("llama", "LlamaForCausalLM"),
    "YiForCausalLM": ("llama", "LlamaForCausalLM"),
    "DeciLMForCausalLM": ("decilm", "DeciLMForCausalLM"),
    "MixtralForCausalLM": ("mixtral", "MixtralForCausalLM"),
    "DeepseekForCausalLM": ("deepseek", "DeepseekForCausalLM"),
    "OPTForCausalLM": ("opt", "OPTForCausalLM"),
    "GPTJForCausalLM": ("gpt_j", "GPTJForCausalLM"),
    "GPTNeoXForCausalLM": ("gpt_neox", "GPTNeoXForCausalLM"),
    "PhiForCausalLM": ("phi", "PhiForCausalLM"),
    "Qwen2ForCausalLM": ("qwen2", "Qwen2ForCausalLM"),
}
#: The architectures whose FFNs are FusedMoE layers.
MOE_ARCHS = ("MixtralForCausalLM", "DeepseekForCausalLM")


def moe_architecture(hf_config) -> Optional[str]:
    """The config's MoE architecture name, or None."""
    archs = getattr(hf_config, "architectures", None) or []
    return next((a for a in archs if a in MOE_ARCHS), None)


class ModelRegistry:

    @staticmethod
    def load_model_cls(model_arch: str) -> Optional[Type]:
        if model_arch not in _MODELS:
            return None
        module_name, cls_name = _MODELS[model_arch]
        module = importlib.import_module(
            f"aphrodite_tpu_torch.modeling.models.{module_name}")
        return getattr(module, cls_name)

    @staticmethod
    def get_supported_archs() -> List[str]:
        return list(_MODELS.keys())
