"""Model zoo of the PyTorch port: HF `architectures` names -> classes,
resolved lazily. This slice registers the Llama-family names that map
to `llama.py`; the other architectures of the JAX package are a later
slice (ROADMAP.md)."""
from __future__ import annotations

import importlib
from typing import List, Optional, Type

_MODELS = {
    "LlamaForCausalLM": ("llama", "LlamaForCausalLM"),
    "LLaMAForCausalLM": ("llama", "LlamaForCausalLM"),
    "MistralForCausalLM": ("llama", "LlamaForCausalLM"),
    "YiForCausalLM": ("llama", "LlamaForCausalLM"),
}


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
