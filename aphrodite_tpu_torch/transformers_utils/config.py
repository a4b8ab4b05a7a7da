"""Model config loading for the PyTorch port: `config.json` read with
`json` alone, or a `.gguf` file's metadata.

The JAX package loads configs through `transformers.AutoConfig`
(`aphrodite_tpu/transformers_utils/config.py:6`). The port runs where
`transformers` is not installed, so it reads the JSON into a plain
attribute object and fills the defaults HF's `LlamaConfig` would give
the keys a Llama-family checkpoint may leave out; a Mixtral file gets
HF's `MixtralConfig` defaults over those, and a DeepSeek-MoE file
(`model_type: "deepseek"`, remote code in HF) the defaults the JAX
model's own `getattr`s give (`aphrodite_tpu/modeling/models/
deepseek.py:35-47`).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

# HF LlamaConfig defaults for keys a config.json may omit.
_LLAMA_DEFAULTS: Dict[str, Any] = {
    "max_position_embeddings": 2048,
    "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0,
    "rope_scaling": None,
    "tie_word_embeddings": False,
    "attention_bias": False,
    "hidden_act": "silu",
    "head_dim": None,
    "sliding_window": None,
}
# HF MistralConfig turns the sliding window on unless the file says so.
_MISTRAL_DEFAULTS: Dict[str, Any] = {"sliding_window": 4096}
# HF MixtralConfig's defaults (transformers'
# models/mixtral/configuration_mixtral.py) for the keys it reads.
_MIXTRAL_DEFAULTS: Dict[str, Any] = {
    "vocab_size": 32000,
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "head_dim": None,
    "hidden_act": "silu",
    "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False,
    "rope_theta": 1e6,
    "sliding_window": None,
    "num_experts_per_tok": 2,
    "num_local_experts": 8,
    "bos_token_id": 1,
    "eos_token_id": 2,
}
# The JAX DeepSeek model's getattr defaults: no routed experts means
# every layer is dense.
_DEEPSEEK_DEFAULTS: Dict[str, Any] = {
    "n_routed_experts": None,
    "norm_topk_prob": False,
    "n_shared_experts": 0,
}
# Read by the JAX DeepSeek model without a default once it has routed
# experts: a file without them is refused here.
_DEEPSEEK_REQUIRED = ("first_k_dense_replace", "moe_layer_freq")


class ModelJsonConfig:
    """The keys of a `config.json` as attributes (the surface the engine
    reads from an HF `PretrainedConfig`)."""

    def __init__(self, **entries: Any) -> None:
        self.__dict__.update(entries)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def __repr__(self) -> str:
        return f"ModelJsonConfig({self.__dict__!r})"


def config_from_dict(raw: Dict[str, Any]) -> ModelJsonConfig:
    """Apply the Llama-family defaults (and Mixtral's or DeepSeek's over
    them) to a parsed config.json."""
    entries = dict(_LLAMA_DEFAULTS)
    model_type = str(raw.get("model_type", "")).lower()
    entries.update({"mistral": _MISTRAL_DEFAULTS,
                    "mixtral": _MIXTRAL_DEFAULTS,
                    "deepseek": _DEEPSEEK_DEFAULTS}.get(model_type, {}))
    entries.update(raw)
    if model_type == "deepseek" and \
            entries["n_routed_experts"] is not None:
        missing = [k for k in _DEEPSEEK_REQUIRED if k not in entries]
        if missing:
            raise ValueError(
                f"DeepSeek config with n_routed_experts "
                f"{entries['n_routed_experts']} lacks {missing}: the layer "
                "plan (dense up to first_k_dense_replace, then MoE every "
                "moe_layer_freq-th layer) needs both.")
    if entries.get("num_key_value_heads") is None and \
            "num_attention_heads" in entries:
        entries["num_key_value_heads"] = entries["num_attention_heads"]
    return ModelJsonConfig(**entries)


def get_config(model: str,
               trust_remote_code: bool = False,
               revision: Optional[str] = None) -> ModelJsonConfig:
    """Read `<model>/config.json` (a local directory; the port has no
    hub access), or a single-file `.gguf` checkpoint's metadata.
    `trust_remote_code` and `revision` are accepted for signature parity
    with the JAX package and do not apply to a local file."""
    del trust_remote_code, revision
    if model.endswith(".gguf"):
        # Single-file GGUF checkpoint: the config comes from its metadata
        # (reference `transformers_utils/config.py:77-78`).
        from aphrodite_tpu_torch.modeling.gguf import extract_gguf_config
        return extract_gguf_config(model)
    path = os.path.join(model, "config.json")
    if not os.path.isfile(path):
        raise ValueError(
            f"{model!r} has no config.json: the PyTorch port loads local "
            "model directories only.")
    with open(path) as f:
        return config_from_dict(json.load(f))
