"""Model config loading for the PyTorch port: `config.json` read with
`json` alone, or a `.gguf` file's metadata.

The JAX package loads configs through `transformers.AutoConfig`
(`aphrodite_tpu/transformers_utils/config.py:6`), or through its own
config classes for `model_type` "yi" and "qwen". The port runs where
`transformers` is not installed, so it reads the JSON into a plain
attribute object and fills, as data, what those classes would give the
keys a checkpoint may leave out:

- a Llama-family file (and any other type, DeciLM's "deci" among them)
  gets HF's `LlamaConfig` defaults; a Mistral or Mixtral file HF's
  `MistralConfig` / `MixtralConfig` defaults over those, and a
  DeepSeek-MoE file (`model_type: "deepseek"`, remote code in HF) the
  defaults the JAX model's own `getattr`s give
  (`aphrodite_tpu/modeling/models/deepseek.py:35-47`);
- Qwen2, OPT, GPT-J, GPT-NeoX and Phi files get their own class's
  defaults alone (transformers 4.57.6,
  `models/<type>/configuration_<type>.py`), with what those classes
  derive in `__init__`: GPT-J's `attribute_map` (`hidden_size` is
  `n_embd`, and so on), Qwen2's window only under `use_sliding_window`,
  OPT's `word_embed_proj_dim` defaulting to `hidden_size`, NeoX's
  `partial_rotary_factor` and `rope_theta` from `rotary_pct` and
  `rotary_emb_base`;
- "yi" and "qwen" files get the JAX package's own config classes'
  tables (`configs/yi.py`, `configs/qwen.py`).
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

from aphrodite_tpu_torch.modeling.hf_loader import resolve_model_path
from aphrodite_tpu_torch.transformers_utils.configs import qwen, yi

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
# transformers 4.57.6's defaults (models/<type>/configuration_<type>.py)
# for the keys the models and the engine read, by model_type; these
# families do not start from the Llama table.
_QWEN2_DEFAULTS: Dict[str, Any] = {
    "vocab_size": 151936, "hidden_size": 4096, "intermediate_size": 22016,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "hidden_act": "silu",
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "rope_theta": 10000.0,
    "rope_scaling": None, "use_sliding_window": False,
    "sliding_window": 4096, "max_window_layers": 28,
    "bos_token_id": None, "eos_token_id": None,
}
_OPT_DEFAULTS: Dict[str, Any] = {
    "vocab_size": 50272, "hidden_size": 768, "num_hidden_layers": 12,
    "ffn_dim": 3072, "max_position_embeddings": 2048,
    "do_layer_norm_before": True, "_remove_final_layer_norm": False,
    "word_embed_proj_dim": None, "num_attention_heads": 12,
    "activation_function": "relu", "enable_bias": True,
    "layer_norm_elementwise_affine": True, "pad_token_id": 1,
    "bos_token_id": 2, "eos_token_id": 2, "tie_word_embeddings": True,
}
_GPTJ_DEFAULTS: Dict[str, Any] = {
    "vocab_size": 50400, "n_positions": 2048, "n_embd": 4096,
    "n_layer": 28, "n_head": 16, "rotary_dim": 64, "n_inner": None,
    "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
    "bos_token_id": 50256, "eos_token_id": 50256,
    "tie_word_embeddings": False,
}
_GPT_NEOX_DEFAULTS: Dict[str, Any] = {
    "vocab_size": 50432, "hidden_size": 6144, "num_hidden_layers": 44,
    "num_attention_heads": 64, "intermediate_size": 24576,
    "hidden_act": "gelu", "rotary_pct": 0.25, "rotary_emb_base": 10000,
    "max_position_embeddings": 2048, "layer_norm_eps": 1e-5,
    "bos_token_id": 0, "eos_token_id": 2, "tie_word_embeddings": False,
    "use_parallel_residual": True, "rope_scaling": None,
    "attention_bias": True,
}
_PHI_DEFAULTS: Dict[str, Any] = {
    "vocab_size": 51200, "hidden_size": 2048, "intermediate_size": 8192,
    "num_hidden_layers": 24, "num_attention_heads": 32,
    "num_key_value_heads": None, "hidden_act": "gelu_new",
    "max_position_embeddings": 2048, "layer_norm_eps": 1e-5,
    "tie_word_embeddings": False, "rope_theta": 10000.0,
    "rope_scaling": None, "partial_rotary_factor": 0.5,
    "qk_layernorm": False, "bos_token_id": 1, "eos_token_id": 2,
}
# HF GPTJConfig's attribute_map: the engine's names -> GPT-J's.
_GPTJ_ATTRIBUTE_MAP = {"max_position_embeddings": "n_positions",
                       "hidden_size": "n_embd",
                       "num_attention_heads": "n_head",
                       "num_hidden_layers": "n_layer"}


def _qwen2_window(e: Dict[str, Any]) -> None:
    # Qwen2Config keeps the window only where use_sliding_window is set.
    if not e["use_sliding_window"]:
        e["sliding_window"] = None


def _opt_proj_dim(e: Dict[str, Any]) -> None:
    if e["word_embed_proj_dim"] is None:
        e["word_embed_proj_dim"] = e["hidden_size"]


def _neox_rotary(e: Dict[str, Any]) -> None:
    # GPTNeoXConfig sets these two from rotary_pct / rotary_emb_base,
    # whatever the file says of them.
    e["partial_rotary_factor"] = e["rotary_pct"]
    e["rope_theta"] = e["rotary_emb_base"]


def _gptj_aliases(e: Dict[str, Any]) -> None:
    for alias, real in _GPTJ_ATTRIBUTE_MAP.items():
        if alias in e:
            e[real] = e[alias]
        e[alias] = e[real]


# model_type -> (defaults, what the HF class derives in __init__).
_OWN_DEFAULTS: Dict[str, Any] = {
    "qwen2": (_QWEN2_DEFAULTS, _qwen2_window),
    "opt": (_OPT_DEFAULTS, _opt_proj_dim),
    "gptj": (_GPTJ_DEFAULTS, _gptj_aliases),
    "gpt_neox": (_GPT_NEOX_DEFAULTS, _neox_rotary),
    "phi": (_PHI_DEFAULTS, None),
    "yi": (yi.DEFAULTS, None),
    "qwen": (qwen.DEFAULTS, None),
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
    """Apply the defaults of the file's model_type (see the module doc)
    to a parsed config.json."""
    model_type = str(raw.get("model_type", "")).lower()
    derive: Optional[Callable[[Dict[str, Any]], None]] = None
    if model_type in _OWN_DEFAULTS:
        defaults, derive = _OWN_DEFAULTS[model_type]
        entries = dict(defaults)
    else:
        entries = dict(_LLAMA_DEFAULTS)
        entries.update({"mistral": _MISTRAL_DEFAULTS,
                        "mixtral": _MIXTRAL_DEFAULTS,
                        "deepseek": _DEEPSEEK_DEFAULTS}.get(model_type, {}))
    entries.update(raw)
    if derive is not None:
        derive(entries)
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
    """Read `<model>/config.json`, or a single-file `.gguf` checkpoint's
    metadata. A model id that is not a local path resolves first through
    `resolve_model_path` (the hub snapshot brings `*.json` along), where
    the JAX package lets `AutoConfig` resolve it. `trust_remote_code` and
    `revision` are accepted for signature parity with the JAX package
    and do not apply to a local file."""
    del trust_remote_code, revision
    if model.endswith(".gguf"):
        # Single-file GGUF checkpoint: the config comes from its metadata
        # (reference `transformers_utils/config.py:77-78`).
        from aphrodite_tpu_torch.modeling.gguf import extract_gguf_config
        return extract_gguf_config(model)
    try:
        model_dir = resolve_model_path(model)
    except ValueError as e:
        # huggingface_hub's HFValidationError: no such local path, and
        # not a well-formed model id either.
        raise ValueError(
            f"{model!r} is neither a local model directory with a "
            f"config.json nor a hub model id: {e}") from e
    path = os.path.join(model_dir, "config.json")
    if not os.path.isfile(path):
        raise ValueError(f"{model!r} has no config.json.")
    with open(path) as f:
        return config_from_dict(json.load(f))
