"""Model config loading for the PyTorch port: `config.json` read with
`json` alone, or a `.gguf` file's metadata.

The JAX package loads configs through `transformers.AutoConfig`
(`aphrodite_tpu/transformers_utils/config.py:6`). The port runs where
`transformers` is not installed, so it reads the JSON into a plain
attribute object and fills the defaults HF's `LlamaConfig` would give
the keys a Llama-family checkpoint may leave out.
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
    """Apply the Llama-family defaults to a parsed config.json."""
    entries = dict(_LLAMA_DEFAULTS)
    if str(raw.get("model_type", "")).lower() == "mistral":
        entries.update(_MISTRAL_DEFAULTS)
    entries.update(raw)
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
