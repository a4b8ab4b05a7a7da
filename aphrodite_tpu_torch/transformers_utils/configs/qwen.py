"""QWen (v1) config defaults (a copy of the table of
`aphrodite_tpu/transformers_utils/configs/qwen.py`, whose field schema
is Qwen/Qwen-7B checkpoints' configuration_qwen.py)."""
from typing import Any, Dict

DEFAULTS: Dict[str, Any] = {
    "vocab_size": 151936,
    "hidden_size": 4096,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "emb_dropout_prob": 0.0,
    "attn_dropout_prob": 0.0,
    "layer_norm_epsilon": 1e-6,
    "initializer_range": 0.02,
    "max_position_embeddings": 8192,
    "scale_attn_weights": True,
    "use_cache": True,
    "bf16": False,
    "fp16": False,
    "fp32": False,
    "kv_channels": 128,
    "rotary_pct": 1.0,
    "rotary_emb_base": 10000,
    "use_dynamic_ntk": True,
    "use_logn_attn": True,
    "use_flash_attn": "auto",
    "intermediate_size": 22016,
    "no_bias": True,
    "tie_word_embeddings": False,
}
