"""Yi config defaults (a copy of the table of
`aphrodite_tpu/transformers_utils/configs/yi.py`, whose field schema
is 01-ai/Yi checkpoints' configuration_yi.py)."""
from typing import Any, Dict

DEFAULTS: Dict[str, Any] = {
    "vocab_size": 64000,
    "hidden_size": 4096,
    "intermediate_size": 11008,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 4,
    "hidden_act": "silu",
    "max_position_embeddings": 4096,
    "initializer_range": 0.02,
    "rms_norm_eps": 1e-5,
    "use_cache": True,
    "output_attentions": False,
    "rope_theta": 5000000.0,
    "pad_token_id": 0,
    "bos_token_id": 1,
    "eos_token_id": 2,
    "tie_word_embeddings": False,
}
