"""Defaults tables of the config classes the JAX package ships for
checkpoints whose `model_type` transformers does not know (`yi`,
`qwen`), read by `transformers_utils/config.py:config_from_dict`."""
