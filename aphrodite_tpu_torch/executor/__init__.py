"""Execution layer of the PyTorch port: KV cache engine, model runner and
the single-GPU executor."""
