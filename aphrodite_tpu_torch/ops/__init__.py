"""Device ops of the PyTorch port: plain KV-cache ops and attention
references (`kv_cache`, `attention`) and the CUDA kernels (`cuda/`)."""
