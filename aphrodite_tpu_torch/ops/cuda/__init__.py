"""Hand-written CUDA kernels for Hopper (sm_90a) with their plain
PyTorch versions; sources live in `aphrodite_tpu_torch/csrc/`."""
