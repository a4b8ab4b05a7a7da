"""Multi-LoRA serving in the PyTorch port (port of `aphrodite_tpu/lora/`).

Adapters live in slot stacks inside each wrapped linear layer's
parameter bucket (`layers.py`); each batch row carries its adapter's
slot, -1 for none. The model runner writes an adapter's (A, B) into a
slot when the executor's `WorkerLoRAManager` (`worker_manager.py`)
activates it before a step, and injects the step's per-row slots into
every LoRA bucket (`ModelRunner._params_with_lora`).
"""
from aphrodite_tpu_torch.lora.request import LoRARequest

__all__ = ["LoRARequest"]
