"""LoRA request descriptor (port of `aphrodite_tpu/lora/request.py`)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LoRARequest:
    """Identifies one adapter; lora_int_id must be globally unique > 0."""
    lora_name: str
    lora_int_id: int
    lora_local_path: str

    def __post_init__(self):
        if self.lora_int_id < 1:
            raise ValueError(f"lora_int_id must be > 0, got "
                             f"{self.lora_int_id}")

    def __eq__(self, value: object) -> bool:
        return isinstance(value, LoRARequest) and \
            self.lora_int_id == value.lora_int_id

    def __hash__(self) -> int:
        return self.lora_int_id
