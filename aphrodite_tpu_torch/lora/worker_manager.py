"""Per-replica LoRA lifecycle (port of
`aphrodite_tpu/lora/worker_manager.py`): adapters load on demand from
their local PEFT directories and each batch's set is made resident in
device slots before the step is dispatched."""
from __future__ import annotations

from typing import List, Optional, Set

from aphrodite_tpu_torch.common.config import LoRAConfig
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.lora.models import (LoRAModel,
                                             LRUCacheLoRAModelManager)
from aphrodite_tpu_torch.lora.request import LoRARequest

logger = init_logger(__name__)


class WorkerLoRAManager:
    """Loads adapters from LoRARequest paths on demand and keeps this
    batch's set active in device slots."""

    def __init__(self, lora_config: LoRAConfig, write_slot_fn,
                 clear_slot_fn, module_layouts=None) -> None:
        self.lora_config = lora_config
        self.module_layouts = module_layouts
        self.manager = LRUCacheLoRAModelManager(lora_config,
                                                write_slot_fn,
                                                clear_slot_fn)

    def add_lora(self, lora_request: LoRARequest) -> bool:
        if lora_request.lora_int_id in self.manager.list_loras():
            self.manager.touch(lora_request.lora_int_id)
            return False
        lora = LoRAModel.from_local_checkpoint(
            lora_request.lora_local_path, lora_request.lora_int_id,
            module_layouts=self.module_layouts)
        return self.manager.add_lora(lora)

    def remove_lora(self, lora_id: int) -> bool:
        return self.manager.remove_lora(lora_id)

    def list_loras(self) -> Set[int]:
        return set(self.manager.list_loras())

    def set_active_adapters(
            self, lora_requests: List[Optional[LoRARequest]]) -> None:
        wanted: Set[int] = set()
        for req in lora_requests:
            if req is None:
                continue
            self.add_lora(req)
            wanted.add(req.lora_int_id)
        if wanted:
            self.manager.set_active_loras(wanted)

    def slot_of(self, lora_id: int) -> int:
        return self.manager.slot_of(lora_id)
