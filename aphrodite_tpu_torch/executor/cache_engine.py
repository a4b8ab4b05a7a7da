"""KV-cache allocation and swaps (port of
`aphrodite_tpu/executor/cache_engine.py`, one GPU).

Per layer the cache is a (k_pages, v_pages) pair of device tensors
[num_pages, page_size, num_kv_heads * head_dim], token-major with heads
in the last dim and head_dim unpadded. The host swap pool is one CPU
tensor per layer [2, host_pages, page_size, heads * head_dim] in the
cache dtype, pinned when the pool serves a CUDA card. Swaps and page
copies update the device pages in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from aphrodite_tpu_torch.common.config import CacheConfig, ModelConfig
from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)

KVCache = Tuple[torch.Tensor, torch.Tensor]

_MODEL_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


class CacheEngine:
    """Owns the paged KV cache for every layer and the host swap pool."""

    def __init__(self, cache_config: CacheConfig, model_config: ModelConfig,
                 device: torch.device) -> None:
        self.cache_config = cache_config
        self.model_config = model_config
        self.device = device
        self.page_size = cache_config.block_size
        self.num_device_pages = cache_config.num_gpu_blocks
        self.num_host_pages = cache_config.num_cpu_blocks or 0
        assert self.num_device_pages is not None
        self.num_layers = model_config.hf_config.num_hidden_layers
        self.kv_heads_per_layer = model_config.get_kv_heads_per_layer()
        self.head_size = model_config.get_head_size()
        self.dtype = _MODEL_DTYPES[model_config.dtype]
        # Quantized KV caches are refused by CacheConfig.
        self.kv_scale = 1.0
        self.kv_caches: List[KVCache] = [
            (self._alloc(heads), self._alloc(heads))
            for heads in self.kv_heads_per_layer]
        self._host_pool: Optional[List[torch.Tensor]] = None

    def _alloc(self, heads: int) -> torch.Tensor:
        return torch.zeros((self.num_device_pages, self.page_size,
                            heads * self.head_size), dtype=self.dtype,
                           device=self.device)

    def _ensure_host_pool(self) -> None:
        if self._host_pool is None:
            pin = self.device.type == "cuda"
            self._host_pool = [
                torch.zeros((2, self.num_host_pages, self.page_size,
                             heads * self.head_size), dtype=self.dtype,
                            pin_memory=pin)
                for heads in self.kv_heads_per_layer]

    @property
    def num_slots(self) -> int:
        return self.num_device_pages * self.page_size

    # -- swap --

    def swap_out(self, mapping: Dict[int, int]) -> None:
        """Device pages -> host pool."""
        if not mapping:
            return
        self._ensure_host_pool()
        src = torch.tensor(list(mapping.keys()), dtype=torch.int64,
                           device=self.device)
        dst = torch.tensor(list(mapping.values()), dtype=torch.int64)
        for layer, (k_pages, v_pages) in enumerate(self.kv_caches):
            self._host_pool[layer][0][dst] = k_pages[src].cpu()
            self._host_pool[layer][1][dst] = v_pages[src].cpu()

    def swap_in(self, mapping: Dict[int, int]) -> None:
        """Host pool -> device pages (in place)."""
        if not mapping:
            return
        self._ensure_host_pool()
        src = torch.tensor(list(mapping.keys()), dtype=torch.int64)
        dst = torch.tensor(list(mapping.values()), dtype=torch.int64,
                           device=self.device)
        for layer, (k_pages, v_pages) in enumerate(self.kv_caches):
            k_pages[dst] = self._host_pool[layer][0][src].to(self.device)
            v_pages[dst] = self._host_pool[layer][1][src].to(self.device)

    @staticmethod
    def get_cache_block_size(cache_config: CacheConfig,
                             model_config: ModelConfig) -> int:
        """Bytes per page across all layers (K and V)."""
        total_heads = sum(model_config.get_kv_heads_per_layer())
        elt = 4 if model_config.dtype == "float32" else 2
        per_token = total_heads * model_config.get_head_size() * elt
        return 2 * cache_config.block_size * per_token
