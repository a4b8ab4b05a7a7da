"""KV-cache allocation and swaps (port of
`aphrodite_tpu/executor/cache_engine.py`, one GPU).

Per layer the cache is a (k_pages, v_pages) pair of device tensors
[num_pages, page_size, num_kv_heads * head_dim], token-major with heads
in the last dim and head_dim unpadded, in the model dtype or, with
`kv_cache_dtype` "int8" / "fp8", in int8 / float8_e5m2 (one byte per
value: about twice the pages in the same memory; `ops/kv_quant.py`).
The host swap pool is one CPU tensor per layer [2, host_pages,
page_size, heads * head_dim] in the cache dtype, pinned when the pool
serves a CUDA card. Swaps and page copies update the device pages in
place, moving 8-bit pages as bytes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.common.config import CacheConfig, ModelConfig
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.ops.kv_quant import DEFAULT_KV_SCALE, byte_view

logger = init_logger(__name__)

KVCache = Tuple[torch.Tensor, torch.Tensor]

_MODEL_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}

_CACHE_DTYPES = {
    "auto": None,                 # the model dtype
    "fp8": torch.float8_e5m2,
    "int8": torch.int8,
}


def cache_dtype_of(cache_config: CacheConfig,
                   model_config: ModelConfig) -> torch.dtype:
    """The page dtype: the cache dtype's, else the model's."""
    quant = _CACHE_DTYPES[cache_config.cache_dtype]
    return quant if quant is not None else _MODEL_DTYPES[model_config.dtype]


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
        self.dtype = cache_dtype_of(cache_config, model_config)
        # The int8 dequant scale, threaded to the kernels through
        # InputMetadata.kv_scale (a strict read: a malformed value raises
        # naming the flag).
        self.kv_scale = 1.0
        if cache_config.cache_dtype == "int8":
            self.kv_scale = flags.get_float("APHRODITE_KV_SCALE",
                                            default=DEFAULT_KV_SCALE)
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
        for layer, pages in enumerate(self.kv_caches):
            host = byte_view(self._host_pool[layer])
            for side in (0, 1):
                host[side][dst] = byte_view(pages[side])[src].cpu()

    def swap_in(self, mapping: Dict[int, int]) -> None:
        """Host pool -> device pages (in place)."""
        if not mapping:
            return
        self._ensure_host_pool()
        src = torch.tensor(list(mapping.keys()), dtype=torch.int64)
        dst = torch.tensor(list(mapping.values()), dtype=torch.int64,
                           device=self.device)
        for layer, pages in enumerate(self.kv_caches):
            host = byte_view(self._host_pool[layer])
            for side in (0, 1):
                byte_view(pages[side])[dst] = host[side][src].to(
                    self.device)

    @staticmethod
    def get_cache_block_size(cache_config: CacheConfig,
                             model_config: ModelConfig) -> int:
        """Bytes per page across all layers (K and V), at the page
        dtype's width."""
        total_heads = sum(model_config.get_kv_heads_per_layer())
        elt = cache_dtype_of(cache_config, model_config).itemsize
        per_token = total_heads * model_config.get_head_size() * elt
        return 2 * cache_config.block_size * per_token
