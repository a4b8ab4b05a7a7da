"""Logical and physical KV-cache blocks.

Reference semantics: `aphrodite/common/block.py:9,49`. On TPU the physical
blocks index into preallocated HBM page arrays (one `jax.Array` of pages per
layer, see executor/cache.py) rather than CUDA tensors; the CPU device is a
pinned-host staging pool used for preemption-by-swap.
"""
from __future__ import annotations

from typing import List


class Device:
    GPU = 0  # retained name for parity; means "TPU HBM" here
    TPU = 0
    CPU = 1


# The reference also keeps a LogicalTokenBlock with per-block token-id
# lists (`aphrodite/common/block.py:9`); here a sequence's logical
# block structure is pure arithmetic on its token count (see
# Sequence.logical_token_blocks), so only the physical page objects
# need real state.


class PhysicalTokenBlock:
    """A slot in the paged KV cache on a device, with a refcount for CoW."""

    __slots__ = ("device", "block_number", "block_size", "ref_count")

    def __init__(self, device: int, block_number: int,
                 block_size: int) -> None:
        self.device = device
        self.block_number = block_number
        self.block_size = block_size
        self.ref_count = 0

    def __repr__(self) -> str:
        return (f"PhysicalTokenBlock(device={self.device}, "
                f"block_number={self.block_number}, "
                f"ref_count={self.ref_count})")


# Mapping: logical block number -> physical block.
BlockTable = List[PhysicalTokenBlock]
