"""Paged KV-cache block accounting (host side) — the page OWNER.

Semantics match the reference's `aphrodite/processing/block_manager.py:10,68`
(ref-counted allocator, watermark admission, copy-on-write fork, sliding-
window block reuse, host<->HBM swap planning). This module is pure Python
and device-agnostic: it only plans block operations; the executor applies
them to the HBM page arrays (`executor/cache.py`) as batched gathers/
scatters and host transfers — there is no per-block memcpy on TPU, the
swap/copy plans are turned into single vectorized device ops per step.

Ownership contract (machine-enforced by aphrocheck's LEAK/OWN passes):
this module — together with `common/block.py` and `common/prefix.py` —
is the ONLY place `PhysicalTokenBlock.ref_count`, the pool free lists,
and the `block_tables` map may be mutated, and raw block objects never
cross the module boundary: callers see `block_number` ints only
(`get_block_table` / `block_numbers` / the swap mappings). Every
refcount increment is paired with a statically-reachable free seam
(`free`/`reset` for sequence tables, `free_prefix` for prefix pins);
`python -m tools.aphrocheck --ledger` emits the alloc-site -> free-seam
map (OWNERSHIP.json) that tier-1 drift-gates.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Set, Tuple

from aphrodite_tpu_torch.common import faultinject
from aphrodite_tpu_torch.common.block import (BlockTable, Device,
                                        PhysicalTokenBlock)
from aphrodite_tpu_torch.common.prefix import Prefix
from aphrodite_tpu_torch.common.sequence import (Sequence, SequenceGroup,
                                           SequenceStatus)


class BlockPool:
    """Free-list allocator with CoW refcounts for one device's pages."""

    def __init__(self, device: int, block_size: int, num_blocks: int) -> None:
        self.device = device
        self.block_size = block_size
        self.num_blocks = num_blocks
        # thread-safe: allocate/free run on the step thread inside
        # step(), or on the event loop (abort paths) strictly BETWEEN
        # steps — engine_step awaits the step future before freeing,
        # so the free list never sees concurrent mutation.
        self._free: List[PhysicalTokenBlock] = [
            PhysicalTokenBlock(device, idx, block_size)
            for idx in range(num_blocks)
        ]

    def allocate(self) -> PhysicalTokenBlock:
        if not self._free:
            raise ValueError("Out of memory! No free blocks are available.")
        block = self._free.pop()
        block.ref_count = 1
        return block

    def free(self, block: PhysicalTokenBlock) -> None:
        if block.ref_count == 0:
            raise ValueError(f"Double free! {block} is already freed.")
        block.ref_count -= 1
        if block.ref_count == 0:
            self._free.append(block)

    def get_num_free_blocks(self) -> int:
        return len(self._free)


# Backwards-compatible alias matching the reference class name.
BlockAllocator = BlockPool


class AllocStatus(enum.Enum):
    """Admission verdict for a waiting sequence group."""
    OK = enum.auto()       # fits now
    LATER = enum.auto()    # doesn't fit now, retry after blocks free up
    NEVER = enum.auto()    # larger than the whole cache; must be ignored


class BlockSpaceManager:
    """Maps logical sequence blocks to physical KV pages on HBM/host."""

    def __init__(
        self,
        block_size: int,
        num_gpu_blocks: int,
        num_cpu_blocks: int,
        watermark: float = 0.01,
        sliding_window: Optional[int] = None,
    ) -> None:
        self.block_size = block_size
        self.num_total_gpu_blocks = num_gpu_blocks
        self.num_total_cpu_blocks = num_cpu_blocks

        self.block_sliding_window: Optional[int] = None
        if sliding_window is not None:
            if sliding_window % block_size != 0:
                raise ValueError(
                    f"Sliding window ({sliding_window}) must be a multiple "
                    f"of block size ({block_size}).")
            self.block_sliding_window = sliding_window // block_size

        assert watermark >= 0.0
        self.watermark = watermark
        self.watermark_blocks = int(watermark * num_gpu_blocks)

        # TPU-native names; the reference's gpu_/cpu_allocator spelling
        # survives as read-only aliases below for parity callers.
        self.hbm_pool = BlockPool(Device.TPU, block_size, num_gpu_blocks)
        self.host_pool = BlockPool(Device.CPU, block_size, num_cpu_blocks)
        # thread-safe: mutated on the step thread inside step() and on
        # the event loop only via abort/free paths that run BETWEEN
        # steps (engine_step awaits the step future first); the two
        # writers are sequenced by the engine loop, never concurrent.
        self.block_tables: Dict[int, BlockTable] = {}

    @property
    def gpu_allocator(self) -> BlockPool:
        """Reference-parity alias for :attr:`hbm_pool` (read-only)."""
        return self.hbm_pool

    @property
    def cpu_allocator(self) -> BlockPool:
        """Reference-parity alias for :attr:`host_pool` (read-only)."""
        return self.host_pool

    # ------------------------------------------------------------------
    # Prompt admission / allocation
    # ------------------------------------------------------------------

    def _prompt_blocks_needed(self, seq_group: SequenceGroup) -> int:
        seq = seq_group.get_seqs(status=SequenceStatus.WAITING)[0]
        needed = len(seq.logical_token_blocks)
        prefix = seq_group.prefix
        if prefix is not None and prefix.allocated:
            needed -= prefix.get_num_blocks()
        if self.block_sliding_window is not None:
            needed = min(needed, self.block_sliding_window)
        return needed

    def can_allocate(self, seq_group: SequenceGroup,
                     extra_reserved: int = 0) -> AllocStatus:
        """Admission verdict. `extra_reserved` blocks are treated as
        unavailable on top of the watermark hysteresis — the
        scheduler passes its low-watermark reserve (pages held back
        for running sequences' next decode slots) so admitting a
        prompt can never immediately force a preemption."""
        needed = self._prompt_blocks_needed(seq_group)
        free = self.hbm_pool.get_num_free_blocks()
        # The watermark hysteresis avoids admitting a prompt that would
        # immediately force evictions.
        if self.num_total_gpu_blocks - needed < self.watermark_blocks:
            return AllocStatus.NEVER
        if free - needed >= self.watermark_blocks + extra_reserved:
            return AllocStatus.OK
        return AllocStatus.LATER

    def allocate(self, seq_group: SequenceGroup) -> None:
        faultinject.fire("block_manager.allocate",
                         detail=seq_group.request_id)
        # All waiting sequences in a group share one prompt, hence one
        # physical block table (forked on first divergent append).
        seq = seq_group.get_seqs(status=SequenceStatus.WAITING)[0]
        num_prompt_blocks = len(seq.logical_token_blocks)

        block_table: BlockTable = []
        prefix = seq_group.prefix
        if prefix is not None and prefix.allocated:
            num_prompt_blocks -= prefix.get_num_blocks()
            for block in prefix.block_table:
                block.ref_count += seq_group.num_seqs()
                block_table.append(block)

        for logical_idx in range(num_prompt_blocks):
            if (self.block_sliding_window is not None
                    and logical_idx >= self.block_sliding_window):
                # Sliding-window reuse: the aliased block is already in
                # this table and already carries this group's refs —
                # frees walk set(table), one decrement per unique block.
                # Re-assigning `= num_seqs` here (the reference's shape)
                # CLOBBERED a prefix-pinned or cross-group-shared count
                # when the window wrapped onto a prefix block.
                block = block_table[logical_idx % self.block_sliding_window]
            else:
                block = self.hbm_pool.allocate()
                block.ref_count = seq_group.num_seqs()
            block_table.append(block)

        if prefix is not None and not prefix.allocated:
            # First request carrying this prefix: pin its leading blocks so
            # later requests can share the computed KV.
            shared = block_table[:prefix.get_num_blocks()]
            for block in shared:
                block.ref_count += 1
            prefix.set_block_table(shared)

        for waiting_seq in seq_group.get_seqs(status=SequenceStatus.WAITING):
            self.block_tables[waiting_seq.seq_id] = block_table.copy()

    # ------------------------------------------------------------------
    # Decode-time slot append (with CoW)
    # ------------------------------------------------------------------

    def can_append_slot(self, seq_group: SequenceGroup) -> bool:
        # One new block per running sequence is the worst case.
        num_seqs = seq_group.num_seqs(status=SequenceStatus.RUNNING)
        return num_seqs <= self.hbm_pool.get_num_free_blocks()

    def append_slot(self, seq: Sequence) -> Optional[Tuple[int, int]]:
        """Reserve a slot for one new token.

        Returns a (src, dst) physical block pair when a copy-on-write is
        required (the executor batches all pairs into one device copy).
        """
        logical_blocks = seq.logical_token_blocks
        block_table = self.block_tables[seq.seq_id]

        if len(block_table) < len(logical_blocks):
            if (self.block_sliding_window
                    and len(block_table) >= self.block_sliding_window):
                # Sliding window: cycle back onto the oldest in-window
                # block — which may be shared post-fork, so fall through to
                # the CoW check below.
                block_table.append(block_table[len(block_table) %
                                               self.block_sliding_window])
            else:
                block_table.append(self.hbm_pool.allocate())
                return None

        last_block = block_table[-1]
        assert last_block.device == Device.TPU
        if last_block.ref_count == 1:
            return None
        # Shared tail block (post-fork): copy-on-write.
        new_block = self.hbm_pool.allocate()
        block_table[-1] = new_block
        self.hbm_pool.free(last_block)
        return last_block.block_number, new_block.block_number

    def burst_blocks_needed(self, seq: Sequence, num_ahead: int) -> int:
        """Blocks to allocate so the table covers positions up to
        seq.get_len()-1+num_ahead (multi-step decode pre-reservation)."""
        table = self.block_tables[seq.seq_id]
        needed = (seq.get_len() - 1 + num_ahead) // self.block_size + 1
        return max(0, needed - len(table))

    def has_unshared_tail(self, seq: Sequence) -> bool:
        table = self.block_tables.get(seq.seq_id)
        return bool(table) and table[-1].ref_count == 1

    def reserve_slots(self, seq: Sequence, num_ahead: int) -> None:
        """Append enough fresh blocks for `num_ahead` future tokens.

        Only valid for unshared-tail sequences (no CoW can arise); the
        device computes each burst step's slot from the block table, so
        the pages must exist before the burst launches.
        """
        table = self.block_tables[seq.seq_id]
        needed = (seq.get_len() - 1 + num_ahead) // self.block_size + 1
        while len(table) < needed:
            table.append(self.hbm_pool.allocate())

    def trim_reserved(self, seq: Sequence) -> int:
        """Release look-ahead pages reserved past the sequence's
        current length (the rollback seam for reserve_slots: burst or
        speculative reservations whose tokens were never emitted).
        Only unshared TPU tail blocks are trimmed — a shared or
        swapped tail means the pages are owned by more than this
        reservation. Returns the number of pages freed."""
        table = self.block_tables.get(seq.seq_id)
        if not table or self.block_sliding_window is not None:
            return 0
        needed = (seq.get_len() - 1) // self.block_size + 1
        freed = 0
        while len(table) > needed and table[-1].ref_count == 1 and \
                table[-1].device == Device.TPU:
            self.hbm_pool.free(table.pop())
            freed += 1
        return freed

    def fork(self, parent_seq: Sequence, child_seq: Sequence) -> None:
        src_block_table = self.block_tables[parent_seq.seq_id]
        self.block_tables[child_seq.seq_id] = src_block_table.copy()
        for block in src_block_table:
            block.ref_count += 1

    # ------------------------------------------------------------------
    # Swap planning (preemption-by-swap)
    # ------------------------------------------------------------------

    def _group_physical_blocks(
            self, seq_group: SequenceGroup) -> List[PhysicalTokenBlock]:
        blocks: Set[PhysicalTokenBlock] = set()
        for seq in seq_group.get_seqs():
            if seq.is_finished():
                continue
            blocks.update(self.block_tables[seq.seq_id])
        return list(blocks)

    def can_swap_in(self, seq_group: SequenceGroup) -> bool:
        blocks = self._group_physical_blocks(seq_group)
        num_swapped_seqs = seq_group.num_seqs(status=SequenceStatus.SWAPPED)
        free = self.hbm_pool.get_num_free_blocks()
        # Each sequence will need one fresh block right after swap-in.
        required = len(blocks) + num_swapped_seqs
        return free - required >= self.watermark_blocks

    def swap_in(self, seq_group: SequenceGroup) -> Dict[int, int]:
        """Plan host->HBM copies; returns {cpu_block: hbm_block}."""
        if seq_group.prefix is not None:
            assert seq_group.prefix.allocated and seq_group.prefix.computed
        mapping: Dict[PhysicalTokenBlock, PhysicalTokenBlock] = {}
        for seq in seq_group.get_seqs(status=SequenceStatus.SWAPPED):
            new_block_table: BlockTable = []
            if seq_group.prefix is not None:
                for block in seq_group.prefix.block_table:
                    new_block_table.append(block)
                    block.ref_count += 1
            for cpu_block in self.block_tables[seq.seq_id]:
                if cpu_block in mapping:
                    hbm_block = mapping[cpu_block]
                    hbm_block.ref_count += 1
                else:
                    hbm_block = self.hbm_pool.allocate()
                    mapping[cpu_block] = hbm_block
                new_block_table.append(hbm_block)
                self.host_pool.free(cpu_block)
            self.block_tables[seq.seq_id] = new_block_table
        return {
            cpu.block_number: hbm.block_number
            for cpu, hbm in mapping.items()
        }

    def can_swap_out(self, seq_group: SequenceGroup) -> bool:
        blocks = self._group_physical_blocks(seq_group)
        return len(blocks) <= self.host_pool.get_num_free_blocks()

    def swap_out(self, seq_group: SequenceGroup) -> Dict[int, int]:
        """Plan HBM->host copies; returns {hbm_block: cpu_block}."""
        mapping: Dict[PhysicalTokenBlock, PhysicalTokenBlock] = {}
        for seq in seq_group.get_seqs(status=SequenceStatus.RUNNING):
            new_block_table: BlockTable = []
            for hbm_block in self.block_tables[seq.seq_id]:
                if (seq_group.prefix is not None
                        and hbm_block in seq_group.prefix.block_table):
                    # Shared prefix blocks stay resident on HBM.
                    self.hbm_pool.free(hbm_block)
                    continue
                if hbm_block in mapping:
                    cpu_block = mapping[hbm_block]
                    cpu_block.ref_count += 1
                else:
                    cpu_block = self.host_pool.allocate()
                    mapping[hbm_block] = cpu_block
                new_block_table.append(cpu_block)
                self.hbm_pool.free(hbm_block)
            self.block_tables[seq.seq_id] = new_block_table
        return {
            hbm.block_number: cpu.block_number
            for hbm, cpu in mapping.items()
        }

    # ------------------------------------------------------------------
    # Teardown / queries
    # ------------------------------------------------------------------

    def _free_block_table(self, block_table: BlockTable) -> None:
        # Order-preserving dedup: prefix-shared tables repeat blocks,
        # but the frees must land in table order (set order hashes by
        # id, so a reincarnated process would rebuild its free lists
        # in a different order and break the bit-equal replay).
        for block in dict.fromkeys(block_table):
            if block.device == Device.TPU:
                self.hbm_pool.free(block)
            else:
                self.host_pool.free(block)

    def free(self, seq: Sequence) -> None:
        if seq.seq_id not in self.block_tables:
            # Never scheduled, or already freed.
            return
        self._free_block_table(self.block_tables.pop(seq.seq_id))

    def free_prefix(self, prefix: Prefix) -> int:
        """Release a prefix's pin: the one refcount `allocate` added
        when it first populated the prefix's block table. Returns the
        number of pages whose pin was dropped. Idempotent via the
        un-allocated early return; pages still shared by live
        sequences survive their own tables' refs and return to the
        pool on the last sequence free."""
        if not prefix.allocated:
            return 0
        released = 0
        for block in prefix.block_table:
            self.hbm_pool.free(block)
            released += 1
        prefix.reset_block_table()
        return released

    def reset(self) -> None:
        for block_table in self.block_tables.values():
            self._free_block_table(block_table)
        self.block_tables.clear()

    def get_block_table(self, seq: Sequence) -> List[int]:
        return [b.block_number for b in self.block_tables[seq.seq_id]]

    def block_numbers(self, seq_id: int) -> List[int]:
        """Page numbers for one sequence id — the int-only projection
        callers outside this module must use (raw PhysicalTokenBlock
        objects never cross the owner boundary)."""
        return [b.block_number for b in self.block_tables[seq_id]]

    def get_num_free_gpu_blocks(self) -> int:
        return self.hbm_pool.get_num_free_blocks()

    def get_num_free_cpu_blocks(self) -> int:
        return self.host_pool.get_num_free_blocks()
