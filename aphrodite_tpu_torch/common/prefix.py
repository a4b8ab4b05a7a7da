"""Prefix-cache pool: block-aligned shared prompt prefixes.

A hash-keyed pool of prompt prefixes whose KV pages are shared between
requests that declare a common prefix via the `prefix_pos` API field
(reference semantics: `aphrodite/common/prefix.py:6,50,73`). Prefix
length is truncated to a multiple of the page size so shared KV pages
align with the paged cache.

Ownership: a prefix's `block_table` holds raw `PhysicalTokenBlock`
objects and is populated/released ONLY by the block manager
(`BlockSpaceManager.allocate` pins one extra ref per page;
`BlockSpaceManager.free_prefix` drops it). This module never touches
refcounts itself — it only carries the table and projects it to page
numbers. `PrefixPool.clear()` hands its entries back to the caller so
the pins can be routed through `free_prefix` (wired into
`Scheduler.clear_prefixes`, which `reincarnate()` runs on the torn-down
scheduler so a rebuilt pool can never resurrect stale pins), and
`pinned_pages()` is the accounting gauge the `/health` overload section
and the bench's exact `kv_leak_pages` check read.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from aphrodite_tpu_torch.common.block import BlockTable


class Prefix:
    """A prompt prefix (page-aligned) that can be shared across requests."""

    def __init__(self, token_ids: Sequence[int], block_size: int) -> None:
        self.token_ids = tuple(token_ids)
        self.block_size = block_size
        self.length = len(token_ids)
        self.hash = hash(self.token_ids)
        assert self.length % block_size == 0
        self.block_table: Optional[BlockTable] = None
        self.computed = False

    @property
    def allocated(self) -> bool:
        return self.block_table is not None

    def get_num_blocks(self) -> int:
        return self.length // self.block_size

    def get_block_numbers(self) -> List[int]:
        assert self.block_table is not None
        return [block.block_number for block in self.block_table]

    def get_length(self) -> int:
        return self.length

    def __hash__(self) -> int:
        return self.hash

    def set_block_table(self, block_table: BlockTable) -> None:
        self.block_table = block_table.copy()

    def reset_block_table(self) -> None:
        """Forget the (already-released) pages; the prefix recomputes
        on next use. Called by `BlockSpaceManager.free_prefix` after it
        dropped the pin refs."""
        self.block_table = None
        self.computed = False


class PrefixPool:
    """Pool of unique prefixes, keyed by token-tuple hash."""

    def __init__(self, block_size: int) -> None:
        self.prefixes: Dict[int, Prefix] = {}
        self.block_size = block_size

    def _truncate_token_ids(self, token_ids: Sequence[int]) -> Tuple[int, ...]:
        new_length = len(token_ids) // self.block_size * self.block_size
        return tuple(token_ids[:new_length])

    def intern(self, token_ids: Sequence[int]) -> Optional[Prefix]:
        """The pool's one insert/lookup seam: truncate to a page
        multiple and return the pooled prefix (None when nothing
        page-aligned remains)."""
        token_ids = self._truncate_token_ids(token_ids)
        if len(token_ids) == 0:
            # Prefix is empty.
            return None
        prefix = Prefix(token_ids, self.block_size)
        prefix_hash = hash(prefix)
        if prefix_hash not in self.prefixes:
            self.prefixes[prefix_hash] = prefix
        return self.prefixes[prefix_hash]

    # Reference-parity alias for `intern`.
    add_or_get_prefix = intern

    def pinned_pages(self) -> int:
        """Pages currently pinned by allocated prefixes — the
        `aphrodite:prefix_pinned_pages` gauge, and the exact correction
        the bench's zero-leak check applies to `free0`."""
        return sum(p.get_num_blocks() for p in self.prefixes.values()
                   if p.allocated)

    def clear(self) -> List[Prefix]:
        """Empty the pool, RETURNING the entries so the caller can
        route still-pinned pages through
        `BlockSpaceManager.free_prefix` (ownership of the pins
        transfers with the return — dropping them un-freed would leak
        the pinned pages)."""
        entries = list(self.prefixes.values())
        self.prefixes.clear()
        return entries
