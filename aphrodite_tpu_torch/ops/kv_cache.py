"""Paged KV-cache ops in plain PyTorch.

Port of `aphrodite_tpu/ops/kv_cache.py`. Layout is the JAX package's
token-major one: per layer the cache is a pair of page tensors

    k_pages, v_pages: [num_pages, page_size, num_kv_heads * head_dim]

with heads collapsed into the last dim, so one page is a contiguous
[page_size, Hkv*d] slab and one token's K (all heads) one row of it.
Unlike the JAX package, head_dim is stored unpadded: the 128-lane pad
was a Mosaic tiling constraint with no CUDA counterpart.

Host contract (unchanged): slot = page * page_size + offset, and pad
entries of slot / page-index vectors hold the out-of-range value
(num_slots, or num_pages for page ids), which every op here skips.

Updates are IN PLACE on the page tensors (the JAX package returned new,
aliased arrays); the functions still return the page tensors so callers
and tests read like the JAX originals.
"""
from __future__ import annotations

from typing import Tuple

import torch


def write_to_kv_cache(
    key: torch.Tensor,         # [num_tokens, num_kv_heads, head_dim]
    value: torch.Tensor,       # [num_tokens, num_kv_heads, head_dim]
    k_pages: torch.Tensor,     # [num_pages, page_size, Hkv * head_dim]
    v_pages: torch.Tensor,
    slot_mapping: torch.Tensor,  # [num_tokens] int32; pad with num_slots
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter each token's K/V into its cache slot (in place).

    The plain version of `reshape_and_cache`: slots >= num_slots are
    the padding no-op."""
    num_pages, page_size, hd = k_pages.shape
    num_slots = num_pages * page_size
    n = key.shape[0]
    slots = slot_mapping.to(torch.int64)
    live = (slots >= 0) & (slots < num_slots)
    idx = slots[live]
    k_pages.view(num_slots, hd)[idx] = \
        key.reshape(n, hd)[live].to(k_pages.dtype)
    v_pages.view(num_slots, hd)[idx] = \
        value.reshape(n, hd)[live].to(v_pages.dtype)
    return k_pages, v_pages


def copy_blocks(
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    src_indices: torch.Tensor,   # [num_copies] int; pad with num_pages
    dst_indices: torch.Tensor,   # [num_copies] int; pad with num_pages
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched page copies for copy-on-write forks (in place).

    Same semantics as the JAX gather-then-scatter: every source page is
    read before any destination is written; an out-of-range source
    reads zeros and an out-of-range destination is dropped."""
    num_pages = k_pages.shape[0]
    src = src_indices.to(torch.int64)
    dst = dst_indices.to(torch.int64)
    src_ok = (src >= 0) & (src < num_pages)
    dst_ok = (dst >= 0) & (dst < num_pages)
    for pages in (k_pages, v_pages):
        gathered = pages[src.clamp(0, num_pages - 1)]
        gathered[~src_ok] = 0
        pages[dst[dst_ok]] = gathered[dst_ok]
    return k_pages, v_pages


def gather_pages(
    pages: torch.Tensor,         # [num_pages, page_size, H * head_dim]
    page_indices: torch.Tensor,  # [num_seqs, pages_per_seq]; pad with OOB
    num_kv_heads: int,
) -> torch.Tensor:
    """Gather each sequence's pages -> [num_seqs, num_kv_heads,
    pages_per_seq * page_size, head_dim]; out-of-range page ids read
    zeros."""
    num_pages, page_size, hd = pages.shape
    head_dim = hd // num_kv_heads
    num_seqs, pages_per_seq = page_indices.shape
    idx = page_indices.reshape(-1).to(torch.int64)
    ok = (idx >= 0) & (idx < num_pages)
    gathered = pages[idx.clamp(0, num_pages - 1)]
    gathered = gathered * ok.view(-1, 1, 1).to(gathered.dtype)
    gathered = gathered.reshape(num_seqs, pages_per_seq * page_size,
                                num_kv_heads, head_dim)
    return gathered.permute(0, 2, 1, 3)
