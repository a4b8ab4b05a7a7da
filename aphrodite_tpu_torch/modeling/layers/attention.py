"""PagedAttention layer: KV-cache write and prefill/decode dispatch.

Port of `aphrodite_tpu/modeling/layers/attention.py` (routing at
`:63-146`), without the 128-lane head pad, ring prefill and tp paths:

- prompt: whole-page writer K2 (`write_kv_pages_prefill`) when the
  runner built page-aligned `prefill_cells`, else the slot scatter K4
  (`write_kv_pages`); then dense causal attention in plain PyTorch,
  over [cached prefix ; chunk] gathered from the pages when the chunk
  continues a prefix;
- decode: the paged decode kernel K1 with the current token's K/V write
  fused in, under the same precondition as the JAX layer
  (`_fused_decode_ok`: no sliding window, no speculative verify);
  otherwise the slot writer and a read-only K1.

The ops run their CUDA kernels on CUDA tensors and their plain versions
on CPU tensors. Page tensors are updated in place and returned.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.modeling.input_metadata import InputMetadata
from aphrodite_tpu_torch.ops.attention import prefill_attention
from aphrodite_tpu_torch.ops.cuda.kv_write import (write_kv_pages,
                                                   write_kv_pages_prefill)
from aphrodite_tpu_torch.ops.cuda.paged_attention import (
    choose_pages_per_chunk, paged_decode_attention)
from aphrodite_tpu_torch.ops.kv_cache import gather_pages

_PAGE_DTYPES = (torch.bfloat16, torch.float32)


class PagedAttention:
    """Stateless attention dispatcher (all state is in the KV pages)."""

    def __init__(
        self,
        num_heads: int,
        head_size: int,
        scale: float,
        num_kv_heads: Optional[int] = None,
        alibi_slopes: Optional[np.ndarray] = None,
        sliding_window: Optional[int] = None,
    ) -> None:
        self.num_heads = num_heads
        self.head_size = head_size
        self.scale = float(scale)
        self.num_kv_heads = num_kv_heads if num_kv_heads is not None \
            else num_heads
        self.alibi_slopes = None if alibi_slopes is None else \
            torch.as_tensor(np.asarray(alibi_slopes, dtype=np.float32))
        self.sliding_window = sliding_window

    def _slopes_on(self, device: torch.device) -> Optional[torch.Tensor]:
        if self.alibi_slopes is None:
            return None
        if self.alibi_slopes.device != device:
            self.alibi_slopes = self.alibi_slopes.to(device)
        return self.alibi_slopes

    def __call__(
        self,
        q: torch.Tensor,              # [batch, seq, num_heads * head_size]
        k: torch.Tensor,              # [batch, seq, num_kv_heads * head]
        v: torch.Tensor,
        k_pages: Optional[torch.Tensor],
        v_pages: Optional[torch.Tensor],
        metadata: InputMetadata,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
               Optional[torch.Tensor]]:
        """Returns (attn_out [batch, seq, num_heads*head_size], k_pages,
        v_pages). k_pages=None runs cache-less prefill (the executor's
        memory profile run)."""
        batch, seq_len, _ = q.shape
        hd = self.num_kv_heads * self.head_size
        q = q.reshape(batch, seq_len, self.num_heads, self.head_size)
        k = k.reshape(batch, seq_len, self.num_kv_heads, self.head_size)
        v = v.reshape(batch, seq_len, self.num_kv_heads, self.head_size)

        fused_decode = self._fused_decode_ok(k_pages, metadata)
        if k_pages is not None and not fused_decode:
            flat_k = k.reshape(-1, hd).contiguous()
            flat_v = v.reshape(-1, hd).contiguous()
            if metadata.is_prompt and metadata.prefill_cells is not None:
                pid, sblk, vld = metadata.prefill_cells
                k_pages, v_pages = write_kv_pages_prefill(
                    flat_k, flat_v, k_pages, v_pages, pid, sblk, vld)
            else:
                k_pages, v_pages = write_kv_pages(
                    flat_k, flat_v, k_pages, v_pages,
                    metadata.slot_mapping,
                    distinct_pages=(not metadata.is_prompt and
                                    not metadata.spec_verify))

        if metadata.is_prompt:
            out = self._prefill(q, k, v, k_pages, v_pages, metadata)
        elif fused_decode:
            out, k_pages, v_pages = self._decode(
                q, k_pages, v_pages, metadata,
                knew=k.reshape(batch, self.num_kv_heads,
                               self.head_size).contiguous(),
                vnew=v.reshape(batch, self.num_kv_heads,
                               self.head_size).contiguous())
        else:
            out = self._decode(q, k_pages, v_pages, metadata)
        return (out.reshape(batch, seq_len,
                            self.num_heads * self.head_size),
                k_pages, v_pages)

    def _fused_decode_ok(self, k_pages, metadata) -> bool:
        """Routing precondition for the fused in-kernel KV write (see
        the JAX layer): sliding-window models write a rotating slot and
        speculative verify rows share pages, so both keep the slot
        writer."""
        return (k_pages is not None and
                not metadata.is_prompt and
                not metadata.spec_verify and
                self.sliding_window is None and
                k_pages.dtype in _PAGE_DTYPES and
                metadata.tp == 1)

    def _prefill(self, q, k, v, k_pages, v_pages,
                 metadata: InputMetadata) -> torch.Tensor:
        batch, seq_len = q.shape[:2]
        prompt_lens = metadata.prompt_lens
        if prompt_lens is None:
            prompt_lens = torch.full((batch,), seq_len, dtype=torch.int32,
                                     device=q.device)
        if metadata.use_prefix:
            # Attend over [cached prefix ; this chunk] read back from the
            # pages (this chunk's KV was written above).
            kv_k = gather_pages(k_pages, metadata.block_tables,
                                self.num_kv_heads).transpose(1, 2)
            kv_v = gather_pages(v_pages, metadata.block_tables,
                                self.num_kv_heads).transpose(1, 2)
            context_lens = metadata.context_lens
            kv_valid = context_lens + prompt_lens
        else:
            kv_k, kv_v = k, v
            context_lens = torch.zeros((batch,), dtype=torch.int32,
                                       device=q.device)
            kv_valid = prompt_lens
        return prefill_attention(
            q, kv_k, kv_v, context_lens, kv_valid, self.scale,
            sliding_window=self.sliding_window,
            alibi_slopes=self._slopes_on(q.device))

    def _decode(self, q, k_pages, v_pages, metadata: InputMetadata,
                knew=None, vnew=None):
        q3 = q.reshape(q.shape[0], self.num_heads,
                       self.head_size).contiguous()
        # Padded table entries hold an out-of-range page id; the kernel
        # reads pages raw, so clamp pads to a valid page (masked by ctx).
        tables = metadata.block_tables.clamp(max=k_pages.shape[0] - 1)
        work = metadata.decode_work
        if work is not None and metadata.decode_ppc:
            ppc = metadata.decode_ppc
        else:
            work = None
            ppc = choose_pages_per_chunk(tables.shape[1], k_pages.shape[1],
                                         q3.shape[0])
        result = paged_decode_attention(
            q3, k_pages, v_pages, tables, metadata.context_lens,
            self._slopes_on(q.device), knew, vnew, scale=self.scale,
            pages_per_chunk=ppc, work_items=work)
        if knew is not None:
            out, k_pages, v_pages = result
            return out[:, None], k_pages, v_pages
        return result[:, None]    # [batch, 1, H, d]
