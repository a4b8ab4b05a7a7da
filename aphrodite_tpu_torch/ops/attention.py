"""Attention in plain PyTorch: dense prompt attention and the reference
paged decode attention.

Port of `aphrodite_tpu/ops/attention.py`. Both are matmuls plus a masked
softmax in float32, as XLA computed them in the JAX package; neither
calls a fused attention operator. Decode attention on the serving path
is the hand-written kernel in `ops/cuda/paged_attention.py`; the
reference here is what the tests hold it against.
"""
from __future__ import annotations

from typing import Optional

import torch

from aphrodite_tpu_torch.ops.kv_cache import gather_pages

_NEG_INF = float("-inf")


def make_causal_mask(seq_len: int, context_len: torch.Tensor, kv_len: int,
                     sliding_window: Optional[int] = None) -> torch.Tensor:
    """Boolean [batch, seq_len, kv_len] mask, True = attend. Query i of
    the chunk sits at absolute position context_len + i and attends to
    kv positions <= it (and within the sliding window if set)."""
    dev = context_len.device
    q_pos = torch.arange(seq_len, device=dev).view(1, seq_len, 1)
    kv_pos = torch.arange(kv_len, device=dev).view(1, 1, kv_len)
    abs_q = q_pos + context_len.to(torch.int64).view(-1, 1, 1)
    mask = kv_pos <= abs_q
    if sliding_window is not None:
        mask = mask & (kv_pos > (abs_q - sliding_window))
    return mask


def make_alibi_bias(alibi_slopes: torch.Tensor, kv_len: int) -> torch.Tensor:
    """[num_heads, 1, kv_len] additive bias over absolute kv position."""
    positions = torch.arange(kv_len, dtype=torch.float32,
                             device=alibi_slopes.device)
    return alibi_slopes.float().view(-1, 1, 1) * positions.view(1, 1, -1)


def prefill_attention(
    q: torch.Tensor,              # [batch, seq, num_q_heads, head_dim]
    k: torch.Tensor,              # [batch, kv_len, num_kv_heads, head_dim]
    v: torch.Tensor,
    context_lens: torch.Tensor,   # [batch] prefix lengths (0 for plain)
    kv_valid_lens: torch.Tensor,  # [batch] valid kv entries
    scale: float,
    sliding_window: Optional[int] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense causal attention for prompt chunks, GQA-aware, softmax in
    float32. Handles plain prefill (context_lens 0, kv = the chunk) and
    prefill over a cached prefix (kv = [prefix ; chunk]). Fully masked
    rows (padding queries) come out as zeros."""
    b, s, num_q_heads, d = q.shape
    kv_len, num_kv_heads = k.shape[1], k.shape[2]
    group = num_q_heads // num_kv_heads
    qg = q.float().reshape(b, s, num_kv_heads, group, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    scores = scores.reshape(b, num_q_heads, s, kv_len)

    mask = make_causal_mask(s, context_lens, kv_len, sliding_window)
    kv_pos = torch.arange(kv_len, device=q.device).view(1, 1, kv_len)
    mask = mask & (kv_pos < kv_valid_lens.to(torch.int64).view(-1, 1, 1))
    if alibi_slopes is not None:
        scores = scores + make_alibi_bias(alibi_slopes, kv_len)[None]
    scores = scores.masked_fill(~mask[:, None], _NEG_INF)
    weights = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)

    wg = weights.reshape(b, num_kv_heads, group, s, kv_len)
    out = torch.einsum("bkgst,btkd->bskgd", wg, v.float())
    return out.reshape(b, s, num_q_heads, d).to(q.dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,             # [batch, num_q_heads, head_dim]
    k_pages: torch.Tensor,       # [num_pages, page_size, Hkv * head_dim]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [batch, pages_per_seq] (OOB padded)
    context_lens: torch.Tensor,  # [batch]
    scale: float,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention over the paged cache by gathering each
    sequence's pages and running masked attention (reads the gathered
    KV a second time; the kernel avoids that)."""
    b, num_q_heads, d = q.shape
    num_kv_heads = k_pages.shape[2] // d
    group = num_q_heads // num_kv_heads
    k = gather_pages(k_pages, block_tables, num_kv_heads)  # [b,Hkv,ctx,d]
    v = gather_pages(v_pages, block_tables, num_kv_heads)
    ctx = k.shape[2]
    qg = q.float().reshape(b, num_kv_heads, group, d)
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) * scale
    if alibi_slopes is not None:
        bias = make_alibi_bias(alibi_slopes, ctx)
        scores = scores + bias.reshape(1, num_kv_heads, group, ctx)
    positions = torch.arange(ctx, device=q.device).view(1, 1, 1, ctx)
    mask = positions < context_lens.to(torch.int64).view(-1, 1, 1, 1)
    scores = scores.masked_fill(~mask, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", weights, v.float())
    return out.reshape(b, num_q_heads, d).to(q.dtype)
