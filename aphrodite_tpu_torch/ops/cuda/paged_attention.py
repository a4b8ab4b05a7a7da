"""Paged decode attention: the CUDA kernel of `csrc/paged_attention.cu`,
its plain PyTorch version, and the host helpers the model runner shares
with it.

Port of `aphrodite_tpu/ops/pallas/paged_attention.py` (K1, the Pallas
`_decode_kernel_ragged`): one query token per sequence attends over its
pages, with GQA, optional ALiBi, and optionally the fused write of the
current token's K/V at position ctx-1 into its page (in place; the
pages are returned beside the output, as the JAX function returned its
aliased page arrays).

`paged_decode_attention` launches the kernel for CUDA tensors and runs
`paged_decode_attention_plain` for CPU tensors, and for nothing else: a
CUDA input the kernel does not take raises.

The plain version repeats the TPU kernel's arithmetic (the
`amla=False` arm): chunks of `pages_per_chunk` pages, an online softmax
in the base-2 domain whose running max is rounded up to an integer,
and dot operands rounded to the page dtype (bf16 pages round the scaled
query and the softmax weights to bf16, as the TPU kernel's bf16 matrix
products did; float32 pages keep everything in float32). The work list
is a TPU grid device: it is validated for signature parity and changes
nothing in the result.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from aphrodite_tpu_torch.ops.cuda import build

PAGED_DECODE_ATTENTION_LAUNCHES = build.launch_counter(
    "paged_decode_attention")

_LOG2E = 1.4426950408889634
_NEG_INF = -2.0 ** 30       # large-but-finite, as in the TPU kernel
_LN2 = 0.6931471805599453


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """2**x as XLA lowers it, exp(x * ln2): the Pallas kernel's weights
    then round to bf16 at the same points (torch.exp2 differs from it by
    up to 18 ulp)."""
    return torch.exp(x * _LN2)

# Work-list length buckets (kept from the JAX package so the runner pads
# its lists the same way).
_WORK_BUCKETS = [8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
                 768, 1024, 1536, 2048, 3072, 4096]

# Kernel limits (csrc/paged_attention.cu): 4 warps x 4 rows, 8 lanes of
# head_dim per warp lane.
_MAX_GROUP = 16
_MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------- host helpers --

def head_block(num_kv_heads: int) -> int:
    """Largest divisor of H that is <= 8 (the TPU kernel's per-cell head
    count; kept for parity of the runner's arithmetic)."""
    for hb in (8, 7, 6, 5, 4, 3, 2):
        if num_kv_heads % hb == 0:
            return hb
    return 1


def clamp_pages_per_chunk(pages_per_seq: int, requested: int) -> int:
    """Largest divisor of the table width that is <= the requested
    chunk size."""
    if requested < 1:
        raise ValueError(f"pages_per_chunk must be >= 1, got {requested}")
    for c in range(min(requested, pages_per_seq), 0, -1):
        if pages_per_seq % c == 0:
            return c
    return 1


def choose_pages_per_chunk(pages_per_seq: int, page_size: int,
                           batch: int) -> int:
    """The shared chunking policy of the layer and the model runner:
    largest divisor of the table width <= 8, boosted for small batches
    up to 512-token chunks."""
    ppc = next(d for d in (8, 4, 2, 1) if pages_per_seq % d == 0)
    if batch < 32:
        while ppc * 2 <= 32 and pages_per_seq % (ppc * 2) == 0 and \
                ppc * page_size < 512:
            ppc *= 2
    return ppc


def _bucket_work(n: int) -> int:
    for b in _WORK_BUCKETS:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


def build_decode_work_list(page_counts, pages_per_chunk: int,
                           pad_to: int = None):
    """Flatten per-row page counts into the ragged (sequence, chunk)
    work list: (wi_seq [NW+1], wi_chunk [NW]) int32 numpy arrays. Rows
    with 0 pages get one masked item; padding items are dead (chunk -1,
    seq = len(page_counts)); wi_seq ends with a -1 sentinel."""
    seqs, chunks = [], []
    for i, npg in enumerate(page_counts):
        n = max(1, -(-int(npg) // pages_per_chunk))
        seqs.extend([i] * n)
        chunks.extend(range(n))
    nw = len(seqs)
    padded = _bucket_work(nw) if pad_to is None else pad_to
    if padded < nw:
        raise ValueError(f"pad_to={padded} < {nw} real work items")
    dummy = len(page_counts)
    wi_seq = np.full((padded + 1,), -1, dtype=np.int32)
    wi_seq[:nw] = seqs
    wi_seq[nw:padded] = dummy
    wi_chunk = np.full((padded,), -1, dtype=np.int32)
    wi_chunk[:nw] = chunks
    return wi_seq, wi_chunk


def _check_work_items(work_items) -> None:
    if work_items is None:
        return
    wi_seq, wi_chunk = work_items
    if len(wi_seq) != len(wi_chunk) + 1:
        raise ValueError(
            f"wi_seq must carry one trailing sentinel: {len(wi_seq)=} != "
            f"{len(wi_chunk)=} + 1")


def _geometry(q, k_pages):
    batch, num_q_heads, head_dim = q.shape
    _, _, hd = k_pages.shape
    if hd % head_dim:
        raise ValueError(f"{hd=} not a multiple of {head_dim=}")
    num_kv_heads = hd // head_dim
    if num_q_heads % num_kv_heads:
        raise ValueError(f"{num_q_heads=} % {num_kv_heads=}")
    return batch, num_q_heads, head_dim, num_kv_heads


# -------------------------------------------------------- plain version --

def paged_decode_attention_plain(
    q: torch.Tensor,               # [batch, Hq, d]
    k_pages: torch.Tensor,         # [num_pages, page_size, Hkv * d]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,    # [batch, pages_per_seq] int32
    context_lens: torch.Tensor,    # [batch] int32
    alibi_slopes: Optional[torch.Tensor] = None,   # [Hq] f32
    knew: Optional[torch.Tensor] = None,           # [batch, Hkv, d]
    vnew: Optional[torch.Tensor] = None,
    *,
    scale: float,
    pages_per_chunk: int = 8,
    work_items=None,
):
    """The TPU kernel's arithmetic in plain PyTorch (see module doc).
    Returns out [batch, Hq, d], or (out, k_pages, v_pages) with the
    fused write."""
    batch, num_q_heads, d, num_kv_heads = _geometry(q, k_pages)
    _check_work_items(work_items)
    group = num_q_heads // num_kv_heads
    num_pages, page_size, hd = k_pages.shape
    pps = block_tables.shape[1]
    ppc = clamp_pages_per_chunk(pps, pages_per_chunk)
    tables = block_tables.to(torch.int64).clamp(0, num_pages - 1)
    ctx = context_lens.to(torch.int64)
    dev = q.device

    if knew is not None:
        live = ctx > 0
        pos = (ctx - 1).clamp(min=0)
        page = tables.gather(1, (pos // page_size).view(-1, 1))[:, 0]
        slot = (page * page_size + pos % page_size)[live]
        k_pages.view(-1, num_kv_heads, d)[slot] = \
            knew[live].to(k_pages.dtype)
        v_pages.view(-1, num_kv_heads, d)[slot] = \
            vnew[live].to(v_pages.dtype)

    op = k_pages.dtype              # dot operand precision
    qs = (q.float() * (scale * _LOG2E)).to(op).float()
    qs = qs.view(batch, num_kv_heads, group, d)
    slopes = None if alibi_slopes is None else \
        (alibi_slopes.float().view(num_kv_heads, group, 1) * _LOG2E)
    chunk_tokens = ppc * page_size
    m = torch.full((batch, num_kv_heads, group), _NEG_INF, device=dev)
    l = torch.zeros((batch, num_kv_heads, group), device=dev)
    acc = torch.zeros((batch, num_kv_heads, group, d), device=dev)
    for c in range(pps // ppc):
        pages = tables[:, c * ppc:(c + 1) * ppc].reshape(-1)
        kc = k_pages[pages].view(batch, chunk_tokens, num_kv_heads, d)
        vc = v_pages[pages].view(batch, chunk_tokens, num_kv_heads, d)
        s = torch.einsum("bkgd,btkd->bkgt", qs, kc.float())
        pos = c * chunk_tokens + torch.arange(chunk_tokens, device=dev)
        if slopes is not None:
            s = s + slopes * pos.float()
        live = pos.view(1, 1, 1, -1) < ctx.view(-1, 1, 1, 1)
        s = torch.where(live, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, torch.ceil(s.amax(dim=-1)))
        corr = _exp2(m - m_new)
        p = torch.where(live, _exp2(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgt,btkd->bkgd", p.to(op).float(), vc.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc * (1.0 / l_safe)[..., None]).reshape(batch, num_q_heads, d)
    out = out.to(q.dtype)
    if knew is not None:
        return out, k_pages, v_pages
    return out


# --------------------------------------------------------------- kernel --

def _paged_decode_attention_kernel(q, k_pages, v_pages, block_tables,
                                   context_lens, alibi_slopes, knew, vnew,
                                   scale: float):
    batch, num_q_heads, d, num_kv_heads = _geometry(q, k_pages)
    group = num_q_heads // num_kv_heads
    num_pages, page_size, _ = k_pages.shape
    dtype = k_pages.dtype
    if dtype not in _DTYPE_CODE or v_pages.dtype != dtype or \
            q.dtype != dtype:
        raise TypeError(f"paged_decode_attention: q and pages must share "
                        f"bf16 or f32, got {q.dtype}/{dtype}/"
                        f"{v_pages.dtype}")
    if group > _MAX_GROUP or d > _MAX_HEAD_DIM or \
            (d * k_pages.element_size()) % 16:
        raise ValueError(f"paged_decode_attention: unsupported geometry "
                         f"group={group} head_dim={d}")
    if block_tables.dtype != torch.int32 or \
            context_lens.dtype != torch.int32 or \
            block_tables.shape[0] != batch or \
            context_lens.shape != (batch,):
        raise TypeError("paged_decode_attention: block_tables [batch, "
                        "pages] and context_lens [batch] must be int32")
    if alibi_slopes is not None and (alibi_slopes.dtype != torch.float32
                                     or alibi_slopes.shape !=
                                     (num_q_heads,)):
        raise TypeError("paged_decode_attention: alibi_slopes must be "
                        "f32 [Hq]")
    if knew is not None and (
            knew.shape != (batch, num_kv_heads, d) or knew.dtype != dtype
            or vnew is None or vnew.shape != knew.shape
            or vnew.dtype != dtype):
        raise ValueError("paged_decode_attention: knew/vnew must be "
                         f"[{batch}, {num_kv_heads}, {d}] {dtype}")
    for t in (q, k_pages, v_pages, block_tables, context_lens,
              alibi_slopes, knew, vnew):
        if t is not None and not t.is_contiguous():
            raise ValueError("paged_decode_attention: inputs must be "
                             "contiguous")
    out = torch.empty_like(q)
    lib = build.library("paged_attention")
    fn = lib.paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(out.data_ptr(), q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(),
             context_lens.data_ptr(), build.ptr(alibi_slopes),
             build.ptr(knew), build.ptr(vnew), batch, num_kv_heads, group,
             d, num_pages, page_size, block_tables.shape[1],
             float(scale) * _LOG2E, _DTYPE_CODE[dtype],
             build.stream_of(q))
    PAGED_DECODE_ATTENTION_LAUNCHES.add()
    build.check(err, "paged_decode_attention")
    return out


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    alibi_slopes: Optional[torch.Tensor] = None,
    knew: Optional[torch.Tensor] = None,
    vnew: Optional[torch.Tensor] = None,
    *,
    scale: float,
    pages_per_chunk: int = 8,
    work_items=None,
):
    """Decode attention over the paged cache. Without knew/vnew returns
    out [batch, Hq, d]; with them also writes each sequence's current
    token into its page at position ctx-1 (in place) and returns
    (out, k_pages, v_pages).

    Padded block-table entries must point at a valid page or be
    clamped (the kernel clamps them); positions >= ctx are masked.
    `pages_per_chunk` and `work_items` follow the JAX signature: the
    kernel walks whole pages and needs neither."""
    if build.on_cuda(q, k_pages, v_pages, block_tables, context_lens,
                     alibi_slopes, knew, vnew):
        _check_work_items(work_items)
        out = _paged_decode_attention_kernel(
            q, k_pages, v_pages, block_tables, context_lens, alibi_slopes,
            knew, vnew, scale)
        return (out, k_pages, v_pages) if knew is not None else out
    return paged_decode_attention_plain(
        q, k_pages, v_pages, block_tables, context_lens, alibi_slopes,
        knew, vnew, scale=scale, pages_per_chunk=pages_per_chunk,
        work_items=work_items)
