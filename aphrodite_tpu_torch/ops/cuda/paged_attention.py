"""Paged decode attention: the CUDA kernels of `csrc/paged_attention.cuh`
(instantiated by `csrc/paged_attention.cu` and, for fp16 activations,
`csrc/paged_attention_f16.cu`), their plain PyTorch version, and the
host helpers the model runner shares with them.

Port of `aphrodite_tpu/ops/pallas/paged_attention.py`: one query token
per sequence attends over its pages, with GQA, optional ALiBi, and
optionally the fused write of the current token's K/V at position ctx-1
into its page (in place; the pages are returned beside the output, as
the JAX function returned its aliased page arrays). Two kernels, as the
JAX package has two grids:

- K1 (`_decode_kernel_ragged`, the ragged work-list grid): taken when
  the caller passes a work list and `APHRODITE_ATTN_RAGGED` is on (the
  default);
- K5 (`_decode_kernel_tm`, the padded (batch, head-block) grid): taken
  without a work list or with `APHRODITE_ATTN_RAGGED=0`.

`paged_decode_attention` launches one of them for CUDA tensors and runs
`paged_decode_attention_plain` for CPU tensors, and for nothing else: a
CUDA input the kernel does not take raises. Both flags are read at call
time, as the JAX function reads them.

Both are one CUDA launch: K1's grid (batch, Hkv, n_split) is the padded
grid at one kv head a block, so K5 launches K1's kernel and counts it
under its own counter. A block serves at most 16 of a kv head's query
rows; a larger group (the JAX K1 packs any group) takes ceil(group / 16)
blocks a kv head (`row_blocks`), each reading the same pages. It splits
a sequence's chunks over `choose_decode_splits` blocks (flash-decoding):
each split keeps its own online-softmax state over a contiguous run of
whole chunks, and a merge kernel (its own launch counter) combines the
splits with the same power-of-two rescale. The plain version takes the same
`num_splits` and repeats that arithmetic; at 1 split it is the
sequential walk of the Pallas body.

The plain version repeats the Pallas bodies' arithmetic, which is the
same for both grids at the same chunking: chunks of `pages_per_chunk`
pages, an online softmax in the base-2 domain whose running max is
rounded up to an integer, the rescale as an exponent-bias add (`amla`,
`APHRODITE_ATTN_AMLA`, the default) or a multiply, and dot operands
rounded to bf16 on bf16, int8 and fp8 pages (the scaled query and the
softmax weights, as the TPU's bf16 matrix products did; int8 and e5m2
values are exact in bf16). Under float16 activations (fp16, int8 or fp8
pages) the operands round to float16 instead, as the kernel's fp16
instances do: the JAX package serves fp16 pages through its f32 jnp
reference, which the tests hold this to. Float32 pages keep everything
in float32, as the JAX package's CPU route (the jnp reference) does. int8 pages
fold their scale `kv_scale` into the query and the epilogue
(`ops/kv_quant.py`). The work list is a TPU grid device: it is
validated for signature parity and changes nothing in the result.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.ops.cuda import build
from aphrodite_tpu_torch.ops.kv_quant import byte_view, quantize_kv

PAGED_DECODE_ATTENTION_LAUNCHES = build.launch_counter(
    "paged_decode_attention")
PAGED_DECODE_ATTENTION_TM_LAUNCHES = build.launch_counter(
    "paged_decode_attention_tm")
PAGED_DECODE_MERGE_LAUNCHES = build.launch_counter("paged_decode_merge")

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

# Kernel limits (csrc/paged_attention.cuh): a block serves up to 16 of a
# kv head's query rows (4 warps x 4 rows), a larger group ceil(group /
# 16) blocks (`row_blocks`); 8 lanes of head_dim per warp lane.
ROWS_PER_BLOCK = 16
_MAX_HEAD_DIM = 256
#: Block-table entries a K1 split stages in shared memory (8 KB): longer
#: tables take more splits.
_MAX_SPLIT_PAGES = 2048
_ACT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PAGE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e5m2: 3, torch.float16: 4}


def ragged_enabled() -> bool:
    """APHRODITE_ATTN_RAGGED=0 pins the padded-grid kernel (K5); on (the
    default), a call with a work list takes the ragged one (K1)."""
    return flags.get_bool("APHRODITE_ATTN_RAGGED")


def amla_enabled() -> bool:
    """APHRODITE_ATTN_AMLA=0 pins the rescale multiply; on (the
    default), the rescale is an exponent-bias add (`_mul_pow2`)."""
    return flags.get_bool("APHRODITE_ATTN_AMLA")


# ------------------------------------------------------- host helpers --

def head_block(num_kv_heads: int) -> int:
    """Largest divisor of H that is <= 8: the kv heads one cell of the
    Pallas padded grid serves (K5 on the card serves one a block)."""
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


sm_count = build.sm_count


def row_blocks(group: int) -> int:
    """K1's blocks a kv head: its query rows in blocks of 16."""
    return -(-group // ROWS_PER_BLOCK)


def choose_decode_splits(batch: int, num_kv_heads: int,
                         pages_per_seq: int, pages_per_chunk: int,
                         sms: int) -> int:
    """Splits of K1's grid (batch, Hkv, n_split) on a card with `sms`
    SMs, from shapes alone (no host sync, no data-dependent launch): 1
    where batch * Hkv blocks already cover the SMs or the table holds
    one chunk; else about two blocks per SM, each split a contiguous run
    of whole chunks, and as few splits as give that run length. Tables
    wider than `_MAX_SPLIT_PAGES` take at least as many splits as keep
    each split's entries near that (K1 stages them in shared memory).
    `pages_per_chunk` divides the table width (`clamp_pages_per_chunk`)."""
    n_chunks = pages_per_seq // pages_per_chunk
    blocks = batch * num_kv_heads
    least = -(-pages_per_seq // _MAX_SPLIT_PAGES)
    if blocks == 0 or blocks >= sms or n_chunks <= 1:
        return least
    want = max(-(-2 * sms // blocks), least)
    per_split = -(-n_chunks // want)
    return -(-n_chunks // per_split)


def wide_slots(batch: int, num_kv_heads: int, n_split: int,
               sms: int) -> bool:
    """Whether K1 stages twice the pages per ring slot: where its grid
    holds at most two blocks per SM, shared memory is plentiful and each
    block's chain of steps, not the card's bandwidth, sets the time."""
    return batch * num_kv_heads * n_split <= 2 * sms


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

def dot_operand_dtype(act: torch.dtype, page: torch.dtype) -> torch.dtype:
    """The precision of K1's dot operands (the scaled query and the
    softmax weights): f32 on f32 pages, fp16 under fp16 activations,
    else bf16."""
    if page == torch.float32:
        return torch.float32
    return torch.float16 if act == torch.float16 else torch.bfloat16


def _mul_pow2(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """x * 2**delta as an exponent-bias add (the Pallas `_mul_pow2`):
    delta is integer-valued and <= 0; entries whose exponent would
    underflow, zeros and denormals included, become 0."""
    bits = x.contiguous().view(torch.int32)
    d = torch.clamp(delta, min=-254.0).to(torch.int32)
    shifted = (bits + d * (1 << 23)).view(torch.float32)
    exp_field = (bits >> 23) & 0xFF
    return torch.where(exp_field + d > 0, shifted, torch.zeros_like(x))


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
    kv_scale: float = 1.0,
    pages_per_chunk: int = 8,
    work_items=None,
    amla: bool = True,
    num_splits: int = 1,
):
    """The Pallas bodies' arithmetic in plain PyTorch (see module doc),
    for both grids. Returns out [batch, Hq, d], or (out, k_pages,
    v_pages) with the fused write. A chunk without a live token leaves
    a row's state as it was, as K5's loop over the row's chunks does.

    `num_splits` > 1 repeats K1's split arithmetic: split s walks chunks
    [s * per, (s + 1) * per), per = ceil(chunks / num_splits), from a
    fresh state, and the splits merge as M = max_s m_s, l = sum_s
    l_s * 2^(m_s - M), acc likewise (the same exponent-bias add or
    multiply as the chunk rescale; the multiply takes exact powers of
    two, as the kernel's exp2f)."""
    batch, num_q_heads, d, num_kv_heads = _geometry(q, k_pages)
    _check_work_items(work_items)
    group = num_q_heads // num_kv_heads
    num_pages, page_size, hd = k_pages.shape
    pps = block_tables.shape[1]
    ppc = clamp_pages_per_chunk(pps, pages_per_chunk)
    n_chunks = pps // ppc
    if not 1 <= num_splits <= max(n_chunks, 1):
        raise ValueError(f"num_splits={num_splits} outside [1, {n_chunks}] "
                         f"(the table's chunks)")
    tables = block_tables.to(torch.int64).clamp(0, num_pages - 1)
    ctx = context_lens.to(torch.int64)
    dev = q.device

    if knew is not None:
        live = ctx > 0
        pos = (ctx - 1).clamp(min=0)
        page = tables.gather(1, (pos // page_size).view(-1, 1))[:, 0]
        slot = (page * page_size + pos % page_size)[live]
        for pages, new in ((k_pages, knew), (v_pages, vnew)):
            byte_view(pages).view(-1, num_kv_heads, d)[slot] = byte_view(
                quantize_kv(new[live], pages.dtype, kv_scale))

    op = dot_operand_dtype(q.dtype, k_pages.dtype)
    qs = (q.float() * (scale * kv_scale * _LOG2E)).to(op).float()
    qs = qs.view(batch, num_kv_heads, group, d)
    slopes = None if alibi_slopes is None else \
        (alibi_slopes.float().view(num_kv_heads, group, 1) * _LOG2E)
    chunk_tokens = ppc * page_size

    def attend(chunks):
        """The online softmax over `chunks` from a fresh state."""
        m = torch.full((batch, num_kv_heads, group), _NEG_INF, device=dev)
        l = torch.zeros((batch, num_kv_heads, group), device=dev)
        acc = torch.zeros((batch, num_kv_heads, group, d), device=dev)
        for c in chunks:
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
            delta = m - m_new
            p = torch.where(live, _exp2(s - m_new[..., None]),
                            torch.zeros_like(s))
            pv = torch.einsum("bkgt,btkd->bkgd", p.to(op).float(),
                              vc.float())
            if amla:
                l_new = _mul_pow2(l, delta) + p.sum(dim=-1)
                acc_new = _mul_pow2(acc, delta[..., None]) + pv
            else:
                corr = _exp2(delta)
                l_new = l * corr + p.sum(dim=-1)
                acc_new = acc * corr[..., None] + pv
            row_live = (c * chunk_tokens < ctx).view(-1, 1, 1)
            m = torch.where(row_live, m_new, m)
            l = torch.where(row_live, l_new, l)
            acc = torch.where(row_live[..., None], acc_new, acc)
        return m, l, acc

    if num_splits == 1:
        _, l, acc = attend(range(n_chunks))
    else:
        per = -(-n_chunks // num_splits)
        parts = [attend(range(s * per, min((s + 1) * per, n_chunks)))
                 for s in range(num_splits)]
        top = torch.stack([m_s for m_s, _, _ in parts]).amax(dim=0)
        l = torch.zeros_like(top)
        acc = torch.zeros((batch, num_kv_heads, group, d), device=dev)
        for m_s, l_s, acc_s in parts:
            delta = m_s - top
            if amla:
                l = l + _mul_pow2(l_s, delta)
                acc = acc + _mul_pow2(acc_s, delta[..., None])
            else:
                corr = torch.exp2(delta)
                l = l + l_s * corr
                acc = acc + acc_s * corr[..., None]
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc * (kv_scale / l_safe)[..., None]).reshape(
        batch, num_q_heads, d)
    out = out.to(q.dtype)
    if knew is not None:
        return out, k_pages, v_pages
    return out


# --------------------------------------------------------------- kernels --

@functools.lru_cache(maxsize=None)
def _entry(fp16: bool):
    """The C entry point, its argument types set once (ctypes rebuilds
    its converters on every assignment): the fp16 activations' instances
    are a library of their own (`csrc/paged_attention_f16.cu`), built
    beside the others' (`csrc/paged_attention.cu`)."""
    fn = build.library("paged_attention_f16").paged_decode_attention_f16 \
        if fp16 else build.library("paged_attention").paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 9 + \
        [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pages, v_pages, block_tables, context_lens, alibi_slopes,
            knew, vnew, *, scale: float, kv_scale: float, ppc: int,
            amla: bool, tm: bool, num_splits: Optional[int]
            ) -> torch.Tensor:
    """K1 (tm False) or K5 (tm True, the same launch under K5's
    counter), with the merge where it splits, on CUDA tensors; raises on
    inputs the kernel does not take."""
    what = "paged_decode_attention" + ("_tm" if tm else "")
    batch, num_q_heads, d, num_kv_heads = _geometry(q, k_pages)
    group = num_q_heads // num_kv_heads
    num_pages, page_size, _ = k_pages.shape
    pps = block_tables.shape[1]
    page = k_pages.dtype
    act = q.dtype
    if act not in _ACT_CODE or page not in _PAGE_CODE or \
            v_pages.dtype != page or \
            (page in _ACT_CODE and page != act):
        raise TypeError(f"{what}: q must be bf16, fp16 or f32 and the "
                        f"pages that dtype, int8 or float8_e5m2, got "
                        f"{act}/{page}/{v_pages.dtype}")
    if d > _MAX_HEAD_DIM or d * k_pages.element_size() % 16 or \
            num_kv_heads * row_blocks(group) > 65535:
        raise ValueError(f"{what}: unsupported geometry Hq={num_q_heads} "
                         f"Hkv={num_kv_heads} (group {group}) head_dim={d} "
                         f"page_size={page_size} page dtype {page} (K1 "
                         f"takes head_dim <= {_MAX_HEAD_DIM} in whole 16-byte "
                         "runs of the page dtype, and at most 65535 (kv "
                         "head, 16-row block) pairs)")
    if block_tables.dtype != torch.int32 or \
            context_lens.dtype != torch.int32 or \
            block_tables.shape[0] != batch or \
            context_lens.shape != (batch,):
        raise TypeError(f"{what}: block_tables [batch, pages] and "
                        "context_lens [batch] must be int32")
    if alibi_slopes is not None and (alibi_slopes.dtype != torch.float32
                                     or alibi_slopes.shape !=
                                     (num_q_heads,)):
        raise TypeError(f"{what}: alibi_slopes must be f32 [Hq]")
    if knew is not None and (
            knew.shape != (batch, num_kv_heads, d) or knew.dtype != act
            or vnew is None or vnew.shape != knew.shape
            or vnew.dtype != act):
        raise ValueError(f"{what}: knew/vnew must be "
                         f"[{batch}, {num_kv_heads}, {d}] {act}")
    for t in (q, k_pages, v_pages, block_tables, context_lens,
              alibi_slopes, knew, vnew):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    sms = sm_count(q.device)
    # The grid's blocks a (sequence, split): every 16-row block of every
    # kv head.
    heads_blocks = num_kv_heads * row_blocks(group)
    n_split = choose_decode_splits(batch, heads_blocks, pps, ppc, sms) \
        if num_splits is None else int(num_splits)
    if not 1 <= n_split <= max(pps // ppc, 1):
        raise ValueError(f"{what}: num_splits={n_split} outside [1, "
                         f"{pps // ppc}] (the table's chunks)")
    wide = wide_slots(batch, heads_blocks, n_split, sms)
    out = torch.empty_like(q)
    # Each split's f32 state: acc [batch, Hkv, n_split, group, d], then
    # m and l [batch, Hkv, n_split, group].
    part = torch.empty((batch * num_q_heads * n_split * (d + 2),),
                       dtype=torch.float32, device=q.device) \
        if n_split > 1 else None
    err = _entry(act == torch.float16)(
        out.data_ptr(), q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), build.ptr(alibi_slopes), build.ptr(knew),
        build.ptr(vnew), batch, num_kv_heads, group, d, num_pages,
        page_size, pps, ppc, float(scale) * float(kv_scale) * _LOG2E,
        float(kv_scale), _ACT_CODE[act], _PAGE_CODE[page], int(amla),
        n_split, int(wide), build.ptr(part), build.stream_of(q))
    (PAGED_DECODE_ATTENTION_TM_LAUNCHES if tm else
     PAGED_DECODE_ATTENTION_LAUNCHES).add()
    if n_split > 1:
        PAGED_DECODE_MERGE_LAUNCHES.add()
    build.check(err, what)
    return out


def k1_smem_bytes(page_dtype: torch.dtype, wide: bool, group: int,
                  head_dim: int, page_size: int, pages_per_chunk: int,
                  pages_per_seq: int, n_split: int) -> int:
    """K1's (and so K5's) dynamic shared memory per block as its
    launcher plans it on the current device, with narrow or wide slots
    (`wide_slots`), or -1 where no ring fits. Builds the kernels;
    card-side diagnostics."""
    fn = build.library("paged_attention").paged_decode_smem_bytes
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_longlong
    return int(fn(_PAGE_CODE[page_dtype], int(wide), group, head_dim,
                  page_size, pages_per_chunk, pages_per_seq, n_split))


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
    kv_scale: float = 1.0,
    pages_per_chunk: int = 8,
    work_items=None,
    amla=None,
    num_splits: Optional[int] = None,
):
    """Decode attention over the paged cache. Without knew/vnew returns
    out [batch, Hq, d]; with them also writes each sequence's current
    token into its page at position ctx-1 (in place, quantized to the
    page dtype) and returns (out, k_pages, v_pages).

    `kv_scale` is the pages' dequant scale (`kv_quant.dequant_scale`:
    S for int8, 1.0 otherwise). A work list selects K1 unless
    APHRODITE_ATTN_RAGGED=0; without one K5 runs. `amla` pins the
    rescale variant; None reads APHRODITE_ATTN_AMLA. Padded block-table
    entries must point at a valid page or be clamped (the kernels clamp
    them); positions >= ctx are masked. `pages_per_chunk` is clamped
    down to a divisor of the table width, as in the JAX function.
    `num_splits` is a test hook that forces the split count (None:
    `choose_decode_splits` on the card, the sequential walk on the
    CPU); the engine never passes it."""
    ppc = clamp_pages_per_chunk(block_tables.shape[1], pages_per_chunk)
    use_amla = amla_enabled() if amla is None else bool(amla)
    if build.on_cuda(q, k_pages, v_pages, block_tables, context_lens,
                     alibi_slopes, knew, vnew):
        _check_work_items(work_items)
        out = _launch(q, k_pages, v_pages, block_tables, context_lens,
                      alibi_slopes, knew, vnew, scale=scale,
                      kv_scale=kv_scale, ppc=ppc, amla=use_amla,
                      tm=work_items is None or not ragged_enabled(),
                      num_splits=num_splits)
        return (out, k_pages, v_pages) if knew is not None else out
    return paged_decode_attention_plain(
        q, k_pages, v_pages, block_tables, context_lens, alibi_slopes,
        knew, vnew, scale=scale, kv_scale=kv_scale, pages_per_chunk=ppc,
        work_items=work_items, amla=use_amla, num_splits=num_splits or 1)
