"""KV page writers: the CUDA kernels of `csrc/kv_write.cu` and their
plain PyTorch versions.

Port of `aphrodite_tpu/ops/pallas/kv_write.py`:

- `write_kv_pages_prefill` (K2, Pallas `_prefill_write_kernel`): whole
  pages of page-aligned prompt chunks; a tail page writes its first
  `valid` rows and keeps the rest; page ids >= num_pages skip the cell.
  A grid of (cell, group of rows) blocks, planned by
  `prefill_write_plan` from the page's geometry alone, each thread
  loading its K and V vectors of a round before it stores one.
- `write_kv_pages` (K3 with `distinct_pages=True`, Pallas
  `_decode_write_kernel`; K4 by default, Pallas `_write_kernel`): one
  row per token into its slot; slots >= num_slots skip. One CUDA scatter
  serves both entry points (tokens that share a page write different
  rows); each counts its launches under its own name. Blocks of tokens
  planned by `slot_write_plan` from the token count, the row's bytes
  and the SM count, each thread loading its K and V vectors of a round
  before it stores one. It takes the model's bf16, fp16 or f32 rows
  and, on int8 and fp8 pages, quantizes them itself (the rules of
  `ops/kv_quant.quantize_kv`, which the plain version runs): one launch
  a layer. Two tokens must not share a slot: the scatter runs them in
  parallel.

Each public function launches the kernel for CUDA tensors and runs the
plain version for CPU tensors, and for nothing else: a CUDA tensor the
kernel does not take raises. Pages are updated IN PLACE (the JAX
kernels aliased their outputs); the page tensors are returned so
callers read like the JAX originals.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.ops.cuda import build
from aphrodite_tpu_torch.ops.kv_cache import write_to_kv_cache

Pages = Tuple[torch.Tensor, torch.Tensor]

WRITE_KV_PAGES_LAUNCHES = build.launch_counter("write_kv_pages")
WRITE_KV_PAGES_DECODE_LAUNCHES = build.launch_counter(
    "write_kv_pages_decode")
WRITE_KV_PAGES_PREFILL_LAUNCHES = build.launch_counter(
    "write_kv_pages_prefill")

# K2's page dtypes (uint8: the byte view of int8 / fp8 pages); its
# source rows are of the page dtype. It copies 16-byte vectors, so fp16
# pages are the bf16 path byte for byte.
_DTYPES = (torch.bfloat16, torch.float16, torch.float32, torch.uint8)
# K2: threads a block at most, and the 16-byte vectors of K (and as many
# of V) each loads in a round before its stores (`kPrefillVecs`).
PREFILL_THREADS = 256
PREFILL_VECS = 4
# K3 / K4: the (source, page) dtype pairs the slot writer takes, as the
# kernel's `kind` (csrc/kv_write.cu `Kind`): copies, and bf16, fp16 or
# f32 rows quantized to int8 or fp8 e5m2 pages.
SLOT_KINDS = {
    (torch.bfloat16, torch.bfloat16): 0,
    (torch.float16, torch.float16): 0,
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.int8): 1,
    (torch.float32, torch.int8): 2,
    (torch.bfloat16, torch.float8_e5m2): 3,
    (torch.float32, torch.float8_e5m2): 4,
    (torch.float16, torch.int8): 5,
    (torch.float16, torch.float8_e5m2): 6,
}
# K3 / K4: threads a block at most, the 16-byte source vectors of K (and
# as many of V) each loads in a round before its stores (`kSlotVecs`),
# and the token count from which a block reads its slots before its data
# rather than beside it: where the two orders cross on a padded prompt
# round of a third live rows, bf16 and int8 pages (NVIDIA H100 80GB
# HBM3, `tools/time_kv_write.py --sweep`; PERF.md). On rounds of live
# rows alone reading beside stays 0.2-0.5 us faster.
SLOT_THREADS = 256
SLOT_VECS = 4
SLOT_FIRST_MIN_TOKENS = 512


def _check_rows(knew, vnew, k_pages, v_pages, index, what: str,
                pairs) -> int:
    """Validate the kernel's inputs against the (source, page) dtype
    pairs it takes; returns a page row's width in bytes."""
    if v_pages.dtype != k_pages.dtype or vnew.dtype != knew.dtype or \
            (knew.dtype, k_pages.dtype) not in pairs:
        raise TypeError(f"{what}: takes (rows, pages) dtypes "
                        f"{sorted({(str(a), str(b)) for a, b in pairs})}, "
                        f"got {knew.dtype}/{vnew.dtype} rows and "
                        f"{k_pages.dtype}/{v_pages.dtype} pages")
    if k_pages.shape != v_pages.shape or k_pages.dim() != 3:
        raise ValueError(f"{what}: pages must be [P, S, H*d] and alike")
    hd = k_pages.shape[2]
    if knew.dim() != 2 or knew.shape[1] != hd or vnew.shape != knew.shape:
        raise ValueError(f"{what}: knew/vnew must be [rows, {hd}], got "
                         f"{tuple(knew.shape)}/{tuple(vnew.shape)}")
    if index.dtype != torch.int32 or index.dim() != 1:
        raise TypeError(f"{what}: index vectors must be 1-D int32")
    for t in (knew, vnew, k_pages, v_pages, index):
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (knew, vnew, k_pages, v_pages)):
        raise ValueError(f"{what}: rows and pages must start on a "
                         "16-byte boundary")
    row_bytes = hd * k_pages.element_size()
    if row_bytes % 16:
        raise ValueError(f"{what}: a row of {row_bytes} bytes is not a "
                         "multiple of the 16-byte vector")
    return row_bytes


# ------------------------------------------------ K3 / K4: slot scatter --

def write_kv_pages_plain(knew: torch.Tensor, vnew: torch.Tensor,
                         k_pages: torch.Tensor, v_pages: torch.Tensor,
                         slots: torch.Tensor,
                         kv_scale: float = 1.0) -> Pages:
    """Plain version of the slot scatter: knew/vnew [T, Hkv*d] rows into
    their slots, quantized to the page dtype, out-of-range slots skipped
    (in place)."""
    return write_to_kv_cache(knew, vnew, k_pages, v_pages, slots,
                             kv_scale=kv_scale)


def slot_write_plan(num_tokens: int, row_bytes: int,
                    sms: int) -> Tuple[int, int, bool]:
    """(rows a block, threads a block, slots read first) of K3 / K4's
    launch, grid ceil(num_tokens / rows), from shapes and the SM count
    alone (no host sync, so a CUDA graph can capture the launch).
    `row_bytes` is one source row's (a token's K in the model's dtype),
    which sets a thread's loads whatever the page dtype. Rows: as many as
    one round of `SLOT_THREADS` threads at `SLOT_VECS` source vectors
    each covers (8 of 2048 bytes: Mistral-7B's 8 kv heads in bf16), but
    no more than spread the tokens over every SM, nor than the threads
    (a thread reads one slot); threads: the fewest whole warps, up to
    `SLOT_THREADS`, that take the block's vectors in one round (rows
    wider than a round take several) and its slots. The slots are read
    before the data from `SLOT_FIRST_MIN_TOKENS` tokens on, else beside
    it."""
    row_vecs = row_bytes // 16
    round_rows = max(1, SLOT_THREADS * SLOT_VECS // row_vecs)
    rows = max(1, min(round_rows, -(-num_tokens // sms), SLOT_THREADS))
    warps = max(-(-rows * row_vecs // (32 * SLOT_VECS)), -(-rows // 32))
    return (rows, min(SLOT_THREADS, 32 * warps),
            num_tokens >= SLOT_FIRST_MIN_TOKENS)


def _write_kv_pages_kernel(knew, vnew, k_pages, v_pages, slots, counter,
                           kv_scale: float) -> Pages:
    row_bytes = _check_rows(knew, vnew, k_pages, v_pages, slots,
                            counter.name, SLOT_KINDS)
    num_tokens = knew.shape[0]
    if slots.shape[0] != num_tokens:
        raise ValueError(f"{counter.name}: one slot per token")
    if num_tokens == 0:
        return k_pages, v_pages
    num_pages, page_size, _ = k_pages.shape
    rows, threads, first = slot_write_plan(
        num_tokens, knew.shape[1] * knew.element_size(),
        build.sm_count(knew.device))
    fn = build.library("kv_write").kv_write_slots
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(k_pages.data_ptr(), v_pages.data_ptr(), knew.data_ptr(),
             vnew.data_ptr(), slots.data_ptr(), num_tokens,
             num_pages * page_size, row_bytes,
             SLOT_KINDS[(knew.dtype, k_pages.dtype)], rows, threads,
             int(first), float(kv_scale), build.stream_of(k_pages))
    counter.add()
    build.check(err, counter.name)
    return k_pages, v_pages


def write_kv_pages(knew: torch.Tensor, vnew: torch.Tensor,
                   k_pages: torch.Tensor, v_pages: torch.Tensor,
                   slots: torch.Tensor, *,
                   distinct_pages: bool = False,
                   kv_scale: float = 1.0) -> Pages:
    """Write token rows knew/vnew [T, Hkv*d] into their slots (in place,
    quantized to the page dtype with `kv_scale` for int8); slots >=
    num_slots skip.

    `distinct_pages` is the JAX entry point's: there it selected the
    pipelined whole-page writer (K3) for decode batches. Here both cases
    run the same row scatter, which is right whether or not tokens share
    pages; the flag picks the launch counter (K3's or K4's)."""
    if not build.on_cuda(knew, vnew, k_pages, v_pages, slots):
        return write_kv_pages_plain(knew, vnew, k_pages, v_pages, slots,
                                    kv_scale)
    counter = WRITE_KV_PAGES_DECODE_LAUNCHES if distinct_pages else \
        WRITE_KV_PAGES_LAUNCHES
    return _write_kv_pages_kernel(knew, vnew, k_pages, v_pages, slots,
                                  counter, kv_scale)


# --------------------------------------------- K2: prefill page writer --

def _check_identity_src(src_blocks, page_ids, num_pages: int) -> None:
    """The cell layout contract: cell c reads source rows
    [c*page_size, (c+1)*page_size), i.e. src_blocks is the identity on
    every live cell. src_blocks is never needed on the card, so callers
    pass it on the host and the check costs no synchronisation. With
    page ids on the card (where reading them would synchronise) every
    cell must be the identity, which the model runner's layout is."""
    src = src_blocks.cpu().numpy() if torch.is_tensor(src_blocks) \
        else np.asarray(src_blocks)
    if torch.is_tensor(page_ids) and page_ids.is_cuda:
        live = np.ones(src.shape, dtype=bool)
    else:
        ids = page_ids.numpy() if torch.is_tensor(page_ids) \
            else np.asarray(page_ids)
        live = ids < num_pages
    if not (src[live] == np.arange(len(src))[live]).all():
        raise ValueError(
            "write_kv_pages_prefill requires identity src_blocks "
            "(cell c reads knew rows [c*page_size, (c+1)*page_size))")


def write_kv_pages_prefill_plain(knew: torch.Tensor, vnew: torch.Tensor,
                                 k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_ids: torch.Tensor,
                                 valids: torch.Tensor) -> Pages:
    """Plain version of the prefill page writer (in place)."""
    num_pages, page_size, hd = k_pages.shape
    cells = page_ids.shape[0]
    rows = torch.arange(page_size, device=k_pages.device).view(1, -1)
    pid = page_ids.to(torch.int64)
    live = (pid >= 0) & (pid < num_pages)
    take = live.view(-1, 1) & (rows < valids.to(torch.int64).view(-1, 1))
    slots = pid.view(-1, 1) * page_size + rows            # [cells, S]
    take = take.reshape(-1)
    idx = slots.reshape(-1)[take]
    src = knew.reshape(cells * page_size, hd)
    k_pages.view(-1, hd)[idx] = src[take].to(k_pages.dtype)
    v_pages.view(-1, hd)[idx] = \
        vnew.reshape(cells * page_size, hd)[take].to(v_pages.dtype)
    return k_pages, v_pages


def prefill_write_plan(page_size: int, row_bytes: int) -> Tuple[int, int]:
    """(rows a block, threads a block) of K2's launch, grid (cells,
    ceil(page_size / rows)), from the page's geometry alone (no host
    sync, so a CUDA graph can capture the launch): as many rows as one
    round of `PREFILL_THREADS` threads at `PREFILL_VECS` vectors each
    covers (8 rows of 2048 bytes: Mistral-7B's 8 kv heads in bf16), at
    least one and at most the page, and the fewest whole warps, up to
    `PREFILL_THREADS`, that take the block's vectors in one round (rows
    wider than a round take several)."""
    row_vecs = row_bytes // 16
    round_vecs = PREFILL_THREADS * PREFILL_VECS
    rows = max(1, min(page_size, round_vecs // row_vecs))
    warps = -(-rows * row_vecs // (32 * PREFILL_VECS))
    return rows, min(PREFILL_THREADS, 32 * warps)


def _write_kv_pages_prefill_kernel(knew, vnew, k_pages, v_pages, page_ids,
                                   valids) -> Pages:
    row_bytes = _check_rows(knew, vnew, k_pages, v_pages, page_ids,
                            "write_kv_pages_prefill",
                            {(d, d) for d in _DTYPES})
    num_pages, page_size, _ = k_pages.shape
    cells = page_ids.shape[0]
    if valids.shape != page_ids.shape or valids.dtype != torch.int32 or \
            not valids.is_contiguous():
        raise ValueError("write_kv_pages_prefill: valids must be "
                         "contiguous int32 like page_ids")
    if knew.shape[0] != cells * page_size:
        raise ValueError(f"write_kv_pages_prefill: {cells} cells need "
                         f"{cells * page_size} source rows, got "
                         f"{knew.shape[0]}")
    lib = build.library("kv_write")
    fn = lib.kv_write_prefill
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(k_pages.data_ptr(), v_pages.data_ptr(), knew.data_ptr(),
             vnew.data_ptr(), page_ids.data_ptr(), valids.data_ptr(),
             cells, num_pages, page_size, row_bytes,
             *prefill_write_plan(page_size, row_bytes),
             build.stream_of(k_pages))
    WRITE_KV_PAGES_PREFILL_LAUNCHES.add()
    build.check(err, "write_kv_pages_prefill")
    return k_pages, v_pages


def write_kv_pages_prefill(knew: torch.Tensor, vnew: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_ids: torch.Tensor, src_blocks,
                           valids: torch.Tensor) -> Pages:
    """Whole-page prompt writer (in place): cell c writes rows
    [0, valids[c]) of knew/vnew rows [c*S, (c+1)*S) into page
    page_ids[c]; page ids >= num_pages skip the cell. `src_blocks`
    must be the identity (checked here, on the host)."""
    _check_identity_src(src_blocks, page_ids, k_pages.shape[0])
    if build.on_cuda(knew, vnew, k_pages, v_pages, page_ids, valids):
        return _write_kv_pages_prefill_kernel(knew, vnew, k_pages, v_pages,
                                              page_ids, valids)
    return write_kv_pages_prefill_plain(knew, vnew, k_pages, v_pages,
                                        page_ids, valids)
