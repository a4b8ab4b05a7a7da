"""KV page writers: the CUDA kernels of `csrc/kv_write.cu` and their
plain PyTorch versions.

Port of `aphrodite_tpu/ops/pallas/kv_write.py`:

- `write_kv_pages_prefill` (K2, Pallas `_prefill_write_kernel`): whole
  pages of page-aligned prompt chunks; a tail page writes its first
  `valid` rows and keeps the rest; page ids >= num_pages skip the cell.
- `write_kv_pages` (K3 with `distinct_pages=True`, Pallas
  `_decode_write_kernel`; K4 by default, Pallas `_write_kernel`): one
  row per token into its slot; slots >= num_slots skip. One CUDA scatter
  serves both entry points: tokens that share a page write different
  rows.

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
WRITE_KV_PAGES_PREFILL_LAUNCHES = build.launch_counter(
    "write_kv_pages_prefill")

_DTYPES = (torch.bfloat16, torch.float32)


def _check_rows(knew, vnew, k_pages, v_pages, index, what: str) -> int:
    """Validate the kernel's inputs; returns the row width in bytes."""
    if k_pages.dtype not in _DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{what}: pages must be bf16 or f32 and alike, "
                        f"got {k_pages.dtype}/{v_pages.dtype}")
    if knew.dtype != k_pages.dtype or vnew.dtype != k_pages.dtype:
        raise TypeError(f"{what}: knew/vnew must match the page dtype "
                        f"{k_pages.dtype}, got {knew.dtype}/{vnew.dtype}")
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
    row_bytes = hd * k_pages.element_size()
    if row_bytes % 16:
        raise ValueError(f"{what}: a row of {row_bytes} bytes is not a "
                         "multiple of the 16-byte vector")
    return row_bytes


# ------------------------------------------------ K3 / K4: slot scatter --

def write_kv_pages_plain(knew: torch.Tensor, vnew: torch.Tensor,
                         k_pages: torch.Tensor, v_pages: torch.Tensor,
                         slots: torch.Tensor) -> Pages:
    """Plain version of the slot scatter: knew/vnew [T, Hkv*d] rows into
    their slots, out-of-range slots skipped (in place)."""
    return write_to_kv_cache(knew, vnew, k_pages, v_pages, slots)


def _write_kv_pages_kernel(knew, vnew, k_pages, v_pages, slots) -> Pages:
    row_bytes = _check_rows(knew, vnew, k_pages, v_pages, slots,
                            "write_kv_pages")
    if slots.shape[0] != knew.shape[0]:
        raise ValueError("write_kv_pages: one slot per token")
    num_pages, page_size, _ = k_pages.shape
    lib = build.library("kv_write")
    fn = lib.kv_write_slots
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(k_pages.data_ptr(), v_pages.data_ptr(), knew.data_ptr(),
             vnew.data_ptr(), slots.data_ptr(), knew.shape[0],
             num_pages * page_size, row_bytes, build.stream_of(k_pages))
    WRITE_KV_PAGES_LAUNCHES.add()
    build.check(err, "write_kv_pages")
    return k_pages, v_pages


def write_kv_pages(knew: torch.Tensor, vnew: torch.Tensor,
                   k_pages: torch.Tensor, v_pages: torch.Tensor,
                   slots: torch.Tensor, *,
                   distinct_pages: bool = False) -> Pages:
    """Write token rows knew/vnew [T, Hkv*d] into their slots (in place);
    slots >= num_slots skip.

    `distinct_pages` keeps the JAX entry point's signature: there it
    selected the pipelined whole-page writer (K3) for decode batches.
    Here both cases run the same row scatter, which is right whether or
    not tokens share pages."""
    del distinct_pages
    if build.on_cuda(knew, vnew, k_pages, v_pages, slots):
        return _write_kv_pages_kernel(knew, vnew, k_pages, v_pages, slots)
    return write_kv_pages_plain(knew, vnew, k_pages, v_pages, slots)


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


def _write_kv_pages_prefill_kernel(knew, vnew, k_pages, v_pages, page_ids,
                                   valids) -> Pages:
    row_bytes = _check_rows(knew, vnew, k_pages, v_pages, page_ids,
                            "write_kv_pages_prefill")
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
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(k_pages.data_ptr(), v_pages.data_ptr(), knew.data_ptr(),
             vnew.data_ptr(), page_ids.data_ptr(), valids.data_ptr(),
             cells, num_pages, page_size, row_bytes,
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
