"""Quantized KV-cache number formats (port of
`aphrodite_tpu/ops/kv_quant.py`).

Two 8-bit page formats besides the model's float dtype:

- fp8 (e5m2, `torch.float8_e5m2`): a straight cast on write (round to
  nearest even, overflow to inf, as the JAX cast), a cast back on read.
  No scale.
- int8: symmetric with one static scale S (value = code * S), S from
  `APHRODITE_KV_SCALE` (default 0.05). The attention kernels fold S into
  the score scale (q.k*S == (q*S).k) and the output epilogue, so the
  pages are never dequantized in memory.

The scale is owned by the CacheEngine and threaded through
`InputMetadata.kv_scale`.
"""
from __future__ import annotations

import torch

DEFAULT_KV_SCALE = 0.05

#: The page dtypes of the 8-bit formats.
KV_8BIT_DTYPES = (torch.int8, torch.float8_e5m2)


def quantize_kv(x: torch.Tensor, page_dtype: torch.dtype,
                scale: float = 1.0) -> torch.Tensor:
    """Cast activations to the cache page dtype (the write path). int8
    codes are clip(round(x / S), -127, 127) with round-half-even and an
    IEEE division (by a tensor: torch on CUDA divides by a Python scalar
    as a multiply by its reciprocal)."""
    if page_dtype == torch.int8:
        xf = x.float()
        s = torch.full((1,), float(scale), dtype=torch.float32,
                       device=x.device)
        return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return x.to(page_dtype)


def dequant_scale(page_dtype: torch.dtype, scale: float = 1.0) -> float:
    """Multiplier that turns stored page values back into activations."""
    return float(scale) if page_dtype == torch.int8 else 1.0


def byte_view(pages: torch.Tensor) -> torch.Tensor:
    """The same memory as uint8 for 8-bit pages (else `pages` itself):
    page copies, gathers and zero fills move bytes only, and CPU torch
    lacks `masked_fill`, `mul` and `index_copy_` for float8_e5m2."""
    return pages.view(torch.uint8) if pages.dtype in KV_8BIT_DTYPES \
        else pages
