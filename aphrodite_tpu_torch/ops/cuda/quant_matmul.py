"""GPTQ, AWQ and GGUF quantized matmuls and int8 activation
quantization: the CUDA kernels of `csrc/quant_matmul.cu` and their plain
PyTorch versions.

Port of the GPTQ, AWQ and GGUF parts of
`aphrodite_tpu/ops/pallas/quant_matmul.py`:

- `gptq_matmul` (W4A16, 4 or 8 bits): y = x @ dequant(W). At m <= 64
  (decode steps) the weight-streaming kernel (K7, Pallas
  `_stream_kernel`), else the tiled kernel (K6, Pallas `_kernel`):
  128 x 256 output tiles with warpgroup MMA, the groups split over
  blocks where the tiles fall short of the SMs (`gemm_plan`).
- `gptq_matmul_a8` (W4A8, 4 bits): x quantized per row to int8 (K9),
  then integer dots per quantization group rescaled in f32: the skinny
  kernel's a8 arm (K7) at m <= 64, else K8 (Pallas `_gptq_a8_kernel`
  and `_gptq_a8_deferred_kernel`; the two bodies differ only in f32
  summation order and one kernel computes both, so `deferred` is
  accepted and has no effect): K15's `w8a8_gemm_kernel` (s8 warpgroup
  MMA, 128 x 128 tiles, a per-group fold) with a 4-bit decoder, each
  group cut into 128-row chunks and split over runs of chunks where the
  tiles fall short of the SMs (`a8_gemm_plan`).
- `awq_matmul` (W4A16, AWQ layout): K7's AWQ layout at m <= 64, else
  K10 (Pallas `_awq_kernel`; K6's kernel and plan in the AWQ layout).
- `awq_matmul_a8` (W4A8, AWQ layout): K9, then K7's AWQ a8 arm at
  m <= 64, else K11 (Pallas `_awq_a8_kernel` and
  `_awq_a8_deferred_kernel`, again one kernel for both bodies): K8's
  kernel and plan with a nibble-transposing decoder.
- `quantize_activations_int8` (K9, Pallas `_quant8_kernel`): per-row
  xs = max(absmax, 1e-8) / 127 and x8 = clip(round(x / xs), -127, 127),
  rounding half to even. One block a row reads it once in 16-byte loads
  into registers (`quant8_plan`: threads and runs a thread from m, K and
  the SM count), or element by element where the row is not whole
  aligned 16-byte runs.
- GGUF at-rest forms, int8 weights qs [K, N] with a scale row per group
  of G input rows (scales [K/G, N]), no zero point:
  `gguf_q8_matmul` (K13, Pallas `_gguf_q8_kernel`; Q8_0, G 32) and
  `gguf_i8g_matmul` (K14, Pallas `_gguf_i8g_kernel`; grouped int8, G
  16) dequantize in the tile, (q * d) rounded to x's dtype, then bf16
  products with f32 sums; `gguf_w8a8_matmul` (K15, Pallas
  `_gguf_w8a8_kernel`; the turbo form, G 128) runs K9 on x, then per
  128-row group an exact int32 dot times the group's scale row added in
  f32 in group order, times xs at the end. Up to `Q8_STREAM_M_MAX` (16),
  `I8G_STREAM_M_MAX` (13) and `K15_STREAM_M_MAX` (12) rows (the Pallas
  wrappers have no skinny variant) K13, K14 and K15 run K7's
  `quant_stream_kernel` with a byte decoder (each ring stage a block's
  128 columns of 128 k rows and their four d, eight d16 or one s128
  rows; K15 on its a8 arm, s8 products of K9's rows), planned by
  `stream_plan` over 32-row units at 8 bits (K15: 128-row groups, int8
  x). Above they take the warpgroup-MMA kernels: K13 and K14 K6's
  `quant_gemm_kernel` with a byte decoder (128 x 256 tiles), K15
  `w8a8_gemm_kernel` (s8 wgmma, a per-group fold, 128 x 128 tiles),
  each split over runs of whole 64-row chunks (K13, K14) or 128-row
  groups (K15) by `gemm_plan` where the tiles fall short of the SMs.
- `gguf_q4k_matmul` (K12, Pallas `_gguf_q4k_kernel`; GGUF's exact Q4_K
  form): 4-bit codes qweight [K/8, N] (8 along K), w = q * dl - ml with
  affine rows dl, ml [K/32, N] per 32 input rows, taken in f32 and
  rounded to x's dtype; bf16 products with f32 sums. At m <= 64 K7's
  `quant_stream_kernel` with K12's decoder (GPTQ's word map, a (dl, ml)
  pair per 32 rows in place of the scale and zero rows), planned by
  `stream_plan` over 32-row units; above, K6's `quant_gemm_kernel` with
  the same words, planned as K13's.
- `squeezellm_matmul` (K16, Pallas `_sqllm_kernel`): the same 4-bit
  packing, w[k, n] = lut[n, q[k, n]] with a 16-entry codebook per output
  column. bf16 x and codebook (SqueezeLLM): at m <= 64 K7's
  `quant_stream_kernel` with a codebook decoder (the block's codebook
  in shared memory, laid out so a warp's lookups hit 32 banks), planned
  by `stream_plan`; above, K6's `quant_gemm_kernel` with a codebook
  decoder, planned as K13's. f32 x and codebook (QuIP#'s 4-bit at-rest
  form): the same two kernels, whose products reach f32 accuracy by
  three bf16 products per term (x_lo w_hi + x_hi w_lo + x_hi w_hi) with
  f32 sums, x and the codebook split once into bf16 hi and lo: at m <=
  64 x is split as it is staged; above, a pass splits x into a bf16
  scratch [2m, K] and `quant_gemm_kernel` runs 128 x 128 tiles with hi
  and lo W tiles (`gemm_plan` with 128-column tiles); the output is f32.
- `int8_matmul` (K17, Pallas `_int8_kernel`): y = (x @ int8 W [K, N]) *
  scales[N], the codes exact in bf16, the f32 sum times the column's
  f32 scale, then rounded. Up to `INT8_STREAM_M_MAX` (16) rows K7's
  `quant_stream_kernel` with K13's bytes and no scale rows, planned as
  K13's; above, K6's `quant_gemm_kernel` with the same bytes, planned as
  K13's; both apply the column scales in their epilogue, or in the
  split reduce.

Layouts, as the checkpoints store them; scales [G, N], G = K //
group_size, row k in group k // group_size (the kernels' contiguous
groups):
- GPTQ (AutoGPTQ v1): qweight [K/pack, N] int32 with pack = 32 // bits
  codes along K (row k in word k // pack at shift bits * (k % pack)),
  qzeros [G, N/pack] int32 packed along N. w[k, n] = (q - (z + 1)) * s.
  Like the Pallas kernels, these functions do not read g_idx (see
  `modeling/layers/quantization/gptq.py`).
- AWQ (llm-awq, 4 bits): qweight [K, N/8] int32 with 8 codes along N,
  interleaved (column 8j + e at shift 4 * AWQ_ORDER[e]), qzeros [G, N/8]
  packed the same way. w[k, n] = (q - z) * s, the zero as stored.

Each public function launches its kernel for CUDA tensors and runs the
plain version for CPU tensors, and for nothing else: a CUDA tensor the
kernel does not take (dtype, shape, bits) raises. The selection follows
`_resolve_stream`: `stream=None` means m <= 64 and APHRODITE_QMM_STREAM
(default on). The TPU tiling knobs (APHRODITE_QMM_BLOCK_M/N/K,
APHRODITE_QMM_STREAM_PF, APHRODITE_QMM_DEFERRED and
APHRODITE_QMM_DEFERRED_VMEM_MB) size VMEM tiles or pick between the two
W4A8 bodies; the port does not read them.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.ops.cuda import build

GPTQ_MATMUL_LAUNCHES = build.launch_counter("gptq_matmul")
GPTQ_MATMUL_STREAM_LAUNCHES = build.launch_counter("gptq_matmul_stream")
GPTQ_MATMUL_STREAM_A8_LAUNCHES = build.launch_counter(
    "gptq_matmul_stream_a8")
GPTQ_MATMUL_A8_LAUNCHES = build.launch_counter("gptq_matmul_a8")
AWQ_MATMUL_LAUNCHES = build.launch_counter("awq_matmul")
AWQ_MATMUL_STREAM_LAUNCHES = build.launch_counter("awq_matmul_stream")
AWQ_MATMUL_A8_LAUNCHES = build.launch_counter("awq_matmul_a8")
AWQ_MATMUL_STREAM_A8_LAUNCHES = build.launch_counter(
    "awq_matmul_stream_a8")
QUANTIZE_ACTIVATIONS_INT8_LAUNCHES = build.launch_counter(
    "quantize_activations_int8")
GGUF_Q8_MATMUL_LAUNCHES = build.launch_counter("gguf_q8_matmul")
GGUF_I8G_MATMUL_LAUNCHES = build.launch_counter("gguf_i8g_matmul")
GGUF_W8A8_MATMUL_LAUNCHES = build.launch_counter("gguf_w8a8_matmul")
GGUF_Q4K_MATMUL_LAUNCHES = build.launch_counter("gguf_q4k_matmul")
#: K12's, K13's, K14's and K15's m > 64 kernels (the counters above count
#: the rest: K12 m <= 64, K13 m <= `Q8_STREAM_M_MAX`, K14 m <=
#: `I8G_STREAM_M_MAX`, K15 m <= `K15_STREAM_M_MAX`, and these above).
GGUF_Q4K_GEMM_LAUNCHES = build.launch_counter("gguf_q4k_gemm")
GGUF_Q8_GEMM_LAUNCHES = build.launch_counter("gguf_q8_gemm")
GGUF_I8G_GEMM_LAUNCHES = build.launch_counter("gguf_i8g_gemm")
GGUF_W8A8_GEMM_LAUNCHES = build.launch_counter("gguf_w8a8_gemm")
SQUEEZELLM_MATMUL_LAUNCHES = build.launch_counter("squeezellm_matmul")
SQUEEZELLM_MATMUL_F32_LAUNCHES = build.launch_counter(
    "squeezellm_matmul_f32")
INT8_MATMUL_LAUNCHES = build.launch_counter("int8_matmul")
#: K16's (bf16 and f32 x) and K17's m > 64 kernels (the three counters
#: above count the rest: K16 m <= 64, K17 m <= `INT8_STREAM_M_MAX`, and
#: K17's here above it).
SQUEEZELLM_GEMM_LAUNCHES = build.launch_counter("squeezellm_gemm")
SQUEEZELLM_F32_GEMM_LAUNCHES = build.launch_counter("squeezellm_f32_gemm")
INT8_GEMM_LAUNCHES = build.launch_counter("int8_gemm")
#: The reduce after a split K6, K8, K10 or K11-K17 launch (`gemm_plan`,
#: `a8_gemm_plan`).
QUANT_GEMM_REDUCE_LAUNCHES = build.launch_counter("quant_gemm_split_reduce")

STREAM_M_MAX = 64          # rows the skinny kernel (K7) takes
# The byte codes' rows on quant_stream_kernel (K13, K14, K17), each
# wrapper's last m at which it took less time than the 128-row
# warpgroup-MMA kernel (whose loads run faster) a Mistral-7B layer: at 17
# rows, where the stream kernel's block grows to 32 rows, the gemm takes
# 0.179-0.183 ms against 0.196-0.203; K14, whose stage carries twice
# K13's scale rows, from 14 rows (0.185 against 0.183 at 14, 0.187
# against 0.184 at 16; within 1.5% at 13-16); PERF.md.
Q8_STREAM_M_MAX = 16
I8G_STREAM_M_MAX = 13
INT8_STREAM_M_MAX = 16
# K15 on quant_stream_kernel's a8 arm against w8a8_gemm_kernel (128-row
# tiles, s8 warpgroup MMA), chosen the same way: the gemm takes
# 0.155-0.163 ms at every m <= 64, the stream kernel 0.154 at 8, 0.159
# at 12 (0.160-0.161 on the gemm), 0.161 at 13 (0.158-0.160) and 0.167 at
# 16 (0.155); PERF.md.
K15_STREAM_M_MAX = 12
BLOCK_N = 128              # output columns per block
GEMM_BLOCK_M, GEMM_BLOCK_N = 128, 256   # K6 / K10 / K12-K14 / K16 / K17
W8A8_BLOCK_N = 128         # K8's, K11's and K15's w8a8 gemm: 128 x 128
X32_BLOCK_N = 128          # K16's on f32 x at m > 64: 128 x 128
A8_CHUNK = 128             # their k rows a chunk
_BLOCKS_PER_SM = 4         # split-K target: this many blocks per SM
STREAM_BLOCK_N = 128       # K7's output columns per block (8 warps x 16)
_STREAM_X_BYTES = 65536    # K7's resident x per block, at most
# AWQ: column 8j + e of a packed word sits at shift 4 * AWQ_ORDER[e].
AWQ_ORDER = (0, 4, 1, 5, 2, 6, 3, 7)


def gptq_supported(in_features: int, out_features: int, bits: int,
                   group_size: int, desc_act: bool) -> bool:
    """Shapes the GPTQ kernels handle (the JAX package's gate, copied)."""
    if desc_act or bits not in (4, 8):
        return False
    gs = group_size if group_size != -1 else in_features
    pack = 32 // bits
    return (in_features % gs == 0 and gs % pack == 0 and gs >= 128 and
            gs <= 1024 and out_features % 128 == 0)


def awq_supported(in_features: int, out_features: int,
                  group_size: int) -> bool:
    """Shapes the AWQ kernels are used for (the JAX package's gate,
    copied)."""
    return (in_features % group_size == 0 and
            128 <= group_size <= 1024 and
            out_features % 1024 == 0)


def gguf_q8_supported(in_features: int, out_features: int) -> bool:
    """Shapes K13 takes (the JAX package's gate, copied)."""
    return in_features % 256 == 0 and out_features % 128 == 0


def gguf_i8g_supported(in_features: int, out_features: int) -> bool:
    """Shapes K14 takes (the JAX package's gate, copied)."""
    return in_features % 256 == 0 and out_features % 128 == 0


def gguf_w8a8_supported(in_features: int, out_features: int) -> bool:
    """Shapes K15 takes (the JAX package's gate, copied)."""
    return in_features % 128 == 0 and out_features % 128 == 0


def gguf_q4k_supported(in_features: int, out_features: int) -> bool:
    """Shapes K12 takes (the JAX package's gate, copied)."""
    return in_features % 256 == 0 and out_features % 128 == 0


def squeezellm_supported(in_features: int, out_features: int) -> bool:
    """Shapes K16 takes (the JAX package's gate, copied)."""
    return in_features % 256 == 0 and out_features % 128 == 0


def int8_supported(in_features: int, out_features: int) -> bool:
    """Shapes K17 takes (the JAX package's gate, copied)."""
    return in_features % 256 == 0 and out_features % 128 == 0


# ------------------------------------------------------ plain versions --

def unpack_rows(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 [r, c] with 32 // bits codes along ROWS -> [r * pack, c]
    int32 codes in natural row order."""
    pack = 32 // bits
    shifts = torch.arange(pack, device=packed.device,
                          dtype=torch.int32) * bits
    vals = (packed[:, None, :] >> shifts[None, :, None]) & ((1 << bits) - 1)
    return vals.reshape(-1, packed.shape[1])


def unpack_cols(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 [r, c] with 32 // bits codes along COLUMNS -> [r, c * pack]."""
    pack = 32 // bits
    shifts = torch.arange(pack, device=packed.device,
                          dtype=torch.int32) * bits
    vals = (packed[:, :, None] >> shifts[None, None, :]) & ((1 << bits) - 1)
    return vals.reshape(packed.shape[0], -1)


def unpack_awq(packed: torch.Tensor) -> torch.Tensor:
    """int32 [r, c] in the AWQ layout -> [r, c * 8] int32 codes in
    natural column order."""
    shifts = torch.tensor([4 * p for p in AWQ_ORDER], device=packed.device,
                          dtype=torch.int32)
    vals = (packed[:, :, None] >> shifts[None, None, :]) & 0xF
    return vals.reshape(packed.shape[0], -1)


def _codes(qweight: torch.Tensor, qzeros: torch.Tensor, bits: int,
           gs: int) -> torch.Tensor:
    """GPTQ: q - (z + 1) as int32 [K, N] over contiguous groups."""
    q = unpack_rows(qweight, bits)
    z = unpack_cols(qzeros, bits) + 1
    return q - z.repeat_interleave(gs, dim=0)


def _awq_codes(qweight: torch.Tensor, qzeros: torch.Tensor,
               gs: int) -> torch.Tensor:
    """AWQ: q - z as int32 [K, N] over contiguous groups."""
    return unpack_awq(qweight) - \
        unpack_awq(qzeros).repeat_interleave(gs, dim=0)


def _dequant(codes: torch.Tensor, scales: torch.Tensor, gs: int,
             dtype: torch.dtype) -> torch.Tensor:
    """W [K, N] in `dtype`: (codes in f32 times s in f32), rounded."""
    s = scales.float().repeat_interleave(gs, dim=0)
    return (codes.float() * s).to(dtype)


def _a16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with w in x's dtype, the products summed in f32, the result
    in x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def _a8(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
        gs: int) -> torch.Tensor:
    """W4A8: per group g, the exact integer dot x8[:, g] . codes[g] (taken
    in f32: every partial sum is an integer below 2^24), times the
    group's scale row, added in group order; then times xs and rounded to
    x's dtype."""
    x8, xs = quantize_activations_int8_plain(x)
    return _a8_rows(x8, xs, codes, scales, gs, x.dtype)


def _a8_rows(x8: torch.Tensor, xs: torch.Tensor, codes: torch.Tensor,
             scales: torch.Tensor, gs: int,
             dtype: torch.dtype) -> torch.Tensor:
    """`_a8` on given int8 rows x8 [m, K] and their scales xs [m, 1]."""
    codes = codes.float()
    s = scales.float()
    xq = x8.float()
    acc = torch.zeros(x8.shape[0], codes.shape[1], dtype=torch.float32,
                      device=x8.device)
    for g in range(x8.shape[1] // gs):
        d = xq[:, g * gs:(g + 1) * gs] @ codes[g * gs:(g + 1) * gs]
        acc += d * s[g]
    return (acc * xs).to(dtype)


def dequantize_plain(qweight: torch.Tensor, qzeros: torch.Tensor,
                     scales: torch.Tensor, *, bits: int, group_size: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """GPTQ W [K, N] in `dtype`: ((q - z) in f32 times s in f32),
    rounded."""
    K = qweight.shape[0] * (32 // bits)
    gs = group_size if group_size != -1 else K
    return _dequant(_codes(qweight, qzeros, bits, gs), scales, gs, dtype)


def dequantize_awq_plain(qweight: torch.Tensor, qzeros: torch.Tensor,
                         scales: torch.Tensor, *, group_size: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """AWQ W [K, N] in `dtype`: ((q - z) in f32 times s in f32),
    rounded."""
    return _dequant(_awq_codes(qweight, qzeros, group_size), scales,
                    group_size, dtype)


def gptq_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                      qzeros: torch.Tensor, scales: torch.Tensor, *,
                      bits: int, group_size: int) -> torch.Tensor:
    """Plain version of K6/K7 (a16): the weight dequantized in x's dtype,
    the products summed in f32, the result in x's dtype."""
    return _a16(x, dequantize_plain(qweight, qzeros, scales, bits=bits,
                                    group_size=group_size, dtype=x.dtype))


def awq_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                     qzeros: torch.Tensor, scales: torch.Tensor, *,
                     group_size: int) -> torch.Tensor:
    """Plain version of K10 and K7's AWQ layout (a16), as
    `gptq_matmul_plain`."""
    return _a16(x, dequantize_awq_plain(qweight, qzeros, scales,
                                        group_size=group_size,
                                        dtype=x.dtype))


def quantize_activations_int8_plain(x: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9: (x8 [m, K] int8, xs [m, 1] f32)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=1, keepdim=True)
    # A tensor divisor: torch on CUDA divides by a Python scalar as a
    # multiply by its reciprocal, which is not IEEE division.
    xs = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)
    x8 = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return x8, xs


def gptq_matmul_a8_plain(x: torch.Tensor, qweight: torch.Tensor,
                         qzeros: torch.Tensor, scales: torch.Tensor, *,
                         bits: int, group_size: int) -> torch.Tensor:
    """Plain version of K8 and K7's a8 arm (GPTQ layout): K9's rows,
    then `_a8`'s integer dots per group."""
    if bits != 4:
        raise ValueError(f"W4A8 takes 4-bit codes, got {bits}")
    gs = group_size if group_size != -1 else x.shape[1]
    return _a8(x, _codes(qweight, qzeros, bits, gs), scales, gs)


def awq_matmul_a8_plain(x: torch.Tensor, qweight: torch.Tensor,
                        qzeros: torch.Tensor, scales: torch.Tensor, *,
                        group_size: int) -> torch.Tensor:
    """Plain version of K11 and K7's AWQ a8 arm: K9's rows, then `_a8`'s
    integer dots per group (AWQ codes minus zeros lie in [-15, 15])."""
    return _a8(x, _awq_codes(qweight, qzeros, group_size), scales,
               group_size)


def gguf_q8_matmul_plain(x: torch.Tensor, qs: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: W = (qs * d[k // 32]) in f32, rounded to x's
    dtype; the products summed in f32; the result in x's dtype."""
    return _a16(x, _dequant(qs, d, 32, x.dtype))


def gguf_i8g_matmul_plain(x: torch.Tensor, qs: torch.Tensor,
                          d16: torch.Tensor) -> torch.Tensor:
    """Plain version of K14: as K13's with a scale row per 16 rows."""
    return _a16(x, _dequant(qs, d16, 16, x.dtype))


def gguf_w8a8_matmul_plain(x: torch.Tensor, qs8: torch.Tensor,
                           s128: torch.Tensor) -> torch.Tensor:
    """Plain version of K9 then K15: `_a8`'s exact integer dots per
    128-row group, each times its scale row, added in group order, then
    times xs."""
    return _a8(x, qs8, s128, 128)


def gguf_w8a8_launch_plain(x8: torch.Tensor, xs: torch.Tensor,
                           qs8: torch.Tensor, s128: torch.Tensor,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """Plain version of K15 alone (`gguf_w8a8_launch`) on K9's rows x8
    and their scales xs; the result in `dtype`."""
    return _a8_rows(x8, xs, qs8, s128, 128, dtype)


def gguf_q4k_dequantize_plain(qweight: torch.Tensor, dl: torch.Tensor,
                              ml: torch.Tensor,
                              dtype: torch.dtype) -> torch.Tensor:
    """Q4_K W [K, N] in `dtype`: (q * dl - ml) in f32 over 32-row groups,
    rounded."""
    codes = unpack_rows(qweight, 4).float()
    return (codes * dl.float().repeat_interleave(32, dim=0) -
            ml.float().repeat_interleave(32, dim=0)).to(dtype)


def gguf_q4k_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                          dl: torch.Tensor, ml: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: W rounded to x's dtype, the products summed
    in f32, the result in x's dtype."""
    return _a16(x, gguf_q4k_dequantize_plain(qweight, dl, ml, x.dtype))


def squeezellm_dequantize_plain(qweight: torch.Tensor, lut: torch.Tensor,
                                dtype: torch.dtype) -> torch.Tensor:
    """W [K, N] in `dtype` with w[k, n] = lut[n, q[k, n]]."""
    codes = unpack_rows(qweight, 4).long()
    return torch.gather(lut.float().t(), 0, codes).to(dtype)


def squeezellm_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                            lut: torch.Tensor) -> torch.Tensor:
    """Plain version of K16 (both kernels): the codebook entries in x's
    dtype, the products summed in f32, the result in x's dtype."""
    return _a16(x, squeezellm_dequantize_plain(qweight, lut, x.dtype))


def int8_matmul_plain(x: torch.Tensor, weight: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """Plain version of K17: (x @ W) with the int8 codes exact in x's
    dtype and the products summed in f32, times the f32 column scales,
    rounded to x's dtype."""
    return ((x.float() @ weight.float()) * scales.float()).to(x.dtype)


# ------------------------------------------------------------ kernels --

def _check(x, qweight, qzeros, scales, bits, gs, what: str,
           awq: bool = False) -> Tuple[int, int, int, int]:
    """Validate the kernels' inputs in the GPTQ (or, with `awq`, the AWQ)
    layout; returns (m, K, N, group_size)."""
    if bits not in (4, 8):
        raise ValueError(f"{what}: bits must be 4 or 8, got {bits}")
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: x must be 2-D bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if scales.dtype != torch.bfloat16:
        raise TypeError(f"{what}: scales must be bfloat16, got "
                        f"{scales.dtype}")
    if qweight.dtype != torch.int32 or qzeros.dtype != torch.int32:
        raise TypeError(f"{what}: qweight and qzeros must be int32")
    pack = 32 // bits
    m, K = x.shape
    N = scales.shape[-1]
    gs = gs if gs != -1 else K
    if gs <= 0 or K % gs or (not awq and gs % pack):
        raise ValueError(f"{what}: K {K} must be a multiple of the group "
                         f"size {gs}" + ("" if awq else
                                         f", itself a multiple of {pack}"))
    if N % BLOCK_N:
        raise ValueError(f"{what}: N {N} must be a multiple of {BLOCK_N}")
    G = K // gs
    if tuple(qweight.shape) != ((K, N // pack) if awq else (K // pack, N)) \
            or tuple(qzeros.shape) != (G, N // pack) or \
            tuple(scales.shape) != (G, N):
        raise ValueError(
            f"{what}: shapes qweight {tuple(qweight.shape)}, qzeros "
            f"{tuple(qzeros.shape)}, scales {tuple(scales.shape)} do not "
            f"fit x {tuple(x.shape)} at {bits} bits, group {gs}, "
            f"{'AWQ' if awq else 'GPTQ'} layout")
    for t in (x, qweight, qzeros, scales):
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    return m, K, N, gs


def gemm_plan(m: int, K: int, N: int, gs: int, sms: int,
              block_n: int = GEMM_BLOCK_N) -> Tuple[int, int]:
    """(splits, groups per split) of a warpgroup-MMA kernel's grid
    (N / block_n, m / 128, splits): K6 / K10 (groups of gs rows), K12-K14,
    K16 and K17 (64-row chunks; K16 on f32 x block_n 128) and K15 (128-row
    groups, block_n 128), from shapes
    and the card's SM count alone (no host sync, so a CUDA graph can
    capture the launch). Where the 128 x block_n output tiles fall short
    of the SMs, the groups are split into contiguous runs so that tiles
    x splits comes near one block per SM; each split starts on a group,
    none is empty, and a second kernel adds the splits' f32 partial sums
    in split order."""
    groups = K // gs
    tiles = -(-m // GEMM_BLOCK_M) * -(-N // block_n)
    splits = max(1, min(groups, sms // tiles))
    per = -(-groups // splits)
    return -(-groups // per), per


def a8_gemm_plan(m: int, K: int, N: int, gs: int, sms: int
                 ) -> Tuple[int, int]:
    """(splits, chunks per split) of K8 / K11 (`w8a8_gemm_kernel` with a
    4-bit decoder): `gemm_plan` with 128 x 128 tiles over chunks of 128
    rows, each group of gs rows cut into ceil(gs / 128) of them (the last
    one short where 128 does not divide gs). A split is a run of whole
    chunks and may start and end inside a group (the group's scale is
    constant over it), so one group of K rows still splits."""
    chunks = K // gs * -(-gs // A8_CHUNK)
    return gemm_plan(m, chunks * A8_CHUNK, N, A8_CHUNK, sms,
                     block_n=W8A8_BLOCK_N)


def quant8_plan(m: int, K: int, sms: int) -> Tuple[int, int]:
    """(threads, runs a thread) of K9's launch, one block a row of K
    bf16, from shapes and the card's SM count alone (so a CUDA graph can
    capture the launch): each thread holds up to `per` 16-byte runs (8
    values) of the row in registers, the least of 1, 2, 4 and 8 that
    keeps the block within a thread target (else 8), and the block has
    enough warps to hold every run, at most 1024 threads. The target is
    1024 threads where the rows are few (m <= 4 blocks an SM: decode
    steps, short prompt rounds), so that each block's few loads and
    divisions a thread finish soon, and 256 where many blocks share each
    SM (PERF.md). The kernel reads the row element by element where it
    is not whole 16-byte runs from an aligned start (K % 8, a view at an
    odd offset) or longer than 1024 x 8 runs."""
    runs = max(1, -(-K // 8))
    target = 1024 if m <= 4 * sms else 256
    per = next((p for p in (1, 2, 4, 8) if -(-runs // p) <= target), 8)
    threads = -(-runs // per)
    return min(1024, -(-threads // 32) * 32), per


def stream_unit(gs: int) -> int:
    """K7's split unit: lcm(gs, 32) rows, whole groups and whole k32
    steps, up to 1024 rows (32 rows of bf16 x over it fill a block's
    `_STREAM_X_BYTES`); past that 32 rows (gs = K, groups of 2048 rows
    and more), and a split may start and end inside a group: the a16 arms
    take each step's group scale, the a8 arm folds its share of a group's
    exact sum."""
    unit = gs // math.gcd(gs, 32) * 32
    return unit if unit <= 1024 else 32


def stream_plan(m: int, K: int, N: int, gs: int, sms: int, bits: int = 4,
                x_bytes: int = 2) -> Tuple[int, int]:
    """(block_m, splits) of `quant_stream_kernel` (K7; K12 and K16 at
    m <= 64, with gs 32; K13, K14 and K17 with `bits` 8; K15 with gs 128,
    `bits` 8 and int8 x) on a card of `sms` SMs, from shapes alone (no
    host sync, so a CUDA graph can capture the launch). block_m is the
    least of 8/16/32/64 rows that covers m (1, 2 or 4 n-tiles of the
    mma; 64 as two 32-row blocks);
    the grid is (N / 128, row blocks, splits), each split a run of whole
    units of `stream_unit` rows, none empty. Splits aim at four blocks
    per SM, but no further than keeps the f32 partial sums (splits x m
    x N x 4 bytes) within a tenth of the packed weight's bytes (`bits` a
    weight), unless that leaves SMs without a block (N / 128 x splits <
    sms: m above 8 or so at N 4096), and no fewer than keep each block's
    resident x (up to 32 rows of its K range, `x_bytes` an element: 2
    for bf16, 1 for the a8 arms' int8, 4 for f32 x held as bf16 hi and
    lo) within `_STREAM_X_BYTES`. Raises on shapes the kernel does not
    take: gs a multiple of 8, K of the unit."""
    if m > STREAM_M_MAX:
        raise ValueError(f"the streamed kernel takes m <= {STREAM_M_MAX}, "
                         f"got {m} (use stream=False)")
    block_m = next(b for b in (8, 16, 32, 64) if m <= b)
    rows = min(block_m, 32)                # a block's x rows
    unit = stream_unit(gs)
    if gs % 8 or K % unit:
        raise ValueError(f"the streamed kernel takes groups of a multiple "
                         f"of 8 rows and K a multiple of its {unit}-row "
                         f"split unit, got group {gs}, K {K}")
    units = K // unit
    per_x = _STREAM_X_BYTES // (rows * unit * x_bytes)
    least = -(-units // per_x)             # splits x needs
    blocks = N // STREAM_BLOCK_N * -(-max(m, 1) // rows)
    fill = -(-sms * _BLOCKS_PER_SM // blocks)
    cap = max(K * bits // (320 * max(m, 1)), -(-sms // blocks))
    splits = min(units, max(least, min(fill, cap)))
    per = -(-units // splits)
    return block_m, -(-units // per)


def _plan(m: int, K: int, N: int, gs: int, stream: bool, a8: bool,
          bits: int, sms: int) -> Tuple[int, int]:
    """(block_m, splits) of a GPTQ / AWQ launch: K7 (`stream_plan`) when
    streamed, else 128 rows, split by `gemm_plan` (K6 / K10) or
    `a8_gemm_plan` (K8 / K11)."""
    if stream:
        return stream_plan(m, K, N, gs, sms, bits, 1 if a8 else 2)
    plan = a8_gemm_plan if a8 else gemm_plan
    return GEMM_BLOCK_M, plan(m, K, N, gs, sms)[0]


def _launch(a8: bool, x, xs, qweight, qzeros, scales, *, bits: int,
            gs: int, stream: bool, counter: build.LaunchCounter,
            what: str, awq: bool = False) -> torch.Tensor:
    """One launch of the GPTQ (or, with `awq`, the AWQ) layout's a16 or
    a8 entry point; x is int8 rows with their scales xs for a8."""
    m, K = x.shape
    N = scales.shape[1]
    block_m, splits = _plan(m, K, N, gs, stream, a8, bits,
                            build.sm_count(x.device))
    out = torch.empty((m, N), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((splits, m, N), dtype=torch.float32,
                          device=x.device) if splits > 1 else None
    # Of the four entry points only gptq_mm_a16 takes the bit width (the
    # others are 4-bit); only the a8 ones take the row scales xs.
    tail = (m, K, N, gs) + (() if a8 or awq else (bits,)) + \
        (splits, block_m)
    ptrs = (x.data_ptr(),) + ((xs.data_ptr(),) if a8 else ()) + (
        qweight.data_ptr(), qzeros.data_ptr(), scales.data_ptr(),
        out.data_ptr(), build.ptr(partial))
    fn = _entry(f"{'awq' if awq else 'gptq'}_mm_{'a8' if a8 else 'a16'}",
                len(ptrs), len(tail))
    err = fn(*ptrs, *tail, build.stream_of(x))
    counter.add()
    if not stream and splits > 1:      # K6, K8, K10, K11 split
        QUANT_GEMM_REDUCE_LAUNCHES.add()
    build.check(err, f"{what} (streamed)" if stream else what)
    return out


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ptrs: int, n_ints: int):
    """The C entry point `name` of the library, its argument types set
    once: n_ptrs pointers, n_ints ints, then the stream."""
    fn = getattr(build.library("quant_matmul"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + \
        [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gemm_smem_bytes(bits: int) -> int:
    """K6 / K10's dynamic shared memory per block at `bits` (4 or 8), as
    the kernel's launcher asks for it."""
    fn = build.library("quant_matmul").quant_gemm_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return int(fn(bits))


def gguf_gemm_smem_bytes(kernel: int, f32: bool = False) -> int:
    """The shared memory per block of the m > 64 kernel of K8 and
    K11-K17 (`kernel`, the number; with `f32`, K16's on f32 x): its
    launcher's dynamic request, plus K16's static codebook tile (16 KB,
    8 KB on f32 x)."""
    if kernel not in (8, 11, 12, 13, 14, 15, 16, 17) or \
            (f32 and kernel != 16):
        raise ValueError(f"no m > 64 kernel K{kernel}"
                         + (" on f32 x" if f32 else ""))
    fn = build.library("quant_matmul").gguf_gemm_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return int(fn(kernel, int(f32)))


def _resolve_stream(stream, m: int) -> bool:
    """The JAX package's selector: an explicit `stream` wins, else the
    skinny kernel at m <= 64 unless APHRODITE_QMM_STREAM=0."""
    if stream is not None:
        return bool(stream)
    if m > STREAM_M_MAX:
        return False
    return flags.get_bool("APHRODITE_QMM_STREAM")


def quantize_activations_int8(x: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of x [m, K]: (x8 int8, xs [m, 1] f32)."""
    if not build.on_cuda(x):
        return quantize_activations_int8_plain(x)
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError("quantize_activations_int8: x must be contiguous "
                        f"2-D bfloat16, got {tuple(x.shape)} {x.dtype}")
    m, K = x.shape
    x8 = torch.empty((m, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    plan = quant8_plan(m, K, build.sm_count(x.device))
    err = _entry("quant8", 3, 4)(x.data_ptr(), x8.data_ptr(),
                                 xs.data_ptr(), m, K, *plan,
                                 build.stream_of(x))
    QUANTIZE_ACTIVATIONS_INT8_LAUNCHES.add()
    build.check(err, "quantize_activations_int8")
    return x8, xs


def gptq_matmul(x: torch.Tensor, qweight: torch.Tensor,
                qzeros: torch.Tensor, scales: torch.Tensor, *, bits: int,
                group_size: int, stream: Optional[bool] = None
                ) -> torch.Tensor:
    """y [m, N] = x [m, K] @ dequant(qweight, qzeros, scales) (W4A16 or
    W8A16). `stream` pins the skinny kernel (K7) or the tiled one (K6);
    None picks by m as the JAX package does."""
    if not build.on_cuda(x, qweight, qzeros, scales):
        return gptq_matmul_plain(x, qweight, qzeros, scales, bits=bits,
                                 group_size=group_size)
    m, K, N, gs = _check(x, qweight, qzeros, scales, bits, group_size,
                         "gptq_matmul")
    use_stream = _resolve_stream(stream, m)
    return _launch(False, x, None, qweight, qzeros, scales, bits=bits,
                   gs=gs, stream=use_stream,
                   counter=GPTQ_MATMUL_STREAM_LAUNCHES if use_stream
                   else GPTQ_MATMUL_LAUNCHES, what="gptq_matmul")


def gptq_matmul_a8(x: torch.Tensor, qweight: torch.Tensor,
                   qzeros: torch.Tensor, scales: torch.Tensor, *,
                   bits: int, group_size: int, deferred=None,
                   stream: Optional[bool] = None) -> torch.Tensor:
    """W4A8: x quantized per row to int8 (K9), then integer dots per
    group with the f32 rescale (K7's a8 arm at m <= 64, else K8).
    `deferred` is the JAX signature's pin between two summation orders
    of the same sums; the one CUDA kernel ignores it."""
    del deferred
    if not build.on_cuda(x, qweight, qzeros, scales):
        return gptq_matmul_a8_plain(x, qweight, qzeros, scales, bits=bits,
                                    group_size=group_size)
    if bits != 4:
        raise ValueError(f"gptq_matmul_a8: W4A8 takes 4-bit codes (8-bit "
                         f"codes minus their zero overflow int8), got {bits}")
    m, K, N, gs = _check(x, qweight, qzeros, scales, bits, group_size,
                         "gptq_matmul_a8")
    use_stream = _resolve_stream(stream, m)
    _plan(m, K, N, gs, use_stream, True, 4,   # raise before quantizing
          build.sm_count(x.device))
    x8, xs = quantize_activations_int8(x)
    return _launch(True, x8, xs, qweight, qzeros, scales, bits=4, gs=gs,
                   stream=use_stream,
                   counter=GPTQ_MATMUL_STREAM_A8_LAUNCHES if use_stream
                   else GPTQ_MATMUL_A8_LAUNCHES, what="gptq_matmul_a8")


def awq_matmul(x: torch.Tensor, qweight: torch.Tensor, qzeros: torch.Tensor,
               scales: torch.Tensor, *, group_size: int,
               stream: Optional[bool] = None) -> torch.Tensor:
    """y [m, N] = x [m, K] @ dequant(qweight, qzeros, scales) in the AWQ
    int4 layout. `stream` pins K7's AWQ layout (True) or K10 (False);
    None picks by m as the JAX package does."""
    if not build.on_cuda(x, qweight, qzeros, scales):
        return awq_matmul_plain(x, qweight, qzeros, scales,
                                group_size=group_size)
    m, K, N, gs = _check(x, qweight, qzeros, scales, 4, group_size,
                         "awq_matmul", awq=True)
    use_stream = _resolve_stream(stream, m)
    return _launch(False, x, None, qweight, qzeros, scales, bits=4,
                   gs=gs, stream=use_stream,
                   counter=AWQ_MATMUL_STREAM_LAUNCHES if use_stream
                   else AWQ_MATMUL_LAUNCHES, what="awq_matmul", awq=True)


def awq_matmul_a8(x: torch.Tensor, qweight: torch.Tensor,
                  qzeros: torch.Tensor, scales: torch.Tensor, *,
                  group_size: int, deferred=None,
                  stream: Optional[bool] = None) -> torch.Tensor:
    """W4A8 in the AWQ layout: x quantized per row to int8 (K9), then
    integer dots per group with the f32 rescale (K7's AWQ a8 arm at
    m <= 64, else K11). `deferred` pins one of the JAX package's two
    summation orders of the same sums; the one CUDA kernel ignores it."""
    del deferred
    if not build.on_cuda(x, qweight, qzeros, scales):
        return awq_matmul_a8_plain(x, qweight, qzeros, scales,
                                   group_size=group_size)
    m, K, N, gs = _check(x, qweight, qzeros, scales, 4, group_size,
                         "awq_matmul_a8", awq=True)
    use_stream = _resolve_stream(stream, m)
    _plan(m, K, N, gs, use_stream, True, 4,   # raise before quantizing
          build.sm_count(x.device))
    x8, xs = quantize_activations_int8(x)
    return _launch(True, x8, xs, qweight, qzeros, scales, bits=4,
                   gs=gs, stream=use_stream,
                   counter=AWQ_MATMUL_STREAM_A8_LAUNCHES if use_stream
                   else AWQ_MATMUL_A8_LAUNCHES, what="awq_matmul_a8",
                   awq=True)


# --------------------------------------------------------------- GGUF --

def _check_gguf(x, qs, scales, G: int, what: str,
                want_x: torch.dtype = torch.bfloat16) -> Tuple[int, int, int]:
    """Validate a GGUF kernel's inputs; returns (m, K, N)."""
    if x.dim() != 2 or x.dtype != want_x:
        raise TypeError(f"{what}: x must be 2-D {want_x}, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if qs.dtype != torch.int8 or scales.dtype != torch.bfloat16:
        raise TypeError(f"{what}: weights must be int8 with bfloat16 "
                        f"scales, got {qs.dtype} and {scales.dtype}")
    m, K = x.shape
    N = qs.shape[-1]
    if K % 128 or N % BLOCK_N:
        raise ValueError(f"{what}: K {K} and N {N} must be multiples of "
                         f"128")
    if tuple(qs.shape) != (K, N) or tuple(scales.shape) != (K // G, N):
        raise ValueError(f"{what}: shapes qs {tuple(qs.shape)}, scales "
                         f"{tuple(scales.shape)} do not fit x "
                         f"{tuple(x.shape)} with a scale per {G} rows")
    for t in (x, qs, scales):
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    return m, K, N


def _entry_launch(entry: str, x: torch.Tensor, ptrs: Tuple[int, ...],
                  N: int, block_m: int, splits: int,
                  out_dtype: torch.dtype, *, counter: build.LaunchCounter,
                  what: str) -> torch.Tensor:
    """One launch of a GGUF, K12, K16 or K17 entry point (its input
    pointers `ptrs`, x [m, K] first, then out, partial, m, K, N, splits,
    block_m and the stream) with the plan given; `counter` counts it, and
    the split reduce where a 128-row launch splits."""
    m, K = x.shape
    out = torch.empty((m, N), dtype=out_dtype, device=x.device)
    partial = torch.empty((splits, m, N), dtype=torch.float32,
                          device=x.device) if splits > 1 else None
    ptrs = ptrs + (out.data_ptr(), build.ptr(partial))
    err = _entry(entry, len(ptrs), 5)(*ptrs, m, K, N, splits, block_m,
                                      build.stream_of(x))
    counter.add()
    if block_m == GEMM_BLOCK_M and splits > 1:
        QUANT_GEMM_REDUCE_LAUNCHES.add()
    build.check(err, what)
    return out


def _launch_by_m(entry: str, x, ptrs: Tuple[int, ...], N: int, *,
                 counter: build.LaunchCounter,
                 gemm_counter: build.LaunchCounter, what: str,
                 w8a8: bool = False, bits: int = 4,
                 stream_m: int = STREAM_M_MAX,
                 block_n: int = GEMM_BLOCK_N,
                 stream: Optional[bool] = None) -> torch.Tensor:
    """One launch of an entry point with an m > 64 warpgroup-MMA kernel
    (K12-K17) on x, bf16, f32 (K16 on f32 x, whose output is f32) or,
    with `w8a8`, K9's int8 rows; `ptrs` are its input pointers, x first.
    At m <= `stream_m` (64; K13-K15 and K17 their `*_STREAM_M_MAX`), or
    wherever `stream` is True (m <= 64), counting on `counter`:
    `quant_stream_kernel` (K12-K17), planned by `stream_plan` over
    32-row units (K15: its 128-row groups) with the weight's `bits` a
    code (8 for the byte codes) and x's bytes an element. Above, or
    wherever `stream` is False, counting on `gemm_counter`: the
    warpgroup-MMA kernel on 128 x `block_n` tiles, planned by `gemm_plan`
    over 64-row chunks or (w8a8) 128-row groups (a split reduce after it
    where it splits)."""
    unit = 128 if w8a8 else 64
    m, K = x.shape
    sms = build.sm_count(x.device)
    out_dtype = torch.float32 if x.dtype == torch.float32 else \
        torch.bfloat16
    use_stream = m <= stream_m if stream is None else stream
    if use_stream:
        block_m, splits = stream_plan(m, K, N, unit if w8a8 else 32, sms,
                                      bits, x.element_size())
        return _entry_launch(entry, x, ptrs, N, block_m, splits, out_dtype,
                             counter=counter, what=what)
    splits, _ = gemm_plan(m, K, N, unit, sms,
                          block_n=W8A8_BLOCK_N if w8a8 else block_n)
    return _entry_launch(entry, x, ptrs, N, GEMM_BLOCK_M, splits, out_dtype,
                         counter=gemm_counter, what=what)


def gguf_q8_matmul(x: torch.Tensor, qs: torch.Tensor, d: torch.Tensor, *,
                   stream: Optional[bool] = None) -> torch.Tensor:
    """y [m, N] = x [m, K] @ (int8 qs [K, N] * d [K/32, N]), Q8_0 at rest
    (K13). `stream` pins quant_stream_kernel (True, m <= 64) or the
    warpgroup-MMA kernel (False); None picks by m (`Q8_STREAM_M_MAX`)."""
    if not build.on_cuda(x, qs, d):
        return gguf_q8_matmul_plain(x, qs, d)
    _check_gguf(x, qs, d, 32, "gguf_q8_matmul")
    return _launch_by_m("gguf_q8_mm", x,
                        (x.data_ptr(), qs.data_ptr(), d.data_ptr()),
                        qs.shape[1], counter=GGUF_Q8_MATMUL_LAUNCHES,
                        gemm_counter=GGUF_Q8_GEMM_LAUNCHES,
                        what="gguf_q8_matmul", bits=8,
                        stream_m=Q8_STREAM_M_MAX, stream=stream)


def gguf_i8g_matmul(x: torch.Tensor, qs: torch.Tensor, d16: torch.Tensor,
                    *, stream: Optional[bool] = None) -> torch.Tensor:
    """y [m, N] = x [m, K] @ (int8 qs [K, N] * d16 [K/16, N]), the
    grouped-int8 at-rest form (K14). `stream` as `gguf_q8_matmul`'s (None:
    `I8G_STREAM_M_MAX`)."""
    if not build.on_cuda(x, qs, d16):
        return gguf_i8g_matmul_plain(x, qs, d16)
    _check_gguf(x, qs, d16, 16, "gguf_i8g_matmul")
    return _launch_by_m("gguf_i8g_mm", x,
                        (x.data_ptr(), qs.data_ptr(), d16.data_ptr()),
                        qs.shape[1], counter=GGUF_I8G_MATMUL_LAUNCHES,
                        gemm_counter=GGUF_I8G_GEMM_LAUNCHES,
                        what="gguf_i8g_matmul", bits=8,
                        stream_m=I8G_STREAM_M_MAX, stream=stream)


def gguf_w8a8_launch(x8: torch.Tensor, xs: torch.Tensor, qs8: torch.Tensor,
                     s128: torch.Tensor, *, stream: Optional[bool] = None
                     ) -> torch.Tensor:
    """K15 alone on K9's int8 rows x8 [m, K] and their scales xs [m, 1];
    bf16 out. `stream` pins quant_stream_kernel's a8 arm (True, m <= 64)
    or w8a8_gemm_kernel (False); None picks by m (`K15_STREAM_M_MAX`)."""
    if not build.on_cuda(x8, xs, qs8, s128):
        return gguf_w8a8_launch_plain(x8, xs, qs8, s128)
    m, K, N = _check_gguf(x8, qs8, s128, 128, "gguf_w8a8_matmul",
                          want_x=torch.int8)
    if xs.dtype != torch.float32 or tuple(xs.shape) != (m, 1) or \
            not xs.is_contiguous():
        raise ValueError("gguf_w8a8_matmul: xs must be contiguous float32 "
                         f"[{m}, 1], got {tuple(xs.shape)} {xs.dtype}")
    return _launch_by_m("gguf_w8a8_mm", x8,
                        (x8.data_ptr(), xs.data_ptr(), qs8.data_ptr(),
                         s128.data_ptr()), N,
                        counter=GGUF_W8A8_MATMUL_LAUNCHES,
                        gemm_counter=GGUF_W8A8_GEMM_LAUNCHES,
                        what="gguf_w8a8_matmul", w8a8=True, bits=8,
                        stream_m=K15_STREAM_M_MAX, stream=stream)


def gguf_w8a8_matmul(x: torch.Tensor, qs8: torch.Tensor,
                     s128: torch.Tensor, *, stream: Optional[bool] = None
                     ) -> torch.Tensor:
    """W8A8, the GGUF turbo form: x quantized per row to int8 (K9), then
    y [m, N] = xs * sum_g s128[g] * (x8[:, g] . qs8[g]) over 128-row
    groups (K15). `stream` as `gguf_w8a8_launch`'s."""
    if not build.on_cuda(x, qs8, s128):
        return gguf_w8a8_matmul_plain(x, qs8, s128)
    m, K, N = _check_gguf(x, qs8, s128, 128, "gguf_w8a8_matmul")
    if stream:                     # raise before K9
        stream_plan(m, K, N, 128, build.sm_count(x.device), 8, 1)
    x8, xs = quantize_activations_int8(x)
    return gguf_w8a8_launch(x8, xs, qs8, s128, stream=stream)


# ------------------------------------------------- K12, K16 and K17 --

def _check_x(x: torch.Tensor, dtypes, what: str) -> Tuple[int, int]:
    if x.dim() != 2 or x.dtype not in dtypes:
        raise TypeError(f"{what}: x must be 2-D "
                        f"{' or '.join(map(str, dtypes))}, got "
                        f"{tuple(x.shape)} {x.dtype}")
    m, K = x.shape
    return m, K


def _check_tiles(K: int, N: int, what: str) -> None:
    """The kernels stage 64 k rows and 128 columns at a time."""
    if K % 64 or N % BLOCK_N:
        raise ValueError(f"{what}: K {K} must be a multiple of 64 and N "
                         f"{N} of {BLOCK_N}")


def _check_contiguous(what: str, *tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def _check_packed4(x, qweight, dtypes, what: str) -> Tuple[int, int, int]:
    """x [m, K] and 4-bit codes qweight [K/8, N] int32; returns (m, K,
    N)."""
    m, K = _check_x(x, dtypes, what)
    if qweight.dtype != torch.int32 or qweight.dim() != 2 or \
            qweight.shape[0] * 8 != K:
        raise ValueError(f"{what}: qweight must be int32 [K/8, N] for K "
                         f"{K}, got {tuple(qweight.shape)} {qweight.dtype}")
    N = qweight.shape[1]
    _check_tiles(K, N, what)
    return m, K, N


def gguf_q4k_matmul(x: torch.Tensor, qweight: torch.Tensor, dl: torch.Tensor,
                    ml: torch.Tensor) -> torch.Tensor:
    """y [m, N] = x [m, K] @ (q * dl - ml), GGUF's exact Q4_K form: 4-bit
    codes qweight [K/8, N], affine rows dl, ml [K/32, N] (K12)."""
    if not build.on_cuda(x, qweight, dl, ml):
        return gguf_q4k_matmul_plain(x, qweight, dl, ml)
    what = "gguf_q4k_matmul"
    m, K, N = _check_packed4(x, qweight, (torch.bfloat16,), what)
    for t in (dl, ml):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (K // 32, N):
            raise ValueError(f"{what}: dl and ml must be bfloat16 "
                             f"[{K // 32}, {N}], got {tuple(t.shape)} "
                             f"{t.dtype}")
    _check_contiguous(what, x, qweight, dl, ml)
    return _launch_by_m("gguf_q4k_mm", x,
                        (x.data_ptr(), qweight.data_ptr(), dl.data_ptr(),
                         ml.data_ptr()), N,
                        counter=GGUF_Q4K_MATMUL_LAUNCHES,
                        gemm_counter=GGUF_Q4K_GEMM_LAUNCHES, what=what)


def squeezellm_matmul(x: torch.Tensor, qweight: torch.Tensor,
                      lut: torch.Tensor) -> torch.Tensor:
    """y [m, N] = x [m, K] @ w, w[k, n] = lut[n, q[k, n]]: 4-bit codes
    qweight [K/8, N], a 16-entry codebook lut [N, 16] per output column
    (K16). bf16 x and lut take the bf16 decoders (SqueezeLLM), f32 x and
    lut the f32 ones (QuIP#: three bf16 products a term, f32 sums): the
    streamed kernel at m <= 64, the warpgroup-MMA kernel above (on f32 x
    after a pass that splits x into bf16 hi and lo rows, in a scratch of
    2 m K bf16); y is in x's dtype."""
    if not build.on_cuda(x, qweight, lut):
        return squeezellm_matmul_plain(x, qweight, lut)
    what = "squeezellm_matmul"
    m, K, N = _check_packed4(x, qweight, (torch.bfloat16, torch.float32),
                             what)
    if lut.dtype != x.dtype or tuple(lut.shape) != (N, 16):
        raise ValueError(f"{what}: lut must be [{N}, 16] in x's dtype "
                         f"{x.dtype}, got {tuple(lut.shape)} {lut.dtype}")
    _check_contiguous(what, x, qweight, lut)
    ptrs = (x.data_ptr(), qweight.data_ptr(), lut.data_ptr())
    if x.dtype == torch.float32:
        # The gemm's scratch for x split into bf16 [hi; lo] rows.
        xhl = torch.empty((2 * m, K), dtype=torch.bfloat16,
                          device=x.device) if m > STREAM_M_MAX else None
        return _launch_by_m("sqllm_mm_f32", x, ptrs + (build.ptr(xhl),), N,
                            counter=SQUEEZELLM_MATMUL_F32_LAUNCHES,
                            gemm_counter=SQUEEZELLM_F32_GEMM_LAUNCHES,
                            what=what + "_f32", block_n=X32_BLOCK_N)
    return _launch_by_m("sqllm_mm", x, ptrs, N,
                        counter=SQUEEZELLM_MATMUL_LAUNCHES,
                        gemm_counter=SQUEEZELLM_GEMM_LAUNCHES, what=what)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor, scales: torch.Tensor,
                *, stream: Optional[bool] = None) -> torch.Tensor:
    """y [m, N] = (x [m, K] @ int8 weight [K, N]) * scales [N] (K17); x
    bf16, scales f32. `stream` as `gguf_q8_matmul`'s (None:
    `INT8_STREAM_M_MAX`)."""
    if not build.on_cuda(x, weight, scales):
        return int8_matmul_plain(x, weight, scales)
    what = "int8_matmul"
    m, K = _check_x(x, (torch.bfloat16,), what)
    if weight.dtype != torch.int8 or weight.dim() != 2 or \
            weight.shape[0] != K:
        raise ValueError(f"{what}: weight must be int8 [K, N] for K {K}, "
                         f"got {tuple(weight.shape)} {weight.dtype}")
    N = weight.shape[1]
    _check_tiles(K, N, what)
    if scales.dtype != torch.float32 or tuple(scales.shape) != (N,):
        raise ValueError(f"{what}: scales must be float32 [{N}], got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    _check_contiguous(what, x, weight, scales)
    return _launch_by_m(
        "int8_mm", x, (x.data_ptr(), weight.data_ptr(), scales.data_ptr()),
        N, counter=INT8_MATMUL_LAUNCHES, gemm_counter=INT8_GEMM_LAUNCHES,
        what=what, bits=8, stream_m=INT8_STREAM_M_MAX,
        stream=stream)
