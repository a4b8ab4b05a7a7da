"""GGUF quantized-at-rest execution, PyTorch port of
`aphrodite_tpu/modeling/layers/quantization/gguf.py`.

The loader hands each block-quantized projection weight over as its raw
ggml blocks (`modeling/gguf.RawGGUF`); `load_weight` repacks them into
one of four at-rest forms, per merged bucket, as the JAX package does
(`at_rest_form`):

- `qs8`/`s128` (the default "turbo" form of lossy formats: Q4_K, Q5_K,
  Q4_0, ... requantized to symmetric int8 per 128-row group): K9, then
  K15 (`gguf_w8a8_matmul`);
- `qs`/`d16` (members of a MIXED sibling group, uniform Q6_K exactly,
  and other lossy formats with APHRODITE_GGUF_EXACT=1 or an input width
  that is not a multiple of 128): K14 (`gguf_i8g_matmul`);
- `qs`/`d` (uniform Q8_0, exact): K13 (`gguf_q8_matmul`);
- `qweight`/`dl`/`ml` (exact Q4_K: APHRODITE_GGUF_EXACT=1, or an input
  width that is not a multiple of 128): K12 (`gguf_q4k_matmul`).

Every other tensor (embeddings, norms, the LM head, groups with float
members) dequantizes at load and runs as a dense `weight`, kept in the
port's [out, in] layout (the JAX package's GGUF method transposes it to
[in, out]). The at-rest forms are [in, out], as in the JAX package.
Where a kernel's `*_supported` gate refuses a bucket's shape, or on the
card where the activations are not bfloat16 (the kernels take bfloat16
only), `apply` dequantizes and multiplies in plain torch, as the JAX
package falls back to XLA.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
from aphrodite_tpu_torch.modeling.layers.quantization.base_config import (
    QuantizationConfig, kernel_takes_dtype)
from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm


class GGUFConfig(QuantizationConfig):

    @classmethod
    def get_name(cls) -> str:
        return "gguf"

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "GGUFConfig":
        return cls()

    def get_linear_method(self) -> "GGUFLinearMethod":
        return GGUFLinearMethod(self)


def q4k_to_kernel(blocks: np.ndarray, out_features: int,
                  in_features: int, scale_dtype=np.float32
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Raw Q4_K superblocks [n, 144] (row-major over [out, in/256]) ->
    (qweight [in/8, out] int32 GPTQ plane packing, dl [in/32, out],
    ml [in/32, out]): w[i, o] = dl[i//32, o] * q - ml[i//32, o]."""
    from aphrodite_tpu_torch.modeling.gguf import _f16, _scale_min_k4
    n = blocks.shape[0]
    d = _f16(blocks[:, :2])[:, 0]                       # [n]
    dmin = _f16(blocks[:, 2:4])[:, 0]
    scales, mins = _scale_min_k4(blocks[:, 4:16])       # [n, 8]
    qs = blocks[:, 16:144]                              # [n, 128]
    codes = np.empty((n, 256), dtype=np.uint8)
    for c in range(4):
        ql = qs[:, 32 * c:32 * (c + 1)]
        codes[:, 64 * c:64 * c + 32] = ql & 0xF
        codes[:, 64 * c + 32:64 * c + 64] = ql >> 4
    dl = (d[:, None] * scales).astype(scale_dtype)      # [n, 8]
    ml = (dmin[:, None] * mins).astype(scale_dtype)
    codes = codes.reshape(out_features, in_features).T  # [in, out]
    dl = dl.reshape(out_features, in_features // 32).T
    ml = ml.reshape(out_features, in_features // 32).T
    qweight = np.zeros((in_features // 8, out_features), np.int32)
    c8 = codes.reshape(in_features // 8, 8, out_features).astype(
        np.int64)
    for p in range(8):
        qweight |= (c8[:, p, :] << (4 * p)).astype(
            np.int64).astype(np.uint32).view(np.int32)
    return qweight, dl, ml


def q8_0_to_kernel(blocks: np.ndarray, out_features: int,
                   in_features: int, scale_dtype=np.float32
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Raw Q8_0 blocks [n, 34] -> (qs [in, out] int8, d [in/32, out])."""
    from aphrodite_tpu_torch.modeling.gguf import _f16
    d = _f16(blocks[:, :2])[:, 0]
    qs = blocks[:, 2:].view(np.int8)
    qs = qs.reshape(out_features, in_features).T.copy()
    d = d.reshape(out_features, in_features // 32).T.astype(scale_dtype)
    return qs, d


def q6k_to_kernel(blocks: np.ndarray, out_features: int,
                  in_features: int, scale_dtype=np.float32
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Raw Q6_K superblocks [n, 210] -> the grouped-int8 form
    (qs [in, out] int8 = codes - 32, d16 [in/16, out] = d * subscale):
    EXACT -- Q6_K's value index // 16 is its scale index, so the 6-bit
    codes land on the int8 grid with no requantization."""
    from aphrodite_tpu_torch.modeling.gguf import _f16
    n = blocks.shape[0]
    ql = blocks[:, :128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)  # [n, 16]
    d = _f16(blocks[:, 208:210])[:, 0]                        # [n]
    codes = np.empty((n, 256), dtype=np.int16)
    for half in range(2):
        qlh = ql[:, 64 * half:64 * (half + 1)]
        qhh = qh[:, 32 * half:32 * (half + 1)]
        quarters = (
            (qlh[:, :32] & 0xF) | (((qhh >> 0) & 3) << 4),
            (qlh[:, 32:] & 0xF) | (((qhh >> 2) & 3) << 4),
            (qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4),
            (qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4),
        )
        for quarter, q in enumerate(quarters):
            codes[:, 128 * half + 32 * quarter:
                  128 * half + 32 * (quarter + 1)] = q.astype(np.int16)
    qs = (codes - 32).astype(np.int8)
    dl = d[:, None] * sc                                      # [n, 16]
    qs = qs.reshape(out_features, in_features).T.copy()
    d16 = dl.reshape(out_features, in_features // 16).T.astype(
        scale_dtype)
    return qs, d16


def gguf_turbo() -> bool:
    """Lossy source formats requantize at load to symmetric int8 with a
    scale per (128-input-row, column) group and run the W8A8 kernel
    (K15), unless APHRODITE_GGUF_EXACT=1. Q8_0 and Q6_K keep their exact
    forms either way: their codes already sit on the int8 grid. Read per
    call, as in the JAX package."""
    return not flags.get_bool("APHRODITE_GGUF_EXACT")


def _symmetric_int8(w: np.ndarray, group: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """A dense [out, in] weight -> (qs [in, out] int8, s [in/group, out])
    with symmetric per-(group-input-row, column) absmax scales."""
    wt = np.asarray(w, dtype=np.float32).T                # [in, out]
    in_f, out_f = wt.shape
    g = wt.reshape(in_f // group, group, out_f)
    amax = np.abs(g).max(axis=1)                          # [in/group, out]
    s = np.where(amax > 0, amax / 127.0, 1.0)
    qs = np.clip(np.round(g / s[:, None, :]), -127, 127)
    return qs.reshape(in_f, out_f).astype(np.int8), s


def dense_to_w8(w: np.ndarray, scale_dtype=np.float32
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Requantize a dense [out, in] weight into the W8A8 at-rest form:
    (qs [in, out] int8, s128 [in/128, out])."""
    qs, s = _symmetric_int8(w, 128)
    return qs, s.astype(scale_dtype)


def dense_to_i8g(w: np.ndarray, scale_dtype=np.float32
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Requantize a dense [out, in] weight into the grouped-int8 form
    (per-(16-input-row, column) scales): members of MIXED sibling groups
    whose native packing cannot share a bucket (~0.4% max relative error
    per group, far below the source 4-bit format's own)."""
    qs, s = _symmetric_int8(w, 16)
    return qs, s.astype(scale_dtype)


def at_rest_form(type_name: str, in_features: int, compat: bool) -> str:
    """The at-rest form `load_weight` gives a RawGGUF tensor, in the JAX
    package's order of checks: "i8g" (qs/d16), "w8" (qs8/s128), "q8_0"
    (qs/d) or "q4k" (qweight/dl/ml)."""
    if compat:
        # Member of a MIXED sibling group: unify on grouped int8 so the
        # merged bucket has one representation (exact for Q8_0/Q6_K).
        return "i8g"
    if gguf_turbo() and in_features % 128 == 0 and \
            type_name not in ("Q8_0", "Q6_K"):
        return "w8"
    if type_name == "Q4_K":
        return "q4k"
    if type_name == "Q8_0":
        return "q8_0"
    # Uniform Q6_K (exact repack), or another lossy format with turbo
    # off or an unaligned input width (requantized).
    return "i8g"


def checkpoint_forms(path: str) -> Dict[str, str]:
    """{hf_name: at-rest form, or "dense"} of every projection weight of
    a `.gguf` file under quantization="gguf", from its header alone."""
    from aphrodite_tpu_torch.modeling.gguf import (GGML_TYPES, GGUFReader,
                                                   _DEQUANT, _hf_name,
                                                   at_rest_groups)
    reader = GGUFReader(path)
    groups = at_rest_groups(reader)
    forms = {}
    for info in reader.tensors:
        try:
            name = _hf_name(info.name)
        except ValueError:
            continue
        if name not in groups:
            continue
        tname = GGML_TYPES[info.ggml_type][0]
        mode, mixed = groups[name]
        if tname in _DEQUANT and len(info.shape) == 2 and mode is not None:
            forms[name] = at_rest_form(tname, info.shape[1], mixed)
        else:
            forms[name] = "dense"
    return forms


def dummy_form(in_features: int) -> str:
    """The at-rest form `create_weights` gives a layer: BENCH_GGUF_FMT
    ("q8_0" or "q6_k") picks an exact form, else the turbo form when it
    is on and the input width allows it, else exact Q4_K."""
    fmt = os.environ.get("BENCH_GGUF_FMT", "")
    if fmt == "q8_0" and in_features % 32 == 0:
        return "q8_0"
    if fmt == "q6_k" and in_features % 16 == 0:
        return "i8g"
    if gguf_turbo() and in_features % 128 == 0:
        return "w8"
    return "q4k"


def _param(t: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(t))


class GGUFLinearMethod(LinearMethod):
    """Per-tensor format dispatch: packed at-rest params, everything else
    a dense `weight` (dequantized at load)."""

    def __init__(self, config: GGUFConfig) -> None:
        self.config = config
        self.pending_rename = None
        self.pending_sidecar = None

    def create_weights(self, in_features: int, out_features: int,
                       dtype: torch.dtype, bias: bool,
                       device: torch.device) -> Dict[str, torch.Tensor]:
        """Dummy-init shapes (benchmarks and profiling): the form
        `dummy_form` picks. Real loads build their buckets per tensor
        format in `load_weight`. Scale rows are in the model dtype, as
        the loader casts every floating tensor."""
        def empty(shape, dt):
            return torch.empty(shape, dtype=dt, device=device)
        form = dummy_form(in_features)
        if form == "q8_0":
            params = {"qs": empty((in_features, out_features), torch.int8),
                      "d": empty((in_features // 32, out_features), dtype)}
        elif form == "i8g":
            params = {"qs": empty((in_features, out_features), torch.int8),
                      "d16": empty((in_features // 16, out_features),
                                   dtype)}
        elif form == "w8":
            params = {"qs8": empty((in_features, out_features), torch.int8),
                      "s128": empty((in_features // 128, out_features),
                                    dtype)}
        else:
            params = {"qweight": empty((in_features // 8, out_features),
                                       torch.int32),
                      "dl": empty((in_features // 32, out_features), dtype),
                      "ml": empty((in_features // 32, out_features), dtype)}
        if bias:
            params["bias"] = empty((out_features,), dtype)
        return params

    def dequantize(self, params: Dict[str, torch.Tensor],
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Dense [in, out] weight from whichever form is present (the
        fallback and the test oracle), as the JAX package's
        `dequantize`."""
        def rep(scales, group):
            return scales.float().repeat_interleave(group, dim=0)
        if "qs8" in params:
            return (params["qs8"].float() * rep(params["s128"], 128)).to(
                dtype)
        if "qweight" in params:
            codes = qmm.unpack_rows(params["qweight"], 4).float()
            return (codes * rep(params["dl"], 32) -
                    rep(params["ml"], 32)).to(dtype)
        if "qs" in params and "d16" in params:
            return (params["qs"].float() * rep(params["d16"], 16)).to(dtype)
        if "qs" in params:
            return (params["qs"].float() * rep(params["d"], 32)).to(dtype)
        return params["weight"].t().to(dtype)

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        if "weight" in params:
            return F.linear(x, params["weight"], params.get("bias"))
        lead = x.shape[:-1]
        takes = kernel_takes_dtype(x)
        y = None
        if "qs8" in params:
            K, N = params["qs8"].shape
            if takes and qmm.gguf_w8a8_supported(K, N):
                y = qmm.gguf_w8a8_matmul(x.reshape(-1, K).contiguous(),
                                         params["qs8"], params["s128"])
        elif "qweight" in params:
            K, N = params["qweight"].shape[0] * 8, params["qweight"].shape[1]
            if takes and qmm.gguf_q4k_supported(K, N):
                y = qmm.gguf_q4k_matmul(x.reshape(-1, K).contiguous(),
                                        params["qweight"], params["dl"],
                                        params["ml"])
        elif "d16" in params:
            K, N = params["qs"].shape
            if takes and qmm.gguf_i8g_supported(K, N):
                y = qmm.gguf_i8g_matmul(x.reshape(-1, K).contiguous(),
                                        params["qs"], params["d16"])
        else:
            K, N = params["qs"].shape
            if takes and qmm.gguf_q8_supported(K, N):
                y = qmm.gguf_q8_matmul(x.reshape(-1, K).contiguous(),
                                       params["qs"], params["d"])
        if y is None:
            # A gate refused the shape, or the kernels do not take x's
            # dtype: dequantize, then multiply, in x's dtype.
            y = x.reshape(-1, x.shape[-1]) @ self.dequantize(params, x.dtype)
        y = y.reshape(*lead, y.shape[-1])
        if "bias" in params:
            y = y + params["bias"]
        return y

    def load_weight(self, params, name: str, hf_tensor) -> torch.Tensor:
        """One checkpoint tensor in this method's layout. A RawGGUF
        weight repacks into its at-rest form: the packed tensor is
        returned and its param name and scale rows are left in
        `pending_rename` / `pending_sidecar` for the layer's loader."""
        from aphrodite_tpu_torch.modeling.gguf import _DEQUANT, RawGGUF
        if not isinstance(hf_tensor, RawGGUF):
            # Dense (load-time-dequantized or float) tensor, kept [out, in].
            return hf_tensor
        out_f, in_f = hf_tensor.shape
        tname = hf_tensor.type_name
        form = at_rest_form(tname, in_f, hf_tensor.compat)

        def dense():
            return _DEQUANT[tname](hf_tensor.blocks).reshape(out_f, in_f)
        if form == "q4k":
            qweight, dl, ml = q4k_to_kernel(hf_tensor.blocks, out_f, in_f)
            self.pending_rename = "qweight"
            self.pending_sidecar = {"dl": _param(dl), "ml": _param(ml)}
            return _param(qweight)
        if form == "q8_0":
            qs, d = q8_0_to_kernel(hf_tensor.blocks, out_f, in_f)
            self.pending_rename = "qs"
            self.pending_sidecar = {"d": _param(d)}
            return _param(qs)
        if form == "w8":
            qs8, s128 = dense_to_w8(dense())
            self.pending_rename = "qs8"
            self.pending_sidecar = {"s128": _param(s128)}
            return _param(qs8)
        # Grouped int8: exact for Q6_K and (scale rows repeated) Q8_0,
        # requantized for the other formats.
        if tname == "Q6_K":
            qs, d16 = q6k_to_kernel(hf_tensor.blocks, out_f, in_f)
        elif tname == "Q8_0":
            qs, d = q8_0_to_kernel(hf_tensor.blocks, out_f, in_f)
            d16 = np.repeat(d, 2, axis=0)
        else:
            qs, d16 = dense_to_i8g(dense())
        self.pending_rename = "qs"
        self.pending_sidecar = {"d16": _param(d16)}
        return _param(qs)

    def out_scale(self, name: str) -> int:
        return 1
