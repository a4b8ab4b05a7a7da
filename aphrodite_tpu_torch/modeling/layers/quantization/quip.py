"""QuIP# (E8P12 codebook) 2-bit quantization, PyTorch port of
`aphrodite_tpu/modeling/layers/quantization/quip.py`.

- The E8P abs-codebook is constructed as the JAX package constructs it
  (`packed_abs_grid`), and `decompress_e8p` is the same bit-exact numpy
  transcription of the reference's decode8weights and its fp16 mantissa
  trick, run once at load.
- At rest the codes take one of two forms, as in the JAX package: where
  K16's gate takes the transform shape (q_in % 256 == 0, q_out % 128 ==
  0), 4-bit LUT codes `qweight` [q_in/8, q_out] with a 16-entry
  `lookup_table` [q_out, 16] (the 12 quarter-integer E8P values: a
  lossless re-encoding), multiplied by K16 on f32 activations with
  Wscale folded into the table; elsewhere int8 quarter-integer codes
  `weight` [q_in, q_out], multiplied in plain torch in f32, `xr @ (w *
  0.25 * Wscale)`, on the CPU and on the card. (The JAX package gates
  its K17 call on the same shape predicate, so that form never reaches
  K17 there either.)
- The Hadamard transforms (the iterative FWHT butterfly in Sylvester
  order, with an optional non-power-of-two factor `had_left` /
  `had_right`) are plain torch ops, as XLA runs them in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
from aphrodite_tpu_torch.modeling.layers.quantization.base_config import (
    QuantizationConfig)
from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm

_NORM12 = np.array([
    [3, 1, 1, 1, 3, 3, 3, 3], [1, 3, 1, 1, 3, 3, 3, 3],
    [1, 1, 3, 1, 3, 3, 3, 3], [1, 1, 1, 3, 3, 3, 3, 3],
    [3, 3, 3, 1, 3, 3, 1, 1], [3, 3, 3, 1, 3, 1, 3, 1],
    [3, 3, 3, 1, 1, 3, 3, 1], [3, 3, 3, 1, 3, 1, 1, 3],
    [3, 3, 3, 1, 1, 3, 1, 3], [3, 3, 3, 1, 1, 1, 3, 3],
    [3, 3, 1, 3, 3, 3, 1, 1], [3, 3, 1, 3, 3, 1, 3, 1],
    [3, 3, 1, 3, 1, 3, 3, 1], [3, 3, 1, 3, 3, 1, 1, 3],
    [3, 3, 1, 3, 1, 3, 1, 3], [3, 3, 1, 3, 1, 1, 3, 3],
    [3, 1, 3, 3, 3, 3, 1, 1], [3, 1, 3, 3, 3, 1, 3, 1],
    [3, 1, 3, 3, 1, 3, 3, 1], [3, 1, 3, 3, 3, 1, 1, 3],
    [3, 1, 3, 3, 1, 3, 1, 3], [1, 3, 3, 3, 1, 1, 3, 3],
    [1, 3, 3, 3, 3, 3, 1, 1], [1, 3, 3, 3, 3, 1, 3, 1],
    [1, 3, 3, 3, 1, 3, 3, 1], [1, 3, 3, 3, 3, 1, 1, 3],
    [1, 3, 3, 3, 1, 3, 1, 3], [1, 1, 3, 3, 1, 3, 3, 3],
    [3, 3, 1, 1, 3, 3, 3, 1],
], dtype=np.float32) / 2


def packed_abs_grid() -> np.ndarray:
    """The 256-entry packed E8P abs codebook as int64 (one byte per
    weight, value*4, byte 7 sign-encoded by row parity): the abs rows of
    the even-sum E8 points of norm^2 <= 10 (every absolute-value
    combination from {0.5, 1.5, 2.5, 3.5}^8 within that norm has an
    even-sum signing) and the 29 norm-12 rows."""
    import itertools
    vals = np.array([0.5, 1.5, 2.5, 3.5], dtype=np.float32)
    rows = [
        np.array(combo, dtype=np.float32)
        for combo in itertools.product(vals, repeat=8)
        if float(np.sum(np.square(combo))) <= 10.0 + 1e-6
    ]
    d8abs = np.unique(np.stack(rows), axis=0)
    cba = np.concatenate([d8abs, _NORM12], axis=0)
    cba = cba[:, [0, 2, 1, 3, 4, 6, 5, 7]]
    row_parity = np.round(cba.sum(1)).astype(np.int64) % 2
    cba[:, 7] *= (1 - 2 * row_parity).astype(np.float32)
    cba_i = np.round(cba * 4).astype(np.int64)
    assert cba_i.shape[0] == 256, cba_i.shape
    acc = cba_i[:, 0] & 0xFF
    for i in range(1, 8):
        acc = acc | ((cba_i[:, i] & 0xFF) << (i * 8))
    return acc.astype(np.int64)


_CODEBOOK: Optional[np.ndarray] = None


def _codebook_bytes() -> np.ndarray:
    """[256, 8] uint8 little-endian view of the packed codebook."""
    global _CODEBOOK
    if _CODEBOOK is None:
        _CODEBOOK = packed_abs_grid().view(np.uint8).reshape(256, 8)
    return _CODEBOOK


def decompress_e8p(qidxs: np.ndarray) -> np.ndarray:
    """[m, n/8] int16 codes -> [m, n] float32 weights: decode8weights and
    the decompress kernel's fp16 mantissa trick, including its output
    byte order [0, 2, 1, 3, 4, 6, 5, 7]."""
    w = qidxs.astype(np.uint16)
    bits_sign = (w & 0xFF).astype(np.uint8)
    parity = (np.unpackbits(bits_sign[..., None], axis=-1)
              .sum(-1) & 1).astype(np.uint8)
    sign_vec = bits_sign ^ parity
    abs_idx = (w >> 8).astype(np.uint8)
    packed = _codebook_bytes()[abs_idx]               # [m, n8, 8] uint8
    sign_bits = (sign_vec[..., None] >>
                 np.arange(8, dtype=np.uint8)) & 1
    b = packed ^ (sign_bits * np.uint8(252))
    b = b | np.uint8(1)
    b = (b.astype(np.int32) - parity[..., None].astype(np.int32) * 2) \
        .astype(np.uint8)
    # fp16 trick: bits(0x5c80 ^ byte) - 288 == signed_byte / 4.
    half_bits = np.uint16(0x5C80) ^ b.astype(np.uint16)
    vals = half_bits.view(np.float16).astype(np.float32) - 288.0
    vals = vals[..., [0, 2, 1, 3, 4, 6, 5, 7]]
    m, n8 = qidxs.shape
    return vals.reshape(m, n8 * 8)


def fwht(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Fast Walsh-Hadamard transform over the trailing (power-of-two)
    axis, Sylvester ordering."""
    n = x.shape[-1]
    assert n & (n - 1) == 0, f"FWHT needs a power of two, got {n}"
    y = x
    h = 1
    while h < n:
        y = y.reshape(*y.shape[:-1], n // (2 * h), 2, h)
        a = y[..., 0, :]
        b = y[..., 1, :]
        y = torch.stack([a + b, a - b], dim=-2)
        y = y.reshape(*y.shape[:-3], n)
        h *= 2
    return y * scale


def matmul_hadU(x: torch.Tensor, hadK: Optional[torch.Tensor], K: int,
                n: int, scale: Optional[float] = None,
                transpose: bool = False) -> torch.Tensor:
    """x -> (H_K (x) H_{n/K}) x over the trailing axis (zero-padded to
    n)."""
    if x.shape[-1] != n:
        x = F.pad(x, (0, n - x.shape[-1]))
    had_scale = (1.0 if scale is None else scale) / math.sqrt(n // K)
    if K == 1:
        return fwht(x, had_scale)
    h = hadK.t() if transpose else hadK
    xv = x.reshape(*x.shape[:-1], K, n // K)
    xv = fwht(xv, had_scale)
    out = torch.einsum("ij,...jk->...ik", h.to(xv.dtype), xv)
    return out.reshape(*x.shape[:-1], n)


class QuipConfig(QuantizationConfig):
    """E8P12 2-bit."""

    def __init__(self, codebook: str = "E8P12",
                 use_rand: bool = True) -> None:
        if codebook != "E8P12":
            raise ValueError(
                f"Only the E8P12 codebook is supported, got {codebook}")
        self.codebook = codebook
        self.use_rand = use_rand

    @classmethod
    def get_name(cls) -> str:
        return "quip"

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "QuipConfig":
        return cls(codebook=cls.get_from_keys(config, ["codebook"],
                                              "E8P12"),
                   use_rand=cls.get_from_keys(config, ["use_rand"],
                                              True))

    def get_linear_method(self) -> "QuipLinearMethod":
        return QuipLinearMethod(self)


def _pad_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def get_hadK(n: int, use_rand: bool = True):
    """(had [K, K] or None, K, q_features) for dimension n: n = 2^exp *
    base; base 1 runs a plain FWHT over n, otherwise the transform is
    had_K (x) H_{n/K} with a [K, K] special-orthogonal factor drawn with
    scipy from RandomState(base), as the JAX package draws it (real
    checkpoints carry had_left / had_right, which replace it at load).
    Without use_rand the dims pad to a power of two."""
    base = n
    exp = 0
    while base % 2 == 0:
        base //= 2
        exp += 1
    if base == 1:
        return None, 1, n
    if use_rand:
        from scipy.stats import special_ortho_group
        mat = special_ortho_group.rvs(
            base, random_state=np.random.RandomState(base))
        return np.asarray(mat, dtype=np.float32), base, n
    return None, 1, _pad_pow2(n)


class QuipLinearMethod(LinearMethod):
    """QuIP# linear execution: y = SV * hadU(hadUt(SU * x) @ W^T).

    Params: `qweight` + `lookup_table` (4-bit LUT form) or `weight`
    (int8 form), `Wscale` [] f32, `SU` [in], `SV` [out] in the model
    dtype, and `had_left` / `had_right` where a dim is not a power of
    two."""

    def __init__(self, config: QuipConfig) -> None:
        self.config = config
        self.pending_rename = None
        self.pending_sidecar = None

    def create_weights(self, in_features: int, out_features: int,
                       dtype: torch.dtype, bias: bool,
                       device: torch.device) -> Dict[str, torch.Tensor]:
        had_l, _, q_in = get_hadK(in_features, self.config.use_rand)
        had_r, _, q_out = get_hadK(out_features, self.config.use_rand)
        if not self.config.use_rand and (q_in != in_features or
                                         q_out != out_features):
            raise ValueError(
                "QuIP with use_rand=false needs power-of-two layer "
                f"dims (got in={in_features}, out={out_features}); "
                "the pre-computed Hadamard factor tables the reference "
                "uses for other sizes are not available. Use a "
                "use_rand=true checkpoint (had_left/had_right ship in "
                "the checkpoint) or power-of-two dims.")

        def empty(shape, dt):
            return torch.empty(shape, dtype=dt, device=device)
        if qmm.squeezellm_supported(q_in, q_out):
            params = {"qweight": empty((q_in // 8, q_out), torch.int32),
                      "lookup_table": empty((q_out, 16), torch.float32)}
        else:
            params = {"weight": empty((q_in, q_out), torch.int8)}
        params.update({
            "Wscale": torch.ones((), dtype=torch.float32, device=device),
            "SU": torch.ones((in_features,), dtype=dtype, device=device),
            "SV": torch.ones((out_features,), dtype=dtype, device=device),
        })
        if had_l is not None:
            params["had_left"] = torch.from_numpy(had_l).to(device)
        if had_r is not None:
            params["had_right"] = torch.from_numpy(had_r).to(device)
        if bias:
            params["bias"] = torch.zeros((out_features,), dtype=dtype,
                                         device=device)
        return params

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        w = params.get("weight")                  # [q_in, q_out] or None
        if w is not None:
            q_in, q_out = w.shape
        else:
            q_in = params["qweight"].shape[0] * 8
            q_out = params["qweight"].shape[1]
        in_features = params["SU"].shape[0]
        out_features = params["SV"].shape[0]
        had_l = params.get("had_left")
        had_r = params.get("had_right")
        k_l = 1 if had_l is None else had_l.shape[0]
        k_r = 1 if had_r is None else had_r.shape[0]
        lead = x.shape[:-1]
        xr = x.reshape(-1, in_features) * params["SU"][None, :]
        xr = matmul_hadU(xr.float(), had_l, k_l, q_in, transpose=True)
        # Wscale, a scalar, folds into the table (or the int8 codes'
        # multiplier), as in the JAX package.
        ws = params["Wscale"]
        if "qweight" in params:
            qw = params["qweight"]
            lut = params["lookup_table"] * ws
            if qmm.squeezellm_supported(q_in, q_out):
                # f32 activations and table: K16's f32 kernel.
                out = qmm.squeezellm_matmul(xr.contiguous(), qw,
                                            lut.float().contiguous())
            else:
                out = xr @ qmm.squeezellm_dequantize_plain(
                    qw, lut, torch.float32)
        elif w.dtype == torch.int8:
            out = xr @ (w.float() * (0.25 * ws))
        else:
            out = (xr * ws) @ w.float()
        out = matmul_hadU(out, had_r, k_r, q_out)[..., :out_features]
        out = out * params["SV"][None, :].float()
        out = out.to(x.dtype).reshape(*lead, out_features)
        if "bias" in params:
            out = out + params["bias"]
        return out

    def load_weight(self, params, name: str, hf_tensor) -> torch.Tensor:
        """Checkpoint `Qidxs` [q_out, q_in/8] int16 -> the 4-bit LUT form
        (`qweight` with its `lookup_table` sidecar) where K16's gate takes
        the shape, else the int8 form (`weight`)."""
        if name == "Qidxs" or name.endswith(".Qidxs"):
            qidxs = np.asarray(hf_tensor, dtype=np.int16) \
                if not isinstance(hf_tensor, torch.Tensor) \
                else hf_tensor.numpy().astype(np.int16)
            q_out_ck = qidxs.shape[0]
            q_in_ck = qidxs.shape[1] * 8
            if qmm.squeezellm_supported(q_in_ck, q_out_ck):
                qweight, lut = quip_codes4_from_qidxs(qidxs)
                self.pending_rename = "qweight"
                self.pending_sidecar = {"lookup_table":
                                        torch.from_numpy(lut)}
                return torch.from_numpy(qweight)
            self.pending_rename = "weight"
            return torch.from_numpy(quip_weight_from_qidxs(qidxs))
        return hf_tensor


# The complete E8P decompressed alphabet: 12 quarter-integer values.
# value*4 is an odd integer in [-11, 11].
E8P_VALUES4 = np.array([-11, -9, -7, -5, -3, -1, 1, 3, 5, 7, 9, 11],
                       dtype=np.int64)


def quip_codes4_from_qidxs(qidxs: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Checkpoint Qidxs [q_out, q_in/8] int16 -> the 4-bit LUT at-rest
    form: (qweight [q_in/8, q_out] int32, 8 nibble codes along the input
    dim, and lookup_table [q_out, 16] f32). Lossless: the E8P alphabet
    has 12 distinct values (E8P_VALUES4 / 4)."""
    dense = decompress_e8p(np.asarray(qidxs, np.int16))   # [q_out, q_in]
    v4 = np.round(dense * 4.0).astype(np.int64)
    codes = np.searchsorted(E8P_VALUES4, v4)
    assert (E8P_VALUES4[codes] == v4).all(), "value outside E8P alphabet"
    q_out, q_in = dense.shape
    lut16 = np.zeros((16,), np.float32)
    lut16[:12] = E8P_VALUES4.astype(np.float32) / 4.0
    codes = codes.T.astype(np.int64)                      # [q_in, q_out]
    c8 = codes.reshape(q_in // 8, 8, q_out)
    qweight = np.zeros((q_in // 8, q_out), np.int32)
    for p in range(8):
        qweight |= (c8[:, p, :] << (4 * p)).astype(
            np.int64).astype(np.uint32).view(np.int32)
    return qweight, np.tile(lut16[None, :], (q_out, 1))


def quip_weight_from_qidxs(qidxs: np.ndarray) -> np.ndarray:
    """Checkpoint Qidxs [q_out, q_in/8] int16 -> [q_in, q_out] int8
    quarter-integer codes (every decompressed E8P value is
    signed_byte / 4, so * 4 round-trips exactly through int8)."""
    dense = decompress_e8p(np.asarray(qidxs, np.int16))   # [q_out, q_in]
    codes = np.round(dense * 4.0)
    assert np.abs(codes).max() <= 127, "E8P code out of int8 range"
    return codes.T.astype(np.int8)
