"""GGUF checkpoint support: binary reader, k-quant dequantization,
llama.cpp->HF tensor-name mapping, config extraction, and a writer for
small files. Port of `aphrodite_tpu/modeling/gguf.py` (numpy only, as
there).

Block formats dequantize at load with vectorized numpy (bit-exact with
ggml's dequantize_row_* semantics), or, for the at-rest execution path
(`quantization="gguf"`), projection weights stay packed (`RawGGUF`) and
`modeling/layers/quantization/gguf.py` repacks them for the kernels.
The reader is self-contained: the `gguf` pip package is not required.
`extract_gguf_config` returns the port's `ModelJsonConfig`
(`transformers_utils/config.py`), since the port runs where
`transformers` is not installed.

GGUF format (v2/v3, little-endian):
  header:  magic 'GGUF', u32 version, u64 tensor_count, u64 kv_count
  kv:      string key, u32 value_type, value (scalars/string/array)
  tensors: string name, u32 n_dims, u64 dims[n_dims] (fastest first),
           u32 ggml_type, u64 offset (into the aligned data section)
  data:    aligned to `general.alignment` (default 32)
"""
from __future__ import annotations

import os
import struct
from typing import Any, BinaryIO, Dict, Iterator, List, Tuple

import numpy as np

from aphrodite_tpu_torch.common.logger import init_logger

logger = init_logger(__name__)

GGUF_MAGIC = b"GGUF"

# -- metadata value types --
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, \
    _T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_U64: "<Q",
    _T_I64: "<q", _T_F64: "<d",
}

# -- ggml tensor types: id -> (name, block_size, bytes_per_block) --
GGML_TYPES = {
    0: ("F32", 1, 4),
    1: ("F16", 1, 2),
    2: ("Q4_0", 32, 18),
    3: ("Q4_1", 32, 20),
    6: ("Q5_0", 32, 22),
    7: ("Q5_1", 32, 24),
    8: ("Q8_0", 32, 34),
    10: ("Q2_K", 256, 84),
    11: ("Q3_K", 256, 110),
    12: ("Q4_K", 256, 144),
    13: ("Q5_K", 256, 176),
    14: ("Q6_K", 256, 210),
    30: ("BF16", 1, 2),
}


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype == _T_STR:
        return _read_str(f)
    if vtype == _T_BOOL:
        return bool(f.read(1)[0])
    if vtype == _T_ARR:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(count)]
    fmt = _SCALAR_FMT[vtype]
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]


class GGUFTensorInfo:
    __slots__ = ("name", "shape", "ggml_type", "offset", "n_bytes")

    def __init__(self, name, shape, ggml_type, offset):
        self.name = name
        self.shape = shape                  # numpy order (outermost first)
        self.ggml_type = ggml_type
        self.offset = offset
        tname, block, bpb = GGML_TYPES[ggml_type]
        n_elems = int(np.prod(shape)) if shape else 1
        assert n_elems % block == 0, (name, shape, tname)
        self.n_bytes = n_elems // block * bpb


class GGUFReader:
    """Parses header/metadata/tensor-info eagerly; tensor data lazily."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.fields: Dict[str, Any] = {}
        self.tensors: List[GGUFTensorInfo] = []
        with open(path, "rb") as f:
            if f.read(4) != GGUF_MAGIC:
                raise ValueError(f"{path} is not a GGUF file")
            (self.version,) = struct.unpack("<I", f.read(4))
            if self.version < 2:
                raise ValueError(f"GGUF v{self.version} not supported")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = _read_str(f)
                (vtype,) = struct.unpack("<I", f.read(4))
                self.fields[key] = _read_value(f, vtype)
            for _ in range(n_tensors):
                name = _read_str(f)
                (n_dims,) = struct.unpack("<I", f.read(4))
                dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                ggml_type, = struct.unpack("<I", f.read(4))
                offset, = struct.unpack("<Q", f.read(8))
                if ggml_type not in GGML_TYPES:
                    raise ValueError(
                        f"Unsupported ggml type {ggml_type} for {name}")
                # GGUF dims are fastest-varying first; numpy wants the
                # reverse.
                self.tensors.append(GGUFTensorInfo(
                    name, tuple(reversed(dims)), ggml_type, offset))
            align = int(self.fields.get("general.alignment", 32))
            pos = f.tell()
            self.data_start = (pos + align - 1) // align * align

    def load(self, info: GGUFTensorInfo) -> np.ndarray:
        """Read + dequantize one tensor to float32 (or raw float dtype)."""
        with open(self.path, "rb") as f:
            f.seek(self.data_start + info.offset)
            raw = f.read(info.n_bytes)
        return dequantize(raw, info.ggml_type, info.shape)


# ------------------------------------------------------------------
# Dequantization (numpy-vectorized ggml dequantize_row_* semantics).
# Each helper takes the raw block bytes as [n_blocks, bytes_per_block]
# uint8 and returns [n_blocks, block_size] float32.
# ------------------------------------------------------------------

def _f16(b: np.ndarray) -> np.ndarray:
    """uint8 [..., 2k] -> float32 via little-endian f16 view."""
    return b.view(np.float16).astype(np.float32)


def _deq_q4_0(b):
    d = _f16(b[:, :2])                                   # [n, 1]
    qs = b[:, 2:]
    lo = (qs & 0xF).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    return d * np.concatenate([lo, hi], axis=1).astype(np.float32)


def _deq_q4_1(b):
    d = _f16(b[:, :2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:]
    lo = (qs & 0xF).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return d * np.concatenate([lo, hi], axis=1) + m


def _deq_q5_0(b):
    d = _f16(b[:, :2])
    qh = b[:, 2:6].copy().view(np.uint32)                # [n, 1]
    qs = b[:, 6:]
    j = np.arange(16, dtype=np.uint32)
    lo_h = ((qh >> j) & 1).astype(np.uint8)              # [n, 16]
    hi_h = ((qh >> (j + 16)) & 1).astype(np.uint8)
    lo = ((qs & 0xF) | (lo_h << 4)).astype(np.int16) - 16
    hi = ((qs >> 4) | (hi_h << 4)).astype(np.int16) - 16
    return d * np.concatenate([lo, hi], axis=1).astype(np.float32)


def _deq_q5_1(b):
    d = _f16(b[:, :2])
    m = _f16(b[:, 2:4])
    qh = b[:, 4:8].copy().view(np.uint32)
    qs = b[:, 8:]
    j = np.arange(16, dtype=np.uint32)
    lo_h = ((qh >> j) & 1).astype(np.uint8)
    hi_h = ((qh >> (j + 16)) & 1).astype(np.uint8)
    lo = ((qs & 0xF) | (lo_h << 4)).astype(np.float32)
    hi = ((qs >> 4) | (hi_h << 4)).astype(np.float32)
    return d * np.concatenate([lo, hi], axis=1) + m


def _deq_q8_0(b):
    d = _f16(b[:, :2])
    return d * b[:, 2:].view(np.int8).astype(np.float32)


def _scale_min_k4(sc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ggml get_scale_min_k4: 12 bytes -> 8 x (6-bit scale, 6-bit min)."""
    sc = sc.astype(np.uint8)
    j = np.arange(4)
    s_lo = sc[:, j] & 63                                  # j < 4
    m_lo = sc[:, j + 4] & 63
    s_hi = (sc[:, j + 8] & 0xF) | ((sc[:, j] >> 6) << 4)  # j >= 4
    m_hi = (sc[:, j + 8] >> 4) | ((sc[:, j + 4] >> 6) << 4)
    return (np.concatenate([s_lo, s_hi], 1).astype(np.float32),
            np.concatenate([m_lo, m_hi], 1).astype(np.float32))


def _deq_q4_k(b):
    d = _f16(b[:, :2])
    dmin = _f16(b[:, 2:4])
    scales, mins = _scale_min_k4(b[:, 4:16])              # [n, 8]
    qs = b[:, 16:144]                                     # [n, 128]
    out = np.empty((b.shape[0], 256), dtype=np.float32)
    for c in range(4):                                    # 4 chunks of 64
        ql = qs[:, 32 * c:32 * (c + 1)]
        for half, q in ((0, ql & 0xF), (1, ql >> 4)):
            sb = 2 * c + half                             # sub-block 0..7
            dl = d[:, 0] * scales[:, sb]
            ml = dmin[:, 0] * mins[:, sb]
            out[:, 64 * c + 32 * half:64 * c + 32 * (half + 1)] = \
                dl[:, None] * q.astype(np.float32) - ml[:, None]
    return out


def _deq_q5_k(b):
    d = _f16(b[:, :2])
    dmin = _f16(b[:, 2:4])
    scales, mins = _scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]                                      # [n, 32]
    qs = b[:, 48:176]                                     # [n, 128]
    out = np.empty((b.shape[0], 256), dtype=np.float32)
    for c in range(4):
        ql = qs[:, 32 * c:32 * (c + 1)]
        for half, q4 in ((0, ql & 0xF), (1, ql >> 4)):
            sb = 2 * c + half
            hbit = (qh >> sb) & 1                       # u1 = 1 << sb
            q = q4.astype(np.float32) + hbit.astype(np.float32) * 16.0
            dl = d[:, 0] * scales[:, sb]
            ml = dmin[:, 0] * mins[:, sb]
            out[:, 64 * c + 32 * half:64 * c + 32 * (half + 1)] = \
                dl[:, None] * q - ml[:, None]
    return out


def _deq_q6_k(b):
    ql = b[:, :128]
    qh = b[:, 128:192]
    sc = b[:, 192:208].view(np.int8).astype(np.float32)   # [n, 16]
    d = _f16(b[:, 208:210])                               # [n, 1]
    out = np.empty((b.shape[0], 256), dtype=np.float32)
    for half in range(2):                                 # 128 values each
        l = np.arange(32)
        qlh = ql[:, 64 * half:64 * (half + 1)]
        qhh = qh[:, 32 * half:32 * (half + 1)]
        s = sc[:, 8 * half:8 * (half + 1)]
        scale_of = np.arange(32) // 16                    # [32] -> 0/1
        for quarter, q in enumerate((
                (qlh[:, :32] & 0xF) | (((qhh >> 0) & 3) << 4),
                (qlh[:, 32:] & 0xF) | (((qhh >> 2) & 3) << 4),
                (qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4),
                (qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4))):
            dl = d[:, 0:1] * s[:, 2 * quarter + scale_of]  # [n, 32]
            out[:, 128 * half + 32 * quarter:
                128 * half + 32 * (quarter + 1)] = \
                dl * (q.astype(np.int16) - 32).astype(np.float32)
    return out


def _deq_q2_k(b):
    scales = b[:, :16]                                    # [n, 16]
    qs = b[:, 16:80]                                      # [n, 64]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    out = np.empty((b.shape[0], 256), dtype=np.float32)
    is_ = 0
    for n128 in range(2):                                 # q += 32 per half
        q = qs[:, 32 * n128:32 * (n128 + 1)]
        for j in range(4):                                # shift 0/2/4/6
            for sub, ql in ((0, q[:, :16]), (1, q[:, 16:])):
                sc = scales[:, is_]
                dl = d[:, 0] * (sc & 0xF).astype(np.float32)
                ml = dmin[:, 0] * (sc >> 4).astype(np.float32)
                vals = ((ql >> (2 * j)) & 3).astype(np.float32)
                base = 128 * n128 + 32 * j + 16 * sub
                out[:, base:base + 16] = dl[:, None] * vals - ml[:, None]
                is_ += 1
        is_ = 8 * (n128 + 1)
    return out


def _deq_q3_k(b):
    hmask = b[:, :32]                                     # [n, 32]
    qs = b[:, 32:96]                                      # [n, 64]
    raw_sc = b[:, 96:108]                                 # [n, 12]
    d_all = _f16(b[:, 108:110])
    # 6-bit scales via the ggml kmask shuffle.
    aux = raw_sc.copy().view(np.uint32)                   # [n, 3]
    kmask1, kmask2 = 0x03030303, 0x0F0F0F0F
    tmp = aux[:, 2]
    out_aux = np.empty((b.shape[0], 4), dtype=np.uint32)
    out_aux[:, 0] = (aux[:, 0] & kmask2) | (((tmp >> 0) & kmask1) << 4)
    out_aux[:, 1] = (aux[:, 1] & kmask2) | (((tmp >> 2) & kmask1) << 4)
    out_aux[:, 2] = ((aux[:, 0] >> 4) & kmask2) | \
        (((tmp >> 4) & kmask1) << 4)
    out_aux[:, 3] = ((aux[:, 1] >> 4) & kmask2) | \
        (((tmp >> 6) & kmask1) << 4)
    scales = out_aux.view(np.int8).astype(np.float32) - 32  # [n, 16]

    out = np.empty((b.shape[0], 256), dtype=np.float32)
    is_ = 0
    m_bit = 0
    for n128 in range(2):
        q = qs[:, 32 * n128:32 * (n128 + 1)]
        for j in range(4):
            for sub, (ql, hm) in ((0, (q[:, :16], hmask[:, :16])),
                                  (1, (q[:, 16:], hmask[:, 16:]))):
                dl = d_all[:, 0] * scales[:, is_]
                vals = ((ql >> (2 * j)) & 3).astype(np.int8)
                vals = vals - np.where((hm >> m_bit) & 1, 0, 4).astype(
                    np.int8)
                base = 128 * n128 + 32 * j + 16 * sub
                out[:, base:base + 16] = \
                    dl[:, None] * vals.astype(np.float32)
                is_ += 1
            m_bit += 1
    return out


_DEQUANT = {
    "Q4_0": _deq_q4_0, "Q4_1": _deq_q4_1, "Q5_0": _deq_q5_0,
    "Q5_1": _deq_q5_1, "Q8_0": _deq_q8_0, "Q2_K": _deq_q2_k,
    "Q3_K": _deq_q3_k, "Q4_K": _deq_q4_k, "Q5_K": _deq_q5_k,
    "Q6_K": _deq_q6_k,
}


def dequantize(raw: bytes, ggml_type: int, shape) -> np.ndarray:
    tname, block, bpb = GGML_TYPES[ggml_type]
    if tname == "F32":
        return np.frombuffer(raw, dtype="<f4").reshape(shape).copy()
    if tname == "F16":
        return np.frombuffer(raw, dtype="<f2").reshape(shape)
    if tname == "BF16":
        u = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return u.view(np.float32).reshape(shape)
    blocks = np.frombuffer(raw, dtype=np.uint8).reshape(-1, bpb)
    return _DEQUANT[tname](blocks).reshape(shape)


# ------------------------------------------------------------------
# llama.cpp -> HF naming and config extraction
# ------------------------------------------------------------------

def _hf_name(gguf_name: str) -> str:
    """Map llama.cpp tensor names to HF (reference tensor_mapping,
    hf_downloader.py:217-252)."""
    fixed = {
        "token_embd.weight": "model.embed_tokens.weight",
        "output.weight": "lm_head.weight",
        "output_norm.weight": "model.norm.weight",
    }
    if gguf_name in fixed:
        return fixed[gguf_name]
    if not gguf_name.startswith("blk."):
        raise ValueError(f"Unknown GGUF tensor {gguf_name}")
    _, bid, rest = gguf_name.split(".", 2)
    sub = {
        "attn_norm.weight": "input_layernorm.weight",
        "attn_q.weight": "self_attn.q_proj.weight",
        "attn_k.weight": "self_attn.k_proj.weight",
        "attn_v.weight": "self_attn.v_proj.weight",
        "attn_output.weight": "self_attn.o_proj.weight",
        "ffn_norm.weight": "post_attention_layernorm.weight",
        "ffn_up.weight": "mlp.up_proj.weight",
        "ffn_down.weight": "mlp.down_proj.weight",
        "ffn_gate.weight": "mlp.gate_proj.weight",
    }
    if rest not in sub:
        raise ValueError(f"Unknown GGUF tensor {gguf_name}")
    return f"model.layers.{bid}.{sub[rest]}"


def _reverse_hf_permute(w: np.ndarray, n_heads: int) -> np.ndarray:
    """Invert llama.cpp's q/k row permutation.

    llama.cpp's convert script rewrites HF q_proj/k_proj as
    reshape(n_head, 2, rows//n_head//2, cols).swapaxes(1, 2) so the
    weights match its interleaved (gptj-style) RoPE. Our llama model
    applies neox-style rotate-half RoPE on HF-layout weights, so GGUF
    tensors must be permuted back (transformers' GGUF integration does
    the same)."""
    rows, cols = w.shape
    return (w.reshape(n_heads, rows // n_heads // 2, 2, cols)
            .swapaxes(1, 2)
            .reshape(rows, cols))


class RawGGUF:
    """A still-quantized tensor handed to GGUFLinearMethod: the packed
    ggml blocks plus enough metadata to repack for the at-rest Pallas
    matmuls (layers/quantization/gguf.py). `compat` marks members of
    MIXED sibling groups: they convert to the shared grouped-int8 form
    instead of their native packing."""

    __slots__ = ("type_name", "blocks", "shape", "compat")

    def __init__(self, type_name: str, blocks: np.ndarray,
                 shape: Tuple[int, int], compat: bool = False) -> None:
        self.type_name = type_name
        self.blocks = blocks          # [n_blocks, bytes_per_block] u8
        self.shape = shape            # (out_features, in_features)
        self.compat = compat


# ggml formats with a NATIVE at-rest packing of their own (Q6_K's
# native form IS the shared grouped-int8, so it routes through 'i8g');
# weight name fragments that route through a LinearMethod (projection
# matmuls only — embeddings, norms, lm_head always dequantize).
_NATIVE_PACKED = ("Q4_K", "Q8_0")
_PROJ_FRAGMENTS = ("q_proj", "k_proj", "v_proj", "o_proj",
                   "gate_proj", "up_proj", "down_proj")
# Shards merged into one matmul must agree on representation: a merged
# layer can't be half packed, half dense (apply() dispatches on the
# bucket's param names). llama.cpp mixes types inside qkv (attn_v is
# often Q6_K in Q4_K_M files), so at-rest routing is per GROUP: a
# uniform group keeps its native packing; a mixed group whose members
# are all block-quantized unifies on grouped int8 (exact for
# Q6_K/Q8_0, a negligible requantization for the rest) — only groups
# containing fp tensors fall back to dense.
_STACKED_SIBLINGS = {
    "q_proj": ("q_proj", "k_proj", "v_proj"),
    "k_proj": ("q_proj", "k_proj", "v_proj"),
    "v_proj": ("q_proj", "k_proj", "v_proj"),
    "gate_proj": ("gate_proj", "up_proj"),
    "up_proj": ("gate_proj", "up_proj"),
}


def _fragment(name: str):
    """The projection fragment of an HF weight name, or None."""
    return next((f for f in _PROJ_FRAGMENTS if f".{f}." in name), None)


def at_rest_groups(reader: GGUFReader
                   ) -> Dict[str, Tuple[Any, bool]]:
    """{hf_name: (mode, mixed)} for every projection tensor of the file,
    from its header alone: mode 'native' (uniform at-rest type), 'i8g'
    (all-quantized -> shared grouped-int8), or None (dense fallback);
    `mixed` is True only when the siblings of its merged bucket actually
    DISAGREE on type -- a uniform non-native group (e.g. all-Q4_0,
    all-Q6_K) is not mixed and keeps its per-format routing in the
    linear method."""
    type_of = {}
    for info in reader.tensors:
        try:
            type_of[_hf_name(info.name)] = GGML_TYPES[info.ggml_type][0]
        except ValueError:
            pass
    groups = {}
    for name in type_of:
        frag = _fragment(name)
        if frag is None:
            continue
        sibs = _STACKED_SIBLINGS.get(frag, (frag,))
        types = {type_of.get(name.replace(frag, s)) for s in sibs}
        if len(types) == 1 and types <= set(_NATIVE_PACKED):
            groups[name] = ("native", False)
        elif types <= set(_DEQUANT):     # incl. uniform Q6_K
            groups[name] = ("i8g", len(types) > 1)
        else:
            groups[name] = (None, False)
    return groups


def gguf_weights_iterator(path: str, at_rest: bool = False
                          ) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (hf_name, tensor) for every tensor in the file. Block
    formats dequantize on the fly; with `at_rest`, block-quantized
    projection weights instead yield RawGGUF packed blocks for the
    quantized execution path."""
    reader = GGUFReader(path)
    n_heads = int(reader.fields.get("llama.attention.head_count", 0))
    n_kv = int(reader.fields.get("llama.attention.head_count_kv",
                                 n_heads))
    groups = at_rest_groups(reader)

    for info in reader.tensors:
        try:
            name = _hf_name(info.name)
        except ValueError:
            # Auxiliary tensors (rope_freqs.weight, *.attn_rot_embd, ...)
            # carry no model weights.
            logger.debug("Skipping GGUF tensor %s", info.name)
            continue
        tname, block, bpb = GGML_TYPES[info.ggml_type]
        mode, mixed = groups.get(name, (None, False))
        if (at_rest and tname in _DEQUANT and
                len(info.shape) == 2 and mode is not None):
            with open(reader.path, "rb") as f:
                f.seek(reader.data_start + info.offset)
                raw = np.frombuffer(f.read(info.n_bytes), np.uint8)
            blocks = raw.reshape(-1, bpb)
            out_f, in_f = info.shape
            if name.endswith("self_attn.q_proj.weight") and n_heads:
                blocks = _permute_raw_rows(blocks, out_f, in_f, block,
                                           n_heads)
            elif name.endswith("self_attn.k_proj.weight") and n_kv:
                blocks = _permute_raw_rows(blocks, out_f, in_f, block,
                                           n_kv)
            yield name, RawGGUF(tname, blocks, (out_f, in_f),
                                compat=mixed)
            continue
        arr = reader.load(info)
        if name.endswith("self_attn.q_proj.weight") and n_heads:
            arr = _reverse_hf_permute(arr, n_heads)
        elif name.endswith("self_attn.k_proj.weight") and n_kv:
            arr = _reverse_hf_permute(arr, n_kv)
        yield name, arr


def _permute_raw_rows(blocks: np.ndarray, out_f: int, in_f: int,
                      block_elems: int, n_heads: int) -> np.ndarray:
    """Apply _reverse_hf_permute's OUT-row permutation to packed blocks:
    blocks are row-major over [out, in/block], so permuting out rows
    permutes whole groups of in/block blocks."""
    per_row = in_f // block_elems
    b = blocks.reshape(out_f, per_row, blocks.shape[1])
    b = (b.reshape(n_heads, out_f // n_heads // 2, 2, per_row,
                   blocks.shape[1])
         .swapaxes(1, 2)
         .reshape(out_f, per_row, blocks.shape[1]))
    return np.ascontiguousarray(b.reshape(-1, blocks.shape[1]))


def extract_gguf_config(path: str):
    """The model config from GGUF llama.* metadata, as a
    `ModelJsonConfig` with HF LlamaConfig's defaults for the keys the
    metadata leaves out (the JAX package builds a transformers
    LlamaConfig from the same keys; reference
    `transformers_utils/config.py:14-64`)."""
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    r = GGUFReader(path)
    f = r.fields
    arch = f.get("general.architecture")
    if arch != "llama":
        raise ValueError(f"Unsupported GGUF architecture {arch!r}")
    cfg = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        # tokenizer-less files (tests, raw conversions) fall back to
        # llama.vocab_size.
        "vocab_size": (len(f["tokenizer.ggml.tokens"])
                       if "tokenizer.ggml.tokens" in f
                       else int(f["llama.vocab_size"])),
        "hidden_size": int(f["llama.embedding_length"]),
        "intermediate_size": int(f["llama.feed_forward_length"]),
        "max_position_embeddings": int(f["llama.context_length"]),
        "num_attention_heads": int(f["llama.attention.head_count"]),
        "num_hidden_layers": int(f["llama.block_count"]),
        "num_key_value_heads": int(
            f.get("llama.attention.head_count_kv",
                  f["llama.attention.head_count"])),
        "rms_norm_eps": float(
            f.get("llama.attention.layer_norm_rms_epsilon", 1e-5)),
        "torch_dtype": "float16",
        "bos_token_id": int(f.get("tokenizer.ggml.bos_token_id", 1)),
        "eos_token_id": int(f.get("tokenizer.ggml.eos_token_id", 2)),
        "tie_word_embeddings": not any(
            t.name == "output.weight" for t in r.tensors),
    }
    if "llama.rope.freq_base" in f:
        cfg["rope_theta"] = float(f["llama.rope.freq_base"])
    return config_from_dict(cfg)


# ------------------------------------------------------------------
# Quantizers (testing + producing small GGUF files offline)
# ------------------------------------------------------------------

def quantize_q8_0(w: np.ndarray) -> bytes:
    """Per-32 block symmetric int8 (ggml quantize_row_q8_0)."""
    flat = w.astype(np.float32).reshape(-1, 32)
    amax = np.abs(flat).max(axis=1, keepdims=True)
    d = amax / 127.0
    q = np.where(d > 0, np.round(flat / np.where(d == 0, 1, d)), 0)
    q = np.clip(q, -127, 127).astype(np.int8)
    out = np.empty((flat.shape[0], 34), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def quantize_q4_0(w: np.ndarray) -> bytes:
    """Per-32 block 4-bit with shared scale (ggml quantize_row_q4_0)."""
    flat = w.astype(np.float32).reshape(-1, 32)
    idx = np.abs(flat).argmax(axis=1)
    maxv = flat[np.arange(flat.shape[0]), idx]
    d = maxv / -8.0
    inv = np.where(d == 0, 0, 1.0 / np.where(d == 0, 1, d))
    q = np.clip(np.floor(flat * inv[:, None] + 8.5), 0, 15).astype(
        np.uint8)
    out = np.empty((flat.shape[0], 18), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


_QUANTIZERS = {"Q8_0": (quantize_q8_0, 8), "Q4_0": (quantize_q4_0, 2)}


def write_gguf(path: str, metadata: Dict[str, Any],
               tensors: Dict[str, Any]) -> None:
    """Minimal GGUF v3 writer (tests + offline conversion). `tensors`
    maps gguf-name -> (float array, type name in F32|F16|Q8_0|Q4_0), or
    to a `RawGGUF`, whose blocks (any block type, e.g. Q4_K or Q6_K) are
    written as they are."""
    by_id = {v[0]: k for k, v in GGML_TYPES.items()}

    def w_str(f, s):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def w_value(f, v):
        if isinstance(v, bool):
            f.write(struct.pack("<I", _T_BOOL) + struct.pack("<B", v))
        elif isinstance(v, int):
            f.write(struct.pack("<I", _T_U32) + struct.pack("<I", v))
        elif isinstance(v, float):
            f.write(struct.pack("<I", _T_F32) + struct.pack("<f", v))
        elif isinstance(v, str):
            f.write(struct.pack("<I", _T_STR))
            w_str(f, v)
        elif isinstance(v, list):
            f.write(struct.pack("<I", _T_ARR))
            if not v or isinstance(v[0], str):
                f.write(struct.pack("<I", _T_STR))
                f.write(struct.pack("<Q", len(v)))
                for s in v:
                    w_str(f, s)
            elif isinstance(v[0], float):
                f.write(struct.pack("<I", _T_F32))
                f.write(struct.pack("<Q", len(v)))
                f.write(np.asarray(v, dtype="<f4").tobytes())
            else:
                f.write(struct.pack("<I", _T_I32))
                f.write(struct.pack("<Q", len(v)))
                f.write(np.asarray(v, dtype="<i4").tobytes())
        else:
            raise TypeError(type(v))

    payloads = []
    infos = []
    offset = 0
    align = 32
    for name, value in tensors.items():
        if isinstance(value, RawGGUF):
            tname, shape = value.type_name, value.shape
            raw = np.ascontiguousarray(value.blocks, np.uint8).tobytes()
        else:
            arr, tname = value
            shape = arr.shape
            if tname == "F32":
                raw = arr.astype("<f4").tobytes()
            elif tname == "F16":
                raw = arr.astype("<f2").tobytes()
            else:
                raw = _QUANTIZERS[tname][0](arr)
        infos.append((name, shape, by_id[tname], offset))
        payloads.append(raw)
        offset += (len(raw) + align - 1) // align * align

    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<QQ", len(infos), len(metadata)))
        for k, v in metadata.items():
            w_str(f, k)
            w_value(f, v)
        for name, shape, tid, off in infos:
            w_str(f, name)
            f.write(struct.pack("<I", len(shape)))
            for dim in reversed(shape):       # fastest-varying first
                f.write(struct.pack("<Q", dim))
            f.write(struct.pack("<I", tid))
            f.write(struct.pack("<Q", off))
        pos = f.tell()
        f.write(b"\x00" * ((pos + align - 1) // align * align - pos))
        for raw in payloads:
            f.write(raw)
            pad = (len(raw) + align - 1) // align * align - len(raw)
            f.write(b"\x00" * pad)
