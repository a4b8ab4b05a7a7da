"""Rotary position embeddings with long-context scaling, in PyTorch.

Port of `aphrodite_tpu/modeling/layers/rotary_embedding.py`: the same
cos/sin caches, computed once in numpy exactly as the JAX package
computes them (plain RoPE and the linear, dynamic-NTK and YaRN scalings
a Llama config may name), then gathered by position on the device.
Both 'neox' (rotate-half) and 'gptj' (interleaved) styles are supported.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                is_neox_style: bool) -> torch.Tensor:
    """x: [..., heads, rot_dim]; cos/sin: [..., 1, rot_dim // 2]."""
    if is_neox_style:
        x1, x2 = x.chunk(2, dim=-1)
        o1 = x1 * cos - x2 * sin
        o2 = x2 * cos + x1 * sin
        return torch.cat([o1, o2], dim=-1)
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape)


class RotaryEmbedding:
    """Plain RoPE with a precomputed float32 cos/sin cache
    [max_positions, rot_dim] storing [cos | sin] halves."""

    def __init__(
        self,
        head_size: int,
        rotary_dim: int,
        max_position_embeddings: int,
        base: float,
        is_neox_style: bool,
    ) -> None:
        self.head_size = head_size
        self.rotary_dim = rotary_dim
        self.max_position_embeddings = max_position_embeddings
        self.base = base
        self.is_neox_style = is_neox_style
        self.cos_sin_cache = self._compute_cos_sin_cache()
        self._device_caches: Dict[torch.device, torch.Tensor] = {}

    def _compute_inv_freq(self, base: float) -> np.ndarray:
        return 1.0 / (base ** (np.arange(0, self.rotary_dim, 2,
                                         dtype=np.float32) /
                               self.rotary_dim))

    def _compute_cos_sin_cache(self) -> np.ndarray:
        inv_freq = self._compute_inv_freq(self.base)
        t = np.arange(self.max_position_embeddings, dtype=np.float32)
        freqs = np.einsum("i,j->ij", t, inv_freq)
        return np.concatenate([np.cos(freqs), np.sin(freqs)],
                              axis=-1).astype(np.float32)

    def _cache_on(self, device: torch.device) -> torch.Tensor:
        cache = self._device_caches.get(device)
        if cache is None:
            cache = torch.from_numpy(self.cos_sin_cache).to(device)
            self._device_caches[device] = cache
        return cache

    def __call__(self, positions: torch.Tensor, query: torch.Tensor,
                 key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions: [...]; query/key: [..., num_heads, head_size].
        Only the first rotary_dim dims of each head are rotated."""
        cos_sin = self._cache_on(query.device)[positions.long()]
        cos, sin = cos_sin.chunk(2, dim=-1)
        cos = cos.unsqueeze(-2).to(query.dtype)       # [..., 1, rot/2]
        sin = sin.unsqueeze(-2).to(query.dtype)
        if self.rotary_dim == self.head_size:
            return (_apply_rope(query, cos, sin, self.is_neox_style),
                    _apply_rope(key, cos, sin, self.is_neox_style))
        q_rot = _apply_rope(query[..., :self.rotary_dim], cos, sin,
                            self.is_neox_style)
        k_rot = _apply_rope(key[..., :self.rotary_dim], cos, sin,
                            self.is_neox_style)
        return (torch.cat([q_rot, query[..., self.rotary_dim:]], -1),
                torch.cat([k_rot, key[..., self.rotary_dim:]], -1))


class LinearScalingRotaryEmbedding(RotaryEmbedding):
    """Positions divided by a constant factor (reference `:151`)."""

    def __init__(self, head_size, rotary_dim, max_position_embeddings, base,
                 is_neox_style, scaling_factor: float) -> None:
        self.scaling_factor = scaling_factor
        super().__init__(head_size, rotary_dim, max_position_embeddings,
                         base, is_neox_style)

    def _compute_cos_sin_cache(self) -> np.ndarray:
        inv_freq = self._compute_inv_freq(self.base)
        max_len = int(self.max_position_embeddings * self.scaling_factor)
        t = np.arange(max_len, dtype=np.float32) / self.scaling_factor
        freqs = np.einsum("i,j->ij", t, inv_freq)
        return np.concatenate([np.cos(freqs), np.sin(freqs)],
                              axis=-1).astype(np.float32)


class DynamicNTKScalingRotaryEmbedding(RotaryEmbedding):
    """NTK-aware base rescaling for the extended range (reference `:186-223`).

    Matches the reference exactly: one static cache for the full extended
    window built with the max-length base (reference `_compute_cos_sin_cache`
    `:205-215` does the same). Note this diverges from HF transformers'
    truly-dynamic variant, which recomputes the base from the running
    seq_len and so uses the ORIGINAL base while seq_len <= original
    max_position_embeddings; serving with a paged KV cache can't re-rotate
    cached keys when the base changes, so the static choice is the only
    coherent one (and is what the reference ships).
    """

    def __init__(self, head_size, rotary_dim, max_position_embeddings, base,
                 is_neox_style, scaling_factor: float) -> None:
        self.scaling_factor = scaling_factor
        super().__init__(head_size, rotary_dim, max_position_embeddings,
                         base, is_neox_style)

    def _compute_cos_sin_cache(self) -> np.ndarray:
        max_len = int(self.max_position_embeddings * self.scaling_factor)
        base = self.base * (
            (self.scaling_factor * max_len / self.max_position_embeddings) -
            (self.scaling_factor - 1)) ** (self.rotary_dim /
                                           (self.rotary_dim - 2))
        inv_freq = self._compute_inv_freq(base)
        t = np.arange(max_len, dtype=np.float32)
        freqs = np.einsum("i,j->ij", t, inv_freq)
        return np.concatenate([np.cos(freqs), np.sin(freqs)],
                              axis=-1).astype(np.float32)


def _yarn_find_correction_dim(num_rotations: float, dim: int, base: float,
                              max_position_embeddings: int) -> float:
    return (dim * math.log(max_position_embeddings /
                           (num_rotations * 2 * math.pi))) / \
        (2 * math.log(base))


def _yarn_find_correction_range(low_rot: float, high_rot: float, dim: int,
                                base: float,
                                max_position_embeddings: int
                                ) -> Tuple[int, int]:
    low = math.floor(_yarn_find_correction_dim(low_rot, dim, base,
                                               max_position_embeddings))
    high = math.ceil(_yarn_find_correction_dim(high_rot, dim, base,
                                               max_position_embeddings))
    return max(low, 0), min(high, dim - 1)


def _yarn_linear_ramp_mask(low: float, high: float,
                           dim: int) -> np.ndarray:
    if low == high:
        high += 0.001
    ramp = (np.arange(dim, dtype=np.float32) - low) / (high - low)
    return np.clip(ramp, 0, 1)


def _yarn_get_mscale(scale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * math.log(scale) + 1.0


class YaRNScalingRotaryEmbedding(RotaryEmbedding):
    """YaRN: NTK-by-parts interpolation + attention mscale (reference
    `rotary_embedding.py:268-328`)."""

    def __init__(self, head_size, rotary_dim, max_position_embeddings, base,
                 is_neox_style, scaling_factor: float, *,
                 extrapolation_factor: float = 1.0,
                 attn_factor: float = 1.0, beta_fast: int = 32,
                 beta_slow: int = 1) -> None:
        self.scaling_factor = scaling_factor
        self.extrapolation_factor = extrapolation_factor
        self.attn_factor = attn_factor
        self.beta_fast = beta_fast
        self.beta_slow = beta_slow
        self.mscale = float(_yarn_get_mscale(scaling_factor) * attn_factor)
        super().__init__(head_size, rotary_dim, max_position_embeddings,
                         base, is_neox_style)

    def _compute_inv_freq(self, scaling_factor: float) -> np.ndarray:
        pos_freqs = self.base ** (np.arange(0, self.rotary_dim, 2,
                                            dtype=np.float32) /
                                  self.rotary_dim)
        inv_freq_extrapolation = 1.0 / pos_freqs
        inv_freq_interpolation = 1.0 / (scaling_factor * pos_freqs)
        low, high = _yarn_find_correction_range(
            self.beta_fast, self.beta_slow, self.rotary_dim, self.base,
            self.max_position_embeddings)
        inv_freq_mask = (1 - _yarn_linear_ramp_mask(
            low, high, self.rotary_dim // 2)) * self.extrapolation_factor
        return (inv_freq_interpolation * (1 - inv_freq_mask) +
                inv_freq_extrapolation * inv_freq_mask)

    def _compute_cos_sin_cache(self) -> np.ndarray:
        inv_freq = self._compute_inv_freq(self.scaling_factor)
        max_len = int(self.max_position_embeddings * self.scaling_factor)
        t = np.arange(max_len, dtype=np.float32)
        freqs = np.einsum("i,j->ij", t, inv_freq)
        return np.concatenate(
            [np.cos(freqs) * self.mscale, np.sin(freqs) * self.mscale],
            axis=-1).astype(np.float32)


_ROPE_CACHE: Dict[Any, RotaryEmbedding] = {}


def get_rope(
    head_size: int,
    rotary_dim: int,
    max_position: int,
    base: float,
    is_neox_style: bool = True,
    rope_scaling: Optional[Dict[str, Any]] = None,
) -> RotaryEmbedding:
    """Factory + cache (reference `rotary_embedding.py:333-379`)."""
    key = (head_size, rotary_dim, max_position, base, is_neox_style,
           tuple(sorted(rope_scaling.items())) if rope_scaling else None)
    if key in _ROPE_CACHE:
        return _ROPE_CACHE[key]

    if rope_scaling is None:
        rope = RotaryEmbedding(head_size, rotary_dim, max_position, base,
                               is_neox_style)
    else:
        scaling_type = rope_scaling.get("type",
                                        rope_scaling.get("rope_type"))
        factor = rope_scaling.get("factor", 1.0)
        if scaling_type == "linear":
            rope = LinearScalingRotaryEmbedding(head_size, rotary_dim,
                                                max_position, base,
                                                is_neox_style, factor)
        elif scaling_type == "dynamic":
            rope = DynamicNTKScalingRotaryEmbedding(head_size, rotary_dim,
                                                    max_position, base,
                                                    is_neox_style, factor)
        elif scaling_type == "yarn":
            original_max = rope_scaling.get(
                "original_max_position_embeddings", max_position)
            extra = {
                k: v for k, v in rope_scaling.items()
                if k in ("extrapolation_factor", "attn_factor", "beta_fast",
                         "beta_slow")
            }
            rope = YaRNScalingRotaryEmbedding(head_size, rotary_dim,
                                              original_max, base,
                                              is_neox_style, factor, **extra)
        else:
            raise ValueError(f"Unknown RoPE scaling type {scaling_type}")
    _ROPE_CACHE[key] = rope
    return rope
