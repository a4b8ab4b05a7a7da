"""JAX's threefry random draws, in PyTorch.

The JAX package draws every sampled token with `jax.random`: one key per
row, `fold_in(fold_in(PRNGKey(base), salt1), salt2)`, then
`jax.random.categorical` (the Gumbel-max trick). This module computes the
same bits with plain tensor ops on the logits' device, so a seeded
request gives the same tokens in both packages. It follows the JAX
version the repo pins (0.9.0, `jax_threefry_partitionable=True`, x64
off):

- `threefry2x32`: the Threefry-2x32 block cipher, 20 rounds, key
  schedule parity constant 0x1BD11BDA.
- `prng_key(seed)`: JAX with x64 off holds the seed as int32, whose
  logical shift by 32 is 0, so the key is (0, seed mod 2**32) for every
  seed, negative ones and those of 2**31 and above included.
- `fold_in(key, data)`: threefry of the counter pair (0, data as uint32).
- `random_bits(keys, shape)`: element n of the flat shape hashes the
  counter pair (n >> 32, n mod 2**32) and xors the two output words.
- `uniform`: the top 23 bits as the mantissa of a float in [1, 2), minus
  1, scaled to [minval, maxval) and floored at minval.
- `gumbel` (JAX's mode "low"): -log(-log(u)) for u uniform in
  [finfo.tiny, 1).
- `categorical(keys, logits, num)`: argmax over the vocabulary of
  gumbel((num, V)) + logits, per row.

Values are uint32 held in int64 tensors and masked to 32 bits after each
add and shift: PyTorch's uint32 support is partial on both the CPU and
CUDA. Every function is vectorised over rows: `keys` is [rows, 2].
The JAX package draws with XLA, not with a Pallas kernel, so plain
tensor ops are the matching level here.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000                 # float32 1.0
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK32) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (x1, x2) under the key (k1,
    k2); every argument an int64 tensor of uint32 values, broadcast
    together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _MASK32
    b = (x2 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return a, b


def prng_key(seeds: torch.Tensor) -> torch.Tensor:
    """[rows, 2] keys of `PRNGKey(seed)` for integer seeds [rows]."""
    lo = seeds.to(torch.int64) & _MASK32
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """[rows, 2] keys of `fold_in(key, data)`, data taken as uint32."""
    d = data.to(torch.int64) & _MASK32
    a, b = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def row_keys(bases: torch.Tensor, salt1: torch.Tensor,
             salt2: torch.Tensor) -> torch.Tensor:
    """fold_in(fold_in(PRNGKey(base), salt1), salt2) for every row."""
    return fold_in(fold_in(prng_key(bases), salt1), salt2)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """[rows, *shape] uint32 bits (in int64) of `random_bits(key, 32,
    shape)` for each row's key."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    k1, k2 = keys[:, 0:1], keys[:, 1:2]
    a, b = threefry2x32(k1, k2, idx >> 32, idx & _MASK32)
    return (a ^ b).reshape(keys.shape[0], *shape)


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """[rows, *shape] float32 uniforms in [minval, maxval), JAX's bits."""
    bits = (random_bits(keys, shape) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    span = torch.tensor(maxval, dtype=torch.float32,
                        device=keys.device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """[rows, *shape] float32 standard Gumbel noise (JAX's mode "low")."""
    u = uniform(keys, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor,
                num: Optional[int] = None) -> torch.Tensor:
    """Draws from softmax(logits) per row: [rows, num] for `shape=(num,)`,
    or [rows] for JAX's default shape (the same bits as num=1)."""
    vocab = logits.shape[-1]
    g = gumbel(keys, (num or 1, vocab))
    out = torch.argmax(g + logits.float()[:, None, :], dim=-1)
    return out if num is not None else out[:, 0]
