"""Activations in plain PyTorch (port of the SwiGLU combine of
`aphrodite_tpu/modeling/layers/activation.py`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """SwiGLU combine: [..., 2d] -> silu(x[..., :d]) * x[..., d:]."""
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate) * up
