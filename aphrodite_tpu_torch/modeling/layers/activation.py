"""Activations in plain PyTorch (port of
`aphrodite_tpu/modeling/layers/activation.py`): the SwiGLU and GeGLU
combines and the pointwise activations the architectures name in their
configs (`hidden_act` / `activation_function`), looked up by
`get_act_fn`."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def silu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """SwiGLU combine: [..., 2d] -> silu(x[..., :d]) * x[..., d:]."""
    gate, up = x.chunk(2, dim=-1)
    return F.silu(gate) * up


def gelu_and_mul(x: torch.Tensor) -> torch.Tensor:
    """GeGLU combine with the exact (erf) gelu."""
    gate, up = x.chunk(2, dim=-1)
    return F.gelu(gate) * up


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF 'new' gelu (tanh approximation over the x^3 term)."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * x *
                                       (1.0 + 0.044715 * x * x)))


_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": F.gelu,
    "gelu_new": gelu_new,
    "gelu_fast": gelu_fast,
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def get_act_fn(name: str):
    """Activation lookup by HF config `hidden_act` name."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"Activation function {name!r} is not supported.")
    return _ACTIVATIONS[name]
