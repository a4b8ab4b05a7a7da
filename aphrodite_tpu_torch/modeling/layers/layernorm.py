"""RMSNorm and LayerNorm in plain PyTorch (port of
`aphrodite_tpu/modeling/layers/layernorm.py`); float32 accumulation
whatever the activation dtype."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x / rms(x) * weight, computed in float32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Mean-centred LayerNorm with a bias (the OPT, GPT-J, GPT-NeoX and
    Phi families), computed in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm_params(hidden: int, dtype: torch.dtype,
                      device) -> Dict[str, torch.Tensor]:
    """An (uninitialized) LayerNorm's weight and bias."""
    return {"weight": torch.empty((hidden,), dtype=dtype, device=device),
            "bias": torch.empty((hidden,), dtype=dtype, device=device)}


def fused_add_rms_norm(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    weight: torch.Tensor,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual add + RMSNorm: returns (normed, new_residual); with no
    residual the input itself becomes the residual stream."""
    if residual is not None:
        x = x + residual
    return rms_norm(x, weight, eps), x
