"""RMSNorm in plain PyTorch (port of
`aphrodite_tpu/modeling/layers/layernorm.py`); float32 accumulation
whatever the activation dtype."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x / rms(x) * weight, computed in float32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


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
