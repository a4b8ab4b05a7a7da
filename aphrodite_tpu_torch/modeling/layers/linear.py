"""Linear layers of the PyTorch port (single GPU, unquantized).

Port of `aphrodite_tpu/modeling/layers/linear.py` at tp=1: the same
classes and the same fused projections (`qkv_proj`, `gate_up_proj`),
with torch's weight layout [out_features, in_features] (HF checkpoints
load as they are; the JAX package transposed to [in, out]). A layer
owns no tensors: its parameters live in the model's parameter dict and
are passed in, as in the JAX package. The parallel classes keep their
names for parity; with one GPU they shard nothing.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

ParamDict = Dict[str, torch.Tensor]


class LinearMethod:
    """Creates and applies the weights of an unquantized linear layer."""

    def create_weights(self, in_features: int, out_features: int,
                       dtype: torch.dtype, bias: bool,
                       device: torch.device) -> ParamDict:
        params = {"weight": torch.empty((out_features, in_features),
                                        dtype=dtype, device=device)}
        if bias:
            params["bias"] = torch.empty((out_features,), dtype=dtype,
                                         device=device)
        return params

    def apply(self, params: ParamDict, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, params["weight"], params.get("bias"))


class LinearBase:
    """Shape bookkeeping shared by the linear layers."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = False, dtype: torch.dtype = torch.bfloat16,
                 linear_method: Optional[LinearMethod] = None) -> None:
        self.in_features = in_features
        self.out_features = out_features
        self.bias = bias
        self.dtype = dtype
        self.linear_method = linear_method or LinearMethod()

    def init(self, device: torch.device) -> ParamDict:
        return self.linear_method.create_weights(
            self.in_features, self.out_features, self.dtype, self.bias,
            device)

    def __call__(self, params: ParamDict, x: torch.Tensor) -> torch.Tensor:
        return self.linear_method.apply(params, x)

    def weight_loader(self, params: ParamDict, name: str,
                      hf_tensor: torch.Tensor, shard_id=None) -> None:
        params[name] = hf_tensor


class ColumnParallelLinear(LinearBase):
    pass


class RowParallelLinear(LinearBase):
    pass


class _ShardedLoadMixin(LinearBase):
    """Places one HF tensor into its slice of a merged parameter (output
    rows [offset, offset + size))."""

    def _write_shard(self, params: ParamDict, name: str,
                     tensor: torch.Tensor, offset: int, size: int) -> None:
        if name not in params:
            params[name] = torch.zeros((self.out_features,) +
                                       tuple(tensor.shape[1:]),
                                       dtype=tensor.dtype,
                                       device=tensor.device)
        params[name][offset:offset + size] = tensor


class MergedColumnParallelLinear(_ShardedLoadMixin, ColumnParallelLinear):
    """Several column outputs fused in one matmul, e.g. gate+up."""

    def __init__(self, in_features: int, output_sizes, **kw) -> None:
        self.output_sizes = list(output_sizes)
        super().__init__(in_features, sum(self.output_sizes), **kw)

    def weight_loader(self, params: ParamDict, name: str,
                      hf_tensor: torch.Tensor, shard_id=None) -> None:
        if shard_id is None:
            params[name] = hf_tensor
            return
        offset = sum(self.output_sizes[:shard_id])
        self._write_shard(params, name, hf_tensor, offset,
                          self.output_sizes[shard_id])


class QKVParallelLinear(_ShardedLoadMixin, ColumnParallelLinear):
    """Fused QKV projection; the loader slices by 'q' | 'k' | 'v'."""

    def __init__(self, hidden_size: int, head_size: int, num_heads: int,
                 num_kv_heads: Optional[int] = None, **kw) -> None:
        self.hidden_size = hidden_size
        self.head_size = head_size
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads if num_kv_heads is not None \
            else num_heads
        out = (num_heads + 2 * self.num_kv_heads) * head_size
        super().__init__(hidden_size, out, **kw)

    def shard_offsets(self) -> Dict[str, Tuple[int, int]]:
        q = self.num_heads * self.head_size
        kv = self.num_kv_heads * self.head_size
        return {"q": (0, q), "k": (q, kv), "v": (q + kv, kv)}

    def split(self, qkv: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        q = self.num_heads * self.head_size
        kv = self.num_kv_heads * self.head_size
        return qkv[..., :q], qkv[..., q:q + kv], qkv[..., q + kv:]

    def weight_loader(self, params: ParamDict, name: str,
                      hf_tensor: torch.Tensor, shard_id=None) -> None:
        if shard_id is None:
            params[name] = hf_tensor
            return
        offset, size = self.shard_offsets()[shard_id]
        self._write_shard(params, name, hf_tensor, offset, size)
