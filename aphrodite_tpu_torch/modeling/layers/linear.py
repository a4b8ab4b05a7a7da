"""Linear layers of the PyTorch port (single GPU).

Port of `aphrodite_tpu/modeling/layers/linear.py` at tp=1: the same
classes and the same fused projections (`qkv_proj`, `gate_up_proj`),
with torch's weight layout [out_features, in_features] (HF checkpoints
load as they are; the JAX package transposed to [in, out]). A layer
owns no tensors: its parameters live in the model's parameter dict and
are passed in, as in the JAX package. The parallel classes keep their
names for parity; with one GPU they shard nothing.

Quantization plugs in through `LinearMethod` objects
(`modeling/layers/quantization/`), which also say how a checkpoint
tensor is converted (`load_weight`) and placed into a merged layer
(`out_scale`). A method may store a checkpoint tensor under another
name and add tensors beside it (GGUF's packed blocks repack into `qs`
with their scales `d`): after `load_weight` it leaves the name in
`pending_rename` and the extra tensors in `pending_sidecar`, and the
layer's weight loader consumes both, placing the sidecar in the same
output slice, as the JAX package's loaders do.
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

    def load_weight(self, params: ParamDict, name: str,
                    hf_tensor: torch.Tensor) -> torch.Tensor:
        """One checkpoint tensor in this method's layout. Every method
        ported so far keeps the checkpoint's: dense weights torch's
        [out, in], GPTQ's packed tensors [.., out]."""
        return hf_tensor

    def out_scale(self, name: str) -> int:
        """Divisor on output-dim offsets and sizes when placing `name`
        into a merged layer (packed formats hold several output channels
        per int32)."""
        return 1


class LinearBase:
    """Shape bookkeeping shared by the linear layers."""

    # Number of stacked sub-projections sharing this layer's matmul
    # (qkv = 3, gate_up = 2); LoRA sizes its merged rank by this.
    packed_factor: int = 1

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = False, dtype: torch.dtype = torch.bfloat16,
                 linear_method: Optional[LinearMethod] = None) -> None:
        self.in_features = in_features
        self.out_features = out_features
        self.bias = bias
        self.dtype = dtype
        self.linear_method = linear_method or LinearMethod()

    def init(self, device: torch.device) -> ParamDict:
        self.linear_method.packed_factor = self.packed_factor
        return self.linear_method.create_weights(
            self.in_features, self.out_features, self.dtype, self.bias,
            device)

    def __call__(self, params: ParamDict, x: torch.Tensor) -> torch.Tensor:
        return self.linear_method.apply(params, x)

    def _convert(self, params: ParamDict, name: str, hf_tensor
                 ) -> Tuple[str, torch.Tensor]:
        """(param name, tensor) of one checkpoint tensor: the method's
        conversion, under its `pending_rename` when it sets one."""
        converted = self.linear_method.load_weight(params, name, hf_tensor)
        rename = getattr(self.linear_method, "pending_rename", None)
        if rename:
            name = rename
            self.linear_method.pending_rename = None
        return name, converted

    def _take_sidecar(self) -> ParamDict:
        """The method's pending sidecar tensors, cleared: one left pending
        would leak into the next layer's shard placement."""
        sidecar = getattr(self.linear_method, "pending_sidecar", None)
        if not sidecar:
            return {}
        self.linear_method.pending_sidecar = None
        return sidecar

    def weight_loader(self, params: ParamDict, name: str,
                      hf_tensor, shard_id=None) -> None:
        name, converted = self._convert(params, name, hf_tensor)
        params[name] = converted
        params.update(self._take_sidecar())


class ColumnParallelLinear(LinearBase):
    pass


class RowParallelLinear(LinearBase):
    pass


class _ShardedLoadMixin(LinearBase):
    """Places one checkpoint tensor into its slice [offset, offset + size)
    of a merged layer's output dim. The dense floating `weight`
    ([out, in]) and SqueezeLLM's `lookup_table` ([out, 16]) have it first;
    every other parameter (bias, the quantized qweight, qzeros and scales,
    which keep the checkpoint's [.., out] layout, GGUF's at-rest [in, out]
    forms and the int8 method's [in, out] int8 `weight`) has it last, with
    offsets divided by the method's `out_scale`. g_idx spans the input
    dim and is the same for every shard."""

    def _write_shard(self, params: ParamDict, name: str,
                     tensor: torch.Tensor, offset: int, size: int) -> None:
        if name == "g_idx":
            params[name] = tensor
            return
        if (name == "weight" and tensor.is_floating_point()) or \
                name == "lookup_table":
            if name not in params:
                params[name] = torch.zeros(
                    (self.out_features,) + tuple(tensor.shape[1:]),
                    dtype=tensor.dtype, device=tensor.device)
            params[name][offset:offset + size] = tensor
            return
        div = self.linear_method.out_scale(name)
        offset //= div
        size //= div
        if name not in params:
            params[name] = torch.zeros(
                tuple(tensor.shape[:-1]) + (self.out_features // div,),
                dtype=tensor.dtype, device=tensor.device)
        params[name][..., offset:offset + size] = tensor

    def _load_shard(self, params: ParamDict, name: str, hf_tensor,
                    offset: int, size: int) -> None:
        """Convert one checkpoint tensor and write it, and the sidecar
        tensors the conversion left pending, into the output slice."""
        name, converted = self._convert(params, name, hf_tensor)
        self._write_shard(params, name, converted, offset, size)
        for pname, tensor in self._take_sidecar().items():
            self._write_shard(params, pname, tensor, offset, size)


class MergedColumnParallelLinear(_ShardedLoadMixin, ColumnParallelLinear):
    """Several column outputs fused in one matmul, e.g. gate+up."""

    def __init__(self, in_features: int, output_sizes, **kw) -> None:
        self.output_sizes = list(output_sizes)
        self.packed_factor = len(self.output_sizes)
        super().__init__(in_features, sum(self.output_sizes), **kw)

    def weight_loader(self, params: ParamDict, name: str,
                      hf_tensor: torch.Tensor, shard_id=None) -> None:
        if shard_id is None:
            super().weight_loader(params, name, hf_tensor)
            return
        offset = sum(self.output_sizes[:shard_id])
        self._load_shard(params, name, hf_tensor, offset,
                         self.output_sizes[shard_id])


class QKVParallelLinear(_ShardedLoadMixin, ColumnParallelLinear):
    """Fused QKV projection; the loader slices by 'q' | 'k' | 'v'."""

    packed_factor = 3

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
            super().weight_loader(params, name, hf_tensor)
            return
        offset, size = self.shard_offsets()[shard_id]
        self._load_shard(params, name, hf_tensor, offset, size)
