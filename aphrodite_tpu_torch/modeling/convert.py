"""Parameters of the JAX package's models -> the PyTorch port's.

The JAX Llama keeps a flat tree `{bucket: {name: array}}` with linear
weights laid out [in, out] (x @ W); the port keeps the same buckets
with torch's [out, in] layout (F.linear). Embedding tables, the LM head
([vocab, hidden] on both sides) and norm weights carry over as they
are, and so do quantized layers' tensors (GPTQ/AWQ qweight, qzeros,
scales and g_idx keep the checkpoint layout on both sides; GGUF's
at-rest qs, d, d16, qs8, s128, qweight, dl and ml are [in, out] on both
sides; SqueezeLLM's and QuIP#'s qweight and lookup_table, QuIP#'s SU,
SV, Wscale and Hadamard factors as they are): only a FLOATING 2-D
`weight` transposes, GGUF's dense `weight` included (the JAX GGUF
method stores it [in, out], the port [out, in]). An int8 `weight` (the
int8 method's, QuIP#'s int8 form) keeps [in, out] on both sides: K17
reads W as [K, N]. LoRA slot stacks, A [slots, in, R] and B [slots, R,
out] in the JAX package, become the port's slot-concatenated A [slots *
R, in] and B [out, slots * R] (`lora/layers.py`). The MoE buckets
(Mixtral's `model.layers.N.block_sparse_moe`, DeepSeek's
`model.layers.N.mlp_moe`) hold the router `gate` [H, E] and the expert
stacks [E, in, out] in the JAX package; the port keeps the linear
layout, [E, H] and [E, out, in] (`layers/fused_moe.py`). DeepSeek's
shared experts are a `LlamaMLP` whose buckets end in `.gate_up_proj` /
`.down_proj` and transpose as every linear does. The other
architectures' linear buckets (OPT's `out_proj`, `fc1`, `fc2`; GPT-J's
`out_proj`, `mlp.fc_in`, `mlp.fc_out`; NeoX's `dense`,
`mlp.dense_h_to_4h`, `mlp.dense_4h_to_h`; Phi's `dense`, `mlp.fc1`,
`mlp.fc2`) transpose too; OPT's position table, LayerNorm weights and
biases and the heads' biases carry over unchanged. Used to give both
sides the same weights in parity tests.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# Bucket suffixes of the linear layers whose 2-D weight transposes: the
# Llama family's, OPT's and GPT-J's out_proj, OPT's and Phi's fc1 / fc2,
# GPT-J's fc_in / fc_out, NeoX's and Phi's dense and NeoX's MLP.
_LINEAR_SUFFIXES = (".qkv_proj", ".o_proj", ".gate_up_proj", ".down_proj",
                    ".out_proj", ".fc1", ".fc2", ".fc_in", ".fc_out",
                    ".dense", ".dense_h_to_4h", ".dense_4h_to_h")
# Bucket suffixes of the MoE layers: gate [H, E] -> [E, H], the expert
# stacks [E, in, out] -> [E, out, in].
_MOE_SUFFIXES = (".block_sparse_moe", ".mlp_moe")


def params_from_jax(np_params: Dict[str, Dict[str, np.ndarray]]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{bucket: {name: numpy array}} from the JAX model -> the port's
    {bucket: {name: CPU tensor}}, linear weights transposed."""
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, bucket in np_params.items():
        out = state.setdefault(key, {})
        for name, arr in bucket.items():
            arr = np.asarray(arr)
            floating = arr.dtype.kind == "f" or arr.dtype.name == "bfloat16"
            if name == "weight" and arr.ndim == 2 and floating and \
                    key.endswith(_LINEAR_SUFFIXES):
                arr = arr.T
            elif key.endswith(_MOE_SUFFIXES):
                arr = arr.T if name == "gate" else arr.transpose(0, 2, 1)
            elif name == "lora_A_stacked":
                arr = arr.transpose(0, 2, 1).reshape(-1, arr.shape[1])
            elif name == "lora_B_stacked":
                arr = arr.reshape(-1, arr.shape[2]).T
            if arr.dtype.name == "bfloat16":      # ml_dtypes, no numpy twin
                out[name] = torch.from_numpy(
                    arr.astype(np.float32)).to(torch.bfloat16)
                continue
            out[name] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return state


def to_device(state: Dict[str, Dict[str, torch.Tensor]],
              device: torch.device,
              dtype: Optional[torch.dtype] = None
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Move a parameter dict to `device`, casting floats to `dtype`."""
    return {key: {name: t.to(device=device, dtype=dtype)
                  if dtype is not None and t.is_floating_point()
                  else t.to(device)
                  for name, t in bucket.items()}
            for key, bucket in state.items()}
