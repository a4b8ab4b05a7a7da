"""Parameters of the JAX package's models -> the PyTorch port's.

The JAX Llama keeps a flat tree `{bucket: {name: array}}` with linear
weights laid out [in, out] (x @ W); the port keeps the same buckets
with torch's [out, in] layout (F.linear). Embedding tables, the LM head
([vocab, hidden] on both sides) and norm weights carry over as they
are. Used to give both sides the same weights in parity tests.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# Bucket suffixes of the linear layers whose 2-D weight transposes.
_LINEAR_SUFFIXES = (".qkv_proj", ".o_proj", ".gate_up_proj", ".down_proj")


def params_from_jax(np_params: Dict[str, Dict[str, np.ndarray]]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{bucket: {name: numpy array}} from the JAX model -> the port's
    {bucket: {name: CPU tensor}}, linear weights transposed."""
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, bucket in np_params.items():
        out = state.setdefault(key, {})
        for name, arr in bucket.items():
            arr = np.asarray(arr)
            if name == "weight" and arr.ndim == 2 and \
                    key.endswith(_LINEAR_SUFFIXES):
                arr = arr.T
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
