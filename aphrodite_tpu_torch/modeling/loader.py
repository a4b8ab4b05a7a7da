"""Model construction and weights (port of
`aphrodite_tpu/modeling/loader.py` and the parts of `hf_loader.py` the
slice needs).

`load_format="dummy"` draws every floating parameter uniformly from
[-1e-3, 1e-3], as the JAX package's `initialize_dummy_params` does,
directly on the device from a `torch.Generator` seeded with the model
seed. Checkpoint formats read local files; `safetensors` is imported
only when a safetensors checkpoint is asked for.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Tuple

import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.modeling.models import ModelRegistry

logger = init_logger(__name__)

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}

DUMMY_SCALE = 1e-3


def _get_model_architecture(config) -> type:
    architectures = getattr(config, "architectures", None) or []
    for arch in architectures:
        model_cls = ModelRegistry.load_model_cls(arch)
        if model_cls is not None:
            return model_cls
    raise ValueError(
        f"Model architectures {architectures} are not supported for now. "
        f"Supported architectures: {ModelRegistry.get_supported_archs()}")


def initialize_dummy_params(model, device: torch.device, seed: int = 0,
                            scale: float = DUMMY_SCALE) -> Dict:
    """Every floating parameter ~ U(-scale, scale), drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init_params(device)
    for bucket in params.values():
        for tensor in bucket.values():
            tensor.uniform_(-scale, scale, generator=gen)
    return params


def _weights_iterator(model_path: str, load_format: str
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if load_format == "safetensors" or (load_format == "auto" and files):
        if not files:
            raise ValueError(f"No *.safetensors files found in {model_path}.")
        from safetensors.torch import load_file
        for path in files:
            yield from load_file(path).items()
        return
    if load_format in ("auto", "pt"):
        bins = sorted(glob.glob(os.path.join(model_path, "*.bin")))
        if not bins:
            raise ValueError(f"No weight files (*.safetensors / *.bin) "
                             f"found in {model_path}.")
        for path in bins:
            yield from torch.load(path, map_location="cpu",
                                  weights_only=True).items()
        return
    raise ValueError(f"Unsupported load format {load_format!r} for "
                     f"{model_path}")


def get_model(model_config: ModelConfig,
              device: torch.device) -> Tuple[object, Dict]:
    """Build the model and its parameters on `device`."""
    model_cls = _get_model_architecture(model_config.hf_config)
    dtype = DTYPES[model_config.dtype]
    model = model_cls(model_config.hf_config, dtype=dtype)
    if model_config.load_format == "dummy":
        return model, initialize_dummy_params(model, device,
                                              seed=model_config.seed)
    params = model.load_weights(_weights_iterator(model_config.model,
                                                  model_config.load_format))
    params = {key: {name: t.to(device=device, dtype=dtype)
                    if t.is_floating_point() else t.to(device)
                    for name, t in bucket.items()}
              for key, bucket in params.items()}
    return model, params
