"""Model construction and weights (port of
`aphrodite_tpu/modeling/loader.py` and the parts of `hf_loader.py` the
slice needs).

`load_format="dummy"` follows the JAX package's
`initialize_dummy_params`, drawing on the device from a
`torch.Generator` seeded with the model seed: every floating parameter
uniformly from [-1e-3, 1e-3]; packed quantized payloads (GPTQ/AWQ
qweight and qzeros, GGUF's int8 qs and qs8 and its Q4_K qweight,
SqueezeLLM's and QuIP#'s 4-bit qweight) uniformly over their whole
integer range, so the codes are random bit patterns; other integers
zero: index-like ones (g_idx) and the int8 method's `weight`, as in the
JAX package. Checkpoint
formats read local files, a model id first resolved to one by
`hf_loader.resolve_model_path`; `safetensors` is imported only when a
safetensors checkpoint is asked for. `load_format="npcache"` converts
the `*.bin` files once, under a file lock, into a numpy cache beside
them (`np/`, one `.npy` per tensor and a `weight_names.json` manifest;
bf16 tensors stored as float32, as the JAX package's cache holds them)
and serves this and every later load from it memory-mapped. A single-file `.gguf` checkpoint
is read by `modeling/gguf.py`: with quantization="gguf" its
block-quantized projections stay packed (`RawGGUF`, repacked by the
GGUF linear method), otherwise everything dequantizes at load and the
model runs dense. Integer tensors are never cast to the model dtype.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common.config import ModelConfig
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.modeling.hf_loader import (_file_lock,
                                                   resolve_model_path)
from aphrodite_tpu_torch.modeling.models import ModelRegistry

logger = init_logger(__name__)

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}

DUMMY_SCALE = 1e-3
# Integer parameters that carry data (random bits); other integer
# parameters are indices and stay zero.
_RANDOM_INT_PARAMS = ("qweight", "qzeros", "qs", "qs8")


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
    """Every floating parameter ~ U(-scale, scale), packed quantized
    payloads uniform over their integer type, other integers zero; all
    drawn on `device`. LoRA slot stacks start zero and draw nothing, so
    the base weights are the same with LoRA on or off (a slot is written
    whole before any row reads it)."""
    from aphrodite_tpu_torch.lora.layers import LORA_A, LORA_B
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init_params(device)
    for bucket in params.values():
        for name, tensor in bucket.items():
            if name in (LORA_A, LORA_B):
                tensor.zero_()
            elif tensor.is_floating_point():
                tensor.uniform_(-scale, scale, generator=gen)
            elif name in _RANDOM_INT_PARAMS:
                info = torch.iinfo(tensor.dtype)
                tensor.random_(info.min, info.max + 1, generator=gen)
            else:
                tensor.zero_()
    return params


def _gguf_weights(path: str, at_rest: bool) -> Iterator[Tuple[str, object]]:
    """(name, tensor) of a `.gguf` file: CPU tensors, or RawGGUF packed
    blocks for the at-rest path."""
    from aphrodite_tpu_torch.modeling.gguf import (RawGGUF,
                                                   gguf_weights_iterator)
    for name, arr in gguf_weights_iterator(path, at_rest=at_rest):
        yield name, arr if isinstance(arr, RawGGUF) else \
            torch.from_numpy(np.array(arr))


def _torch_bin_weights(model_path: str
                       ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) of every `*.bin` file, one file at a time."""
    for path in sorted(glob.glob(os.path.join(model_path, "*.bin"))):
        yield from torch.load(path, map_location="cpu",
                              weights_only=True).items()


def _np_cache_iterator(model_path: str
                       ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Stream from (building on first use) the numpy cache of a `*.bin`
    checkpoint, `<model_path>/np` (the JAX package's
    `hf_loader._np_cache_iterator`). The cache is written once, under
    the lock, by whichever process gets there first; bf16 tensors go in
    as float32 (numpy has no bf16). Every load reads the `.npy` files
    memory-mapped (copy-on-write, so the tensors are writable and the
    files stay as written)."""
    cache_dir = os.path.join(model_path, "np")
    manifest = os.path.join(cache_dir, "weight_names.json")
    os.makedirs(cache_dir, exist_ok=True)
    with _file_lock(os.path.join(cache_dir, "convert.lock")):
        if not os.path.exists(manifest):
            names = []
            for name, tensor in _torch_bin_weights(model_path):
                if tensor.dtype == torch.bfloat16:
                    tensor = tensor.float()
                np.save(os.path.join(cache_dir, name.replace("/", "--")),
                        tensor.numpy())
                names.append(name)
            with open(manifest, "w") as f:
                json.dump(names, f)
    with open(manifest) as f:
        names = json.load(f)
    for name in names:
        yield name, torch.from_numpy(np.load(
            os.path.join(cache_dir, name.replace("/", "--") + ".npy"),
            mmap_mode="c"))


def _weights_iterator(model_path: str, load_format: str,
                      gguf_at_rest: bool = False
                      ) -> Iterator[Tuple[str, object]]:
    model_path = resolve_model_path(model_path)
    if model_path.endswith(".gguf") and os.path.isfile(model_path):
        yield from _gguf_weights(model_path, gguf_at_rest)
        return
    files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if load_format == "safetensors" or (load_format == "auto" and files):
        if not files:
            raise ValueError(f"No *.safetensors files found in {model_path}.")
        from safetensors.torch import load_file
        for path in files:
            yield from load_file(path).items()
        return
    has_bins = bool(glob.glob(os.path.join(model_path, "*.bin")))
    if load_format == "npcache":
        if not (has_bins or os.path.exists(
                os.path.join(model_path, "np", "weight_names.json"))):
            raise ValueError(f"npcache needs *.bin files (or an existing "
                             f"np/ cache) in {model_path}.")
        yield from _np_cache_iterator(model_path)
        return
    if load_format in ("auto", "pt"):
        if not has_bins:
            raise ValueError(f"No weight files (*.safetensors / *.bin) "
                             f"found in {model_path}.")
        yield from _torch_bin_weights(model_path)
        return
    raise ValueError(f"Unsupported load format {load_format!r} for "
                     f"{model_path}")


def get_model(model_config: ModelConfig, device: torch.device,
              lora_config=None) -> Tuple[object, Dict]:
    """Build the model and its parameters on `device`. With a
    lora_config every linear layer is built through LoRALinearMethod
    over its own method, so its bucket carries the adapter slots."""
    model_cls = _get_model_architecture(model_config.hf_config)
    dtype = DTYPES[model_config.dtype]
    linear_method = None
    if model_config.quantization is not None:
        from aphrodite_tpu_torch.modeling.layers.quantization import (
            get_quantization_config)
        linear_method = get_quantization_config(
            model_config).get_linear_method()
    if lora_config is not None:
        from aphrodite_tpu_torch.lora.layers import LoRALinearMethod
        from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
        linear_method = LoRALinearMethod(
            linear_method or LinearMethod(),
            max_loras=lora_config.max_loras,
            max_rank=lora_config.max_lora_rank)
    model = model_cls(model_config.hf_config, dtype=dtype,
                      linear_method=linear_method)
    if model_config.load_format == "dummy":
        return model, initialize_dummy_params(model, device,
                                              seed=model_config.seed)
    params = model.load_weights(_weights_iterator(
        model_config.model, model_config.load_format,
        gguf_at_rest=model_config.quantization == "gguf"))
    params = {key: {name: t.to(device=device, dtype=dtype)
                    if t.is_floating_point() else t.to(device)
                    for name, t in bucket.items()}
              for key, bucket in params.items()}
    if lora_config is not None:
        _add_empty_lora_params(model, params, device)
    return model, params


def _add_empty_lora_params(model, params: Dict,
                           device: torch.device) -> None:
    """Checkpoints carry no adapter slots: add the zeroed stacks that
    `create_weights` declares (shapes read from a meta-device build)."""
    from aphrodite_tpu_torch.lora.layers import LORA_A, LORA_B
    for key, bucket in model.init_params(torch.device("meta")).items():
        for name in (LORA_A, LORA_B):
            if name in bucket:
                params.setdefault(key, {})[name] = torch.zeros(
                    bucket[name].shape, dtype=bucket[name].dtype,
                    device=device)
