"""The PyTorch port stands alone and refuses what it does not serve.

- An AST scan: no module of aphrodite_tpu_torch/ and not chip_smoke.py
  imports jax, flax or anything of the JAX package aphrodite_tpu.
- The entry points (LLM, AphroditeEngine.from_engine_args, the
  executor's DeviceConfig) raise without a CUDA card unless the caller
  passes device="cpu"; they never fall back to the CPU on their own.
- Configurations outside the port's first slice are refused at config
  time with a message naming the later slice.
"""
import ast
import json
import os
import shutil

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are too small to gain from
    more, and idle OpenMP threads spinning would slow the other test
    workers sharing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "aphrodite_tpu")


def _sources():
    root = os.path.join(REPO, "aphrodite_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    offenders = []
    files = list(_sources())
    assert len(files) > 40
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for mod in _imported(tree):
            if mod.split(".")[0] in FORBIDDEN:
                offenders.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert offenders == []


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")


def test_entry_points_refuse_the_cpu_unless_asked(tiny_model_dir):
    _no_card()
    from aphrodite_tpu_torch.common.config import DeviceConfig
    from aphrodite_tpu_torch.endpoints.llm import LLM
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    for device in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA card"):
            DeviceConfig(device).resolve()
    assert DeviceConfig("cpu").resolve() == "cpu"
    with pytest.raises(RuntimeError, match="CUDA card"):
        LLM(model=tiny_model_dir, load_format="dummy",
            skip_tokenizer_init=True, swap_space=0.01)
    with pytest.raises(RuntimeError, match="CUDA card"):
        AphroditeEngine.from_engine_args(EngineArgs(
            model=tiny_model_dir, load_format="dummy",
            skip_tokenizer_init=True, swap_space=0.01))
    with pytest.raises(ValueError, match="Unknown device"):
        DeviceConfig("tpu")


def _model_dir(tmp_path, tiny_model_dir, **changes):
    path = tmp_path / "model"
    shutil.copytree(tiny_model_dir, path)
    cfg = json.loads((path / "config.json").read_text())
    cfg.update(changes)
    (path / "config.json").write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("change,match", [
    (dict(tensor_parallel_size=2), "multi-GPU"),
    (dict(disagg_split="1,1", tensor_parallel_size=2), "multi-GPU"),
    (dict(quantization="gptq"), "quantized matmul"),
    (dict(enable_lora=True), "LoRA"),
    (dict(kv_cache_dtype="int8"), "int8/fp8 KV"),
    (dict(kv_cache_dtype="fp8"), "int8/fp8 KV"),
])
def test_out_of_slice_engine_args_are_refused(tiny_model_dir, change,
                                              match):
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    with pytest.raises(NotImplementedError, match=match):
        EngineArgs(model=tiny_model_dir, load_format="dummy", device="cpu",
                   **change).create_engine_configs()


def test_speculative_decoding_is_refused(tiny_model_dir, monkeypatch):
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    monkeypatch.setenv("APHRODITE_SPEC", "1")
    with pytest.raises(NotImplementedError, match="speculative"):
        EngineArgs(model=tiny_model_dir, load_format="dummy",
                   device="cpu").create_engine_configs()


@pytest.mark.parametrize("change,match", [
    (dict(sliding_window=64), "sliding"),
    (dict(architectures=["MistralForCausalLM"], model_type="mistral"),
     "sliding"),
    (dict(architectures=["GPTNeoXForCausalLM"]), "architectures"),
    (dict(quantization_config={"quant_method": "awq"}), "quantized"),
])
def test_out_of_slice_models_are_refused(tmp_path, tiny_model_dir, change,
                                         match):
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    path = _model_dir(tmp_path, tiny_model_dir, **change)
    with pytest.raises(NotImplementedError, match=match):
        EngineArgs(model=path, load_format="dummy",
                   device="cpu").create_engine_configs()


def test_json_config_defaults(tmp_path, tiny_model_dir):
    """config.json read without transformers: Llama defaults fill the
    keys a checkpoint may omit."""
    from aphrodite_tpu_torch.transformers_utils.config import get_config
    path = _model_dir(tmp_path, tiny_model_dir, num_key_value_heads=None)
    cfg = get_config(path)
    assert cfg.num_key_value_heads == cfg.num_attention_heads
    assert cfg.rope_scaling is None and cfg.sliding_window is None
    assert cfg.tie_word_embeddings is False
    with pytest.raises(ValueError, match="config.json"):
        get_config(str(tmp_path / "missing"))
