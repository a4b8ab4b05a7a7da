"""The PyTorch port stands alone and refuses what it does not serve.

- An AST scan: no module of aphrodite_tpu_torch/ and not chip_smoke.py
  imports jax, flax or anything of the JAX package aphrodite_tpu.
- The entry points (LLM, AphroditeEngine.from_engine_args, the
  executor's DeviceConfig) raise without a CUDA card unless the caller
  passes device="cpu"; they never fall back to the CPU on their own.
- Configurations outside the port's slices are refused at config time
  with a message naming the later slice; int8 / fp8 KV caches,
  sliding-window (Mistral) models, speculative decoding and LoRA are
  served.
- The two flag registries hold the same names, types and defaults.
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


def test_async_entry_point_refuses_the_cpu_unless_asked(tiny_model_dir):
    """AsyncAphrodite (and so the OpenAI server, which builds it from the
    same arguments) runs on the card unless the caller passes
    device="cpu"."""
    _no_card()
    from aphrodite_tpu_torch.engine.args_tools import AsyncEngineArgs
    from aphrodite_tpu_torch.engine.async_aphrodite import AsyncAphrodite
    kw = dict(model=tiny_model_dir, load_format="dummy",
              skip_tokenizer_init=True, swap_space=0.01,
              disable_log_stats=True, disable_log_requests=True)
    with pytest.raises(RuntimeError, match="CUDA card"):
        AsyncAphrodite.from_engine_args(AsyncEngineArgs(**kw))
    engine = AsyncAphrodite.from_engine_args(AsyncEngineArgs(
        device="cpu", **kw))
    assert engine.engine.executor.device.type == "cpu"


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
    # SqueezeLLM is served on the CPU; on the card the tiny model's
    # layers fail K16's gate and wait for the fallback route.
    (dict(quantization="squeezellm", device="cuda"), "quantized matmul"),
    (dict(enable_lora=True), "LoRA"),
])
def test_out_of_slice_engine_args_are_refused(tiny_model_dir, change,
                                              match):
    """LoRA was refused here until the port served it; its case keeps
    its id and holds what replaced the refusal: the configs build with
    a LoRAConfig (the port's), as the JAX package's do."""
    from aphrodite_tpu_torch.common.config import LoRAConfig
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    if match == "LoRA":
        configs = EngineArgs(model=tiny_model_dir, load_format="dummy",
                             device="cpu", max_loras=2, **change
                             ).create_engine_configs()
        assert isinstance(configs[-1], LoRAConfig)
        assert (configs[-1].max_loras, configs[-1].max_lora_rank,
                configs[-1].max_cpu_loras) == (2, 16, 2)
        assert configs[-1].lora_dtype == configs[0].dtype
        return
    with pytest.raises(NotImplementedError, match=match):
        EngineArgs(**{"model": tiny_model_dir, "load_format": "dummy",
                      "device": "cpu", **change}).create_engine_configs()
    if "quantization" in change:
        EngineArgs(model=tiny_model_dir, load_format="dummy", device="cpu",
                   quantization=change["quantization"]
                   ).create_engine_configs()


def test_speculative_decoding_is_refused(tiny_model_dir, monkeypatch):
    """The port once refused APHRODITE_SPEC=1 at config time; it now
    serves speculative decoding, on by default as in the JAX package.
    The test keeps its id and holds what replaced the refusal: with
    APHRODITE_SPEC=1 the configs build on the CPU and the runner serves
    `execute_spec_verify` (the drafter is pinned to a two-token draft,
    so every decode round of the tiny model's random weights is a
    verify round)."""
    from aphrodite_tpu_torch.common import flags
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    from aphrodite_tpu_torch.executor.model_runner import ModelRunner
    monkeypatch.delenv("APHRODITE_SPEC", raising=False)
    assert flags.get_bool("APHRODITE_SPEC") is True
    monkeypatch.setenv("APHRODITE_SPEC", "1")
    configs = EngineArgs(model=tiny_model_dir, load_format="dummy",
                         device="cpu", block_size=16, max_model_len=128,
                         swap_space=0.01).create_engine_configs()
    configs[1].num_gpu_blocks = 64
    engine = AphroditeEngine(*configs, log_stats=False,
                             skip_tokenizer_init=True)
    results = []
    real = ModelRunner.execute_spec_verify

    def spy(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        results.extend(out[0])
        return out
    monkeypatch.setattr(ModelRunner, "execute_spec_verify", spy)
    monkeypatch.setattr(engine.drafter, "propose",
                        lambda seq_id, tokens, k: [7, 7][:k])
    engine.add_request("spec", None, SamplingParams(
        temperature=0.0, max_tokens=8, ignore_eos=True),
        prompt_token_ids=[11, 23, 37, 41] * 5)
    outs = []
    while engine.has_unfinished_requests():
        outs = engine.step() or outs
    assert results and all(r.proposed > 0 for r in results)
    assert all(len(r.samples) == r.accepted + 1 for r in results)
    assert len(outs[0].outputs[0].token_ids) == 8


def test_flag_registries_match():
    """Both packages register the same 48 flags with the same types and
    defaults (APHRODITE_SPEC included, on in both)."""
    from aphrodite_tpu.common import flags as jax_flags
    from aphrodite_tpu_torch.common import flags
    jax_reg, reg = jax_flags.registry(), flags.registry()
    assert len(reg) == 48
    assert sorted(reg) == sorted(jax_reg)
    for name, flag in reg.items():
        assert (flag.type, flag.default) == \
            (jax_reg[name].type, jax_reg[name].default), name
    assert reg["APHRODITE_SPEC"].default is True


def test_serving_modules_are_scanned_and_chip_smoke_skips_endpoints():
    """The serving modules (the OpenAI, Kobold and Ooba servers, the
    fleet router and model-path resolution among them) are among the
    scanned sources, and the card's smoke script drives `AsyncAphrodite`
    without the HTTP layer or the fleet (their packages are not on the
    card machine)."""
    scanned = {os.path.relpath(p, REPO) for p in _sources()}
    for rel in ("engine/async_aphrodite.py", "endpoints/utils.py",
                "endpoints/openai/protocol.py",
                "endpoints/openai/api_server.py", "common/grammar.py",
                "modeling/layers/rejection.py", "lora/__init__.py",
                "lora/request.py", "lora/layers.py", "lora/models.py",
                "lora/worker_manager.py", "endpoints/kobold/__init__.py",
                "endpoints/kobold/protocol.py",
                "endpoints/kobold/api_server.py",
                "endpoints/ooba/__init__.py", "endpoints/ooba/api_server.py",
                "fleet/__init__.py", "fleet/replica.py", "fleet/router.py",
                "fleet/launcher.py", "modeling/hf_loader.py"):
        assert f"aphrodite_tpu_torch/{rel}" in scanned, rel
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        mods = list(_imported(ast.parse(f.read())))
    assert "aphrodite_tpu_torch.engine.async_aphrodite" in mods
    assert not [m for m in mods
                if m.startswith("aphrodite_tpu_torch.endpoints.")
                and m != "aphrodite_tpu_torch.endpoints.llm"]
    assert not [m for m in mods
                if m == "aphrodite_tpu_torch.fleet"
                or m.startswith("aphrodite_tpu_torch.fleet.")]


@pytest.mark.parametrize("change,match", [
    (dict(architectures=["FalconForCausalLM"]), "architectures"),
    (dict(quantization_config={"quant_method": "squeezellm",
                               "wbits": 4}), "quantized"),
])
def test_out_of_slice_models_are_refused(tmp_path, tiny_model_dir, change,
                                         match):
    """Another architecture is refused anywhere; a SqueezeLLM checkpoint
    is served on the CPU and refused on the card, where the tiny model's
    layers fail K16's gate."""
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    path = _model_dir(tmp_path, tiny_model_dir, **change)
    quantized = "quantization_config" in change
    with pytest.raises(NotImplementedError, match=match):
        EngineArgs(model=path, load_format="dummy",
                   device="cuda" if quantized else "cpu"
                   ).create_engine_configs()
    if quantized:
        assert EngineArgs(model=path, load_format="dummy", device="cpu"
                          ).create_engine_configs()[0].quantization == \
            "squeezellm"


@pytest.mark.parametrize("args,model,cache_dtype,window", [
    (dict(kv_cache_dtype="int8"), {}, "int8", None),
    (dict(kv_cache_dtype="fp8_e5m2"), {}, "fp8", None),
    (dict(block_size=16), dict(sliding_window=64), "auto", 64),
    # HF's MistralConfig turns a 4096-token window on by default.
    (dict(kv_cache_dtype="fp8"), dict(
        architectures=["MistralForCausalLM"], model_type="mistral"),
     "fp8", 4096),
])
def test_served_configurations_are_accepted(tmp_path, tiny_model_dir, args,
                                            model, cache_dtype, window):
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    path = _model_dir(tmp_path, tiny_model_dir, **model)
    model_cfg, cache_cfg, *_ = EngineArgs(
        model=path, load_format="dummy", device="cpu",
        **args).create_engine_configs()
    assert cache_cfg.cache_dtype == cache_dtype
    assert model_cfg.get_sliding_window() == window
    assert cache_cfg.sliding_window == window


def test_window_not_a_multiple_of_the_block_is_refused(tmp_path,
                                                       tiny_model_dir):
    """The block manager's rule: the window must divide into pages."""
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    path = _model_dir(tmp_path, tiny_model_dir, sliding_window=20)
    with pytest.raises(ValueError, match="multiple of block size"):
        AphroditeEngine.from_engine_args(EngineArgs(
            model=path, load_format="dummy", device="cpu", block_size=16,
            max_model_len=128, swap_space=0.01, skip_tokenizer_init=True,
            disable_log_stats=True))


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
