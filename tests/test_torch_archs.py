"""The other architectures in the PyTorch port (Qwen2, DeciLM, OPT,
GPT-J, GPT-NeoX, Phi) against the JAX package, in float32 on the CPU.

Every case is parametrised over the families (two of them also in a
second form: GPT-NeoX with the serial residual, OPT with LayerNorm after
each block), at tiny widths: 2 layers (DeciLM 3, its KV heads [4, 2,
1]), hidden 64, 4 query heads of 16, vocab 256.

- Config: a config.json with only `architectures` and `model_type`,
  and one with the tiny widths, give the port (`config_from_dict`, no
  transformers) the attributes HF's `AutoConfig` gives the JAX package,
  and both packages' `ModelConfig` the same head size, KV heads, window
  and max length; the yi / qwen config classes as
  tests/test_weight_loading.py holds them; Qwen2's window only under
  `use_sliding_window`, in both packages.
- Layers: every activation of `get_act_fn` and the SwiGLU / GeGLU
  combines within 1e-6 of max |y| of JAX's; `layer_norm` and partial
  rotary (rotary_dim 24 of 96 and 32 of 80 neox-style, 64 of 256 GPT-J
  style) within 1e-6.
- Models: prompt logits within 1e-5 of the JAX model's on the same
  numpy-seeded weights carried across by `params_from_jax` (whose
  transposes each family's linear buckets need).
- Checkpoints: an HF-layout safetensors directory (names from
  transformers' own model classes; DeciLM's written by hand; GPT-J's
  causal-mask buffers, NeoX's rotary and mask buffers added, OPT under
  both prefixes) loads into both packages equal.
- Engines: greedy and seeded tokens from `LLM(..., device="cpu")` over
  that checkpoint equal the JAX engine's (greedy compared while the
  port's top-2 logprob gap exceeds 1e-4); GPTQ W4A16 over a tiny Qwen2
  (a local AutoGPTQ checkpoint, biases after the kernel) too.
- Refusals: each family's `LLM` without `device="cpu"` raises where no
  card is; an OPT whose word_embed_proj_dim differs from hidden_size is
  refused, as the JAX OPT cannot run it. Explicit float16 builds on
  every device (ROADMAP Queue 1 item 5).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.endpoints.llm import LLM as JaxLLM
from aphrodite_tpu.engine.args_tools import EngineArgs as JaxEngineArgs
from aphrodite_tpu.modeling.input_metadata import (
    InputMetadata as JaxInputMetadata)
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.endpoints.llm import LLM
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.modeling.convert import params_from_jax
from aphrodite_tpu_torch.modeling.input_metadata import InputMetadata


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are too small to gain from
    more, and idle OpenMP threads spinning would slow the other test
    workers sharing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_injected_faults(monkeypatch):
    """Run without fault injection whatever an earlier test in this
    process left in the environment."""
    from aphrodite_tpu.common import faultinject as jax_faults
    from aphrodite_tpu_torch.common import faultinject
    monkeypatch.delenv("APHRODITE_FAULT", raising=False)
    monkeypatch.delenv("APHRODITE_FAULT_SEED", raising=False)
    monkeypatch.delenv("APHRODITE_W4A8", raising=False)
    jax_faults.reset()
    faultinject.reset()


ACT_TOL = 1e-6
MODEL_TOL = 1e-5
GAP_TOL = 1e-4

_COMMON = {"vocab_size": 256, "torch_dtype": "float32"}
CONFIGS = {
    "qwen2": dict(_COMMON, architectures=["Qwen2ForCausalLM"],
                  model_type="qwen2", hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=256,
                  rms_norm_eps=1e-6, rope_theta=1e6, sliding_window=256,
                  use_sliding_window=False, tie_word_embeddings=False),
    "decilm": dict(_COMMON, architectures=["DeciLMForCausalLM"],
                   model_type="deci", hidden_size=64, intermediate_size=128,
                   num_hidden_layers=3, num_attention_heads=4,
                   num_key_value_heads_per_layer=[4, 2, 1],
                   max_position_embeddings=256, rms_norm_eps=1e-6,
                   rope_theta=10000.0, tie_word_embeddings=False),
    "opt": dict(_COMMON, architectures=["OPTForCausalLM"], model_type="opt",
                hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=256,
                word_embed_proj_dim=64, do_layer_norm_before=True),
    "opt_post_ln": dict(_COMMON, architectures=["OPTForCausalLM"],
                        model_type="opt", hidden_size=64, ffn_dim=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        max_position_embeddings=256, word_embed_proj_dim=64,
                        do_layer_norm_before=False),
    "gptj": dict(_COMMON, architectures=["GPTJForCausalLM"],
                 model_type="gptj", n_embd=64, n_head=4, n_layer=2,
                 n_inner=128, rotary_dim=8, n_positions=256),
    "gpt_neox": dict(_COMMON, architectures=["GPTNeoXForCausalLM"],
                     model_type="gpt_neox", hidden_size=64,
                     intermediate_size=128, num_hidden_layers=2,
                     num_attention_heads=4, rotary_pct=0.25,
                     max_position_embeddings=256,
                     use_parallel_residual=True),
    "gpt_neox_serial": dict(_COMMON, architectures=["GPTNeoXForCausalLM"],
                            model_type="gpt_neox", hidden_size=64,
                            intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, rotary_pct=0.25,
                            max_position_embeddings=256,
                            use_parallel_residual=False),
    "phi": dict(_COMMON, architectures=["PhiForCausalLM"], model_type="phi",
                hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, partial_rotary_factor=0.5,
                max_position_embeddings=256),
}
FAMILIES = ["qwen2", "decilm", "opt", "gptj", "gpt_neox", "phi"]
VARIANTS = FAMILIES + ["opt_post_ln", "gpt_neox_serial"]
# HF model types with an HF config class (DeciLM's is remote code).
HF_TYPES = ["qwen2", "opt", "gptj", "gpt_neox", "phi"]


def _write_config(path, cfg) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    return str(path)


def _jax_hf_config(cfg):
    """The config the JAX package reads: HF's class, or (DeciLM, remote
    code in HF) the keys as they are."""
    from transformers import AutoConfig, PretrainedConfig
    if cfg["model_type"] == "deci":
        return PretrainedConfig(**cfg)
    return AutoConfig.for_model(**cfg)


@pytest.fixture
def jax_reads_deci(monkeypatch):
    """The JAX package's `get_config` returning a PretrainedConfig of the
    directory's config.json for `model_type: "deci"` (which HF serves
    only through remote code)."""
    from transformers import PretrainedConfig
    from aphrodite_tpu.common import config as jax_config
    real = jax_config.get_config

    def get_config(model, trust_remote_code=False, revision=None):
        path = os.path.join(model, "config.json")
        if os.path.isfile(path):
            with open(path) as f:
                raw = json.load(f)
            if raw.get("model_type") == "deci":
                return PretrainedConfig(**raw)
        return real(model, trust_remote_code, revision)
    monkeypatch.setattr(jax_config, "get_config", get_config)


# ---- config ----

# What the models and the engine read, by model type.
_READ = {
    "qwen2": ("intermediate_size", "num_key_value_heads", "hidden_act",
              "rms_norm_eps", "rope_theta", "rope_scaling", "sliding_window",
              "use_sliding_window"),
    "opt": ("ffn_dim", "word_embed_proj_dim", "do_layer_norm_before",
            "enable_bias", "activation_function", "_remove_final_layer_norm"),
    "gptj": ("n_embd", "n_head", "n_layer", "n_positions", "rotary_dim",
             "n_inner", "activation_function", "layer_norm_epsilon"),
    "gpt_neox": ("intermediate_size", "hidden_act", "rotary_pct",
                 "rotary_emb_base", "layer_norm_eps", "use_parallel_residual",
                 "partial_rotary_factor", "rope_theta"),
    "phi": ("intermediate_size", "hidden_act", "partial_rotary_factor",
            "rope_theta", "layer_norm_eps", "num_key_value_heads"),
}
_ENGINE_READS = ("hidden_size", "num_attention_heads", "num_hidden_layers",
                 "vocab_size", "max_position_embeddings",
                 "tie_word_embeddings", "bos_token_id", "eos_token_id")


@pytest.mark.parametrize("widths", ["defaults", "tiny"])
@pytest.mark.parametrize("model_type", HF_TYPES)
def test_config_surface_matches_autoconfig(model_type, widths, tmp_path):
    from transformers import AutoConfig
    from aphrodite_tpu.common.config import ModelConfig as JaxModelConfig
    from aphrodite_tpu_torch.common.config import ModelConfig
    from aphrodite_tpu_torch.transformers_utils.config import get_config
    base = CONFIGS[model_type]
    raw = base if widths == "tiny" else {
        k: base[k] for k in ("architectures", "model_type")}
    path = _write_config(tmp_path, raw)
    want, got = AutoConfig.from_pretrained(path), get_config(path)
    for key in _ENGINE_READS + _READ[model_type]:
        assert getattr(got, key) == getattr(want, key), key
    jcfg = JaxModelConfig(path, path, "auto", False, None, "dummy", "float32",
                          0)
    cfg = ModelConfig(path, path, "auto", False, None, "dummy", "float32", 0)
    assert (cfg.get_head_size(), cfg.get_total_num_kv_heads(),
            cfg.get_sliding_window(), cfg.max_model_len,
            cfg.get_kv_heads_per_layer()) == (
        jcfg.get_head_size(), jcfg.get_total_num_kv_heads(),
        jcfg.get_sliding_window(), jcfg.max_model_len,
        jcfg.get_kv_heads_per_layer())


@pytest.mark.parametrize("use_window", [False, True])
def test_qwen2_window_follows_use_sliding_window(use_window, tmp_path):
    """Qwen2-7B's file sets sliding_window 131072 with use_sliding_window
    false: HF's Qwen2Config (the JAX package's reader) drops the window,
    so neither package serves one; with the flag on both do."""
    from aphrodite_tpu.common.config import ModelConfig as JaxModelConfig
    from aphrodite_tpu_torch.common.config import ModelConfig
    path = _write_config(tmp_path, dict(
        CONFIGS["qwen2"], sliding_window=131072,
        use_sliding_window=use_window, max_position_embeddings=131072))
    jcfg = JaxModelConfig(path, path, "auto", False, None, "dummy", "float32",
                          0)
    cfg = ModelConfig(path, path, "auto", False, None, "dummy", "float32", 0)
    assert cfg.get_sliding_window() == jcfg.get_sliding_window() == \
        (131072 if use_window else None)


def test_yi_qwen_config_classes(tmp_path):
    """The yi / qwen checks of tests/test_weight_loading.py, through the
    port's reader, beside the JAX package's."""
    from aphrodite_tpu.transformers_utils.config import (
        get_config as jax_get_config)
    from aphrodite_tpu_torch.transformers_utils.config import get_config
    yi = _write_config(tmp_path / "yi", {
        "model_type": "Yi", "architectures": ["YiForCausalLM"],
        "hidden_size": 128, "num_attention_heads": 4,
        "num_key_value_heads": 2, "num_hidden_layers": 2,
        "intermediate_size": 256, "vocab_size": 1024})
    qwen = _write_config(tmp_path / "qwen", {
        "model_type": "qwen", "architectures": ["QWenLMHeadModel"],
        "hidden_size": 128, "num_attention_heads": 4,
        "num_hidden_layers": 2, "intermediate_size": 256,
        "vocab_size": 1024})
    cfg, want = get_config(yi), jax_get_config(yi)
    assert cfg.model_type.lower() == "yi"
    assert cfg.num_key_value_heads == 2
    assert cfg.rope_theta == 5000000.0       # Yi default
    for key in ("rms_norm_eps", "max_position_embeddings", "hidden_act",
                "tie_word_embeddings", "bos_token_id", "eos_token_id",
                "pad_token_id"):
        assert getattr(cfg, key) == getattr(want, key), key
    cfg, want = get_config(qwen), jax_get_config(qwen)
    assert cfg.model_type == "qwen"
    assert cfg.no_bias is True
    for key in ("kv_channels", "rotary_pct", "rotary_emb_base",
                "layer_norm_epsilon", "max_position_embeddings",
                "tie_word_embeddings"):
        assert getattr(cfg, key) == getattr(want, key), key


# ---- layers ----

ACTS = ["silu", "gelu", "gelu_new", "gelu_fast", "gelu_pytorch_tanh",
        "relu"]


@pytest.mark.parametrize("name", ACTS + ["silu_and_mul", "gelu_and_mul"])
def test_activations_match_jax(name):
    from aphrodite_tpu.modeling.layers import activation as jact
    from aphrodite_tpu_torch.modeling.layers import activation as act
    x = np.random.default_rng(1).normal(0, 3, (7, 96)).astype(np.float32)
    if name in ACTS:
        jfn, fn = jact.get_act_fn(name), act.get_act_fn(name)
    else:
        jfn, fn = getattr(jact, name), getattr(act, name)
    want = np.asarray(jfn(jnp.asarray(x)))
    # Within 1e-6 of max |y| (erf's and tanh's last bits differ between
    # torch and XLA; the combines multiply them by |up| up to ~10).
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want,
                               atol=ACT_TOL * np.abs(want).max(), rtol=0)
    with pytest.raises(ValueError):
        act.get_act_fn("swish")


def test_layer_norm_matches_jax():
    from aphrodite_tpu.modeling.layers.layernorm import (
        layer_norm as jax_layer_norm)
    from aphrodite_tpu_torch.modeling.layers.layernorm import layer_norm
    rng = np.random.default_rng(2)
    x = rng.normal(0.5, 2, (5, 3, 80)).astype(np.float32)
    w = rng.normal(1, 0.1, 80).astype(np.float32)
    b = rng.normal(0, 0.1, 80).astype(np.float32)
    for eps in (1e-5, 1e-6):
        np.testing.assert_allclose(
            layer_norm(*map(torch.from_numpy, (x, w, b)), eps).numpy(),
            np.asarray(jax_layer_norm(*map(jnp.asarray, (x, w, b)), eps)),
            atol=ACT_TOL, rtol=ACT_TOL)


@pytest.mark.parametrize("head,rot,neox", [(96, 24, True), (80, 32, True),
                                           (256, 64, False)])
def test_partial_rotary_matches_jax(head, rot, neox):
    from aphrodite_tpu.modeling.layers.rotary_embedding import (
        get_rope as jax_get_rope)
    from aphrodite_tpu_torch.modeling.layers.rotary_embedding import get_rope
    rng = np.random.default_rng(head)
    pos = rng.integers(0, 2048, (2, 5)).astype(np.int32)
    q = rng.normal(0, 1, (2, 5, 4, head)).astype(np.float32)
    k = rng.normal(0, 1, (2, 5, 2, head)).astype(np.float32)
    jq, jk = jax_get_rope(head, rot, 2048, 10000.0, neox)(
        *map(jnp.asarray, (pos, q, k)))
    tq, tk = get_rope(head, rot, 2048, 10000.0, neox)(
        *map(torch.from_numpy, (pos, q, k)))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ACT_TOL,
                               rtol=ACT_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ACT_TOL,
                               rtol=ACT_TOL)
    # The dims past rotary_dim pass through.
    assert torch.equal(tq[..., rot:], torch.from_numpy(q[..., rot:]))


# ---- the models ----

def _jax_model(cfg):
    from aphrodite_tpu.modeling.models import ModelRegistry
    return ModelRegistry.load_model_cls(cfg["architectures"][0])(
        _jax_hf_config(cfg), dtype=jnp.float32)


def _port_model(cfg):
    from aphrodite_tpu_torch.modeling.loader import _get_model_architecture
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    hf = config_from_dict(cfg)
    return _get_model_architecture(hf)(hf, dtype=torch.float32)


_NORMS = ("norm", "layernorm", "layer_norm", "ln_1", "ln_f")


def _random_params(model, seed):
    """Numpy-seeded params over the JAX model's tree (norm weights near
    1, the rest N(0, 0.1^2))."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, bucket in jax.eval_shape(model.init_params).items():
        out[key] = {}
        for name, leaf in bucket.items():
            norm = key.endswith(_NORMS) and name == "weight"
            arr = (1.0 if norm else 0.0) + rng.normal(0, 0.1, leaf.shape)
            out[key][name] = arr.astype(np.float32)
    return out


@pytest.mark.parametrize("name", VARIANTS)
def test_models_match_jax(name):
    cfg = CONFIGS[name]
    jmodel = _jax_model(cfg)
    model = _port_model(cfg)
    np_params = _random_params(jmodel, seed=5)
    params = params_from_jax(np_params)
    assert set(params) == set(model.init_params(torch.device("meta")))
    for key, bucket in model.init_params(torch.device("meta")).items():
        for pname, t in bucket.items():
            assert params[key][pname].shape == t.shape, (key, pname)
    n = 9
    ids = np.array([[(i * 37 + 5) % 250 for i in range(n)]], np.int32)
    pos = np.arange(n, dtype=np.int32)[None]
    jmeta = JaxInputMetadata(
        slot_mapping=jnp.full((n,), 10 ** 6, jnp.int32),
        block_tables=jnp.full((1, 1), 10 ** 4, jnp.int32),
        context_lens=jnp.zeros((1,), jnp.int32),
        prompt_lens=jnp.full((1,), n, jnp.int32), is_prompt=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    hidden, _ = jmodel(jparams, jnp.asarray(ids), jnp.asarray(pos), None,
                       jmeta)
    want = np.asarray(jmodel.compute_logits(jparams, hidden))
    meta = InputMetadata(
        slot_mapping=torch.full((n,), 10 ** 6, dtype=torch.int32),
        block_tables=torch.full((1, 1), 10 ** 4, dtype=torch.int32),
        context_lens=torch.zeros((1,), dtype=torch.int32),
        prompt_lens=torch.full((1,), n, dtype=torch.int32), is_prompt=True)
    hidden, _ = model(params, torch.from_numpy(ids), torch.from_numpy(pos),
                      None, meta)
    got = model.compute_logits(params, hidden).numpy()
    assert got.shape == want.shape == (1, n, 256)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=0)


def test_decilm_layers_take_their_own_kv_heads():
    model = _port_model(CONFIGS["decilm"])
    assert [l.self_attn.num_kv_heads for l in model.layers] == [4, 2, 1]
    assert [l.self_attn.attn.num_kv_heads for l in model.layers] == \
        [4, 2, 1]
    shapes = model.init_params(torch.device("meta"))
    assert [shapes[f"model.layers.{i}.self_attn.qkv_proj"]["weight"].shape[0]
            for i in range(3)] == [(4 + 2 * kv) * 16 for kv in (4, 2, 1)]


# ---- checkpoints ----

# Buffers a checkpoint may carry that both packages skip.
_BUFFERS = {
    "gptj": ("transformer.h.{i}.attn.bias",
             "transformer.h.{i}.attn.masked_bias"),
    "gpt_neox": ("gpt_neox.layers.{i}.attention.rotary_emb.inv_freq",
                 "gpt_neox.layers.{i}.attention.bias",
                 "gpt_neox.layers.{i}.attention.masked_bias"),
}


def _decilm_tensors(cfg):
    h, v, inter = cfg["hidden_size"], cfg["vocab_size"], \
        cfg["intermediate_size"]
    d = h // cfg["num_attention_heads"]
    out = {"model.embed_tokens.weight": (v, h), "lm_head.weight": (v, h),
           "model.norm.weight": (h,)}
    for i, kv in enumerate(cfg["num_key_value_heads_per_layer"]):
        p = f"model.layers.{i}"
        out.update({f"{p}.self_attn.q_proj.weight": (h, h),
                    f"{p}.self_attn.k_proj.weight": (kv * d, h),
                    f"{p}.self_attn.v_proj.weight": (kv * d, h),
                    f"{p}.self_attn.o_proj.weight": (h, h),
                    f"{p}.mlp.gate_proj.weight": (inter, h),
                    f"{p}.mlp.up_proj.weight": (inter, h),
                    f"{p}.mlp.down_proj.weight": (h, inter),
                    f"{p}.input_layernorm.weight": (h,),
                    f"{p}.post_attention_layernorm.weight": (h,)})
    return out


def _hf_tensors(name, cfg, seed):
    """(HF name, float32 array) of a checkpoint of `cfg`: the names and
    shapes of transformers' own model class (DeciLM's by hand), values
    from a numpy generator (norm weights near 1, the rest N(0, 0.2^2)),
    plus the buffers the loaders skip."""
    rng = np.random.default_rng(seed)
    if name == "decilm":
        shapes = _decilm_tensors(cfg)
    else:
        from transformers import AutoModelForCausalLM
        model = AutoModelForCausalLM.from_config(_jax_hf_config(cfg))
        shapes = {k: tuple(t.shape) for k, t in model.state_dict().items()}
        if cfg["model_type"] == "opt":
            shapes.pop("lm_head.weight")            # tied
    out = {}
    for key, shape in shapes.items():
        norm = key.endswith("weight") and len(shape) == 1
        out[key] = ((1.0 if norm else 0.0) +
                    rng.normal(0, 0.2, shape)).astype(np.float32)
    for pattern in _BUFFERS.get(cfg["model_type"], ()):
        for i in range(2):
            out[pattern.format(i=i)] = np.full((4,), np.nan, np.float32)
    return out


def _write_checkpoint(path, name, prefix=""):
    from safetensors.numpy import save_file
    cfg = CONFIGS[name]
    _write_config(path, cfg)
    tensors = _hf_tensors(name, cfg, seed=7)
    if prefix:
        tensors = {(prefix + k[len("model.decoder."):]
                    if k.startswith("model.decoder.") else k): t
                   for k, t in tensors.items()}
    save_file(tensors, os.path.join(path, "model.safetensors"))
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return {name: _write_checkpoint(tmp_path_factory.mktemp(name), name)
            for name in FAMILIES}


@pytest.mark.parametrize("name", FAMILIES + ["opt_decoder_prefix"])
def test_checkpoint_loads_equal_into_both_packages(name, tmp_path,
                                                   jax_reads_deci):
    from aphrodite_tpu.common.config import ModelConfig as JaxModelConfig
    from aphrodite_tpu.modeling.loader import get_model as jax_get_model
    from aphrodite_tpu_torch.common.config import ModelConfig
    from aphrodite_tpu_torch.modeling.loader import get_model
    family = "opt" if name == "opt_decoder_prefix" else name
    path = _write_checkpoint(tmp_path, family,
                             "decoder." if family != name else "")
    _, jparams = jax_get_model(JaxModelConfig(
        path, path, "auto", False, None, "safetensors", "float32", 0))
    _, params = get_model(ModelConfig(
        path, path, "auto", False, None, "safetensors", "float32", 0),
        torch.device("cpu"))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(params) == set(want)
    for key, bucket in want.items():
        assert set(params[key]) == set(bucket), key
        for pname, t in bucket.items():
            assert torch.equal(params[key][pname], t), (key, pname)
            assert torch.isfinite(t).all(), (key, pname)   # buffers skipped
    if family == "gpt_neox":
        # The loader de-interleaved HF's per-head [q k v] rows.
        from safetensors.numpy import load_file
        qkv = load_file(os.path.join(path, "model.safetensors"))[
            "gpt_neox.layers.0.attention.query_key_value.weight"]
        heads = qkv.reshape(4, 3, 16, 64)
        got = params["gpt_neox.layers.0.attention.qkv_proj"]["weight"]
        assert torch.equal(got[16:32], torch.from_numpy(heads[1, 0]))
        assert torch.equal(got[64:80], torch.from_numpy(heads[0, 1]))


# ---- the engines ----

ENGINE_KW = dict(dtype="float32", max_model_len=128, max_num_seqs=4,
                 swap_space=0.01, skip_tokenizer_init=True,
                 disable_log_stats=True, block_size=16)
PROMPTS = [[(i * 7 + 3) % 250 + 5 for i in range(n)] for n in (5, 23, 40)]


def _generate(llm, sp_cls, **kw):
    outs = llm.generate(
        prompt_token_ids=[list(p) for p in PROMPTS],
        sampling_params=sp_cls(**dict(dict(temperature=0.0, max_tokens=8,
                                           ignore_eos=True), **kw)))
    return [o.outputs[0] for o in outs]


def _greedy_compare(jax_llm, port) -> int:
    """Tokens equal while the port's top-2 logprob gap exceeds GAP_TOL;
    returns how many were compared."""
    want = [o.token_ids for o in _generate(jax_llm, JaxSamplingParams)]
    got = [o.token_ids for o in _generate(port, SamplingParams)]
    scored = _generate(port, SamplingParams, logprobs=2)
    compared = 0
    for w, g, s in zip(want, got, scored):
        assert list(s.token_ids) == list(g)
        for pos, (wt, gt) in enumerate(zip(w, g)):
            top = sorted(s.logprobs[pos].values(), reverse=True)
            if top[0] - top[1] <= GAP_TOL:
                break                      # near tie: may flip from here
            assert wt == gt, (pos, w, g)
            compared += 1
    return compared


@pytest.fixture(scope="module", params=FAMILIES)
def llms(request, checkpoints):
    mp = pytest.MonkeyPatch()
    mp.setenv("APHRODITE_SPEC", "0")
    if request.param == "decilm":
        from transformers import PretrainedConfig
        from aphrodite_tpu.common import config as jax_config
        mp.setattr(jax_config, "get_config", lambda model, *a, **k:
                   PretrainedConfig(**CONFIGS["decilm"]))
    path = checkpoints[request.param]
    jax_llm = JaxLLM(model=path, load_format="safetensors", **ENGINE_KW)
    port = LLM(model=path, load_format="safetensors", device="cpu",
               **ENGINE_KW)
    mp.undo()
    yield request.param, jax_llm, port


def test_greedy_generation_matches_jax(llms):
    name, jax_llm, port = llms
    if name == "decilm":
        kv = [pages[0].shape[-1] // 16 for pages in
              port.engine.executor.cache_engine.kv_caches]
        assert kv == [4, 2, 1]
    assert _greedy_compare(jax_llm, port) >= 12


def test_seeded_generation_matches_jax(llms):
    _, jax_llm, port = llms
    kw = dict(temperature=0.8, top_p=0.9, seed=7)
    want = [list(o.token_ids) for o in _generate(jax_llm, JaxSamplingParams,
                                                 **kw)]
    got = [list(o.token_ids) for o in _generate(port, SamplingParams, **kw)]
    assert got == want


GROUP = 128
QWEN2_GPTQ = dict(_COMMON, architectures=["Qwen2ForCausalLM"],
                  model_type="qwen2", hidden_size=128, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=256,
                  rms_norm_eps=1e-6, rope_theta=1e6,
                  tie_word_embeddings=False,
                  quantization_config={"quant_method": "gptq", "bits": 4,
                                       "group_size": GROUP,
                                       "desc_act": False, "sym": False})


def test_gptq_qwen2_greedy_generation_matches_jax(tmp_path, monkeypatch):
    """A tiny AutoGPTQ Qwen2 (4-bit codes in groups of 128, g_idx =
    arange(in) // 128, biased q/k/v added after the kernel's product)
    through both engines: the same greedy tokens."""
    from safetensors.numpy import save_file
    from tests.test_torch_gptq import quantize_gptq
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    rs = np.random.RandomState(3)
    h, inter, hd, v = 128, 256, 32, 256
    tensors = {"model.embed_tokens.weight":
               rs.randn(v, h).astype(np.float32),
               "lm_head.weight": (rs.randn(v, h) * 0.2).astype(np.float32),
               "model.norm.weight": np.ones(h, np.float32)}
    shapes = {"q_proj": (4 * hd, h), "k_proj": (2 * hd, h),
              "v_proj": (2 * hd, h), "o_proj": (h, 4 * hd),
              "gate_proj": (inter, h), "up_proj": (inter, h),
              "down_proj": (h, inter)}
    for i in range(2):
        p = f"model.layers.{i}"
        tensors[f"{p}.input_layernorm.weight"] = np.ones(h, np.float32)
        tensors[f"{p}.post_attention_layernorm.weight"] = \
            np.ones(h, np.float32)
        for frag, shape in shapes.items():
            part = "mlp" if frag in ("gate_proj", "up_proj", "down_proj") \
                else "self_attn"
            base = f"{p}.{part}.{frag}"
            qweight, qzeros, scales, _ = quantize_gptq(
                (rs.randn(*shape) * 0.05).astype(np.float32))
            tensors.update({f"{base}.qweight": qweight,
                            f"{base}.qzeros": qzeros,
                            f"{base}.scales": scales,
                            f"{base}.g_idx": (np.arange(shape[1]) // GROUP
                                              ).astype(np.int32)})
            if frag in ("q_proj", "k_proj", "v_proj"):
                tensors[f"{base}.bias"] = (rs.randn(shape[0]) * 0.5
                                           ).astype(np.float32)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    path = _write_config(tmp_path, QWEN2_GPTQ)
    jax_llm = JaxLLM(model=path, load_format="safetensors", **ENGINE_KW)
    port = LLM(model=path, load_format="safetensors", device="cpu",
               **ENGINE_KW)
    assert port.engine.model_config.quantization == "gptq"
    qkv = port.engine.executor.params[
        "model.layers.0.self_attn.qkv_proj"]
    assert set(qkv) == {"qweight", "qzeros", "scales", "g_idx", "bias"}
    assert _greedy_compare(jax_llm, port) >= 12


# ---- refusals ----

@pytest.mark.parametrize("name", FAMILIES)
def test_llm_refuses_the_cpu_unless_asked(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    path = _write_config(tmp_path, CONFIGS[name])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLM(model=path, load_format="dummy", skip_tokenizer_init=True)


def test_explicit_float16_names_item_2(tmp_path):
    """Explicit float16 (ROADMAP.md Queue 1 item 5, item 2 when this test
    was named, and refused until it landed) builds engine configs on
    every device, as "float16" and as "half"; `auto` still maps a
    float16 checkpoint to bfloat16, in both packages."""
    path = _write_config(tmp_path, CONFIGS["phi"])
    for device in ("cpu", "cuda", "auto"):
        for dtype in ("float16", "half"):
            cfg = EngineArgs(model=path, load_format="dummy", device=device,
                             dtype=dtype).create_engine_configs()[0]
            assert cfg.dtype == "float16"
    path = _write_config(tmp_path / "f16",
                         dict(CONFIGS["phi"], torch_dtype="float16"))
    assert EngineArgs(model=path, load_format="dummy", device="cpu"
                      ).create_engine_configs()[0].dtype == "bfloat16"
    assert JaxEngineArgs(model=path, load_format="dummy"
                         ).create_engine_configs()[0].dtype == "bfloat16"


def test_opt_with_a_projection_is_refused_as_jax_cannot_run_it(tmp_path):
    """opt-350m's word_embed_proj_dim (512) differs from hidden_size: the
    JAX OPT (no project_in / project_out) builds a 512-wide embedding
    into 1024-wide layers and fails on the first forward; the port
    refuses the config."""
    cfg = dict(CONFIGS["opt"], word_embed_proj_dim=32)
    path = _write_config(tmp_path, cfg)
    with pytest.raises(NotImplementedError, match="word_embed_proj_dim"):
        EngineArgs(model=path, load_format="dummy", device="cpu"
                   ).create_engine_configs()
    jmodel = _jax_model(cfg)
    params = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(jmodel.init_params))
    meta = JaxInputMetadata(
        slot_mapping=jnp.full((3,), 10 ** 6, jnp.int32),
        block_tables=jnp.full((1, 1), 10 ** 4, jnp.int32),
        context_lens=jnp.zeros((1,), jnp.int32),
        prompt_lens=jnp.full((1,), 3, jnp.int32), is_prompt=True)
    with pytest.raises(TypeError):
        jmodel(params, jnp.ones((1, 3), jnp.int32),
               jnp.arange(3, dtype=jnp.int32)[None], None, meta)
