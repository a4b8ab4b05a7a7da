"""The port's SqueezeLLM path (config, layer, loading, dummy weights,
engine) against the JAX package, on the CPU.

A tiny SqueezeLLM checkpoint is written locally with safetensors from
numpy weights made from a seed: a Llama of hidden 256, intermediate 768,
4 query and 2 KV heads of 64, 2 layers, vocab 256, every projection's
4-bit codes random and its per-column codebook N(0, 0.05), so every
layer shape passes K16's gate (in % 256 == 0, out % 128 == 0).

- `SqueezeLLMLinearMethod.apply` against the JAX package's `apply` (its
  CPU route dequantizes, then multiplies): within 1e-5 of max |y| in f32,
  through K16's wrapper where the gate takes the shape and through the
  dequantize route where it does not;
  APHRODITE_DISABLE_PALLAS_QUANT=1 takes the dequantize route (no K16
  call), read per call.
- Loading: every merged parameter equals the JAX loader's (the codebook
  [out, 16] placed along its first dim, the codes along their last).
- Dummy weights: random codes.
- Greedy `LLM.generate` is token-equal to the JAX engine's, compared
  while the port's top-2 logprob gap exceeds 1e-4, every projection of
  every step through K16's wrapper.
- Config: served on the CPU and on the card, in bfloat16 and float32
  (K16 takes both), at hidden 256 and at hidden 128, whose layers K16's
  gate refuses (they take the dequantize route).

The helpers `write_checkpoint`, `engine_pair` and `assert_greedy_equal`
are shared with tests/test_torch_int8.py and tests/test_torch_quip.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.endpoints.llm import LLM as JaxLLM
from aphrodite_tpu.modeling.layers.quantization import squeezellm as JS
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.endpoints.llm import LLM
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.modeling.convert import params_from_jax, to_device
from aphrodite_tpu_torch.modeling.layers.quantization import squeezellm as TS
from aphrodite_tpu_torch.ops.cuda import quant_matmul as tqm

HIDDEN, INTER, HEADS, KV_HEADS, HEAD, VOCAB = 256, 768, 4, 2, 64, 256
GAP_TOL = 1e-4
CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": VOCAB, "hidden_size": HIDDEN, "intermediate_size": INTER,
    "num_hidden_layers": 2, "num_attention_heads": HEADS,
    "num_key_value_heads": KV_HEADS, "max_position_embeddings": 256,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "bos_token_id": 0, "eos_token_id": 1,
}
# (out, in) of each HF projection.
PROJ = {"self_attn.q_proj": (HEADS * HEAD, HIDDEN),
        "self_attn.k_proj": (KV_HEADS * HEAD, HIDDEN),
        "self_attn.v_proj": (KV_HEADS * HEAD, HIDDEN),
        "self_attn.o_proj": (HIDDEN, HEADS * HEAD),
        "mlp.gate_proj": (INTER, HIDDEN), "mlp.up_proj": (INTER, HIDDEN),
        "mlp.down_proj": (HIDDEN, INTER)}
ENGINE_KW = dict(dtype="float32", max_model_len=128, max_num_seqs=4,
                 swap_space=0.01, skip_tokenizer_init=True,
                 disable_log_stats=True, block_size=16)
PROMPTS = [[(i * 7 + 3) % 250 + 5 for i in range(n)] for n in (5, 23, 40)]
SQLLM = {"quant_method": "squeezellm", "wbits": 4}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """No fault injection, speculative decoding or quantization knob left
    over from an earlier test in this process."""
    from aphrodite_tpu.common import faultinject as jax_faults
    from aphrodite_tpu_torch.common import faultinject
    for name in ("APHRODITE_FAULT", "APHRODITE_FAULT_SEED",
                 "APHRODITE_DISABLE_PALLAS_QUANT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    jax_faults.reset()
    faultinject.reset()


# ----------------------------------------------------------- helpers --

def write_checkpoint(path, projection, config=CONFIG, seed=3):
    """A Llama directory: config.json and model.safetensors with random
    embeddings, LM head and unit norms; `projection(rs, out, in)` gives
    each HF projection's tensors {suffix: array}."""
    from safetensors.numpy import save_file
    rs = np.random.RandomState(seed)
    h = config["hidden_size"]
    tensors = {
        "model.embed_tokens.weight": rs.randn(VOCAB, h).astype(np.float32),
        "lm_head.weight": (rs.randn(VOCAB, h) * 0.05).astype(np.float32),
        "model.norm.weight": np.ones(h, np.float32)}
    for i in range(config["num_hidden_layers"]):
        p = f"model.layers.{i}"
        tensors[f"{p}.input_layernorm.weight"] = np.ones(h, np.float32)
        tensors[f"{p}.post_attention_layernorm.weight"] = np.ones(
            h, np.float32)
        for frag, (out_f, in_f) in PROJ.items():
            for suffix, arr in projection(rs, out_f, in_f).items():
                tensors[f"{p}.{frag}.{suffix}"] = arr
    path.mkdir(parents=True, exist_ok=True)
    save_file(tensors, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(config))
    return str(path)


def engine_pair(model_dir, quantization=None, host_params=None, **kw):
    """The JAX LLM and the port's on `model_dir`; with `host_params`
    ({bucket: {name: numpy array}} from the JAX engine's params -> the
    same shape of dict), both engines get the returned weights."""
    jax_llm = JaxLLM(model=model_dir, quantization=quantization,
                     **ENGINE_KW, **kw)
    port = LLM(model=model_dir, quantization=quantization, device="cpu",
               **ENGINE_KW, **kw)
    if host_params is not None:
        host = host_params(jax.tree_util.tree_map(
            np.asarray, jax_llm.engine.executor.params))
        jparams = {k: {n: jnp.asarray(a) for n, a in b.items()}
                   for k, b in host.items()}
        jax_llm.engine.executor.params = jparams
        jax_llm.engine.executor.model_runner.params = jparams
        params = to_device(params_from_jax(host), torch.device("cpu"))
        port.engine.executor.params = params
        port.engine.executor.model_runner.params = params
    return jax_llm, port


def generate(llm, sp_cls, **kw):
    outs = llm.generate(prompt_token_ids=[list(p) for p in PROMPTS],
                        sampling_params=sp_cls(temperature=0.0,
                                               max_tokens=8,
                                               ignore_eos=True, **kw))
    return [o.outputs[0] for o in outs]


def assert_greedy_equal(jax_llm, port):
    """Greedy tokens equal while the port's top-2 logprob gap exceeds
    GAP_TOL (a near tie may flip on float noise), at least 16 compared."""
    want = [o.token_ids for o in generate(jax_llm, JaxSamplingParams)]
    got = generate(port, SamplingParams, logprobs=2)
    compared = 0
    for w, g in zip(want, got):
        for pos, (wt, gt) in enumerate(zip(w, g.token_ids)):
            top = sorted(g.logprobs[pos].values(), reverse=True)
            if top[0] - top[1] <= GAP_TOL:
                break
            assert wt == gt, (pos, w, g.token_ids)
            compared += 1
    assert compared >= 16, compared


def spy(monkeypatch, module, names):
    """Count the calls of `module.<name>` (the wrappers the methods call
    through `qmm`)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def fn(*a, _real=getattr(module, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(module, name, fn)
    return calls


def _configs(path, device="cpu", dtype="auto", **kw):
    return EngineArgs(model=path, load_format="dummy", dtype=dtype,
                      device=device, **kw).create_engine_configs()


def sqllm_projection(rs, out_f, in_f):
    return {"qweight": rs.randint(-2 ** 31, 2 ** 31, (in_f // 8, out_f),
                                  dtype=np.int64).astype(np.int32),
            "lookup_table": (rs.randn(out_f, 16) * 0.05).astype(np.float32)}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("sqllm") / "m",
                            sqllm_projection,
                            dict(CONFIG, quantization_config=SQLLM))


# -------------------------------------------------------------- layer --

@pytest.mark.parametrize("K,N", [(256, 384), (128, 256)],
                         ids=["k16", "gated"])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_apply_matches_jax(monkeypatch, K, N, lead):
    calls = spy(monkeypatch, TS.qmm, ["squeezellm_matmul"])
    params = sqllm_projection(np.random.RandomState(K + N), N, K)
    x = np.random.RandomState(1).randn(*lead, K).astype(np.float32)
    want = np.asarray(JS.SqueezeLLMLinearMethod(JS.SqueezeLLMConfig()).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    got = TS.SqueezeLLMLinearMethod(TS.SqueezeLLMConfig()).apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*lead, N)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert calls["squeezellm_matmul"] == (1 if K % 256 == 0 else 0)


def test_disable_pallas_quant_takes_the_dequantize_route(monkeypatch):
    """APHRODITE_DISABLE_PALLAS_QUANT=1, read per call: x @ dequantize,
    no K16 call; unset again, K16's wrapper."""
    calls = spy(monkeypatch, TS.qmm, ["squeezellm_matmul"])
    params = {k: torch.from_numpy(v) for k, v in sqllm_projection(
        np.random.RandomState(7), 256, 512).items()}
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 512).astype(
        np.float32))
    method = TS.SqueezeLLMLinearMethod(TS.SqueezeLLMConfig())
    monkeypatch.setenv("APHRODITE_DISABLE_PALLAS_QUANT", "1")
    got = method.apply(params, x)
    assert calls["squeezellm_matmul"] == 0
    assert torch.equal(got, x @ method.dequantize(params, torch.float32))
    monkeypatch.delenv("APHRODITE_DISABLE_PALLAS_QUANT")
    kernel = method.apply(params, x)
    assert calls["squeezellm_matmul"] == 1
    assert (got - kernel).abs().max() <= 1e-5 * kernel.abs().max()


# ------------------------------------------------------------ loading --

def test_loaded_params_equal_the_jax_loaders(checkpoint):
    jax_llm, port = engine_pair(checkpoint)
    host = jax.tree_util.tree_map(np.asarray,
                                  jax_llm.engine.executor.params)
    want = params_from_jax(host)
    got = port.engine.executor.params
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == set(want[key]), key
        for name, w in want[key].items():
            assert got[key][name].dtype == w.dtype, (key, name)
            assert torch.equal(got[key][name], w), (key, name)
    qkv = got["model.layers.0.self_attn.qkv_proj"]
    assert tuple(qkv["qweight"].shape) == (HIDDEN // 8, 512)
    assert tuple(qkv["lookup_table"].shape) == (512, 16)


def test_dummy_weights_have_random_codes(tmp_path):
    from aphrodite_tpu_torch.modeling.loader import get_model
    path = write_checkpoint(tmp_path / "m", sqllm_projection,
                            dict(CONFIG, quantization_config=SQLLM))
    _, params = get_model(_configs(path)[0], torch.device("cpu"))
    down = params["model.layers.1.mlp.down_proj"]
    assert {k: tuple(v.shape) for k, v in down.items()} == {
        "qweight": (INTER // 8, HIDDEN), "lookup_table": (HIDDEN, 16)}
    codes = tqm.unpack_rows(down["qweight"], 4)
    assert sorted(torch.unique(codes).tolist()) == list(range(16))


# ------------------------------------------------------------- engine --

def test_greedy_generation_matches_jax(checkpoint, monkeypatch):
    calls = spy(monkeypatch, TS.qmm, ["squeezellm_matmul"])
    jax_llm, port = engine_pair(checkpoint)
    assert_greedy_equal(jax_llm, port)
    # Prompt round plus 7 decode rounds, 2 layers, 4 projections.
    assert calls["squeezellm_matmul"] == 8 * 2 * 4


# ------------------------------------------------------------- config --

def test_config_on_the_cpu_and_on_the_card(tmp_path):
    """float32 on the card, and on the card hidden 128, where K16's gate
    refuses every projection but down, were refused until the fallback
    route served them; the test keeps its id and holds what replaced the
    refusals: the configs build on the CPU and on the card in bfloat16
    and float32, at hidden 256 and 128."""
    path = write_checkpoint(tmp_path / "m", sqllm_projection,
                            dict(CONFIG, quantization_config=SQLLM))
    assert _configs(path)[0].quantization == "squeezellm"
    for dtype in ("bfloat16", "float32"):
        assert _configs(path, device="cuda", dtype=dtype)[0].dtype == dtype
    narrow = tmp_path / "narrow"
    narrow.mkdir()
    (narrow / "config.json").write_text(json.dumps(dict(
        CONFIG, hidden_size=128, quantization_config=SQLLM)))
    for device in ("cpu", "cuda", "auto"):
        assert _configs(str(narrow), device=device, dtype="bfloat16"
                        )[0].quantization == "squeezellm"
    from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm
    assert not qmm.squeezellm_supported(128, 256)
    assert qmm.squeezellm_supported(768, 128)
