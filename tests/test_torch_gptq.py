"""The port's GPTQ path (config, layer, loading, dummy weights, engine)
against the JAX package, on the CPU.

A tiny AutoGPTQ checkpoint is built locally with the real asymmetric
group-quantization math (the `quantize_gptq` helper of
tests/engine/test_quantized_checkpoint_e2e.py, copied) from numpy
weights made from a seed, written with safetensors: a Llama of hidden
128, intermediate 256, 4 query and 2 KV heads of 32, 2 layers, 4-bit
codes in groups of 128, g_idx = arange(in) // 128 as desc_act=False
checkpoints store it. The JAX package's CPU path gathers scales by
g_idx and the port's kernels (like the Pallas ones) use contiguous
groups; with this g_idx the two are the same weight.

- Config: 4- and 8-bit GPTQ accepted; desc_act, 2-bit, shapes the
  kernels do not take, and SqueezeLLM at shapes K16 does not take
  accepted too, on the CPU and on the card (the layers the gates refuse
  take the dequantize-then-matmul route; tests/test_torch_fallback.py
  holds that route to the JAX package).
- Dummy init: packed payloads span the int32 range, g_idx is zero.
- Config: float32 GPTQ accepted on the card (its layers take the
  dequantize route there) and on the CPU.
- `GPTQLinearMethod.apply` against the JAX `dequantize` then matmul, and
  under W4A8 against the JAX `apply` on its Pallas route (interpret
  mode): within 1e-5 of max |y| (f32, sums in another order).
- Loading: the merged `qkv_proj` / `gate_up_proj` (and every other)
  parameter equals the JAX package's exactly.
- Greedy `LLM.generate` with W4A16 is token-for-token equal to the JAX
  engine's (compared while the port's top-2 logprob gap exceeds 1e-4).
- W4A8 (APHRODITE_W4A8=1) through the port's model runner: its logits
  stay within the bounds tests/quantization/test_w4a8_drift.py holds the
  JAX path to, relative to the port's W4A16 logits.
- APHRODITE_DISABLE_PALLAS_QUANT=1: on dummy weights (g_idx zero; the
  JAX engine's weights, floats scaled x100, given to the port) the port
  takes the JAX package's dequantize-then-matmul route, launches no
  K6-K9 wrapper, and is greedy token-equal to the JAX CPU engine with
  APHRODITE_W4A8 0 and 1; unsetting the flag between two generate calls
  on one engine sends the next call back through the kernels.
"""
import json

import jax
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.endpoints.llm import LLM as JaxLLM
from aphrodite_tpu.modeling.layers.quantization.gptq import (
    GPTQConfig as JaxGPTQConfig, GPTQLinearMethod as JaxGPTQLinearMethod)
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.sequence import (SequenceData,
                                                 SequenceGroupMetadata)
from aphrodite_tpu_torch.endpoints.llm import LLM
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.modeling.convert import params_from_jax
from aphrodite_tpu_torch.modeling.layers.quantization.gptq import (
    GPTQConfig, GPTQLinearMethod)

GROUP = 128
GAP_TOL = 1e-4
CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 256, "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "max_position_embeddings": 256,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "bos_token_id": 0, "eos_token_id": 1,
}
QUANT = {"quant_method": "gptq", "bits": 4, "group_size": GROUP,
         "desc_act": False, "sym": False}
ENGINE_KW = dict(dtype="float32", max_model_len=128, max_num_seqs=4,
                 swap_space=0.01, skip_tokenizer_init=True,
                 disable_log_stats=True, block_size=16)


@pytest.fixture(autouse=True)
def _one_torch_thread():
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


def quantize_gptq(w: np.ndarray):
    """[out, in] float -> AutoGPTQ v1 (qweight [in/8, out] int32,
    qzeros [in/gs, out/8] int32 storing z-1, scales [in/gs, out] f16)
    with REAL asymmetric group quantization, plus the dequantized
    weight for the reference model."""
    out_f, in_f = w.shape
    G = in_f // GROUP
    wg = w.reshape(out_f, G, GROUP)
    wmax = wg.max(-1)
    wmin = wg.min(-1)
    scale = np.maximum((wmax - wmin) / 15.0, 1e-8)      # [out, G]
    # The checkpoint stores f16 scales; the reference dequant must use
    # the SAME rounded values or greedy tokens drift on near-ties.
    scale = scale.astype(np.float16).astype(np.float32)
    zero = np.clip(np.round(-wmin / scale), 0, 15)      # [out, G]
    q = np.clip(np.round(wg / scale[..., None]) + zero[..., None],
                0, 15).astype(np.int64)                 # [out, G, gs]
    deq = (q - zero[..., None]) * scale[..., None]
    deq = deq.reshape(out_f, in_f).astype(np.float32)

    qT = q.reshape(out_f, in_f).T                       # [in, out]
    qweight = np.zeros((in_f // 8, out_f), np.int64)
    for p in range(8):
        qweight |= qT[p::8] << (4 * p)
    zT = zero.T.astype(np.int64)                        # [G, out]
    zstore = zT - 1                                     # v1 stores z-1
    qzeros = np.zeros((G, out_f // 8), np.int64)
    for p in range(8):
        qzeros |= (zstore[:, p::8] & 0xF) << (4 * p)
    # ascontiguousarray: save_file serializes raw bytes, and a .T view
    # is F-contiguous — saving it as-is writes column-major data under
    # a row-major header (silently corrupt checkpoint).
    scales = np.ascontiguousarray(scale.T.astype(np.float16))  # [G, out]
    return (np.ascontiguousarray(
                qweight.astype(np.uint64).astype(np.uint32)
            ).view(np.int32),
            np.ascontiguousarray(
                qzeros.astype(np.uint64).astype(np.uint32)
            ).view(np.int32),
            scales, deq)


def _write_model_dir(path, config):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    return str(path)


@pytest.fixture(scope="module")
def gptq_checkpoint(tmp_path_factory):
    from safetensors.numpy import save_file
    rs = np.random.RandomState(3)
    c = CONFIG
    h, inter, hd = c["hidden_size"], c["intermediate_size"], 32
    shapes = {"q_proj": (4 * hd, h), "k_proj": (2 * hd, h),
              "v_proj": (2 * hd, h), "o_proj": (h, 4 * hd),
              "gate_proj": (inter, h), "up_proj": (inter, h),
              "down_proj": (h, inter)}
    tensors = {
        "model.embed_tokens.weight":
            rs.randn(c["vocab_size"], h).astype(np.float32),
        "lm_head.weight":
            (rs.randn(c["vocab_size"], h) * 0.2).astype(np.float32),
        "model.norm.weight": np.ones(h, np.float32),
    }
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        tensors[f"{p}.input_layernorm.weight"] = np.ones(h, np.float32)
        tensors[f"{p}.post_attention_layernorm.weight"] = \
            np.ones(h, np.float32)
        for frag, shape in shapes.items():
            part = "self_attn" if frag.endswith(("q_proj", "k_proj",
                                                 "v_proj", "o_proj")) \
                else "mlp"
            # Each layer adds an update small next to the residual
            # stream, as in a trained model.
            w = (rs.randn(*shape) * 0.05).astype(np.float32)
            qweight, qzeros, scales, _ = quantize_gptq(w)
            base = f"{p}.{part}.{frag}"
            tensors[f"{base}.qweight"] = qweight
            tensors[f"{base}.qzeros"] = qzeros
            tensors[f"{base}.scales"] = scales
            tensors[f"{base}.g_idx"] = (
                np.arange(shape[1]) // GROUP).astype(np.int32)
    path = tmp_path_factory.mktemp("gptq-ckpt")
    save_file(tensors, str(path / "model.safetensors"))
    _write_model_dir(path, dict(CONFIG, quantization_config=QUANT))
    return str(path)


@pytest.fixture(scope="module")
def llms(gptq_checkpoint):
    mp = pytest.MonkeyPatch()
    mp.setenv("APHRODITE_SPEC", "0")
    mp.delenv("APHRODITE_W4A8", raising=False)
    jax_llm = JaxLLM(model=gptq_checkpoint, load_format="safetensors",
                     **ENGINE_KW)
    port = LLM(model=gptq_checkpoint, load_format="safetensors",
               device="cpu", **ENGINE_KW)
    yield jax_llm, port
    mp.undo()


# ---------------------------------------------------------- config --

def _configs(tmp_path, quant, device="cpu", dtype="auto", **changes):
    path = _write_model_dir(tmp_path / "m",
                            dict(CONFIG, quantization_config=quant,
                                 **changes))
    return EngineArgs(model=path, load_format="dummy", dtype=dtype,
                      device=device).create_engine_configs()


@pytest.mark.parametrize("bits", [4, 8])
def test_gptq_4_and_8_bit_are_accepted(tmp_path, bits):
    model_config = _configs(tmp_path, dict(QUANT, bits=bits))[0]
    assert model_config.quantization == "gptq"


@pytest.mark.parametrize("quant,changes,what", [
    (dict(QUANT, desc_act=True), {}, "desc_act"),
    (dict(QUANT, bits=2), {}, "2-bit GPTQ"),
    (dict(QUANT, group_size=64), {}, "group size 64"),
    (QUANT, {"hidden_size": 96}, "group size 128"),
    ({"quant_method": "squeezellm", "wbits": 4},
     {"device": "cuda", "dtype": "bfloat16"}, "quantization 'squeezellm'"),
])
def test_out_of_slice_gptq_is_refused(tmp_path, quant, changes, what):
    """These configurations were refused, naming the quantized matmul
    fallback route, until the port served it; each case keeps its id and
    holds what replaced the refusal: the configs build on the CPU, and
    on the card (device "cuda" and "auto": the config does not look for
    a card), and the layers the kernels' gate refuses are the ones the
    method's `apply` sends to the dequantize route (act-order, 2 bits,
    groups of 64, hidden 96; SqueezeLLM's hidden-128 layers fail K16's
    gate the same way)."""
    from aphrodite_tpu_torch.modeling.layers.quantization import (
        get_quantization_config)
    from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm
    changes = dict(changes)
    dtype = changes.pop("dtype", "auto")
    changes.pop("device", None)
    for device in ("cpu", "cuda", "auto"):
        model_config = _configs(tmp_path, quant, device=device,
                                dtype=dtype, **changes)[0]
        assert model_config.quantization == quant["quant_method"]
    cfg = get_quantization_config(model_config)
    hidden = changes.get("hidden_size", CONFIG["hidden_size"])
    if quant["quant_method"] == "gptq":
        assert not cfg.supports(hidden, hidden), what
    else:
        assert not qmm.squeezellm_supported(hidden, hidden), what


@pytest.mark.parametrize("device", ["cuda", "auto"])
def test_gptq_in_float32_on_the_card_is_refused(tmp_path, device):
    """float32 GPTQ was refused on the card (the kernels take bfloat16
    activations) until the fallback route served it; the test keeps its
    id and holds what replaced the refusal: the configs build on the
    card in float32 and bfloat16 (the config does not look for a card:
    DeviceConfig resolves later) and on the CPU, and on a card a float32
    layer takes the dequantize route (`kernel_takes_dtype`)."""
    from aphrodite_tpu_torch.modeling.layers.quantization.base_config \
        import kernel_takes_dtype
    for dtype in ("float32", "bfloat16"):
        assert _configs(tmp_path, QUANT, device=device,
                        dtype=dtype)[0].dtype == dtype
    assert _configs(tmp_path, QUANT, dtype="float32")[0].dtype == "float32"
    meta = torch.empty(2, 8, device="meta")
    assert not kernel_takes_dtype(meta)
    assert kernel_takes_dtype(meta.bfloat16())
    assert kernel_takes_dtype(torch.empty(2, 8))


def test_dummy_gptq_init_spans_int32_and_zeroes_g_idx(gptq_checkpoint):
    from aphrodite_tpu_torch.modeling.loader import get_model
    model_config = EngineArgs(
        model=gptq_checkpoint, load_format="dummy", dtype="float32",
        device="cpu").create_engine_configs()[0]
    model, params = get_model(model_config, torch.device("cpu"))
    qkv = params["model.layers.0.self_attn.qkv_proj"]
    assert set(qkv) == {"qweight", "qzeros", "scales", "g_idx"}
    for name in ("qweight", "qzeros"):
        t = qkv[name]
        assert t.dtype == torch.int32
        assert int(t.min()) < -2 ** 30 and int(t.max()) > 2 ** 30
        assert 0.4 < float((t < 0).float().mean()) < 0.6
    assert qkv["g_idx"].dtype == torch.int32
    assert not qkv["g_idx"].any()
    assert qkv["scales"].dtype == torch.float32
    assert float(qkv["scales"].abs().max()) <= 1e-3
    assert tuple(qkv["qweight"].shape) == (128 // 8, 256)
    assert params["lm_head"]["weight"].dtype == torch.float32


# ----------------------------------------------------------- layer --

@pytest.mark.parametrize("bits,gs", [(4, 128), (8, 128), (4, 256)])
def test_apply_matches_jax_dequantize_then_matmul(bits, gs):
    import jax.numpy as jnp
    rs = np.random.RandomState(bits + gs)
    K, N, pack = 512, 256, 32 // bits
    arrays = {
        "qweight": rs.randint(-2 ** 31, 2 ** 31, (K // pack, N),
                              dtype=np.int64).astype(np.int32),
        "qzeros": rs.randint(-2 ** 31, 2 ** 31, (K // gs, N // pack),
                             dtype=np.int64).astype(np.int32),
        "scales": (rs.rand(K // gs, N) * 0.05 + 0.01).astype(np.float32),
        "g_idx": (np.arange(K) // gs).astype(np.int32),
    }
    x = rs.randn(3, 5, K).astype(np.float32)
    jm = JaxGPTQLinearMethod(JaxGPTQConfig(bits, gs))
    want = np.asarray(jnp.asarray(x) @ jm.dequantize(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.float32))
    tm = GPTQLinearMethod(GPTQConfig(bits, gs))
    got = tm.apply({k: torch.from_numpy(v) for k, v in arrays.items()},
                   torch.from_numpy(x)).numpy()
    assert got.shape == (3, 5, N)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # The plain helper mirrors the JAX `dequantize` (g_idx grouping).
    w = tm.dequantize({k: torch.from_numpy(v) for k, v in arrays.items()},
                      torch.float32).numpy()
    np.testing.assert_array_equal(w, np.asarray(jm.dequantize(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.float32)))


@pytest.mark.parametrize("lead", [(3, 5), (2, 40)])
def test_w4a8_apply_matches_jax_pallas_apply(lead, monkeypatch):
    """`GPTQLinearMethod.apply` under APHRODITE_W4A8=1 against the JAX
    package's `apply` on its Pallas route (forced here: off the TPU it
    takes the dequantize path), the kernel run with interpret=True. 15
    rows take the streamed a8 kernel (K7), 80 the tiled one (K8), on
    both sides. The JAX side is given the reference chain's int8 rows in
    place of its quantize kernel (interpret mode divides by reciprocal
    multiplies; see tests/test_torch_quant_matmul.py). f32: within 1e-5
    of max |y|."""
    import functools

    import jax.numpy as jnp
    from aphrodite_tpu.ops.pallas import quant_matmul as jqm
    rs = np.random.RandomState(sum(lead))
    K, N, gs = 384, 256, 128
    arrays = {
        "qweight": rs.randint(-2 ** 31, 2 ** 31, (K // 8, N),
                              dtype=np.int64).astype(np.int32),
        "qzeros": rs.randint(-2 ** 31, 2 ** 31, (K // gs, N // 8),
                             dtype=np.int64).astype(np.int32),
        "scales": (rs.rand(K // gs, N) * 0.05 + 0.01).astype(np.float32),
        "g_idx": (np.arange(K) // gs).astype(np.int32),
    }
    x = rs.randn(*lead, K).astype(np.float32)
    monkeypatch.setenv("APHRODITE_W4A8", "1")
    monkeypatch.setattr(JaxGPTQLinearMethod, "_use_pallas",
                        lambda self, i, o: True)
    x8, xs = jqm._quantize_activations_int8(jnp.asarray(x.reshape(-1, K)))
    monkeypatch.setattr(jqm, "quantize_activations_int8",
                        lambda x, interpret=False: (x8, xs))
    monkeypatch.setattr(jqm, "gptq_matmul_a8", functools.partial(
        jqm.gptq_matmul_a8, interpret=True))
    jqm.gptq_matmul_a8.func.clear_cache()
    jm = JaxGPTQLinearMethod(JaxGPTQConfig(4, gs))
    want = np.asarray(jm.apply({k: jnp.asarray(v) for k, v in
                                arrays.items()}, jnp.asarray(x)))
    jqm.gptq_matmul_a8.func.clear_cache()
    tm = GPTQLinearMethod(GPTQConfig(4, gs))
    got = tm.apply({k: torch.from_numpy(v) for k, v in arrays.items()},
                   torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*lead, N)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # W4A8 really ran: the result is not the W4A16 product.
    a16 = GPTQLinearMethod(GPTQConfig(4, gs))
    monkeypatch.setenv("APHRODITE_W4A8", "0")
    w16 = a16.apply({k: torch.from_numpy(v) for k, v in arrays.items()},
                    torch.from_numpy(x)).numpy()
    assert np.abs(got - w16).max() > 1e-4 * np.abs(w16).max()


# ------------------------------------------------ loading, engine --

def test_merged_layers_load_like_jax(llms):
    jax_llm, port = llms
    assert port.engine.model_config.quantization == "gptq"
    host = jax.tree_util.tree_map(np.asarray,
                                  jax_llm.engine.executor.params)
    want = params_from_jax(host)
    got = port.engine.executor.params
    assert set(got) == set(want)
    merged = 0
    for key, bucket in want.items():
        assert set(got[key]) == set(bucket), key
        for name, tensor in bucket.items():
            assert got[key][name].dtype == tensor.dtype, (key, name)
            assert torch.equal(got[key][name], tensor), (key, name)
            merged += key.endswith(("qkv_proj", "gate_up_proj"))
    assert merged == 2 * 2 * 4           # 2 layers x 2 merged x 4 tensors
    qkv = got["model.layers.0.self_attn.qkv_proj"]
    assert tuple(qkv["qzeros"].shape) == (1, 256 // 8)
    assert torch.equal(qkv["g_idx"], torch.arange(128, dtype=torch.int32)
                       // GROUP)


PROMPTS = [[(i * 7 + 3) % 250 + 5 for i in range(n)] for n in (5, 23, 40)]


def _generate(llm, sp_cls, **kw):
    outs = llm.generate(prompt_token_ids=[list(p) for p in PROMPTS],
                        sampling_params=sp_cls(temperature=0.0,
                                               max_tokens=8,
                                               ignore_eos=True, **kw))
    return [o.outputs[0] for o in outs]


def test_w4a16_greedy_generation_matches_jax(llms):
    jax_llm, port = llms
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
    assert compared >= 12


def _logits_run(runner, tokens, steps):
    """Prompt + `steps` decode steps through the port's model runner,
    greedy; returns each step's logits row."""
    kv = [(torch.zeros(32, 16, 64), torch.zeros(32, 16, 64))
          for _ in range(2)]
    tokens = list(tokens)
    rows = []
    table = [3, 9, 4, 12, 7]
    for step in range(steps + 1):
        data = SequenceData(tokens if step == 0 else tokens[:-1])
        if step:
            data.append_token_id(tokens[-1], 0.0)
        md = SequenceGroupMetadata("0", step == 0, {0: data},
                                   SamplingParams(temperature=0.0),
                                   {0: table}, {0: {}})
        inputs, _ = (runner._prepare_prompt([md]) if step == 0
                     else runner._prepare_decode([md]))
        meta = inputs["metadata"].replace(is_prompt=step == 0)
        logits, kv = runner._logits(runner.params, inputs["input_ids"],
                                    inputs["positions"], kv, meta,
                                    inputs["sel"])
        rows.append(logits[inputs["num_rows"] - 1].clone())
        tokens.append(int(rows[-1].argmax()))
    return rows


def test_w4a8_logits_stay_near_w4a16(llms, monkeypatch):
    from aphrodite_tpu_torch.modeling.layers.quantization import gptq
    _, port = llms
    runner = port.engine.executor.model_runner
    calls = {"a8": 0}
    real = gptq.qmm.gptq_matmul_a8

    def spy(*a, **kw):
        calls["a8"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(gptq.qmm, "gptq_matmul_a8", spy)
    ref = _logits_run(runner, PROMPTS[2], steps=4)
    assert calls["a8"] == 0
    monkeypatch.setenv("APHRODITE_W4A8", "1")
    got = _logits_run(runner, PROMPTS[2], steps=4)
    assert calls["a8"] == 5 * 2 * 4       # steps x layers x projections
    rels = [float(torch.sqrt(torch.mean((a - b) ** 2)) /
                  (torch.sqrt(torch.mean(a ** 2)) + 1e-9))
            for a, b in zip(ref, got)]
    assert float(ref[0].std()) > 0.1           # not a degenerate model
    # tests/quantization/test_w4a8_drift.py:54-56.
    assert rels[0] < 2.5e-2, rels
    assert rels[-1] < 3 * max(rels[0], 1e-3), rels
    assert max(rels) < 5e-2, rels


# --------------------------------------- APHRODITE_DISABLE_PALLAS_QUANT --

@pytest.fixture(scope="module")
def dummy_llms(tmp_path_factory):
    """Dummy GPTQ weights (g_idx zero) on both packages, the port given
    the JAX engine's weights with every float scaled x100."""
    from aphrodite_tpu_torch.modeling.convert import to_device
    mp = pytest.MonkeyPatch()
    mp.setenv("APHRODITE_SPEC", "0")
    path = _write_model_dir(tmp_path_factory.mktemp("gptq-dummy") / "m",
                            dict(CONFIG, quantization_config=QUANT))
    jax_llm = JaxLLM(model=path, load_format="dummy", **ENGINE_KW)
    port = LLM(model=path, load_format="dummy", device="cpu", **ENGINE_KW)
    scaled = jax.tree_util.tree_map(
        lambda a: a * 100 if a.dtype.kind == "f" else a,
        jax_llm.engine.executor.params)
    jax_llm.engine.executor.params = scaled
    jax_llm.engine.executor.model_runner.params = scaled
    params = to_device(params_from_jax(jax.tree_util.tree_map(
        np.asarray, scaled)), torch.device("cpu"), torch.float32)
    port.engine.executor.params = params
    port.engine.executor.model_runner.params = params
    yield jax_llm, port
    mp.undo()


@pytest.mark.parametrize("w4a8", ["0", "1"])
def test_disable_pallas_quant_takes_the_dequantize_route(dummy_llms, w4a8,
                                                         monkeypatch):
    from aphrodite_tpu_torch.modeling.layers.quantization import gptq
    jax_llm, port = dummy_llms
    qkv = port.engine.executor.params["model.layers.0.self_attn.qkv_proj"]
    assert not qkv["g_idx"].any()
    calls = {"kernels": 0}
    for name in ("gptq_matmul", "gptq_matmul_a8"):
        real = getattr(gptq.qmm, name)

        def spy(*a, _real=real, **kw):
            calls["kernels"] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(gptq.qmm, name, spy)
    monkeypatch.setenv("APHRODITE_W4A8", w4a8)
    monkeypatch.setenv("APHRODITE_DISABLE_PALLAS_QUANT", "1")
    want = [o.token_ids for o in _generate(jax_llm, JaxSamplingParams)]
    got = _generate(port, SamplingParams, logprobs=2)
    assert calls["kernels"] == 0
    compared = 0
    for w, g in zip(want, got):
        for pos, (wt, gt) in enumerate(zip(w, g.token_ids)):
            top = sorted(g.logprobs[pos].values(), reverse=True)
            if top[0] - top[1] <= GAP_TOL:
                break
            assert wt == gt, (pos, w, g.token_ids)
            compared += 1
    assert compared >= 12
    # Read per call: the same engine goes back through the kernels.
    monkeypatch.setenv("APHRODITE_DISABLE_PALLAS_QUANT", "0")
    _generate(port, SamplingParams)
    assert calls["kernels"] > 0
