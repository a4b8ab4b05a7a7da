"""The port's AWQ path (config, layer, loading, dummy weights, engine)
against the JAX package, on the CPU.

A tiny llm-awq checkpoint is built locally with real asymmetric group
quantization from numpy weights made from a seed, packed with the
`pack_awq` of tests/quantization/test_quant_methods.py (copied) and
written with safetensors: a Llama of hidden 1024, intermediate 1024, 8
query and 4 KV heads of 128, 2 layers, vocab 256, 4-bit codes in groups
of 128, so that every projection's output width is a multiple of 1024
(the kernels' gate). AWQ has no g_idx: the JAX package's CPU path
(dequantize, then matmul) and the port's kernels use the same weight.

- Config: AWQ accepted from `quantization_config` and from
  `quantization="awq"`; shapes outside the kernels' gate accepted too,
  on the CPU and on the card (those layers take the dequantize-then-
  matmul route, held to the JAX package in tests/test_torch_fallback.py);
  float32 AWQ accepted on the card and on the CPU.
- Dummy init: packed payloads span the int32 range.
- `AWQLinearMethod.apply` against the JAX `dequantize` then matmul,
  W4A16 and (APHRODITE_W4A8=1) W4A8 against the JAX `apply` on its
  Pallas route in interpret mode: within 1e-5 of max |y| (f32, the same
  products summed in another order).
- Loading: the merged `qkv_proj` / `gate_up_proj` (and every other)
  parameter equals the JAX package's exactly, and `params_from_jax`
  passes AWQ tensors through untransposed.
- Greedy `LLM.generate` with W4A16 is token-for-token equal to the JAX
  engine's (compared while the port's top-2 logprob gap exceeds 1e-4).
"""
import json

import jax
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.endpoints.llm import LLM as JaxLLM
from aphrodite_tpu.modeling.layers.quantization.awq import (
    AWQ_ORDER, AWQConfig as JaxAWQConfig,
    AWQLinearMethod as JaxAWQLinearMethod)
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.endpoints.llm import LLM
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.modeling.convert import params_from_jax
from aphrodite_tpu_torch.modeling.layers.quantization.awq import (
    AWQConfig, AWQLinearMethod)

GROUP = 128
GAP_TOL = 1e-4
HEAD = 128
CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 256, "hidden_size": 1024, "intermediate_size": 1024,
    "num_hidden_layers": 2, "num_attention_heads": 8,
    "num_key_value_heads": 4, "max_position_embeddings": 256,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "bos_token_id": 0, "eos_token_id": 1,
}
QUANT = {"quant_method": "awq", "bits": 4, "group_size": GROUP,
         "zero_point": True, "version": "gemm"}
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


def pack_awq(q):
    """llm-awq packing: element e at nibble AWQ_ORDER[e], along OUT."""
    out = np.zeros((q.shape[0], q.shape[1] // 8), dtype=np.uint32)
    for j in range(q.shape[1]):
        e = j % 8
        out[:, j // 8] |= q[:, j].astype(np.uint32) << (4 * AWQ_ORDER[e])
    return out.astype(np.int32)


def quantize_awq(w: np.ndarray):
    """[out, in] float -> llm-awq (qweight [in, out/8] int32, qzeros
    [in/gs, out/8] int32, scales [in/gs, out] f16) with real asymmetric
    group quantization along IN."""
    wt = w.T                                            # [in, out]
    in_f, out_f = wt.shape
    wg = wt.reshape(in_f // GROUP, GROUP, out_f)
    wmax, wmin = wg.max(1), wg.min(1)                   # [G, out]
    scale = np.maximum((wmax - wmin) / 15.0, 1e-8)
    scale = scale.astype(np.float16).astype(np.float32)
    zero = np.clip(np.round(-wmin / scale), 0, 15)
    q = np.clip(np.round(wg / scale[:, None]) + zero[:, None], 0, 15)
    return (pack_awq(q.reshape(in_f, out_f).astype(np.int64)),
            pack_awq(zero.astype(np.int64)), scale.astype(np.float16))


def _write_model_dir(path, config):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    return str(path)


@pytest.fixture(scope="module")
def awq_checkpoint(tmp_path_factory):
    from safetensors.numpy import save_file
    rs = np.random.RandomState(5)
    c = CONFIG
    h, inter = c["hidden_size"], c["intermediate_size"]
    shapes = {"q_proj": (8 * HEAD, h), "k_proj": (4 * HEAD, h),
              "v_proj": (4 * HEAD, h), "o_proj": (h, 8 * HEAD),
              "gate_proj": (inter, h), "up_proj": (inter, h),
              "down_proj": (h, inter)}
    tensors = {
        "model.embed_tokens.weight":
            rs.randn(c["vocab_size"], h).astype(np.float32),
        "lm_head.weight":
            (rs.randn(c["vocab_size"], h) * 0.1).astype(np.float32),
        "model.norm.weight": np.ones(h, np.float32),
    }
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        tensors[f"{p}.input_layernorm.weight"] = np.ones(h, np.float32)
        tensors[f"{p}.post_attention_layernorm.weight"] = \
            np.ones(h, np.float32)
        for frag, shape in shapes.items():
            part = "self_attn" if frag in ("q_proj", "k_proj", "v_proj",
                                           "o_proj") else "mlp"
            w = (rs.randn(*shape) * 0.02).astype(np.float32)
            qweight, qzeros, scales = quantize_awq(w)
            base = f"{p}.{part}.{frag}"
            tensors[f"{base}.qweight"] = qweight
            tensors[f"{base}.qzeros"] = qzeros
            tensors[f"{base}.scales"] = scales
    path = tmp_path_factory.mktemp("awq-ckpt")
    save_file(tensors, str(path / "model.safetensors"))
    _write_model_dir(path, dict(CONFIG, quantization_config=QUANT))
    return str(path)


@pytest.fixture(scope="module")
def llms(awq_checkpoint):
    mp = pytest.MonkeyPatch()
    mp.setenv("APHRODITE_SPEC", "0")
    mp.delenv("APHRODITE_W4A8", raising=False)
    jax_llm = JaxLLM(model=awq_checkpoint, load_format="safetensors",
                     **ENGINE_KW)
    port = LLM(model=awq_checkpoint, load_format="safetensors",
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


@pytest.mark.parametrize("quant", [QUANT, {"quant_method": "awq",
                                           "w_bit": 4, "q_group_size": 256,
                                           "zero_point": True}])
def test_awq_is_accepted(tmp_path, quant):
    model_config = _configs(tmp_path, quant)[0]
    assert model_config.quantization == "awq"
    from aphrodite_tpu_torch.modeling.layers.quantization import (
        get_quantization_config)
    cfg = get_quantization_config(model_config)
    assert isinstance(cfg, AWQConfig)
    assert cfg.group_size == quant.get("group_size",
                                       quant.get("q_group_size"))


def test_awq_from_the_quantization_argument(tmp_path):
    path = _write_model_dir(tmp_path / "m", CONFIG)
    model_config = EngineArgs(
        model=path, load_format="dummy", quantization="awq",
        device="cpu").create_engine_configs()[0]
    assert model_config.quantization == "awq"


@pytest.mark.parametrize("quant,changes,what", [
    (dict(QUANT, group_size=64), {}, "AWQ group size 64"),
    (QUANT, {"intermediate_size": 1152}, "AWQ group size 128"),
    (QUANT, {"hidden_size": 960, "num_attention_heads": 8,
             "head_dim": 120}, "AWQ group size 128"),
])
def test_out_of_gate_awq_is_refused(tmp_path, quant, changes, what):
    """These shapes were refused, naming the quantized matmul fallback
    route, until the port served it; each case keeps its id and holds
    what replaced the refusal: the configs build on the CPU and on the
    card (device "cuda" and "auto"), and the kernels' gate refuses the
    layer the case names (groups of 64; gate_up out 2304 and down in
    1152 at intermediate 1152; every projection at hidden 960), which
    `apply` sends to the dequantize route."""
    from aphrodite_tpu_torch.modeling.layers.quantization import (
        get_quantization_config)
    for device in ("cpu", "cuda", "auto"):
        model_config = _configs(tmp_path, quant, device=device,
                                **changes)[0]
        assert model_config.quantization == "awq"
    cfg = get_quantization_config(model_config)
    hidden = changes.get("hidden_size", CONFIG["hidden_size"])
    inter = changes.get("intermediate_size", CONFIG["intermediate_size"])
    assert not cfg.supports(hidden, 2 * inter) or \
        not cfg.supports(hidden, hidden), what


@pytest.mark.parametrize("device", ["cuda", "auto"])
def test_awq_in_float32_on_the_card_is_refused(tmp_path, device):
    """float32 AWQ was refused on the card until the fallback route
    served it; the test keeps its id and holds what replaced the
    refusal: the configs build on the card in float32 and bfloat16 and
    on the CPU (on a card a float32 layer takes the dequantize route)."""
    for dtype in ("float32", "bfloat16"):
        assert _configs(tmp_path, QUANT, device=device,
                        dtype=dtype)[0].dtype == dtype
    assert _configs(tmp_path, QUANT, dtype="float32")[0].dtype == "float32"


def test_dummy_awq_init_spans_int32(awq_checkpoint):
    from aphrodite_tpu_torch.modeling.loader import get_model
    model_config = EngineArgs(
        model=awq_checkpoint, load_format="dummy", dtype="float32",
        device="cpu").create_engine_configs()[0]
    _, params = get_model(model_config, torch.device("cpu"))
    qkv = params["model.layers.0.self_attn.qkv_proj"]
    assert set(qkv) == {"qweight", "qzeros", "scales"}
    for name in ("qweight", "qzeros"):
        t = qkv[name]
        assert t.dtype == torch.int32
        assert int(t.min()) < -2 ** 30 and int(t.max()) > 2 ** 30
        assert 0.4 < float((t < 0).float().mean()) < 0.6
    assert qkv["scales"].dtype == torch.float32
    assert float(qkv["scales"].abs().max()) <= 1e-3
    assert tuple(qkv["qweight"].shape) == (1024, 2048 // 8)
    assert tuple(qkv["qzeros"].shape) == (1024 // GROUP, 2048 // 8)


# ----------------------------------------------------------- layer --

def _layer_arrays(seed, K, N, gs):
    rs = np.random.RandomState(seed)
    return {
        "qweight": rs.randint(-2 ** 31, 2 ** 31, (K, N // 8),
                              dtype=np.int64).astype(np.int32),
        "qzeros": rs.randint(-2 ** 31, 2 ** 31, (K // gs, N // 8),
                             dtype=np.int64).astype(np.int32),
        "scales": (rs.rand(K // gs, N) * 0.05 + 0.01).astype(np.float32),
    }


@pytest.mark.parametrize("gs", [128, 256])
def test_apply_matches_jax_dequantize_then_matmul(gs):
    import jax.numpy as jnp
    K, N = 512, 1024
    arrays = _layer_arrays(gs, K, N, gs)
    x = np.random.RandomState(gs + 1).randn(3, 5, K).astype(np.float32)
    jm = JaxAWQLinearMethod(JaxAWQConfig(4, gs))
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = np.asarray(jnp.asarray(x) @ jm.dequantize(jparams, jnp.float32))
    tm = AWQLinearMethod(AWQConfig(4, gs))
    tparams = {k: torch.from_numpy(v) for k, v in arrays.items()}
    got = tm.apply(tparams, torch.from_numpy(x)).numpy()
    assert got.shape == (3, 5, N)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(
        tm.dequantize(tparams, torch.float32).numpy(),
        np.asarray(jm.dequantize(jparams, jnp.float32)))


@pytest.mark.parametrize("lead", [(3, 5), (2, 40)])
def test_w4a8_apply_matches_jax_pallas_apply(lead, monkeypatch):
    """`AWQLinearMethod.apply` under APHRODITE_W4A8=1 against the JAX
    package's `apply` on its Pallas route (forced here: off the TPU it
    takes the dequantize path), the kernel run with interpret=True: 15
    rows take the streamed a8 kernel (K7), 80 the tiled one (K11), on
    both sides. The JAX side is given the reference chain's int8 rows in
    place of its quantize kernel (see tests/test_torch_quant_matmul.py).
    f32: within 1e-5 of max |y|."""
    import functools

    import jax.numpy as jnp
    from aphrodite_tpu.ops.pallas import quant_matmul as jqm
    K, N, gs = 384, 1024, 128
    arrays = _layer_arrays(sum(lead), K, N, gs)
    x = np.random.RandomState(sum(lead) + 1).randn(*lead, K).astype(
        np.float32)
    monkeypatch.setenv("APHRODITE_W4A8", "1")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    x8, xs = jqm._quantize_activations_int8(jnp.asarray(x.reshape(-1, K)))
    monkeypatch.setattr(jqm, "quantize_activations_int8",
                        lambda x, interpret=False: (x8, xs))
    monkeypatch.setattr(jqm, "awq_matmul_a8", functools.partial(
        jqm.awq_matmul_a8, interpret=True))
    jqm.awq_matmul_a8.func.clear_cache()
    jm = JaxAWQLinearMethod(JaxAWQConfig(4, gs))
    want = np.asarray(jm.apply({k: jnp.asarray(v) for k, v in
                                arrays.items()}, jnp.asarray(x)))
    jqm.awq_matmul_a8.func.clear_cache()
    monkeypatch.undo()
    monkeypatch.setenv("APHRODITE_W4A8", "1")
    tm = AWQLinearMethod(AWQConfig(4, gs))
    got = tm.apply({k: torch.from_numpy(v) for k, v in arrays.items()},
                   torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*lead, N)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # W4A8 really ran: the result is not the W4A16 product.
    monkeypatch.setenv("APHRODITE_W4A8", "0")
    w16 = tm.apply({k: torch.from_numpy(v) for k, v in arrays.items()},
                   torch.from_numpy(x)).numpy()
    assert np.abs(got - w16).max() > 1e-4 * np.abs(w16).max()


# ------------------------------------------------ loading, engine --

def test_merged_layers_load_like_jax(llms):
    jax_llm, port = llms
    assert port.engine.model_config.quantization == "awq"
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
    assert merged == 2 * 2 * 3           # 2 layers x 2 merged x 3 tensors
    # params_from_jax keeps the AWQ layout ([in, out/8]): no transpose.
    qkv = got["model.layers.0.self_attn.qkv_proj"]
    assert tuple(qkv["qweight"].shape) == (1024, 2048 // 8)
    assert tuple(qkv["qzeros"].shape) == (1024 // GROUP, 2048 // 8)
    assert tuple(qkv["scales"].shape) == (1024 // GROUP, 2048)
    assert qkv["scales"].dtype == torch.float32      # f16 cast on load


def test_merged_layer_equals_its_checkpoint_parts(llms, awq_checkpoint):
    """The merged qkv_proj's packed columns are q, k and v side by side,
    each at its offset divided by 8 (qweight, qzeros) or 1 (scales)."""
    from safetensors.numpy import load_file
    _, port = llms
    ckpt = load_file(f"{awq_checkpoint}/model.safetensors")
    qkv = port.engine.executor.params["model.layers.1.self_attn.qkv_proj"]
    base = "model.layers.1.self_attn"
    for name in ("qweight", "qzeros", "scales"):
        want = np.concatenate([ckpt[f"{base}.{p}.{name}"]
                               for p in ("q_proj", "k_proj", "v_proj")],
                              axis=-1)
        np.testing.assert_array_equal(
            qkv[name].numpy(), want.astype(qkv[name].numpy().dtype))


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
    assert len({tuple(g) for g in got}) > 1      # not a degenerate model
