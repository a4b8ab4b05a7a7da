"""The port's quantized fallback route (dequantize, then matmul, in plain
torch) against the JAX package, on the CPU.

Every checkpoint is built here with real asymmetric group quantization
from numpy weights made from a seed and written with safetensors: GPTQ
in the AutoGPTQ layout (codes along IN, zeros stored minus one, `g_idx`
per input row), generalised from `quantize_gptq` of
tests/test_torch_gptq.py to 2, 4 and 8 bits, any group size and an
act-order `g_idx` (a seeded permutation of arange(in) // group, so each
group holds exactly `group` rows, which need not be contiguous), and AWQ
in the llm-awq layout at any group size. The cases, each a 2-layer model
of vocab 256 that the kernels' gates refuse in part or whole:

- GPTQ 4-bit, group 32, desc_act (act-order `g_idx`);
- GPTQ 2-bit, group 128;
- GPTQ 8-bit, group 64;
- GPTQ 4-bit, group 128 at hidden 96 (3 query heads, 1 KV head of 32);
- AWQ, group 64;
- AWQ group 128 over a Llama and a Qwen2 (q/k/v biases) of hidden 128
  and intermediate 512: gate_up (out 1024) passes the AWQ gate and takes
  the kernel's plain version, qkv, o and down take the fallback.

Each case holds: every layer-0 projection's `apply` against the JAX
`dequantize` then matmul (its CPU route), within 1e-5 of max |y| in f32;
the model's logits on a 9-token prompt within 1e-5 of the JAX model's
max |logit|; greedy `LLM.generate` token-equal to the JAX engine's
(compared while the port's top-2 logprob gap exceeds 1e-4); one seeded
request token-equal; and, with the wrappers spied on through `qmm`, the
kernel wrappers called only for the layers the gate takes (an
act-order checkpoint: never).

Layer routes: a refused layer calls no wrapper and a taken one calls its
wrapper once a call; APHRODITE_W4A8=1 on a refused layer launches no K9
and equals the a16 fallback exactly; float32 activations off the CPU
(meta tensors stand in for the card) take the fallback at shapes the
gates take, bfloat16 ones the kernels. No module of the port turns TF32
on, so float32 products on the card run in full f32.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.endpoints.llm import LLM as JaxLLM
from aphrodite_tpu.modeling.layers.quantization.awq import (
    AWQ_ORDER, AWQConfig as JaxAWQConfig,
    AWQLinearMethod as JaxAWQLinearMethod)
from aphrodite_tpu.modeling.layers.quantization.gptq import (
    GPTQConfig as JaxGPTQConfig, GPTQLinearMethod as JaxGPTQLinearMethod)
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.endpoints.llm import LLM
from aphrodite_tpu_torch.modeling.layers.quantization import awq as TA
from aphrodite_tpu_torch.modeling.layers.quantization import gptq as TG
from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm

GAP_TOL = 1e-4
VOCAB = 256
LLAMA = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": VOCAB, "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "max_position_embeddings": 256,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "bos_token_id": 0, "eos_token_id": 1,
}
QWEN2 = dict(LLAMA, architectures=["Qwen2ForCausalLM"], model_type="qwen2",
             rope_theta=1e6)
ENGINE_KW = dict(dtype="float32", max_model_len=128, max_num_seqs=4,
                 swap_space=0.01, skip_tokenizer_init=True,
                 disable_log_stats=True, block_size=16)
PROMPTS = [[(i * 7 + 3) % 250 + 5 for i in range(n)] for n in (5, 23, 40)]
GPTQ_WRAPPERS = ("gptq_matmul", "gptq_matmul_a8")
AWQ_WRAPPERS = ("awq_matmul", "awq_matmul_a8")


def gptq(bits, group, desc_act=False):
    return {"quant_method": "gptq", "bits": bits, "group_size": group,
            "desc_act": desc_act, "sym": False}


def awq(group):
    return {"quant_method": "awq", "bits": 4, "group_size": group,
            "zero_point": True, "version": "gemm"}


# name -> (model config, quantization_config, projections the gate takes)
CASES = {
    "gptq-4bit-g32-actorder": (LLAMA, gptq(4, 32, True), ()),
    "gptq-2bit-g128": (LLAMA, gptq(2, 128), ()),
    "gptq-8bit-g64": (LLAMA, gptq(8, 64), ()),
    "gptq-hidden96": (dict(LLAMA, hidden_size=96, num_attention_heads=3,
                           num_key_value_heads=1), gptq(4, 128), ()),
    "awq-g64": (LLAMA, awq(64), ()),
    "awq-llama-mixed": (dict(LLAMA, intermediate_size=512), awq(128),
                        ("gate_up_proj",)),
    "awq-qwen2-mixed": (dict(QWEN2, intermediate_size=512), awq(128),
                        ("gate_up_proj",)),
}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """One intra-op thread, and no fault injection, speculative decoding
    or quantization knob left over from an earlier test."""
    from aphrodite_tpu.common import faultinject as jax_faults
    from aphrodite_tpu_torch.common import faultinject
    for name in ("APHRODITE_FAULT", "APHRODITE_FAULT_SEED", "APHRODITE_W4A8",
                 "APHRODITE_DISABLE_PALLAS_QUANT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    jax_faults.reset()
    faultinject.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ checkpoints --

def act_order_g_idx(rs, in_f: int, group: int) -> np.ndarray:
    """An act-order assignment: a seeded permutation of arange(in) //
    group, so every group holds exactly `group` rows."""
    return rs.permutation(np.arange(in_f) // group).astype(np.int32)


def pack_along(codes: np.ndarray, bits: int, axis: int) -> np.ndarray:
    """int codes -> int32 words of 32 // bits codes along `axis`, code p
    of a word at shift p * bits (AutoGPTQ's order)."""
    pack = 32 // bits
    c = np.moveaxis(codes.astype(np.uint64), axis, 0)
    words = np.zeros((c.shape[0] // pack,) + c.shape[1:], np.uint64)
    for p in range(pack):
        words |= c[p::pack] << np.uint64(bits * p)
    return np.ascontiguousarray(np.moveaxis(
        words.astype(np.uint32).view(np.int32), 0, axis))


def quantize_gptq_rows(w: np.ndarray, bits: int, group: int,
                       g_idx: np.ndarray):
    """[out, in] float -> AutoGPTQ (qweight [in/pack, out], qzeros
    [G, out/pack] storing z-1, scales [G, out] f16), row k of the input
    in group g_idx[k]: asymmetric min/max quantization per (group,
    output column), G = max(1, in // group) as `create_weights` sizes
    it."""
    out_f, in_f = w.shape
    maxq = 2 ** bits - 1
    G = max(1, in_f // group)
    scales = np.zeros((G, out_f), np.float32)
    zeros = np.zeros((G, out_f), np.int64)
    for g in range(G):
        wg = w[:, g_idx == g]
        scale = np.maximum((wg.max(1) - wg.min(1)) / maxq, 1e-8)
        scales[g] = scale.astype(np.float16).astype(np.float32)
        zeros[g] = np.clip(np.round(-wg.min(1) / scales[g]), 0, maxq)
    q = np.clip(np.round(w / scales[g_idx].T) + zeros[g_idx].T, 0,
                maxq).astype(np.int64)                  # [out, in]
    return (pack_along(q.T, bits, 0),
            pack_along((zeros - 1) & maxq, bits, 1),
            scales.astype(np.float16))


def pack_awq(q: np.ndarray) -> np.ndarray:
    """llm-awq packing: element e of 8 at nibble AWQ_ORDER[e], along
    OUT."""
    out = np.zeros((q.shape[0], q.shape[1] // 8), dtype=np.uint32)
    for e in range(8):
        out |= q[:, e::8].astype(np.uint32) << (4 * AWQ_ORDER[e])
    return out.view(np.int32)


def quantize_awq(w: np.ndarray, group: int):
    """[out, in] float -> llm-awq (qweight [in, out/8], qzeros [G, out/8],
    scales [G, out] f16), asymmetric groups of `group` input rows."""
    wt = w.T
    in_f, out_f = wt.shape
    wg = wt.reshape(in_f // group, group, out_f)
    scale = np.maximum((wg.max(1) - wg.min(1)) / 15.0, 1e-8)
    scale = scale.astype(np.float16).astype(np.float32)
    zero = np.clip(np.round(-wg.min(1) / scale), 0, 15)
    q = np.clip(np.round(wg / scale[:, None]) + zero[:, None], 0, 15)
    return (pack_awq(q.reshape(in_f, out_f).astype(np.int64)),
            pack_awq(zero.astype(np.int64)), scale.astype(np.float16))


def write_checkpoint(path, config, quant, seed=3):
    """A model directory: config.json (with `quant`) and
    model.safetensors, every projection quantized by `quant`'s method."""
    from safetensors.numpy import save_file
    rs = np.random.RandomState(seed)
    h, inter = config["hidden_size"], config["intermediate_size"]
    heads, kv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = h // heads
    shapes = {"q_proj": (heads * hd, h), "k_proj": (kv * hd, h),
              "v_proj": (kv * hd, h), "o_proj": (h, heads * hd),
              "gate_proj": (inter, h), "up_proj": (inter, h),
              "down_proj": (h, inter)}
    tensors = {
        "model.embed_tokens.weight": rs.randn(VOCAB, h).astype(np.float32),
        "lm_head.weight": (rs.randn(VOCAB, h) * 0.2).astype(np.float32),
        "model.norm.weight": np.ones(h, np.float32)}
    qwen2 = config["model_type"] == "qwen2"
    group = quant["group_size"]
    for i in range(config["num_hidden_layers"]):
        p = f"model.layers.{i}"
        tensors[f"{p}.input_layernorm.weight"] = np.ones(h, np.float32)
        tensors[f"{p}.post_attention_layernorm.weight"] = np.ones(
            h, np.float32)
        for frag, shape in shapes.items():
            part = "mlp" if frag in ("gate_proj", "up_proj", "down_proj") \
                else "self_attn"
            base = f"{p}.{part}.{frag}"
            # A small update beside the residual stream, as in a trained
            # model.
            w = (rs.randn(*shape) * 0.05).astype(np.float32)
            if quant["quant_method"] == "gptq":
                in_f = shape[1]
                g_idx = act_order_g_idx(rs, in_f, group) \
                    if quant["desc_act"] else \
                    (np.arange(in_f) // group).astype(np.int32)
                qw, qz, sc = quantize_gptq_rows(w, quant["bits"], group,
                                                g_idx)
                tensors[f"{base}.g_idx"] = g_idx
            else:
                qw, qz, sc = quantize_awq(w, group)
            tensors.update({f"{base}.qweight": qw, f"{base}.qzeros": qz,
                            f"{base}.scales": sc})
            if qwen2 and frag in ("q_proj", "k_proj", "v_proj"):
                tensors[f"{base}.bias"] = (rs.randn(shape[0]) * 0.5
                                           ).astype(np.float32)
    path.mkdir(parents=True, exist_ok=True)
    save_file(tensors, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(
        dict(config, quantization_config=quant)))
    return str(path)


def test_act_order_g_idx_fills_every_group_and_is_not_contiguous():
    g_idx = act_order_g_idx(np.random.RandomState(0), 128, 32)
    assert np.bincount(g_idx).tolist() == [32] * 4
    assert not np.array_equal(g_idx, np.arange(128) // 32)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantizer_round_trips_through_the_jax_dequantize(bits):
    """The checkpoint helper's packing is the layout the JAX package
    reads: its `dequantize` gives back w within half a step a group."""
    rs = np.random.RandomState(bits)
    w = (rs.randn(64, 128) * 0.05).astype(np.float32)
    g_idx = act_order_g_idx(rs, 128, 32)
    qw, qz, sc = quantize_gptq_rows(w, bits, 32, g_idx)
    jm = JaxGPTQLinearMethod(JaxGPTQConfig(bits, 32, True))
    deq = np.asarray(jm.dequantize(
        {"qweight": jnp.asarray(qw), "qzeros": jnp.asarray(qz),
         "scales": jnp.asarray(sc.astype(np.float32)),
         "g_idx": jnp.asarray(g_idx)}, jnp.float32))      # [in, out]
    step = sc.astype(np.float32)[g_idx]                   # [in, out]
    # A zero point of 0 is stored as -1 and read back as 2^bits (the
    # AutoGPTQ off-by-one both packages keep); elsewhere within a step.
    near = np.abs(deq - w.T) <= 0.5 * step + 1e-6
    assert near.mean() > 0.9


# ------------------------------------------------------------ pairs --

@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, tmp_path_factory):
    """(case name, JAX LLM, port LLM) on the case's checkpoint."""
    config, quant, taken = CASES[request.param]
    path = write_checkpoint(tmp_path_factory.mktemp(request.param) / "m",
                            config, quant)
    mp = pytest.MonkeyPatch()
    mp.setenv("APHRODITE_SPEC", "0")
    for name in ("APHRODITE_W4A8", "APHRODITE_DISABLE_PALLAS_QUANT",
                 "APHRODITE_FAULT"):
        mp.delenv(name, raising=False)
    jax_llm = JaxLLM(model=path, load_format="safetensors", **ENGINE_KW)
    port = LLM(model=path, load_format="safetensors", device="cpu",
               **ENGINE_KW)
    mp.undo()
    yield request.param, jax_llm, port


def _generate(llm, sp_cls, prompts=PROMPTS, **kw):
    outs = llm.generate(
        prompt_token_ids=[list(p) for p in prompts],
        sampling_params=sp_cls(**dict(dict(temperature=0.0, max_tokens=8,
                                           ignore_eos=True), **kw)))
    return [o.outputs[0] for o in outs]


def _spy(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        def fn(*a, _real=getattr(module, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(module, name, fn)
    return calls


def _methods(quant):
    if quant["quant_method"] == "gptq":
        return (TG.GPTQLinearMethod(TG.GPTQConfig.from_config(quant)),
                JaxGPTQLinearMethod(JaxGPTQConfig.from_config(quant)))
    return (TA.AWQLinearMethod(TA.AWQConfig.from_config(quant)),
            JaxAWQLinearMethod(JaxAWQConfig.from_config(quant)))


def test_apply_matches_jax_dequantize_then_matmul(pair):
    """Each layer-0 projection's `apply` on the port's loaded parameters
    against x @ the JAX `dequantize` of the JAX loader's, plus the bias:
    within 1e-5 of max |y| (f32, sums in another order)."""
    import jax
    from aphrodite_tpu_torch.modeling.convert import params_from_jax
    name, jax_llm, port = pair
    _, quant, _ = CASES[name]
    tm, jm = _methods(quant)
    jax_params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_llm.engine.executor.params))
    rs = np.random.RandomState(11)
    checked = 0
    for key, bucket in port.engine.executor.params.items():
        if not key.startswith("model.layers.0.") or "qweight" not in bucket:
            continue
        want_bucket = jax_params[key]
        for n, t in bucket.items():
            assert torch.equal(t, want_bucket[n]), (key, n)
        w = np.asarray(jm.dequantize(
            {n: jnp.asarray(t.numpy()) for n, t in want_bucket.items()
             if n != "bias"}, jnp.float32))
        x = rs.randn(3, 5, w.shape[0]).astype(np.float32)
        want = x @ w
        if "bias" in bucket:
            want = want + bucket["bias"].numpy()
        got = tm.apply(bucket, torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key
        checked += 1
    assert checked == 4


def test_model_logits_match_jax(pair):
    """A 9-token prompt, cache-less, through each engine's model on its
    loaded weights: the port's logits within 1e-5 of max |logit| of the
    JAX package's (its layers on the XLA dequantize route)."""
    from aphrodite_tpu.modeling.input_metadata import (
        InputMetadata as JaxInputMetadata)
    from aphrodite_tpu_torch.modeling.input_metadata import InputMetadata
    _, jax_llm, port = pair
    n = 9
    ids = np.array([[(i * 37 + 5) % 250 for i in range(n)]], np.int32)
    pos = np.arange(n, dtype=np.int32)[None]
    jex = jax_llm.engine.executor
    jmeta = JaxInputMetadata(
        slot_mapping=jnp.full((n,), 10 ** 6, jnp.int32),
        block_tables=jnp.full((1, 1), 10 ** 4, jnp.int32),
        context_lens=jnp.zeros((1,), jnp.int32),
        prompt_lens=jnp.full((1,), n, jnp.int32), is_prompt=True)
    hidden, _ = jex.model(jex.params, jnp.asarray(ids), jnp.asarray(pos),
                          None, jmeta)
    want = np.asarray(jex.model.compute_logits(jex.params, hidden))
    tex = port.engine.executor
    meta = InputMetadata(
        slot_mapping=torch.full((n,), 10 ** 6, dtype=torch.int32),
        block_tables=torch.full((1, 1), 10 ** 4, dtype=torch.int32),
        context_lens=torch.zeros((1,), dtype=torch.int32),
        prompt_lens=torch.full((1,), n, dtype=torch.int32), is_prompt=True)
    hidden, _ = tex.model(tex.params, torch.from_numpy(ids),
                          torch.from_numpy(pos), None, meta)
    got = tex.model.compute_logits(tex.params, hidden).numpy()
    assert got.shape == want.shape == (1, n, VOCAB)
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_greedy_generation_matches_jax(pair, monkeypatch):
    """Greedy tokens equal while the port's top-2 logprob gap exceeds
    1e-4; the kernel wrappers called only for the projections the gate
    takes, once a layer a forward pass (3 prompts, 8 tokens: a prompt
    round and 7 decode rounds)."""
    name, jax_llm, port = pair
    _, quant, taken = CASES[name]
    calls = _spy(monkeypatch, TG.qmm, GPTQ_WRAPPERS + AWQ_WRAPPERS)
    want = [o.token_ids for o in _generate(jax_llm, JaxSamplingParams)]
    got = _generate(port, SamplingParams, logprobs=2)
    passes = 8 * 2
    assert calls == {n: (passes * len(taken) if n == "awq_matmul" else 0)
                     for n in calls}, calls
    compared = 0
    for w, g in zip(want, got):
        for pos, (wt, gt) in enumerate(zip(w, g.token_ids)):
            top = sorted(g.logprobs[pos].values(), reverse=True)
            if top[0] - top[1] <= GAP_TOL:
                break                      # near tie: may flip from here
            assert wt == gt, (pos, w, g.token_ids)
            compared += 1
    assert compared >= 12, compared


def test_seeded_request_matches_jax(pair):
    _, jax_llm, port = pair
    kw = dict(temperature=0.8, top_p=0.9, seed=7, max_tokens=12)
    want = [list(o.token_ids) for o in _generate(
        jax_llm, JaxSamplingParams, PROMPTS[1:2], **kw)]
    got = [list(o.token_ids) for o in _generate(
        port, SamplingParams, PROMPTS[1:2], **kw)]
    assert got == want


# ----------------------------------------------------------- routes --

def _gptq_layer(rs, K, N, bits, group, desc_act):
    w = (rs.randn(N, K) * 0.05).astype(np.float32)
    g_idx = act_order_g_idx(rs, K, group) if desc_act else \
        (np.arange(K) // group).astype(np.int32)
    qw, qz, sc = quantize_gptq_rows(w, bits, group, g_idx)
    return {"qweight": torch.from_numpy(qw), "qzeros": torch.from_numpy(qz),
            "scales": torch.from_numpy(sc.astype(np.float32)),
            "g_idx": torch.from_numpy(g_idx)}


@pytest.mark.parametrize("w4a8", ["0", "1"])
def test_gptq_routes_by_the_gate(monkeypatch, w4a8):
    """A layer the gate takes calls its wrapper once a call (a8 under
    APHRODITE_W4A8=1); act-order, 2 bits, 8 bits at group 64 and hidden
    96 call none. Under W4A8 a refused layer runs no K9 and its output
    equals the a16 fallback exactly."""
    monkeypatch.setenv("APHRODITE_W4A8", w4a8)
    calls = _spy(monkeypatch, TG.qmm,
                 GPTQ_WRAPPERS + ("quantize_activations_int8",))
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 7, 256).astype(np.float32))
    taken = TG.GPTQLinearMethod(TG.GPTQConfig(4, 128))
    taken.apply(_gptq_layer(rs, 256, 256, 4, 128, False), x)
    want = "gptq_matmul_a8" if w4a8 == "1" else "gptq_matmul"
    assert calls == {n: int(n == want) for n in calls}, calls
    for bits, group, desc_act, K, N in ((4, 32, True, 256, 256),
                                        (4, 128, True, 256, 256),
                                        (2, 128, False, 256, 256),
                                        (8, 64, False, 256, 256),
                                        (4, 128, False, 96, 160)):
        for n in calls:
            calls[n] = 0
        method = TG.GPTQLinearMethod(TG.GPTQConfig(bits, group, desc_act))
        params = _gptq_layer(rs, K, N, bits, group, desc_act)
        y = method.apply(params, x[..., :K])
        assert calls == dict.fromkeys(calls, 0), (bits, group, desc_act)
        assert y.shape == (2, 7, N)
        monkeypatch.setenv("APHRODITE_W4A8", "0")
        assert torch.equal(y, method.apply(params, x[..., :K]))
        monkeypatch.setenv("APHRODITE_W4A8", w4a8)


def test_act_order_never_reaches_the_kernels_and_gathers_by_g_idx():
    """An act-order layer's `apply` is x @ W with W's rows grouped by
    g_idx; the kernels' plain version (groups k // group_size) on the same
    codes gives another product, which is why the gate must refuse
    desc_act before any wrapper is reached."""
    rs = np.random.RandomState(8)
    params = _gptq_layer(rs, 256, 128, 4, 32, True)
    x = torch.from_numpy(rs.randn(6, 256).astype(np.float32))
    method = TG.GPTQLinearMethod(TG.GPTQConfig(4, 32, True))
    y = method.apply(params, x)
    jm = JaxGPTQLinearMethod(JaxGPTQConfig(4, 32, True))
    w = np.asarray(jm.dequantize({n: jnp.asarray(t.numpy())
                                  for n, t in params.items()}, jnp.float32))
    want = x.numpy() @ w
    assert np.abs(y.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    contiguous = qmm.gptq_matmul_plain(x, params["qweight"],
                                       params["qzeros"], params["scales"],
                                       bits=4, group_size=32)
    assert (y - contiguous).abs().max() > 0.1 * y.abs().max()


@pytest.mark.parametrize("w4a8", ["0", "1"])
def test_awq_routes_by_the_gate(monkeypatch, w4a8):
    """out % 1024 == 0 takes the wrapper; out 128 and groups of 64 call
    none and, under W4A8, run no K9 and equal the a16 fallback."""
    monkeypatch.setenv("APHRODITE_W4A8", w4a8)
    calls = _spy(monkeypatch, TA.qmm,
                 AWQ_WRAPPERS + ("quantize_activations_int8",))
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(9, 128).astype(np.float32))

    def layer(N, group):
        qw, qz, sc = quantize_awq((rs.randn(N, 128) * 0.05).astype(
            np.float32), group)
        return {"qweight": torch.from_numpy(qw),
                "qzeros": torch.from_numpy(qz),
                "scales": torch.from_numpy(sc.astype(np.float32))}
    TA.AWQLinearMethod(TA.AWQConfig(4, 128)).apply(layer(1024, 128), x)
    want = "awq_matmul_a8" if w4a8 == "1" else "awq_matmul"
    assert calls == {n: int(n == want) for n in calls}, calls
    for N, group in ((128, 128), (1024, 64)):
        for n in calls:
            calls[n] = 0
        method = TA.AWQLinearMethod(TA.AWQConfig(4, group))
        params = layer(N, group)
        y = method.apply(params, x)
        assert calls == dict.fromkeys(calls, 0)
        monkeypatch.setenv("APHRODITE_W4A8", "0")
        assert torch.equal(y, method.apply(params, x))
        monkeypatch.setenv("APHRODITE_W4A8", w4a8)


def test_float32_off_the_cpu_takes_the_fallback(monkeypatch):
    """On the card (meta tensors stand in for it) the GPTQ and AWQ
    kernels take bfloat16 activations only: float32 activations at shapes
    the gates take call no wrapper and come back [.., out] in float32;
    bfloat16 ones call the wrapper."""
    calls = _spy(monkeypatch, TG.qmm, GPTQ_WRAPPERS + AWQ_WRAPPERS)
    meta = torch.device("meta")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=meta)
    for dtype, want in ((torch.float32, 0), (torch.bfloat16, 1)):
        gp = {"qweight": empty((32, 256), torch.int32),
              "qzeros": empty((2, 32), torch.int32),
              "scales": empty((2, 256), dtype),
              "g_idx": empty((256,), torch.int32)}
        y = TG.GPTQLinearMethod(TG.GPTQConfig(4, 128)).apply(
            gp, empty((3, 256), dtype))
        assert (y.shape, y.dtype) == ((3, 256), dtype)
        ap = {"qweight": empty((256, 128), torch.int32),
              "qzeros": empty((2, 128), torch.int32),
              "scales": empty((2, 1024), dtype)}
        y = TA.AWQLinearMethod(TA.AWQConfig(4, 128)).apply(
            ap, empty((3, 256), dtype))
        assert (y.shape, y.dtype) == ((3, 1024), dtype)
        assert (calls["gptq_matmul"], calls["awq_matmul"]) == (want, want)


def test_no_module_turns_tf32_on():
    """float32 products on the card must run in full f32: nothing in the
    port sets `allow_tf32` true or lowers the float32 matmul
    precision."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "aphrodite_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            text = open(os.path.join(dirpath, f)).read().replace(" ", "")
            if "allow_tf32=True" in text or \
                    "set_float32_matmul_precision(" in text:
                offenders.append(os.path.join(dirpath, f))
    assert offenders == []
    assert not torch.backends.cuda.matmul.allow_tf32
