"""The port's GGUF path (reader, writer, tokenizer, config, at-rest
loading, the `gguf` linear method, config, engine) against the JAX
package, on the CPU.

Every `.gguf` file is written under `tmp_path` with the port's
`write_gguf` from numpy weights made from a seed (Q4_K and Q6_K blocks,
which the writer cannot quantize, are drawn at random as the JAX tests
draw them and written as raw blocks). Flags are set with monkeypatch.

- Writer and reader: the port writes the bytes the JAX package writes;
  the raw-row q/k permutation equals JAX's.
- Repacking: `q8_0_to_kernel`, `q6k_to_kernel`, `q4k_to_kernel`,
  `dense_to_w8` and `dense_to_i8g` are bit-equal to the JAX package's.
- Loading: the port's parameters equal the JAX loader's tensor by
  tensor (integers and scales bit-equal, dense weights transposed by
  `params_from_jax`) for a uniform Q8_0 file (qs/d), uniform Q4_0 under
  turbo (qs8/s128), a mixed Q4_0/Q8_0 qkv (qs/d16), uniform Q4_0 with
  APHRODITE_GGUF_EXACT=1 (qs/d16) and a Q6_K file (exact qs/d16); a
  Q4_K file under turbo loads as qs8/s128 in both packages.
- Engine (float32, 2 layers, hidden 256, intermediate 512, 4 query and
  2 KV heads of 64, so every kernel's gate passes and the plain versions
  run): uniform Q8_0 (K13), a mixed qkv beside Q8_0 (K14 and K13) and
  the same Q4_0 file loaded dense (quantization=None) are greedy
  token-equal to the JAX engine (compared while the port's top-2
  logprob gap exceeds 1e-4). Uniform Q4_0 under turbo (K15): the JAX CPU
  engine dequantizes and keeps float activations, the port quantizes
  them to int8 per row, so logprobs are held within 0.05 (the top-5 of
  each step, where the tokens agree) and tokens compared only while the
  port's top-2 gap exceeds 0.1.
- Layer: `GGUFLinearMethod.apply` on the turbo form equals the JAX
  `gguf_w8a8_matmul` (interpret mode) on the same int8 rows within
  1e-5 of max |y|.
- Tokenizer and config from metadata: the same encodings and decodings,
  the same config values as the JAX package's LlamaConfig.
- Exact Q4_K (K12): APHRODITE_GGUF_EXACT=1 on a Q4_K file, and a dummy
  load in that form, are served (bf16 on the card); the file's greedy
  tokens equal the JAX engine's.
- Served where they were once refused: float32 GGUF on the card, and
  on the card a file or dummy load whose buckets a kernel's gate refuses
  (those buckets, and every bucket on a float32 card, take the
  dequantize route in `apply`, which off the CPU runs on meta tensors
  here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.endpoints.llm import LLM as JaxLLM
from aphrodite_tpu.modeling import gguf as JG
from aphrodite_tpu.modeling.layers.quantization import gguf as JQ
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.endpoints.llm import LLM
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.modeling import gguf as TG
from aphrodite_tpu_torch.modeling.convert import params_from_jax
from aphrodite_tpu_torch.modeling.layers.quantization import gguf as TQ
from aphrodite_tpu_torch.ops.cuda import quant_matmul as tqm

HIDDEN, INTER, HEADS, KV_HEADS, VOCAB = 256, 512, 4, 2, 256
HEAD = HIDDEN // HEADS
GAP_TOL = 1e-4
PROJ = {"attn_q": (HIDDEN, HIDDEN), "attn_k": (KV_HEADS * HEAD, HIDDEN),
        "attn_v": (KV_HEADS * HEAD, HIDDEN),
        "attn_output": (HIDDEN, HIDDEN), "ffn_gate": (INTER, HIDDEN),
        "ffn_up": (INTER, HIDDEN), "ffn_down": (HIDDEN, INTER)}
ENGINE_KW = dict(max_model_len=128, max_num_seqs=4, swap_space=0.01,
                 skip_tokenizer_init=True, disable_log_stats=True,
                 block_size=16)
PROMPTS = [[(i * 7 + 3) % 250 + 5 for i in range(n)] for n in (5, 23, 40)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """No fault injection, speculative decoding or GGUF knob left over
    from an earlier test in this process."""
    from aphrodite_tpu.common import faultinject as jax_faults
    from aphrodite_tpu_torch.common import faultinject
    for name in ("APHRODITE_FAULT", "APHRODITE_FAULT_SEED",
                 "APHRODITE_GGUF_EXACT", "BENCH_GGUF_FMT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    jax_faults.reset()
    faultinject.reset()


# ------------------------------------------------------------ blocks --

def random_q4k_blocks(rs, out_f, in_f):
    """Valid random Q4_K superblocks, as
    tests/quantization/test_gguf_at_rest.py draws them."""
    n = out_f * in_f // 256
    blocks = np.zeros((n, 144), dtype=np.uint8)
    d = (rs.rand(n).astype(np.float16) * 0.01 + 1e-3)
    dmin = (rs.rand(n).astype(np.float16) * 0.01 + 1e-3)
    blocks[:, 0:2] = d.view(np.uint8).reshape(n, 2)
    blocks[:, 2:4] = dmin.view(np.uint8).reshape(n, 2)
    blocks[:, 4:16] = rs.randint(0, 256, (n, 12), dtype=np.uint8)
    blocks[:, 16:144] = rs.randint(0, 256, (n, 128), dtype=np.uint8)
    return blocks


def random_q6k_blocks(rs, out_f, in_f):
    """Valid random Q6_K superblocks, as the JAX tests draw them."""
    n = out_f * in_f // 256
    blocks = np.zeros((n, 210), np.uint8)
    blocks[:, :192] = rs.randint(0, 256, (n, 192), dtype=np.uint8)
    blocks[:, 192:208] = rs.randint(-16, 16, (n, 16),
                                    dtype=np.int8).view(np.uint8)
    d = (rs.rand(n).astype(np.float16) * 0.01 + 1e-3)
    blocks[:, 208:210] = d.view(np.uint8).reshape(n, 2)
    return blocks


def _meta(layers=2):
    return {
        "general.architecture": "llama", "general.alignment": 32,
        "llama.context_length": 256, "llama.embedding_length": HIDDEN,
        "llama.feed_forward_length": INTER, "llama.block_count": layers,
        "llama.attention.head_count": HEADS,
        "llama.attention.head_count_kv": KV_HEADS,
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        "llama.rope.freq_base": 10000.0, "llama.vocab_size": VOCAB,
    }


def write_model(path, types, seed=3, layers=2):
    """A Llama `.gguf` at the test width: F32 norms, embedding and
    output; each projection of `types` (gguf fragment -> type; Q4_K and
    Q6_K as random raw blocks)."""
    rs = np.random.RandomState(seed)
    t = {"token_embd.weight": (rs.randn(VOCAB, HIDDEN).astype(np.float32),
                               "F32"),
         "output.weight": ((rs.randn(VOCAB, HIDDEN) * 0.05).astype(
             np.float32), "F32"),
         "output_norm.weight": (np.ones(HIDDEN, np.float32), "F32")}
    for i in range(layers):
        p = f"blk.{i}"
        t[f"{p}.attn_norm.weight"] = (np.ones(HIDDEN, np.float32), "F32")
        t[f"{p}.ffn_norm.weight"] = (np.ones(HIDDEN, np.float32), "F32")
        for frag, (out_f, in_f) in PROJ.items():
            tname = types[frag]
            if tname in ("Q4_K", "Q6_K"):
                make = random_q4k_blocks if tname == "Q4_K" \
                    else random_q6k_blocks
                t[f"{p}.{frag}.weight"] = TG.RawGGUF(
                    tname, make(rs, out_f, in_f), (out_f, in_f))
            else:
                t[f"{p}.{frag}.weight"] = (
                    (rs.randn(out_f, in_f) * 0.05).astype(np.float32), tname)
    TG.write_gguf(str(path), _meta(layers), t)
    return str(path)


UNIFORM_Q8 = dict.fromkeys(PROJ, "Q8_0")
UNIFORM_Q4 = dict.fromkeys(PROJ, "Q4_0")
# q/k at Q4_0 beside v at Q8_0 (llama.cpp's Q4_K_M pattern): a mixed
# group on grouped int8 (K14); the rest Q8_0 (K13).
MIXED_QKV = dict(UNIFORM_Q8, attn_q="Q4_0", attn_k="Q4_0")


# ------------------------------------------------- writer and reader --

def test_writer_writes_the_jax_packages_bytes(tmp_path):
    rs = np.random.RandomState(0)
    tensors = {
        "token_embd.weight": (rs.randn(64, 256).astype(np.float32), "F16"),
        "output_norm.weight": (np.ones(256, np.float32), "F32"),
        "blk.0.attn_q.weight": (rs.randn(256, 256).astype(np.float32),
                                "Q4_0"),
        "blk.0.attn_k.weight": (rs.randn(128, 256).astype(np.float32),
                                "Q8_0"),
    }
    meta = dict(_meta(1), **{"tokenizer.ggml.tokens": ["a", "b"],
                             "tokenizer.ggml.scores": [0.0, -1.0]})
    TG.write_gguf(str(tmp_path / "port.gguf"), meta, tensors)
    JG.write_gguf(str(tmp_path / "jax.gguf"), meta, tensors)
    assert (tmp_path / "port.gguf").read_bytes() == \
        (tmp_path / "jax.gguf").read_bytes()
    reader = TG.GGUFReader(str(tmp_path / "port.gguf"))
    assert reader.fields == JG.GGUFReader(str(tmp_path / "jax.gguf")).fields
    for info in reader.tensors:
        np.testing.assert_array_equal(
            reader.load(info),
            JG.GGUFReader(str(tmp_path / "jax.gguf")).load(info))


def test_raw_blocks_round_trip_through_the_writer(tmp_path):
    rs = np.random.RandomState(1)
    blocks = random_q6k_blocks(rs, 8, 512)
    TG.write_gguf(str(tmp_path / "q6.gguf"), _meta(1), {
        "blk.0.ffn_down.weight": TG.RawGGUF("Q6_K", blocks, (8, 512))})
    reader = JG.GGUFReader(str(tmp_path / "q6.gguf"))
    (info,) = reader.tensors
    assert info.shape == (8, 512) and JG.GGML_TYPES[info.ggml_type][0] == \
        "Q6_K"
    np.testing.assert_array_equal(
        reader.load(info), JG._deq_q6_k(blocks).reshape(8, 512))


@pytest.mark.parametrize("block,bpb,n_heads", [(32, 34, 4), (256, 210, 2)])
def test_raw_row_permutation_matches_jax(block, bpb, n_heads):
    rs = np.random.RandomState(block)
    out_f, in_f = 128, 512
    blocks = rs.randint(0, 256, (out_f * in_f // block, bpb),
                        dtype=np.uint8)
    np.testing.assert_array_equal(
        TG._permute_raw_rows(blocks, out_f, in_f, block, n_heads),
        JG._permute_raw_rows(blocks, out_f, in_f, block, n_heads))


# --------------------------------------------------------- repacking --

@pytest.mark.parametrize("kind", ["q8_0", "q6k", "q4k", "w8", "i8g"])
def test_repack_is_bit_equal_to_jax(kind):
    rs = np.random.RandomState(7)
    out_f, in_f = 96, 512
    if kind == "q8_0":
        blocks = rs.randint(0, 256, (out_f * in_f // 32, 34),
                            dtype=np.uint8)
        want = JQ.q8_0_to_kernel(blocks, out_f, in_f)
        got = TQ.q8_0_to_kernel(blocks, out_f, in_f)
    elif kind == "q6k":
        blocks = random_q6k_blocks(rs, out_f, in_f)
        want = JQ.q6k_to_kernel(blocks, out_f, in_f)
        got = TQ.q6k_to_kernel(blocks, out_f, in_f)
    elif kind == "q4k":
        blocks = random_q4k_blocks(rs, out_f, in_f)
        want = JQ.q4k_to_kernel(blocks, out_f, in_f)
        got = TQ.q4k_to_kernel(blocks, out_f, in_f)
    else:
        w = (rs.randn(out_f, in_f) * 0.05).astype(np.float32)
        w[:, :128] = 0.0                   # an all-zero group: scale 1
        fn = "dense_to_w8" if kind == "w8" else "dense_to_i8g"
        want, got = getattr(JQ, fn)(w), getattr(TQ, fn)(w)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        np.testing.assert_array_equal(g, w_)


def test_dequantize_matches_jax_for_every_form():
    rs = np.random.RandomState(8)
    K, N = 512, 128
    forms = {
        "q8_0": {"qs": rs.randint(-128, 128, (K, N)).astype(np.int8),
                 "d": rs.rand(K // 32, N).astype(np.float32)},
        "i8g": {"qs": rs.randint(-128, 128, (K, N)).astype(np.int8),
                "d16": rs.rand(K // 16, N).astype(np.float32)},
        "w8": {"qs8": rs.randint(-127, 128, (K, N)).astype(np.int8),
               "s128": rs.rand(K // 128, N).astype(np.float32)},
        "q4k": dict(zip(("qweight", "dl", "ml"), JQ.q4k_to_kernel(
            random_q4k_blocks(rs, N, K), N, K))),
    }
    jm = JQ.GGUFLinearMethod(JQ.GGUFConfig())
    tm = TQ.GGUFLinearMethod(TQ.GGUFConfig())
    for form, params in forms.items():
        want = np.asarray(jm.dequantize(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.float32))
        got = tm.dequantize({k: torch.from_numpy(v)
                             for k, v in params.items()}, torch.float32)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=form)


# ------------------------------------------------------------ loading --

def _load_both(path, at_rest=True):
    """The JAX and the port's Llama load `path`: (JAX params converted
    with params_from_jax, the port's params)."""
    from aphrodite_tpu.modeling.models.llama import (
        LlamaForCausalLM as JaxLlama)
    from aphrodite_tpu_torch.modeling.loader import _weights_iterator
    from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM
    jm = JaxLlama(JG.extract_gguf_config(path), dtype=jnp.float32,
                  linear_method=JQ.GGUFConfig().get_linear_method()
                  if at_rest else None)
    want = params_from_jax(jm.load_weights(
        JG.gguf_weights_iterator(path, at_rest=at_rest)))
    tm = LlamaForCausalLM(TG.extract_gguf_config(path),
                          dtype=torch.float32,
                          linear_method=TQ.GGUFConfig().get_linear_method()
                          if at_rest else None)
    got = tm.load_weights(_weights_iterator(path, "auto",
                                            gguf_at_rest=at_rest))
    return want, got


def _assert_params_equal(want, got):
    assert set(got) == set(want)
    for key, bucket in want.items():
        assert set(got[key]) == set(bucket), key
        for name, tensor in bucket.items():
            g = got[key][name]
            assert g.dtype == tensor.dtype, (key, name, g.dtype)
            assert torch.equal(g, tensor), (key, name)


def _forms(params):
    return {key.rsplit(".", 1)[-1]: tuple(sorted(bucket))
            for key, bucket in params.items() if "layers.0." in key and
            key.endswith("_proj")}


@pytest.mark.parametrize("types,exact,forms", [
    (UNIFORM_Q8, False, dict.fromkeys(
        ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"), ("d", "qs"))),
    (UNIFORM_Q4, False, dict.fromkeys(
        ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"),
        ("qs8", "s128"))),
    (MIXED_QKV, False, dict(
        qkv_proj=("d16", "qs"), o_proj=("d", "qs"),
        gate_up_proj=("d", "qs"), down_proj=("d", "qs"))),
    (UNIFORM_Q4, True, dict.fromkeys(
        ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"),
        ("d16", "qs"))),
    (dict.fromkeys(PROJ, "Q6_K"), False, dict.fromkeys(
        ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"),
        ("d16", "qs"))),
    (dict.fromkeys(PROJ, "Q4_K"), False, dict.fromkeys(
        ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"),
        ("qs8", "s128"))),
], ids=["q8_0", "q4_0-turbo", "mixed-qkv", "q4_0-exact", "q6_k",
        "q4_k-turbo"])
def test_at_rest_params_equal_the_jax_loaders(tmp_path, monkeypatch, types,
                                              exact, forms):
    if exact:
        monkeypatch.setenv("APHRODITE_GGUF_EXACT", "1")
    path = write_model(tmp_path / "m.gguf", types)
    want, got = _load_both(path)
    _assert_params_equal(want, got)
    assert _forms(got) == forms
    planned = {name for name, form in TQ.checkpoint_forms(path).items()
               if form == "dense"}
    assert not planned


def test_dense_load_equals_the_jax_loaders(tmp_path):
    """quantization=None: every tensor dequantizes at load; the q/k rows
    are un-permuted as in the JAX package."""
    path = write_model(tmp_path / "m.gguf", MIXED_QKV)
    want, got = _load_both(path, at_rest=False)
    _assert_params_equal(want, got)
    qkv = got["model.layers.0.self_attn.qkv_proj"]
    assert set(qkv) == {"weight"} and qkv["weight"].shape == (512, HIDDEN)


def test_sidecar_is_consumed_by_every_loader():
    """pending_rename / pending_sidecar: a whole-tensor load stores the
    sidecar beside the tensor, a shard load places it in the shard's
    slice, and nothing is left pending for the next layer."""
    from aphrodite_tpu_torch.modeling.layers.linear import (
        MergedColumnParallelLinear, QKVParallelLinear, RowParallelLinear)
    rs = np.random.RandomState(9)
    method = TQ.GGUFConfig().get_linear_method()

    def raw(out_f, in_f):
        return TG.RawGGUF("Q6_K", random_q6k_blocks(rs, out_f, in_f),
                          (out_f, in_f))
    row = RowParallelLinear(512, 256, dtype=torch.float32,
                            linear_method=method)
    params = {}
    row.weight_loader(params, "weight", raw(256, 512))
    assert set(params) == {"qs", "d16"} and params["d16"].shape == (32, 256)
    qkv = QKVParallelLinear(256, 64, 4, 2, dtype=torch.float32,
                            linear_method=method)
    params = {}
    parts = {s: raw(n, 256) for s, n in (("q", 256), ("k", 128),
                                         ("v", 128))}
    for shard, tensor in parts.items():
        qkv.weight_loader(params, "weight", tensor, shard)
    assert set(params) == {"qs", "d16"}
    for shard, (off, size) in qkv.shard_offsets().items():
        qs, d16 = TQ.q6k_to_kernel(parts[shard].blocks, size, 256)
        np.testing.assert_array_equal(params["qs"][:, off:off + size], qs)
        np.testing.assert_array_equal(params["d16"][:, off:off + size], d16)
    gate_up = MergedColumnParallelLinear(256, [512, 512],
                                         dtype=torch.float32,
                                         linear_method=method)
    params = {}
    gate_up.weight_loader(params, "weight", raw(1024, 256))   # whole
    assert set(params) == {"qs", "d16"} and params["qs"].shape == (256, 1024)
    assert method.pending_rename is None and method.pending_sidecar is None


def test_params_from_jax_keeps_at_rest_forms_and_transposes_dense():
    arrays = {"model.layers.0.self_attn.qkv_proj": {
        "qs": np.arange(12, dtype=np.int8).reshape(3, 4),
        "d16": np.ones((1, 4), np.float32)},
        "model.layers.0.mlp.down_proj": {
            "weight": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    got = params_from_jax(arrays)
    qkv = got["model.layers.0.self_attn.qkv_proj"]
    assert qkv["qs"].shape == (3, 4) and qkv["qs"].dtype == torch.int8
    np.testing.assert_array_equal(qkv["qs"].numpy(), arrays[
        "model.layers.0.self_attn.qkv_proj"]["qs"])
    np.testing.assert_array_equal(
        got["model.layers.0.mlp.down_proj"]["weight"].numpy(),
        arrays["model.layers.0.mlp.down_proj"]["weight"].T)


# -------------------------------------------------------------- layer --

@pytest.mark.parametrize("lead", [(3,), (2, 70)])
def test_turbo_apply_matches_jax_pallas(lead, monkeypatch):
    """The turbo form through `GGUFLinearMethod.apply` against the JAX
    `gguf_w8a8_matmul` run with interpret=True, the JAX side given the
    reference chain's int8 rows in place of its quantize kernel
    (interpret mode divides by reciprocal multiplies; see
    tests/test_torch_quant_matmul.py). f32: within 1e-5 of max |y|."""
    from aphrodite_tpu.ops.pallas import quant_matmul as jqm
    rs = np.random.RandomState(sum(lead))
    K, N = 512, 256
    qs8, s128 = JQ.dense_to_w8((rs.randn(N, K) * 0.05).astype(np.float32))
    x = rs.randn(*lead, K).astype(np.float32)
    x8, xs = jqm._quantize_activations_int8(jnp.asarray(x.reshape(-1, K)))
    monkeypatch.setattr(jqm, "quantize_activations_int8",
                        lambda x, interpret=False: (x8, xs))
    jqm.gguf_w8a8_matmul.clear_cache()
    want = np.asarray(jqm.gguf_w8a8_matmul(
        jnp.asarray(x.reshape(-1, K)), jnp.asarray(qs8), jnp.asarray(s128),
        interpret=True)).reshape(*lead, N)
    jqm.gguf_w8a8_matmul.clear_cache()
    got = TQ.GGUFLinearMethod(TQ.GGUFConfig()).apply(
        {"qs8": torch.from_numpy(qs8), "s128": torch.from_numpy(s128)},
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*lead, N)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_apply_falls_back_only_where_a_gate_refuses(monkeypatch):
    """Shapes the kernels take go through their wrappers (Q8_0's K13 and
    the exact Q4_K form's K12); a shape a gate refuses (K % 256 != 0)
    dequantizes and multiplies, as the JAX package's `apply` does."""
    rs = np.random.RandomState(10)
    calls = {"gguf_q8_matmul": 0, "gguf_q4k_matmul": 0}
    for name in calls:
        def spy(*a, _real=getattr(tqm, name), _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(TQ.qmm, name, spy)
    method = TQ.GGUFLinearMethod(TQ.GGUFConfig())
    jm = JQ.GGUFLinearMethod(JQ.GGUFConfig())
    for K in (256, 128):
        q4k = dict(zip(("qweight", "dl", "ml"), JQ.q4k_to_kernel(
            random_q4k_blocks(rs, 128, 256), 128, 256)))
        if K == 128:                 # an unaligned at-rest Q4_K bucket
            q4k = {"qweight": q4k["qweight"][:16], "dl": q4k["dl"][:4],
                   "ml": q4k["ml"][:4]}
        for params in ({"qs": rs.randint(-128, 128, (K, 128)).astype(
                            np.int8),
                        "d": rs.rand(K // 32, 128).astype(np.float32)},
                       q4k):
            x = rs.randn(5, K).astype(np.float32)
            got = method.apply({k: torch.from_numpy(v) for k, v in
                                params.items()},
                               torch.from_numpy(x)).numpy()
            want = np.asarray(jm.apply({k: jnp.asarray(v) for k, v in
                                        params.items()}, jnp.asarray(x)))
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert calls == {"gguf_q8_matmul": 1, "gguf_q4k_matmul": 1}


def test_apply_refuses_a_gated_shape_off_the_cpu(monkeypatch):
    """Off the CPU the dequantize route of a shape a gate refuses was
    refused, naming the later slice, until the port served it; the test
    keeps its id and holds what replaced the refusal: off the CPU (meta
    tensors stand in for the card) `apply` dequantizes and multiplies,
    and returns [.., out] in x's dtype, without calling a kernel
    wrapper; so does a shape the gates take with float32 activations
    (the kernels take bfloat16 only), and in bfloat16 that shape goes
    to its wrapper."""
    calls = []
    for name in ("gguf_q8_matmul", "gguf_i8g_matmul", "gguf_w8a8_matmul"):
        def spy(*a, _real=getattr(tqm, name), _name=name):
            calls.append(_name)
            return _real(*a)
        monkeypatch.setattr(TQ.qmm, name, spy)
    method = TQ.GGUFLinearMethod(TQ.GGUFConfig())
    meta = torch.device("meta")
    for params, K, N, dtype in (
            ({"qs": (128, 128), "d": (4, 128)}, 128, 128, torch.bfloat16),
            ({"qs": (128, 128), "d16": (8, 128)}, 128, 128, torch.bfloat16),
            ({"qs8": (128, 96), "s128": (1, 96)}, 128, 96, torch.bfloat16),
            ({"qs": (256, 128), "d": (8, 128)}, 256, 128, torch.float32),
            ({"qs8": (256, 128), "s128": (2, 128)}, 256, 128,
             torch.float32)):
        tensors = {k: torch.empty(shape, device=meta,
                                  dtype=torch.int8 if k.startswith("qs")
                                  else dtype)
                   for k, shape in params.items()}
        y = method.apply(tensors, torch.empty(2, 3, K, dtype=dtype,
                                              device=meta))
        assert (y.shape, y.dtype, y.device) == ((2, 3, N), dtype, meta)
    assert calls == []
    tensors = {"qs": torch.empty(256, 128, dtype=torch.int8, device=meta),
               "d": torch.empty(8, 128, dtype=torch.bfloat16, device=meta)}
    y = method.apply(tensors, torch.empty(3, 256, dtype=torch.bfloat16,
                                          device=meta))
    assert y.shape == (3, 128) and calls == ["gguf_q8_matmul"]


# ------------------------------------------------- tokenizer, config --

def _tokenizer_meta():
    """A small sentencepiece-style BPE vocabulary: specials, byte
    fallback, letters and a few merges, scored so that merges win."""
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    words = ["▁", "h", "e", "l", "o", "w", "r", "d", "t", "a", "n",
             "▁h", "he", "ll", "lo", "wo", "or", "rl", "ld", "▁w",
             "▁t", "th", "▁the", "▁he", "▁hel",
             "▁hello", "▁wor", "▁world", "an", "▁an"]
    pieces += words
    types += [1] * len(words)
    scores = [0.0] * 259 + [-float(i) for i in range(len(words))]
    return {"tokenizer.ggml.tokens": pieces,
            "tokenizer.ggml.scores": scores,
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.unknown_token_id": 0}


def test_gguf_tokenizer_encodes_and_decodes_like_jax(tmp_path):
    pytest.importorskip("transformers")
    from aphrodite_tpu.transformers_utils.tokenizer import (
        convert_gguf_to_tokenizer as jax_convert)
    from aphrodite_tpu_torch.transformers_utils.tokenizer import (
        convert_gguf_to_tokenizer, get_tokenizer)
    path = str(tmp_path / "tok.gguf")
    TG.write_gguf(path, dict(_meta(1), **_tokenizer_meta()), {
        "output_norm.weight": (np.ones(HIDDEN, np.float32), "F32")})
    want = jax_convert(path)
    got = convert_gguf_to_tokenizer(path)
    assert type(get_tokenizer(path)) is type(got)
    assert (got.bos_token, got.eos_token, got.unk_token) == \
        (want.bos_token, want.eos_token, want.unk_token) == \
        ("<s>", "</s>", "<unk>")
    assert got.vocab_size == want.vocab_size == 289
    for text in ("hello world", "the world and the hello",
                 "an ünïcode wörld ✓", " leading  spaces"):
        ids = got.encode(text)
        assert ids == want.encode(text), text
        assert got.decode(ids) == want.decode(ids)
        assert got.convert_ids_to_tokens(ids) == \
            want.convert_ids_to_tokens(ids)


def test_config_from_metadata_equals_jax(tmp_path):
    path = write_model(tmp_path / "m.gguf", UNIFORM_Q8, layers=1)
    want = JG.extract_gguf_config(path)
    got = TG.extract_gguf_config(path)
    from aphrodite_tpu_torch.transformers_utils.config import get_config
    assert get_config(path).to_dict() == got.to_dict()
    keys = ("architectures", "model_type", "vocab_size", "hidden_size",
            "intermediate_size", "max_position_embeddings",
            "num_attention_heads", "num_hidden_layers",
            "num_key_value_heads", "rms_norm_eps", "bos_token_id",
            "eos_token_id", "tie_word_embeddings", "rope_theta",
            "rope_scaling", "hidden_act", "attention_bias")
    for key in keys:
        assert getattr(got, key) == getattr(want, key), key
    assert got.torch_dtype == "float16"
    assert got.sliding_window is None


# ----------------------------------------------------------- refusals --

def _engine_configs(model, device="cpu", dtype="float32", **kw):
    return EngineArgs(model=model, quantization="gguf", dtype=dtype,
                      device=device, **kw).create_engine_configs()


def test_exact_q4k_is_refused_naming_k12(tmp_path, monkeypatch):
    """K12 serves the exact Q4_K form: APHRODITE_GGUF_EXACT=1 on a Q4_K
    file is accepted on the CPU and, in bfloat16, on the card (every
    bucket passes K12's gate at hidden 256); the header routes each
    projection to the qweight/dl/ml form."""
    path = write_model(tmp_path / "q4k.gguf", dict.fromkeys(PROJ, "Q4_K"),
                       layers=1)
    assert _engine_configs(path)[0].quantization == "gguf"   # turbo
    assert set(TQ.checkpoint_forms(path).values()) == {"w8"}
    monkeypatch.setenv("APHRODITE_GGUF_EXACT", "1")
    assert _engine_configs(path)[0].quantization == "gguf"
    assert _engine_configs(path, device="cuda", dtype="bfloat16"
                           )[0].quantization == "gguf"
    assert set(TQ.checkpoint_forms(path).values()) == {"q4k"}
    # Exact Q8_0 and Q6_K files stay served with the flag set.
    q6 = write_model(tmp_path / "q6k.gguf", dict.fromkeys(PROJ, "Q6_K"),
                     layers=1)
    assert _engine_configs(q6)[0].quantization == "gguf"


def test_dummy_load_in_the_exact_q4k_form_is_refused(tmp_path, monkeypatch):
    import json
    (tmp_path / "config.json").write_text(json.dumps(dict(
        architectures=["LlamaForCausalLM"], model_type="llama",
        vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=INTER,
        num_hidden_layers=1, num_attention_heads=HEADS,
        num_key_value_heads=KV_HEADS, max_position_embeddings=128)))
    model = str(tmp_path)
    assert _engine_configs(model, load_format="dummy")[0].quantization == \
        "gguf"
    monkeypatch.setenv("APHRODITE_GGUF_EXACT", "1")
    # Served now (K12): dummy weights in the exact Q4_K form, random codes.
    from aphrodite_tpu_torch.modeling.loader import get_model
    model_config = _engine_configs(model, load_format="dummy")[0]
    assert _engine_configs(model, load_format="dummy", device="cuda",
                           dtype="bfloat16")[0].quantization == "gguf"
    _, params = get_model(model_config, torch.device("cpu"))
    qkv = params["model.layers.0.self_attn.qkv_proj"]
    assert {k: tuple(v.shape) for k, v in qkv.items()} == {
        "qweight": (HIDDEN // 8, 512), "dl": (HIDDEN // 32, 512),
        "ml": (HIDDEN // 32, 512)}
    assert len(torch.unique(qkv["qweight"])) > 1000
    for fmt in ("q8_0", "q6_k"):
        monkeypatch.setenv("BENCH_GGUF_FMT", fmt)
        _engine_configs(model, load_format="dummy")


@pytest.mark.parametrize("device", ["cuda", "auto"])
def test_gguf_in_float32_on_the_card_is_refused(tmp_path, device):
    """float32 GGUF was refused on the card until the fallback route
    served it; the test keeps its id and holds what replaced the
    refusal: the configs build on the card in float32 (every bucket then
    takes the dequantize route) and bfloat16, and on the CPU."""
    path = write_model(tmp_path / "m.gguf", UNIFORM_Q8, layers=1)
    assert _engine_configs(path, device=device)[0].dtype == "float32"
    assert _engine_configs(path, device=device,
                           dtype="bfloat16")[0].dtype == "bfloat16"
    assert _engine_configs(path)[0].dtype == "float32"


def _write_wide_q8(path):
    """One layer at hidden 384 (6 query and 2 KV heads of 64), every
    projection Q8_0: qkv (384, 640), o (384, 384) and gate_up (384, 1024)
    fail K13's in % 256 gate; down (512, 384) passes it."""
    hidden, heads = 384, 6
    meta = dict(_meta(1), **{"llama.embedding_length": hidden,
                             "llama.attention.head_count": heads})
    rs = np.random.RandomState(4)
    shapes = {"attn_q": (hidden, hidden), "attn_k": (2 * HEAD, hidden),
              "attn_v": (2 * HEAD, hidden), "attn_output": (hidden, hidden),
              "ffn_gate": (INTER, hidden), "ffn_up": (INTER, hidden),
              "ffn_down": (hidden, INTER)}
    t = {"token_embd.weight": (rs.randn(VOCAB, hidden).astype(np.float32),
                               "F32"),
         "output.weight": (rs.randn(VOCAB, hidden).astype(np.float32),
                           "F32"),
         "output_norm.weight": (np.ones(hidden, np.float32), "F32"),
         "blk.0.attn_norm.weight": (np.ones(hidden, np.float32), "F32"),
         "blk.0.ffn_norm.weight": (np.ones(hidden, np.float32), "F32")}
    for frag, shape in shapes.items():
        t[f"blk.0.{frag}.weight"] = (
            (rs.randn(*shape) * 0.05).astype(np.float32), "Q8_0")
    TG.write_gguf(str(path), meta, t)
    return str(path)


@pytest.mark.parametrize("load", ["file", "dummy"])
def test_gated_shapes_are_refused_on_the_card(tmp_path, monkeypatch, load):
    """A file (forms from its header) or a dummy load (BENCH_GGUF_FMT=
    q8_0) at hidden 384, whose qkv, o and gate_up buckets fail K13's
    gate, was refused on the card until the fallback route served it;
    the test keeps its id and holds what replaced the refusal: the
    configs build on the card and on the CPU, and the file's buckets
    load in the q8_0 form with exactly those three refused by K13's
    gate (they take the dequantize route in `apply`)."""
    path = _write_wide_q8(tmp_path / "wide.gguf")
    kw = {}
    if load == "dummy":
        monkeypatch.setenv("BENCH_GGUF_FMT", "q8_0")
        kw = dict(load_format="dummy")
    for device in ("cuda", "auto"):
        assert _engine_configs(path, device=device, dtype="bfloat16",
                               **kw)[0].quantization == "gguf"
    assert _engine_configs(path, **kw)[0].quantization == "gguf"
    if load == "file":
        assert set(TQ.checkpoint_forms(path).values()) == {"q8_0"}
    shapes = {"qkv": (384, 640), "o": (384, 384), "gate_up": (384, 1024),
              "down": (512, 384)}
    assert {k: tqm.gguf_q8_supported(*s) for k, s in shapes.items()} == {
        "qkv": False, "o": False, "gate_up": False, "down": True}
    # The turbo form (K15 needs in % 128 == 0 only) passes on the card.
    monkeypatch.delenv("BENCH_GGUF_FMT", raising=False)
    assert _engine_configs(path, device="cuda", dtype="bfloat16",
                           load_format="dummy")[0].quantization == "gguf"


@pytest.mark.parametrize("form,params", [
    ("q8_0", {"qs": (256, 512), "d": (8, 512)}),
    ("q6_k", {"qs": (256, 512), "d16": (16, 512)}),
    ("", {"qs8": (256, 512), "s128": (2, 512)}),
])
def test_dummy_forms_and_random_codes(tmp_path, monkeypatch, form, params):
    from aphrodite_tpu_torch.modeling.loader import get_model
    path = write_model(tmp_path / "m.gguf", UNIFORM_Q8, layers=1)
    if form:
        monkeypatch.setenv("BENCH_GGUF_FMT", form)
    model_config = _engine_configs(path, load_format="dummy")[0]
    _, got = get_model(model_config, torch.device("cpu"))
    qkv = got["model.layers.0.self_attn.qkv_proj"]
    assert {k: tuple(v.shape) for k, v in qkv.items()} == params
    codes = qkv["qs8" if "qs8" in qkv else "qs"]
    assert codes.dtype == torch.int8
    assert int(codes.min()) < -100 and int(codes.max()) > 100


# ------------------------------------------------------------- engine --

def _generate(llm, sp_cls, **kw):
    outs = llm.generate(prompt_token_ids=[list(p) for p in PROMPTS],
                        sampling_params=sp_cls(temperature=0.0,
                                               max_tokens=8,
                                               ignore_eos=True, **kw))
    return [o.outputs[0] for o in outs]


def _engines(path, quantization):
    jax_llm = JaxLLM(model=path, quantization=quantization,
                     dtype="float32", **ENGINE_KW)
    port = LLM(model=path, quantization=quantization, dtype="float32",
               device="cpu", **ENGINE_KW)
    return jax_llm, port


def _spy(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(tqm, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(TQ.qmm, name, spy)
    return calls


@pytest.mark.parametrize("types,quantization,kernels", [
    (UNIFORM_Q8, "gguf", {"gguf_q8_matmul": 4}),
    (MIXED_QKV, "gguf", {"gguf_i8g_matmul": 1, "gguf_q8_matmul": 3}),
    (UNIFORM_Q4, None, {}),
], ids=["q8_0-k13", "mixed-qkv-k14", "dense"])
def test_greedy_generation_matches_jax(tmp_path, monkeypatch, types,
                                       quantization, kernels):
    calls = _spy(monkeypatch, ("gguf_q8_matmul", "gguf_i8g_matmul",
                               "gguf_w8a8_matmul"))
    path = write_model(tmp_path / "m.gguf", types)
    jax_llm, port = _engines(path, quantization)
    want = [o.token_ids for o in _generate(jax_llm, JaxSamplingParams)]
    got = _generate(port, SamplingParams, logprobs=2)
    compared = 0
    for w, g in zip(want, got):
        for pos, (wt, gt) in enumerate(zip(w, g.token_ids)):
            top = sorted(g.logprobs[pos].values(), reverse=True)
            if top[0] - top[1] <= GAP_TOL:
                break                      # near tie: may flip from here
            assert wt == gt, (pos, w, g.token_ids)
            compared += 1
    assert compared >= 16
    # Every projection of every step went through its kernel's wrapper
    # (prompt round plus 7 decode rounds, 2 layers).
    for name, per_layer in kernels.items():
        assert calls[name] == 8 * 2 * per_layer, calls
    assert sum(calls.values()) == 8 * 2 * sum(kernels.values())


def test_exact_q4k_generation_matches_jax(tmp_path, monkeypatch):
    """A Q4_K file under APHRODITE_GGUF_EXACT=1: the port runs K12 on the
    qweight/dl/ml form, the JAX CPU engine dequantizes the same form;
    greedy tokens equal, as for the other exact forms."""
    monkeypatch.setenv("APHRODITE_GGUF_EXACT", "1")
    calls = _spy(monkeypatch, ("gguf_q4k_matmul", "gguf_q8_matmul",
                               "gguf_i8g_matmul", "gguf_w8a8_matmul"))
    path = write_model(tmp_path / "q4k.gguf", dict.fromkeys(PROJ, "Q4_K"))
    jax_llm, port = _engines(path, "gguf")
    qkv = port.engine.executor.params["model.layers.0.self_attn.qkv_proj"]
    assert sorted(qkv) == ["dl", "ml", "qweight"]
    want = [o.token_ids for o in _generate(jax_llm, JaxSamplingParams)]
    got = _generate(port, SamplingParams, logprobs=2)
    compared = 0
    for w, g in zip(want, got):
        for pos, (wt, gt) in enumerate(zip(w, g.token_ids)):
            top = sorted(g.logprobs[pos].values(), reverse=True)
            if top[0] - top[1] <= GAP_TOL:
                break
            assert wt == gt, (pos, w, g.token_ids)
            compared += 1
    assert compared >= 16
    assert calls == {"gguf_q4k_matmul": 8 * 2 * 4, "gguf_q8_matmul": 0,
                     "gguf_i8g_matmul": 0, "gguf_w8a8_matmul": 0}


def test_turbo_generation_stays_near_jax(tmp_path, monkeypatch):
    """Uniform Q4_0 under turbo: the port runs K9 + K15 (int8
    activations), the JAX CPU engine the dequantized weight on float
    activations. Top-5 logprobs within 0.05 where both have the token
    and the generations still agree; tokens equal while the port's top-2
    gap exceeds 0.1."""
    calls = _spy(monkeypatch, ("gguf_w8a8_matmul",))
    path = write_model(tmp_path / "m.gguf", UNIFORM_Q4)
    jax_llm, port = _engines(path, "gguf")
    want = _generate(jax_llm, JaxSamplingParams, logprobs=5)
    got = _generate(port, SamplingParams, logprobs=5)
    assert calls["gguf_w8a8_matmul"] == 8 * 2 * 4
    compared = worst = 0.0
    for w, g in zip(want, got):
        for pos, (wt, gt) in enumerate(zip(w.token_ids, g.token_ids)):
            shared = set(w.logprobs[pos]) & set(g.logprobs[pos])
            assert len(shared) >= 3
            for tok in shared:
                err = abs(w.logprobs[pos][tok] - g.logprobs[pos][tok])
                worst = max(worst, err)
            top = sorted(g.logprobs[pos].values(), reverse=True)
            if top[0] - top[1] <= 0.1:
                break
            assert wt == gt, (pos, w.token_ids, g.token_ids)
            compared += 1
    assert worst <= 0.05, worst
    # The random model's top-2 gaps are often below 0.1 (0.03-1.3 here).
    assert compared >= 6
