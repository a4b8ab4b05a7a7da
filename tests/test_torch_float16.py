"""float16 compute in the PyTorch port against the JAX package, on the
CPU (the kernels' plain versions). Inputs are made with numpy from a
seed; both sides get the same fp16 weights, through `params_from_jax`
or one local checkpoint.

The JAX package serves fp16 pages through its jnp reference (f32
scores, softmax and weights @ V) and its XLA scatter; the port's plain
K1 rounds the scaled query and the softmax weights to fp16, as its
kernel's fp16 instances do. Tolerances:

- plain K1 at fp16 (fp16, int8 and fp8 pages, ALiBi, groups 1, 4 and 32,
  head_dim 80 and 128) against `paged_decode_attention_ref`: |port -
  jax| <= 2e-3 + 1e-3 |jax| on the live rows. Both round the output to
  fp16, one ulp of which is 1.95e-3 at 2-4 (the largest outputs here);
  the fp16 rounding of q and of p adds under 1e-3. The JAX reference
  writes NaN on a row of context 0 (a softmax over nothing), the port 0;
- the slot writer's plain version with fp16 rows against `quantize_kv` +
  `write_to_kv_cache`: bit for bit, int8 round-half-even ties and
  clamps and fp8 e5m2 overflow (57344 and up to 61440 round to 57344,
  from there +-inf) included;
- a tiny Llama's and a tiny Phi's fp16 prompt logits: within 2e-2 + 1e-2
  |jax| (logits up to about 3, where an fp16 ulp is 2e-3; the two
  packages round each layer's fp16 activations at other places); a tiny
  Mixtral's: finite on both sides (weights N(0, 0.1^2), the archs and
  MoE tests' draw) and within the same tolerance;
- engines (`LLM(dtype="float16", device="cpu")` and the engine API):
  greedy and seeded tokens bit-equal to the JAX engine's, at multi_step
  1 and 8, speculative verify on and off, on fp16, int8 and fp8 pages;
  the sliding window; a locally written GPTQ checkpoint; one LoRA
  adapter over an fp16 Llama.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.endpoints.llm import LLM as JaxLLM
from aphrodite_tpu.engine.aphrodite_engine import (
    AphroditeEngine as JaxEngine)
from aphrodite_tpu.engine.args_tools import EngineArgs as JaxEngineArgs
from aphrodite_tpu.lora.request import LoRARequest as JaxLoRARequest
from aphrodite_tpu.modeling.input_metadata import (
    InputMetadata as JaxInputMetadata)
from aphrodite_tpu.ops import kv_cache as jkv
from aphrodite_tpu.ops.attention import paged_decode_attention_ref
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.utils import Counter
from aphrodite_tpu_torch.endpoints.llm import LLM
from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.lora.request import LoRARequest
from aphrodite_tpu_torch.modeling.convert import params_from_jax, to_device
from aphrodite_tpu_torch.modeling.input_metadata import InputMetadata
from aphrodite_tpu_torch.ops import kv_quant as tkq
from aphrodite_tpu_torch.ops.cuda import kv_write as tkw
from aphrodite_tpu_torch.ops.cuda import paged_attention as tpa
from test_torch_e2e import mistral_dir  # noqa: F401 (fixture)
from test_torch_gptq import gptq_checkpoint  # noqa: F401 (fixture)
from test_torch_lora import write_adapter
from test_torch_spec import drain


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
    from aphrodite_tpu.common import faultinject as jax_faults
    from aphrodite_tpu_torch.common import faultinject
    monkeypatch.delenv("APHRODITE_FAULT", raising=False)
    monkeypatch.delenv("APHRODITE_FAULT_SEED", raising=False)
    jax_faults.reset()
    faultinject.reset()


S = tkq.DEFAULT_KV_SCALE
ATTN_ATOL, ATTN_RTOL = 2e-3, 1e-3
MODEL_ATOL, MODEL_RTOL = 2e-2, 1e-2
KINDS = {"fp16": (np.float16, torch.float16, jnp.float16),
         "int8": (np.int8, torch.int8, jnp.int8),
         "fp8": (ml_dtypes.float8_e5m2, torch.float8_e5m2,
                 jnp.float8_e5m2)}


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch through the bytes (fp8 has no numpy twin)."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.float8_e5m2:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e5m2)
    return torch.from_numpy(a.copy())


def _bytes(x) -> np.ndarray:
    a = x.contiguous().view(torch.uint8).numpy() if torch.is_tensor(x) \
        else np.asarray(x)
    return a.view(np.uint8)


# ---------------------------------------------------------- config --

def test_float16_is_a_served_dtype(tmp_path, tiny_model_dir):
    """"float16" and "half" build engine configs; the port's dtype tables
    map it to torch.float16; `params_from_jax` carries numpy float16
    arrays over as float16; dummy init draws fp16 weights within the
    JAX loader's scale."""
    import inspect
    from aphrodite_tpu.modeling import hf_loader as jax_hf_loader
    from aphrodite_tpu_torch.executor import cache_engine
    from aphrodite_tpu_torch.modeling import loader
    cfgs = EngineArgs(model=tiny_model_dir, device="cpu", dtype="half",
                      kv_cache_dtype="auto").create_engine_configs()
    assert cfgs[0].dtype == "float16"
    assert cache_engine.cache_dtype_of(cfgs[1], cfgs[0]) == torch.float16
    assert loader.DTYPES["float16"] == torch.float16
    assert loader.DUMMY_SCALE == inspect.signature(
        jax_hf_loader.initialize_dummy_params).parameters["scale"].default
    rng = np.random.default_rng(0)
    host = {"model.layers.0.self_attn.qkv_proj": {
                "weight": rng.normal(size=(8, 12)).astype(np.float16)},
            "model.norm": {"weight": np.ones(8, np.float16)}}
    params = params_from_jax(host)
    w = params["model.layers.0.self_attn.qkv_proj"]["weight"]
    assert w.dtype == torch.float16 and w.shape == (12, 8)
    assert torch.equal(w, torch.from_numpy(host[
        "model.layers.0.self_attn.qkv_proj"]["weight"].T.copy()))
    assert params["model.norm"]["weight"].dtype == torch.float16
    llm = LLM(model=tiny_model_dir, load_format="dummy", dtype="float16",
              device="cpu", max_model_len=128, swap_space=0.01,
              skip_tokenizer_init=True, disable_log_stats=True)
    ex = llm.engine.executor
    bound = torch.tensor(loader.DUMMY_SCALE, dtype=torch.float16)
    for bucket in ex.params.values():
        for t in bucket.values():
            if t.is_floating_point():
                assert t.dtype == torch.float16
                assert bool(t.abs().max() <= bound)
    assert ex.cache_engine.kv_caches[0][0].dtype == torch.float16


def test_llm_at_float16_needs_a_card_unless_asked(tiny_model_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLM(model=tiny_model_dir, load_format="dummy", dtype="float16",
            skip_tokenizer_init=True)


# ----------------------------------------------------- plain kernels --

def _decode_case(kind, group, d, seed=0):
    """Pages of `kind` (int8 codes of N(0, 1) / S), fp16 q of N(0, 2^2),
    tables, contexts (one of them 0) and ALiBi slopes."""
    rng = np.random.default_rng(seed)
    hkv, page, pps, num_pages = 2, 8, 8, 48
    np_dt = KINDS[kind][0]

    def pages():
        x = rng.normal(size=(num_pages, page, hkv * d)).astype(np.float32)
        if kind == "int8":
            return np.clip(np.round(x / S), -127, 127).astype(np.int8)
        return x.astype(np_dt)
    q = (rng.normal(size=(5, hkv * group, d)) * 2).astype(np.float16)
    tables = rng.permutation(num_pages)[:5 * pps].reshape(5, pps).astype(
        np.int32)
    ctx = np.array([1, 0, 40, 64, 17], np.int32)
    slopes = rng.uniform(0.0, 0.1, size=hkv * group).astype(np.float32)
    return q, pages(), pages(), tables, ctx, slopes


@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("group", [1, 4, 32])
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_k1_at_fp16_matches_jax_reference(kind, group, d):
    """The plain K1 on fp16 activations over fp16, int8 and fp8 pages,
    with ALiBi, against the JAX package's jnp reference (its fp16
    route); the operands round to fp16, not bf16; with the fused write,
    the pages equal `write_to_kv_cache`'s bit for bit."""
    q, kp, vp, tables, ctx, slopes = _decode_case(kind, group, d)
    kv_scale = S if kind == "int8" else 1.0
    want = np.asarray(paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ctx), d ** -0.5,
        jnp.asarray(slopes), kv_scale=S)).astype(np.float32)
    kw = dict(scale=d ** -0.5, kv_scale=kv_scale, pages_per_chunk=2)
    got = tpa.paged_decode_attention_plain(
        _t(q), _t(kp), _t(vp), _t(tables), _t(ctx), _t(slopes), **kw)
    assert got.dtype == torch.float16
    live = ctx > 0
    assert (got[~live] == 0).all()
    np.testing.assert_allclose(got.float().numpy()[live], want[live],
                               atol=ATTN_ATOL, rtol=ATTN_RTOL)
    # The fused write: the current token, drawn as the pages were, at
    # ctx - 1 of each live row.
    rng = np.random.default_rng(1)
    hkv = kp.shape[2] // d
    kn = rng.normal(size=(5, hkv, d)).astype(np.float16)
    vn = rng.normal(size=(5, hkv, d)).astype(np.float16)
    page = kp.shape[1]
    pos = np.maximum(ctx - 1, 0)
    slots = tables[np.arange(5), pos // page] * page + pos % page
    slots = np.where(live, slots, kp.shape[0] * page).astype(np.int32)
    wk, wv = jkv.write_to_kv_cache(
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(slots), kv_scale=S)
    out, gk, gv = tpa.paged_decode_attention_plain(
        _t(q), _t(kp), _t(vp), _t(tables), _t(ctx), _t(slopes), _t(kn),
        _t(vn), **kw)
    assert np.array_equal(_bytes(gk), _bytes(wk))
    assert np.array_equal(_bytes(gv), _bytes(wv))
    want = np.asarray(paged_decode_attention_ref(
        jnp.asarray(q), wk, wv, jnp.asarray(tables), jnp.asarray(ctx),
        d ** -0.5, jnp.asarray(slopes), kv_scale=S)).astype(np.float32)
    np.testing.assert_allclose(out.float().numpy()[live], want[live],
                               atol=ATTN_ATOL, rtol=ATTN_RTOL)


def test_plain_k1_rounds_fp16_operands():
    """The operand rule: fp16 under fp16 activations (on fp16 and 8-bit
    pages), bf16 under bf16 and f32 ones, f32 on f32 pages."""
    f16, bf16, f32 = torch.float16, torch.bfloat16, torch.float32
    for act, page, op in ((f16, f16, f16), (f16, torch.int8, f16),
                          (f16, torch.float8_e5m2, f16), (bf16, bf16, bf16),
                          (bf16, torch.int8, bf16), (f32, torch.int8, bf16),
                          (f32, f32, f32)):
        assert tpa.dot_operand_dtype(act, page) == op


def _edge_values():
    """fp16 values at the write rules' edges: int8 ties at S = 0.25
    (x / S = k + 1/2) and clamps, every e5m2 value and rounding midpoint
    (subnormals too), the values around e5m2's overflow (57344 is its
    largest, 61440 the midpoint to 2^16), fp16's largest, +-inf and
    NaN, each exact in fp16, negated too."""
    e5m2 = np.arange(0, 0x7C, dtype=np.uint8).view(
        ml_dtypes.float8_e5m2).astype(np.float32)
    mids = (e5m2[:-1] + e5m2[1:]) / 2
    vals = np.concatenate([
        np.arange(-128, 128) * 0.25 + 0.125, [31.875, 32.0, 40.0], e5m2,
        mids, [57376.0, 60000.0, 61408.0, 61440.0, 61472.0, 65504.0,
               np.inf, np.nan]]).astype(np.float32)
    vals = np.concatenate([vals, -vals])
    assert np.array_equal(vals.astype(np.float16).astype(np.float32), vals,
                          equal_nan=True)
    return vals.astype(np.float16)


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_slot_writer_takes_fp16_rows_as_jax(kind):
    """fp16 rows through the slot writer's plain version (K3 / K4 on the
    CPU) into fp16, int8 (S = 0.25) and fp8 pages: bit for bit the JAX
    package's `quantize_kv` + `write_to_kv_cache`, with padding slots
    skipped; the kernel takes each pair."""
    rng = np.random.default_rng(2)
    vals = _edge_values()
    hd, page, num_pages = 64, 8, 16
    rows = np.resize(vals, (-(-len(vals) // hd) * hd,)).reshape(-1, hd)
    n = rows.shape[0]
    kn = rows
    vn = np.ascontiguousarray(rows[::-1])
    np_dt = KINDS[kind][0]
    kp = np.zeros((num_pages, page, hd), np_dt)
    vp = np.zeros((num_pages, page, hd), np_dt)
    slots = rng.permutation(num_pages * page)[:n].astype(np.int32)
    slots[::5] = num_pages * page
    wk, wv = jkv.write_to_kv_cache(
        jnp.asarray(kn).reshape(n, 2, hd // 2),
        jnp.asarray(vn).reshape(n, 2, hd // 2), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(slots), kv_scale=0.25)
    gk, gv = tkw.write_kv_pages(_t(kn), _t(vn), _t(kp), _t(vp), _t(slots),
                                distinct_pages=True, kv_scale=0.25)
    assert (torch.float16, KINDS[kind][1]) in tkw.SLOT_KINDS
    for got, want in ((_bytes(gk), _bytes(wk)), (_bytes(gv), _bytes(wv))):
        if kind == "fp8":
            # A NaN stays a NaN; its sign is torch's (kept, the card's
            # rule too), where JAX's fp16 -> e5m2 cast drops it.
            nan = (want & 0x7F) > 0x7C
            assert ((got[nan] & 0x7F) > 0x7C).all()
            got, want = got[~nan], want[~nan]
            assert (got == 0x7C).any() and (got == 0xFC).any()   # +-inf
            assert (got == 0x7B).any()                           # 57344
        assert np.array_equal(got, want)


def test_plain_prefill_writer_takes_fp16_pages():
    """K2's plain version on fp16 pages against `write_to_kv_cache` of the
    same live rows: bit for bit (the JAX package writes fp16 prompts
    through its scatter; K2 copies whole 16-byte vectors)."""
    rng = np.random.default_rng(3)
    page, hd, num_pages = 8, 64, 12
    kp = rng.normal(size=(num_pages, page, hd)).astype(np.float16)
    rows = rng.normal(size=(4 * page, hd)).astype(np.float16)
    pid = np.array([3, num_pages, 5, 9], np.int32)
    vld = np.array([page, page, 3, 1], np.int32)
    live = np.arange(page)[None] < vld[:, None]
    live &= (pid < num_pages)[:, None]
    slots = np.where(live, pid[:, None] * page + np.arange(page)[None],
                     num_pages * page).reshape(-1).astype(np.int32)
    wk, _ = jkv.write_to_kv_cache(
        jnp.asarray(rows).reshape(-1, 1, hd),
        jnp.asarray(rows).reshape(-1, 1, hd), jnp.asarray(kp),
        jnp.asarray(kp), jnp.asarray(slots))
    gk, _ = tkw.write_kv_pages_prefill(_t(rows), _t(rows), _t(kp), _t(kp),
                                       _t(pid), np.arange(4, dtype=np.int32),
                                       _t(vld))
    assert np.array_equal(_bytes(gk), _bytes(wk))


# --------------------------------------------------------- the models --

LLAMA = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
         "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "max_position_embeddings": 256,
         "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
         "tie_word_embeddings": False}
PHI = {"architectures": ["PhiForCausalLM"], "model_type": "phi",
       "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
       "num_hidden_layers": 2, "num_attention_heads": 4,
       "partial_rotary_factor": 0.5, "max_position_embeddings": 256}
MIXTRAL = {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
           "vocab_size": 256, "hidden_size": 64, "intermediate_size": 96,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "num_local_experts": 8,
           "num_experts_per_tok": 2, "max_position_embeddings": 512,
           "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
_NORMS = ("norm", "layernorm", "layer_norm", "ln_1", "ln_f")


def _fp16_logits(cfg, seed=5, n=9):
    """Prompt logits of the JAX model and the port's at fp16 on the same
    numpy-seeded fp16 weights (norm weights near 1, the rest N(0,
    0.1^2)); returns (port, jax) as f32 numpy arrays."""
    from transformers import AutoConfig
    from aphrodite_tpu.modeling.models import ModelRegistry as JaxRegistry
    from aphrodite_tpu_torch.modeling.loader import _get_model_architecture
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    jmodel = JaxRegistry.load_model_cls(cfg["architectures"][0])(
        AutoConfig.for_model(**cfg), dtype=jnp.float16)
    hf = config_from_dict(cfg)
    model = _get_model_architecture(hf)(hf, dtype=torch.float16)
    rng = np.random.default_rng(seed)
    np_params = {}
    for key, bucket in jax.eval_shape(jmodel.init_params).items():
        np_params[key] = {}
        for name, leaf in bucket.items():
            norm = key.endswith(_NORMS) and name == "weight"
            arr = (1.0 if norm else 0.0) + rng.normal(0, 0.1, leaf.shape)
            np_params[key][name] = arr.astype(np.float16)
    params = params_from_jax(np_params)
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
    want = np.asarray(jmodel.compute_logits(jparams, hidden)).astype(
        np.float32)
    meta = InputMetadata(
        slot_mapping=torch.full((n,), 10 ** 6, dtype=torch.int32),
        block_tables=torch.full((1, 1), 10 ** 4, dtype=torch.int32),
        context_lens=torch.zeros((1,), dtype=torch.int32),
        prompt_lens=torch.full((1,), n, dtype=torch.int32), is_prompt=True)
    hidden, _ = model(params, torch.from_numpy(ids), torch.from_numpy(pos),
                      None, meta)
    assert hidden.dtype == torch.float16
    got = model.compute_logits(params, hidden).float().numpy()
    return got, want


@pytest.mark.parametrize("cfg", [LLAMA, PHI, MIXTRAL],
                         ids=["llama", "phi", "mixtral"])
def test_fp16_logits_match_jax(cfg):
    """A tiny Llama, Phi (an fp16-native family) and Mixtral at fp16:
    finite logits on both sides, within MODEL_ATOL + MODEL_RTOL |jax|."""
    got, want = _fp16_logits(cfg)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=MODEL_RTOL)


# -------------------------------------------------------- the engines --

NUM_BLOCKS = 64
WEIGHT_SCALE = 100.0
ENGINE_KW = dict(load_format="dummy", dtype="float16", block_size=16,
                 max_model_len=256, max_num_seqs=8, swap_space=0.01,
                 disable_log_stats=True, skip_tokenizer_init=True)
PATTERN = [11, 23, 37, 41]
PROMPTS = [PATTERN * 5] + [[(i * 7 + 3) % 250 + 5 for i in range(n)]
                           for n in (5, 40, 70)]


def _pair(model_dir, **kw):
    """The JAX engine and the port's at fp16, the port given the JAX
    engine's dummy fp16 weights x WEIGHT_SCALE (so attention and the MLP
    do real work) and both the same pool."""
    args = dict(ENGINE_KW, **kw)
    jcfg = JaxEngineArgs(model=model_dir, **args).create_engine_configs()
    jcfg[1].num_gpu_blocks = NUM_BLOCKS
    jax_engine = JaxEngine(*jcfg, log_stats=False, skip_tokenizer_init=True)
    params = jax.tree_util.tree_map(lambda a: a * WEIGHT_SCALE,
                                    jax_engine.executor.params)
    jax_engine.executor.params = params
    jax_engine.executor.model_runner.params = params
    tcfg = EngineArgs(model=model_dir, device="cpu",
                      **args).create_engine_configs()
    tcfg[1].num_gpu_blocks = NUM_BLOCKS
    port = AphroditeEngine(*tcfg, log_stats=False, skip_tokenizer_init=True)
    host = jax.tree_util.tree_map(np.asarray, params)
    tparams = to_device(params_from_jax(host), torch.device("cpu"))
    assert tparams["model.embed_tokens"]["weight"].dtype == torch.float16
    port.executor.params = tparams
    port.executor.model_runner.params = tparams
    return jax_engine, port


@pytest.fixture(scope="module", params=["auto", "int8", "fp8"],
                ids=["fp16_pages", "int8_pages", "fp8_pages"])
def engines(request, tiny_model_dir):
    return request.param, _pair(tiny_model_dir,
                                kv_cache_dtype=request.param)


def _serve(engine, multi_step, prompts=PROMPTS, **sp):
    """`LLM.generate` of the engine's package over `engine`: every prompt
    one request, token ids in prompt order. Every page returns to the
    pool."""
    if isinstance(engine, AphroditeEngine):
        llm_cls, sp_cls = LLM, SamplingParams
    else:
        llm_cls, sp_cls = JaxLLM, JaxSamplingParams
    llm = object.__new__(llm_cls)
    llm.engine, llm.request_counter = engine, Counter()
    engine.scheduler_config.multi_step = multi_step
    outs = llm.generate(prompt_token_ids=[list(p) for p in prompts],
                        sampling_params=sp_cls(**dict(dict(
                            temperature=0.0, max_tokens=16,
                            ignore_eos=True), **sp)))
    assert engine.scheduler.block_manager.get_num_free_gpu_blocks() == \
        NUM_BLOCKS
    return [list(o.outputs[0].token_ids) for o in outs]


@pytest.mark.parametrize("spec", ["0", "1"], ids=["spec_off", "spec_on"])
@pytest.mark.parametrize("multi_step", [1, 8])
def test_fp16_engine_tokens_match_jax(engines, multi_step, spec,
                                      monkeypatch):
    """Greedy and seeded (temperature 0.8, top_p 0.9) tokens of
    `LLM.generate` over the port's fp16 engine bit-equal to the JAX
    engine's on fp16, int8 and fp8 pages;
    the pages are of the model dtype or the 8-bit one; with spec on,
    verify rounds ran; every decode step attended through K1's wrapper
    and the prompts were written by K2 (fp16 pages) or the slot writer
    (8-bit pages)."""
    from aphrodite_tpu_torch.executor.model_runner import ModelRunner
    from aphrodite_tpu_torch.modeling.layers import attention
    kv, (jax_engine, port) = engines
    want_page = {"auto": torch.float16, "int8": torch.int8,
                 "fp8": torch.float8_e5m2}[kv]
    assert port.executor.cache_engine.kv_caches[0][0].dtype == want_page
    monkeypatch.setenv("APHRODITE_SPEC", spec)
    for engine in (jax_engine, port):
        # Draft the last two tokens: with spec on, every decode round is
        # a verify round, some drafts accepted once a stream repeats.
        monkeypatch.setattr(engine.drafter, "propose",
                            lambda seq_id, tokens, k: list(tokens[-k:]))
    calls = {}
    for name in ("write_kv_pages_prefill", "write_kv_pages",
                 "paged_decode_attention"):
        real = getattr(attention, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(attention, name, spy)
    verify = []
    real_verify = ModelRunner.execute_spec_verify

    def verify_spy(self, *a, **k):
        verify.append(1)
        return real_verify(self, *a, **k)
    monkeypatch.setattr(ModelRunner, "execute_spec_verify", verify_spy)
    want = _serve(jax_engine, multi_step)
    got = _serve(port, multi_step)
    assert got == want
    assert bool(verify) == (spec == "1")
    assert calls.get("paged_decode_attention", 0) > 0
    assert calls.get("write_kv_pages_prefill" if kv == "auto"
                     else "write_kv_pages", 0) > 0
    seeded = dict(temperature=0.8, top_p=0.9, seed=7)
    assert _serve(port, multi_step, **seeded) == \
        _serve(jax_engine, multi_step, **seeded)


def test_fp16_sliding_window_matches_jax(mistral_dir):
    """The tiny Mistral (window 24, 8-token pages) at fp16: a 10-token
    prompt decoded 40 steps past the window beside a 30-token prompt
    longer than it, token for token the JAX engine's."""
    prompts = [[5, 9, 11, 3, 7, 2, 8, 4, 6, 10],
               [(i * 37 + 5) % 120 + 3 for i in range(30)]]
    kw = dict(load_format="safetensors", dtype="float16", max_model_len=128,
              max_num_seqs=4, block_size=8, swap_space=0.01,
              skip_tokenizer_init=True, disable_log_stats=True)
    sp = dict(temperature=0.0, max_tokens=40, ignore_eos=True)
    jllm = JaxLLM(model=mistral_dir, **kw)
    want = [list(o.outputs[0].token_ids) for o in jllm.generate(
        prompt_token_ids=prompts, sampling_params=JaxSamplingParams(**sp))]
    llm = LLM(model=mistral_dir, device="cpu", **kw)
    assert llm.engine.model_config.get_sliding_window() == 24
    got = [list(o.outputs[0].token_ids) for o in llm.generate(
        prompt_token_ids=prompts, sampling_params=SamplingParams(**sp))]
    assert got == want


def test_fp16_gptq_checkpoint_matches_jax(gptq_checkpoint, monkeypatch):
    """A locally written 4-bit GPTQ checkpoint (group 128) at fp16:
    greedy tokens equal the JAX engine's; the layers run in fp16."""
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    monkeypatch.delenv("APHRODITE_W4A8", raising=False)
    kw = dict(dtype="float16", max_model_len=128, max_num_seqs=4,
              swap_space=0.01, skip_tokenizer_init=True,
              disable_log_stats=True, block_size=16,
              load_format="safetensors")
    sp = dict(temperature=0.0, max_tokens=8, ignore_eos=True)
    prompts = [[(i * 7 + 3) % 250 + 5 for i in range(n)] for n in (5, 23)]
    jllm = JaxLLM(model=gptq_checkpoint, **kw)
    want = [list(o.outputs[0].token_ids) for o in jllm.generate(
        prompt_token_ids=prompts, sampling_params=JaxSamplingParams(**sp))]
    llm = LLM(model=gptq_checkpoint, device="cpu", **kw)
    qkv = llm.engine.executor.params["model.layers.0.self_attn.qkv_proj"]
    assert qkv["scales"].dtype == torch.float16
    got = [list(o.outputs[0].token_ids) for o in llm.generate(
        prompt_token_ids=prompts, sampling_params=SamplingParams(**sp))]
    assert got == want


def test_fp16_lora_adapter_matches_jax(tiny_model_dir, tmp_path,
                                       monkeypatch):
    """One rank-8 adapter over all seven projections of an fp16 Llama:
    rows with and without it, token for token the JAX engine's, and the
    adapter moves the tokens."""
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    path = write_adapter(tmp_path / "a1", seed=101, scale=0.3)
    jax_engine, port = _pair(tiny_model_dir, enable_lora=True, max_loras=1,
                             max_lora_rank=8)
    out = {}
    for engine, req in ((jax_engine, JaxLoRARequest("a1", 1, path)),
                        (port, LoRARequest("a1", 1, path))):
        cls = SamplingParams if engine is port else JaxSamplingParams
        params = cls(temperature=0.0, max_tokens=12, ignore_eos=True)
        for i, p in enumerate(PROMPTS[1:3]):
            engine.add_request(f"b{i}", None, params,
                               prompt_token_ids=list(p))
            engine.add_request(f"l{i}", None, params,
                               prompt_token_ids=list(p), lora_request=req)
        finals, _ = drain(engine)
        out[engine is port] = {r: list(o.outputs[0].token_ids)
                               for r, o in finals.items()}
    assert out[True] == out[False]
    assert out[True]["b0"] != out[True]["l0"] or \
        out[True]["b1"] != out[True]["l1"]
