"""Multi-LoRA serving in the PyTorch port against the JAX package, on the
CPU (tests/conftest.py's tiny Llama and tests/test_torch_gptq.py's GPTQ
checkpoint, float32).

Adapters are PEFT directories (adapter_config.json, adapter_model.bin
or .safetensors) written from numpy RandomStates with fixed seeds (the
JAX package's own LoRA test seeds with `hash(name)`, which varies by
process). Both engines get the JAX engine's weights (`params_from_jax`,
the LoRA slot stacks included) and the same pinned `num_gpu_blocks`.

- `LoRALinearMethod`: rows with a slot, with -1 and with an out-of-range
  slot, over a dense base: the port's delta within 1e-5 of the JAX
  method's (f32), from the idx alone and from the runner's mask.
- `_merge_block_diagonal` (full qkv, q+v and gate-only subsets, with and
  without the layer's layout) and `layouts_from_model`: exact.
- `LoRAModel.from_local_checkpoint` from `.bin` and `.safetensors`,
  full and q+v adapters: every merged (A, B) exactly the JAX package's.
- The managers: slot writes, clears and evictions across 3 adapters at
  max_loras 2 in the JAX package's order.
- Engines: greedy tokens bit-equal to the JAX engine's for a base-only
  batch, one adapter alone, two adapters in one batch beside base rows,
  and a third adapter that the scheduler holds back until a slot frees
  and that then evicts one; with speculative verify on (drafts pinned so
  verify rounds carry adapter rows) and off, at multi_step 1 and 8. A
  seeded sampled request under an adapter: bit-equal. LoRA over the
  GPTQ checkpoint: bit-equal; over SqueezeLLM, int8, AWQ and GGUF
  checkpoints (whose JAX CPU routes dequantize and sum in another order;
  the GGUF file served dense on the JAX side): equal while the port's
  top-2 logprob gap exceeds 1e-4, as their own tests compare.
- `LLM(enable_lora=True)` and `AsyncAphrodite` with LoRA raise without a
  card unless given `device="cpu"`.
- A decode burst's pad rows stay dead, so the fused KV write leaves the
  pool's last page alone.
"""
import json

import numpy as np
import pytest
import torch

from aphrodite_tpu.common.config import LoRAConfig as JaxLoRAConfig
from aphrodite_tpu.lora import layers as jax_layers
from aphrodite_tpu.lora import models as jax_models
from aphrodite_tpu.lora.request import LoRARequest as JaxLoRARequest
from aphrodite_tpu.modeling.layers.linear import (
    LinearMethod as JaxLinearMethod)
from aphrodite_tpu_torch.common.config import LoRAConfig
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.lora import layers
from aphrodite_tpu_torch.lora import models
from aphrodite_tpu_torch.lora.request import LoRARequest
from aphrodite_tpu_torch.modeling.convert import params_from_jax
from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
from test_torch_gptq import gptq_checkpoint  # noqa: F401 (fixture)
from test_torch_spec import drain, engine_pair, sampling


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


ALL7 = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj")
QV = ("q_proj", "v_proj")
_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")


def _dims(hidden, kv, inter):
    """(in, out) of each HF projection."""
    return {"q_proj": (hidden, hidden), "k_proj": (hidden, kv),
            "v_proj": (hidden, kv), "o_proj": (hidden, hidden),
            "gate_proj": (hidden, inter), "up_proj": (hidden, inter),
            "down_proj": (inter, hidden)}


def write_adapter(path, seed, rank=8, targets=ALL7, scale=0.05,
                  hidden=64, kv=32, inter=128, num_layers=2, fmt="bin"):
    """A PEFT adapter directory for a Llama of these widths, its A and B
    drawn from RandomState(seed); lora_alpha = 2 * rank."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "adapter_config.json").write_text(json.dumps({
        "r": rank, "lora_alpha": 2 * rank,
        "target_modules": list(targets)}))
    rs = np.random.RandomState(seed)
    dims = _dims(hidden, kv, inter)
    state = {}
    for i in range(num_layers):
        for proj in targets:
            part = "self_attn" if proj in _ATTN else "mlp"
            base = f"base_model.model.model.layers.{i}.{part}.{proj}"
            fan_in, fan_out = dims[proj]
            state[f"{base}.lora_A.weight"] = \
                (rs.randn(rank, fan_in) * scale).astype(np.float32)
            state[f"{base}.lora_B.weight"] = \
                (rs.randn(fan_out, rank) * scale).astype(np.float32)
    if fmt == "safetensors":
        from safetensors.numpy import save_file
        save_file(state, str(path / "adapter_model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   path / "adapter_model.bin")
    return str(path)


# ------------------------------------------------------------ layers --

IN, OUT, RANK, SLOTS = 32, 48, 8, 2


def test_lora_linear_method_matches_jax():
    """Slot 1, -1, slot 0 and slot 5 (out of range) rows: the port's
    output within 1e-5 of the JAX method's and of base + (x @ A) @ B on
    the rows with a slot; -1 and out-of-range rows get the base output.
    (The JAX method's out-of-range row is NaN: `jnp.take` fills an
    out-of-bounds gather with NaN and NaN * 0 stays NaN, against its own
    docstring. The port gives that row the base output, as documented.)"""
    import jax.numpy as jnp
    rs = np.random.RandomState(0)
    w = (rs.randn(IN, OUT) * 0.1).astype(np.float32)
    a = (rs.randn(SLOTS, IN, RANK) * 0.1).astype(np.float32)
    b = (rs.randn(SLOTS, RANK, OUT) * 0.1).astype(np.float32)
    idx = np.array([1, -1, 0, 5], dtype=np.int32)
    x = rs.randn(4, 3, IN).astype(np.float32)

    jax_method = jax_layers.LoRALinearMethod(JaxLinearMethod(), SLOTS, RANK)
    want = np.asarray(jax_method.apply({
        "weight": jnp.asarray(w), jax_layers.LORA_A: jnp.asarray(a),
        jax_layers.LORA_B: jnp.asarray(b),
        jax_layers.LORA_IDX: jnp.asarray(idx)}, jnp.asarray(x)))

    bucket = params_from_jax({"m.qkv_proj": {
        "weight": w, jax_layers.LORA_A: a, jax_layers.LORA_B: b}})
    params = {**bucket["m.qkv_proj"],
              layers.LORA_IDX: torch.from_numpy(idx)}
    method = layers.LoRALinearMethod(LinearMethod(), SLOTS, RANK)
    got = method.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=1e-5)
    assert np.isnan(want[3]).all()
    masked = method.apply(
        {**params, layers.LORA_MASK: layers.slot_mask(
            params[layers.LORA_IDX], SLOTS, torch.float32)},
        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(masked, got)

    base = x @ w
    for row, slot in enumerate(idx):
        ref = base[row] if not 0 <= slot < SLOTS else \
            base[row] + (x[row] @ a[slot]) @ b[slot]
        np.testing.assert_allclose(got[row], ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], torch.from_numpy(x[1]).matmul(
        torch.from_numpy(w)).numpy())


def test_lora_stacks_sized_by_packed_factor():
    """qkv carries rank 3r a slot, gate_up 2r, the others r; the stacks
    start zero in the model dtype."""
    from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    cfg = config_from_dict(dict(_TINY_CFG))
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                             linear_method=layers.LoRALinearMethod(
                                 LinearMethod(), max_loras=3, max_rank=8))
    params = model.init_params(torch.device("cpu"))
    for name, packed, fan_in, fan_out in (
            ("self_attn.qkv_proj", 3, 64, 128),
            ("self_attn.o_proj", 1, 64, 64),
            ("mlp.gate_up_proj", 2, 64, 256),
            ("mlp.down_proj", 1, 128, 64)):
        bucket = params[f"model.layers.1.{name}"]
        assert bucket[layers.LORA_A].shape == (3 * 8 * packed, fan_in)
        assert bucket[layers.LORA_B].shape == (fan_out, 3 * 8 * packed)
        assert bucket[layers.LORA_A].dtype == torch.bfloat16


# ------------------------------------------------------------- merge --

_TINY_CFG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128, "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 256, "rope_theta": 10000.0,
    "tie_word_embeddings": False,
}


def _pieces(rs, specs, fan_in=32):
    return [(sid, rs.randn(fan_in, r).astype(np.float32),
             rs.randn(r, out).astype(np.float32)) for sid, r, out in specs]


@pytest.mark.parametrize("key,specs,layout", [
    ("x.qkv_proj", [("q", 4, 16), ("k", 4, 8), ("v", 4, 8)], None),
    ("x.qkv_proj", [("q", 4, 16), ("k", 4, 8), ("v", 4, 8)],
     {"q": (0, 16), "k": (16, 8), "v": (24, 8)}),
    ("x.qkv_proj", [("q", 4, 16), ("v", 4, 8)], None),
    ("x.qkv_proj", [("v", 4, 8), ("q", 4, 16)],
     {"q": (0, 16), "k": (16, 8), "v": (24, 8)}),
    ("x.gate_up_proj", [(0, 4, 24)], None),
    ("x.gate_up_proj", [(0, 4, 24)], {0: (0, 24), 1: (24, 24)}),
    ("x.gate_up_proj", [(1, 4, 24), (0, 4, 24)], None),
    ("x.o_proj", [(None, 4, 32)], None),
])
def test_merge_block_diagonal_matches_jax(key, specs, layout):
    want = jax_models._merge_block_diagonal(
        key, _pieces(np.random.RandomState(7), specs), layout)
    got = models._merge_block_diagonal(
        key, _pieces(np.random.RandomState(7), specs), layout)
    np.testing.assert_array_equal(got.a, want.a)
    np.testing.assert_array_equal(got.b, want.b)
    if key == "x.qkv_proj" and len(specs) == 2:
        # q+v only: v's block sits past k's slice, k's slice stays zero.
        assert got.b.shape == (8, 32)
        np.testing.assert_array_equal(got.b[:, 16:24], 0.0)


def test_layouts_from_model_match_jax():
    import jax.numpy as jnp
    from aphrodite_tpu.modeling.models.llama import (
        LlamaForCausalLM as JaxLlama)
    from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    want = jax_models.layouts_from_model(
        JaxLlama(config_from_dict(dict(_TINY_CFG)), dtype=jnp.float32))
    got = models.layouts_from_model(
        LlamaForCausalLM(config_from_dict(dict(_TINY_CFG)),
                         dtype=torch.float32))
    assert got == want
    assert got["model.layers.1.self_attn.qkv_proj"] == \
        {"q": (0, 64), "k": (64, 32), "v": (96, 32)}
    assert got["model.layers.0.mlp.gate_up_proj"] == \
        {0: (0, 128), 1: (128, 128)}


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
@pytest.mark.parametrize("targets,rank", [(ALL7, 8), (QV, 4)])
def test_from_local_checkpoint_matches_jax(tmp_path, fmt, targets, rank):
    from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    path = write_adapter(tmp_path / "a", seed=11, rank=rank,
                         targets=targets, fmt=fmt)
    layout = models.layouts_from_model(LlamaForCausalLM(
        config_from_dict(dict(_TINY_CFG)), dtype=torch.float32))
    want = jax_models.LoRAModel.from_local_checkpoint(path, 3, layout)
    got = models.LoRAModel.from_local_checkpoint(path, 3, layout)
    assert (got.id, got.rank) == (want.id, want.rank) == (3, rank)
    assert sorted(got.loras) == sorted(want.loras)
    assert len(got.loras) == 2 * (4 if targets == ALL7 else 1)
    for key, w in want.loras.items():
        np.testing.assert_array_equal(got.loras[key].a, w.a)
        np.testing.assert_array_equal(got.loras[key].b, w.b)


# ---------------------------------------------------------- managers --

def _manager_log(models_mod, config_cls, lru: bool):
    log = []
    cls = models_mod.LRUCacheLoRAModelManager if lru else \
        models_mod.LoRAModelManager
    mgr = cls(config_cls(max_lora_rank=8, max_loras=2, max_cpu_loras=2),
              write_slot_fn=lambda k, s, a, b: log.append(
                  ("write", k, s, float(a.sum()))),
              clear_slot_fn=lambda k, s: log.append(("clear", k, s)))
    rs = np.random.RandomState(5)

    def lora(i):
        w = models_mod.LoRALayerWeights(
            rs.randn(4, 8).astype(np.float32),
            rs.randn(8, 4).astype(np.float32))
        return models_mod.LoRAModel(i, 8, {"m0": w, "m1": w})
    for batch in ([1], [1, 2], [3], [2, 3], [1], [3, 1]):
        for i in batch:
            if i not in mgr.list_loras():
                mgr.add_lora(lora(i))
            elif lru:
                mgr.touch(i)
        mgr.set_active_loras(set(batch))
        log.append(("slots", tuple(sorted(
            (i, mgr.slot_of(i)) for i in batch))))
        log.append(("registered", tuple(sorted(mgr.list_loras()))))
    return log


@pytest.mark.parametrize("lru", [False, True])
def test_managers_match_jax(lru):
    """Slot writes, clears and evictions across 3 adapters at max_loras
    2 (and, under the LRU manager, host eviction at max_cpu_loras 2) in
    the JAX package's order."""
    want = _manager_log(jax_models, JaxLoRAConfig, lru)
    got = _manager_log(models, LoRAConfig, lru)
    assert got == want
    assert any(entry[0] == "clear" for entry in got)


# ----------------------------------------------------------- engines --

LORA_KW = dict(enable_lora=True, max_loras=2, max_lora_rank=8,
               skip_tokenizer_init=True)
PROMPTS = [[(i * 7 + 3 * j) % 250 + 5 for i in range(n)]
           for j, n in enumerate((5, 40, 21, 33, 17))]


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """Three adapters: all seven projections at rank 8, q+v only at rank
    8, all seven at rank 4 (zero-padded to the slot's rank 8)."""
    root = tmp_path_factory.mktemp("adapters")
    return [write_adapter(root / "a1", seed=101),
            write_adapter(root / "a2", seed=202, targets=QV),
            write_adapter(root / "a3", seed=303, rank=4)]


def _requests(engine, adapter_paths):
    """LoRARequests of the engine's package for the adapters (ids 1-3)."""
    cls = LoRARequest if "torch" in type(engine).__module__ else \
        JaxLoRARequest
    return [cls(f"a{i + 1}", i + 1, p) for i, p in enumerate(adapter_paths)]


def _serve(engine, batch, multi_step, prefix, **sp):
    """Add `batch` ((prompt, adapter index or None), ...) in order and
    drain; {request id: token ids}. Every page returns to the pool."""
    engine.scheduler_config.multi_step = multi_step
    reqs = engine._test_lora_requests
    params = sampling(engine, **dict(dict(
        temperature=0.0, max_tokens=12, ignore_eos=True), **sp))
    free = engine.scheduler.block_manager.get_num_free_gpu_blocks()
    for i, (prompt, a) in enumerate(batch):
        engine.add_request(f"{prefix}{i}", None, params,
                           prompt_token_ids=list(prompt),
                           lora_request=None if a is None else reqs[a])
    finals, _ = drain(engine)
    assert engine.scheduler.block_manager.get_num_free_gpu_blocks() == free
    return {rid: list(out.outputs[0].token_ids)
            for rid, out in finals.items()}


def _lora_pair(model_dir, adapter_paths, spec: bool, **kw):
    mp = pytest.MonkeyPatch()
    mp.setenv("APHRODITE_SPEC", "1" if spec else "0")
    pair = engine_pair(model_dir, scale=100.0, **dict(LORA_KW, **kw))
    for engine in pair:
        engine._test_lora_requests = _requests(engine, adapter_paths)
        if spec:
            # Draft the last two tokens: every decode round is a verify
            # round, some drafts accepted once a greedy stream repeats.
            mp.setattr(engine.drafter, "propose",
                       lambda seq_id, tokens, k: list(tokens[-k:]))
    return pair, mp


@pytest.fixture(scope="module", params=[False, True],
                ids=["spec_off", "spec_on"])
def lora_engines(request, tiny_model_dir, adapters):
    pair, mp = _lora_pair(tiny_model_dir, adapters, request.param)
    yield pair + (request.param,)
    mp.undo()


# (prompt index, adapter index or None) batches, served one after the
# other on the same engines: base only; one adapter alone; two adapters
# beside base rows; then a third adapter (max_loras 2: the scheduler
# holds it back until a slot frees, and activating it evicts one).
SCENARIO = [
    [(0, None), (1, None), (2, None)],
    [(3, 0)],
    [(0, 0), (1, None), (2, 1), (3, 0), (4, None)],
    [(4, 2), (1, 0), (2, 1), (0, None), (3, 2)],
]


@pytest.mark.parametrize("multi_step", [1, 8])
def test_greedy_lora_tokens_match_jax(lora_engines, multi_step,
                                      monkeypatch):
    from aphrodite_tpu_torch.executor.model_runner import ModelRunner
    jax_engine, port, spec = lora_engines
    verify_rows = []
    real = ModelRunner.execute_spec_verify

    def spy(self, mds, *args, **kwargs):
        verify_rows.extend(md.lora_request is not None for md in mds)
        return real(self, mds, *args, **kwargs)
    monkeypatch.setattr(ModelRunner, "execute_spec_verify", spy)
    seen = []
    for n, batch in enumerate(SCENARIO):
        reqs = [(PROMPTS[p], a) for p, a in batch]
        want = _serve(jax_engine, reqs, multi_step, f"m{multi_step}-{n}-")
        got = _serve(port, reqs, multi_step, f"m{multi_step}-{n}-")
        assert got == want, (n, got, want)
        seen.append(got)
    # The adapters change what the model says, and differ from each
    # other: prompt 3 under a1 vs a3, prompt 2 under a2 vs base.
    assert seen[1]["m%d-1-0" % multi_step] != \
        seen[3]["m%d-3-4" % multi_step]
    assert seen[0]["m%d-0-2" % multi_step] != \
        seen[2]["m%d-2-2" % multi_step]
    # With spec on, verify rounds carried adapter rows beside base rows.
    assert (any(verify_rows) and not all(verify_rows)) == spec


def test_seeded_sampling_under_an_adapter_matches_jax(tiny_model_dir,
                                                      adapters, tmp_path):
    """A seeded draw (temperature 0.8) under a strong adapter (A, B times
    0.4, so it moves the draw) beside a base row and an adapter row."""
    strong = write_adapter(tmp_path / "strong", seed=505, scale=0.4)
    (jax_engine, port), mp = _lora_pair(tiny_model_dir,
                                        [strong] + adapters[1:], spec=False)
    try:
        batch = [(PROMPTS[1], 0), (PROMPTS[2], None), (PROMPTS[3], 2)]
        kw = dict(temperature=0.8, top_p=0.9, seed=1234)
        want = _serve(jax_engine, batch, 1, "s-", **kw)
        got = _serve(port, batch, 1, "s-", **kw)
        assert got == want
        assert got["s-0"] != _serve(port, [(PROMPTS[1], None)], 1,
                                    "s-", **kw)["s-0"]
    finally:
        mp.undo()


def test_lora_over_gptq_matches_jax(gptq_checkpoint, tmp_path,
                                    monkeypatch):
    """LoRA wraps the GPTQ method (the port's K6 / K7 wrappers, on the
    CPU their plain versions); greedy tokens equal the JAX engine's."""
    from aphrodite_tpu.engine.aphrodite_engine import (
        AphroditeEngine as JaxEngine)
    from aphrodite_tpu.engine.args_tools import EngineArgs as JaxEngineArgs
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    from aphrodite_tpu_torch.modeling.layers.quantization.gptq import (
        GPTQLinearMethod)
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    monkeypatch.delenv("APHRODITE_W4A8", raising=False)
    paths = [write_adapter(tmp_path / f"g{i}", seed=400 + i, hidden=128,
                           kv=64, inter=256, scale=0.1,
                           targets=ALL7 if i == 0 else QV)
             for i in range(2)]
    kw = dict(model=gptq_checkpoint, load_format="safetensors",
              dtype="float32", max_model_len=128, max_num_seqs=4,
              swap_space=0.01, block_size=16, disable_log_stats=True,
              **LORA_KW)
    jcfg = JaxEngineArgs(**kw).create_engine_configs()
    jcfg[1].num_gpu_blocks = 32
    jax_engine = JaxEngine(*jcfg, log_stats=False,
                           skip_tokenizer_init=True)
    tcfg = EngineArgs(device="cpu", **kw).create_engine_configs()
    tcfg[1].num_gpu_blocks = 32
    port = AphroditeEngine(*tcfg, log_stats=False, skip_tokenizer_init=True)
    method = port.executor.model.layers[0].mlp.down_proj.linear_method
    assert isinstance(method.base, GPTQLinearMethod)
    for engine in (jax_engine, port):
        engine._test_lora_requests = _requests(engine, paths)
    prompts = [[(i * 5 + j) % 200 + 3 for i in range(n)]
               for j, n in enumerate((9, 30, 16))]
    batch = [(prompts[0], 0), (prompts[1], None), (prompts[2], 1)]
    for ms in (1, 8):
        want = _serve(jax_engine, batch, ms, f"g{ms}-")
        got = _serve(port, batch, ms, f"g{ms}-")
        assert got == want
    base = _serve(port, [(prompts[0], None)], 1, "gb-")
    assert base["gb-0"] != got["g8-0"]


def _quantized_base(kind, tmp_path):
    """(model dir, quantization, load format, (hidden, kv, inter)) of the
    checkpoints the other quantized methods' tests build."""
    import test_torch_squeezellm as sq
    if kind == "squeezellm":
        path = sq.write_checkpoint(tmp_path / "m", sq.sqllm_projection,
                                   dict(sq.CONFIG,
                                        quantization_config=sq.SQLLM))
        return path, None, "auto", (sq.HIDDEN, 128, sq.INTER)
    if kind == "int8":
        from test_torch_int8 import dense_projection
        path = sq.write_checkpoint(tmp_path / "m", dense_projection)
        return path, "int8", "auto", (sq.HIDDEN, 128, sq.INTER)
    if kind == "gguf":
        import test_torch_gguf as gg
        path = gg.write_model(tmp_path / "m.gguf", gg.MIXED_QKV)
        return path, "gguf", "auto", (gg.HIDDEN, gg.KV_HEADS * (
            gg.HIDDEN // gg.HEADS), gg.INTER)
    import test_torch_awq as aw
    path = aw.awq_checkpoint.__wrapped__(_TmpFactory(tmp_path))
    return path, None, "safetensors", (1024, 512, 1024)


class _TmpFactory:
    def __init__(self, root):
        self.root = root

    def mktemp(self, name):
        path = self.root / name
        path.mkdir()
        return path


@pytest.mark.parametrize("kind", ["squeezellm", "int8", "awq", "gguf"])
def test_lora_over_other_quantized_bases_matches_jax(kind, tmp_path,
                                                     monkeypatch):
    """LoRA over SqueezeLLM (K16), int8 (K17, quantized at load), AWQ
    (K10 / K7) and GGUF (a `.gguf` file whose projections stay Q8_0 and
    grouped int8 at rest: K13 / K14) checkpoints, on the CPU: greedy
    tokens with two adapters and a base row in one batch equal the JAX
    engine's while the port's top-2 logprob gap exceeds 1e-4 (those
    methods' JAX CPU routes dequantize and sum in another order; their
    own tests use the same rule), at least 12 compared; the base row
    equals the port's with LoRA off bit for bit. The JAX engine serves
    the `.gguf` file dense (its LoRA wrapper loses GGUF's renamed
    tensors, ROADMAP Queue 3)."""
    from aphrodite_tpu.engine.aphrodite_engine import (
        AphroditeEngine as JaxEngine)
    from aphrodite_tpu.engine.args_tools import EngineArgs as JaxEngineArgs
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    monkeypatch.delenv("APHRODITE_W4A8", raising=False)
    model_dir, quantization, load_format, (h, kv, inter) = \
        _quantized_base(kind, tmp_path)
    paths = [write_adapter(tmp_path / f"q{i}", seed=600 + i, hidden=h,
                           kv=kv, inter=inter, scale=0.1,
                           targets=ALL7 if i == 0 else QV)
             for i in range(2)]
    kw = dict(model=model_dir, load_format=load_format,
              quantization=quantization, dtype="float32", max_model_len=128,
              max_num_seqs=4, swap_space=0.01, block_size=16,
              disable_log_stats=True, skip_tokenizer_init=True)

    def engine(cls_args, cls_engine, lora, **extra):
        cfg = cls_args(**dict(kw, **extra), **(dict(
            enable_lora=True, max_loras=2, max_lora_rank=8)
            if lora else {})).create_engine_configs()
        cfg[1].num_gpu_blocks = 32
        return cls_engine(*cfg, log_stats=False, skip_tokenizer_init=True)
    # The JAX LoRA wrapper drops GGUF's rename (Queue 3), so its GGUF
    # engine is the dense one: the file dequantized at load, the same
    # values as the port's exact Q8_0 and grouped-int8 forms.
    jax_engine = engine(JaxEngineArgs, JaxEngine, True,
                        **({"quantization": None} if kind == "gguf"
                           else {}))
    port = engine(EngineArgs, AphroditeEngine, True, device="cpu")
    for e in (jax_engine, port):
        e._test_lora_requests = _requests(e, paths)
    prompts = [[(i * 5 + j) % 200 + 3 for i in range(n)]
               for j, n in enumerate((9, 30, 16))]
    batch = [(prompts[0], 0), (prompts[1], None), (prompts[2], 1)]
    want = _serve(jax_engine, batch, 1, "q-")
    got = _serve(port, batch, 1, "q-")
    scored = _serve_scored(port, batch)
    compared = 0
    for rid in want:
        assert scored[rid][0] == got[rid]
        for pos, (w, g) in enumerate(zip(want[rid], got[rid])):
            top = sorted(scored[rid][1][pos].values(), reverse=True)
            if top[0] - top[1] <= 1e-4:
                break
            assert w == g, (rid, pos, want[rid], got[rid])
            compared += 1
    assert compared >= 12, compared
    off = engine(EngineArgs, AphroditeEngine, False, device="cpu")
    off._test_lora_requests = None
    assert _serve(off, [(prompts[1], None)], 1, "q-")["q-0"] == got["q-1"]
    assert got["q-0"] != _serve(off, [(prompts[0], None)], 1, "o-")["o-0"]


def _serve_scored(engine, batch):
    """`_serve`'s batch with logprobs=2: {request id: (tokens, logprobs
    per position)}."""
    reqs = engine._test_lora_requests
    params = sampling(engine, temperature=0.0, max_tokens=12,
                      ignore_eos=True, logprobs=2)
    for i, (prompt, a) in enumerate(batch):
        engine.add_request(f"q-{i}", None, params,
                           prompt_token_ids=list(prompt),
                           lora_request=None if a is None else reqs[a])
    finals, _ = drain(engine)
    return {rid: (list(o.outputs[0].token_ids), o.outputs[0].logprobs)
            for rid, o in finals.items()}


def test_lora_engine_refuses_the_cpu_unless_asked(tiny_model_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    from aphrodite_tpu_torch.endpoints.llm import LLM
    with pytest.raises(RuntimeError, match="CUDA card"):
        LLM(model=tiny_model_dir, load_format="dummy", swap_space=0.01,
            **LORA_KW)
    llm = LLM(model=tiny_model_dir, load_format="dummy", swap_space=0.01,
              device="cpu", **LORA_KW)
    assert llm.engine.executor.lora_manager is not None
    from aphrodite_tpu_torch.engine.args_tools import AsyncEngineArgs
    from aphrodite_tpu_torch.engine.async_aphrodite import AsyncAphrodite
    kw = dict(model=tiny_model_dir, load_format="dummy", swap_space=0.01,
              disable_log_stats=True, disable_log_requests=True, **LORA_KW)
    with pytest.raises(RuntimeError, match="CUDA card"):
        AsyncAphrodite.from_engine_args(AsyncEngineArgs(**kw))
    engine = AsyncAphrodite.from_engine_args(AsyncEngineArgs(device="cpu",
                                                             **kw))
    assert engine.engine.executor.lora_manager is not None


def test_burst_pad_rows_leave_the_last_page_alone(lora_engines):
    """A decode burst of 3 rows pads to 4; the pad row stays dead in
    every step (ctx 0), so the fused KV write never reaches the page its
    clamped table points at, the pool's last. (Before, the pad row went
    live from the second step and wrote the last page's first slot,
    which the adapter runs above exposed when a sequence owned it.)"""
    from aphrodite_tpu_torch.common.sequence import (SequenceData,
                                                     SequenceGroupMetadata)
    _, port, _ = lora_engines
    runner = port.executor.model_runner
    kv = port.executor.cache_engine.kv_caches
    last = kv[0][0].shape[0] - 1
    before = [(k[last].clone(), v[last].clone()) for k, v in kv]
    mds = [SequenceGroupMetadata(
        request_id=f"pad{i}", is_prompt=False,
        seq_data={i: SequenceData([(j * 3 + i) % 250 for j in range(20)])},
        sampling_params=SamplingParams(temperature=0.0),
        block_tables={i: [10 + 2 * i, 11 + 2 * i]}, persistent_data={i: {}})
        for i in range(3)]
    outs, _ = runner.execute_decode_burst(mds, kv, 4)
    assert len(outs) == 4
    for (k, v), (k0, v0) in zip(kv, before):
        assert torch.equal(k[last], k0) and torch.equal(v[last], v0)
