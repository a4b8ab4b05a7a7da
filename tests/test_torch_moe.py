"""Mixture-of-Experts in the PyTorch port (`modeling/layers/fused_moe.py`,
`modeling/models/{mixtral,deepseek}.py`) against the JAX package, in
float32 on the CPU.

- `FusedMoE` against the JAX layer on the same numpy-seeded inputs and
  weights (carried across by `params_from_jax`): the dense combine (4
  experts, k 1 and 2) and the grouped path (8 and 16 experts, k 2 and 6,
  renormalized and not) at T 1, 7 and 64, within 1e-5 (f32; the port
  sums each token's k contributions in JAX's order, so the difference
  is the einsums' and products' summation order). The top-k expert ids
  are equal wherever the k-th and (k+1)-th probabilities differ by more
  than 1e-6 (torch and XLA may order ties differently).
- Mixtral and DeepSeek models (DeepSeek's plan [dense, MoE, MoE] with
  two shared experts) at narrow widths: prompt logits within 1e-4 of
  the JAX model's (f32 through 2-3 layers of attention and experts).
- The engine pair (the JAX engine's dummy weights x 100, the routers and
  expert stacks x 1000, through `params_from_jax`): greedy tokens equal while the
  port's top-2 logprob gap exceeds GAP_TOL, at multi_step 1 and 4, with
  speculative decoding off and on; seeded tokens bit-equal; the port's
  experts rolled by one change every sequence (the control). The JAX
  engine reads the DeepSeek directory's config.json through its
  `get_config` patched to return a `transformers.PretrainedConfig` of
  the same keys (HF needs remote code for `model_type: "deepseek"`;
  nothing is downloaded or executed from the directory).
- A tiny checkpoint with HF tensor names, written as safetensors, loads
  into both packages equal (after `params_from_jax`).
- Config: a Mixtral config.json that omits keys gives the port the
  values HF's `AutoConfig` gives the JAX package; DeepSeek's defaults
  follow the JAX model's getattrs; quantization and LoRA on an MoE
  architecture are refused at config time; unregistered architectures
  still are; the JAX package fails to load a quantized expert.
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
from aphrodite_tpu.engine.aphrodite_engine import (
    AphroditeEngine as JaxEngine)
from aphrodite_tpu.engine.args_tools import EngineArgs as JaxEngineArgs
from aphrodite_tpu.modeling.input_metadata import (
    InputMetadata as JaxInputMetadata)
from aphrodite_tpu.modeling.layers.fused_moe import FusedMoE as JaxFusedMoE
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.modeling.convert import params_from_jax, to_device
from aphrodite_tpu_torch.modeling.input_metadata import InputMetadata
from aphrodite_tpu_torch.modeling.layers import fused_moe
from aphrodite_tpu_torch.modeling.layers.fused_moe import FusedMoE


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
    jax_faults.reset()
    faultinject.reset()


MOE_TOL = 1e-5
MARGIN = 1e-6
MODEL_TOL = 1e-4
GAP_TOL = 1e-4
NUM_BLOCKS = 96
HIDDEN = 32
INTER = 48

MIXTRAL = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 256, "hidden_size": 64, "intermediate_size": 96,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_local_experts": 8,
    "num_experts_per_tok": 2, "max_position_embeddings": 512,
    "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
}
DEEPSEEK = {
    "architectures": ["DeepseekForCausalLM"], "model_type": "deepseek",
    "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
    "moe_intermediate_size": 48, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4,
    "n_routed_experts": 16, "num_experts_per_tok": 6,
    "n_shared_experts": 2, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "norm_topk_prob": False,
    "max_position_embeddings": 512, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "tie_word_embeddings": False,
}
CONFIGS = {"mixtral": MIXTRAL, "deepseek": DEEPSEEK}


def _write_config(path, cfg) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    return {name: _write_config(tmp_path_factory.mktemp(name), cfg)
            for name, cfg in CONFIGS.items()}


@pytest.fixture
def jax_reads_deepseek(monkeypatch):
    """The JAX package's `get_config` returning a PretrainedConfig of the
    directory's config.json for `model_type: "deepseek"` (which HF
    serves only through remote code)."""
    from transformers import PretrainedConfig
    from aphrodite_tpu.common import config as jax_config
    real = jax_config.get_config

    def get_config(model, trust_remote_code=False, revision=None):
        path = os.path.join(model, "config.json")
        if os.path.isfile(path):
            with open(path) as f:
                raw = json.load(f)
            if raw.get("model_type") == "deepseek":
                return PretrainedConfig(**raw)
        return real(model, trust_remote_code, revision)
    monkeypatch.setattr(jax_config, "get_config", get_config)


# ---- FusedMoE ----

def _moe_inputs(e, t, seed):
    rng = np.random.default_rng(seed)
    params = {
        "gate": rng.normal(0, 0.5, (HIDDEN, e)),
        "w_gate": rng.normal(0, 0.2, (e, HIDDEN, INTER)),
        "w_up": rng.normal(0, 0.2, (e, HIDDEN, INTER)),
        "w_down": rng.normal(0, 0.2, (e, INTER, HIDDEN)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(0, 1, (t, HIDDEN)).astype(np.float32)
    return params, x


def _port_params(bucket_key, np_params):
    return params_from_jax({bucket_key: np_params})[bucket_key]


MOE_CASES = [(4, k, True, t) for k in (1, 2) for t in (1, 7, 64)] + [
    (e, k, renorm, t) for e in (8, 16) for k in (2, 6)
    for renorm in (True, False) for t in (1, 7, 64)]


@pytest.mark.parametrize("e,k,renorm,t", MOE_CASES)
def test_fused_moe_matches_jax(e, k, renorm, t):
    np_params, x = _moe_inputs(e, t, seed=e * 100 + k * 10 + t)
    jmoe = JaxFusedMoE(e, k, HIDDEN, INTER, renormalize=renorm,
                       dtype=jnp.float32)
    want = np.asarray(jmoe({n: jnp.asarray(a) for n, a in
                            np_params.items()}, jnp.asarray(x)))
    moe = FusedMoE(e, k, HIDDEN, INTER, renormalize=renorm,
                   dtype=torch.float32)
    params = _port_params("model.layers.0.block_sparse_moe", np_params)
    reads = fused_moe.HOST_READS.count
    got = moe(params, torch.from_numpy(x))
    # One host read per grouped call (the group sizes), none dense.
    assert fused_moe.HOST_READS.count - reads == (1 if e > 4 else 0)
    assert got.dtype == torch.float32 and got.shape == (t, HIDDEN)
    np.testing.assert_allclose(got.numpy(), want, atol=MOE_TOL, rtol=0)
    # The picks: equal top-k ids wherever the k-th and (k+1)-th
    # probabilities are MARGIN apart.
    probs, _, idx = fused_moe.route(torch.from_numpy(x), params["gate"], k,
                                    renorm)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(np_params["gate"]),
                            axis=-1)
    _, jidx = jax.lax.top_k(jprobs, k)
    srt = probs.sort(dim=-1, descending=True).values
    clear = (srt[:, k - 1] - srt[:, k]) > MARGIN
    assert clear.sum() >= t // 2
    assert torch.equal(idx[clear], torch.tensor(np.asarray(jidx))
                       .long()[clear])


def test_grouped_path_takes_each_expert_once_in_stable_order():
    """Every expert's rows multiply its own weights once: with all the
    probability on one expert a token's output is that expert's SwiGLU,
    and a token's k pairs keep their slot order inside an expert group
    (stable sort), as JAX's argsort keeps them."""
    e, k = 8, 2
    np_params, x = _moe_inputs(e, 5, seed=3)
    moe = FusedMoE(e, k, HIDDEN, INTER, renormalize=True,
                   dtype=torch.float32)
    params = _port_params("m.block_sparse_moe", np_params)
    idx = torch.tensor([[3, 5], [5, 3], [0, 7], [7, 0], [3, 0]])
    vals = torch.tensor([[1.0, 0.0]] * 5)
    got = moe._grouped_ffn(params, torch.from_numpy(x), vals, idx)
    for tok, expert in enumerate(idx[:, 0].tolist()):
        xe = torch.from_numpy(x[tok:tok + 1])
        act = torch.nn.functional.silu(xe @ params["w_gate"][expert].T) * \
            (xe @ params["w_up"][expert].T)
        want = act @ params["w_down"][expert].T
        torch.testing.assert_close(got[tok:tok + 1], want, atol=1e-5,
                                   rtol=0)


# ---- the models ----

def _jax_model(name, cfg):
    """The JAX model on the config the JAX package reads: HF's
    MixtralConfig, or (DeepSeek, remote code in HF) the keys as they
    are."""
    from transformers import AutoConfig, PretrainedConfig
    from aphrodite_tpu.modeling.models.deepseek import DeepseekForCausalLM
    from aphrodite_tpu.modeling.models.mixtral import MixtralForCausalLM
    if name == "mixtral":
        hf = AutoConfig.for_model(**cfg)
    else:
        hf = PretrainedConfig(**cfg)
    cls = MixtralForCausalLM if name == "mixtral" else DeepseekForCausalLM
    return cls(hf, dtype=jnp.float32)


def _port_model(cfg):
    from aphrodite_tpu_torch.modeling.loader import _get_model_architecture
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    hf = config_from_dict(cfg)
    return _get_model_architecture(hf)(hf, dtype=torch.float32)


def _random_params(model, seed):
    """Numpy-seeded params over the JAX model's tree (norm weights near
    1, the rest N(0, 0.1^2))."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init_params)
    out = {}
    for key, bucket in shapes.items():
        out[key] = {}
        for name, leaf in bucket.items():
            if key.endswith("norm"):
                arr = 1.0 + rng.normal(0, 0.1, leaf.shape)
            else:
                arr = rng.normal(0, 0.1, leaf.shape)
            out[key][name] = arr.astype(np.float32)
    return out


@pytest.mark.parametrize("name", ["mixtral", "deepseek"])
def test_models_match_jax(name):
    cfg = CONFIGS[name]
    jmodel = _jax_model(name, cfg)
    model = _port_model(cfg)
    if name == "deepseek":
        from aphrodite_tpu_torch.modeling.models.deepseek import DeepseekMoE
        from aphrodite_tpu_torch.modeling.models.llama import LlamaMLP
        assert [l.is_moe for l in jmodel.layers] == [False, True, True]
        assert [type(l.mlp) for l in model.layers] == [
            LlamaMLP, DeepseekMoE, DeepseekMoE]
        assert model.layers[1].mlp.shared.gate_up_proj.out_features == \
            2 * 2 * cfg["moe_intermediate_size"]
    np_params = _random_params(jmodel, seed=5)
    params = params_from_jax(np_params)
    assert set(params) == set(model.init_params(torch.device("meta")))
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
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=0)


# ---- the engine pair ----

ENGINE_KW = dict(load_format="dummy", dtype="float32", block_size=16,
                 max_model_len=256, max_num_seqs=8, swap_space=0.01,
                 disable_log_stats=True, skip_tokenizer_init=True,
                 max_num_batched_tokens=256)
WEIGHT_SCALE = 100.0
# The routers and the expert stacks U(-1, 1): picks with clear margins,
# and experts whose output moves the residual stream (at x 100 the MoE
# layers added ~1e-3 of it and rolling the experts changed no token).
MOE_SCALE = 1000.0
# A recurring tail n-gram: the drafter proposes from the first step.
PATTERN = [11, 23, 37, 41]
PROMPTS = [PATTERN * 5, [(i * 7 + 3) % 250 + 5 for i in range(40)],
           [(i * 13 + 1) % 250 + 5 for i in range(70)], [7, 9, 200]]


def _scale(path, a):
    moe = path[0].key.endswith(("block_sparse_moe", "mlp_moe"))
    return a * (MOE_SCALE if moe else WEIGHT_SCALE)


def _engine_pair(model_dir):
    jcfg = JaxEngineArgs(model=model_dir, **ENGINE_KW).create_engine_configs()
    jcfg[1].num_gpu_blocks = NUM_BLOCKS
    jax_engine = JaxEngine(*jcfg, log_stats=False, skip_tokenizer_init=True)
    params = jax.tree_util.tree_map_with_path(_scale,
                                              jax_engine.executor.params)
    jax_engine.executor.params = params
    jax_engine.executor.model_runner.params = params
    tcfg = EngineArgs(model=model_dir, device="cpu",
                      **ENGINE_KW).create_engine_configs()
    tcfg[1].num_gpu_blocks = NUM_BLOCKS
    port = AphroditeEngine(*tcfg, log_stats=False, skip_tokenizer_init=True)
    host = jax.tree_util.tree_map(np.asarray, params)
    tparams = to_device(params_from_jax(host), torch.device("cpu"),
                        torch.float32)
    port.executor.params = tparams
    port.executor.model_runner.params = tparams
    return jax_engine, port


@pytest.fixture(scope="module", params=["mixtral", "deepseek"])
def engines(request, model_dirs):
    mp = pytest.MonkeyPatch()
    mp.setenv("APHRODITE_SPEC", "0")
    if request.param == "deepseek":
        from transformers import PretrainedConfig
        from aphrodite_tpu.common import config as jax_config
        mp.setattr(jax_config, "get_config",
                   lambda model, *a, **k: PretrainedConfig(**DEEPSEEK))
    pair = _engine_pair(model_dirs[request.param])
    mp.undo()
    yield pair


def _generate(engine, multi_step, **sp):
    sp_cls = SamplingParams if isinstance(engine, AphroditeEngine) \
        else JaxSamplingParams
    engine.scheduler_config.multi_step = multi_step
    for i, p in enumerate(PROMPTS):
        engine.add_request(str(i), None, sp_cls(**dict(
            dict(temperature=0.0, max_tokens=12, ignore_eos=True), **sp)),
            prompt_token_ids=list(p))
    finals = {}
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                finals[out.request_id] = out.outputs[0]
    assert engine.scheduler.block_manager.get_num_free_gpu_blocks() == \
        NUM_BLOCKS
    return [finals[str(i)] for i in range(len(PROMPTS))]


def _gap_compare(want, got, scored):
    """Tokens equal while the port's top-2 logprob gap exceeds GAP_TOL;
    returns how many were compared."""
    compared = 0
    for w, g, s in zip(want, got, scored):
        assert list(s.token_ids) == list(g)
        for pos, (wt, gt) in enumerate(zip(w, g)):
            top = sorted(s.logprobs[pos].values(), reverse=True)
            if top[0] - top[1] <= GAP_TOL:
                break
            assert wt == gt, (pos, w, g)
            compared += 1
    return compared


@pytest.mark.parametrize("spec", ["0", "1"])
@pytest.mark.parametrize("multi_step", [1, 4])
def test_greedy_generation_matches_jax(engines, multi_step, spec,
                                       monkeypatch):
    jax_engine, port = engines
    monkeypatch.setenv("APHRODITE_SPEC", spec)
    grouped = []
    real = FusedMoE._grouped_ffn

    def spy(self, params, x, *a):
        grouped.append(x.shape[0])
        return real(self, params, x, *a)
    monkeypatch.setattr(FusedMoE, "_grouped_ffn", spy)
    if spec == "1":
        # Drafts whatever the dummy weights emit (the last token, k
        # times), so verify rows reach the MoE FFN in every round.
        monkeypatch.setattr(port.drafter, "propose",
                            lambda seq_id, ids, k: [ids[-1]] * k)
    verify = []
    real_verify = port.executor.execute_spec_verify

    def verify_spy(*a, **k):
        verify.append(1)
        return real_verify(*a, **k)
    monkeypatch.setattr(port.executor, "execute_spec_verify", verify_spy)
    want = [o.token_ids for o in _generate(jax_engine, multi_step)]
    got = [o.token_ids for o in _generate(port, multi_step)]
    scored = _generate(port, multi_step, logprobs=2)
    assert grouped, "the grouped path never ran"
    assert bool(verify) == (spec == "1")
    assert _gap_compare(want, got, scored) >= 24


def test_rolled_experts_change_the_tokens(engines):
    """The control: the port's expert stacks rolled by one expert change
    every sequence's greedy tokens, so the comparison above sees the
    experts."""
    jax_engine, port = engines
    want = [o.token_ids for o in _generate(jax_engine, 1)]
    stacks = [b[n] for k, b in port.executor.params.items()
              if k.endswith(("block_sparse_moe", "mlp_moe"))
              for n in ("w_gate", "w_up", "w_down")]
    for t in stacks:
        t.copy_(t.roll(1, 0))
    try:
        got = [o.token_ids for o in _generate(port, 1)]
    finally:
        for t in stacks:
            t.copy_(t.roll(-1, 0))
    assert all(g != w for g, w in zip(got, want))


def test_seeded_generation_matches_jax(engines):
    jax_engine, port = engines
    kw = dict(temperature=0.8, top_p=0.9, seed=7)
    want = [list(o.token_ids) for o in _generate(jax_engine, 4, **kw)]
    got = [list(o.token_ids) for o in _generate(port, 4, **kw)]
    assert got == want


# ---- checkpoints, the loader and the runner ----

def _hf_tensors(name, cfg, rng):
    """(HF name, float32 array) of a checkpoint of `cfg`."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = h // heads
    out = {"model.embed_tokens.weight": (v, h), "lm_head.weight": (v, h),
           "model.norm.weight": (h,)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out.update({f"{p}.self_attn.q_proj.weight": (heads * d, h),
                    f"{p}.self_attn.k_proj.weight": (kv * d, h),
                    f"{p}.self_attn.v_proj.weight": (kv * d, h),
                    f"{p}.self_attn.o_proj.weight": (h, heads * d),
                    f"{p}.input_layernorm.weight": (h,),
                    f"{p}.post_attention_layernorm.weight": (h,)})
        if name == "mixtral":
            inter, e = cfg["intermediate_size"], cfg["num_local_experts"]
            out[f"{p}.block_sparse_moe.gate.weight"] = (e, h)
            for x in range(e):
                q = f"{p}.block_sparse_moe.experts.{x}"
                out.update({f"{q}.w1.weight": (inter, h),
                            f"{q}.w3.weight": (inter, h),
                            f"{q}.w2.weight": (h, inter)})
        elif i < cfg["first_k_dense_replace"]:
            inter = cfg["intermediate_size"]
            out.update({f"{p}.mlp.gate_proj.weight": (inter, h),
                        f"{p}.mlp.up_proj.weight": (inter, h),
                        f"{p}.mlp.down_proj.weight": (h, inter)})
        else:
            inter, e = cfg["moe_intermediate_size"], cfg["n_routed_experts"]
            shared = inter * cfg["n_shared_experts"]
            out[f"{p}.mlp.gate.weight"] = (e, h)
            for x in range(e):
                q = f"{p}.mlp.experts.{x}"
                out.update({f"{q}.gate_proj.weight": (inter, h),
                            f"{q}.up_proj.weight": (inter, h),
                            f"{q}.down_proj.weight": (h, inter)})
            q = f"{p}.mlp.shared_experts"
            out.update({f"{q}.gate_proj.weight": (shared, h),
                        f"{q}.up_proj.weight": (shared, h),
                        f"{q}.down_proj.weight": (h, shared)})
    return {n: rng.normal(0, 0.1, s).astype(np.float32)
            for n, s in out.items()}


@pytest.mark.parametrize("name", ["mixtral", "deepseek"])
def test_checkpoint_loads_equal_into_both_packages(name, tmp_path,
                                                   jax_reads_deepseek):
    from safetensors.numpy import save_file
    from aphrodite_tpu.common.config import ModelConfig as JaxModelConfig
    from aphrodite_tpu.modeling.loader import get_model as jax_get_model
    from aphrodite_tpu_torch.common.config import ModelConfig
    from aphrodite_tpu_torch.modeling.loader import get_model
    path = _write_config(tmp_path, CONFIGS[name])
    tensors = _hf_tensors(name, CONFIGS[name], np.random.default_rng(2))
    save_file(tensors, os.path.join(path, "model.safetensors"))
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
    # The experts stacked without a transpose: expert 3's HF tensor.
    moe = "model.layers.1.block_sparse_moe" if name == "mixtral" else \
        "model.layers.1.mlp_moe"
    hf = "model.layers.1.block_sparse_moe.experts.3.w2.weight" \
        if name == "mixtral" else "model.layers.1.mlp.experts.3.down_proj.weight"
    assert torch.equal(params[moe]["w_down"][3], torch.from_numpy(tensors[hf]))


def test_dummy_params_draw_the_moe_stacks_from_the_seeded_generator(
        model_dirs):
    from aphrodite_tpu_torch.common.config import ModelConfig
    from aphrodite_tpu_torch.modeling.loader import get_model
    draws = []
    for seed in (0, 0, 1):
        _, params = get_model(ModelConfig(
            model_dirs["deepseek"], load_format="dummy", dtype="float32",
            seed=seed), torch.device("cpu"))
        draws.append(params["model.layers.2.mlp_moe"])
    for name, t in draws[0].items():
        assert t.abs().max() <= 1e-3 and t.abs().max() > 0, name
        assert torch.equal(t, draws[1][name]), name
        assert not torch.equal(t, draws[2][name]), name


def test_profile_run_reaches_the_grouped_path(model_dirs, monkeypatch):
    """The executor's profile run (a cache-less prompt round of
    max_num_batched_tokens rows) sends every row's k pairs through the
    grouped path, so the peak it measures on the card holds the [T * k,
    I] intermediates."""
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    cfg = EngineArgs(model=model_dirs["deepseek"], device="cpu",
                     **ENGINE_KW).create_engine_configs()
    cfg[1].num_gpu_blocks = NUM_BLOCKS
    port = AphroditeEngine(*cfg, log_stats=False, skip_tokenizer_init=True)
    rows = []
    real = FusedMoE._grouped_ffn

    def spy(self, params, x, vals, idx):
        rows.append(idx.numel())
        return real(self, params, x, vals, idx)
    monkeypatch.setattr(FusedMoE, "_grouped_ffn", spy)
    sched = port.scheduler_config
    seq_len = min(sched.max_model_len, sched.max_num_batched_tokens)
    port.executor.model_runner.profile_run(
        sched.max_num_batched_tokens // seq_len, seq_len)
    k = DEEPSEEK["num_experts_per_tok"]
    assert rows == [sched.max_num_batched_tokens * k] * 2


def test_async_engine_serves_an_moe_model(model_dirs):
    import asyncio
    from aphrodite_tpu_torch.engine.args_tools import AsyncEngineArgs
    from aphrodite_tpu_torch.engine.async_aphrodite import AsyncAphrodite

    async def go():
        engine = AsyncAphrodite.from_engine_args(AsyncEngineArgs(
            model=model_dirs["mixtral"], device="cpu",
            disable_log_requests=True, **ENGINE_KW))
        final = None
        async for out in engine.generate(
                None, SamplingParams(temperature=0.0, max_tokens=4,
                                     ignore_eos=True), "a",
                prompt_token_ids=[5, 6, 7]):
            final = out
        return final
    out = asyncio.run(go())
    assert out.finished and len(out.outputs[0].token_ids) == 4


# ---- config ----

def test_mixtral_config_defaults_match_hf(tmp_path):
    from transformers import AutoConfig
    from aphrodite_tpu_torch.transformers_utils.config import get_config
    path = _write_config(tmp_path, {
        "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
        "hidden_size": 256, "num_attention_heads": 8})
    want, got = AutoConfig.from_pretrained(path), get_config(path)
    for key in ("vocab_size", "intermediate_size", "num_hidden_layers",
                "num_key_value_heads", "head_dim", "hidden_act",
                "max_position_embeddings", "rms_norm_eps",
                "tie_word_embeddings", "rope_theta", "sliding_window",
                "num_experts_per_tok", "num_local_experts", "bos_token_id",
                "eos_token_id"):
        assert getattr(got, key) == getattr(want, key), key


def test_deepseek_config_defaults_and_refusal(tmp_path):
    from aphrodite_tpu_torch.modeling.models.deepseek import is_moe_layer
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)
    dense = {k: v for k, v in DEEPSEEK.items()
             if k not in ("n_routed_experts", "norm_topk_prob",
                          "n_shared_experts", "first_k_dense_replace",
                          "moe_layer_freq")}
    cfg = config_from_dict(dense)
    assert (cfg.n_routed_experts, cfg.norm_topk_prob,
            cfg.n_shared_experts) == (None, False, 0)
    assert not any(is_moe_layer(cfg, i) for i in range(3))
    for missing in ("first_k_dense_replace", "moe_layer_freq"):
        raw = {k: v for k, v in DEEPSEEK.items() if k != missing}
        with pytest.raises(ValueError, match=missing):
            config_from_dict(raw)


@pytest.mark.parametrize("name", ["mixtral", "deepseek"])
@pytest.mark.parametrize("how", ["argument", "checkpoint"])
def test_moe_refuses_quantization_at_config_time(name, how, tmp_path):
    quant = {"quant_method": "gptq", "bits": 4, "group_size": 32,
             "desc_act": False}
    cfg = dict(CONFIGS[name], **({"quantization_config": quant}
                                 if how == "checkpoint" else {}))
    path = _write_config(tmp_path, cfg)
    kw = {"quantization": "gptq"} if how == "argument" else {}
    with pytest.raises(NotImplementedError,
                       match="serves no quantized experts"):
        EngineArgs(model=path, device="cpu", load_format="dummy",
                   **kw).create_engine_configs()


@pytest.mark.parametrize("name", ["mixtral", "deepseek"])
def test_moe_refuses_lora_at_config_time(name, model_dirs):
    with pytest.raises(NotImplementedError, match="later slice"):
        EngineArgs(model=model_dirs[name], device="cpu", load_format="dummy",
                   enable_lora=True).create_engine_configs()


@pytest.mark.parametrize("arch", ["FalconForCausalLM", "FooForCausalLM"])
def test_unregistered_architectures_are_still_refused(arch, tmp_path):
    path = _write_config(tmp_path, dict(MIXTRAL, architectures=[arch]))
    with pytest.raises(NotImplementedError, match="architecture"):
        EngineArgs(model=path, device="cpu", load_format="dummy"
                   ).create_engine_configs()


def test_moe_engine_refuses_the_cpu_unless_asked(model_dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run on it")
    from aphrodite_tpu_torch.endpoints.llm import LLM
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLM(model=model_dirs["deepseek"], load_format="dummy",
            skip_tokenizer_init=True)


def test_jax_package_cannot_load_quantized_experts():
    """The reference behaviour behind the refusal: the JAX FusedMoE
    stacks float experts, so a GPTQ expert's packed qweight ([in / 8,
    out] int32) does not fit its [E, in, out] slot."""
    jmodel = _jax_model("mixtral", MIXTRAL)
    h, inter = MIXTRAL["hidden_size"], MIXTRAL["intermediate_size"]
    qweight = np.zeros((h // 8, inter), np.int32)
    with pytest.raises(ValueError):
        jmodel.load_weights([(
            "model.layers.0.block_sparse_moe.experts.0.w1.qweight",
            qweight)])
