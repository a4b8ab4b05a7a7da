"""The port's `load_format="npcache"` against the JAX package's, on the
CPU.

- The pattern of tests/test_weight_loading.py::test_npcache_roundtrip
  through the port's loader: a tiny `.bin` under `tmp_path` with a bf16,
  a float32 and an int32 tensor. The first load builds `np/` (the bf16
  tensor cached as float32, as the JAX package caches it) and equals the
  checkpoint; the second, with the `.bin` replaced by an empty stub, is
  served from the cache, which is not rewritten. A directory with
  neither `*.bin` files nor a cache is refused.
- A tiny Llama (hidden 128, 2 layers, bf16 weights made from a seed,
  written with `torch.save`): every parameter of the npcache load equals
  the `pt` load's exactly.
- Greedy `LLM.generate` on that checkpoint, the port under npcache
  against the JAX engine, token for token while the port's top-2
  logprob gap exceeds 1e-4 (a near tie may flip: f32 sums in another
  order).
"""
import json
import os

import numpy as np
import pytest
import torch

from aphrodite_tpu.common.sampling_params import (
    SamplingParams as JaxSamplingParams)
from aphrodite_tpu.endpoints.llm import LLM as JaxLLM
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.endpoints.llm import LLM
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.modeling import loader

GAP_TOL = 1e-4
CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 256, "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "max_position_embeddings": 256,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "bos_token_id": 0, "eos_token_id": 1,
}
ENGINE_KW = dict(dtype="float32", max_model_len=128, max_num_seqs=4,
                 swap_space=0.01, skip_tokenizer_init=True,
                 disable_log_stats=True, block_size=16)
PROMPTS = [[(i * 7 + 3) % 250 + 5 for i in range(n)] for n in (5, 23, 40)]


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
    jax_faults.reset()
    faultinject.reset()


def test_npcache_roundtrip_through_the_port_loader(tmp_path):
    state = {
        "a.weight": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b.bias": torch.linspace(-1, 1, 5).to(torch.bfloat16),
        "c.index": torch.arange(6, dtype=torch.int32),
    }
    torch.save(state, tmp_path / "pytorch_model.bin")
    first = dict(loader._weights_iterator(str(tmp_path), "npcache"))
    assert set(first) == set(state)
    assert torch.equal(first["a.weight"], state["a.weight"])
    assert first["b.bias"].dtype == torch.float32
    assert torch.equal(first["b.bias"], state["b.bias"].float())
    assert first["c.index"].dtype == torch.int32
    assert torch.equal(first["c.index"], state["c.index"])
    cache = tmp_path / "np"
    manifest = cache / "weight_names.json"
    assert json.loads(manifest.read_text()) == list(state)
    assert np.load(cache / "b.bias.npy").dtype == np.float32
    stamps = {p.name: p.stat().st_mtime_ns for p in cache.iterdir()
              if p.suffix in (".npy", ".json")}
    # The .bin is gone (an empty stub stays, which torch.load would
    # refuse): the second load must come from the cache alone.
    (tmp_path / "pytorch_model.bin").write_bytes(b"")
    second = dict(loader._weights_iterator(str(tmp_path), "npcache"))
    assert set(second) == set(state)
    for name, tensor in state.items():
        want = tensor.float() if tensor.dtype == torch.bfloat16 else tensor
        assert torch.equal(second[name], want), name
    assert {p.name: p.stat().st_mtime_ns for p in cache.iterdir()
            if p.suffix in (".npy", ".json")} == stamps
    # Served memory-mapped, and the tensors are writable without
    # touching the files.
    second["a.weight"].add_(1.0)
    assert torch.equal(torch.from_numpy(np.load(cache / "a.weight.npy")),
                       state["a.weight"])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="npcache"):
        list(loader._weights_iterator(str(empty), "npcache"))


def _tiny_llama_state(seed: int = 5):
    """HF-named bf16 weights of CONFIG's Llama, from a numpy seed."""
    rs = np.random.RandomState(seed)
    c = CONFIG
    h, inter, hd = c["hidden_size"], c["intermediate_size"], 32
    shapes = {"self_attn.q_proj": (4 * hd, h), "self_attn.k_proj": (2 * hd, h),
              "self_attn.v_proj": (2 * hd, h), "self_attn.o_proj": (h, 4 * hd),
              "mlp.gate_proj": (inter, h), "mlp.up_proj": (inter, h),
              "mlp.down_proj": (h, inter)}

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    state = {
        "model.embed_tokens.weight": bf16(rs.randn(c["vocab_size"], h)),
        "lm_head.weight": bf16(rs.randn(c["vocab_size"], h) * 0.2),
        "model.norm.weight": bf16(1 + 0.1 * rs.randn(h)),
    }
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        state[f"{p}.input_layernorm.weight"] = bf16(1 + 0.1 * rs.randn(h))
        state[f"{p}.post_attention_layernorm.weight"] = \
            bf16(1 + 0.1 * rs.randn(h))
        for frag, shape in shapes.items():
            state[f"{p}.{frag}.weight"] = bf16(rs.randn(*shape) * 0.08)
    return state


@pytest.fixture(scope="module")
def bin_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("llama-bin")
    (path / "config.json").write_text(json.dumps(CONFIG))
    torch.save(_tiny_llama_state(), path / "pytorch_model.bin")
    return str(path)


def _port_params(model_dir: str, load_format: str):
    cfg = EngineArgs(model=model_dir, load_format=load_format,
                     device="cpu", **ENGINE_KW).create_engine_configs()[0]
    return loader.get_model(cfg, torch.device("cpu"))[1]


def test_npcache_load_equals_the_pt_load(bin_checkpoint):
    want = _port_params(bin_checkpoint, "pt")
    got = _port_params(bin_checkpoint, "npcache")
    assert os.path.exists(os.path.join(bin_checkpoint, "np",
                                       "weight_names.json"))
    assert set(got) == set(want)
    for key, bucket in want.items():
        assert set(got[key]) == set(bucket), key
        for name, tensor in bucket.items():
            assert got[key][name].dtype == tensor.dtype == torch.float32
            assert torch.equal(got[key][name], tensor), (key, name)


def _generate(llm, sp_cls, **kw):
    outs = llm.generate(prompt_token_ids=[list(p) for p in PROMPTS],
                        sampling_params=sp_cls(temperature=0.0,
                                               max_tokens=8,
                                               ignore_eos=True, **kw))
    return [o.outputs[0] for o in outs]


def test_npcache_greedy_generation_matches_jax(bin_checkpoint,
                                               monkeypatch):
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    jax_llm = JaxLLM(model=bin_checkpoint, load_format="pt", **ENGINE_KW)
    port = LLM(model=bin_checkpoint, load_format="npcache", device="cpu",
               **ENGINE_KW)
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
