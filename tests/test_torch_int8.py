"""The port's load-time int8 weights (config, quantize-at-load, merged
loading, layer, dummy weights, engine) against the JAX package, on the
CPU.

A float checkpoint of the tiny Llama of tests/test_torch_squeezellm.py
(hidden 256, intermediate 768, 4/2 heads of 64, 2 layers, weights
N(0, 0.05) from a seed) is served with quantization="int8": both
packages quantize it as it loads, per output channel.

- `load_weight`: int8 codes [in, out] and f32 scales bit-equal to the JAX
  package's, an all-zero channel at scale 1.
- Loading through the merged loaders: every parameter equals the JAX
  loader's (q, k and v, gate and up quantized shard by shard and placed
  along the output dim with their scales).
- `params_from_jax` transposes a floating 2-D `weight` only: an int8
  `weight` keeps [in, out], which K17 reads as [K, N].
- `Int8LinearMethod.apply` against the JAX `apply` (its CPU route,
  (x @ W) * scales): within 1e-5 of max |y| in f32, through K17's wrapper
  where its gate takes the shape.
- Dummy weights: the int8 `weight` stays zero in both packages.
- Greedy `LLM.generate` is token-equal to the JAX engine's (compared
  while the port's top-2 logprob gap exceeds 1e-4), every projection of
  every step through K17's wrapper.
- Config: served on the CPU and on the card, in bfloat16 and float32,
  at shapes K17's gate takes and at shapes it refuses (those layers, and
  every layer on a float32 card, take the JAX package's XLA route).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.modeling.layers.quantization import int8 as JI
from aphrodite_tpu_torch.modeling.convert import params_from_jax
from aphrodite_tpu_torch.modeling.layers.quantization import int8 as TI

from test_torch_squeezellm import (CONFIG, HIDDEN, INTER, _clean_env,
                                   _configs, _one_torch_thread,
                                   assert_greedy_equal, engine_pair, spy,
                                   write_checkpoint)

__all__ = ["_clean_env", "_one_torch_thread"]      # autouse fixtures


def dense_projection(rs, out_f, in_f):
    return {"weight": (rs.randn(out_f, in_f) * 0.05).astype(np.float32)}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("int8") / "m",
                            dense_projection)


def test_load_weight_matches_jax():
    rs = np.random.RandomState(0)
    w = (rs.randn(384, 256) * 0.05).astype(np.float32)
    w[7] = 0.0                                   # an all-zero channel
    jm = JI.Int8LinearMethod(JI.Int8Config())
    tm = TI.Int8LinearMethod(TI.Int8Config())
    want = jm.load_weight({}, "weight", w)
    got = tm.load_weight({}, "weight", torch.from_numpy(w))
    assert got.dtype == torch.int8 and tuple(got.shape) == (256, 384)
    np.testing.assert_array_equal(got.numpy(), want)
    scales = tm.pending_sidecar["scales"]
    assert scales.dtype == torch.float32
    np.testing.assert_array_equal(scales.numpy(),
                                  jm.pending_sidecar["scales"])
    assert scales[7] == 1.0
    # Other tensors (a bias) pass through.
    bias = torch.ones(384)
    assert tm.load_weight({}, "bias", bias) is bias


def test_loaded_params_equal_the_jax_loaders(checkpoint):
    jax_llm, port = engine_pair(checkpoint, "int8")
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
    assert qkv["weight"].dtype == torch.int8
    assert tuple(qkv["weight"].shape) == (HIDDEN, 512)
    assert tuple(qkv["scales"].shape) == (512,)
    assert tuple(got["model.layers.0.mlp.down_proj"]["weight"].shape) == \
        (INTER, HIDDEN)


def test_params_from_jax_transposes_only_floating_weights():
    """An int8 `weight` (the int8 method's, QuIP#'s int8 form) keeps
    [in, out]; a float one becomes torch's [out, in]. The converted int8
    layer gives the JAX layer's output."""
    rs = np.random.RandomState(1)
    q = rs.randint(-128, 128, (256, 384)).astype(np.int8)
    s = (rs.rand(384) * 0.01).astype(np.float32)
    dense = rs.randn(256, 128).astype(np.float32)
    got = params_from_jax({
        "model.layers.0.self_attn.qkv_proj": {"weight": q, "scales": s},
        "model.layers.0.mlp.down_proj": {"weight": dense}})
    np.testing.assert_array_equal(
        got["model.layers.0.self_attn.qkv_proj"]["weight"].numpy(), q)
    np.testing.assert_array_equal(
        got["model.layers.0.mlp.down_proj"]["weight"].numpy(), dense.T)
    x = rs.randn(3, 256).astype(np.float32)
    want = np.asarray(JI.Int8LinearMethod(JI.Int8Config()).apply(
        {"weight": jnp.asarray(q), "scales": jnp.asarray(s)},
        jnp.asarray(x)))
    y = TI.Int8LinearMethod(TI.Int8Config()).apply(
        got["model.layers.0.self_attn.qkv_proj"],
        torch.from_numpy(x)).numpy()
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("K,N", [(512, 256), (384, 256)],
                         ids=["k17", "gated"])
def test_apply_matches_jax(monkeypatch, K, N):
    calls = spy(monkeypatch, TI.qmm, ["int8_matmul"])
    rs = np.random.RandomState(K)
    params = {"weight": rs.randint(-128, 128, (K, N)).astype(np.int8),
              "scales": (rs.rand(N) * 0.01).astype(np.float32),
              "bias": rs.randn(N).astype(np.float32)}
    x = rs.randn(2, 3, K).astype(np.float32)
    want = np.asarray(JI.Int8LinearMethod(JI.Int8Config()).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    got = TI.Int8LinearMethod(TI.Int8Config()).apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, N)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert calls["int8_matmul"] == (1 if K % 256 == 0 else 0)


def test_dummy_int8_weights_stay_zero(checkpoint):
    from aphrodite_tpu_torch.modeling.loader import get_model
    _, params = get_model(_configs(checkpoint, quantization="int8")[0],
                          torch.device("cpu"))
    qkv = params["model.layers.0.self_attn.qkv_proj"]
    assert {k: (tuple(v.shape), v.dtype) for k, v in qkv.items()} == {
        "weight": ((HIDDEN, 512), torch.int8),
        "scales": ((512,), torch.float32)}
    assert not qkv["weight"].any()
    assert qkv["scales"].abs().max() > 0


def test_greedy_generation_matches_jax(checkpoint, monkeypatch):
    calls = spy(monkeypatch, TI.qmm, ["int8_matmul"])
    jax_llm, port = engine_pair(checkpoint, "int8")
    assert_greedy_equal(jax_llm, port)
    assert calls["int8_matmul"] == 8 * 2 * 4


def test_config_on_the_cpu_and_on_the_card(tmp_path, checkpoint):
    """float32 int8 on the card, and on the card a shape K17's gate
    refuses (hidden 384), were refused until the fallback route served
    them; the test keeps its id and holds what replaced the refusals:
    every one of these configs builds, on the CPU and on the card."""
    assert _configs(checkpoint, quantization="int8")[0].quantization == \
        "int8"
    for dtype in ("bfloat16", "float32"):
        assert _configs(checkpoint, device="cuda", dtype=dtype,
                        quantization="int8")[0].dtype == dtype
    narrow = tmp_path / "narrow"
    narrow.mkdir()
    (narrow / "config.json").write_text(json.dumps(dict(CONFIG,
                                                        hidden_size=384)))
    for device in ("cpu", "cuda", "auto"):
        assert _configs(str(narrow), device=device, dtype="bfloat16",
                        quantization="int8")[0].quantization == "int8"
    assert not TI.qmm.int8_supported(384, 768)
