"""The port's QuIP# path (codebook, decompression, Hadamard transforms,
the two at-rest forms, config, engine) against the JAX package, on the
CPU.

- `packed_abs_grid` equal; `decompress_e8p` bit-equal on all 65536
  codes; `get_hadK` equal at 3, 7 and 12 and at Mistral-7B's widths
  (6144 = 3 * 2048, 14336 = 7 * 2048, 28672 = 7 * 4096); the FWHT and
  `matmul_hadU` within 1e-6 of max |y| (f32; the factor's einsum sums
  in another order).
- `load_weight`: checkpoint `Qidxs` renamed to `qweight` with its
  `lookup_table` sidecar where K16's gate takes the transform shape
  (equal to the JAX package's), else to the int8 `weight`.
- `QuipLinearMethod.apply` against the JAX `apply` (its CPU routes):
  within 1e-5 of max |y| in f32, the LUT form through K16's wrapper on
  f32 activations, the int8 form through plain torch (never K17).
- Greedy `LLM.generate` on the tiny Llama of tests/test_torch_squeezellm
  .py (hidden 256, intermediate 768: gate_up and down carry 3x3 Hadamard
  factors) with QuIP# weights made as chip_smoke.py makes them (random
  Qidxs through `quip_codes4_from_qidxs`, SU and SV +-1, Wscale 0.05,
  the factors of `get_hadK`), given to both engines: token-equal
  (compared while the port's top-2 logprob gap exceeds 1e-4), every
  projection of every step through K16 on f32 activations.
- Config: the int8 form (hidden 128) and the LUT form are served on the
  CPU and on the card.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.modeling.layers.quantization import quip as JQ
from aphrodite_tpu.ops.pallas import quant_matmul as jqm
from aphrodite_tpu_torch.modeling.layers.quantization import quip as TQ

from test_torch_squeezellm import (CONFIG, HIDDEN, INTER, _clean_env,
                                   _configs, _one_torch_thread,
                                   assert_greedy_equal, engine_pair, spy)

__all__ = ["_clean_env", "_one_torch_thread"]      # autouse fixtures


def test_packed_abs_grid_equals_jax():
    np.testing.assert_array_equal(TQ.packed_abs_grid(),
                                  JQ.packed_abs_grid())


def test_decompress_e8p_is_bit_equal_on_every_code():
    codes = np.arange(65536, dtype=np.int64).astype(np.uint16).view(
        np.int16).reshape(256, 256)
    got = TQ.decompress_e8p(codes)
    want = JQ.decompress_e8p(codes)
    assert got.shape == (256, 2048) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert sorted(set(np.round(got * 4).astype(int).ravel())) == \
        list(TQ.E8P_VALUES4)


@pytest.mark.parametrize("n", [3, 7, 12, 256, 768, 6144, 14336, 28672])
@pytest.mark.parametrize("use_rand", [True, False])
def test_get_hadK_equals_jax(n, use_rand):
    got = TQ.get_hadK(n, use_rand)
    want = JQ.get_hadK(n, use_rand)
    assert got[1:] == want[1:]
    if want[0] is None:
        assert got[0] is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert np.allclose(got[0] @ got[0].T, np.eye(got[1]), atol=1e-5)


@pytest.mark.parametrize("n,transpose", [(512, False), (768, False),
                                         (768, True)])
def test_matmul_hadU_equals_jax(n, transpose):
    rs = np.random.RandomState(n)
    x = rs.randn(5, n).astype(np.float32)
    had, k, _ = JQ.get_hadK(n)
    want = np.asarray(JQ.matmul_hadU(
        jnp.asarray(x), None if had is None else jnp.asarray(had), k, n,
        transpose=transpose))
    got = TQ.matmul_hadU(torch.from_numpy(x),
                         None if had is None else torch.from_numpy(had), k,
                         n, transpose=transpose).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(
        TQ.fwht(torch.from_numpy(x[:, :512])).numpy(),
        np.asarray(JQ.fwht(jnp.asarray(x[:, :512]))))


def _qidxs(rs, q_out, q_in):
    return rs.randint(-2 ** 15, 2 ** 15, (q_out, q_in // 8)).astype(np.int16)


@pytest.mark.parametrize("q_in,q_out,form", [(256, 384, "qweight"),
                                              (128, 256, "weight")])
def test_load_weight_renames_qidxs(q_in, q_out, form):
    qidxs = _qidxs(np.random.RandomState(q_in), q_out, q_in)
    jm = JQ.QuipLinearMethod(JQ.QuipConfig())
    tm = TQ.QuipLinearMethod(TQ.QuipConfig())
    want = jm.load_weight({}, "Qidxs", qidxs)
    got = tm.load_weight({}, "Qidxs", torch.from_numpy(qidxs))
    assert tm.pending_rename == jm.pending_rename == form
    np.testing.assert_array_equal(got.numpy(), want)
    if form == "qweight":
        assert got.dtype == torch.int32 and tuple(got.shape) == \
            (q_in // 8, q_out)
        lut = tm.pending_sidecar["lookup_table"]
        assert tuple(lut.shape) == (q_out, 16)
        np.testing.assert_array_equal(lut.numpy(),
                                      jm.pending_sidecar["lookup_table"])
    else:
        assert got.dtype == torch.int8 and tuple(got.shape) == (q_in, q_out)
        assert tm.pending_sidecar is None
    assert tm.load_weight({}, "SU", torch.ones(3)).shape == (3,)


def quip_params(rs, in_f, out_f, wscale=0.05):
    """A QuIP# layer as chip_smoke.py builds one: random Qidxs through
    the at-rest re-encoding, SU and SV +-1, Wscale, the get_hadK
    factors (numpy, the JAX package's layout)."""
    had_l, _, q_in = JQ.get_hadK(in_f)
    had_r, _, q_out = JQ.get_hadK(out_f)
    qidxs = _qidxs(rs, q_out, q_in)
    if jqm.squeezellm_supported(q_in, q_out):
        qweight, lut = JQ.quip_codes4_from_qidxs(qidxs)
        params = {"qweight": qweight, "lookup_table": lut}
    else:
        params = {"weight": JQ.quip_weight_from_qidxs(qidxs)}
    params.update(
        Wscale=np.float32(wscale),
        SU=rs.choice([-1.0, 1.0], in_f).astype(np.float32),
        SV=rs.choice([-1.0, 1.0], out_f).astype(np.float32))
    if had_l is not None:
        params["had_left"] = had_l
    if had_r is not None:
        params["had_right"] = had_r
    return params


@pytest.mark.parametrize("in_f,out_f,form", [(768, 1536, "lut"),
                                             (128, 384, "int8")])
def test_apply_matches_jax(monkeypatch, in_f, out_f, form):
    calls = spy(monkeypatch, TQ.qmm, ["squeezellm_matmul", "int8_matmul"])
    seen = []
    real = TQ.qmm.squeezellm_matmul
    monkeypatch.setattr(TQ.qmm, "squeezellm_matmul",
                        lambda x, *a: seen.append(x.dtype) or real(x, *a))
    rs = np.random.RandomState(in_f)
    params = quip_params(rs, in_f, out_f)
    assert ("qweight" in params) == (form == "lut")
    x = rs.randn(2, 3, in_f).astype(np.float32)
    want = np.asarray(JQ.QuipLinearMethod(JQ.QuipConfig()).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    got = TQ.QuipLinearMethod(TQ.QuipConfig()).apply(
        {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, out_f)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert calls["int8_matmul"] == 0
    assert seen == ([torch.float32] if form == "lut" else [])


def _model_dir(tmp_path, **changes):
    path = tmp_path / "m"
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(dict(CONFIG, **changes)))
    return str(path)


def _shared_weights(host):
    """Replace the JAX engine's dummy weights: QuIP# layers made by
    `quip_params`, unit norms, N(0, 1) embeddings and an N(0, 0.05) LM
    head."""
    rs = np.random.RandomState(5)
    out = {}
    for key, bucket in host.items():
        if "Wscale" in bucket:
            out[key] = quip_params(rs, bucket["SU"].shape[0],
                                   bucket["SV"].shape[0])
            assert {k: np.shape(v) for k, v in out[key].items()} == \
                {k: np.shape(v) for k, v in bucket.items()}, key
        elif key.endswith("layernorm") or key == "model.norm":
            out[key] = {"weight": np.ones_like(bucket["weight"])}
        else:
            scale = 0.05 if key == "lm_head" else 1.0
            out[key] = {"weight": (rs.randn(*bucket["weight"].shape) *
                                   scale).astype(np.float32)}
    return out


def test_greedy_generation_matches_jax(tmp_path, monkeypatch):
    calls = spy(monkeypatch, TQ.qmm, ["squeezellm_matmul", "int8_matmul"])
    jax_llm, port = engine_pair(_model_dir(tmp_path), "quip",
                                host_params=_shared_weights,
                                load_format="dummy")
    down = port.engine.executor.params["model.layers.0.mlp.down_proj"]
    assert tuple(down["had_left"].shape) == (3, 3)
    assert tuple(down["qweight"].shape) == (INTER // 8, HIDDEN)
    assert_greedy_equal(jax_llm, port)
    assert calls == {"squeezellm_matmul": 8 * 2 * 4, "int8_matmul": 0}


def test_config_on_the_cpu_and_on_the_card(tmp_path):
    """Hidden 256: every transform shape passes K16's gate, served on the
    CPU and on the card (in bfloat16 and float32: the matmuls run on f32
    activations). Hidden 128: q, k, v, o and gate_up take the int8 form,
    which was refused on the card until the fallback route served it;
    the test keeps its id and holds what replaced the refusal: that
    config builds on the CPU and on the card, in bfloat16 and float32,
    and its qkv transform shape is one K16's gate refuses."""
    wide = _model_dir(tmp_path)
    for device, dtype in (("cpu", "auto"), ("cuda", "bfloat16"),
                          ("cuda", "float32")):
        assert _configs(wide, device=device, dtype=dtype,
                        quantization="quip")[0].quantization == "quip"
    narrow = _model_dir(tmp_path / "narrow", hidden_size=128)
    for device, dtype in (("cpu", "auto"), ("cuda", "bfloat16"),
                          ("auto", "float32")):
        assert _configs(narrow, device=device, dtype=dtype,
                        quantization="quip")[0].quantization == "quip"
    assert not TQ.qmm.squeezellm_supported(TQ.get_hadK(128)[2],
                                           TQ.get_hadK(256)[2])


def test_dummy_weights(tmp_path):
    from aphrodite_tpu_torch.modeling.loader import get_model
    model_config = _configs(_model_dir(tmp_path), quantization="quip")[0]
    _, params = get_model(model_config, torch.device("cpu"))
    gate_up = params["model.layers.0.mlp.gate_up_proj"]
    assert {k: tuple(v.shape) for k, v in gate_up.items()} == {
        "qweight": (HIDDEN // 8, 2 * INTER), "lookup_table": (2 * INTER, 16),
        "Wscale": (), "SU": (HIDDEN,), "SV": (2 * INTER,),
        "had_right": (3, 3)}
    assert len(torch.unique(gate_up["qweight"])) > 1000
