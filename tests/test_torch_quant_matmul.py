"""Plain versions of the port's GPTQ and AWQ kernels
(`ops/cuda/quant_matmul.py`) against the JAX package's Pallas kernels run
with interpret=True on the CPU, as tests/kernels/test_quant_matmul.py and
test_stream_matmul.py run them. Inputs are made with numpy from a seed
and given to both sides.

- K9 (`quantize_activations_int8`), f32 and bf16 inputs: codes and row
  scales exactly equal to the JAX package's jnp reference chain (IEEE
  division); against the Pallas kernel, which divides by reciprocal
  multiplies in interpret mode, scales within 1 ulp and codes equal
  away from rounding ties.
- K6 (`gptq_matmul`, stream=False), bits 4 and 8, group 128 and 256,
  m 65 and 130; K7 (stream=True) a16 and a8 at m 1, 8 and 64, a8 with
  deferred rescale off and on; K8 (`gptq_matmul_a8`, stream=False)
  deferred off and on. The port's one plain version per function
  stands for every Pallas body (they differ in f32 summation order).
- AWQ: K10 (`awq_matmul`, stream=False; the Pallas wrapper moves z, s
  and the output columns through its plane-major order, the port
  does not), group 128 and 256, f32 and bf16; K7's AWQ layout
  (stream=True) a16 and a8 at m 1, 8 and 64, a8 deferred off and on;
  K11 (`awq_matmul_a8`, stream=False) deferred off and on, f32 and
  bf16, on the reference chain's int8 rows as for K8.

- GGUF: K13 (`gguf_q8_matmul`, a scale per 32 rows), K14
  (`gguf_i8g_matmul`, per 16 rows) and K15 (`gguf_w8a8_matmul`, K9 then
  int8 dots per 128-row group) at m 1, 8 and 130, (K, N) (256, 128) and
  (512, 384), f32 and bf16 x; K15 on the reference chain's int8 rows as
  for K8. The plain K15 alone on given int8 rows
  (`gguf_w8a8_launch_plain`) is the plain K9 + K15 bit for bit. The JAX
  gates `gguf_*_supported` are copied.

- K12 (`gguf_q4k_matmul`, Q4_K codes with affine dl/ml rows per 32
  rows), K16 (`squeezellm_matmul`, a 16-entry codebook per column; bf16
  and f32 x) and K17 (`int8_matmul`, int8 W times f32 column scales) at
  (K, N, m) (256, 128, 1), (512, 256, 8) and (1024, 256, 33), f32 and
  bf16 x. The plain versions compute on the natural row order; the
  Pallas wrappers permute x's columns for their plane-wise unpack. The
  JAX gates are copied.

Tolerances: in f32, |port - pallas| <= 1e-5 * max |pallas| (the same
products summed in another order); in bf16, one output ulp (both round
the same f32 sum to bf16, which may land on neighbouring values). The
GGUF cases hold every element to 1e-5 max |pallas| + 1e-5 |pallas|
(f32) and 1e-2 + 1e-2 |pallas| (bf16).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aphrodite_tpu.ops.pallas import quant_matmul as jqm
from aphrodite_tpu_torch.ops.cuda import quant_matmul as tqm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, bits, gs, K, N, m):
    rs = np.random.RandomState(seed)
    pack = 32 // bits
    return dict(
        x=rs.randn(m, K).astype(np.float32),
        qweight=rs.randint(-2 ** 31, 2 ** 31, (K // pack, N),
                           dtype=np.int64).astype(np.int32),
        qzeros=rs.randint(-2 ** 31, 2 ** 31, (K // gs, N // pack),
                          dtype=np.int64).astype(np.int32),
        scales=(rs.rand(K // gs, N) * 0.1 + 0.01).astype(np.float32))


def _both(arrays, dtype):
    """The same arrays as jnp (for Pallas) and torch (for the port), the
    floating ones in `dtype`."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    j = {k: jnp.asarray(v, dtype=jdt) if v.dtype == np.float32
         else jnp.asarray(v) for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(tdt) if v.dtype == np.float32
         else torch.from_numpy(v) for k, v in arrays.items()}
    return j, t


def _assert_close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "f32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        return
    # One bf16 ulp of the larger magnitude: 2^(floor(log2|v|) - 7).
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


def _activations(dtype):
    rs = np.random.RandomState(0)
    x = (rs.randn(37, 384) * 3).astype(np.float32)
    x[0, :7] = 0.5 * np.arange(7)         # ties round half to even
    x[1] = 0.0                            # the 1e-8 floor
    return _both({"x": x}, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activations_int8_plain_equals_the_reference_chain(dtype):
    """Exact against the JAX package's jnp chain
    (`_quantize_activations_int8`, its parity oracle): IEEE division,
    rounding half to even."""
    j, t = _activations(dtype)
    want8, wants = jqm._quantize_activations_int8(j["x"])
    got8, gots = tqm.quantize_activations_int8(t["x"])
    assert got8.dtype == torch.int8 and gots.shape == (37, 1)
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(gots.numpy(), np.asarray(wants))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activations_int8_plain_matches_pallas(dtype):
    """Against the Pallas kernel in interpret mode, which lowers both
    divisions as reciprocal multiplies: row scales within 1 ulp (the
    bound the JAX package's own test holds its kernel to), codes equal
    except where the IEEE quotient lies within 4 f32 ulps of a rounding
    tie, and there they differ by one."""
    j, t = _activations(dtype)
    want8, wants = jqm.quantize_activations_int8(j["x"], interpret=True)
    got8, gots = tqm.quantize_activations_int8(t["x"])
    np.testing.assert_allclose(gots.numpy(), np.asarray(wants), rtol=2e-7,
                               atol=0)
    quotient = t["x"].float().numpy() / gots.numpy()
    near_tie = np.abs(np.abs(quotient - np.trunc(quotient)) - 0.5) <= \
        4 * np.spacing(np.abs(quotient).astype(np.float32))
    diff = np.abs(got8.numpy().astype(int) - np.asarray(want8).astype(int))
    assert diff.max() <= 1
    assert (near_tie | (diff == 0)).all()


@pytest.mark.parametrize("bits,gs,m", [
    (4, 128, 65), (4, 256, 130), (8, 128, 130), (8, 256, 65)])
def test_k6_plain_matches_pallas(bits, gs, m):
    j, t = _both(_inputs(1, bits, gs, 2 * gs, 128, m), "f32")
    want = jqm.gptq_matmul(j["x"], j["qweight"], j["qzeros"], j["scales"],
                           bits=bits, group_size=gs, interpret=True,
                           stream=False)
    got = tqm.gptq_matmul(t["x"], t["qweight"], t["qzeros"], t["scales"],
                          bits=bits, group_size=gs, stream=False)
    _assert_close(got, want, "f32")


def test_k6_plain_matches_pallas_bf16():
    j, t = _both(_inputs(2, 4, 128, 256, 256, 65), "bf16")
    want = jqm.gptq_matmul(j["x"], j["qweight"], j["qzeros"], j["scales"],
                           bits=4, group_size=128, interpret=True,
                           stream=False)
    got = tqm.gptq_matmul(t["x"], t["qweight"], t["qzeros"], t["scales"],
                          bits=4, group_size=128)
    _assert_close(got, want, "bf16")


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("arm", ["a16", "a8", "a8-deferred"])
def test_k7_plain_matches_streamed_pallas(m, arm):
    j, t = _both(_inputs(3 + m, 4, 128, 384, 128, m), "f32")
    args_j = (j["x"], j["qweight"], j["qzeros"], j["scales"])
    args_t = (t["x"], t["qweight"], t["qzeros"], t["scales"])
    if arm == "a16":
        want = jqm.gptq_matmul(*args_j, bits=4, group_size=128,
                               interpret=True, stream=True)
        got = tqm.gptq_matmul(*args_t, bits=4, group_size=128, stream=True)
    else:
        deferred = arm == "a8-deferred"
        want = jqm.gptq_matmul_a8(*args_j, bits=4, group_size=128,
                                  interpret=True, stream=True,
                                  deferred=deferred)
        got = tqm.gptq_matmul_a8(*args_t, bits=4, group_size=128,
                                 stream=True, deferred=deferred)
    _assert_close(got, want, "f32")


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k8_plain_matches_pallas(deferred, dtype, monkeypatch):
    """Both sides take the same int8 codes: the Pallas wrapper is given
    the reference chain's codes, computed eagerly, in place of its
    quantize kernel (whose divide, like XLA's fused divide inside a jit,
    is a reciprocal multiply that flips codes at rounding ties, see the
    test above); they equal the port's. So this compares the two matmul
    bodies alone."""
    j, t = _both(_inputs(4, 4, 128, 512, 128, 80), dtype)
    x8, xs = jqm._quantize_activations_int8(j["x"])
    p8, ps = tqm.quantize_activations_int8(t["x"])
    np.testing.assert_array_equal(np.asarray(x8), p8.numpy())
    np.testing.assert_array_equal(np.asarray(xs), ps.numpy())
    monkeypatch.setattr(jqm, "quantize_activations_int8",
                        lambda x, interpret=False: (x8, xs))
    jqm.gptq_matmul_a8.clear_cache()
    want = jqm.gptq_matmul_a8(j["x"], j["qweight"], j["qzeros"],
                              j["scales"], bits=4, group_size=128,
                              interpret=True, stream=False,
                              deferred=deferred)
    got = tqm.gptq_matmul_a8(t["x"], t["qweight"], t["qzeros"], t["scales"],
                             bits=4, group_size=128, stream=False,
                             deferred=deferred)
    jqm.gptq_matmul_a8.clear_cache()
    _assert_close(got, want, dtype)


def test_plain_w4a8_refuses_8_bit_codes():
    t = {k: torch.from_numpy(v) for k, v in
         _inputs(5, 8, 128, 128, 128, 2).items()}
    with pytest.raises(ValueError, match="4-bit"):
        tqm.gptq_matmul_a8(t["x"], t["qweight"], t["qzeros"], t["scales"],
                           bits=8, group_size=128)


def test_gptq_supported_gate_matches_jax():
    for args in [(4096, 14336, 4, 128, False), (4096, 4096, 8, 128, False),
                 (4096, 14336, 4, 128, True), (4096, 14336, 2, 128, False),
                 (4000, 14336, 4, 128, False), (4096, 14300, 4, 128, False),
                 (256, 256, 4, -1, False), (64, 256, 4, 128, False)]:
        assert tqm.gptq_supported(*args) == jqm.gptq_supported(*args), args


# --------------------------------------------------------------- AWQ --

def _awq_inputs(seed, gs, K, N, m):
    """As tests/kernels/test_quant_matmul.py's `make_awq_inputs`."""
    rs = np.random.RandomState(seed)
    return dict(
        x=rs.randn(m, K).astype(np.float32),
        qweight=rs.randint(-2 ** 31, 2 ** 31, (K, N // 8),
                           dtype=np.int64).astype(np.int32),
        qzeros=rs.randint(-2 ** 31, 2 ** 31, (K // gs, N // 8),
                          dtype=np.int64).astype(np.int32),
        scales=(rs.rand(K // gs, N) * 0.1 + 0.01).astype(np.float32))


def _awq_args(d):
    return d["x"], d["qweight"], d["qzeros"], d["scales"]


@pytest.mark.parametrize("gs,K,N,m", [
    (128, 256, 1024, 65), (256, 512, 1024, 130), (128, 128, 2048, 80)])
def test_k10_plain_matches_pallas(gs, K, N, m):
    j, t = _both(_awq_inputs(10 + m, gs, K, N, m), "f32")
    want = jqm.awq_matmul(*_awq_args(j), group_size=gs, interpret=True,
                          stream=False)
    got = tqm.awq_matmul(*_awq_args(t), group_size=gs, stream=False)
    _assert_close(got, want, "f32")


def test_k10_plain_matches_pallas_bf16():
    j, t = _both(_awq_inputs(11, 128, 256, 1024, 70), "bf16")
    want = jqm.awq_matmul(*_awq_args(j), group_size=128, interpret=True,
                          stream=False)
    got = tqm.awq_matmul(*_awq_args(t), group_size=128)
    _assert_close(got, want, "bf16")


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("arm", ["a16", "a8", "a8-deferred"])
def test_k7_awq_plain_matches_streamed_pallas(m, arm):
    j, t = _both(_awq_inputs(20 + m, 128, 384, 1024, m), "f32")
    if arm == "a16":
        want = jqm.awq_matmul(*_awq_args(j), group_size=128,
                              interpret=True, stream=True)
        got = tqm.awq_matmul(*_awq_args(t), group_size=128, stream=True)
    else:
        deferred = arm == "a8-deferred"
        want = jqm.awq_matmul_a8(*_awq_args(j), group_size=128,
                                 interpret=True, stream=True,
                                 deferred=deferred)
        got = tqm.awq_matmul_a8(*_awq_args(t), group_size=128, stream=True,
                                deferred=deferred)
    _assert_close(got, want, "f32")


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k11_plain_matches_pallas(deferred, dtype, monkeypatch):
    """Both sides on the same int8 rows, as test_k8_plain_matches_pallas
    does: the Pallas wrapper is given the reference chain's codes."""
    j, t = _both(_awq_inputs(30, 128, 512, 1024, 80), dtype)
    x8, xs = jqm._quantize_activations_int8(j["x"])
    p8, ps = tqm.quantize_activations_int8(t["x"])
    np.testing.assert_array_equal(np.asarray(x8), p8.numpy())
    np.testing.assert_array_equal(np.asarray(xs), ps.numpy())
    monkeypatch.setattr(jqm, "quantize_activations_int8",
                        lambda x, interpret=False: (x8, xs))
    jqm.awq_matmul_a8.clear_cache()
    want = jqm.awq_matmul_a8(*_awq_args(j), group_size=128, interpret=True,
                             stream=False, deferred=deferred)
    got = tqm.awq_matmul_a8(*_awq_args(t), group_size=128, stream=False,
                            deferred=deferred)
    jqm.awq_matmul_a8.clear_cache()
    _assert_close(got, want, dtype)


def test_awq_dequantize_plain_matches_jax_unpack():
    """The natural-order unpack and w = (q - z) * s (no +1) equal the JAX
    package's AWQ `dequantize`, bit for bit in f32."""
    from aphrodite_tpu.modeling.layers.quantization.awq import (
        AWQConfig, AWQLinearMethod)
    d = _awq_inputs(40, 128, 256, 1024, 1)
    want = AWQLinearMethod(AWQConfig(4, 128)).dequantize(
        {k: jnp.asarray(v) for k, v in d.items() if k != "x"}, jnp.float32)
    got = tqm.dequantize_awq_plain(
        torch.from_numpy(d["qweight"]), torch.from_numpy(d["qzeros"]),
        torch.from_numpy(d["scales"]), group_size=128, dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_awq_supported_gate_matches_jax():
    for args in [(4096, 28672, 128), (14336, 4096, 128), (4096, 6144, 128),
                 (4000, 4096, 128), (4096, 4608, 128), (4096, 4096, 64),
                 (4096, 4096, 2048), (2048, 1024, 1024)]:
        assert tqm.awq_supported(*args) == jqm.awq_supported(*args), args


# -------------------------------------------------------------- GGUF --

GGUF_KERNELS = {"q8": ("gguf_q8_matmul", 32), "i8g": ("gguf_i8g_matmul", 16),
                "w8a8": ("gguf_w8a8_matmul", 128)}


def _gguf_inputs(seed, kind, K, N, m):
    """int8 codes and scale rows as the JAX at-rest tests draw them (K15's
    codes symmetric, in [-127, 127])."""
    rs = np.random.RandomState(seed)
    G = GGUF_KERNELS[kind][1]
    lo = -127 if kind == "w8a8" else -128
    return dict(x=rs.randn(m, K).astype(np.float32),
                qs=rs.randint(lo, 128, (K, N)).astype(np.int8),
                scales=(rs.rand(K // G, N) * 0.01 + 1e-3).astype(np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K,N", [(256, 128), (512, 384)])
@pytest.mark.parametrize("m", [1, 8, 130])
@pytest.mark.parametrize("kind", ["q8", "i8g", "w8a8"])
def test_gguf_plain_matches_pallas(kind, m, K, N, dtype, monkeypatch):
    name, _ = GGUF_KERNELS[kind]
    j, t = _both(_gguf_inputs(K + N + m, kind, K, N, m), dtype)
    if kind == "w8a8":
        # Both sides on the reference chain's int8 rows, as for K8.
        x8, xs = jqm._quantize_activations_int8(j["x"])
        p8, ps = tqm.quantize_activations_int8(t["x"])
        np.testing.assert_array_equal(np.asarray(x8), p8.numpy())
        np.testing.assert_array_equal(np.asarray(xs), ps.numpy())
        monkeypatch.setattr(jqm, "quantize_activations_int8",
                            lambda x, interpret=False: (x8, xs))
    getattr(jqm, name).clear_cache()
    want = getattr(jqm, name)(j["x"], j["qs"], j["scales"], interpret=True)
    getattr(jqm, name).clear_cache()
    got = getattr(tqm, name)(t["x"], t["qs"], t["scales"])
    plain = getattr(tqm, name + "_plain")(t["x"], t["qs"], t["scales"])
    assert torch.equal(got, plain)         # CPU tensors: the plain version
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape == (m, N)
    # f32: sums of up to 512 products of magnitude ~1 in another order
    # differ by a few 1e-5 where outputs cancel; bf16: an output ulp.
    atol = 1e-5 * np.abs(want).max() if dtype == "f32" else 1e-2
    rtol = 1e-5 if dtype == "f32" else 1e-2
    assert (np.abs(got - want) <= atol + rtol * np.abs(want)).all(), \
        np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k15_alone_on_k9_rows_equals_the_wrapper(dtype):
    """The plain K15 alone (`gguf_w8a8_launch_plain`) on the plain K9's
    rows is the plain K9 + K15 bit for bit; `gguf_w8a8_launch` on CPU
    tensors is that plain version (bf16 out)."""
    _, t = _both(_gguf_inputs(7, "w8a8", 512, 384, 9), dtype)
    x8, xs = tqm.quantize_activations_int8(t["x"])
    want = tqm.gguf_w8a8_matmul_plain(t["x"], t["qs"], t["scales"])
    got = tqm.gguf_w8a8_launch_plain(x8, xs, t["qs"], t["scales"],
                                     t["x"].dtype)
    assert got.dtype == t["x"].dtype and torch.equal(got, want)
    assert torch.equal(
        tqm.gguf_w8a8_launch(x8, xs, t["qs"], t["scales"]),
        tqm.gguf_w8a8_launch_plain(x8, xs, t["qs"], t["scales"]))


def test_gguf_supported_gates_match_jax():
    for kind in ("q8", "i8g", "w8a8"):
        gate = f"gguf_{kind}_supported"
        for args in [(4096, 6144), (14336, 4096), (4096, 28672), (384, 128),
                     (256, 192), (128, 256), (640, 128)]:
            assert getattr(tqm, gate)(*args) == getattr(jqm, gate)(*args), \
                (gate, args)


# ------------------------------------------------- K12, K16 and K17 --

PACKED4 = {"q4k": ("gguf_q4k_matmul", ("qweight", "dl", "ml")),
           "sqllm": ("squeezellm_matmul", ("qweight", "lut")),
           "int8": ("int8_matmul", ("weight", "scales"))}


def _packed4_inputs(seed, kind, K, N, m):
    rs = np.random.RandomState(seed)
    arrays = {"x": rs.randn(m, K).astype(np.float32)}
    if kind == "int8":
        arrays["weight"] = rs.randint(-128, 128, (K, N)).astype(np.int8)
        arrays["scales"] = (rs.rand(N) * 0.01 + 1e-3).astype(np.float32)
        return arrays
    arrays["qweight"] = rs.randint(-2 ** 31, 2 ** 31, (K // 8, N),
                                   dtype=np.int64).astype(np.int32)
    if kind == "q4k":
        arrays["dl"] = (rs.rand(K // 32, N) * 0.01 + 1e-3).astype(np.float32)
        arrays["ml"] = (rs.rand(K // 32, N) * 0.05).astype(np.float32)
    else:
        arrays["lut"] = (rs.randn(N, 16) * 0.05).astype(np.float32)
    return arrays


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K,N,m", [(256, 128, 1), (512, 256, 8),
                                   (1024, 256, 33), (512, 256, 130)])
@pytest.mark.parametrize("kind", list(PACKED4))
def test_k12_k16_k17_plain_match_pallas(kind, K, N, m, dtype):
    name, args = PACKED4[kind]
    arrays = _packed4_inputs(K + N + m, kind, K, N, m)
    j, t = _both(arrays, dtype)
    if kind == "int8":                   # K17's scales stay f32
        j["scales"] = jnp.asarray(arrays["scales"])
        t["scales"] = torch.from_numpy(arrays["scales"])
    fn = getattr(jqm, name)
    fn.clear_cache()
    want = fn(j["x"], *(j[a] for a in args), interpret=True)
    fn.clear_cache()
    got = getattr(tqm, name)(t["x"], *(t[a] for a in args))
    plain = getattr(tqm, name + "_plain")(t["x"], *(t[a] for a in args))
    assert torch.equal(got, plain)         # CPU tensors: the plain version
    assert got.dtype == t["x"].dtype
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape == (m, N)
    # f32: the same products summed in another order; bf16: both round
    # the f32 sum to bf16, which may land on neighbouring values.
    atol = 1e-5 * np.abs(want).max() if dtype == "f32" else 2e-2
    rtol = 1e-5 if dtype == "f32" else 2e-2
    assert (np.abs(got - want) <= atol + rtol * np.abs(want)).all(), \
        np.abs(got - want).max()


def test_k12_k16_k17_gates_match_jax():
    for gate in ("gguf_q4k_supported", "squeezellm_supported",
                 "int8_supported"):
        for args in [(4096, 6144), (14336, 4096), (4096, 28672), (384, 128),
                     (256, 192), (128, 256), (768, 1536)]:
            assert getattr(tqm, gate)(*args) == getattr(jqm, gate)(*args), \
                (gate, args)


# K6 / K10's plan (`gemm_plan`): 128 x 256 output tiles; where they fall
# short of the SMs, the quantization groups split into contiguous runs.
# Rows at Mistral-7B's widths, group 128 (K 4096: 32 groups; K 14336:
# 112), on 132 SMs (H100 SXM) and 114 (H100 PCIe).
@pytest.mark.parametrize("m,K,N,sms,want", [
    (65, 4096, 4096, 132, (8, 4)),      # 16 tiles: 132 // 16 = 8 splits
    (96, 4096, 6144, 132, (5, 7)),      # 24 tiles: 5 wanted, runs of 7
    (128, 4096, 28672, 132, (1, 32)),   # 112 tiles cover the SMs
    (96, 14336, 4096, 132, (8, 14)),
    (512, 4096, 4096, 132, (2, 16)),    # 4 row tiles x 16
    (512, 4096, 6144, 132, (1, 32)),
    (4096, 4096, 28672, 132, (1, 32)),
    (4096, 14336, 4096, 132, (1, 112)),
    (65, 4096, 4096, 114, (7, 5)),      # 7 wanted: runs of 5, 7 splits
    (96, 4096, 6144, 114, (4, 8)),
    (128, 14336, 4096, 114, (7, 16)),
    (512, 4096, 4096, 114, (1, 32)),    # 64 tiles: 114 // 64 = 1
    (4096, 4096, 6144, 114, (1, 32)),
])
def test_gemm_plan_table(m, K, N, sms, want):
    assert tqm.gemm_plan(m, K, N, 128, sms) == want


@pytest.mark.parametrize("sms", [132, 114])
def test_gemm_plan_splits_start_on_groups_and_none_is_empty(sms):
    for m in (65, 72, 96, 128, 129, 257, 512, 1000, 4096):
        for K, N in ((4096, 6144), (4096, 4096), (4096, 28672),
                     (14336, 4096), (3200, 4096), (2048, 384)):
            for gs in (128, 200, 1024):
                if K % gs:
                    continue
                groups = K // gs
                splits, per = tqm.gemm_plan(m, K, N, gs, sms)
                # Split s covers groups [s * per, min(groups, (s+1) * per)).
                starts = [s * per for s in range(splits)]
                assert starts[-1] < groups and splits * per >= groups
                tiles = -(-m // 128) * -(-N // 256)
                assert splits <= max(1, sms // tiles)
                # Shapes and the SM count alone decide it.
                assert tqm.gemm_plan(m, K, N, gs, sms) == (splits, per)


# K12's, K13's and K14's plans at m > 64 (`gemm_plan` over 64-row chunks,
# 128 x 256 tiles) and K15's (over 128-row groups, 128 x 128 tiles), on
# 132 SMs.
@pytest.mark.parametrize("m,K,N,unit,block_n,want", [
    (65, 4096, 4096, 64, 256, (8, 8)),      # 16 tiles: 8 splits of 8 chunks
    (72, 4096, 6144, 64, 256, (5, 13)),
    (128, 14336, 4096, 64, 256, (8, 28)),
    (256, 4096, 4096, 64, 256, (4, 16)),
    (4096, 14336, 4096, 64, 256, (1, 224)),
    (65, 4096, 4096, 128, 128, (4, 8)),     # 32 tiles: 4 splits of 8 groups
    (72, 4096, 6144, 128, 128, (2, 16)),
    (128, 4096, 28672, 128, 128, (1, 32)),  # 224 tiles cover the SMs
    (256, 14336, 4096, 128, 128, (2, 56)),
    (4096, 4096, 4096, 128, 128, (1, 32)),
    # K12 and K13 (K14's unit and tile) at the rest of Mistral-7B's shapes.
    (65, 4096, 6144, 64, 256, (5, 13)),     # 24 tiles: 5 splits of 13
    (96, 4096, 28672, 64, 256, (1, 64)),    # 112 tiles: no split
    (129, 14336, 4096, 64, 256, (4, 56)),   # 2 row tiles x 16
    (200, 4096, 4096, 64, 256, (4, 16)),
    (512, 4096, 6144, 64, 256, (1, 64)),
    (4096, 4096, 28672, 64, 256, (1, 64)),
])
def test_gguf_gemm_plan_table(m, K, N, unit, block_n, want):
    assert tqm.gemm_plan(m, K, N, unit, 132, block_n=block_n) == want


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("kernel", ["k12", "k13", "k14", "k15", "k16",
                                    "k16f32", "k17"])
def test_gguf_gemm_plan_splits_start_on_a_unit_and_fit_the_sms(kernel, sms):
    """Every split starts on a 64-row chunk (K12-K14, K16, K17) or a
    128-row scale group (K15), none is empty, and where the plan splits,
    tiles x splits stays within the SMs (K16 on f32 x: 128 x 128
    tiles)."""
    unit, block_n = (128, 128) if kernel == "k15" else \
        (64, 128) if kernel == "k16f32" else (64, 256)
    for m in (65, 72, 96, 128, 129, 200, 256, 257, 512, 1000, 4096):
        for K, N in ((4096, 6144), (4096, 4096), (4096, 28672),
                     (14336, 4096), (2048, 384), (256, 128)):
            units = K // unit
            splits, per = tqm.gemm_plan(m, K, N, unit, sms, block_n=block_n)
            # Split s covers rows [s * per * unit, ...): a whole unit each.
            starts = [s * per for s in range(splits)]
            assert starts[-1] < units and splits * per >= units
            tiles = -(-m // 128) * -(-N // block_n)
            assert splits == 1 or tiles * splits <= sms
            assert tqm.gemm_plan(m, K, N, unit, sms, block_n=block_n) == \
                (splits, per)


# K8's and K11's plan (`a8_gemm_plan`): 128 x 128 tiles over 128-row
# chunks, each group of gs rows cut into ceil(gs / 128) of them; gs K is
# GPTQ's group_size -1. On 132 SMs (H100 SXM) and 114 (H100 PCIe).
@pytest.mark.parametrize("m,K,N,gs,sms,want", [
    (72, 4096, 4096, 128, 132, (4, 8)),      # 32 tiles: 4 splits of 8
    (72, 4096, 6144, 128, 132, (2, 16)),
    (72, 4096, 28672, 128, 132, (1, 32)),    # 224 tiles cover the SMs
    (72, 14336, 4096, 128, 132, (4, 28)),
    (72, 4096, 4096, 4096, 132, (4, 8)),     # one group, split as 128s
    (72, 14336, 4096, 14336, 132, (4, 28)),
    (65, 4096, 4096, 1024, 132, (4, 8)),     # groups of 8 chunks
    (96, 4096, 6144, 1024, 132, (2, 16)),
    (128, 4096, 4096, 128, 132, (4, 8)),
    (512, 4096, 4096, 128, 132, (1, 32)),    # 128 tiles
    (512, 14336, 4096, 14336, 132, (1, 112)),
    (4096, 4096, 28672, 128, 132, (1, 32)),
    (130, 3200, 4096, 200, 132, (2, 16)),    # groups of 200: 2 chunks each
    (72, 4096, 4096, 128, 114, (3, 11)),     # 3 wanted: runs of 11
    (72, 14336, 4096, 14336, 114, (3, 38)),
    (96, 4096, 6144, 128, 114, (2, 16)),
    (512, 4096, 4096, 1024, 114, (1, 32)),
])
def test_a8_gemm_plan_table(m, K, N, gs, sms, want):
    assert tqm.a8_gemm_plan(m, K, N, gs, sms) == want


def _a8_chunk_walk(K, gs, per, split):
    """`w8a8_gemm_kernel`'s chunk bookkeeping for one split of a K8 / K11
    launch: [(group, first row, real rows, opens a fold unit)] for each of
    its chunks, as the kernel's `chunk` and `opens` compute them (a new
    s32 set where a group starts, and every 64 chunks of a longer
    group)."""
    cpg = -(-gs // 128)
    chunks = K // gs * cpg
    c_begin = split * per
    walk = []
    for t in range(max(0, min(chunks, c_begin + per) - c_begin)):
        c = c_begin + t
        g = c // cpg
        r = (c - g * cpg) * 128
        walk.append((g, g * gs + r, min(128, gs - r),
                     t == 0 or c % cpg % 64 == 0))
    return walk


@pytest.mark.parametrize("sms", [132, 114])
def test_a8_gemm_plan_splits_start_on_a_chunk_and_fold_each_group(sms):
    """At m 65-4096, Mistral-7B's four projections and groups of 128,
    1024 and K rows (group_size -1): every split starts on a 128-row
    chunk and none is empty; where the plan splits, tiles x splits stays
    within the SMs; one group of K rows splits at m 72; the plan depends
    on shapes and the SM count alone. The kernel's chunk walk over those
    splits takes each row of K once, in its own group, and a split folds
    each group it touches in group order: once, or (groups past 8192
    rows) once per run of at most 8192 of its rows, so that every dot
    stays below 2^24 (|dot| <= 8192 * 127 * 16), where its conversion to
    f32 is exact."""
    for m in (65, 72, 96, 128, 512, 4096):
        for K, N in ((4096, 6144), (4096, 4096), (4096, 28672),
                     (14336, 4096)):
            for gs in (128, 1024, K):
                splits, per = tqm.a8_gemm_plan(m, K, N, gs, sms)
                chunks = K // gs * -(-gs // 128)
                assert (splits - 1) * per < chunks <= splits * per
                tiles = -(-m // 128) * (N // 128)
                assert splits == 1 or tiles * splits <= sms
                if gs == K and m == 72 and N == 4096:
                    assert splits > 1
                assert tqm.a8_gemm_plan(m, K, N, gs, sms) == (splits, per)
                rows = []
                for split in range(splits):
                    walk = _a8_chunk_walk(K, gs, per, split)
                    assert walk and walk[0][1] % 128 == 0
                    units = []                # [(group, rows)] per fold
                    for g, _, kn, opens in walk:
                        if opens:
                            units.append([g, 0])
                        assert units[-1][0] == g
                        units[-1][1] += kn
                    groups = [g for g, _ in units]
                    assert groups == sorted(groups)
                    assert all(n <= 8192 for _, n in units)
                    if gs <= 8192:
                        assert len(set(groups)) == len(groups)
                    assert 8192 * 127 * 16 < 2 ** 24
                    for g, k0, kn, _ in walk:
                        assert 0 < kn <= 128
                        assert all(k // gs == g for k in (k0, k0 + kn - 1))
                        rows.extend(range(k0, k0 + kn))
                assert rows == list(range(K))


def test_a8_gemm_walk_cuts_odd_groups_into_short_chunks():
    """Groups of 200 (AWQ's K 3200) and 136 rows: a group's last chunk is
    short (72 and 8 rows real), every row once in its group."""
    for K, gs in ((3200, 200), (4080, 136)):
        for m in (72, 130, 513):
            splits, per = tqm.a8_gemm_plan(m, K, 4096, gs, 132)
            walk = [w for s in range(splits)
                    for w in _a8_chunk_walk(K, gs, per, s)]
            assert [kn for _, _, kn, _ in walk] == \
                [128, gs - 128] * (K // gs)
            assert [k for _, k0, kn, _ in walk
                    for k in range(k0, k0 + kn)] == list(range(K))


def _tiling_at_132(m, K, N, gs):
    """K15's route and plan at m on a card of 132 SMs (H100 SXM), as its
    wrapper takes them (they replace the skinny tiles' `_tiling`): up to
    `K15_STREAM_M_MAX` rows quant_stream_kernel's a8 arm, `stream_plan`
    over gs-row groups of 8-bit codes and int8 x; above, w8a8_gemm_kernel,
    128 rows and `gemm_plan`'s splits of the groups over 128 x 128
    tiles."""
    if m <= tqm.K15_STREAM_M_MAX:
        return tqm.stream_plan(m, K, N, gs, 132, 8, 1)
    return 128, tqm.gemm_plan(m, K, N, gs, 132, block_n=128)[0]


def test_tiling_reads_the_sm_count(monkeypatch):
    """K15's launch as `gguf_w8a8_launch` makes it, as if its tensors
    were on a card: at 132 SMs every plan at Mistral-7B's projections and
    m 1-64 is `_tiling_at_132`'s, the stream route's splits whole runs of
    128-row groups, none empty; the SM count is read from x8's device
    (build.sm_count), and on a card of 66 SMs the plan follows that
    count, so some plans move; the stream route refuses m 65."""
    calls, asked = [], []
    sms = [132]
    monkeypatch.setattr(tqm.build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(tqm.build, "sm_count",
                        lambda dev: asked.append(dev) or sms[0])
    monkeypatch.setattr(
        tqm, "_entry_launch",
        lambda entry, x, ptrs, N, block_m, splits, out_dtype, *, counter,
        what: calls.append((entry, block_m, splits)))
    moved = 0
    for K, N in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        x8 = torch.zeros(64, K, dtype=torch.int8)
        xs = torch.ones(64, 1)
        qs8 = torch.zeros(K, N, dtype=torch.int8)
        s128 = torch.ones(K // 128, N, dtype=torch.bfloat16)
        for m in range(1, 65):
            want = _tiling_at_132(m, K, N, 128)
            sms[0] = 132
            tqm.gguf_w8a8_launch(x8[:m], xs[:m], qs8, s128)
            assert calls.pop() == ("gguf_w8a8_mm",) + want, (K, N, m)
            assert asked.pop() == x8.device
            block_m, splits = want
            if m <= tqm.K15_STREAM_M_MAX:
                units = K // 128
                per = -(-units // splits)
                assert block_m in (8, 16) and -(-units // per) == splits
            sms[0] = 66
            tqm.gguf_w8a8_launch(x8[:m], xs[:m], qs8, s128)
            on66 = calls.pop()[1:]
            assert on66 == (tqm.stream_plan(m, K, N, 128, 66, 8, 1)
                            if m <= tqm.K15_STREAM_M_MAX else
                            (128, tqm.gemm_plan(m, K, N, 128, 66,
                                                block_n=128)[0]))
            moved += on66 != want
    assert moved > 0 and not calls
    with pytest.raises(ValueError, match="m <= 64"):
        tqm.stream_plan(65, 4096, 4096, 128, 132, 8, 1)


def _bf16_sweep(lo_exp: int, hi_exp: int) -> np.ndarray:
    """Every positive normal bf16 value with a binary exponent in [lo_exp,
    hi_exp], as float64 (128 mantissas per exponent)."""
    bits = np.arange(0x0080, 0x7F80, dtype=np.uint32)
    v = (bits << 16).view(np.float32).astype(np.float64)
    e = np.floor(np.log2(v))
    return v[(e >= lo_exp) & (e <= hi_exp)]


def _two_sum_err(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The rounding error of a + b in float64 (Knuth's TwoSum): zero where
    the float64 sum is exact."""
    s = a + b
    bb = s - a
    return (a - (s - bb)) + (b - bb)


def test_k12_decoder_fma_rounds_as_the_plain_version():
    """K12's m > 64 decoder writes bf16(fma(q, dl, -ml)) in f32, where the
    plain version (and the Pallas body) rounds q * dl, subtracts ml and
    rounds, then rounds to bf16. For every code 0-15 and every bf16 dl of
    33 binades q * dl is exact in f32 (4 by 8 significant bits), so both
    round the exact difference, taken in float64 (checked exact), once to
    f32: the same value, and the same bf16. The plain version's own
    dequantization gives that bf16 too."""
    dl = _bf16_sweep(-24, 8)
    rs = np.random.RandomState(12)
    ml = np.concatenate([[0.0], rs.choice(dl, 31), -rs.choice(dl, 16)])
    q = np.arange(16, dtype=np.float64)
    prod = q[:, None] * dl[None, :]
    assert np.array_equal(prod.astype(np.float32).astype(np.float64), prod)
    prod = prod[:, :, None]
    exact = prod - ml
    assert not _two_sum_err(prod, -ml).any()
    fma32 = exact.astype(np.float32)               # one rounding
    f32 = np.float32
    twice = (q.astype(f32)[:, None, None] * dl.astype(f32)[None, :, None]) \
        - ml.astype(f32)                           # mul, then sub
    assert np.array_equal(fma32, twice)
    # One rounding straight to bf16 (what a bf16 fma would give) differs
    # from these two on the sweep, so the decoder keeps the f32 step.
    mant, exp = np.frexp(exact)
    once = np.ldexp(np.round(mant * 256), exp - 8)
    assert (once != torch.from_numpy(fma32).to(torch.bfloat16).double()
            .numpy()).any()
    # The plain version on a layout that holds codes 0-15 (rows k % 16)
    # in every column: columns sweep dl, 32-row groups sweep ml.
    n = 1024
    cols = np.linspace(0, dl.size - 1, n).astype(np.int64)
    groups = ml.size
    codes = np.tile(np.arange(16, dtype=np.int64), 2 * groups)
    words = np.zeros(codes.size // 8, dtype=np.int64)
    for p in range(8):
        words |= codes[p::8] << (4 * p)
    qweight = torch.from_numpy(np.repeat(
        words.astype(np.uint32).view(np.int32)[:, None], n, axis=1))
    dl_t = torch.from_numpy(np.repeat(dl[cols][None, :], groups, 0)).to(
        torch.bfloat16)
    ml_t = torch.from_numpy(np.repeat(ml[:, None], n, 1)).to(torch.bfloat16)
    assert torch.equal(dl_t.double(), torch.from_numpy(
        np.repeat(dl[cols][None, :], groups, 0)))   # bf16 values, exact
    w = tqm.gguf_q4k_dequantize_plain(qweight, dl_t, ml_t, torch.bfloat16)
    rows = np.arange(codes.size)[:, None]
    want = torch.from_numpy(fma32[codes[:, None], cols[None, :], rows // 32])
    assert torch.equal(w, want.to(torch.bfloat16))


def test_byte_decoder_fma_is_exact():
    """K13's and K14's m > 64 decoder writes bf16(fma(2^23 + q + 128, d,
    -(2^23 + 128) d)): the addend is exact in f32 (17 by 8 significant
    bits, under 2^24), so the fma gives q * d exactly, for every int8
    code and every bf16 d of 41 binades, and the pack rounds it once, as
    the plain version rounds q * d."""
    d = _bf16_sweep(-30, 10)
    q = np.arange(-128, 128, dtype=np.float64)[:, None]
    c = -(2.0 ** 23 + 128) * d
    assert np.array_equal(c.astype(np.float32).astype(np.float64), c)
    prod = (2.0 ** 23 + q + 128) * d              # exact in float64
    assert not _two_sum_err(prod, c).any()
    fma32 = (prod + c).astype(np.float32)
    assert np.array_equal(fma32.astype(np.float64), q * d)


def _bf16_bits_to_f64(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def test_int8_decoder_bit_trick_is_exact():
    """K17's m > 64 decoder (`i8_pair` in csrc/quant_matmul.cu): a byte
    permute puts 0x43 above each int8 code b (bf16 bits 0x43bb), one AND
    keeps 0x43bb & 0xff7f = bf16 128 + (b & 0x7f), another 0x43bb &
    0xff80 = bf16 128 + 128 (b >> 7), and one bf16 subtraction of the two
    gives q = (b & 0x7f) - 128 (b >> 7). Emulated for all 256 codes: both
    operands are exact bf16 integers, their difference is exact (no
    rounding), and it equals bf16(q) bit for bit, as the plain version
    (and the Pallas body's cast) gives it."""
    b = np.arange(256, dtype=np.uint32)
    q = b.astype(np.uint8).view(np.int8).astype(np.float64)
    t = 0x4300 | b                       # __byte_perm(w, 0x43434343, sel)
    hi = _bf16_bits_to_f64(t & 0xFF7F)
    lo = _bf16_bits_to_f64(t & 0xFF80)
    assert np.array_equal(hi, 128 + (b & 0x7F))
    assert np.array_equal(lo, 128 + 128 * (b >> 7))
    diff = hi - lo                       # exact in float64
    # sub.rn.bf16x2 rounds the exact difference once to bf16: an integer
    # of magnitude at most 128 is a bf16, so the rounding changes nothing.
    as_bf16 = torch.from_numpy(diff).to(torch.bfloat16)
    assert np.array_equal(as_bf16.double().numpy(), diff)
    assert np.array_equal(diff, q)
    want = torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(as_bf16.view(torch.int16), want.view(torch.int16))
    # The plain version takes the same codes as f32: the same values.
    w = torch.from_numpy(b.astype(np.uint8).view(np.int8))
    assert torch.equal(w.float(), as_bf16.float())


# ---- K7 (csrc/quant_matmul.cu quant_stream_kernel), emulated ----
#
# The streamed kernel dequantizes packed words straight into mma.sync A
# fragments (W^T as A, x^T as B). Its fragment map, emulated here lane by
# lane with the kernel's own bit operations on one ring stage (128 k rows
# of a block's 128 columns, eight warps, four k32 steps): each warp's A
# registers hold each (column, k) of its 16 x 32 tile once, every value
# equal to the plain version's dequantized weight bit for bit; x, staged
# in the same k order, gives B fragments whose k matches A's at every
# (lane, register, element); and the PTX products of those fragments
# equal the tile's W^T x (float64, the same sums).

_MASK32 = np.uint64(0xFFFFFFFF)


def _prmt(x, y, sel):
    """__byte_perm(x, y, sel): byte i of the result is byte sel[i] of
    the eight bytes x (0-3) then y (4-7)."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    src = [(x >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)] + \
        [(y >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)]
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint64(8 * i)
    return out


def _bf16_bits(f):
    """float64 values -> bf16 bits, rounded to nearest even."""
    t = torch.from_numpy(np.asarray(f, np.float64)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().astype(np.uint64) & np.uint64(0xFFFF)


def _halves(u):
    u = np.asarray(u, np.uint64)
    return (_bf16_bits_to_f64(u & np.uint64(0xFFFF)),
            _bf16_bits_to_f64(u >> np.uint64(16)))


def _bf2(lo, hi):
    return _bf16_bits(lo) | (_bf16_bits(hi) << np.uint64(16))


def _bf2_sub(a, b):      # sub.rn.bf16x2: the exact difference, rounded once
    (a0, a1), (b0, b1) = _halves(a), _halves(b)
    return _bf2(a0 - b0, a1 - b1)


def _bf2_mul(a, b):      # mul.rn.bf16x2: the exact product, rounded once
    (a0, a1), (b0, b1) = _halves(a), _halves(b)
    return _bf2(a0 * b0, a1 * b1)


def _nib2(v):
    return (np.asarray(v, np.uint64) & np.uint64(0x000F000F)) | \
        np.uint64(0x43004300)


def _s8_codes(v, zz):
    v = (np.asarray(v, np.uint64) & np.uint64(0x0F0F0F0F)) | \
        np.uint64(0x80808080)
    return ((v - np.asarray(zz, np.uint64)) & _MASK32) ^ \
        np.uint64(0x80808080)


def _awq_word(r, w, row_words=16):
    """The kernel's awq_word: rows of `row_words` words packed in 32-word
    lines, a row's place in its line XORed with (r >> 3) & 3 times 8
    (4 for 16-word rows)."""
    e = r * row_words + w
    return (e & ~31) | ((e & 31) ^ (((r >> 3) & 3) *
                                     (4 if row_words == 16 else 8)))


def _k7_problem(kind, seed=0):
    """One stage's inputs: K 128 x N 128, groups of 32, x of 8 rows."""
    rs = np.random.RandomState(seed)
    K, N, gs = 128, 128, 32
    bits = 8 if kind == "gptq8" else 4
    pack = 32 // bits
    codes = rs.randint(0, 1 << bits, size=(K, N)).astype(np.uint64)
    zeros = rs.randint(0, 1 << bits, size=(K // gs, N)).astype(np.uint64)
    if kind == "awq":
        order = np.array(tqm.AWQ_ORDER, np.uint64)

        def pack_cols(a):
            out = np.zeros((a.shape[0], a.shape[1] // 8), np.uint64)
            for e in range(8):
                out |= a[:, e::8] << (np.uint64(4) * order[e])
            return out
        qweight, qzeros = pack_cols(codes), pack_cols(zeros)
    else:
        qweight = np.zeros((K // pack, N), np.uint64)
        for j in range(pack):
            qweight |= codes[j::pack] << np.uint64(bits * j)
        qzeros = np.zeros((K // gs, N // pack), np.uint64)
        for j in range(pack):
            qzeros |= zeros[:, j::pack] << np.uint64(bits * j)
    scales = torch.from_numpy(rs.uniform(0.002, 0.03, size=(K // gs, N))
                              ).to(torch.bfloat16)
    x = torch.from_numpy(rs.normal(size=(8, K))).to(torch.bfloat16)
    as_i32 = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32))
    return (as_i32(qweight), as_i32(qzeros), scales, x, bits, gs,
            qweight, qzeros)


def _k7_stage_words(kind, qweight):
    """The ring stage's words as the kernel's copies lay them out: GPTQ
    [word row][128 + pad words], AWQ rows at _awq_word."""
    if kind == "awq":
        stage = np.zeros(128 * 16, np.uint64)
        for r in range(128):
            for w in range(16):
                stage[_awq_word(r, w)] = qweight[r, w]
        return stage, 16
    row_words = 128 + (8 if kind == "gptq4" else 4)
    stage = np.zeros(qweight.shape[0] * row_words, np.uint64)
    for r in range(qweight.shape[0]):
        stage[r * row_words:r * row_words + 128] = qweight[r]
    return stage, row_words


def _k7_fragments(kind, a8, stage, row_words, qzeros, scales, warp, b,
                  zero_plus):
    """step_fragments and group_consts for every lane of `warp` at k32
    step b (group b: groups of 32). Returns uint64 [32, 2, 4] registers
    (a8: step 0 only)."""
    lane = np.arange(32)
    gid, t = lane >> 2, lane & 3
    c0 = warp * 16 + 2 * gid
    sbits = scales.view(torch.int16).numpy().astype(np.uint64) & \
        np.uint64(0xFFFF)
    s2 = sbits[b, c0] | (sbits[b, c0 + 1] << np.uint64(16))
    regs = np.zeros((32, 2, 4), np.uint64)
    if kind == "awq":
        v = qzeros[b, c0 // 8] >> (2 * (c0 & 7)).astype(np.uint64)
        wc = 2 * warp + (gid >> 2)
        w = np.stack([stage[[_awq_word(32 * b + 8 * tt + j, int(c))
                             for tt, c in zip(t, wc)]]
                      for j in range(8)], 1)
        w = w >> (4 * (gid & 3)).astype(np.uint64)[:, None]
        if a8:
            zz0 = (v & np.uint64(0xF)) * np.uint64(0x01010101)
            zz1 = ((v >> np.uint64(16)) & np.uint64(0xF)) * \
                np.uint64(0x01010101)
            p02, p46 = _prmt(w[:, 0], w[:, 2], 0x6240), \
                _prmt(w[:, 4], w[:, 6], 0x6240)
            p13, p57 = _prmt(w[:, 1], w[:, 3], 0x6240), \
                _prmt(w[:, 5], w[:, 7], 0x6240)
            regs[:, 0, 0] = _s8_codes(_prmt(p02, p46, 0x5410), zz0)
            regs[:, 0, 1] = _s8_codes(_prmt(p02, p46, 0x7632), zz1)
            regs[:, 0, 2] = _s8_codes(_prmt(p13, p57, 0x5410), zz0)
            regs[:, 0, 3] = _s8_codes(_prmt(p13, p57, 0x7632), zz1)
        else:
            z2 = _nib2(v)
            p = [_bf2_mul(_bf2_sub(_nib2(w[:, j]), z2), s2) for j in range(8)]
            for s in range(2):
                for h in range(2):
                    r = 2 * s + h
                    regs[:, s, 2 * h] = _prmt(p[r], p[r + 4], 0x5410)
                    regs[:, s, 2 * h + 1] = _prmt(p[r], p[r + 4], 0x7632)
        return regs
    bits = 4 if kind == "gptq4" else 8
    pack = 32 // bits
    mask = np.uint64((1 << bits) - 1)
    v = qzeros[b, c0 // pack] >> (bits * (c0 % pack)).astype(np.uint64)
    za = (v & mask) + np.uint64(zero_plus)
    zb = ((v >> np.uint64(bits)) & mask) + np.uint64(zero_plus)
    if bits == 4:
        at = (4 * b + t) * row_words + warp * 16 + 2 * gid
        wx, wy = stage[at], stage[at + 1]
        if a8:
            zza, zzb = za * np.uint64(0x01010101), zb * np.uint64(0x01010101)
            regs[:, 0, 0] = _s8_codes(wx, zza)
            regs[:, 0, 1] = _s8_codes(wy, zzb)
            regs[:, 0, 2] = _s8_codes(wx >> np.uint64(4), zza)
            regs[:, 0, 3] = _s8_codes(wy >> np.uint64(4), zzb)
            return regs
        z0 = (np.uint64(0x4300) | za) * np.uint64(0x10001)
        z1 = (np.uint64(0x4300) | zb) * np.uint64(0x10001)
        sa, sb = _prmt(s2, s2, 0x1010), _prmt(s2, s2, 0x3232)
        for s in range(2):
            for h in range(2):
                sh = np.uint64(8 * s + 4 * h)
                regs[:, s, 2 * h] = _bf2_mul(_bf2_sub(_nib2(wx >> sh), z0),
                                             sa)
                regs[:, s, 2 * h + 1] = _bf2_mul(
                    _bf2_sub(_nib2(wy >> sh), z1), sb)
        return regs
    # 8 bits: f32 (2^23 + q) - (2^23 + z), times s, one rounding to bf16.
    f32 = np.float32
    at = (8 * b + 2 * t) * row_words + warp * 16 + 2 * gid
    lo = (stage[at], stage[at + 1])
    hi = (stage[at + row_words], stage[at + row_words + 1])
    zf = (f32(2 ** 23) + za.astype(f32), f32(2 ** 23) + zb.astype(f32))
    sf = (_bf16_bits_to_f64(s2 & np.uint64(0xFFFF)).astype(f32),
          _bf16_bits_to_f64(s2 >> np.uint64(16)).astype(f32))

    def val(w, byte, c):
        q = (w >> np.uint64(8 * byte)) & np.uint64(0xFF)
        return ((f32(2 ** 23) + q.astype(f32)) - zf[c]) * sf[c]
    for s in range(2):
        for h in range(2):
            r = 2 * s + h
            for c in range(2):
                regs[:, s, 2 * h + c] = _bf2(val(lo[c], r, c),
                                             val(hi[c], r, c))
    return regs


# The kernel's fragment map, as the CUDA comments state it: A row g of
# a warp's tile is column 2g, row g + 8 column 2g + 1; thread t of a quad
# takes k rows 8t .. 8t + 7 of a step. PTX m16n8k16 (bf16): register i,
# element e holds A row gid + 8 (i & 1), k 2t + e + 8 (i >> 1) of step s;
# the kernel's physical k is 8t + 2s + (i >> 1) + 4e. m16n8k32 (s8):
# register i, byte e holds row gid + 8 (i & 1), k 4t + e + 16 (i >> 1);
# physical k 8t + 2e + (i >> 1). B registers use the same (t, element)
# -> k, with the register's k half in place of i >> 1.
def _k7_a_map(a8):
    """[(lane, step, reg, element)] -> (column in the warp's 16, k)."""
    out = {}
    for lane in range(32):
        gid, t = lane >> 2, lane & 3
        for i in range(4):
            col = 2 * gid + (i & 1)
            if a8:
                for e in range(4):
                    out[(lane, 0, i, e)] = (col, 8 * t + 2 * e + (i >> 1))
            else:
                for s in range(2):
                    for e in range(2):
                        out[(lane, s, i, e)] = \
                            (col, 8 * t + 2 * s + (i >> 1) + 4 * e)
    return out


@pytest.mark.parametrize("kind,a8", [("gptq4", False), ("gptq8", False),
                                     ("awq", False), ("gptq4", True),
                                     ("awq", True)])
def test_k7_fragment_map_covers_the_tile(kind, a8):
    (qw_t, qz_t, scales, x, bits, gs, qweight, qzeros) = _k7_problem(kind)
    awq = kind == "awq"
    # The plain version's dequantized weight (bf16) and, for a8, codes
    # minus zero (the AutoGPTQ +1 in the GPTQ layout).
    if awq:
        w_plain = tqm.dequantize_awq_plain(qw_t, qz_t, scales,
                                           group_size=gs,
                                           dtype=torch.bfloat16)
        codes = tqm._awq_codes(qw_t, qz_t, gs)
    else:
        w_plain = tqm.dequantize_plain(qw_t, qz_t, scales, bits=bits,
                                       group_size=gs, dtype=torch.bfloat16)
        codes = tqm._codes(qw_t, qz_t, bits, gs)
    w_plain = w_plain.double().numpy()
    codes = codes.numpy()
    stage, row_words = _k7_stage_words(kind, qweight)
    amap = _k7_a_map(a8)
    # Every (column, k) of a 16 x 32 tile once.
    assert sorted(amap.values()) == [(c, k) for c in range(16)
                                     for k in range(32)]
    if a8:
        x8, _ = tqm.quantize_activations_int8_plain(x)
        xv = x8.numpy().astype(np.float64)
        perm = [0, 2, 4, 6, 1, 3, 5, 7]
    else:
        xv = x.double().numpy()
        perm = [0, 4, 1, 5, 2, 6, 3, 7]
    # x in fragment order: each run of 8 k rows permuted in place.
    xp = xv.reshape(8, -1, 8)[:, :, perm].reshape(8, -1)
    for warp in range(8):
        for b in range(4):
            regs = _k7_fragments(kind, a8, stage, row_words, qzeros,
                                 scales, warp, b, 0 if awq else 1)
            k0, c_base = 32 * b, 16 * warp
            a_tile = np.zeros((16, 32))
            for (lane, s, i, e), (col, k) in amap.items():
                reg = int(regs[lane, s, i])
                if a8:
                    byte = (reg >> (8 * e)) & 0xFF
                    v = byte - 256 if byte > 127 else byte
                    want = codes[k0 + k, c_base + col]
                else:
                    v = _bf16_bits_to_f64(np.array(
                        [(reg >> (16 * e)) & 0xFFFF]))[0]
                    want = w_plain[k0 + k, c_base + col]
                assert v == want, (kind, a8, warp, b, lane, s, i, e)
                a_tile[col, k] = v
            # B from the staged x: lane (gid, t)'s 16 (8) bytes of a step,
            # registers in order; the k each element takes must be A's.
            for lane in range(32):
                gid, t = lane >> 2, lane & 3
                run = xp[gid, k0 + 8 * t:k0 + 8 * t + 8]
                for j, val in enumerate(run):
                    if a8:       # b0 bytes 0-3 (k half 0), b1 (half 1)
                        i, e = j // 4, j % 4
                        k = 8 * t + 2 * e + i
                    else:        # (step 0: b0, b1), (step 1: b0, b1)
                        s, i, e = j // 4, (j // 2) % 2, j % 2
                        k = 8 * t + 2 * s + i + 4 * e
                    assert val == xv[gid, k0 + k]
            # The products over the step: D[col, row] = W^T x.
            got = a_tile @ xv[:, k0:k0 + 32].T
            want = (codes if a8 else w_plain)[k0:k0 + 32,
                                              c_base:c_base + 16].T @ \
                xv[:, k0:k0 + 32].T
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("row_words", [8, 16, 32, 64])
def test_k7_awq_word_loads_are_conflict_free(row_words):
    """The AWQ stage's row swizzle, for blocks of 64-512 columns: every
    word has one place, 16-byte copies stay whole, and for every warp,
    step and word j of a thread's eight, the 32 lanes' 32-bit loads touch
    eight distinct words in eight distinct banks (four lanes share each
    word: a broadcast)."""
    places = [_awq_word(r, w, row_words) for r in range(128)
              for w in range(row_words)]
    assert sorted(places) == list(range(128 * row_words))
    for r in range(128):
        for c in range(0, row_words, 4):
            first = _awq_word(r, c, row_words)
            assert first % 4 == 0 and [_awq_word(r, c + i, row_words)
                                       for i in range(4)] == \
                list(range(first, first + 4))
    for warp in range(row_words // 2):
        for b in range(4):
            for j in range(8):
                addrs = set()
                for lane in range(32):
                    gid, t = lane >> 2, lane & 3
                    addrs.add(_awq_word(32 * b + 8 * t + j,
                                        2 * warp + (gid >> 2), row_words))
                assert len(addrs) == 8
                assert len({a % 32 for a in addrs}) == 8


# ---- K8, K11, K15 at m > 64 (csrc/quant_matmul.cu w8a8_gemm_kernel) ----
#
# The decoders turn one chunk of 128 k rows of the weight, as the TMA ring
# stage holds it, into the K-major swizzled s8 tile wgmma reads (column
# n's 128 k bytes in row n, 16-byte piece c at n * 128 + (c ^ n % 8) *
# 16). Emulated thread by thread with the kernel's own bit operations.


def _swz(r, c):
    return r * 128 + ((c ^ (r & 7)) << 4)


def _pick2(j0, j1):
    return j0 | (4 + j0) << 4 | j1 << 8 | (4 + j1) << 12


def _prmt_each(x, y, sel):
    """__byte_perm with a selector per element."""
    x, y, sel = np.broadcast_arrays(np.asarray(x, np.uint64),
                                    np.asarray(y, np.uint64),
                                    np.asarray(sel, np.uint64))
    src = np.stack([(x >> np.uint64(8 * i)) & np.uint64(0xFF)
                    for i in range(4)] +
                   [(y >> np.uint64(8 * i)) & np.uint64(0xFF)
                    for i in range(4)])
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        idx = ((sel >> np.uint64(4 * i)) & np.uint64(7)).astype(np.int64)
        out |= np.take_along_axis(src, idx[None], 0)[0] << np.uint64(8 * i)
    return out


def _transpose4(a, b, c, d, sel01, sel23):
    t0, t1 = _prmt_each(a, b, sel01), _prmt_each(a, b, sel23)
    t2, t3 = _prmt_each(c, d, sel01), _prmt_each(c, d, sel23)
    return [_prmt_each(t0, t2, 0x5410), _prmt_each(t0, t2, 0x7632),
            _prmt_each(t1, t3, 0x5410), _prmt_each(t1, t3, 0x7632)]


def _w8_decode(kind, stage, zrow, kn):
    """Every consumer thread's stores of one chunk, one entry a store
    (s of 4): (byte offsets [256], the 16 bytes [256, 16]), threads in
    order."""
    tid = np.arange(256)
    stores = []

    def piece(words):
        return np.stack([(w >> np.uint64(8 * b)) & np.uint64(0xFF)
                         for w in words for b in range(4)], 1)
    if kind == "gptq":
        n, c0 = tid & 127, (tid >> 7) * 4
        zz = (((zrow[n >> 3] >> (4 * (n & 7)).astype(np.uint64)) &
               np.uint64(0xF)) + np.uint64(1)) * np.uint64(0x01010101)
        for i in range(4):
            c = c0 + i
            o = []
            for h in range(2):
                w = stage[(2 * c + h) * 128 + n]
                lo, hi = _s8_codes(w, zz), _s8_codes(w >> np.uint64(4), zz)
                real = 16 * c + 8 * h < kn
                o += [np.where(real, _prmt(lo, hi, 0x5140), 0),
                      np.where(real, _prmt(lo, hi, 0x7362), 0)]
            stores.append((_swz(n, c), piece(o)))
        return stores
    if kind == "awq":
        c, j, sh = tid >> 5, (tid & 31) >> 1, 4 * (tid & 1)
        rot = j & 3
        zz = (zrow[j] >> sh.astype(np.uint64)) & np.uint64(0x0F0F0F0F)
        rows = [[stage[(16 * c + 4 * i + r) * 16 + j] >> sh.astype(np.uint64)
                 for r in range(4)] for i in range(4)]
        vals = [[np.where(16 * c + 4 * i + r < kn, _s8_codes(w, zz), 0)
                 for r, w in enumerate(ws)] for i, ws in enumerate(rows)]
        n_of = lambda b: 8 * j + sh // 2 + (b >> 1) + 4 * (b & 1)
    else:                                     # K15: qs8 [128 k][128 n]
        c, q = tid >> 5, tid & 31
        rot = (q >> 1) & 3
        vals = [[stage[(16 * c + 4 * i + r) * 32 + q] for r in range(4)]
                for i in range(4)]
        n_of = lambda b: 4 * q + b
    sel01 = _pick2(rot, (rot + 1) & 3)
    sel23 = _pick2((rot + 2) & 3, (rot + 3) & 3)
    o = [_transpose4(*v, sel01, sel23) for v in vals]    # o[i][s]
    for s in range(4):
        stores.append((_swz(n_of((s + rot) & 3), c),
                       piece([o[i][s] for i in range(4)])))
    return stores


def _w8_problem(kind, gs, seed):
    """K 2 gs x N 128 of random words and zeros, as the GPU tests make
    them: the packed tensors (uint64 numpy) and the plain codes minus
    zero [K, N] (`_codes` with the AutoGPTQ +1, `_awq_codes`), or K15's
    int8 codes."""
    rs = np.random.RandomState(seed)
    K, N = 2 * gs, 128
    if kind == "qs8":
        qs = rs.randint(-127, 128, (K, N)).astype(np.int64)
        return qs.astype(np.uint8).astype(np.uint64), None, qs
    words = lambda *shape: rs.randint(0, 2 ** 32, shape, dtype=np.uint64)
    qw = words(K, N // 8) if kind == "awq" else words(K // 8, N)
    qz = words(2, N // 8)
    t = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32))
    codes = tqm._awq_codes(t(qw), t(qz), gs) if kind == "awq" else \
        tqm._codes(t(qw), t(qz), 4, gs)
    return qw, qz, codes.numpy()


@pytest.mark.parametrize("kind,gs,chunk", [
    ("gptq", 128, 1), ("awq", 128, 1), ("qs8", 128, 1),
    ("gptq", 200, 1), ("awq", 200, 1),       # a group's short last chunk
    ("gptq", 136, 2), ("awq", 200, 2),       # a chunk past the first group
])
def test_w8a8_decoders_fill_the_k_major_tile(kind, gs, chunk):
    """Each decoder fills the K-major s8 tile of one chunk (group
    `chunk` // cpg, its chunk `chunk` % cpg) with exactly the plain
    version's codes minus zero of its real rows and zero past them,
    every byte stored once; the 8 lanes of every quarter warp store to 8
    distinct 16-byte bank groups (AWQ and K15 by their rotation)."""
    qw, qz, codes = _w8_problem(kind, gs, seed=gs + chunk)
    K = codes.shape[0]
    cpg = -(-gs // 128)
    g = chunk // cpg
    r0 = (chunk % cpg) * 128
    k0, kn = g * gs + r0, min(128, gs - r0)
    # The ring stage as TMA fills it (rows past K read as zero).
    if kind == "gptq":
        rows = np.zeros((16, 128), np.uint64)
        src = qw[k0 // 8:k0 // 8 + 16]
    elif kind == "awq":
        rows = np.zeros((128, 16), np.uint64)
        src = qw[k0:k0 + 128]
    else:
        rows = np.zeros((128, 32), np.uint64)     # 4 bytes a word
        b = qw[k0:k0 + 128]
        src = sum(b[:, i::4] << np.uint64(8 * i) for i in range(4))
    rows[:len(src)] = src
    zrow = qz[g] if qz is not None else None
    tile = np.full(128 * 128, -1, np.int64)
    writes = np.zeros(128 * 128, np.int64)
    for off, bytes16 in _w8_decode(kind, rows.reshape(-1), zrow, kn):
        for lane0 in range(0, 256, 8):            # quarter warps
            groups = (off[lane0:lane0 + 8] // 16) % 8
            assert len(set(groups.tolist())) == 8, (kind, lane0)
        for o, v in zip(off, bytes16):
            tile[o:o + 16] = v.astype(np.uint8).view(np.int8)
            writes[o:o + 16] += 1
    assert (writes == 1).all()
    want = np.zeros((128, 128), np.int64)         # [n, k]
    want[:, :kn] = codes[k0:k0 + kn].T
    got = np.array([[tile[_swz(n, k // 16) + k % 16] for k in range(128)]
                    for n in range(128)])
    np.testing.assert_array_equal(got, want)
    if kind != "qs8":
        assert got.min() >= (-16 if kind == "gptq" else -15)
        assert got.max() <= (14 if kind == "gptq" else 15)


def test_w8a8_awq_decoder_loads_hit_distinct_banks():
    """K11's decoder reads its stage ([128 k][16 word columns]) one row a
    load: a warp's 32 lanes read 16 distinct words (two lanes each, a
    broadcast) in 16 distinct banks; K8's read one 128-word row, 32
    banks."""
    for c in range(8):
        for i in range(16):
            words = {(16 * c + i) * 16 + (lane >> 1) for lane in range(32)}
            assert len(words) == 16 and len({w % 32 for w in words}) == 16
    for row in range(16):
        words = {row * 128 + n for n in range(32)}
        assert len({w % 32 for w in words}) == 32


# K7's plan (`stream_plan`) on 132 SMs at Mistral-7B's four projections.
@pytest.mark.parametrize("m,K,N,gs,a8,want", [
    (1, 4096, 6144, 128, False, (8, 11)),     # 48 column blocks: 11 wanted
    (8, 4096, 6144, 128, False, (8, 6)),      # a tenth allows 6
    (8, 4096, 4096, 128, False, (8, 6)),
    (1, 4096, 4096, 128, False, (8, 16)),     # 17 wanted: runs of 2 groups
    (8, 4096, 28672, 128, False, (8, 3)),     # 224 column blocks
    (8, 14336, 4096, 128, False, (8, 16)),
    (16, 4096, 4096, 128, False, (16, 5)),    # a tenth allows 3; 32 x 5
    (32, 4096, 4096, 128, False, (32, 5)),    # blocks give every SM one
    (32, 4096, 28672, 128, False, (32, 4)),   # x of 32 rows: 1024 a block
    (64, 4096, 6144, 128, False, (64, 4)),    # two 32-row blocks, as m 32
    (64, 4096, 28672, 128, True, (64, 2)),    # int8 x: 2048 a block
    (64, 14336, 4096, 128, False, (64, 14)),
    (3, 4096, 6144, 32, False, (8, 11)),      # groups of 32: 32-row units
    (8, 3200, 4096, 200, False, (8, 4)),      # groups of 200: 800-row units
])
def test_k7_stream_plan_table(m, K, N, gs, a8, want):
    assert tqm.stream_plan(m, K, N, gs, 132, x_bytes=1 if a8 else 2) == want


@pytest.mark.parametrize("sms", [132, 114, 66])
def test_k7_stream_plan_splits_fit(sms):
    """Every split is a run of whole `stream_unit` units (lcm(gs, 32) rows
    up to 1024, else 32), none empty;
    the plan depends on shapes and the SM count alone; each block's x
    fits its bound; wherever there are more splits than the x bound needs
    and than give every SM a block, the f32 partials stay within a tenth
    of the packed weight's bytes; and the splits never exceed what four
    blocks per SM want unless x needs them."""
    for K, N in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        for gs in (32, 64, 128, 1024, 2048, K):
            for bits in (4, 8):
                for a8 in ((False, True) if bits == 4 else (False,)):
                    for m in (1, 2, 3, 8, 9, 16, 17, 33, 48, 64):
                        block_m, splits = tqm.stream_plan(
                            m, K, N, gs, sms, bits, 1 if a8 else 2)
                        assert block_m == next(b for b in (8, 16, 32, 64)
                                               if m <= b)
                        unit = tqm.stream_unit(gs)
                        units = K // unit
                        per = -(-units // splits)
                        assert -(-units // per) == splits   # none empty
                        rows = min(block_m, 32)     # a block's x rows
                        x_bytes = rows * per * unit * (1 if a8 else 2)
                        assert x_bytes <= tqm._STREAM_X_BYTES
                        least = -(-units // (tqm._STREAM_X_BYTES // (
                            rows * unit * (1 if a8 else 2))))
                        if splits > least:
                            assert splits <= -(-sms * 4 // (N // 128))
                        if splits > max(least, -(-sms // (N // 128))):
                            assert splits * m * N * 4 * 10 <= \
                                K * N * bits // 8
                        assert tqm.stream_plan(m, K, N, gs, sms, bits,
                                               1 if a8 else 2) == \
                            (block_m, splits)


def test_k7_stream_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="m <= 64"):
        tqm.stream_plan(65, 4096, 4096, 128, 132)
    with pytest.raises(ValueError, match="multiple"):
        tqm.stream_plan(8, 4096, 4096, 132, 132)      # gs % 8
    with pytest.raises(ValueError, match="multiple"):
        tqm.stream_plan(8, 4080, 4096, 136, 132)      # K % lcm(136, 32)
    with pytest.raises(ValueError, match="multiple"):
        tqm.stream_plan(64, 4104, 4096, 4104, 132)    # one group, K % 32


@pytest.mark.parametrize("gs", [-1, 1000, 2048])
@pytest.mark.parametrize("m", [1, 8, 17, 64])
def test_k7_stream_plan_serves_one_group_and_large_groups(m, gs):
    """One group of K rows (GPTQ's group_size -1) and groups whose
    lcm(gs, 32) passes 1024 rows split over 32-row units, so every m
    plans at Mistral-7B's four projections with each block's x within
    its bound, and as many splits as at groups of 128 but where the
    split count rounds to other whole units (K 14336)."""
    for K, N in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        g = K if gs == -1 else gs
        assert tqm.stream_unit(g) == 32
        for a8 in (False, True):
            block_m, splits = tqm.stream_plan(m, K, N, g, 132, 4,
                                              1 if a8 else 2)
            per = -(-(K // 32) // splits) * 32
            assert min(block_m, 32) * per * (1 if a8 else 2) <= \
                tqm._STREAM_X_BYTES
            if K != 14336:
                assert (block_m, splits) == tqm.stream_plan(
                    m, K, N, 128, 132, 4, 1 if a8 else 2)


def _k7_group_walk(K, gs, k_split, a8):
    """`quant_stream_kernel`'s group bookkeeping, split by split and step
    by step: yields (split start, rows, staged groups, [(row, group) for
    each thread's run of 8 rows], [(group, rows summed) for each a8
    fold]); groups are the split's own indices (g_begin + index)."""
    for k_begin in range(0, K, k_split):
        k_rows = min(K - k_begin, k_split)
        g_begin = k_begin // gs
        n_groups = (k_begin + k_rows - 1) // gs - g_begin + 1
        runs, folds = [], []
        sg = [-1] * 4
        sg_end = [g_begin * gs - k_begin] * 4
        fg, fg_end, summed = 0, g_begin * gs - k_begin + gs, 0
        for kb in range(k_rows // 32):
            kk = 32 * kb
            for t in range(4):
                while kk + 8 * t >= sg_end[t]:
                    sg[t] += 1
                    sg_end[t] += gs
                runs.append((kk + 8 * t, sg[t]))
            if not a8:
                continue
            if kk + 32 <= fg_end:
                summed += 32
                if kk + 32 == fg_end:
                    folds.append((fg, summed))
                    fg, fg_end, summed = fg + 1, fg_end + gs, 0
                continue
            while True:           # the step crosses groups
                summed += sum(8 for t in range(4) if sg[t] == fg)
                if fg_end > kk + 32:
                    break
                folds.append((fg, summed))
                fg, fg_end, summed = fg + 1, fg_end + gs, 0
                if fg_end - gs >= kk + 32:
                    break
        if a8 and fg_end - gs < k_rows:      # a group the split ends in
            folds.append((fg, summed))
        yield k_begin, k_rows, n_groups, runs, folds


@pytest.mark.parametrize("K,gs,m", [(4096, 128, 8), (4096, 4096, 8),
                                    (14336, 14336, 64), (4096, 2048, 17),
                                    (14336, 2048, 1), (3200, 40, 8),
                                    (4000, 1000, 64)])
def test_k7_group_walk_takes_each_row_once_in_its_group(K, gs, m):
    """The kernel's per-thread group tracking and the a8 arm's folds over
    the splits `stream_plan` gives, splits starting inside a group
    included: each run of 8 k rows takes its own group's scale and zero,
    every group index lies within the split's staged rows, and in the a8
    arm each group a split touches is folded once, in group order, over
    exactly the split's rows of it."""
    for a8 in (False, True):
        _, splits = tqm.stream_plan(m, K, 4096, gs, 132, 4,
                                    1 if a8 else 2)
        unit = tqm.stream_unit(gs)
        k_split = -(-(K // unit) // splits) * unit
        seen = 0
        for k_begin, k_rows, n_groups, runs, folds in _k7_group_walk(
                K, gs, k_split, a8):
            g_begin = k_begin // gs
            assert [r for r, _ in runs] == list(range(0, k_rows, 8))
            for r, g in runs:
                assert 0 <= g < n_groups
                assert (k_begin + r) // gs == g_begin + g
            if a8:
                assert [g for g, _ in folds] == list(range(n_groups))
                for g, rows in folds:
                    lo = max(k_begin, (g_begin + g) * gs)
                    hi = min(k_begin + k_rows, (g_begin + g + 1) * gs)
                    assert rows == hi - lo
            seen += k_rows
        assert seen == K


# ---- K12 and K16 at m <= 64 (quant_stream_kernel's kQ4k, kLut and
# kLutX32 decoders), emulated ----
#
# The same ring stage and fragment map as K7's GPTQ 4-bit words (thread t
# of a quad takes rows 8t .. 8t + 7 of a k32 step; `_k7_a_map`). K12 takes
# each value through f32: bf16(f32(q) * dl - ml), the product and the
# difference rounded separately; K16 looks each code up in the block's
# codebook as the kernel stages it in shared memory (kLut: four copies of
# [16 codes][64 column pairs], lane t reading copy t, pair p at p ^ 8t;
# kLutX32: two copies of [16 codes][128 columns] of (hi | lo << 16), lane t
# reading copy t // 2, column n at n ^ 16 (t // 2), odd lanes looking up
# their columns in the other order).


def _lut_tables(kind, lut):
    """The kernel's shared codebook as 32-bit words, built by its staging
    loop thread by thread (every word written once): kLut from the bf16
    codebook's bits [128, 16], kLutX32 from the f32 codebook [128, 16]."""
    words = np.full(4096, -1, np.int64)
    for tid in range(256):
        if kind == "lut":
            p, q0 = tid & 63, 4 * (tid >> 6)
            for i in range(4):
                e = int(lut[2 * p, q0 + i]) | int(lut[2 * p + 1, q0 + i]) << 16
                for c in range(4):
                    at = c * 1024 + (q0 + i) * 64 + (p ^ (8 * c))
                    assert words[at] == -1
                    words[at] = e
        else:
            n, q0 = tid & 127, 8 * (tid >> 7)
            for i in range(8):
                v = np.float32(lut[n, q0 + i])
                hi = int(_bf16_bits(np.float64(v))[()])
                lo = int(_bf16_bits(np.float64(
                    v - np.float32(_bf16_bits_to_f64(np.array([hi]))[0])))[()])
                for u in range(2):
                    at = u * 2048 + (q0 + i) * 128 + (n ^ (16 * u))
                    assert words[at] == -1
                    words[at] = hi | lo << 16
    assert (words >= 0).all()
    return words.astype(np.uint64)


def _lut_offset(w, j, s, col):
    """lut_offset<S>: code j of word w shifted to bits S .. S + 3, or
    col."""
    w = np.asarray(w, np.uint64)
    sh = (w << np.uint64(s - 4 * j)) if 4 * j <= s else \
        (w >> np.uint64(4 * j - s))
    sh = sh & _MASK32
    col = np.asarray(col, np.uint64)
    assert not (col & np.uint64(0xF << s)).any()
    return (sh & np.uint64(0xF << s)) | col


def _k16_k12_fragments(kind, stage, table, warp, b, lookups=None):
    """step_fragments (and lut_lanes / q4k_consts) of kQ4k, kLut and
    kLutX32 for every lane of `warp` at k32 step b: uint64 [32, 2, 4] A
    registers (kLutX32: the hi halves, then the lo halves). K12's stage
    carries its four dl rows, then its four ml rows, after the words
    (word 2176 on, 64 words a row); `lookups` collects each lookup
    instruction's 32 word addresses."""
    lane = np.arange(32)
    gid, t = lane >> 2, lane & 3
    c0 = warp * 16 + 2 * gid
    at = (4 * b + t) * 136 + warp * 16 + 2 * gid
    wx, wy = stage[at], stage[at + 1]
    regs = np.zeros((32, 2, 4), np.uint64)
    lo_regs = np.zeros((32, 2, 4), np.uint64)
    f32 = np.float32
    if kind == "q4k":
        d2 = stage[2176 + b * 64 + c0 // 2]
        m2 = stage[2176 + (4 + b) * 64 + c0 // 2]
        dl = [_bf16_bits_to_f64((d2 >> np.uint64(16 * c)) & np.uint64(0xFFFF))
              .astype(f32) for c in range(2)]
        nml = [-_bf16_bits_to_f64((m2 >> np.uint64(16 * c)) &
                                  np.uint64(0xFFFF)).astype(f32)
               for c in range(2)]
        for s in range(2):
            for h in range(2):
                for c, w in enumerate((wx, wy)):
                    v = _nib2(w >> np.uint64(8 * s + 4 * h))
                    q0 = (_bf16_bits_to_f64(v & np.uint64(0xFFFF)).astype(f32)
                          - f32(128))
                    q1 = (_bf16_bits_to_f64(v >> np.uint64(16)).astype(f32)
                          - f32(128))
                    regs[:, s, 2 * h + c] = _bf2(
                        (q0 * dl[c]).astype(f32) + nml[c],
                        (q1 * dl[c]).astype(f32) + nml[c])
        return regs
    if kind == "lut":
        p = 8 * warp + gid
        col = (4096 * t + 4 * (p ^ (8 * t))).astype(np.uint64)

        def e(w, j):
            addr = _lut_offset(w, j, 8, col)
            if lookups is not None:
                lookups.append(addr // np.uint64(4))
            return table[(addr // np.uint64(4)).astype(np.int64)]
        for s in range(2):
            for h in range(2):
                r = 2 * s + h
                regs[:, s, 2 * h] = _prmt(e(wx, r), e(wx, r + 4), 0x5410)
                regs[:, s, 2 * h + 1] = _prmt(e(wy, r), e(wy, r + 4), 0x7632)
        return regs
    u, odd = t >> 1, (t & 1).astype(bool)
    col_a = (8192 * u + 4 * ((c0 + odd) ^ (16 * u))).astype(np.uint64)
    col_b = (8192 * u + 4 * ((c0 + 1 - odd) ^ (16 * u))).astype(np.uint64)
    wa, wb = np.where(odd, wy, wx), np.where(odd, wx, wy)

    def e(w, j, col):
        addr = _lut_offset(w, j, 9, col)
        if lookups is not None:
            lookups.append(addr // np.uint64(4))
        return table[(addr // np.uint64(4)).astype(np.int64)]
    for s in range(2):
        for h in range(2):
            r = 2 * s + h
            a0, a4 = e(wa, r, col_a), e(wa, r + 4, col_a)
            b0, b4 = e(wb, r, col_b), e(wb, r + 4, col_b)
            ha, la = _prmt(a0, a4, 0x5410), _prmt(a0, a4, 0x7632)
            hb, lb = _prmt(b0, b4, 0x5410), _prmt(b0, b4, 0x7632)
            regs[:, s, 2 * h] = np.where(odd, hb, ha)
            regs[:, s, 2 * h + 1] = np.where(odd, ha, hb)
            lo_regs[:, s, 2 * h] = np.where(odd, lb, la)
            lo_regs[:, s, 2 * h + 1] = np.where(odd, la, lb)
    return np.concatenate([regs, lo_regs], 1)


def _k16_k12_problem(kind, seed):
    """One stage: K 128 x N 128 random 4-bit words; K12's dl and ml rows
    over wide binades (either sign for ml, some zero), K16's codebook
    (bf16 or f32) over 2^-30 .. 2^10 of either sign."""
    rs = np.random.RandomState(seed)
    K, N = 128, 128
    qweight = rs.randint(0, 2 ** 32, (K // 8, N), dtype=np.uint64)
    qw_t = torch.from_numpy(qweight.astype(np.uint32).view(np.int32))
    if kind == "q4k":
        def spread(signed):
            v = (1 + rs.rand(K // 32, N)) * 2.0 ** rs.randint(-20, 1,
                                                              (K // 32, N))
            if signed:
                v *= np.where(rs.rand(K // 32, N) < 0.5, -1, 1)
                v[rs.rand(K // 32, N) < 0.05] = 0
            return torch.from_numpy(v).to(torch.bfloat16)
        dl, ml = spread(False), spread(True)
        want = tqm.gguf_q4k_dequantize_plain(qw_t, dl, ml, torch.bfloat16)
        bits = tuple(t.view(torch.int16).numpy().astype(np.uint64) &
                     np.uint64(0xFFFF) for t in (dl, ml))
        return qweight, want, bits, None
    lut = (1 + rs.rand(N, 16)) * 2.0 ** rs.randint(-30, 11, (N, 16)) * \
        np.where(rs.rand(N, 16) < 0.5, -1, 1)
    lut[rs.rand(N, 16) < 0.05] = 0
    if kind == "lut":
        lut_t = torch.from_numpy(lut).to(torch.bfloat16)
        table = _lut_tables(kind, lut_t.view(torch.int16).numpy()
                            .astype(np.int64) & 0xFFFF)
        want = tqm.squeezellm_dequantize_plain(qw_t, lut_t, torch.bfloat16)
    else:
        lut_t = torch.from_numpy(lut.astype(np.float32))
        table = _lut_tables(kind, lut_t.numpy())
        want = tqm.squeezellm_dequantize_plain(qw_t, lut_t, torch.float32)
    return qweight, want, None, table


@pytest.mark.parametrize("kind", ["q4k", "lut", "lut32"])
def test_k12_k16_stream_fragment_map_covers_the_tile(kind):
    """Every (k, n) of each warp's k32 steps of a stage lands once in the
    lane's A registers, equal to the plain version's dequantized weight
    bit for bit: K12's bf16(f32(q) dl - ml), K16's codebook entry (bf16);
    on f32 x the hi register holds bf16(w) and the lo register bf16(w -
    hi) of the plain version's f32 entry, bit for bit, with |w - hi - lo|
    <= 2^-16 |w|."""
    qweight, want, rows, table = _k16_k12_problem(kind, seed=len(kind))
    # [16 word rows][128 + 8], then K12's dl and ml rows as bf16 pairs.
    stage = np.zeros(16 * 136 + 8 * 64, np.uint64)
    for r in range(16):
        stage[r * 136:r * 136 + 128] = qweight[r]
    if kind == "q4k":
        for h, bits in enumerate(rows):
            for g in range(4):
                at = 2176 + (4 * h + g) * 64
                stage[at:at + 64] = bits[g, 0::2] | \
                    (bits[g, 1::2] << np.uint64(16))
    amap = _k7_a_map(False)
    want = want.double().numpy()
    for warp in range(8):
        for b in range(4):
            regs = _k16_k12_fragments(kind, stage, table, warp, b)
            seen = set()
            for (lane, s, i, e), (col, k) in amap.items():
                n, kk = 16 * warp + col, 32 * b + k
                seen.add((n, kk))
                half = lambda reg: _bf16_bits_to_f64(np.array(
                    [(int(reg) >> (16 * e)) & 0xFFFF]))[0]
                hi = half(regs[lane, s, i])
                w = want[kk, n]
                if kind != "lut32":
                    assert hi == w, (kind, warp, b, lane, s, i, e)
                    continue
                lo = half(regs[lane, 2 + s, i])
                assert hi == _bf16_bits_to_f64(_bf16_bits(w))[()]
                rest = np.float64(np.float32(w) - np.float32(hi))
                assert lo == _bf16_bits_to_f64(_bf16_bits(rest))[()]
                assert abs(w - hi - lo) <= 2.0 ** -16 * abs(w)
            assert len(seen) == 16 * 32


@pytest.mark.parametrize("kind", ["lut", "lut32"])
def test_k16_stream_codebook_lookups_are_conflict_free(kind):
    """For random codes, every lookup instruction of every warp and step:
    no two of the 32 lanes read one bank at different words (lanes that
    read one word share it by broadcast), so a lookup takes one shared
    load whatever the codes."""
    qweight, _, _, table = _k16_k12_problem(kind, seed=7)
    stage = np.zeros(16 * 136, np.uint64)
    for r in range(16):
        stage[r * 136:r * 136 + 128] = qweight[r]
    n_loads = 0
    for warp in range(8):
        for b in range(4):
            lookups = []
            _k16_k12_fragments(kind, stage, table, warp, b, lookups)
            assert len(lookups) == 16
            for words in lookups:
                by_bank = {}
                for wd in words.tolist():
                    by_bank.setdefault(wd % 32, set()).add(wd)
                assert all(len(v) == 1 for v in by_bank.values())
                n_loads += 1
    assert n_loads == 8 * 4 * 16


def test_k16_x32_split_and_three_products():
    """K16 on f32 x: x and the f32 codebook split into bf16 hi = bf16(v)
    and lo = bf16(v - hi) lie within 2^-16 |v| of v (seeded values over
    2^-40 .. 2^40); the kernel's sum of x_lo w_hi + x_hi w_lo + x_hi w_hi
    (each bf16 product exact in f32, summed in f32 one k16 at a time) is
    within chip_smoke's F32_RTOL (1e-4 of max |y|) of the float64 product
    of the f32 values, at QuIP#'s table and Mistral-7B's K."""
    rs = np.random.RandomState(32)

    def split(v):
        v = np.asarray(v, np.float32)
        hi = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        lo = torch.from_numpy(v - hi).to(torch.bfloat16).float().numpy()
        return hi, lo
    v = ((1 + rs.rand(100000)) * 2.0 ** rs.randint(-40, 41, 100000) *
         np.where(rs.rand(100000) < 0.5, -1, 1)).astype(np.float32)
    hi, lo = split(v)
    assert (np.abs(v.astype(np.float64) - hi - lo) <=
            2.0 ** -16 * np.abs(v)).all()
    # x after QuIP#'s Hadamard transform (unit scale), E8P values / 4 times
    # Wscale 0.05 as the codebook, K 4096 and 14336.
    from aphrodite_tpu_torch.modeling.layers.quantization.quip import (
        E8P_VALUES4)
    table = np.array(E8P_VALUES4, np.float32) / np.float32(4) * \
        np.float32(0.05)
    for K in (4096, 14336):
        x = rs.randn(4, K).astype(np.float32)
        w = table[rs.randint(0, len(table), (K, 8))]
        xh, xl = split(x)
        wh, wl = split(w)
        acc = np.zeros((4, 8), np.float32)
        for k0 in range(0, K, 16):
            sl = slice(k0, k0 + 16)
            for a, b_ in ((xl, wh), (xh, wl), (xh, wh)):
                acc = (acc.astype(np.float64) + a[:, sl].astype(np.float64)
                       @ b_[sl].astype(np.float64)).astype(np.float32)
        ref = x.astype(np.float64) @ w.astype(np.float64)
        assert np.abs(acc - ref).max() <= 1e-4 * np.abs(ref).max()


# The split plan of K12 and K16 at m <= 64 (`stream_plan` with gs 32 and
# the resident x's element bytes: 2 for bf16 x, 4 for f32 x as bf16 hi and
# lo) on 132 SMs, at QuIP#'s Llama-2-7B shapes (4096 -> 12288, 4096 ->
# 4096, 4096 -> 22016, 11008 -> 4096) and Mistral-7B's.
@pytest.mark.parametrize("m,K,N,x_bytes,want", [
    (1, 4096, 6144, 2, (8, 11)),
    (8, 4096, 4096, 2, (8, 6)),
    (8, 14336, 4096, 2, (8, 17)),
    (33, 4096, 28672, 2, (64, 4)),       # x of 32 rows: 1024 rows a block
    (1, 4096, 6144, 4, (8, 11)),
    (8, 4096, 4096, 4, (8, 6)),
    (8, 14336, 4096, 4, (8, 17)),
    (32, 4096, 28672, 4, (32, 8)),       # 32 rows of f32 x: 512 a block
    (64, 14336, 4096, 4, (64, 28)),
    (8, 4096, 12288, 4, (8, 6)),
    (1, 4096, 22016, 4, (8, 4)),
    (8, 11008, 4096, 4, (8, 17)),
    (64, 11008, 4096, 4, (64, 22)),
])
def test_k12_k16_stream_plan_table(m, K, N, x_bytes, want):
    assert tqm.stream_plan(m, K, N, 32, 132, 4, x_bytes) == want


def _stream_smem(kind, k_split, nt):
    """quant_stream_kernel's shared memory a block (smem_bytes): the
    ring (K12's stages carry their dl and ml rows; K14's two stages their
    bytes and d16 rows, K13's their bytes and d rows, K15's their bytes
    and s128 row, K17's their bytes), K16's codebook and the resident x
    (K15's int8)."""
    if kind == "i8g":
        ring = 2 * (128 * 32 + 8 * _I8G_D16_WORDS) * 4
    elif kind in ("q8", "qs8", "int8"):
        ring = 2 * (128 * 32 + {"q8": 4, "qs8": 1}.get(kind, 0) * 64) * 4
    else:
        ring = 3 * (16 * 136 + (8 * 64 if kind == "q4k" else 0)) * 4
    es = {"lut32": 4, "qs8": 1}.get(kind, 2)
    x_row = -(-k_split * es // 128) * 128 + {4: 16, 2: 64, 1: 32}[es]
    lut = 16384 if kind in ("lut", "lut32") else 0
    return ring + lut + 8 * nt * x_row


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("kind", ["q4k", "lut", "lut32", "i8g", "q8",
                                  "qs8", "int8"])
def test_k12_k16_stream_blocks_fit_two_an_sm(kind, sms):
    """At every m 1-64 and QuIP#'s and Mistral-7B's shapes the plan's
    splits are runs of whole 32-row units (K15's of 128-row groups), none
    empty, each block's x within `_STREAM_X_BYTES`, and a block's shared
    memory (with the 1 KB the card reserves per block) lets two blocks
    share an SM's 228 KB, as the kernel's launch bounds ask."""
    unit = 128 if kind == "qs8" else 32
    x_bytes = {"lut32": 4, "qs8": 1}.get(kind, 2)
    bits = 8 if kind in ("i8g", "q8", "qs8", "int8") else 4
    for K, N in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                 (4096, 12288), (4096, 22016), (11008, 4096)):
        if K % unit:
            continue
        for m in range(1, 65):
            block_m, splits = tqm.stream_plan(m, K, N, unit, sms, bits,
                                              x_bytes)
            units = K // unit
            per = -(-units // splits)
            assert -(-units // per) == splits
            rows = min(block_m, 32)
            assert rows * per * unit * x_bytes <= tqm._STREAM_X_BYTES
            nt = rows // 8
            assert 2 * (_stream_smem(kind, per * unit, nt) + 1024) <= \
                233472


# K16 on f32 x at m > 64 (`gemm_plan` over 64-row chunks, 128 x 128
# tiles) on 132 SMs, at Mistral-7B's and QuIP#'s Llama-2-7B shapes.
@pytest.mark.parametrize("m,K,N,want", [
    (65, 4096, 4096, (4, 16)),      # 32 tiles: 4 splits of 16 chunks
    (72, 4096, 6144, (2, 32)),      # 48 tiles
    (128, 4096, 28672, (1, 64)),    # 224 tiles cover the SMs
    (128, 14336, 4096, (4, 56)),
    (256, 4096, 4096, (2, 32)),     # 2 row tiles x 32
    (512, 14336, 4096, (1, 224)),
    (4096, 4096, 6144, (1, 64)),
    (65, 4096, 12288, (1, 64)),     # 96 tiles
    (65, 11008, 4096, (4, 43)),     # 172 chunks: 4 splits of 43
    (200, 4096, 22016, (1, 64)),
])
def test_k16_x32_gemm_plan_table(m, K, N, want):
    assert tqm.gemm_plan(m, K, N, 64, 132, block_n=tqm.X32_BLOCK_N) == want


# ---- K14 at m <= 64 (quant_stream_kernel's kI8g decoder), emulated ----
#
# A ring stage holds the block's 128 columns of int8 codes for 128 k rows,
# 16-byte piece c of row r at byte i8g_piece(r, c) = 128 r + 16 (c ^ (r >>
# 2) & 7), then the stage's eight d16 rows, 72 words apart. One
# ldmatrix.x4.trans a k32 step (lane l gives row l % 8 of matrix l // 8:
# k row 8 (j // 2) + r + 4 (j % 2) of the step, j = l % 8, r = l // 8)
# hands lane (gid, t) rows 8t + r and 8t + r + 4 of its columns c0 = 16
# warp + 2 gid and c0 + 1 in register r: K7's fragment map (`_k7_a_map`).
# Each code becomes bf16(fma(2^23 + (q ^ 0x80), d, -(2^23 + 128) d)).

_I8G_D16 = 16384          # byte offset of a stage's d16 rows
_I8G_D16_WORDS = 72       # words from one d16 row to the next


def _i8g_piece(r, c):
    return r * 128 + ((c ^ ((r >> 2) & 7)) << 4)


def _i8g_lane_row(lane):
    """The k row of a step whose address lane `lane` gives ldmatrix."""
    r, j = lane >> 3, lane & 7
    return 8 * (j >> 1) + r + 4 * (j & 1)


def _i8g_stage(codes, d16_bits):
    """The stage's bytes as the kernel's copies place them: int8 codes
    [128, 128], then bf16 bits d16 [8, 128]."""
    stage = np.zeros(_I8G_D16 + 8 * _I8G_D16_WORDS * 4, np.uint8)
    raw = np.ascontiguousarray(codes).view(np.uint8)
    for r in range(128):
        for c in range(8):
            at = _i8g_piece(r, c)
            assert not stage[at:at + 16].any()
            stage[at:at + 16] = raw[r, 16 * c:16 * c + 16]
    d = np.ascontiguousarray(d16_bits.astype(np.uint16)).view(np.uint8)
    for g in range(8):
        at = _I8G_D16 + g * _I8G_D16_WORDS * 4
        stage[at:at + 256] = d[g]
    return stage


def _ldsm_x4_trans(stage, addrs):
    """ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 for one warp: lane l
    gives addrs[l], row l % 8 of matrix l // 8; lane (gid, t) gets rows 2t
    (low half) and 2t + 1 (high half) of b16 column gid of each matrix.
    Returns uint64 [32, 4]."""
    regs = np.zeros((32, 4), np.uint64)
    for lane in range(32):
        gid, t = lane >> 2, lane & 3
        for i in range(4):
            v = 0
            for e in range(2):
                a = addrs[8 * i + 2 * t + e] + 2 * gid
                v |= (int(stage[a]) | int(stage[a + 1]) << 8) << (16 * e)
            regs[lane, i] = v
    return regs


def _fma32(a, b, c):
    """fma.rn.f32 of an f32 a and a bf16 b (exact product in float64: 24 by
    8 significant bits) where the sum with c is exact in float64 (checked):
    that sum, rounded once to f32."""
    b = b.astype(np.float64)
    assert np.array_equal(_bf16_bits_to_f64(_bf16_bits(b)), b)
    p = a.astype(np.float64) * b
    assert not _two_sum_err(p, c.astype(np.float64)).any()
    return (p + c.astype(np.float64)).astype(np.float32)


def _i8g_values(w, byte, d):
    """The decoder on byte `byte` of words w (q ^ 0x80 already applied) at
    f32 scales d: fma(2^23 + byte, d, fl(-(2^23 + 128) d)) in f32."""
    a = (((np.asarray(w, np.uint64) >> np.uint64(8 * byte)) & np.uint64(0xFF))
         | np.uint64(0x4B000000)).astype(np.uint32).view(np.float32)
    e = (np.float32(-8388736.0) * np.asarray(d, np.float32)).astype(
        np.float32)
    return _fma32(a, np.asarray(d, np.float32), e)


def _i8g_fragments(stage, warp, b, loads=None):
    """step_fragments (with i8g_lane and the loop's d16 pair) of kI8g for
    every lane of `warp` at k32 step b: uint64 [32, 2, 4] A registers.
    `loads` collects the ldmatrix's row addresses and the d16 words."""
    lane = np.arange(32)
    gid, t = lane >> 2, lane & 3
    addrs = [b * 32 * 128 + _i8g_piece(_i8g_lane_row(l), warp)
             for l in range(32)]
    v = _ldsm_x4_trans(stage, addrs)
    c0 = 16 * warp + 2 * gid
    at = _I8G_D16 // 4 + (2 * b + (t >> 1)) * _I8G_D16_WORDS + c0 // 2
    d2 = stage.view(np.uint32)[at].astype(np.uint64)
    if loads is not None:
        loads.append((addrs, at))
    d = [_bf16_bits_to_f64(d2 & np.uint64(0xFFFF)),
         _bf16_bits_to_f64(d2 >> np.uint64(16))]
    regs = np.zeros((32, 2, 4), np.uint64)
    for r in range(4):
        w = v[:, r] ^ np.uint64(0x80808080)
        regs[:, r >> 1, 2 * (r & 1)] = _bf2(_i8g_values(w, 0, d[0]),
                                            _i8g_values(w, 2, d[0]))
        regs[:, r >> 1, 2 * (r & 1) + 1] = _bf2(_i8g_values(w, 1, d[1]),
                                                _i8g_values(w, 3, d[1]))
    return regs


def _i8g_problem(seed):
    """One stage: int8 codes [128, 128] over all 256 values, d16 [8, 128]
    bf16 over normals of 2^-30 .. 2^20, subnormals and zero, either sign."""
    rs = np.random.RandomState(seed)
    codes = rs.randint(-128, 128, (128, 128)).astype(np.int8)
    d = (1 + rs.rand(8, 128)) * 2.0 ** rs.randint(-30, 21, (8, 128)) * \
        np.where(rs.rand(8, 128) < 0.5, -1, 1)
    d[rs.rand(8, 128) < 0.05] = 0
    sub = rs.rand(8, 128) < 0.1
    d[sub] = rs.randint(1, 128, sub.sum()) * 2.0 ** -133
    d16 = torch.from_numpy(d).to(torch.bfloat16)
    bits = d16.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    return codes, d16, bits


def test_k14_stream_fragment_map_covers_the_tile():
    """Every (k, n) of each warp's four k32 steps of a stage lands once in
    the lane's A registers, through the ldmatrix of the swizzled stage and
    the byte decoder, equal to the plain version's dequantized weight
    (`gguf_i8g_matmul_plain`'s `_dequant`) bit for bit."""
    codes, d16, bits = _i8g_problem(14)
    stage = _i8g_stage(codes, bits)
    want = tqm._dequant(torch.from_numpy(codes), d16, 16,
                        torch.bfloat16).double().numpy()
    amap = _k7_a_map(False)
    for warp in range(8):
        for b in range(4):
            regs = _i8g_fragments(stage, warp, b)
            seen = set()
            for (lane, s, i, e), (col, k) in amap.items():
                n, kk = 16 * warp + col, 32 * b + k
                seen.add((n, kk))
                got = _bf16_bits_to_f64(np.array(
                    [(int(regs[lane, s, i]) >> (16 * e)) & 0xFFFF]))[0]
                assert got == want[kk, n], (warp, b, lane, s, i, e)
            assert len(seen) == 16 * 32


def test_k14_stream_stage_loads_are_conflict_free():
    """The stage's copies and loads: every 16-byte piece of its 128 rows
    has one 16-byte aligned place; for every warp and step, the eight row
    addresses of each of the ldmatrix's four matrices fall in eight
    distinct 16-byte bank groups (one wavefront a matrix), and the 32
    lanes' d16 loads put no two words in one bank."""
    places = sorted(_i8g_piece(r, c) for r in range(128) for c in range(8))
    assert places == list(range(0, _I8G_D16, 16))
    codes, _, bits = _i8g_problem(15)
    stage = _i8g_stage(codes, bits)
    n_loads = 0
    for warp in range(8):
        for b in range(4):
            loads = []
            _i8g_fragments(stage, warp, b, loads)
            addrs, d16_words = loads[0]
            for i in range(4):
                rows = addrs[8 * i:8 * i + 8]
                assert all(a % 16 == 0 for a in rows)
                assert len({(a // 16) % 8 for a in rows}) == 8
                n_loads += 1
            by_bank = {}
            for wd in d16_words.tolist():
                by_bank.setdefault(wd % 32, set()).add(wd)
            assert all(len(v) == 1 for v in by_bank.values())
    assert n_loads == 8 * 4 * 4


def test_k14_stream_decoder_equals_the_plain_dequant():
    """The decoder's arithmetic for all 256 codes and every d16 of a spread
    (every bf16 subnormal, normals of 2^-126 .. 2^100 at 16 mantissas a
    binade, zero, either sign): bf16(fma(2^23 + (q ^ 0x80), d, -(2^23 +
    128) d)) equals the plain version's bf16(f32(q) * f32(d)) bit for bit
    wherever q d is not zero, and where it is zero both are zero (the fma
    gives +0 where the plain product may be -0; a product or a sum with
    either gives the same value). The fma is exact while -(2^23 + 128) d
    is a finite f32, |d| < 2^104; GGUF's scales are far below that."""
    sub = np.arange(1, 0x80, dtype=np.uint32)
    norm = np.array([(e << 7) | m for e in range(1, 127 + 101)
                     for m in range(0, 128, 8)], np.uint32)
    pos = np.concatenate([[0], sub, norm])
    d_bits = np.concatenate([pos, pos | 0x8000])
    d = _bf16_bits_to_f64(d_bits)
    assert np.abs(d).max() < 2.0 ** 104 and (np.abs(d) < 2.0 ** -126).sum() \
        == 2 * 128
    q = np.arange(-128, 128)
    w = (q.astype(np.int64) & 0xFF) ^ 0x80        # the byte after the XOR
    got = _bf2(_i8g_values(w[:, None], 0, d[None, :]), 0.0) & \
        np.uint64(0xFFFF)
    d16 = torch.from_numpy(d_bits.astype(np.uint16).view(np.int16)[None, :]
                           ).view(torch.bfloat16)
    want = tqm._dequant(torch.from_numpy(q.astype(np.int8))[:, None],
                        d16, 256, torch.bfloat16)
    want = want.view(torch.int16).numpy().astype(np.uint64) & \
        np.uint64(0xFFFF)
    zero = (q[:, None] == 0) | (d[None, :] == 0)
    assert np.array_equal(got[~zero], want[~zero])
    assert (got[zero] == 0).all() and \
        (_bf16_bits_to_f64(want[zero]) == 0).all()
    assert (got[~zero] & np.uint64(0x7FFF)).all()   # no product underflows


# K14's plan on quant_stream_kernel, m <= 16 (`stream_plan` over 32-row
# units at 8 bits: the f32 partials' cap counts the byte codes) on 132
# SMs, at Mistral-7B's four projections.
@pytest.mark.parametrize("m,K,N,want", [
    (1, 4096, 6144, (8, 11)),
    (1, 4096, 4096, (8, 16)),
    (1, 4096, 28672, (8, 3)),
    (1, 14336, 4096, (8, 17)),
    (8, 4096, 6144, (8, 11)),       # 4 bits: 6 (a tenth of half the bytes)
    (8, 4096, 4096, (8, 12)),       # 4 bits: 6
    (8, 4096, 28672, (8, 3)),
    (8, 14336, 4096, (8, 17)),
    (9, 4096, 6144, (16, 11)),      # 4 bits: 5
    (16, 4096, 4096, (16, 6)),      # 4 bits: 5
    (16, 4096, 28672, (16, 3)),
    (16, 14336, 4096, (16, 17)),    # 4 bits: 11
])
def test_k14_stream_plan_table(m, K, N, want):
    assert tqm.stream_plan(m, K, N, 16, 132, 8, 2) == want
    assert tqm.stream_plan(m, K, N, 32, 132, 8, 2) == want


# ---- K13 and K17 at decode (quant_stream_kernel's kQ8 / kInt8), emulated ----
#
# K14's stage and ldmatrix (above) with other scale rows: K13's stage
# carries its four d rows (a row per 32 k rows, 64 words each, unpadded)
# after the 128 code rows, K17's none. Each code becomes bf16(q) exactly
# (`i8_pair`: a byte permute puts 0x43 above the code, two masks and a
# bf16x2 subtraction), bytes 0 and 2 of a register (column c0, rows r
# and r + 4) into one pair and bytes 1 and 3 (c0 + 1) into the other;
# K13 multiplies each pair by its column's (d, d) in one bf16x2 multiply.

_Q8_D = 16384             # byte offset of a K13 stage's d rows
_Q8_D_WORDS = 64          # words from one d row to the next


def _byte_stage(codes, d_bits=None):
    """K13's (with bf16 bits d [4, 128]), K15's (s128 [1, 128]) or K17's
    (without) stage bytes as the kernel's copies place them."""
    rows = 0 if d_bits is None else len(d_bits)
    stage = np.zeros(_Q8_D + rows * _Q8_D_WORDS * 4, np.uint8)
    raw = np.ascontiguousarray(codes).view(np.uint8)
    for r in range(128):
        for c in range(8):
            stage[_i8g_piece(r, c):_i8g_piece(r, c) + 16] = \
                raw[r, 16 * c:16 * c + 16]
    if rows:
        d = np.ascontiguousarray(d_bits.astype(np.uint16)).view(np.uint8)
        for g in range(rows):
            at = _Q8_D + g * _Q8_D_WORDS * 4
            assert not stage[at:at + 256].any()
            stage[at:at + 256] = d[g]
    return stage


def _i8_pair(w, sel):
    """gemm::i8_pair: the two codes `sel` picks as an exact bf16 pair."""
    t = _prmt(w, 0x43434343, sel)
    return _bf2_sub(t & np.uint64(0xFF7FFF7F), t & np.uint64(0xFF80FF80))


def _byte_fragments(kind, stage, warp, b, loads=None):
    """step_fragments of kQ8 ("q8", with the loop's d pair) or kInt8
    ("int8") for every lane of `warp` at k32 step b: uint64 [32, 2, 4] A
    registers. `loads` collects the ldmatrix's row addresses and the d
    words."""
    lane = np.arange(32)
    gid, t = lane >> 2, lane & 3
    addrs = [b * 32 * 128 + _i8g_piece(_i8g_lane_row(l), warp)
             for l in range(32)]
    v = _ldsm_x4_trans(stage, addrs)
    at = None
    if kind == "q8":
        at = _Q8_D // 4 + b * _Q8_D_WORDS + (16 * warp + 2 * gid) // 2
        d2 = stage.view(np.uint32)[at].astype(np.uint64)
        s0, s1 = _prmt(d2, d2, 0x1010), _prmt(d2, d2, 0x3232)
    if loads is not None:
        loads.append((addrs, at))
    regs = np.zeros((32, 2, 4), np.uint64)
    for r in range(4):
        p0, p1 = _i8_pair(v[:, r], 0x4240), _i8_pair(v[:, r], 0x4341)
        if kind == "q8":
            p0, p1 = _bf2_mul(p0, s0), _bf2_mul(p1, s1)
        regs[:, r >> 1, 2 * (r & 1)] = p0
        regs[:, r >> 1, 2 * (r & 1) + 1] = p1
    return regs


def _bf16_spread():
    """bf16 bits of +-0, every subnormal and every finite normal binade
    at 16 mantissas, either sign."""
    sub = np.arange(1, 0x80, dtype=np.uint32)
    norm = np.array([(e << 7) | m for e in range(1, 255)
                     for m in range(0, 128, 8)], np.uint32)
    pos = np.concatenate([[0], sub, norm, [0x7F7F]])   # and the largest
    return np.concatenate([pos, pos | 0x8000])


def _byte_problem(seed):
    """One stage: codes [128, 128] over all 256 values, d [4, 128] bf16
    bits drawn from `_bf16_spread` (zeros, subnormals, huge values)."""
    rs = np.random.RandomState(seed)
    codes = rs.randint(-128, 128, (128, 128)).astype(np.int8)
    codes[:2] = np.arange(-128, 128).astype(np.int8).reshape(2, 128)
    bits = rs.choice(_bf16_spread(), (4, 128)).astype(np.int64)
    d = torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(
        torch.bfloat16)
    return codes, d, bits


@pytest.mark.parametrize("kind", ["q8", "int8"])
def test_k13_k17_stream_fragment_map_covers_the_tile(kind):
    """Every (k, n) of each warp's four k32 steps of a stage lands once in
    the lane's A registers through the ldmatrix of the swizzled stage and
    the kQ8 / kInt8 decoder, equal bit for bit (zeros' signs too) to the
    plain version's weight: K13's bf16(f32(q) * f32(d[k // 32]))
    (`gguf_q8_matmul_plain`'s `_dequant`), K17's bf16(q) (its column
    scale comes after the sums)."""
    codes, d, bits = _byte_problem(13 if kind == "q8" else 17)
    stage = _byte_stage(codes, bits if kind == "q8" else None)
    q = torch.from_numpy(codes)
    w = tqm._dequant(q, d, 32, torch.bfloat16) if kind == "q8" else \
        q.to(torch.bfloat16)
    want = w.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    amap = _k7_a_map(False)
    for warp in range(8):
        for b in range(4):
            regs = _byte_fragments(kind, stage, warp, b)
            seen = set()
            for (lane, s, i, e), (col, k) in amap.items():
                n, kk = 16 * warp + col, 32 * b + k
                seen.add((n, kk))
                got = (int(regs[lane, s, i]) >> (16 * e)) & 0xFFFF
                assert got == want[kk, n], (warp, b, lane, s, i, e)
            assert len(seen) == 16 * 32


def test_k13_stream_stage_rows_and_loads():
    """K13's stage: the four d rows lie after the 128 code rows, one
    (unpadded, 64 words) a 32-row group; for every warp and step each
    lane's d word is its columns' pair in row b, the group of all 8 of its
    rows (8t .. 8t + 7 of the step); the 32 lanes' d loads touch 8
    neighbouring words, a quad sharing one (a broadcast), so no two words
    in one bank; and the ldmatrix's rows are K14's, one wavefront a
    matrix."""
    codes, _, bits = _byte_problem(130)
    stage = _byte_stage(codes, bits)
    assert stage.size == 128 * 128 + 4 * 128 * 2
    lane = np.arange(32)
    gid, t = lane >> 2, lane & 3
    for warp in range(8):
        for b in range(4):
            loads = []
            _byte_fragments("q8", stage, warp, b, loads)
            addrs, at = loads[0]
            row = (at - _Q8_D // 4) // _Q8_D_WORDS
            assert (row == b).all()
            assert ((32 * b + 8 * t) // 32 == row).all()
            assert ((32 * b + 8 * t + 7) // 32 == row).all()
            assert ((at - _Q8_D // 4) % _Q8_D_WORDS ==
                    (16 * warp + 2 * gid) // 2).all()
            by_bank = {}
            for wd in at.tolist():
                by_bank.setdefault(wd % 32, set()).add(wd)
            assert all(len(v) == 1 for v in by_bank.values())
            assert len(set(at.tolist())) == 8
            for i in range(4):
                rows = addrs[8 * i:8 * i + 8]
                assert len({(a // 16) % 8 for a in rows}) == 8


def test_k13_stream_decoder_equals_the_plain_dequant_bit_for_bit():
    """kQ8's arithmetic for all 256 codes and every d of a spread (+-0,
    every bf16 subnormal, every finite binade at 16 mantissas up to the
    largest bf16, either sign): `i8_pair` then one bf16x2 multiply by (d,
    d) equals the plain version's bf16(f32(q) * f32(d)) bit for bit, the
    zeros' signs and the products past bf16's range (inf) included: q d
    is exact in f32 (8 by 8 significant bits, subnormal products on
    2^-133 steps), so both round the exact product once."""
    d_bits = _bf16_spread()
    q = np.arange(-128, 128)
    w = (q.astype(np.int64) & 0xFF)[:, None] | 0x43004300   # any word
    pair = _i8_pair(np.broadcast_to(w, (256, d_bits.size)), 0x4240)
    d2 = np.broadcast_to(d_bits.astype(np.uint64) * np.uint64(0x10001),
                         (256, d_bits.size))
    got = _bf2_mul(pair, d2) & np.uint64(0xFFFF)
    d = torch.from_numpy(d_bits.astype(np.uint16).view(np.int16)[None, :]
                         ).view(torch.bfloat16)
    want = tqm._dequant(torch.from_numpy(q.astype(np.int8))[:, None], d,
                        256, torch.bfloat16)
    want = want.view(torch.int16).numpy().astype(np.uint64) & \
        np.uint64(0xFFFF)
    assert np.array_equal(got, want)
    assert (want == 0x8000).any() and (want == 0x7F80).any() and \
        (want == 0xFF80).any()          # -0, +inf and -inf are reached


def test_k17_stream_decoder_is_exact():
    """kInt8's arithmetic: `i8_pair` on bytes (0, 2) and (1, 3) of a
    register gives bf16(q) of each byte, bit for bit, for all 256 codes
    in every byte position: what the plain version's f32 codes hold."""
    q = np.arange(-128, 128)
    b = (q.astype(np.int64) & 0xFF).astype(np.uint64)
    rs = np.random.RandomState(17)
    other = rs.randint(0, 256, (3, 256)).astype(np.uint64)
    want = torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16)
    want = want.view(torch.int16).numpy().astype(np.uint64) & \
        np.uint64(0xFFFF)
    for pos in range(4):
        bytes_ = list(other)
        bytes_.insert(pos, b)
        w = sum(v << np.uint64(8 * i) for i, v in enumerate(bytes_))
        sel, half = (0x4240, pos // 2) if pos % 2 == 0 else \
            (0x4341, pos // 2)
        got = (_i8_pair(w, sel) >> np.uint64(16 * half)) & np.uint64(0xFFFF)
        assert np.array_equal(got, want), pos


@pytest.mark.parametrize("splits", [1, 3])
def test_k17_stream_epilogue_order_equals_the_plain_version(splits):
    """K17's stream epilogue: the f32 sums (in split order through the
    split reduce), times the column's f32 scale, rounded once to bf16.
    With integer x the f32 sums are exact in any order, so the emulated
    order equals `int8_matmul_plain` bit for bit; rounding the sum to
    bf16 before the scale, or scaling each split's partial, does not."""
    rs = np.random.RandomState(170 + splits)
    m, K, N = 8, 384, 256
    x = rs.randint(-8, 9, (m, K)).astype(np.float32)
    w = rs.randint(-127, 128, (K, N)).astype(np.int8)
    s = (rs.rand(N) * 4e-4 + 1e-4).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(xt.float(), torch.from_numpy(x))
    want = tqm.int8_matmul_plain(xt, torch.from_numpy(w),
                                 torch.from_numpy(s))
    f32 = np.float32
    parts = [x[:, k0:k0 + K // splits].astype(np.float64) @
             w[k0:k0 + K // splits].astype(np.float64)
             for k0 in range(0, K, K // splits)]
    acc = f32(0)
    for p in parts:
        assert np.array_equal(p.astype(f32), p)          # exact partials
        acc = (acc + p.astype(f32)).astype(f32)
    got = torch.from_numpy((acc * s).astype(f32)).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    early = torch.from_numpy(acc).to(torch.bfloat16).float() * \
        torch.from_numpy(s)
    assert not torch.equal(early.to(torch.bfloat16), want)
    if splits > 1:
        each = sum(torch.from_numpy((p.astype(f32) * s).astype(f32))
                   for p in parts)
        assert not torch.equal(each.to(torch.bfloat16), want)


# K13's and K17's plan on quant_stream_kernel (`stream_plan` over 32-row
# units at 8 bits, K14's) on 132 SMs at Mistral-7B's four projections:
# m <= 16 is the wrappers' route; 17-64 the stream route the timing
# tool forces to compare it with the gemm.
@pytest.mark.parametrize("m,K,N,want", [
    (1, 4096, 6144, (8, 11)),
    (1, 4096, 4096, (8, 16)),
    (1, 4096, 28672, (8, 3)),
    (1, 14336, 4096, (8, 17)),
    (8, 4096, 6144, (8, 11)),
    (8, 4096, 4096, (8, 12)),
    (8, 4096, 28672, (8, 3)),
    (8, 14336, 4096, (8, 17)),
    (16, 4096, 6144, (16, 6)),
    (16, 4096, 4096, (16, 6)),
    (16, 4096, 28672, (16, 3)),
    (16, 14336, 4096, (16, 17)),
    (17, 4096, 4096, (32, 6)),
    (32, 14336, 4096, (32, 14)),
    (64, 4096, 28672, (64, 4)),       # x of 32 rows: 4 splits at least
    (64, 14336, 4096, (64, 14)),
])
def test_k13_k17_stream_plan_table(m, K, N, want):
    assert tqm.stream_plan(m, K, N, 32, 132, 8, 2) == want


# ---- K15 at decode (quant_stream_kernel's kQs8 on the a8 arm), emulated ----
#
# K14's stage and ldmatrix on K15's int8 codes, the stage's one s128 row
# after the 128 code rows (a 128-row stage is one group). The a8 arm's
# m16n8k32 A register i of a lane holds rows 8t + 2e + (i >> 1), e < 4,
# of column c0 + (i & 1) (`_k7_a_map(True)`); each is one byte permute
# of two ldmatrix registers. The group's exact int32 sums are folded into
# f32 with the stage's s128 pair when its four steps are done.


def _qs8_stage(qs8, s128_bits, k0, n0):
    """The ring stage of block column n0 at k rows [k0, k0 + 128), as the
    kernel's copies place it: the codes' 16-byte pieces (`i8g_piece`),
    then s128 row k0 // 128 of the block's 128 columns."""
    rows = s128_bits[k0 // 128:k0 // 128 + 1, n0:n0 + 128]
    return _byte_stage(qs8[k0:k0 + 128, n0:n0 + 128], rows)


def _qs8_fragments(stage, warp, b):
    """step_fragments of kQs8 for every lane of `warp` at k32 step b:
    uint64 [32, 4] s8 A registers (a[0][i])."""
    addrs = [b * 32 * 128 + _i8g_piece(_i8g_lane_row(l), warp)
             for l in range(32)]
    v = _ldsm_x4_trans(stage, addrs)
    return np.stack([_prmt(v[:, 0], v[:, 2], 0x6240),
                     _prmt(v[:, 0], v[:, 2], 0x7351),
                     _prmt(v[:, 1], v[:, 3], 0x6240),
                     _prmt(v[:, 1], v[:, 3], 0x7351)], axis=1)


def test_k15_stream_fragment_map_covers_the_tile():
    """Every (k, n) byte of each warp's four k32 steps of a stage lands
    once in the lane's s8 A registers, as the code (all 256 byte values
    at each of a register's four places), through the swizzled stage,
    the ldmatrix and the byte permutes, in the k order in which the a8
    arm stages K9's rows (each 8-row run permuted to rows 0, 2, 4, 6, 1,
    3, 5, 7; a lane's B bytes of a step one 8-byte load), so the step's
    products are qs8^T x8 exactly; and the s128 pair each lane's fold
    reads (word kRowsOff + c0 / 2) is the stage's group's scale of
    columns c0 and c0 + 1, for stages at other k rows and block
    columns."""
    rs = np.random.RandomState(15)
    K, N = 384, 256
    qs8 = rs.randint(-128, 128, (K, N)).astype(np.int8)
    qs8[:2, :128] = np.arange(-128, 128).astype(np.int8).reshape(2, 128)
    s128 = torch.from_numpy(rs.rand(K // 128, N).astype(np.float32)).to(
        torch.bfloat16)
    bits = s128.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    x8 = rs.randint(-127, 128, (8, K)).astype(np.int64)
    xp = x8.reshape(8, -1, 8)[:, :, [0, 2, 4, 6, 1, 3, 5, 7]].reshape(8, -1)
    amap = _k7_a_map(True)
    lane = np.arange(32)
    gid = lane >> 2
    for ln in range(32):         # B: byte e of register i is k 8t + 2e + i
        for j in range(8):
            i, e = j // 4, j % 4
            assert (xp[ln >> 2, 8 * (ln & 3) + j] ==
                    x8[ln >> 2, 8 * (ln & 3) + 2 * e + i])
    for k0, n0 in ((0, 0), (128, 128), (256, 0)):
        stage = _qs8_stage(qs8, bits, k0, n0)
        assert stage.size == 128 * 128 + 256     # 16.25 KB
        words = stage.view(np.uint32)
        for warp in range(8):
            c0 = 16 * warp + 2 * gid
            s2 = words[128 * 32 + c0 // 2].astype(np.int64)
            assert (s2 & 0xFFFF == bits[k0 // 128, n0 + c0]).all()
            assert (s2 >> 16 == bits[k0 // 128, n0 + c0 + 1]).all()
            for b in range(4):
                regs = _qs8_fragments(stage, warp, b)
                seen = set()
                a_tile = np.zeros((16, 32), np.int64)
                for (ln, _, i, e), (col, k) in amap.items():
                    byte = (int(regs[ln, i]) >> (8 * e)) & 0xFF
                    got = byte - 256 if byte > 127 else byte
                    n, kk = n0 + 16 * warp + col, k0 + 32 * b + k
                    assert got == qs8[kk, n], (k0, n0, warp, b, ln, i, e)
                    seen.add((n, kk))
                    a_tile[col, k] = got
                assert len(seen) == 16 * 32
                kb, nb = k0 + 32 * b, n0 + 16 * warp
                assert np.array_equal(
                    a_tile @ x8[:, kb:kb + 32].T,
                    qs8[kb:kb + 32, nb:nb + 16].astype(np.int64).T @
                    x8[:, kb:kb + 32].T)


def _k15_stream_order(x8, xs, qs8, s128, splits):
    """quant_stream_kernel<8, kQs8>'s arithmetic in its order, in numpy
    float32 (one rounding an operation): each split a run of whole
    128-row groups; per group the exact int32 dot, acc = acc +
    f32(float(dot) * s) in group order from 0; one split: bf16(acc *
    xs); more: the split reduce's sum of the splits' acc in split order
    from 0, then times xs, then bf16."""
    f32 = np.float32
    x = x8.numpy().astype(np.int64)
    q = qs8.numpy().astype(np.int64)
    s = s128.float().numpy()
    groups = x.shape[1] // 128
    per = -(-groups // splits)
    parts = []
    for g0 in range(0, groups, per):
        acc = np.zeros((x.shape[0], q.shape[1]), f32)
        for g in range(g0, min(groups, g0 + per)):
            dot = x[:, 128 * g:128 * g + 128] @ q[128 * g:128 * g + 128]
            assert np.abs(dot).max() < 2 ** 24     # exact in f32
            acc = (acc + (dot.astype(f32) * s[g]).astype(f32)).astype(f32)
        parts.append(acc)
    total = parts[0]
    if len(parts) > 1:
        total = np.zeros_like(parts[0])
        for p in parts:
            total = (total + p).astype(f32)
    out = (total * xs.numpy().astype(f32)).astype(f32)
    return torch.from_numpy(out).to(torch.bfloat16)


@pytest.mark.parametrize("splits", [1, 3])
def test_k15_stream_order_equals_the_plain_version(splits):
    """The emulated kernel order against `gguf_w8a8_launch_plain` on K9's
    rows: unsplit (the plain version's group order) bit for bit; over
    three splits (the split reduce's order) within the card tests'
    tolerance, 2e-2 + 2e-2 |plain| (bf16 outputs of f32 sums in another
    order)."""
    rs = np.random.RandomState(150 + splits)
    m, K, N = 8, 768, 256
    x = torch.from_numpy(rs.randn(m, K).astype(np.float32))
    qs8 = torch.from_numpy(rs.randint(-127, 128, (K, N)).astype(np.int8))
    s128 = torch.from_numpy((rs.rand(K // 128, N) * 0.002 + 1e-4).astype(
        np.float32)).to(torch.bfloat16)
    x8, xs = tqm.quantize_activations_int8(x)
    want = tqm.gguf_w8a8_launch_plain(x8, xs, qs8, s128)
    got = _k15_stream_order(x8, xs, qs8, s128, splits)
    if splits == 1:
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2e-2 + 2e-2 * want.float().abs()).all())
    # Scaling each group by xs before the fold is not the kernel's order.
    early = _k15_stream_order(x8, torch.ones_like(xs), qs8, s128, 1)
    assert not torch.equal(early, want)


# K15's plan on quant_stream_kernel (`stream_plan` over its 128-row
# groups, 8-bit codes, int8 x) on 132 SMs at Mistral-7B's four
# projections: m <= 12 is the wrapper's route; 13-64 the stream route
# the timing tool forces to compare it with the gemm.
@pytest.mark.parametrize("m,K,N,want", [
    (1, 4096, 6144, (8, 11)),
    (1, 4096, 4096, (8, 16)),
    (1, 4096, 28672, (8, 3)),
    (1, 14336, 4096, (8, 16)),       # 112 groups: runs of 7
    (8, 4096, 6144, (8, 11)),
    (8, 4096, 4096, (8, 11)),        # 12 wanted: runs of 3 groups
    (8, 4096, 28672, (8, 3)),
    (8, 14336, 4096, (8, 16)),
    (16, 4096, 6144, (16, 6)),
    (16, 4096, 4096, (16, 6)),
    (16, 4096, 28672, (16, 3)),
    (16, 14336, 4096, (16, 16)),
    (17, 4096, 4096, (32, 6)),
    (32, 14336, 4096, (32, 11)),
    (64, 4096, 28672, (64, 2)),      # int8 x of 32 rows: 2048 a block
    (64, 14336, 4096, (64, 7)),
])
def test_k15_stream_plan_table(m, K, N, want):
    assert tqm.stream_plan(m, K, N, 128, 132, 8, 1) == want


# The routes: kernel -> (wrapper, threshold attribute, stream counter,
# gemm counter).
_BYTE_ROUTES = {
    "k13": ("gguf_q8_matmul", "Q8_STREAM_M_MAX", "gguf_q8_matmul",
            "gguf_q8_gemm"),
    "k14": ("gguf_i8g_matmul", "I8G_STREAM_M_MAX", "gguf_i8g_matmul",
            "gguf_i8g_gemm"),
    "k15": ("gguf_w8a8_launch", "K15_STREAM_M_MAX", "gguf_w8a8_matmul",
            "gguf_w8a8_gemm"),
    "k17": ("int8_matmul", "INT8_STREAM_M_MAX", "int8_matmul", "int8_gemm"),
}


def _byte_route_args(kernel, m, K, N):
    if kernel == "k15":         # K9's rows and their scales
        return (torch.zeros(m, K, dtype=torch.int8), torch.ones(m, 1),
                torch.zeros(K, N, dtype=torch.int8),
                torch.ones(K // 128, N, dtype=torch.bfloat16))
    x = torch.zeros(m, K, dtype=torch.bfloat16)
    w = torch.zeros(K, N, dtype=torch.int8)
    if kernel == "k17":
        return x, w, torch.ones(N)
    G = 32 if kernel == "k13" else 16
    return x, w, torch.ones(K // G, N, dtype=torch.bfloat16)


def _byte_stream_plan(kernel, m, K, N):
    """A byte decoder's `stream_plan` at m on 132 SMs: K13, K14 and K17
    over 32-row units of bf16 x, K15 over 128-row groups of int8 x."""
    return tqm.stream_plan(m, K, N, 128, 132, 8, 1) if kernel == "k15" \
        else tqm.stream_plan(m, K, N, 32, 132, 8, 2)


def _byte_gemm_splits(kernel, m, K, N):
    """A byte decoder's `gemm_plan` splits at m on 132 SMs: K13, K14 and
    K17 over 64-row chunks of 128 x 256 tiles, K15 over 128-row groups of
    128 x 128 tiles."""
    return tqm.gemm_plan(m, K, N, 128, 132, block_n=128)[0] \
        if kernel == "k15" else tqm.gemm_plan(m, K, N, 64, 132)[0]


@pytest.mark.parametrize("kernel", list(_BYTE_ROUTES))
def test_byte_decoders_route_by_the_threshold(kernel, monkeypatch):
    """The wrappers of K13, K14, K15 (alone on K9's rows) and K17, as if
    their tensors were on a card of 132 SMs: m <= its threshold (16; K14
    13, K15 12) goes to quant_stream_kernel (block_m 8 or 16, `stream_plan`'s
    splits, the wrapper's own counter), every larger m to the
    warpgroup-MMA kernel (block_m 128, `gemm_plan`'s splits, the gemm
    counter); `stream` pins either route, and the stream route refuses m
    over 64 (K15's `gguf_w8a8_matmul` before it quantizes x)."""
    name, attr, stream_counter, gemm_counter = _BYTE_ROUTES[kernel]
    threshold = getattr(tqm, attr)
    assert threshold == {"k14": 13, "k15": 12}.get(kernel, 16)
    calls = []
    monkeypatch.setattr(tqm.build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(tqm.build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(
        tqm, "_entry_launch",
        lambda entry, x, ptrs, N, block_m, splits, out_dtype, *, counter,
        what: calls.append((block_m, splits, counter.name)))
    fn = getattr(tqm, name)

    def rows(args, m):          # the wrapper's arguments at m rows
        return (args[0][:m], args[1][:m]) + args[2:] if kernel == "k15" \
            else (args[0][:m],) + args[1:]
    for K, N in ((4096, 6144), (14336, 4096)):
        args = _byte_route_args(kernel, 72, K, N)
        for m in range(1, 73):
            fn(*rows(args, m))
            if m <= threshold:
                want = _byte_stream_plan(kernel, m, K, N) + (stream_counter,)
            else:
                want = (128, _byte_gemm_splits(kernel, m, K, N),
                        gemm_counter)
            assert calls.pop() == want, (K, N, m)
        fn(*rows(args, 40), stream=True)
        assert calls.pop() == _byte_stream_plan(kernel, 40, K, N) + \
            (stream_counter,)
        fn(*rows(args, 8), stream=False)
        assert calls.pop() == (128, _byte_gemm_splits(kernel, 8, K, N),
                               gemm_counter)
        with pytest.raises(ValueError, match="m <= 64"):
            fn(*rows(args, 65), stream=True)
        if kernel == "k15":
            x = torch.zeros(65, K, dtype=torch.bfloat16)
            with pytest.raises(ValueError, match="m <= 64"):
                tqm.gguf_w8a8_matmul(x, *args[2:], stream=True)
    assert not calls


# K9's launch plan (`quant8_plan`) on 132 SMs: threads a row and 16-byte
# runs a thread, at decode m (a 1024-thread target) and at a prompt
# round's (256).
@pytest.mark.parametrize("m,K,want", [
    (1, 1, (32, 1)), (8, 7, (32, 1)), (64, 64, (32, 1)),
    (8, 4096, (512, 1)), (64, 4100, (544, 1)), (1, 14336, (896, 2)),
    (528, 14336, (896, 2)), (32, 28672, (896, 4)),
    (8, 65536, (1024, 8)), (8, 65544, (1024, 8)),
    (529, 4096, (256, 2)), (4096, 2048, (256, 1)), (4096, 4096, (256, 2)),
    (4096, 4100, (160, 4)), (4096, 8192, (256, 4)),
    (4096, 14336, (224, 8)), (4096, 16384, (256, 8)),
    (4096, 28672, (448, 8)), (4096, 65536, (1024, 8)),
])
def test_k9_launch_plan_table(m, K, want):
    assert tqm.quant8_plan(m, K, 132) == want


@pytest.mark.parametrize("m", [1, 4096])
def test_k9_plan_holds_every_row_it_can(m):
    """For every K of whole 16-byte runs up to 1024 x 8 runs the plan's
    threads (a multiple of 32, at most 1024) hold the row in registers,
    with no warp left without a run; past that the kernel takes its
    element path."""
    for K in range(8, 65537, 8):
        threads, per = tqm.quant8_plan(m, K, 132)
        assert threads % 32 == 0 and 32 <= threads <= 1024
        assert per in (1, 2, 4, 8)
        assert threads * per * 8 >= K
        assert (threads - 32) * per * 8 < K
    threads, per = tqm.quant8_plan(m, 65544, 132)
    assert threads * per * 8 < 65544
