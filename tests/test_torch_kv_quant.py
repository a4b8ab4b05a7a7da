"""int8 and fp8 (e5m2) KV pages, the padded-grid decode kernel (K5) and
the AMLA rescale in the PyTorch port against the JAX package, on the
same numpy inputs:

- `ops/kv_quant.quantize_kv` equals the jnp one bit for bit, on values
  that include rounding ties and overflow;
- the plain decode attention against the Pallas bodies run in interpret
  mode: `_decode_kernel_tm` (K5, called without a work list) and
  `_decode_kernel_ragged` (K1, with one), AMLA on and off, with ALiBi
  and the fused write, on bf16, int8 and fp8 pages. Outputs within
  1e-5 (both round the dot operands to bf16 the same way and sum in
  f32; only the order of f32 sums differs); pages written by the fused
  write exactly equal. Interpret mode lowers the int8 write's division
  as a reciprocal multiply, so the injected values sit away from
  rounding ties, where the two agree;
- the KV-cache ops (slot write, CoW copies, the gather) on int8 and fp8
  pages against the JAX ops, exactly (swaps: tests/test_torch_e2e.py).
The CUDA kernels are held against the plain version on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops import kv_cache as jkv
from aphrodite_tpu.ops import kv_quant as jkq
from aphrodite_tpu.ops.pallas import paged_attention as jpa
from aphrodite_tpu_torch.ops import kv_cache as tkv
from aphrodite_tpu_torch.ops import kv_quant as tkq
from aphrodite_tpu_torch.ops.cuda import paged_attention as tpa

S = tkq.DEFAULT_KV_SCALE
PAGE, PPS, PAGES, DIM = 8, 8, 64, 128
CTX = np.array([1, 0, 40, 64, 17], dtype=np.int32)

JAX_DTYPE = {"bf16": jnp.bfloat16, "int8": jnp.int8,
             "fp8": jnp.float8_e5m2}
TORCH_DTYPE = {"bf16": torch.bfloat16, "int8": torch.int8,
               "fp8": torch.float8_e5m2}
NP_DTYPE = {"bf16": ml_dtypes.bfloat16, "int8": np.int8,
            "fp8": ml_dtypes.float8_e5m2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are too small to gain from
    more, and idle OpenMP threads spinning would slow the other test
    workers sharing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(x: np.ndarray, kind: str) -> torch.Tensor:
    """numpy (ml_dtypes) pages -> torch, through their bytes."""
    raw = torch.from_numpy(np.ascontiguousarray(x).view(
        np.int16 if kind == "bf16" else np.uint8).copy())
    return raw.view(TORCH_DTYPE[kind])


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(
        torch.int16 if t.element_size() == 2 else torch.uint8).numpy()


def _jbytes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.uint8)


def _pages(rng, kind, heads):
    """Random pages stored in `kind`: int8 codes of values ~N(0, 1)/S
    (clipped), fp8 and bf16 casts of N(0, 1)."""
    x = rng.normal(size=(PAGES, PAGE, heads * DIM)).astype(np.float32)
    if kind == "int8":
        return np.clip(np.round(x / S), -127, 127).astype(np.int8)
    return x.astype(NP_DTYPE[kind])


def _problem(kind, hq, hkv, seed):
    rng = np.random.default_rng(seed)
    b = len(CTX)
    q = rng.normal(size=(b, hq, DIM)).astype(np.float32)
    q = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    kp, vp = _pages(rng, kind, hkv), _pages(rng, kind, hkv)
    bt = np.zeros((b, PPS), dtype=np.int32)
    perm = rng.permutation(PAGES - 1) + 1
    for i in range(b):
        n = -(-int(max(CTX[i], 1)) // PAGE)
        bt[i, :n] = perm[i * PPS:i * PPS + n]
    # New tokens away from int8 rounding ties: integer codes plus an
    # offset in [-0.3, 0.3], times S.
    off = rng.uniform(-0.3, 0.3, size=(b, hkv, DIM))
    knew = ((rng.integers(-40, 40, size=off.shape) + off) * S).astype(
        ml_dtypes.bfloat16).astype(np.float32)
    vnew = ((rng.integers(-40, 40, size=off.shape) - off) * S).astype(
        ml_dtypes.bfloat16).astype(np.float32)
    return q, kp, vp, bt, knew, vnew


def _both(kind, hq, hkv, ppc, alibi, fused, amla, ragged, seed=0):
    q, kp, vp, bt, knew, vnew = _problem(kind, hq, hkv, seed)
    slopes = np.array([2.0 ** -(i + 1) for i in range(hq)],
                      dtype=np.float32) if alibi else None
    kv_scale = tkq.dequant_scale(TORCH_DTYPE[kind], S)
    work = jpa.build_decode_work_list(
        [-(-int(c) // PAGE) for c in CTX], ppc) if ragged else None
    want = jpa.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(CTX),
        None if slopes is None else jnp.asarray(slopes),
        jnp.asarray(knew, jnp.bfloat16) if fused else None,
        jnp.asarray(vnew, jnp.bfloat16) if fused else None,
        scale=0.1, kv_scale=kv_scale, pages_per_chunk=ppc,
        work_items=work, amla=amla, interpret=True)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q).bfloat16(), _to_torch(kp, kind),
        _to_torch(vp, kind), torch.from_numpy(bt), torch.from_numpy(CTX),
        None if slopes is None else torch.from_numpy(slopes),
        torch.from_numpy(knew).bfloat16() if fused else None,
        torch.from_numpy(vnew).bfloat16() if fused else None,
        scale=0.1, kv_scale=kv_scale, pages_per_chunk=ppc,
        work_items=work, amla=amla)
    return want, got


CASES = [
    # kind, hq, hkv, ppc, alibi, fused, amla
    ("bf16", 8, 2, 2, False, False, True),
    ("bf16", 8, 2, 8, True, True, False),  # one chunk: K5's single_chunk
    ("int8", 8, 2, 2, True, False, False),
    ("int8", 12, 12, 4, False, True, True),  # hb 6: two head blocks
    ("fp8", 8, 1, 2, False, True, False),
    ("fp8", 8, 2, 4, True, False, True),
]


@pytest.mark.parametrize("kind,hq,hkv,ppc,alibi,fused,amla", CASES)
@pytest.mark.parametrize("ragged", [False, True], ids=["K5", "K1"])
def test_plain_matches_pallas_interpret(ragged, kind, hq, hkv, ppc, alibi,
                                        fused, amla):
    """The plain version against `_decode_kernel_tm` (K5, no work list)
    or `_decode_kernel_ragged` (K1, with one)."""
    want, got = _both(kind, hq, hkv, ppc, alibi, fused, amla, ragged)
    if fused:
        (want, wk, wv), (got, gk, gv) = want, got
        np.testing.assert_array_equal(_bytes(gk), _jbytes(wk))
        np.testing.assert_array_equal(_bytes(gv), _jbytes(wv))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-5)
    assert (got.float().numpy()[CTX == 0] == 0).all()


def test_ragged_flag_pins_the_padded_grid(monkeypatch):
    """APHRODITE_ATTN_RAGGED=0 sends a call with a work list to K5 on
    both sides; the JAX function reads the flag at call time."""
    monkeypatch.setenv("APHRODITE_ATTN_RAGGED", "0")
    assert not tpa.ragged_enabled() and not jpa.ragged_enabled()
    want, got = _both("int8", 8, 2, 2, False, False, None, True, seed=4)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("amla", [False, True])
def test_amla_flag_is_read_at_call_time(amla, monkeypatch):
    monkeypatch.setenv("APHRODITE_ATTN_AMLA", "1" if amla else "0")
    assert tpa.amla_enabled() is amla
    want, got = _both("bf16", 8, 2, 2, False, False, None, False, seed=6)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-5)


def test_mul_pow2_flushes_where_the_multiply_keeps_denormals():
    """The two rescale arms differ only at underflow: the exponent-bias
    add maps what would leave the normal range to 0."""
    x = np.array([1.5, -3.0, 2.0 ** -120, 2.0 ** -126, 1e-40, 0.0,
                  3.0e38], dtype=np.float32)
    delta = np.array([-1.0, -4.0, -5.0, -1.0, -1.0, -3.0, -300.0],
                     dtype=np.float32)
    got = tpa._mul_pow2(torch.from_numpy(x), torch.from_numpy(delta))
    want = jpa._mul_pow2(jnp.asarray(x), jnp.asarray(delta))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:2], x[:2] * 2.0 ** delta[:2])
    assert got[2] == 2.0 ** -125 and got[3] == 0.0 and got[4] == 0.0


def test_quantize_kv_matches_jnp_bit_for_bit():
    rng = np.random.default_rng(3)
    ties = (np.arange(-130, 131) + 0.5) * S          # x / S at .5 ties
    x = np.concatenate([
        rng.normal(size=4096) * 3, ties, np.arange(-130, 131) * S,
        [1e6, -1e6, 61440.0, 57344.0, -57344.0, 7.0e4, 1e-9, 0.0,
         6.35, -6.35, 6.4, -6.4]]).astype(np.float32)
    for src in (np.float32, ml_dtypes.bfloat16):
        xs = x.astype(src)
        tx = torch.from_numpy(xs.astype(np.float32))
        if src is not np.float32:
            tx = tx.bfloat16()
        for kind in ("int8", "fp8"):
            got = tkq.quantize_kv(tx, TORCH_DTYPE[kind], S)
            want = jkq.quantize_kv(jnp.asarray(xs), JAX_DTYPE[kind], S)
            np.testing.assert_array_equal(_bytes(got), _jbytes(want))
    assert tkq.dequant_scale(torch.int8, S) == S
    assert tkq.dequant_scale(torch.float8_e5m2, S) == 1.0


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_kv_cache_ops_on_8bit_pages_match_jax(kind):
    """Slot write (quantizing), CoW copies and the gather on 8-bit
    pages, exactly as the JAX ops; CPU torch lacks masked_fill, mul and
    index_copy_ for float8_e5m2, so the ops move bytes."""
    rng = np.random.default_rng(9)
    hd, n_pages, page = 2 * 16, 12, 4
    kp, vp = (_pages(np.random.default_rng(s), kind, 2)[:n_pages, :page,
                                                        :hd]
              for s in (1, 2))
    slots = np.array([5, 48, 17, 0, 47, 30], dtype=np.int32)   # 48: pad
    key = rng.normal(size=(6, 2, 16)).astype(np.float32)
    val = rng.normal(size=(6, 2, 16)).astype(np.float32)
    wk, wv = jkv.write_to_kv_cache(
        jnp.asarray(key), jnp.asarray(val), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(slots), kv_scale=S)
    gk, gv = tkv.write_to_kv_cache(
        torch.from_numpy(key), torch.from_numpy(val), _to_torch(kp, kind),
        _to_torch(vp, kind), torch.from_numpy(slots), kv_scale=S)
    np.testing.assert_array_equal(_bytes(gk), _jbytes(wk))
    np.testing.assert_array_equal(_bytes(gv), _jbytes(wv))

    src = np.array([1, 3, 12, 7], dtype=np.int32)     # 12: out of range
    dst = np.array([9, 10, 2, 12], dtype=np.int32)
    ck, cv = jkv.copy_blocks(wk, wv, jnp.asarray(src), jnp.asarray(dst))
    tk, tv = tkv.copy_blocks(gk, gv, torch.from_numpy(src),
                             torch.from_numpy(dst))
    np.testing.assert_array_equal(_bytes(tk), _jbytes(ck))
    np.testing.assert_array_equal(_bytes(tv), _jbytes(cv))

    idx = np.array([[2, 9, 12], [4, 4, 0]], dtype=np.int32)
    want = jkv.gather_pages(ck, jnp.asarray(idx), 2)
    got = tkv.gather_pages(tk, torch.from_numpy(idx), 2)
    assert got.dtype == TORCH_DTYPE[kind]
    np.testing.assert_array_equal(_bytes(got), _jbytes(want))
