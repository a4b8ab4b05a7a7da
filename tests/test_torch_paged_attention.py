"""Paged decode attention (K1) in the PyTorch port against the JAX
package: the port's plain version against the Pallas kernel run in
interpret mode (`amla=False`, ragged work list) and against the jnp
reference `paged_decode_attention_ref`, on the same numpy inputs.

Tolerances:
- pages written by the fused KV write: exactly equal;
- plain vs Pallas interpret with bf16 pages: 1e-5 (both round the dot
  operands to bf16 the same way and accumulate in f32; only the order
  of f32 sums differs);
- plain vs the jnp reference with f32 pages: 1e-5 (both f32
  throughout).
The CUDA kernel is held against the plain version on the card in
tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops.attention import (
    paged_decode_attention_ref as jax_ref)
from aphrodite_tpu.ops.kv_cache import write_to_kv_cache as jax_write
from aphrodite_tpu.ops.pallas import paged_attention as jpa
from aphrodite_tpu_torch.ops import kv_quant as tkq
from aphrodite_tpu_torch.ops.cuda import paged_attention as tpa


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are too small to gain from
    more, and idle OpenMP threads spinning would slow the other test
    workers sharing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RAGGED_CTX = np.array([1, 0, 40, 64, 17], dtype=np.int32)
PAGE, PPS, PAGES, DIM = 8, 8, 64, 128


def ragged_problem(num_q_heads, num_kv_heads, seed=0):
    """Shapes of tests/kernels/test_ragged_attention.py: page 8, 8 pages
    per sequence, sequence-exclusive pages, a ctx-0 pad row."""
    rng = np.random.default_rng(seed)
    b = len(RAGGED_CTX)
    q = rng.normal(size=(b, num_q_heads, DIM)).astype(np.float32)
    kp = rng.normal(size=(PAGES, PAGE, num_kv_heads * DIM)).astype(
        np.float32)
    vp = rng.normal(size=(PAGES, PAGE, num_kv_heads * DIM)).astype(
        np.float32)
    bt = np.zeros((b, PPS), dtype=np.int32)
    perm = rng.permutation(PAGES - 1) + 1
    for i in range(b):
        n = -(-int(max(RAGGED_CTX[i], 1)) // PAGE)
        bt[i, :n] = perm[i * PPS:i * PPS + n]
    return q, kp, vp, bt, RAGGED_CTX.copy()


def bf16_np(x):
    """numpy f32 copy of x rounded to bf16 (inputs both sides share)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


GEOMETRIES = [(4, 4, 2), (8, 2, 2), (8, 1, 4), (12, 12, 2), (8, 2, 8)]


@pytest.mark.parametrize("num_q_heads,num_kv_heads,ppc,alibi",
                         [g + (False,) for g in GEOMETRIES] +
                         [(8, 2, 2, True)])
def test_plain_matches_pallas_interpret(num_q_heads, num_kv_heads, ppc,
                                        alibi):
    q, kp, vp, bt, ctx = ragged_problem(num_q_heads, num_kv_heads)
    kp, vp = bf16_np(kp), bf16_np(vp)
    slopes = np.array([2.0 ** -(i + 1) for i in range(num_q_heads)],
                      dtype=np.float32) if alibi else None
    work = jpa.build_decode_work_list([-(-int(c) // PAGE) for c in ctx],
                                      ppc)
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(bt), jnp.asarray(ctx),
        None if slopes is None else jnp.asarray(slopes), scale=0.1,
        pages_per_chunk=ppc, work_items=work, amla=False, interpret=True)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(bt),
        torch.from_numpy(ctx),
        None if slopes is None else torch.from_numpy(slopes), scale=0.1,
        pages_per_chunk=ppc, work_items=work)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (got.numpy()[ctx == 0] == 0).all()


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("num_q_heads,num_kv_heads,ppc", GEOMETRIES)
def test_plain_matches_jnp_reference_f32(num_q_heads, num_kv_heads, ppc,
                                         alibi):
    q, kp, vp, bt, ctx = ragged_problem(num_q_heads, num_kv_heads, seed=3)
    slopes = np.array([2.0 ** -(i + 1) for i in range(num_q_heads)],
                      dtype=np.float32) if alibi else None
    want = np.asarray(jax_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(ctx), 0.1,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes)))
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(ctx),
        None if slopes is None else torch.from_numpy(slopes), scale=0.1,
        pages_per_chunk=ppc).numpy()
    live = ctx > 0
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("num_q_heads,num_kv_heads,ppc",
                         [(8, 2, 4), (12, 12, 2)])
def test_fused_write_matches_pallas_interpret(num_q_heads, num_kv_heads,
                                              ppc):
    """Fused KV write on multi-chunk rows and a ctx-0 row: the pages
    equal the Pallas kernel's exactly and the output within 1e-5."""
    rng = np.random.default_rng(11)
    q, kp, vp, bt, ctx = ragged_problem(num_q_heads, num_kv_heads)
    kp, vp = bf16_np(kp), bf16_np(vp)
    knew = bf16_np(rng.normal(size=(len(ctx), num_kv_heads, DIM)).astype(
        np.float32))
    vnew = bf16_np(rng.normal(size=knew.shape).astype(np.float32))
    work = jpa.build_decode_work_list([-(-int(c) // PAGE) for c in ctx],
                                      ppc)
    want, wk, wv = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(bt), jnp.asarray(ctx),
        None, jnp.asarray(knew, jnp.bfloat16),
        jnp.asarray(vnew, jnp.bfloat16), scale=0.1, pages_per_chunk=ppc,
        work_items=work, amla=False, interpret=True)
    # The Pallas kernel rounds q to bf16 after scaling; pass q as bf16
    # on both sides so the fused path's q dtype matches the pages.
    got, gk, gv = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(bt),
        torch.from_numpy(ctx), None, torch.from_numpy(knew).bfloat16(),
        torch.from_numpy(vnew).bfloat16(), scale=0.1, pages_per_chunk=ppc,
        work_items=work)
    assert torch.equal(gk.float(), torch.from_numpy(
        np.asarray(wk, np.float32)))
    assert torch.equal(gv.float(), torch.from_numpy(
        np.asarray(wv, np.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fused_write_f32_equals_write_then_reference():
    """f32 pages: the fused write equals the JAX slot writer followed by
    the jnp reference (pages exact, output within 1e-5)."""
    rng = np.random.default_rng(5)
    q, kp, vp, bt, ctx = ragged_problem(8, 2)
    knew = rng.normal(size=(len(ctx), 2, DIM)).astype(np.float32)
    vnew = rng.normal(size=knew.shape).astype(np.float32)
    slots = np.full((len(ctx),), PAGES * PAGE, dtype=np.int32)
    for b in range(len(ctx)):
        if ctx[b] > 0:
            pos = ctx[b] - 1
            slots[b] = bt[b][pos // PAGE] * PAGE + pos % PAGE
    rk, rv = jax_write(jnp.asarray(knew), jnp.asarray(vnew),
                       jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(slots))
    want = np.asarray(jax_ref(jnp.asarray(q), rk, rv, jnp.asarray(bt),
                              jnp.asarray(ctx), 0.1))
    got, gk, gv = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp.copy()),
        torch.from_numpy(vp.copy()), torch.from_numpy(bt),
        torch.from_numpy(ctx), None, torch.from_numpy(knew),
        torch.from_numpy(vnew), scale=0.1, pages_per_chunk=2)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    live = ctx > 0
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("counts,ppc,pad_to", [
    ([1, 0, 5, 8], 2, 12), ([1] * 5, 2, None), ([3, 40, 150], 4, None),
    ([0], 1, None)])
def test_work_list_helper_matches_jax(counts, ppc, pad_to):
    want = jpa.build_decode_work_list(counts, ppc, pad_to=pad_to)
    got = tpa.build_decode_work_list(counts, ppc, pad_to=pad_to)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("pps,page,batch", [
    (4, 32, 512), (8, 16, 512), (64, 32, 1), (64, 16, 1), (12, 16, 3),
    (6, 32, 64)])
def test_chunk_policy_helpers_match_jax(pps, page, batch):
    assert tpa.choose_pages_per_chunk(pps, page, batch) == \
        jpa.choose_pages_per_chunk(pps, page, batch)
    for req in (1, 3, 8, 100):
        assert tpa.clamp_pages_per_chunk(pps, req) == \
            jpa.clamp_pages_per_chunk(pps, req)
    assert tpa.head_block(pps) == jpa.head_block(pps)


def test_work_list_does_not_change_the_result():
    q, kp, vp, bt, ctx = ragged_problem(8, 2)
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(bt), torch.from_numpy(ctx))
    work = tpa.build_decode_work_list([8] * len(ctx), 2)
    a = tpa.paged_decode_attention(*args, scale=0.1, pages_per_chunk=2)
    b = tpa.paged_decode_attention(*args, scale=0.1, pages_per_chunk=2,
                                   work_items=work)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sentinel"):
        tpa.paged_decode_attention(*args, scale=0.1,
                                   work_items=(work[0][:-1], work[1]))



# ---- K1's sequence splits: the plain version at num_splits > 1 ----
#
# The plain version at a forced split count (the kernel's split
# arithmetic: each split walks its chunks with its own online-softmax
# state, then the splits merge by the same power-of-two rescale)
# against the Pallas `_decode_kernel_ragged` in interpret mode, which
# walks every chunk of a row in order; f32 activations, so the outputs
# show the f32 sums. Tolerance on bf16, int8 and fp8 pages: 1e-5, as
# for one split (f32 sums in another order; the largest difference on
# these inputs is 2.0e-6). A split's own integer running max can differ
# from the sequential one by an integer k, so p = 2^(s - m) comes from
# another f32 difference: the weights agree times 2^k unless that
# difference rounds a weight across a bf16 tie, which would move it by
# a bf16 ulp (2^-8 relative) and this test by more than 1e-5; no weight
# does here. f32 pages: the Pallas body rounds its dot operands to bf16
# on every page type, where the f32 route (the JAX package's CPU route)
# keeps f32; they are held against the jnp reference
# `paged_decode_attention_ref` at 1e-5 (f32 sums in another order).

SPLIT_CTX = np.array([1, 0, 40, 64, 17], dtype=np.int32)
KV_S = 0.05
SPLIT_CASES = [
    # kind, hq, hkv, ppc, alibi, fused, amla
    ("bf16", 8, 2, 2, False, False, True),
    ("bf16", 8, 2, 2, True, True, False),
    ("bf16", 8, 8, 1, True, False, True),
    ("int8", 8, 2, 2, True, True, True),
    ("int8", 8, 8, 1, False, False, False),
    ("fp8", 8, 2, 2, False, True, False),
    ("fp8", 12, 12, 1, True, False, True),
]
SPLITS = [2, 3, "policy", "per-chunk"]
H100_SMS = 132                 # the H100 SXM's streaming multiprocessors
_PAGE_NP = {"bf16": ml_dtypes.bfloat16, "int8": np.int8,
            "fp8": ml_dtypes.float8_e5m2}
_PAGE_TORCH = {"bf16": torch.bfloat16, "int8": torch.int8,
               "fp8": torch.float8_e5m2, "f32": torch.float32}


def _split_count(splits, batch, hkv, ppc):
    if splits == "policy":
        return tpa.choose_decode_splits(batch, hkv, PPS, ppc, H100_SMS)
    if splits == "per-chunk":
        return PPS // ppc
    return splits


def _split_problem(kind, hq, hkv, seed=7):
    """Seeded inputs; pages in `kind` (int8 codes of N(0, 1) / S), new
    tokens away from int8 rounding ties, as tests/test_torch_kv_quant.py
    builds them."""
    rng = np.random.default_rng(seed)
    b = len(SPLIT_CTX)
    q = bf16_np(rng.normal(size=(b, hq, DIM)).astype(np.float32))

    def pages():
        x = rng.normal(size=(PAGES, PAGE, hkv * DIM)).astype(np.float32)
        if kind == "int8":
            return np.clip(np.round(x / KV_S), -127, 127).astype(np.int8)
        return x if kind == "f32" else x.astype(_PAGE_NP[kind])
    kp, vp = pages(), pages()
    bt = np.zeros((b, PPS), dtype=np.int32)
    perm = rng.permutation(PAGES - 1) + 1
    for i in range(b):
        n = -(-int(max(SPLIT_CTX[i], 1)) // PAGE)
        bt[i, :n] = perm[i * PPS:i * PPS + n]
    off = rng.uniform(-0.3, 0.3, size=(b, hkv, DIM))
    knew = bf16_np(((rng.integers(-40, 40, size=off.shape) + off) *
                    KV_S).astype(np.float32))
    vnew = bf16_np(((rng.integers(-40, 40, size=off.shape) - off) *
                    KV_S).astype(np.float32))
    slopes = np.array([2.0 ** -(i + 1) for i in range(hq)], np.float32)
    return q, kp, vp, bt, knew, vnew, slopes


def _torch_pages(x, kind):
    if kind == "f32":
        return torch.from_numpy(x.copy())
    raw = torch.from_numpy(np.ascontiguousarray(x).view(
        np.int16 if kind == "bf16" else np.uint8).copy())
    return raw.view(_PAGE_TORCH[kind])


def _page_bytes(t):
    return t.contiguous().view(
        torch.int16 if t.element_size() == 2 else torch.uint8).numpy()


@functools.lru_cache(maxsize=None)
def _pallas_split_case(kind, hq, hkv, ppc, alibi, fused, amla, ragged=True):
    """The Pallas ragged body (or, without `ragged`, the padded-grid body
    `_decode_kernel_tm`) in interpret mode (out, and the pages' bytes
    after the fused write), once per case."""
    q, kp, vp, bt, knew, vnew, slopes = _split_problem(kind, hq, hkv)
    kv_scale = tkq.dequant_scale(_PAGE_TORCH[kind], KV_S)
    work = jpa.build_decode_work_list(
        [-(-int(c) // PAGE) for c in SPLIT_CTX], ppc) if ragged else None
    res = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(SPLIT_CTX),
        jnp.asarray(slopes) if alibi else None,
        jnp.asarray(knew, jnp.bfloat16) if fused else None,
        jnp.asarray(vnew, jnp.bfloat16) if fused else None,
        scale=0.1, kv_scale=kv_scale, pages_per_chunk=ppc,
        work_items=work, amla=amla, interpret=True)
    if not fused:
        return np.asarray(res, np.float32), None, None
    out, wk, wv = res
    return (np.asarray(out, np.float32), np.asarray(wk).view(np.uint8),
            np.asarray(wv).view(np.uint8))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("kind,hq,hkv,ppc,alibi,fused,amla", SPLIT_CASES)
def test_split_plain_matches_pallas_interpret(kind, hq, hkv, ppc, alibi,
                                              fused, amla, splits):
    """Forced split counts: 2, 3 (a split wholly past every row's
    chunks), the policy's and one per chunk; rows with ctx 0 and ctx
    inside the first chunk, so most splits of those rows are empty."""
    n = _split_count(splits, len(SPLIT_CTX), hkv, ppc)
    assert 1 < n <= PPS // ppc
    want, wk, wv = _pallas_split_case(kind, hq, hkv, ppc, alibi, fused,
                                      amla)
    q, kp, vp, bt, knew, vnew, slopes = _split_problem(kind, hq, hkv)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), _torch_pages(kp, kind),
        _torch_pages(vp, kind), torch.from_numpy(bt),
        torch.from_numpy(SPLIT_CTX),
        torch.from_numpy(slopes) if alibi else None,
        torch.from_numpy(knew).bfloat16() if fused else None,
        torch.from_numpy(vnew).bfloat16() if fused else None,
        scale=0.1, kv_scale=tkq.dequant_scale(_PAGE_TORCH[kind], KV_S),
        pages_per_chunk=ppc,
        work_items=tpa.build_decode_work_list(
            [-(-int(c) // PAGE) for c in SPLIT_CTX], ppc),
        amla=amla, num_splits=n)
    if fused:
        got, gk, gv = got
        np.testing.assert_array_equal(_page_bytes(gk).view(np.uint8), wk)
        np.testing.assert_array_equal(_page_bytes(gv).view(np.uint8), wv)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[SPLIT_CTX == 0] == 0).all()


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("alibi,fused,amla", [
    (False, False, True), (True, True, False), (True, False, True),
    (False, True, False)])
def test_split_plain_f32_matches_jnp_reference(alibi, fused, amla, splits):
    """f32 pages at forced split counts against the JAX slot writer
    (with the fused write) and the jnp reference: pages exact, output
    within 1e-5."""
    hq, hkv, ppc = 8, 2, 2
    q, kp, vp, bt, knew, vnew, slopes = _split_problem("f32", hq, hkv)
    n = _split_count(splits, len(SPLIT_CTX), hkv, ppc)
    rk, rv = jnp.asarray(kp), jnp.asarray(vp)
    if fused:
        slots = np.full((len(SPLIT_CTX),), PAGES * PAGE, dtype=np.int32)
        for b, c in enumerate(SPLIT_CTX):
            if c > 0:
                slots[b] = bt[b][(c - 1) // PAGE] * PAGE + (c - 1) % PAGE
        rk, rv = jax_write(jnp.asarray(knew), jnp.asarray(vnew), rk, rv,
                           jnp.asarray(slots))
    want = np.asarray(jax_ref(
        jnp.asarray(q), rk, rv, jnp.asarray(bt), jnp.asarray(SPLIT_CTX),
        0.1, alibi_slopes=jnp.asarray(slopes) if alibi else None))
    got = tpa.paged_decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp.copy()),
        torch.from_numpy(vp.copy()), torch.from_numpy(bt),
        torch.from_numpy(SPLIT_CTX),
        torch.from_numpy(slopes) if alibi else None,
        torch.from_numpy(knew) if fused else None,
        torch.from_numpy(vnew) if fused else None, scale=0.1,
        pages_per_chunk=ppc, amla=amla, num_splits=n)
    if fused:
        got, gk, gv = got
        np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    live = SPLIT_CTX > 0
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=1e-5,
                               atol=1e-5)
    assert (got.numpy()[~live] == 0).all()


def test_one_split_is_the_sequential_walk():
    """num_splits=1 (the default) changes nothing; a count outside
    [1, chunks] raises."""
    q, kp, vp, bt, ctx = ragged_problem(8, 2)
    args = (torch.from_numpy(q), torch.from_numpy(kp).bfloat16(),
            torch.from_numpy(vp).bfloat16(), torch.from_numpy(bt),
            torch.from_numpy(ctx))
    a = tpa.paged_decode_attention_plain(*args, scale=0.1,
                                         pages_per_chunk=2)
    b = tpa.paged_decode_attention_plain(*args, scale=0.1,
                                         pages_per_chunk=2, num_splits=1)
    assert torch.equal(a, b)
    for bad in (0, PPS // 2 + 1):
        with pytest.raises(ValueError, match="num_splits"):
            tpa.paged_decode_attention_plain(*args, scale=0.1,
                                             pages_per_chunk=2,
                                             num_splits=bad)


@pytest.mark.parametrize("batch,hkv,pps,ppc,sms,want", [
    (8, 8, 36, 4, 132, 5),      # the e2e decode batch: 64 blocks, 9 chunks
    (64, 8, 64, 8, 132, 1),     # 512 blocks fill the card
    (17, 8, 64, 8, 132, 1),     # 136 blocks: one per SM already
    (16, 8, 64, 8, 132, 3),     # 128 blocks: ceil(264 / 128) = 3 of 8
    (1, 8, 64, 16, 132, 4),     # batch 1: one split per chunk
    (8, 8, 64, 16, 132, 4),
    (2, 8, 128, 4, 132, 16),    # 16 blocks, 32 chunks, 17 wanted: 2 each
    (4, 8, 40, 4, 132, 5),      # 10 chunks, 9 wanted: 2 chunks per split
    (8, 8, 4, 4, 132, 1),       # one chunk
    (0, 8, 64, 8, 132, 1),      # no rows
    (16, 8, 64, 8, 114, 1),     # 128 blocks cover 114 SMs (H100 PCIe)
    (8, 8, 64, 8, 114, 4),      # 64 blocks: ceil(228 / 64) = 4 of 8
    (64, 8, 4096, 8, 132, 2),   # 4096 table entries: two splits hold them
    (64, 8, 6144, 8, 132, 3),
    (8, 8, 8192, 32, 132, 5),   # 52 chunks a split: 1664 entries
])
def test_choose_decode_splits_table(batch, hkv, pps, ppc, sms, want):
    assert tpa.choose_decode_splits(batch, hkv, pps, ppc, sms) == want


@pytest.mark.parametrize("batch,hkv,n_split,sms,want", [
    (8, 8, 5, 132, False),      # 320 blocks: narrow
    (8, 8, 4, 132, True),       # 256 blocks: two per SM
    (64, 8, 1, 132, False),     # 512 blocks: four per SM
    (16, 8, 3, 132, False),     # 384 blocks
    (16, 8, 1, 114, True),      # 128 blocks on 114 SMs
])
def test_wide_slots_table(batch, hkv, n_split, sms, want):
    assert tpa.wide_slots(batch, hkv, n_split, sms) == want


# ---- K5: K1's kernel on the padded grid, one kv head a block ----

@pytest.mark.parametrize("batch,hkv,pps,ppc,sms,want", [
    (8, 8, 36, 4, 132, 5),      # the e2e decode batch: 64 blocks x 5
    (8, 8, 32, 16, 132, 2),     # B 8 x 1016: 2 chunks
    (64, 8, 64, 8, 132, 1),     # B 64 x 2047: 512 blocks, one split
    (66, 8, 64, 8, 132, 1),
    (16, 8, 64, 8, 132, 3),     # 128 blocks fall short of 2 an SM
    (8, 8, 64, 16, 132, 4),     # 64 blocks x 4 chunks
    (8, 8, 36, 4, 114, 3),      # 114 SMs: 64 x 3 splits
    (8, 6, 36, 4, 132, 5),      # 48 blocks
    (8, 5, 36, 4, 132, 5),      # a head block of 5 (Pallas) changes nothing
    (8, 12, 36, 4, 132, 3),     # 96 blocks
    (4, 8, 36, 4, 132, 9),      # 32 blocks: a split a chunk
    (1, 8, 64, 8, 132, 8),
    (0, 8, 64, 8, 132, 1),
    (64, 8, 4096, 8, 132, 2),   # two splits stage 4096 entries
    (17, 8, 64, 8, 132, 1),     # 136 blocks cover the SMs
    (32, 4, 64, 8, 132, 3),     # 128 blocks
])
def test_k5_split_table(batch, hkv, pps, ppc, sms, want):
    """K5's split count: K1's policy on the same (batch, Hkv) grid, from
    shapes and the SM count alone."""
    assert tpa.choose_decode_splits(batch, hkv, pps, ppc, sms) == want


def _k5_split_count(splits, batch, hkv, ppc):
    if splits == "k5":
        return tpa.choose_decode_splits(batch, hkv, PPS, ppc, H100_SMS)
    return splits


@pytest.mark.parametrize("splits", ["k5", 2, 3])
@pytest.mark.parametrize("kind,hq,hkv,ppc,alibi,fused,amla", SPLIT_CASES)
def test_k5_split_plain_matches_pallas_tm_interpret(kind, hq, hkv, ppc,
                                                    alibi, fused, amla,
                                                    splits):
    """K5 (no work list) on the CPU is the plain version at K5's split
    count (the policy's on its padded grid, or forced): against the
    Pallas padded-grid body `_decode_kernel_tm` in interpret mode, which
    walks every chunk of a row in order, within 1e-5 (as for K1's
    splits); fused-write bytes exact."""
    n = _k5_split_count(splits, len(SPLIT_CTX), hkv, ppc)
    assert 1 < n <= PPS // ppc
    want, wk, wv = _pallas_split_case(kind, hq, hkv, ppc, alibi, fused,
                                      amla, ragged=False)
    q, kp, vp, bt, knew, vnew, slopes = _split_problem(kind, hq, hkv)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), _torch_pages(kp, kind),
        _torch_pages(vp, kind), torch.from_numpy(bt),
        torch.from_numpy(SPLIT_CTX),
        torch.from_numpy(slopes) if alibi else None,
        torch.from_numpy(knew).bfloat16() if fused else None,
        torch.from_numpy(vnew).bfloat16() if fused else None,
        scale=0.1, kv_scale=tkq.dequant_scale(_PAGE_TORCH[kind], KV_S),
        pages_per_chunk=ppc, amla=amla, num_splits=n)
    if fused:
        got, gk, gv = got
        np.testing.assert_array_equal(_page_bytes(gk).view(np.uint8), wk)
        np.testing.assert_array_equal(_page_bytes(gv).view(np.uint8), wv)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[SPLIT_CTX == 0] == 0).all()
