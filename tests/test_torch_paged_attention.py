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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops.attention import (
    paged_decode_attention_ref as jax_ref)
from aphrodite_tpu.ops.kv_cache import write_to_kv_cache as jax_write
from aphrodite_tpu.ops.pallas import paged_attention as jpa
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

