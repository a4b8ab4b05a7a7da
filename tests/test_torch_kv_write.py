"""KV page writers (K2, K3, K4) in the PyTorch port against the JAX
package: the port's plain versions against the Pallas kernels run in
interpret mode, and the plain KV-cache ops (`ops/kv_cache.py`) against
the JAX ones, on the same numpy inputs. Every comparison is exact: the
writers copy values and do no arithmetic."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops import kv_cache as jkv
from aphrodite_tpu.ops.pallas import kv_write as jkw
from aphrodite_tpu_torch.ops import kv_cache as tkv
from aphrodite_tpu_torch.ops.cuda import kv_write as tkw


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are too small to gain from
    more, and idle OpenMP threads spinning would slow the other test
    workers sharing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pages(rng, pages, page_size, hd, dtype=np.float32):
    return (rng.normal(size=(pages, page_size, hd)).astype(dtype),
            rng.normal(size=(pages, page_size, hd)).astype(dtype))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("distinct,slots", [
    # decode contract: one token per page, pads first/middle/last
    (True, [128, 17, 39, 111, 64, 128]),
    (True, [128, 9, 128, 33, 128, 70]),
    # shared pages (unaligned prompt chunks), pads in between
    (False, [0, 17, 18, 127, 64, 128]),
    (False, [16, 17, 18, 19, 128, 20]),
])
def test_slot_writer_matches_pallas_interpret(distinct, slots):
    rng = np.random.default_rng(5)
    pages, page_size, hd = 8, 16, 2 * 128
    kp, vp = _pages(rng, pages, page_size, hd)
    slots = np.asarray(slots, dtype=np.int32)
    knew = rng.normal(size=(len(slots), hd)).astype(np.float32)
    vnew = rng.normal(size=(len(slots), hd)).astype(np.float32)
    wk, wv = jkw.write_kv_pages(
        jnp.asarray(knew), jnp.asarray(vnew), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(slots), distinct_pages=distinct,
        interpret=True)
    gk, gv = tkw.write_kv_pages(_t(knew), _t(vnew), _t(kp), _t(vp),
                                _t(slots), distinct_pages=distinct)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("case", ["tails_and_skips", "prefix_offset"])
def test_prefill_writer_matches_pallas_interpret(case):
    """Full pages, partial tail pages merged over existing rows, and
    skipped (out-of-range) cells."""
    rng = np.random.default_rng(9)
    pages, page_size, hd = 10, 8, 256
    kp, vp = _pages(rng, pages, page_size, hd)
    if case == "tails_and_skips":
        pid = np.array([1, 2, 4, 5, pages, pages], dtype=np.int32)
        vld = np.array([8, 8, 8, 3, 0, 0], dtype=np.int32)
    else:
        pid = np.array([7, pages, 3, 9, 0, pages, pages, pages],
                       dtype=np.int32)
        vld = np.array([8, 0, 8, 1, 5, 0, 0, 0], dtype=np.int32)
    cells = len(pid)
    sblk = np.arange(cells, dtype=np.int32)
    knew = rng.normal(size=(cells * page_size, hd)).astype(np.float32)
    vnew = rng.normal(size=(cells * page_size, hd)).astype(np.float32)
    wk, wv = jkw.write_kv_pages_prefill(
        jnp.asarray(knew), jnp.asarray(vnew), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(pid), jnp.asarray(sblk),
        jnp.asarray(vld), interpret=True)
    gk, gv = tkw.write_kv_pages_prefill(_t(knew), _t(vnew), _t(kp), _t(vp),
                                        _t(pid), sblk, _t(vld))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_prefill_writer_refuses_non_identity_sources():
    pages, page_size, hd = 4, 8, 128
    kp = torch.zeros(pages, page_size, hd)
    knew = torch.zeros(2 * page_size, hd)
    pid = torch.tensor([0, 1], dtype=torch.int32)
    vld = torch.tensor([8, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="identity"):
        tkw.write_kv_pages_prefill(knew, knew, kp, kp.clone(), pid,
                                   np.array([1, 0], np.int32), vld)
    # A skipped cell may carry any source index.
    pid[1] = pages
    tkw.write_kv_pages_prefill(knew, knew, kp, kp.clone(), pid,
                               np.array([0, 7], np.int32), vld)


def test_bf16_pages_round_trip_exactly():
    """bf16 pages: the plain writers copy bit patterns."""
    rng = np.random.default_rng(2)
    kp = torch.from_numpy(rng.normal(size=(4, 8, 128)).astype(
        np.float32)).bfloat16()
    vp = kp.clone() + 1
    knew = torch.from_numpy(rng.normal(size=(3, 128)).astype(
        np.float32)).bfloat16()
    slots = torch.tensor([3, 32, 17], dtype=torch.int32)
    gk, gv = tkw.write_kv_pages(knew, knew + 2, kp.clone(), vp.clone(),
                                slots)
    assert torch.equal(gk.view(-1, 128)[3], knew[0])
    assert torch.equal(gv.view(-1, 128)[17], knew[2] + 2)
    assert torch.equal(gk.view(-1, 128)[[0, 1, 2]], kp.view(-1, 128)[:3])


# ---- plain KV-cache ops vs ops/kv_cache.py of the JAX package ----

def test_write_to_kv_cache_matches_jax():
    rng = np.random.default_rng(1)
    kp, vp = _pages(rng, 6, 4, 2 * 8)
    key = rng.normal(size=(5, 2, 8)).astype(np.float32)
    val = rng.normal(size=(5, 2, 8)).astype(np.float32)
    slots = np.array([0, 5, 23, 24, 7], dtype=np.int32)   # 24 = pad
    wk, wv = jkv.write_to_kv_cache(jnp.asarray(key), jnp.asarray(val),
                                   jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(slots))
    gk, gv = tkv.write_to_kv_cache(_t(key), _t(val), _t(kp), _t(vp),
                                   _t(slots))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_copy_blocks_matches_jax():
    """Copies read every source before writing; a pad source reads
    zeros into a live destination; pad destinations drop."""
    rng = np.random.default_rng(4)
    kp, vp = _pages(rng, 6, 4, 16)
    src = np.array([1, 2, 6, 3, 6], dtype=np.int32)
    dst = np.array([2, 4, 5, 6, 6], dtype=np.int32)
    wk, wv = jkv.copy_blocks(jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(src), jnp.asarray(dst))
    gk, gv = tkv.copy_blocks(_t(kp), _t(vp), _t(src), _t(dst))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(7)
    kp, _ = _pages(rng, 8, 4, 3 * 16)
    idx = np.array([[6, 1, 8], [0, 8, 8]], dtype=np.int32)   # 8 = pad
    want = np.asarray(jkv.gather_pages(jnp.asarray(kp), jnp.asarray(idx),
                                       3))
    got = tkv.gather_pages(_t(kp), _t(idx), 3).numpy()
    np.testing.assert_array_equal(got, want)

