"""KV page writers (K2, K3, K4) in the PyTorch port against the JAX
package: the port's plain versions against the Pallas kernels run in
interpret mode, and the plain KV-cache ops (`ops/kv_cache.py`) against
the JAX ones, on the same numpy inputs; and the CUDA launches of K2 and
K3 / K4 emulated vector by vector against the plain versions. Every
comparison is exact: the writers copy values, or quantize them by
`quantize_kv`'s rules on both sides."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aphrodite_tpu.ops import kv_cache as jkv
from aphrodite_tpu.ops.pallas import kv_write as jkw
from aphrodite_tpu_torch.ops import kv_cache as tkv
from aphrodite_tpu_torch.ops import kv_quant as tkq
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


# ---- K2's launch (csrc/kv_write.cu `kv_write_prefill_kernel`), emulated ----

def _k2_copies(page_ids, valids, num_pages, page_size, row_bytes):
    """The 16-byte vectors K2's launch copies, block by block and thread
    by thread as the kernel indexes them: grid (cells, ceil(page_size /
    rows)) of `threads` from `prefill_write_plan`; block (c, y) reads
    page_ids[c] and valids[c] and returns where the page is out of range
    or valid <= y rows, else copies rows [y rows, min(valid, page_size,
    (y + 1) rows)), thread t vectors t + threads (4 j + u) of them, u <
    PREFILL_VECS, in round j. Returns (source vector, page vector,
    thread) arrays."""
    rows, threads = tkw.prefill_write_plan(page_size, row_bytes)
    row_vecs = row_bytes // 16
    per_round = tkw.PREFILL_VECS * threads
    src, dst, thr = [], [], []
    for c, page in enumerate(page_ids):
        if page < 0 or page >= num_pages:
            continue
        for y in range(-(-page_size // rows)):
            r0 = y * rows
            valid = min(valids[c], page_size)
            if valid <= r0:
                continue
            r1 = min(valid, r0 + rows)
            n = (r1 - r0) * row_vecs
            t = np.arange(threads)
            i = (t[None, :, None] + per_round *
                 np.arange(-(-n // per_round))[:, None, None] +
                 threads * np.arange(tkw.PREFILL_VECS)[None, None, :])
            t = np.broadcast_to(t[None, :, None], i.shape)
            keep = i < n
            src.append((c * page_size + r0) * row_vecs + i[keep])
            dst.append((page * page_size + r0) * row_vecs + i[keep])
            thr.append(t[keep])
    if not src:
        return (np.zeros(0, np.int64),) * 3
    return tuple(np.concatenate(a) for a in (src, dst, thr))


_K2_CELLS = {
    # tail pages, skipped cells (past the pool and negative), a cell of
    # no rows, valids past the page (clamped), full pages
    "tails_and_skips": ([3, 9, 0, 7, 12, -1, 5, 2],
                        [32, 5, 1, 31, 32, 32, 0, 40]),
    "all_full": ([1, 4, 6, 8], [32, 32, 32, 32]),
    "one_row_each": ([2, 11, 3], [1, 1, 1]),
}


@pytest.mark.parametrize("row_bytes", [128, 256, 768, 2048, 4096, 65536])
@pytest.mark.parametrize("page_size", [8, 16, 32])
@pytest.mark.parametrize("cells", list(_K2_CELLS))
def test_prefill_launch_covers_each_live_row_once(cells, page_size,
                                                  row_bytes):
    """K2's plan and indexing: every 16-byte vector of every live cell's
    rows r < min(valid, page_size) is copied exactly once, to the same
    row of its page, and nothing else is read or written (rows at and
    past valid, skipped cells); a thread's vectors are distinct."""
    num_pages = 12
    pid, vld = (np.array(a) for a in _K2_CELLS[cells])
    src, dst, thr = _k2_copies(pid, vld, num_pages, page_size, row_bytes)
    row_vecs = row_bytes // 16
    want_src, want_dst = [], []
    for c, (page, valid) in enumerate(zip(pid, vld)):
        if 0 <= page < num_pages:
            n = min(valid, page_size) * row_vecs
            want_src.append(c * page_size * row_vecs + np.arange(n))
            want_dst.append(page * page_size * row_vecs + np.arange(n))
    order = np.argsort(dst, kind="stable")
    assert np.array_equal(dst[order], np.sort(np.concatenate(want_dst)))
    assert len(np.unique(dst)) == len(dst)
    # Each vector lands on its own row of its page, from its cell.
    want = dict(zip(np.concatenate(want_dst).tolist(),
                    np.concatenate(want_src).tolist()))
    assert all(want[d] == s for d, s in zip(dst.tolist(), src.tolist()))
    assert len({(t, s) for t, s in zip(thr.tolist(), src.tolist())}) == \
        len(src)


def test_prefill_launch_equals_the_plain_writer():
    """The emulated launch applied to pages (f32 values, bit patterns
    copied) gives `write_kv_pages_prefill_plain`'s pages exactly, at
    Mistral-7B's row (8 kv heads x 128 in bf16: 2048 bytes, 128 vectors)
    with 32-row pages: tail pages, a skipped cell, a full page."""
    rng = np.random.default_rng(12)
    pages, page_size, hd = 10, 32, 512             # 512 f32: 2048 bytes
    kp, vp = _pages(rng, pages, page_size, hd)
    pid = np.array([4, 0, pages, 7, 2], dtype=np.int32)
    vld = np.array([32, 17, 0, 1, 31], dtype=np.int32)
    knew = rng.normal(size=(len(pid) * page_size, hd)).astype(np.float32)
    vnew = rng.normal(size=(len(pid) * page_size, hd)).astype(np.float32)
    src, dst, _ = _k2_copies(pid, vld, pages, page_size, hd * 4)
    got = []
    for new, old in ((knew, kp), (vnew, vp)):
        out = old.copy().reshape(-1, 4)           # 16-byte vectors
        out[dst] = new.reshape(-1, 4)[src]
        got.append(out.reshape(old.shape))
    wk, wv = tkw.write_kv_pages_prefill_plain(_t(knew), _t(vnew), _t(kp),
                                              _t(vp), _t(pid), _t(vld))
    np.testing.assert_array_equal(got[0], wk.numpy())
    np.testing.assert_array_equal(got[1], wv.numpy())


# K2's plan, (rows a block, threads a block), by page size and row bytes.
@pytest.mark.parametrize("page_size,row_bytes,want", [
    (32, 2048, (8, 256)),        # Mistral-7B's 8 kv heads: 8 loads a thread
    (16, 2048, (8, 256)),
    (32, 4096, (4, 256)),        # f32 pages
    (32, 1024, (16, 256)),       # 8-bit pages of 8 kv heads
    (32, 256, (32, 128)),        # one kv head: the whole page, 4 warps
    (16, 128, (16, 32)),
    (32, 768, (21, 256)),        # rows that do not divide the page
    (8, 65536, (1, 256)),        # a row wider than a round: 4 rounds
])
def test_prefill_write_plan_table(page_size, row_bytes, want):
    rows, threads = tkw.prefill_write_plan(page_size, row_bytes)
    assert (rows, threads) == want
    assert threads % 32 == 0 and 32 <= threads <= tkw.PREFILL_THREADS
    # One round covers the block's vectors unless a row alone exceeds it.
    per_round = tkw.PREFILL_VECS * threads
    assert rows * row_bytes // 16 <= per_round or rows == 1
    assert rows * row_bytes // 16 > per_round - 32 * tkw.PREFILL_VECS or \
        rows == page_size or threads == tkw.PREFILL_THREADS


# ---- K3 / K4's launch (csrc/kv_write.cu `kv_write_slots_kernel`), emulated ----

def _slot_launch(slots, num_slots, row_bytes, src_vecs, sms,
                 slot_first=None):
    """The 16-byte vectors K3 / K4's launch reads and writes, block by
    block and thread by thread as the kernel indexes them: grid
    ceil(tokens / rows) of `threads` from `slot_write_plan` (its source
    rows of `row_bytes * src_vecs` bytes: `src_vecs` source vectors a
    16-byte page vector); block b takes tokens [b rows, (b + 1) rows);
    thread t its items t + threads (U j + u), u < U = SLOT_VECS /
    src_vecs, in round j, item i page vector i % row_vecs of the block's
    row i / row_vecs. With the slots read first a block of padding
    returns and padding rows are not read; else every row of the block
    is read. Items of rows whose slot lies outside [0, num_slots) are not
    written. Returns (source vectors read, their thread) and (page vector
    written, its first source vector, its thread), threads numbered
    across the grid."""
    num_tokens = len(slots)
    rows, threads, first = tkw.slot_write_plan(num_tokens,
                                               row_bytes * src_vecs, sms)
    if slot_first is not None:
        first = slot_first
    row_vecs = row_bytes // 16
    u_vecs = tkw.SLOT_VECS // src_vecs
    per_round = u_vecs * threads
    reads, read_thr, writes, write_src, write_thr = [], [], [], [], []
    for b in range(-(-num_tokens // rows)):
        t0 = b * rows
        block_slots = np.asarray(slots[t0:t0 + rows], dtype=np.int64)
        live = (block_slots >= 0) & (block_slots < num_slots)
        if first and not live.any():
            continue
        n = len(block_slots) * row_vecs
        t = np.arange(threads)
        i = (t[None, :, None] + per_round *
             np.arange(-(-n // per_round))[:, None, None] +
             threads * np.arange(u_vecs)[None, None, :])
        thr = np.broadcast_to(t[None, :, None], i.shape) + b * threads
        keep = i < n
        i, thr = i[keep], thr[keep]
        r, c = i // row_vecs, i % row_vecs
        src0 = ((t0 + r) * row_vecs + c) * src_vecs
        load = live[r] if first else np.ones(len(i), dtype=bool)
        for w in range(src_vecs):
            reads.append(src0[load] + w)
            read_thr.append(thr[load])
        writes.append(block_slots[r[live[r]]] * row_vecs + c[live[r]])
        write_src.append(src0[live[r]])
        write_thr.append(thr[live[r]])
    cat = [np.concatenate(a) if a else np.zeros(0, np.int64)
           for a in (reads, read_thr, writes, write_src, write_thr)]
    return tuple(cat)


def _slot_vector(num_tokens, seed):
    """Slots of `num_tokens` tokens in a pool of 2 tokens + 16 slots: a
    third of them padding (num_slots, past it, negative), in runs at the
    end of each 1024-token sequence from 2728 tokens on (a padded prompt
    round), else scattered; the rest distinct live slots."""
    rng = np.random.default_rng(seed)
    num_slots = 2 * num_tokens + 16
    slots = rng.permutation(num_slots)[:num_tokens].astype(np.int64)
    if num_tokens >= 2728:
        dead = np.arange(num_tokens) % 1024 >= 341
    else:
        dead = rng.random(num_tokens) < 1 / 3
    pads = np.array([num_slots, num_slots + 5, -1, 2 ** 30])
    slots[dead] = pads[np.arange(dead.sum()) % len(pads)]
    return slots, num_slots


# (page row bytes, source vectors a page vector): a one-vector row, 8-bit
# pages from bf16 and f32 rows, bf16 pages of one and of 8 kv heads, f32
# pages, a row wider than a round.
_SLOT_ROWS = [(16, 1), (128, 1), (1024, 2), (1024, 4), (2048, 1),
              (4096, 1), (65536, 1)]


_SLOT_LAUNCHES = [(n, b, v) for n in (1, 2, 31, 33, 64, 2728, 8192)
                  for b, v in _SLOT_ROWS if b < 65536 or n <= 64]


@pytest.mark.parametrize("slot_first", [False, True])
@pytest.mark.parametrize("num_tokens,row_bytes,src_vecs", _SLOT_LAUNCHES)
def test_slot_launch_writes_each_live_row_once(num_tokens, row_bytes,
                                                src_vecs, slot_first):
    """K3 / K4's plan and indexing, in both slot-read orders: every
    16-byte page vector of every live token's row is written exactly
    once, into its slot's row, from that token's source vectors; nothing
    else is written; every read lies in the source rows, each vector
    read once, and with the slots read first padding rows are not read.
    (The 65536-byte row up to 64 tokens: its emulation grows with the
    bytes.)"""
    slots, num_slots = _slot_vector(num_tokens, num_tokens + row_bytes)
    reads, read_thr, dst, src0, thr = _slot_launch(
        slots, num_slots, row_bytes, src_vecs, 132, slot_first)
    row_vecs = row_bytes // 16
    live = np.flatnonzero((slots >= 0) & (slots < num_slots))
    want_dst = (slots[live][:, None] * row_vecs +
                np.arange(row_vecs)[None, :]).ravel()
    want_src = ((live[:, None] * row_vecs + np.arange(row_vecs)[None, :])
                * src_vecs).ravel()
    order = np.argsort(dst, kind="stable")
    assert len(np.unique(dst)) == len(dst)
    np.testing.assert_array_equal(dst[order], np.sort(want_dst))
    want = dict(zip(want_dst.tolist(), want_src.tolist()))
    assert all(want[d] == s for d, s in zip(dst.tolist(), src0.tolist()))
    assert len(np.unique(reads)) == len(reads)
    assert reads.min(initial=0) >= 0
    assert reads.max(initial=0) < num_tokens * row_vecs * src_vecs
    read_rows = np.unique(reads // (row_vecs * src_vecs))
    if slot_first:
        np.testing.assert_array_equal(read_rows, live)
    else:
        np.testing.assert_array_equal(read_rows, np.arange(num_tokens))
    # A thread's stores are distinct page vectors.
    assert len({(t, d) for t, d in zip(thr.tolist(), dst.tolist())}) == \
        len(dst)


@pytest.mark.parametrize("page_dtype,src_dtype", [
    (torch.float32, torch.float32),
    (torch.int8, torch.float32),
    (torch.int8, torch.bfloat16),
    (torch.float8_e5m2, torch.bfloat16),
])
@pytest.mark.parametrize("slot_first", [False, True])
def test_slot_launch_equals_the_plain_writer(page_dtype, src_dtype,
                                             slot_first):
    """The emulated launch applied to pages gives `write_kv_pages_plain`'s
    pages exactly, at Mistral-7B's 8 kv heads of 128 with 32-row pages:
    each page vector is its 16 source values quantized by
    `quantize_kv` (copied as bit patterns on f32 pages); shared pages,
    padding slots of every kind."""
    rng = np.random.default_rng(21)
    pages, page_size, hd, num_tokens = 12, 32, 1024, 160
    num_slots = pages * page_size
    slots = rng.permutation(num_slots)[:num_tokens].astype(np.int64)
    slots[::6] = num_slots
    slots[1::9] = -1
    scale = 0.05
    kp = tkq.quantize_kv(torch.from_numpy(rng.normal(
        size=(pages, page_size, hd)).astype(np.float32)), page_dtype, scale)
    vp = tkq.quantize_kv(torch.from_numpy(rng.normal(
        size=(pages, page_size, hd)).astype(np.float32)), page_dtype, scale)
    knew, vnew = (torch.from_numpy(rng.normal(size=(num_tokens, hd)).astype(
        np.float32) * 4).to(src_dtype) for _ in range(2))
    page_elt = kp.element_size()
    src_vecs = knew.element_size() // page_elt
    _, _, dst, src0, _ = _slot_launch(slots, num_slots, hd * page_elt,
                                      src_vecs, 132, slot_first)
    per_vec = 16 // page_elt                  # values a page vector
    got = []
    for new, old in ((knew, kp), (vnew, vp)):
        vals = new.reshape(-1)
        first = src0 * (16 // new.element_size())     # first source value
        idx = torch.from_numpy(first[:, None] + np.arange(per_vec)[None, :])
        codes = tkq.quantize_kv(vals[idx], page_dtype, scale)
        out = old.clone().view(torch.uint8).reshape(-1, 16)
        out[torch.from_numpy(dst)] = codes.view(torch.uint8).reshape(-1, 16)
        got.append(out.reshape(-1))
    wk, wv = tkw.write_kv_pages_plain(knew, vnew, kp.clone(), vp.clone(),
                                      torch.from_numpy(slots).to(
                                          torch.int32), scale)
    assert torch.equal(got[0], wk.view(torch.uint8).reshape(-1))
    assert torch.equal(got[1], wv.view(torch.uint8).reshape(-1))


# K3 / K4's plan, (rows a block, threads a block, slots read first), by
# token count and source row bytes, on 132 SMs.
@pytest.mark.parametrize("num_tokens,row_bytes,want", [
    (1, 2048, (1, 32, False)),       # Mistral-7B's 8 kv heads in bf16
    (2, 2048, (1, 32, False)),       # the window run's decode step (K3)
    (64, 2048, (1, 32, False)),      # a wide decode round: one row an SM
    (511, 2048, (4, 128, False)),
    (512, 2048, (4, 128, True)),     # SLOT_FIRST_MIN_TOKENS
    (1024, 2048, (8, 256, True)),
    (2728, 2048, (8, 256, True)),    # a prompt round's live rows
    (8192, 2048, (8, 256, True)),    # the same round padded (8-bit pages)
    (8192, 4096, (4, 256, True)),    # f32 rows
    (1, 128, (1, 32, False)),        # one kv head of 64 in bf16
    (8192, 128, (63, 128, True)),    # small rows: one block an SM
    (4, 65536, (1, 256, False)),     # a row wider than a round: 4 rounds
    (8192, 16, (63, 64, True)),      # 16-byte rows: a thread a slot
    (100000, 16, (256, 256, True)),
])
def test_slot_write_plan_table(num_tokens, row_bytes, want):
    rows, threads, first = tkw.slot_write_plan(num_tokens, row_bytes, 132)
    assert (rows, threads, first) == want
    assert threads % 32 == 0 and 32 <= threads <= tkw.SLOT_THREADS
    assert rows <= threads                    # a thread reads one slot
    assert first == (num_tokens >= tkw.SLOT_FIRST_MIN_TOKENS)
    # One round covers the block's source vectors unless a row alone
    # exceeds it; no more rows than spread the tokens over the SMs.
    per_round = tkw.SLOT_VECS * threads
    assert rows * row_bytes // 16 <= per_round or rows == 1
    assert rows <= max(1, -(-num_tokens // 132))


def test_slot_writer_takes_its_dtype_pairs_only():
    """The slot writer's checks take bf16, fp16 and f32 rows into pages
    of their own dtype or into int8 / fp8 e5m2 pages, and refuse every
    other pair, the mixed float pairs among them (K2 takes only rows of
    the page dtype, fp16 pages too)."""
    def check(src, page, pairs=tkw.SLOT_KINDS):
        kp = torch.zeros(2, 4, 64, dtype=page)
        knew = torch.zeros(3, 64, dtype=src)
        return tkw._check_rows(knew, knew, kp, kp.clone(),
                               torch.zeros(3, dtype=torch.int32), "t",
                               pairs)
    for src in (torch.bfloat16, torch.float16, torch.float32):
        assert check(src, src) == 64 * torch.tensor([], dtype=src
                                                    ).element_size()
        for page in (torch.int8, torch.float8_e5m2):
            assert check(src, page) == 64
    assert check(torch.float16, torch.float16,
                 {(d, d) for d in tkw._DTYPES}) == 128
    floats = (torch.bfloat16, torch.float16, torch.float32)
    mixed = [(a, b) for a in floats for b in floats if a != b]
    for src, page in mixed + [(torch.int8, torch.int8),
                              (torch.uint8, torch.uint8)]:
        with pytest.raises(TypeError):
            check(src, page)
    with pytest.raises(TypeError):
        check(torch.bfloat16, torch.int8, {(d, d) for d in tkw._DTYPES})


def _rn32(v):
    """A rational to float32, rounded to nearest, ties to even."""
    f = np.float32(float(v))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                     int(np.float32(c).view(np.int32)) & 1))


def _fma32(a, b, c):
    """float32 fma, a * b + c rounded once, on arrays of finite values."""
    return np.array([_rn32(Fraction(float(x)) * Fraction(float(y)) +
                           Fraction(float(z)))
                     for x, y, z in np.broadcast(a, b, c)], np.float32)


def _int8_code(x, s):
    """The slot writer's int8 rule (csrc/kv_write.cu `quantize_vec`, with
    csrc/kv_quant.cuh's `quotient`, `quotient_safe` and `int8_of`) in
    float32 numpy, value by value: where x is 0 or |x| lies in [2^-60,
    2^60), q = x r (r = RN(1 / s)) refined twice by q + (x - s q) r, each
    step one fma; elsewhere the IEEE division (the kernel then divides
    all 16 values of the vector, which gives each the same code); then
    round half to even (cvt.rni: NaN to 0) and clamp to +-127."""
    x = np.asarray(x, dtype=np.float32)
    s = np.float32(s)
    r = np.float32(1) / s
    ex = (x.view(np.uint32) >> 23) & 0xFF
    safe = ((ex >= 67) & (ex < 187)) | (x == 0)
    with np.errstate(all="ignore"):
        q = x / s
        xs = x[safe]
        qs = xs * r
        for _ in range(2):
            qs = _fma32(_fma32(-s, qs, xs), r, qs)
        q[safe] = qs
        code = np.clip(np.nan_to_num(np.rint(q), nan=0.0), -127, 127)
    return code.astype(np.int8)


@pytest.mark.parametrize("scale", [0.05, 0.25, 1 / 3, 0.0123, 7.0])
def test_int8_code_rule_matches_quantize_kv(scale):
    """The kernels' int8 rule (the quotient refined from the reciprocal by
    two fma corrections, no division) equals `quantize_kv`'s IEEE
    division, rounding and clamp on random values, on random bfloat16
    bit patterns (whose x / S lie near half-integers often), on every
    half-integer code boundary and the 16 float32 values on each side of
    it, and on 0, +-inf, NaN and magnitudes outside the fma range."""
    rng = np.random.default_rng(3)
    s = np.float32(scale)
    ties = (np.arange(-130, 131, dtype=np.float32) + np.float32(0.5)) * s
    around = ties[:, None].view(np.int32) + np.arange(-16, 17)[None, :]
    bf16 = (rng.integers(0, 2 ** 16, 3000).astype(np.uint32) << 16).view(
        np.float32)
    vals = np.concatenate([
        rng.normal(size=1500).astype(np.float32) * s * 60,
        bf16[np.isfinite(bf16)],
        around.astype(np.int32).view(np.float32).ravel(),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 2.0 ** 70, 1e-30],
                 np.float32)])
    want = tkq.quantize_kv(torch.from_numpy(vals), torch.int8, scale)
    np.testing.assert_array_equal(_int8_code(vals, scale), want.numpy())


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

