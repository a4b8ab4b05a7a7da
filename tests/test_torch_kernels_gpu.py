"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked `gpu` and skips without a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed: `python -m pytest --noconftest -m gpu
tests/test_torch_kernels_gpu.py` (tests/conftest.py imports JAX).

Tolerances: the writers copy values, so exactly equal (on int8 and fp8
pages too: the quantized rows equal the plain `quantize_kv`'s). Decode
attention (K1 and K5, bf16, int8 and fp8 pages): |kernel - plain| <=
2e-2 + 2e-2 |plain| (both round the dot operands to bf16 and sum in f32
in another order; exp2 differs by an ulp, which can move a weight to
the neighbouring bf16 value; both round the output to bf16, one ulp of
which is 1.6e-2 at 2-4). The GPTQ
and AWQ matmuls (bf16 outputs, f32 sums taken in another order): the
same 2e-2 + 2e-2 |plain|, and so the GGUF matmuls (K13, K14 and K15,
which sums exact int32 group dots in f32). int8 activation
quantization: exactly equal. K15, K8 and K11 at m > 64 fold each group
in group order with one fma (the plain version rounds a product and a
sum; a split folds its part of a group) and are held to the same
tolerance. K12, K16 on bf16 and K17 (bf16 outputs of
f32 sums): 2e-2 + 2e-2 |plain|; their m > 64 kernels also dequantize
bit for bit (identity rows of x), and so do K13's and K17's stream
kernels. K16 on f32 x: within 1e-4 of max
|plain| (three bf16 products per term keep about 16 mantissa bits of
each operand; the plain version sums exact f32 products); its m > 64
kernel returns bf16 hi + lo of each f32 entry bit for bit (identity
rows of x).
The threefry draws (`modeling/layers/prng.py`): keys, bits and uniforms
bit-equal to the same calls on the CPU, and the tokens drawn equal.
The speculative verify shape (K4 then read-only K1, rows of a sequence
sharing one table): K4 exact, K1 within the attention tolerance, and a
control (every row at the sequence's last context) beyond it. K1 at
group 1 (DeepSeek-MoE-16B's 16 over 16 heads): the attention tolerance;
K2 and K4 at 16 KV heads: exact. The MoE FFN (grouped path, bf16
products rounded at gate, up, act and down): within 2e-2 + 2e-2 |f64|
of an f64 evaluation on the same picks. The quantized fallback route
(plain torch: dequantize, then matmul) on layers the gates refuse and on
float32 activations: the card's `apply` against the CPU's, bf16 within
2e-2 + 2e-2 |cpu|, f32 within 1e-4 of max |cpu|, no quantized wrapper
launching; an act-order GPTQ engine built for the card generates
without a GPTQ kernel.
"""
import numpy as np
import pytest
import torch

from aphrodite_tpu_torch.modeling.layers import prng
from aphrodite_tpu_torch.ops.cuda import kv_write as tkw
from aphrodite_tpu_torch.ops.cuda import paged_attention as tpa
from aphrodite_tpu_torch.ops.cuda import quant_matmul as tqm
from aphrodite_tpu_torch.ops import kv_quant as tkq

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


KV_SCALE = 0.05
# A `tkw.SLOT_FIRST_MIN_TOKENS` no launch reaches: K3 / K4 read their
# slots beside the data (0 pins the other order, slots first).
SLOTS_BESIDE = 1 << 62


def _decode_problem(dev, ctxs, page_size=32, pps=64, seed=0,
                    page_dtype=torch.bfloat16, d=128, hq=32, hkv=8,
                    act=None):
    """q, pages, tables, contexts and the fused rows of a decode call;
    activations `act` (default: f32 on f32 pages, else bf16)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(ctxs)
    pages = b * pps + 1
    if act is None:
        act = torch.float32 if page_dtype == torch.float32 else \
            torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(act)

    def page_values():
        x = randn(pages, page_size, hkv * d)
        return tkq.quantize_kv(x, page_dtype, KV_SCALE)
    tables = (torch.randperm(pages - 1, generator=g, device=dev)[:b * pps]
              + 1).view(b, pps).to(torch.int32).contiguous()
    return (randn(b, hq, d), page_values(), page_values(), tables,
            torch.tensor(ctxs, dtype=torch.int32, device=dev),
            randn(b, hkv, d), randn(b, hkv, d))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("alibi", [False, True])
def test_paged_decode_attention_kernel_matches_plain(dev, fused, alibi):
    q, kp, vp, tb, ctx, kn, vn = _decode_problem(
        dev, [1, 0, 17, 100, 1000, 2047, 33, 512])
    slopes = torch.tensor([2.0 ** -(i / 4 + 1) for i in range(32)],
                          device=dev) if alibi else None
    kn, vn = (kn, vn) if fused else (None, None)
    kp2, vp2 = kp.clone(), vp.clone()
    got = tpa.paged_decode_attention(q, kp, vp, tb, ctx, slopes, kn, vn,
                                     scale=128 ** -0.5)
    want = tpa.paged_decode_attention_plain(q, kp2, vp2, tb, ctx, slopes,
                                            kn, vn, scale=128 ** -0.5)
    torch.cuda.synchronize()
    if fused:
        got, want = got[0], want[0]
        assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    assert (got[1] == 0).all()                     # ctx 0 row
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2e-2 + 2e-2 * want.float().abs()).all()), \
        err.max().item()


def _bytes(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


@pytest.mark.parametrize("page_dtype", [torch.bfloat16, torch.int8,
                                        torch.float8_e5m2])
@pytest.mark.parametrize("ragged,splits", [
    (False, None), (True, None), (True, 1), (True, 2), (True, "chunks")],
    ids=["K5", "K1", "K1-1split", "K1-2splits", "K1-split-per-chunk"])
@pytest.mark.parametrize("fused,alibi,amla", [
    (False, False, True), (True, True, False), (True, False, True)])
def test_decode_attention_kernels_on_every_page_type(dev, ragged, splits,
                                                     page_dtype, fused,
                                                     alibi, amla):
    """K1 (with a work list; its split count forced or the policy's) and
    K5 (without; the policy's split count on its grid) against the plain
    version at the same split count; fused-write codes exact; the merge
    launches exactly when the kernel splits."""
    ctxs = [1, 0, 17, 100, 1000, 2047, 33, 512]
    q, kp, vp, tb, ctx, kn, vn = _decode_problem(
        dev, ctxs, page_dtype=page_dtype, seed=3)
    slopes = torch.tensor([2.0 ** -(i / 4 + 1) for i in range(32)],
                          device=dev) if alibi else None
    kn, vn = (kn, vn) if fused else (None, None)
    ppc = tpa.choose_pages_per_chunk(tb.shape[1], 32, len(ctxs))
    work = tpa.build_decode_work_list(
        [-(-c // 32) for c in ctxs], ppc) if ragged else None
    if splits == "chunks":
        splits = tb.shape[1] // ppc
    # K5 splits too: K1's policy on the same (batch, Hkv) grid.
    n_split = tpa.choose_decode_splits(len(ctxs), 8, tb.shape[1], ppc,
                                       tpa.sm_count(dev)) \
        if splits is None else splits
    kv_scale = tkq.dequant_scale(page_dtype, KV_SCALE)
    counter = tpa.PAGED_DECODE_ATTENTION_LAUNCHES if ragged else \
        tpa.PAGED_DECODE_ATTENTION_TM_LAUNCHES
    before = counter.count
    merges = tpa.PAGED_DECODE_MERGE_LAUNCHES.count
    kp2, vp2 = kp.clone(), vp.clone()
    kw = dict(scale=128 ** -0.5, kv_scale=kv_scale, pages_per_chunk=ppc,
              amla=amla)
    got = tpa.paged_decode_attention(q, kp, vp, tb, ctx, slopes, kn, vn,
                                     work_items=work, num_splits=splits,
                                     **kw)
    want = tpa.paged_decode_attention_plain(q, kp2, vp2, tb, ctx, slopes,
                                            kn, vn, num_splits=n_split,
                                            **kw)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    assert tpa.PAGED_DECODE_MERGE_LAUNCHES.count == \
        merges + (n_split > 1)
    if fused:
        got, want = got[0], want[0]
        assert torch.equal(_bytes(kp), _bytes(kp2))
        assert torch.equal(_bytes(vp), _bytes(vp2))
    assert (got[1] == 0).all()                     # ctx 0 row
    _close(got, want)


# K1 off the main path's geometry: its launcher plans the ring per page
# size and head_dim (slots that cross pages, fewer stages or rows where
# a chunk's scores take the room), so every page size and head_dim up
# to 256 serves. (page_size, head_dim, Hq, Hkv); a head_dim of 72 is 8
# mod 16 (bf16 and f32 pages only: 8-bit rows must be 16-byte runs).
K1_GEOMETRIES = [
    (1, 128, 32, 8), (5, 128, 32, 8), (8, 128, 32, 8), (24, 128, 32, 8),
    (64, 128, 32, 8), (128, 128, 32, 8), (256, 128, 32, 8),
    (64, 256, 16, 4), (128, 256, 16, 4), (256, 256, 16, 4),
    (256, 256, 32, 2), (32, 72, 32, 8),
]


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("page_dtype,page_size,d,hq,hkv", [
    (dt, *geo) for dt in (torch.bfloat16, torch.int8, torch.float8_e5m2,
                          torch.float32)
    for geo in K1_GEOMETRIES if geo[1] % 16 == 0 or dt.itemsize > 1])
def test_k1_serves_every_page_size_and_head_dim(dev, batch, page_dtype,
                                                page_size, d, hq, hkv):
    """K1 at page sizes 1-256 and head_dim 72-256, groups 4-16, batch 8
    (split, wide slots) and 64 (one split), fused write and ALiBi,
    against the plain version at the same split count."""
    rng = np.random.default_rng(batch)
    ctxs = [1, 0, 17, 100, 1000, 2047, 33, 512]
    ctxs += [int(c) for c in rng.integers(0, 2048, batch - len(ctxs))]
    pps = -(-2048 // page_size)
    q, kp, vp, tb, ctx, kn, vn = _decode_problem(
        dev, ctxs, page_size=page_size, pps=pps, seed=5,
        page_dtype=page_dtype, d=d, hq=hq, hkv=hkv)
    slopes = torch.tensor([2.0 ** -(i / 4 + 1) for i in range(hq)],
                          device=dev)
    ppc = tpa.choose_pages_per_chunk(pps, page_size, batch)
    work = tpa.build_decode_work_list(
        [-(-c // page_size) for c in ctxs], ppc)
    n_split = tpa.choose_decode_splits(batch, hkv, pps, ppc,
                                       tpa.sm_count(dev))
    kw = dict(scale=d ** -0.5, kv_scale=tkq.dequant_scale(page_dtype,
                                                          KV_SCALE),
              pages_per_chunk=ppc)
    kp2, vp2 = kp.clone(), vp.clone()
    got, _, _ = tpa.paged_decode_attention(q, kp, vp, tb, ctx, slopes, kn,
                                           vn, work_items=work, **kw)
    want, _, _ = tpa.paged_decode_attention_plain(
        q, kp2, vp2, tb, ctx, slopes, kn, vn, num_splits=n_split, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bytes(kp), _bytes(kp2))
    assert torch.equal(_bytes(vp), _bytes(vp2))
    assert (got[1] == 0).all()                     # ctx 0 row
    _close(got, want)


def test_k1_splits_a_table_wider_than_a_split_stages(dev):
    """Tables of more than 2048 pages take at least two splits, so each
    split's entries fit K1's shared memory, even where batch x Hkv
    covers the card."""
    rng = np.random.default_rng(11)
    ctxs = [4096, 1, 0, 2049] + [int(c) for c in rng.integers(0, 4097, 60)]
    q, kp, vp, tb, ctx, kn, vn = _decode_problem(dev, ctxs, page_size=1,
                                                 pps=4096, seed=6)
    ppc = tpa.choose_pages_per_chunk(4096, 1, len(ctxs))
    n_split = tpa.choose_decode_splits(len(ctxs), 8, 4096, ppc,
                                       tpa.sm_count(dev))
    assert n_split == 2
    work = tpa.build_decode_work_list(ctxs, ppc)
    kw = dict(scale=128 ** -0.5, pages_per_chunk=ppc)
    kp2, vp2 = kp.clone(), vp.clone()
    got, _, _ = tpa.paged_decode_attention(q, kp, vp, tb, ctx, None, kn, vn,
                                           work_items=work, **kw)
    want, _, _ = tpa.paged_decode_attention_plain(
        q, kp2, vp2, tb, ctx, None, kn, vn, num_splits=n_split, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    _close(got, want)


# K5 (the padded grid, no work list): every geometry K1 serves, with
# the split count its grid gives; batch 8 (splits) and 64 (the B 64 x
# 2047 row of chip_smoke: 2047 tokens in every row).
@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("page_dtype,page_size,d,hq,hkv", [
    (dt, *geo) for dt in (torch.bfloat16, torch.int8, torch.float8_e5m2,
                          torch.float32)
    for geo in K1_GEOMETRIES if geo[1] % 16 == 0 or dt.itemsize > 1])
def test_k5_serves_every_geometry(dev, batch, page_dtype, page_size, d,
                                  hq, hkv):
    """K5 at page sizes 1-256, head_dim 72-256, groups 4-16, fused write
    and ALiBi (AMLA at batch 8, the multiply at 64), against the plain
    version at the split count it picks."""
    ctxs = [1, 0, 17, 100, 1000, 2047, 33, 512] if batch == 8 else \
        [2047] * 62 + [0, 1]
    pps = -(-2048 // page_size)
    ppc = tpa.choose_pages_per_chunk(pps, page_size, batch)
    n_split = tpa.choose_decode_splits(batch, hkv, pps, ppc,
                                       tpa.sm_count(dev))
    q, kp, vp, tb, ctx, kn, vn = _decode_problem(
        dev, ctxs, page_size=page_size, pps=pps, seed=7,
        page_dtype=page_dtype, d=d, hq=hq, hkv=hkv)
    slopes = torch.tensor([2.0 ** -(i / 4 + 1) for i in range(hq)],
                          device=dev)
    kw = dict(scale=d ** -0.5, kv_scale=tkq.dequant_scale(page_dtype,
                                                          KV_SCALE),
              pages_per_chunk=ppc, amla=batch == 8)
    before = tpa.PAGED_DECODE_ATTENTION_TM_LAUNCHES.count
    merges = tpa.PAGED_DECODE_MERGE_LAUNCHES.count
    kp2, vp2 = kp.clone(), vp.clone()
    got, _, _ = tpa.paged_decode_attention(q, kp, vp, tb, ctx, slopes, kn,
                                           vn, **kw)
    want, _, _ = tpa.paged_decode_attention_plain(
        q, kp2, vp2, tb, ctx, slopes, kn, vn, num_splits=n_split, **kw)
    torch.cuda.synchronize()
    assert tpa.PAGED_DECODE_ATTENTION_TM_LAUNCHES.count == before + 1
    assert tpa.PAGED_DECODE_MERGE_LAUNCHES.count == merges + (n_split > 1)
    assert torch.equal(_bytes(kp), _bytes(kp2))
    assert torch.equal(_bytes(vp), _bytes(vp2))
    assert (got[batch - 2] == 0).all() if batch == 64 else \
        (got[1] == 0).all()                        # the ctx 0 row
    _close(got, want)


def test_k5_control_misses_the_tolerance(dev):
    """A wrong plain version, the K rows of the neighbouring head block
    (pages rolled by d along the lanes), must miss `_close`'s tolerance
    against K5, so a head-offset fault in the staged slots cannot pass
    the checks above."""
    ctxs = [2047] * 62 + [1000, 17]
    q, kp, vp, tb, ctx, _, _ = _decode_problem(dev, ctxs, seed=9)
    ppc = tpa.choose_pages_per_chunk(tb.shape[1], 32, len(ctxs))
    n_split = tpa.choose_decode_splits(len(ctxs), 8, tb.shape[1], ppc,
                                       tpa.sm_count(dev))
    kw = dict(scale=128 ** -0.5, pages_per_chunk=ppc)
    got = tpa.paged_decode_attention(q, kp, vp, tb, ctx, **kw)
    good = tpa.paged_decode_attention_plain(q, kp, vp, tb, ctx,
                                            num_splits=n_split, **kw)
    bad = tpa.paged_decode_attention_plain(q, kp.roll(128, 2), vp, tb, ctx,
                                           num_splits=n_split, **kw)
    torch.cuda.synchronize()
    _close(got, good)
    assert _misses(got, bad)


@pytest.mark.parametrize("page_dtype", [torch.int8, torch.float8_e5m2])
def test_slot_writers_on_8bit_pages_are_exact(dev, page_dtype,
                                              monkeypatch):
    """K3 / K4 on 8-bit pages: one launch quantizes the bf16 rows in
    registers and scatters the codes, bit-equal to the plain version's
    quantize-then-scatter (rows of 3 N(0, 1), so int8 codes at scale
    0.05 clamp), in both slot-read orders."""
    g = torch.Generator(device=dev).manual_seed(2)
    kp = tkq.quantize_kv(torch.randn(16, 16, 1024, generator=g, device=dev),
                         page_dtype, KV_SCALE)
    knew = torch.randn(64, 1024, generator=g, device=dev).to(
        torch.bfloat16) * 3
    slots = torch.randperm(256, generator=g, device=dev)[:64].to(
        torch.int32)
    slots[::7] = 256
    b = tkw.write_kv_pages_plain(knew, knew * 2, kp.clone(), kp.clone(),
                                 slots, KV_SCALE)
    plan = tkw.SLOT_FIRST_MIN_TOKENS
    for distinct, min_tokens in ((False, plan), (True, plan),
                                 (False, 0), (True, SLOTS_BESIDE)):
        monkeypatch.setattr(tkw, "SLOT_FIRST_MIN_TOKENS", min_tokens)
        counter = tkw.WRITE_KV_PAGES_DECODE_LAUNCHES if distinct else \
            tkw.WRITE_KV_PAGES_LAUNCHES
        before = counter.count
        a = tkw.write_kv_pages(knew, knew * 2, kp.clone(), kp.clone(),
                               slots, distinct_pages=distinct,
                               kv_scale=KV_SCALE)
        torch.cuda.synchronize()
        assert counter.count == before + 1
        assert torch.equal(_bytes(a[0]), _bytes(b[0]))
        assert torch.equal(_bytes(a[1]), _bytes(b[1]))


def _edge_rows(dev, src_dtype, hd=1024):
    """Rows of the 8-bit write rules' edge values, each exact in bf16:
    int8 ties at S = 0.25 (x = k / 4 + 1 / 8, so x / S = k + 1/2, k in
    [-128, 127]) and values that clamp at +-127 (x / S from 127.5 to
    4e9); every midpoint of two neighbouring finite fp8 e5m2 values and
    of the largest and +inf (61440), values past it, +-inf and NaN of
    both signs; all of them negated too, the rows filled out by
    repeating the list, then shifted one place a row. fp16 rows (the
    twin): the same list without the values past fp16's range (2^30,
    2^16, 2^20), plus fp16's own edges around e5m2's overflow (57376,
    60000, 61408, 61472, 65504: e5m2 57344 below 61440, inf from
    there), each exact in fp16."""
    e5m2 = torch.arange(0, 0x7C, dtype=torch.uint8).view(
        torch.float8_e5m2).float()
    mids = (e5m2[:-1] + e5m2[1:]) / 2
    vals = torch.cat([
        torch.arange(-128, 128).float() * 0.25 + 0.125,
        torch.tensor([31.875, 32.0, 40.0, 2.0 ** 30]), e5m2, mids,
        torch.tensor([61440.0, 65536.0, 2.0 ** 20, float("inf"),
                      float("nan")])])
    if src_dtype == torch.float16:
        vals = torch.cat([vals[vals.abs() < 65536.0],
                          torch.tensor([57376.0, 60000.0, 61408.0, 61472.0,
                                        65504.0, float("inf"),
                                        float("nan")])])
    vals = torch.cat([vals, -vals])
    exact = torch.float16 if src_dtype == torch.float16 else torch.bfloat16
    assert bool((vals.to(exact).float().nan_to_num(7) ==
                 vals.nan_to_num(7)).all())
    rows = vals.repeat(-(-hd // len(vals)) + 1)
    rows = torch.stack([rows[r:r + hd] for r in range(48)])
    return rows.to(dev, src_dtype).contiguous()


@pytest.mark.parametrize("src_dtype", [torch.bfloat16, torch.float32,
                                       torch.float16])
@pytest.mark.parametrize("page_dtype", [torch.int8, torch.float8_e5m2])
def test_slot_writer_rounds_as_the_plain_cast(dev, page_dtype, src_dtype):
    """The kernel's 8-bit codes at their edges, bit-equal to the plain
    version (`quantize_kv`, torch's division, rounding and cast): int8
    round-half-even ties and clamps at S = 0.25, fp8 e5m2 rounding
    midpoints (subnormal ones too), overflow to +-inf and NaN (torch's
    NaN byte, 0x7F with the sign), from bf16, f32 and fp16 rows (fp16's
    own edges around e5m2's overflow included)."""
    g = torch.Generator(device=dev).manual_seed(4)
    knew = _edge_rows(dev, src_dtype)
    vnew = knew.flip(0).contiguous()
    kp = torch.zeros(8, 16, 1024, device=dev, dtype=torch.uint8).view(
        page_dtype)
    slots = torch.randperm(128, generator=g, device=dev)[:48].to(
        torch.int32)
    slots[::5] = 128
    a = tkw.write_kv_pages(knew, vnew, kp.clone(), kp.clone(), slots,
                           kv_scale=0.25)
    b = tkw.write_kv_pages_plain(knew, vnew, kp.clone(), kp.clone(), slots,
                                 0.25)
    torch.cuda.synchronize()
    assert torch.equal(_bytes(a[0]), _bytes(b[0]))
    assert torch.equal(_bytes(a[1]), _bytes(b[1]))


@pytest.mark.parametrize("ragged", [True, False], ids=["K1", "K5"])
@pytest.mark.parametrize("page_dtype", [torch.int8, torch.float8_e5m2])
def test_fused_write_rounds_as_the_slot_writer(dev, page_dtype, ragged):
    """K1's (work list) and K5's fused write at the 8-bit rules' edges
    (`_edge_rows` as the new K and V, S = 0.25 on int8 pages): page bytes
    equal to the slot writer's plain version writing the same rows at
    each sequence's position ctx - 1 (ctx 0 writes nothing)."""
    ctxs = [1, 0, 17, 100, 1000, 2047, 33, 512]
    b = len(ctxs)
    q, kp, vp, tb, ctx, _, _ = _decode_problem(dev, ctxs, seed=5,
                                               page_dtype=page_dtype)
    knew = _edge_rows(dev, torch.bfloat16)[:b].contiguous()
    vnew = knew.flip(0).contiguous()
    kv_scale = tkq.dequant_scale(page_dtype, 0.25)
    ppc = tpa.choose_pages_per_chunk(tb.shape[1], 32, b)
    work = tpa.build_decode_work_list(
        [-(-c // 32) for c in ctxs], ppc) if ragged else None
    pos = (ctx.long() - 1).clamp(min=0)
    slots = tb.long().gather(1, (pos // 32)[:, None])[:, 0] * 32 + pos % 32
    slots = torch.where(ctx > 0, slots, kp.shape[0] * 32).to(torch.int32)
    want = tkw.write_kv_pages_plain(knew, vnew, kp.clone(), vp.clone(),
                                    slots, kv_scale)
    tpa.paged_decode_attention(q, kp, vp, tb, ctx, None,
                               knew.view(b, 8, 128), vnew.view(b, 8, 128),
                               work_items=work, scale=128 ** -0.5,
                               kv_scale=kv_scale, pages_per_chunk=ppc)
    torch.cuda.synchronize()
    assert torch.equal(_bytes(kp), _bytes(want[0]))
    assert torch.equal(_bytes(vp), _bytes(want[1]))


def _slot_round(dev, g, num_tokens, hd=1024):
    """Slots of a round of `num_tokens` tokens in a pool of 32-row pages:
    from 1024 tokens on a padded prompt round (341 live rows of each
    1024, the rest padding: 8192 rows, 2728 live, as chip_smoke's first
    8-bit round), else a decode round with every fifth token padding."""
    if num_tokens >= 1024:
        live = torch.arange(num_tokens, device=dev) % 1024 < 341
    else:
        live = torch.arange(num_tokens, device=dev) % 5 != 4
    num_slots = 32 * (-(-int(live.sum()) // 32) + 4)
    slots = torch.full((num_tokens,), num_slots, dtype=torch.int32,
                       device=dev)
    slots[live] = torch.randperm(num_slots, generator=g, device=dev)[
        :int(live.sum())].to(torch.int32)
    return slots, num_slots // 32


@pytest.mark.parametrize("num_tokens", [2, 64, 8192])
@pytest.mark.parametrize("pair", list(tkw.SLOT_KINDS),
                         ids=lambda p: f"{p[0]}-{p[1]}".replace("torch.", ""))
def test_slot_writer_is_exact_on_every_pair(dev, pair, num_tokens,
                                            monkeypatch):
    """K3 / K4 on every (rows, pages) dtype pair it takes, at the window
    run's 2 rows, a 64-row decode round and an 8-bit prompt round of 8192
    rows, most of them padding: bit-equal to the plain version in the
    plan's slot-read order and in both pinned, one launch a call."""
    src_dtype, page_dtype = pair
    g = torch.Generator(device=dev).manual_seed(num_tokens)
    slots, num_pages = _slot_round(dev, g, num_tokens)
    knew, vnew = (torch.randn(num_tokens, 1024, generator=g,
                              device=dev).mul_(3).to(src_dtype)
                  for _ in range(2))
    kp = tkq.quantize_kv(torch.randn(num_pages, 32, 1024, generator=g,
                                     device=dev), page_dtype, KV_SCALE)
    b = tkw.write_kv_pages_plain(knew, vnew, kp.clone(), kp.clone(), slots,
                                 KV_SCALE)
    for min_tokens in (tkw.SLOT_FIRST_MIN_TOKENS, SLOTS_BESIDE, 0):
        monkeypatch.setattr(tkw, "SLOT_FIRST_MIN_TOKENS", min_tokens)
        before = tkw.WRITE_KV_PAGES_LAUNCHES.count
        a = tkw.write_kv_pages(knew, vnew, kp.clone(), kp.clone(), slots,
                               kv_scale=KV_SCALE)
        torch.cuda.synchronize()
        assert tkw.WRITE_KV_PAGES_LAUNCHES.count == before + 1
        assert torch.equal(_bytes(a[0]), _bytes(b[0]))
        assert torch.equal(_bytes(a[1]), _bytes(b[1]))


def test_slot_writer_controls_miss(dev):
    """Controls that must miss the kernel's pages: the plain version at
    kv_scale x 1.01 on int8 pages, and with every live slot moved one
    row on bf16 pages."""
    g = torch.Generator(device=dev).manual_seed(6)
    slots, num_pages = _slot_round(dev, g, 64)
    knew = torch.randn(64, 1024, generator=g, device=dev).to(torch.bfloat16)
    for page_dtype in (torch.int8, torch.bfloat16):
        kp = tkq.quantize_kv(torch.randn(num_pages, 32, 1024, generator=g,
                                         device=dev), page_dtype, KV_SCALE)
        a = tkw.write_kv_pages(knew, knew, kp.clone(), kp.clone(), slots,
                               kv_scale=KV_SCALE)
        if page_dtype == torch.int8:
            bad = tkw.write_kv_pages_plain(knew, knew, kp.clone(),
                                           kp.clone(), slots,
                                           KV_SCALE * 1.01)
        else:
            moved = torch.where(slots < num_pages * 32,
                                (slots + 1) % (num_pages * 32), slots)
            bad = tkw.write_kv_pages_plain(knew, knew, kp.clone(),
                                           kp.clone(), moved, KV_SCALE)
        torch.cuda.synchronize()
        assert not torch.equal(_bytes(a[0]), _bytes(bad[0]))


def test_writers_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    kp = torch.randn(16, 16, 1024, generator=g, device=dev).to(
        torch.bfloat16)
    knew = torch.randn(64, 1024, generator=g, device=dev).to(torch.bfloat16)
    slots = torch.randperm(256, generator=g, device=dev)[:64].to(
        torch.int32)
    slots[::7] = 256
    a = tkw.write_kv_pages(knew, knew, kp.clone(), kp.clone(), slots)
    b = tkw.write_kv_pages_plain(knew, knew, kp.clone(), kp.clone(), slots)
    pid = torch.tensor([3, 16, 5, 9], dtype=torch.int32, device=dev)
    vld = torch.tensor([16, 16, 7, 1], dtype=torch.int32, device=dev)
    c = tkw.write_kv_pages_prefill(knew, knew, kp.clone(), kp.clone(), pid,
                                   np.arange(4, dtype=np.int32), vld)
    d = tkw.write_kv_pages_prefill_plain(knew, knew, kp.clone(),
                                         kp.clone(), pid, vld)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])


# The speculative verify shape: 8 sequences (contexts L as phase 4 of
# chip_smoke decodes them) x (k + 1) rows, k = 4.
_VERIFY_CTX = [1016, 316, 80, 1016, 316, 80, 28, 28]


@pytest.mark.parametrize("page_dtype", [torch.bfloat16, torch.int8,
                                        torch.float8_e5m2])
@pytest.mark.parametrize("seqs,padded", [(8, 48), (128, 640)])
def test_verify_rows_k4_then_read_only_k1(dev, page_dtype, seqs, padded):
    """A verify round as the model runner builds it: row j of a sequence
    at position L - 1 + j with ctx L + j, the k + 1 rows sharing the
    sequence's block table, padded to the runner's batch (8 sequences:
    40 rows in the bucket of 48; 128: 640 rows, past the largest decode
    bucket, unpadded) with out-of-range slots and page ids, ctx 0. K4
    writes the slots with shared pages: exact, one launch; K1 then reads
    them read-only: within 2e-2 + 2e-2 |plain| of its plain version at
    its split count; a control with every row at ctx L + k misses that
    tolerance."""
    k, ps, hd = 4, 32, 1024
    g = torch.Generator(device=dev).manual_seed(5)
    ctxs = [_VERIFY_CTX[i % 8] + i // 8 for i in range(seqs)]
    need = [-(-(L + k) // ps) for L in ctxs]
    pps = -(-max(need) // 4) * 4
    num_pages = sum(need) + 8
    perm = torch.randperm(num_pages, generator=g, device=dev).tolist()
    tb = torch.full((padded, pps), num_pages, dtype=torch.int32)
    slots = torch.full((padded,), num_pages * ps, dtype=torch.int32)
    ctx = torch.zeros((padded,), dtype=torch.int32)
    bad = torch.zeros((padded,), dtype=torch.int32)
    counts, row = [], 0
    for s, L in enumerate(ctxs):
        table = perm[sum(need[:s]):sum(need[:s + 1])]
        for j in range(k + 1):
            pos = L - 1 + j
            tb[row, :len(table)] = torch.tensor(table)
            slots[row] = table[pos // ps] * ps + pos % ps
            ctx[row], bad[row] = pos + 1, L + k
            counts.append(len(table))
            row += 1
    counts += [0] * (padded - row)
    tb, slots, ctx, bad = (t.to(dev) for t in (tb, slots, ctx, bad))
    tb = tb.clamp(max=num_pages - 1)
    kp = tkq.quantize_kv(torch.randn(num_pages, ps, hd, generator=g,
                                     device=dev), page_dtype, KV_SCALE)
    vp = tkq.quantize_kv(torch.randn(num_pages, ps, hd, generator=g,
                                     device=dev), page_dtype, KV_SCALE)
    knew, vnew = (torch.randn(padded, hd, generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(padded, 32, 128, generator=g, device=dev).to(
        torch.bfloat16)
    before = tkw.WRITE_KV_PAGES_LAUNCHES.count
    a = tkw.write_kv_pages(knew, vnew, kp.clone(), vp.clone(), slots,
                           distinct_pages=False, kv_scale=KV_SCALE)
    b = tkw.write_kv_pages_plain(knew, vnew, kp.clone(), vp.clone(), slots,
                                 KV_SCALE)
    torch.cuda.synchronize()
    assert tkw.WRITE_KV_PAGES_LAUNCHES.count == before + 1
    assert torch.equal(_bytes(a[0]), _bytes(b[0]))
    assert torch.equal(_bytes(a[1]), _bytes(b[1]))
    ppc = tpa.choose_pages_per_chunk(pps, ps, padded)
    nw_real = sum(max(1, -(-c // ppc)) for c in counts)
    mix = 1
    while padded * mix < nw_real:
        mix *= 2
    work = tpa.build_decode_work_list(
        counts, ppc, pad_to=padded * min(mix, -(-pps // ppc)))
    n_split = tpa.choose_decode_splits(padded, 8, pps, ppc,
                                       tpa.sm_count(dev))
    kw = dict(scale=128 ** -0.5,
              kv_scale=tkq.dequant_scale(page_dtype, KV_SCALE),
              pages_per_chunk=ppc)
    before = tpa.PAGED_DECODE_ATTENTION_LAUNCHES.count
    got = tpa.paged_decode_attention(q, a[0], a[1], tb, ctx,
                                     work_items=work, **kw)
    ctl = tpa.paged_decode_attention(q, a[0], a[1], tb, bad,
                                     work_items=work, **kw)
    want = tpa.paged_decode_attention_plain(q, a[0], a[1], tb, ctx,
                                            num_splits=n_split, **kw)
    torch.cuda.synchronize()
    assert tpa.PAGED_DECODE_ATTENTION_LAUNCHES.count == before + 2
    assert (got[row:] == 0).all()                   # padding rows
    _close(got, want)
    assert _misses(ctl, want)


# K2's geometries: (page size, kv heads of 128, page dtype); rows of 256
# bytes to 4 KB, and 768 (3 heads: 21-row blocks, which do not divide a
# 32-row page); fp16 pages are bf16's path byte for byte.
_K2_PAGES = [(16, 8, torch.bfloat16), (32, 8, torch.bfloat16),
             (16, 1, torch.bfloat16), (32, 1, torch.bfloat16),
             (32, 8, torch.float32), (16, 1, torch.float32),
             (32, 3, torch.bfloat16), (32, 8, torch.float16),
             (16, 1, torch.float16)]


@pytest.mark.parametrize("page_size,hkv,page_dtype", _K2_PAGES)
def test_prefill_writer_is_exact_on_every_geometry(dev, page_size, hkv,
                                                   page_dtype):
    """K2 (grid (cell, group of rows) from `prefill_write_plan`) against
    its plain version on full pages, tail pages of every length, skipped
    cells (page id num_pages and beyond) and cells of valid 0: every page
    bit for bit, the rows past valid keeping their contents; one launch
    counted. The control, the plain version also writing row `valid` of
    each tail page (`valids + 1`), must differ."""
    g = torch.Generator(device=dev).manual_seed(page_size + hkv)
    hd, num_pages = hkv * 128, 96
    kp = torch.randn(num_pages, page_size, hd, generator=g,
                     device=dev).to(page_dtype)
    vp = torch.randn(num_pages, page_size, hd, generator=g,
                     device=dev).to(page_dtype)
    valid = [page_size] * 5 + list(range(1, page_size)) + [0, page_size, 3]
    cells = len(valid) + 3
    pid = torch.randperm(num_pages, generator=g, device=dev)[:cells].to(
        torch.int32)
    vld = torch.tensor(valid + [page_size] * 3, dtype=torch.int32,
                       device=dev)
    pid[-3:] = torch.tensor([num_pages, num_pages + 7, 2 ** 30],
                            dtype=torch.int32, device=dev)
    knew = torch.randn(cells * page_size, hd, generator=g, device=dev).to(
        page_dtype)
    vnew = torch.randn(cells * page_size, hd, generator=g, device=dev).to(
        page_dtype)
    sblk = np.arange(cells, dtype=np.int32)
    before = tkw.WRITE_KV_PAGES_PREFILL_LAUNCHES.count
    a = tkw.write_kv_pages_prefill(knew, vnew, kp.clone(), vp.clone(), pid,
                                   sblk, vld)
    b = tkw.write_kv_pages_prefill_plain(knew, vnew, kp.clone(), vp.clone(),
                                         pid, vld)
    bad = tkw.write_kv_pages_prefill_plain(knew, vnew, kp.clone(),
                                           vp.clone(), pid, vld + 1)
    torch.cuda.synchronize()
    assert tkw.WRITE_KV_PAGES_PREFILL_LAUNCHES.count == before + 1
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], bad[0]) and not torch.equal(a[1], bad[1])


def test_wrappers_count_launches_and_refuse_bad_inputs(dev):
    q, kp, vp, tb, ctx, kn, vn = _decode_problem(dev, [5, 9])
    before = tpa.PAGED_DECODE_ATTENTION_LAUNCHES.count
    before_tm = tpa.PAGED_DECODE_ATTENTION_TM_LAUNCHES.count
    tpa.paged_decode_attention(q, kp, vp, tb, ctx, scale=0.1,
                               work_items=tpa.build_decode_work_list(
                                   [1, 1], 8))
    assert tpa.PAGED_DECODE_ATTENTION_LAUNCHES.count == before + 1
    tpa.paged_decode_attention(q, kp, vp, tb, ctx, scale=0.1)
    assert tpa.PAGED_DECODE_ATTENTION_TM_LAUNCHES.count == before_tm + 1
    with pytest.raises(TypeError):
        tpa.paged_decode_attention(q.float(), kp, vp, tb, ctx, scale=0.1)
    with pytest.raises(ValueError, match="mixed devices"):
        tpa.paged_decode_attention(q, kp, vp, tb.cpu(), ctx, scale=0.1)
    with pytest.raises(TypeError):
        tkw.write_kv_pages(kn.view(2, -1), vn.view(2, -1), kp, vp,
                           ctx.long())


def _gptq_problem(dev, m, K, N, bits=4, gs=128, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    pack = 32 // bits

    def bits32(*shape):
        return torch.empty(*shape, dtype=torch.int32, device=dev).random_(
            -2 ** 31, 2 ** 31, generator=g)
    scales = (torch.rand(K // gs, N, generator=g, device=dev) * 0.02 +
              0.002).to(torch.bfloat16)
    x = torch.randn(m, K, generator=g, device=dev).to(torch.bfloat16)
    return x, bits32(K // pack, N), bits32(K // gs, N // pack), scales


def _close(got, want):
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= 2e-2 + 2e-2 * want.float().abs()).all()), \
        err.max().item()


# K9's K: odd and short rows (the element path), Mistral-7B's widths, a
# row twice the widest, and one longer than the register path holds
# (1024 threads x 8 runs of 8).
_K9_K = (1, 7, 4100, 4096, 14336, 28672, 65544)


@pytest.mark.parametrize("K", _K9_K)
def test_quantize_activations_int8_kernel_is_exact(dev, K):
    """K9 equals its plain version bit for bit, codes and row scales, at
    the decode and prompt m, on x and on a contiguous view of it that
    starts 2 bytes past a 16-byte boundary; with rows of halves (ties
    round to even) and a zero row (the 1e-8 floor). A control: scales
    taken from absmax / 128 differ."""
    for m in (1, 8, 64, 513, 4096):
        g = torch.Generator(device=dev).manual_seed(m * K)
        x = torch.randn(m, K, generator=g, device=dev).to(torch.bfloat16) * 3
        x[0, :7] = (0.5 * torch.arange(7, device=dev))[:K]  # halves: ties
        if m > 1:
            x[1] = 0                                    # the 1e-8 floor
        buf = torch.empty(m * K + 1, dtype=x.dtype, device=dev)
        shifted = buf[1:].view(m, K)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 and shifted.is_contiguous()
        p8, ps = tqm.quantize_activations_int8_plain(x)
        before = tqm.QUANTIZE_ACTIVATIONS_INT8_LAUNCHES.count
        for what, xv in (("aligned", x), ("view", shifted)):
            x8, xs = tqm.quantize_activations_int8(xv)
            torch.cuda.synchronize()
            assert torch.equal(x8, p8) and torch.equal(xs, ps), (what, m)
        assert tqm.QUANTIZE_ACTIVATIONS_INT8_LAUNCHES.count == before + 2
        bad = torch.clamp(x.float().abs().amax(dim=1, keepdim=True),
                          min=1e-8) / torch.full_like(xs, 128.0)
        assert not torch.equal(xs, bad)


# Mistral-7B's four projections (K, N): qkv, o, gate_up, down.
_PROJ = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
# K6 / K10 (m > 64): the m where decode runs above batch 64 and prompt
# rounds run, at every projection.
_GEMM_M = (65, 96, 128, 129, 257, 1000, 4096)


def _reduces(m, K, N, gs, stream, dev, a8=False):
    """The split reduces one K6 / K10 (or, with `a8`, K8 / K11) launch
    adds (none when streamed)."""
    if stream:
        return 0
    plan = tqm.a8_gemm_plan if a8 else tqm.gemm_plan
    return int(plan(m, K, N, gs, tqm.build.sm_count(dev))[0] > 1)


@pytest.mark.parametrize("m,K,N,bits,gs,stream", [
    (1, 4096, 6144, 4, 128, True),
    (8, 14336, 4096, 4, 128, True),
    (64, 4096, 4096, 8, 128, True),
    (33, 2048, 1024, 4, 256, True),
    (65, 4096, 4096, 4, 128, False),
    (300, 2048, 2048, 8, 256, False),
    (8, 1024, 512, 4, 128, False),
] + [(m, K, N, 4, 128, False) for m in _GEMM_M for K, N in _PROJ] + [
    (m, K, N, 8, 128, False) for m in (72, 1000) for K, N in _PROJ] + [
    (200, 4096, 6144, 4, 256, False),
    (1000, 4096, 4096, 4, 1024, False),
    (96, 14336, 4096, 8, 1024, False),
    (130, 3200, 4096, 4, 200, False),     # groups of 200: 64+64+64+8 rows
    (513, 4080, 1152, 8, 136, False),     # groups of 136, N % 256 = 128
    (77, 2048, 384, 4, 128, False),       # a 128-column tail tile
])
def test_gptq_matmul_kernels_match_plain(dev, m, K, N, bits, gs, stream):
    x, qw, qz, sc = _gptq_problem(dev, m, K, N, bits, gs)
    counter = tqm.GPTQ_MATMUL_STREAM_LAUNCHES if stream \
        else tqm.GPTQ_MATMUL_LAUNCHES
    before = (counter.count, tqm.QUANT_GEMM_REDUCE_LAUNCHES.count)
    got = tqm.gptq_matmul(x, qw, qz, sc, bits=bits, group_size=gs,
                          stream=stream)
    want = tqm.gptq_matmul_plain(x, qw, qz, sc, bits=bits, group_size=gs)
    torch.cuda.synchronize()
    assert (counter.count, tqm.QUANT_GEMM_REDUCE_LAUNCHES.count) == \
        (before[0] + 1, before[1] + _reduces(m, K, N, gs, stream, dev))
    _close(got, want)


def _misses(got, want):
    """True where `_close` would fail: some element off by more than
    2e-2 + 2e-2 |plain|."""
    err = (got.float() - want.float()).abs()
    return bool((err > 2e-2 + 2e-2 * want.float().abs()).any())


def _views(x_all, m):
    """x [m, K] as views into a larger buffer: at a row offset (16-byte
    aligned rows, the cp.async path) and at a one-element offset (rows
    unaligned, the element-load path)."""
    K = x_all.shape[1]
    flat = x_all.reshape(-1)
    return {"row offset": x_all[3:3 + m],
            "element offset": flat[1:1 + m * K].view(m, K)}


@pytest.mark.parametrize("awq", [False, True])
@pytest.mark.parametrize("m,K,N", [(72, 4096, 4096), (300, 14336, 4096)])
def test_gemm_kernels_take_views_of_x(dev, awq, m, K, N):
    """K6 / K10 on x given as a view at a row offset and at an unaligned
    element offset, against the plain version on a copy."""
    if awq:
        x_all, qw, qz, sc = _awq_problem(dev, m + 8, K, N)
        fn = lambda x: tqm.awq_matmul(x, qw, qz, sc, group_size=128)
        plain = lambda x: tqm.awq_matmul_plain(x, qw, qz, sc,
                                               group_size=128)
    else:
        x_all, qw, qz, sc = _gptq_problem(dev, m + 8, K, N)
        fn = lambda x: tqm.gptq_matmul(x, qw, qz, sc, bits=4,
                                       group_size=128)
        plain = lambda x: tqm.gptq_matmul_plain(x, qw, qz, sc, bits=4,
                                                group_size=128)
    for what, x in _views(x_all, m).items():
        assert x.is_contiguous() and x.data_ptr() != x_all.data_ptr(), what
        got = fn(x)
        want = plain(x.clone())
        torch.cuda.synchronize()
        _close(got, want)


@pytest.mark.parametrize("awq", [False, True])
@pytest.mark.parametrize("m", [96, 1000])
def test_gemm_control_misses_the_tolerance(dev, awq, m):
    """A wrong plain version (the scale rows shifted by one group) must
    miss `_close`'s tolerance against K6 / K10, so a swizzle or layout
    fault that gives plausible numbers cannot pass the checks above."""
    K, N = 4096, 4096
    if awq:
        x, qw, qz, sc = _awq_problem(dev, m, K, N)
        got = tqm.awq_matmul(x, qw, qz, sc, group_size=128)
        good = tqm.awq_matmul_plain(x, qw, qz, sc, group_size=128)
        bad = tqm.awq_matmul_plain(x, qw, qz, sc.roll(1, 0),
                                   group_size=128)
    else:
        x, qw, qz, sc = _gptq_problem(dev, m, K, N)
        got = tqm.gptq_matmul(x, qw, qz, sc, bits=4, group_size=128)
        good = tqm.gptq_matmul_plain(x, qw, qz, sc, bits=4, group_size=128)
        bad = tqm.gptq_matmul_plain(x, qw, qz, sc.roll(1, 0), bits=4,
                                    group_size=128)
    torch.cuda.synchronize()
    _close(got, good)
    assert _misses(got, bad)


@pytest.mark.parametrize("m,K,N,gs,stream", [
    (1, 4096, 6144, 128, True), (8, 14336, 4096, 128, True),
    (64, 4096, 4096, 128, True),
    (65, 4096, 4096, 128, False), (300, 2048, 2048, 128, False),
    (8, 1024, 512, 128, False),           # m 8 unstreamed: one row tile
] + [(m, K, N, 128, False) for m in (72, 128, 129, 4096)
     for K, N in _PROJ] + [
    (72, 4096, 4096, 1024, False), (1000, 14336, 4096, 1024, False),
    (72, 4096, 6144, -1, False),          # one group of K rows, split
    (129, 14336, 4096, -1, False), (4096, 4096, 4096, -1, False),
    (130, 3200, 4096, 200, False),        # groups of 200: 128 + 72 rows
    (513, 4080, 1152, 136, False),        # groups of 136: x8 by the consumers
    (77, 2048, 384, 128, False),          # N 384, N 1152: odd tile counts
    (129, 1024, 1152, 256, False),
    (96, 2048, 1024, 64, False),          # groups of 64: half chunks
])
def test_gptq_matmul_a8_kernels_match_plain(dev, m, K, N, gs, stream):
    """K7's a8 arm (streamed) and K8 (`w8a8_gemm_kernel` with the GPTQ
    decoder) against the plain version within 2e-2 + 2e-2 |plain|: K9
    and one matmul launch each, and K8's split reduce where
    `a8_gemm_plan` splits (one group of K rows too)."""
    x, qw, qz, sc = _gptq_problem(dev, m, K, N, gs=K if gs == -1 else gs)
    counter = tqm.GPTQ_MATMUL_STREAM_A8_LAUNCHES if stream \
        else tqm.GPTQ_MATMUL_A8_LAUNCHES
    counts = lambda: (counter.count,
                      tqm.QUANTIZE_ACTIVATIONS_INT8_LAUNCHES.count,
                      tqm.QUANT_GEMM_REDUCE_LAUNCHES.count)
    before = counts()
    got = tqm.gptq_matmul_a8(x, qw, qz, sc, bits=4, group_size=gs,
                             stream=stream)
    want = tqm.gptq_matmul_a8_plain(x, qw, qz, sc, bits=4, group_size=gs)
    torch.cuda.synchronize()
    g = K if gs == -1 else gs
    assert counts() == (before[0] + 1, before[1] + 1,
                        before[2] + _reduces(m, K, N, g, stream, dev, True))
    _close(got, want)


def _a8_gemm_call(dev, awq, m, K, N, gs=128, seed=0):
    """x, (K9 + K8 or K11 wrapper), (the matmul alone on K9's rows x8,
    xs), (plain of x, optionally other zeros) and the zeros."""
    if awq:
        x, qw, qz, sc = _awq_problem(dev, m, K, N, gs, seed=seed)
        wrapper = lambda xx: tqm.awq_matmul_a8(xx, qw, qz, sc, group_size=gs,
                                               stream=False)
        plain = lambda xx, zz=qz: tqm.awq_matmul_a8_plain(
            xx, qw, zz, sc, group_size=gs)
        counter = tqm.AWQ_MATMUL_A8_LAUNCHES
    else:
        x, qw, qz, sc = _gptq_problem(dev, m, K, N, gs=gs, seed=seed)
        wrapper = lambda xx: tqm.gptq_matmul_a8(xx, qw, qz, sc, bits=4,
                                                group_size=gs, stream=False)
        plain = lambda xx, zz=qz: tqm.gptq_matmul_a8_plain(
            xx, qw, zz, sc, bits=4, group_size=gs)
        counter = tqm.GPTQ_MATMUL_A8_LAUNCHES
    launch = lambda x8, xs: tqm._launch(
        True, x8, xs, qw, qz, sc, bits=4, gs=gs, stream=False,
        counter=counter, what="a8 launch", awq=awq)
    return x, wrapper, launch, plain, (qw, qz, sc)


def _awq_natural_order_plain(x, qw, qz, sc, gs):
    """The AWQ a8 plain version with AWQ's interleave undone: the words
    read as 8 columns in natural order (column 8j + e at shift 4e)."""
    codes = tqm.unpack_cols(qw, 4) - \
        tqm.unpack_cols(qz, 4).repeat_interleave(gs, dim=0)
    return tqm._a8(x, codes, sc, gs)


@pytest.mark.parametrize("awq", [False, True])
@pytest.mark.parametrize("m", [72, 300, 1000])
def test_a8_gemm_controls_miss_the_tolerance(dev, awq, m):
    """Wrong plain versions must miss `_close`'s tolerance against K8 /
    K11: the zero rows shifted by one group and, for K11, AWQ's column
    interleave undone; so a decoder, layout or fold fault that gives
    plausible numbers cannot pass the checks above."""
    x, wrapper, _, plain, (qw, qz, sc) = _a8_gemm_call(
        dev, awq, m, 4096, 4096, seed=m)
    got = wrapper(x)
    bad = [plain(x, qz.roll(1, 0))]
    if awq:
        bad.append(_awq_natural_order_plain(x, qw, qz, sc, 128))
    good = plain(x)
    torch.cuda.synchronize()
    _close(got, good)
    for b in bad:
        assert _misses(got, b)


@pytest.mark.parametrize("awq", [False, True])
@pytest.mark.parametrize("m", [72, 300])
def test_a8_gemm_on_k9_rows_equals_the_wrapper(dev, awq, m):
    """K8 / K11 launched alone on K9's rows (what chip_smoke and the
    timing tool time) equals the wrapper's output; and on K9's rows as a
    view one byte past an aligned start (the consumers store x8 where
    TMA cannot) equals the aligned launch."""
    x, wrapper, launch, _, _ = _a8_gemm_call(dev, awq, m, 4096, 6144)
    x8, xs = tqm.quantize_activations_int8(x)
    assert torch.equal(launch(x8, xs), wrapper(x))
    buf = torch.empty(x8.numel() + 1, dtype=torch.int8, device=dev)
    shifted = buf[1:].view_as(x8)
    shifted.copy_(x8)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    assert torch.equal(launch(shifted, xs), launch(x8, xs))


# K7 (quant_stream_kernel), its four arms at Mistral-7B's projections,
# m 1-64 and groups of 32, 64 and 128.
_K7_ARMS = ("gptq", "gptq8", "gptq_a8", "awq", "awq_a8")


def _k7_call(arm, dev, m, K, N, gs, seed=0):
    """(kernel, plain) callables of x for one K7 arm and its inputs x; gs
    -1 is one group of K rows (GPTQ's group_size -1; AWQ, which has no
    such setting, takes gs K)."""
    if arm.startswith("awq"):
        gs = K if gs == -1 else gs
        x, qw, qz, sc = _awq_problem(dev, m, K, N, gs, seed=seed)
        fn = tqm.awq_matmul_a8 if arm == "awq_a8" else tqm.awq_matmul
        plain = tqm.awq_matmul_a8_plain if arm == "awq_a8" else \
            tqm.awq_matmul_plain
        kw = dict(group_size=gs)
    else:
        bits = 8 if arm == "gptq8" else 4
        x, qw, qz, sc = _gptq_problem(dev, m, K, N, bits=bits,
                                      gs=K if gs == -1 else gs, seed=seed)
        fn = tqm.gptq_matmul_a8 if arm == "gptq_a8" else tqm.gptq_matmul
        plain = tqm.gptq_matmul_a8_plain if arm == "gptq_a8" else \
            tqm.gptq_matmul_plain
        kw = dict(bits=bits, group_size=gs)
    return (x, lambda xx: fn(xx, qw, qz, sc, stream=True, **kw),
            lambda xx, zz=qz: plain(xx, qw, zz, sc, **kw), qz)


_K7_COUNTER = {
    "gptq": "GPTQ_MATMUL_STREAM_LAUNCHES",
    "gptq8": "GPTQ_MATMUL_STREAM_LAUNCHES",
    "gptq_a8": "GPTQ_MATMUL_STREAM_A8_LAUNCHES",
    "awq": "AWQ_MATMUL_STREAM_LAUNCHES",
    "awq_a8": "AWQ_MATMUL_STREAM_A8_LAUNCHES",
}


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("K,N", _PROJ)
@pytest.mark.parametrize("m", [1, 3, 8, 17, 33, 64])
@pytest.mark.parametrize("arm", _K7_ARMS)
def test_k7_matches_plain(dev, arm, m, K, N, gs):
    """K7's arms (GPTQ 4 and 8 bits a16, GPTQ a8, AWQ a16 and a8) against
    their plain versions within 2e-2 + 2e-2 |plain|, one launch each."""
    x, fn, plain, _ = _k7_call(arm, dev, m, K, N, gs)
    counter = getattr(tqm, _K7_COUNTER[arm])
    before = counter.count
    got = fn(x)
    want = plain(x)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    _close(got, want)


@pytest.mark.parametrize("gs", [-1, 2048])
@pytest.mark.parametrize("K,N", _PROJ)
@pytest.mark.parametrize("m", [1, 8, 17, 64])
@pytest.mark.parametrize("arm", _K7_ARMS)
def test_k7_serves_one_group_and_large_groups(dev, arm, m, K, N, gs):
    """K7 at one group of K rows (group_size -1) and at groups of 2048,
    where 32 rows of x over a group pass a block's 64 KB and splits start
    and end inside a group, against the plain version."""
    x, fn, plain, _ = _k7_call(arm, dev, m, K, N, gs, seed=11)
    counter = getattr(tqm, _K7_COUNTER[arm])
    before = counter.count
    got = fn(x)
    want = plain(x)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    _close(got, want)


@pytest.mark.parametrize("arm", _K7_ARMS)
@pytest.mark.parametrize("m,K,N,gs", [(8, 4096, 6144, 128),
                                      (33, 14336, 4096, 64),
                                      (5, 3200, 1024, 40)])
def test_k7_takes_views_of_x_and_odd_groups(dev, arm, m, K, N, gs):
    """K7 on x given as a view at a row offset and at an unaligned
    element offset, and at groups of 40 rows (a k32 step crossing
    groups), against the plain version on a copy."""
    x_all, fn, plain, _ = _k7_call(arm, dev, m + 8, K, N, gs, seed=3)
    for what, x in _views(x_all, m).items():
        assert x.is_contiguous() and x.data_ptr() != x_all.data_ptr(), what
        got = fn(x)
        want = plain(x.clone())
        torch.cuda.synchronize()
        _close(got, want)


@pytest.mark.parametrize("arm", _K7_ARMS)
@pytest.mark.parametrize("m", [1, 8, 64])
def test_k7_control_misses_the_tolerance(dev, arm, m):
    """A wrong plain version, the zero rows shifted by one group, must
    miss `_close`'s tolerance against K7, so a group-tracking or
    fragment-map fault that gives plausible numbers cannot pass."""
    x, fn, plain, qz = _k7_call(arm, dev, m, 4096, 4096, 128, seed=5)
    got = fn(x)
    good = plain(x)
    bad = plain(x, qz.roll(1, 0))
    torch.cuda.synchronize()
    _close(got, good)
    assert _misses(got, bad)


def test_gptq_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, qw, qz, sc = _gptq_problem(dev, 8, 1024, 256)
    with pytest.raises(TypeError):                   # f32 activations
        tqm.gptq_matmul(x.float(), qw, qz, sc, bits=4, group_size=128)
    with pytest.raises(ValueError):                  # N % 128
        tqm.gptq_matmul(x, qw[:, :200].contiguous(), qz[:, :25].contiguous(),
                        sc[:, :200].contiguous(), bits=4, group_size=128)
    with pytest.raises(ValueError):                  # 8-bit W4A8
        x8, qw8, qz8, sc8 = _gptq_problem(dev, 8, 1024, 256, bits=8)
        tqm.gptq_matmul_a8(x8, qw8, qz8, sc8, bits=8, group_size=128)
    with pytest.raises(ValueError):                  # streamed m > 64
        big = torch.zeros(65, 1024, dtype=torch.bfloat16, device=dev)
        tqm.gptq_matmul(big, qw, qz, sc, bits=4, group_size=128,
                        stream=True)
    with pytest.raises(ValueError, match="mixed devices"):
        tqm.gptq_matmul(x, qw.cpu(), qz, sc, bits=4, group_size=128)


def _awq_problem(dev, m, K, N, gs=128, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def bits32(*shape):
        return torch.empty(*shape, dtype=torch.int32, device=dev).random_(
            -2 ** 31, 2 ** 31, generator=g)
    scales = (torch.rand(K // gs, N, generator=g, device=dev) * 0.02 +
              0.002).to(torch.bfloat16)
    x = torch.randn(m, K, generator=g, device=dev).to(torch.bfloat16)
    return x, bits32(K, N // 8), bits32(K // gs, N // 8), scales


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("m,K,N,gs,stream", [
    (1, 4096, 6144, 128, True),
    (8, 14336, 4096, 128, True),
    (64, 4096, 28672, 128, True),
    (33, 2048, 1024, 256, True),
    (65, 4096, 4096, 128, False),
    (300, 2048, 2048, 256, False),
    (8, 1024, 1024, 128, False),
] + [(m, K, N, 128, False) for m in _GEMM_M for K, N in _PROJ] + [
    (200, 4096, 6144, 256, False),
    (1000, 4096, 4096, 1024, False),
    (130, 3200, 4096, 200, False),        # groups of 200: 64+64+64+8 rows
    (77, 2048, 1152, 128, False),         # a 128-column tail tile
])
def test_awq_matmul_kernels_match_plain(dev, m, K, N, gs, stream, a8):
    x, qw, qz, sc = _awq_problem(dev, m, K, N, gs)
    if a8:
        counter = tqm.AWQ_MATMUL_STREAM_A8_LAUNCHES if stream \
            else tqm.AWQ_MATMUL_A8_LAUNCHES
        fn, plain = tqm.awq_matmul_a8, tqm.awq_matmul_a8_plain
    else:
        counter = tqm.AWQ_MATMUL_STREAM_LAUNCHES if stream \
            else tqm.AWQ_MATMUL_LAUNCHES
        fn, plain = tqm.awq_matmul, tqm.awq_matmul_plain
    before = (counter.count, tqm.QUANT_GEMM_REDUCE_LAUNCHES.count)
    got = fn(x, qw, qz, sc, group_size=gs, stream=stream)
    want = plain(x, qw, qz, sc, group_size=gs)
    torch.cuda.synchronize()
    assert (counter.count, tqm.QUANT_GEMM_REDUCE_LAUNCHES.count) == \
        (before[0] + 1, before[1] + _reduces(m, K, N, gs, stream, dev, a8))
    _close(got, want)


def test_awq_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, qw, qz, sc = _awq_problem(dev, 8, 1024, 1024)
    with pytest.raises(TypeError):                   # f32 activations
        tqm.awq_matmul(x.float(), qw, qz, sc, group_size=128)
    with pytest.raises(ValueError):                  # K % group
        tqm.awq_matmul(x, qw, qz, sc, group_size=384)
    with pytest.raises(ValueError):                  # N % 128
        tqm.awq_matmul(x, qw[:, :20].contiguous(), qz[:, :20].contiguous(),
                       sc[:, :160].contiguous(), group_size=128)
    with pytest.raises(ValueError):                  # streamed m > 64
        big = torch.zeros(65, 1024, dtype=torch.bfloat16, device=dev)
        tqm.awq_matmul_a8(big, qw, qz, sc, group_size=128, stream=True)
    with pytest.raises(ValueError, match="mixed devices"):
        tqm.awq_matmul(x, qw.cpu(), qz, sc, group_size=128)


def _gguf_problem(dev, kind, m, K, N, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    G = {"q8": 32, "i8g": 16, "w8a8": 128}[kind]
    x = torch.randn(m, K, generator=g, device=dev).to(torch.bfloat16)
    qs = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    scales = (torch.rand(K // G, N, generator=g, device=dev) * 0.002 +
              1e-4).to(torch.bfloat16)
    return x, qs, scales


def _gguf_skinny_m(kind):
    """The rows up to which a GGUF wrapper runs quant_stream_kernel:
    `Q8_STREAM_M_MAX`, `I8G_STREAM_M_MAX` and `K15_STREAM_M_MAX`."""
    return {"q8": tqm.Q8_STREAM_M_MAX, "i8g": tqm.I8G_STREAM_M_MAX,
            "w8a8": tqm.K15_STREAM_M_MAX}[kind]


def _gguf_counter(kind, m):
    """The counter of the kernel a GGUF wrapper launches at m: the
    warpgroup-MMA kernels above the skinny kernel's rows, else the
    wrapper's own."""
    if m > _gguf_skinny_m(kind):
        return getattr(tqm, f"GGUF_{kind.upper()}_GEMM_LAUNCHES")
    return getattr(tqm, f"GGUF_{kind.upper()}_MATMUL_LAUNCHES")


def _gguf_reduces(kind, m, K, N, dev):
    """The split reduces one K13-K15 launch adds on its warpgroup-MMA
    kernel."""
    if m <= _gguf_skinny_m(kind):
        return 0
    unit, block_n = (128, 128) if kind == "w8a8" else (64, 256)
    return int(tqm.gemm_plan(m, K, N, unit, tqm.build.sm_count(dev),
                             block_n=block_n)[0] > 1)


@pytest.mark.parametrize("kind", ["q8", "i8g", "w8a8"])
@pytest.mark.parametrize("m,K,N", [
    (1, 4096, 6144), (8, 14336, 4096), (33, 512, 384), (64, 4096, 4096),
    (65, 256, 128), (300, 4096, 1024)] + [
    (m, K, N) for m in (3, 8, 16, 17, 32, 33, 64) for K, N in _PROJ] + [
    (m, K, N) for m in (65, 72, 128, 256, 512) for K, N in _PROJ] + [
    (200, 2048, 384), (129, 1024, 1152), (77, 14336, 4096)])
def test_gguf_matmul_kernels_match_plain(dev, kind, m, K, N):
    """Every tiling: up to `Q8_STREAM_M_MAX` / `I8G_STREAM_M_MAX` /
    `K15_STREAM_M_MAX` rows K13's, K14's and K15's quant_stream_kernel
    (8-16-row blocks, K split over 32-row units, K15's over its 128-row
    groups, by stream_plan);
    above, K13's and K14's quant_gemm_kernel (128 x 256 tiles; N 384 and
    1152 end on a 128-column half tile) and K15's w8a8_gemm_kernel, with
    their split plans; one launch counted each, and the split reduce
    where the plan splits."""
    if kind == "q8" or kind == "i8g":
        K = max(256, K // 256 * 256)
    x, qs, scales = _gguf_problem(dev, kind, m, K, N, seed=m + K)
    name = f"gguf_{kind}_matmul"
    counter = _gguf_counter(kind, m)
    before = (counter.count, tqm.QUANT_GEMM_REDUCE_LAUNCHES.count)
    got = getattr(tqm, name)(x, qs, scales)
    want = getattr(tqm, name + "_plain")(x, qs, scales)
    torch.cuda.synchronize()
    assert (counter.count, tqm.QUANT_GEMM_REDUCE_LAUNCHES.count) == \
        (before[0] + 1, before[1] + _gguf_reduces(kind, m, K, N, dev))
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    _close(got, want)


@pytest.mark.parametrize("kind", ["q8", "i8g", "w8a8"])
@pytest.mark.parametrize("m", [72, 300, 1000])
def test_gguf_gemm_controls_miss_the_tolerance(dev, kind, m):
    """A wrong plain version must miss `_close`'s tolerance against the
    m > 64 kernels: K15 and K13 with their scale rows shifted by one
    group, K14 reading d16 per 32 rows; so a layout or fold fault that
    gives plausible numbers cannot pass the checks above."""
    K, N = 4096, 4096
    x, qs, scales = _gguf_problem(dev, kind, m, K, N, seed=m)
    if kind == "q8":
        got = tqm.gguf_q8_matmul(x, qs, scales)
        good = tqm.gguf_q8_matmul_plain(x, qs, scales)
        bad = tqm.gguf_q8_matmul_plain(x, qs, scales.roll(1, 0))
    elif kind == "w8a8":
        got = tqm.gguf_w8a8_matmul(x, qs, scales)
        good = tqm.gguf_w8a8_matmul_plain(x, qs, scales)
        bad = tqm.gguf_w8a8_matmul_plain(x, qs, scales.roll(1, 0))
    else:
        got = tqm.gguf_i8g_matmul(x, qs, scales)
        good = tqm.gguf_i8g_matmul_plain(x, qs, scales)
        bad = tqm.gguf_q8_matmul_plain(x, qs, scales[:K // 32])
    torch.cuda.synchronize()
    _close(got, good)
    assert _misses(got, bad)


@pytest.mark.parametrize("kind", ["q8", "i8g"])
@pytest.mark.parametrize("m", [8, 24, 200])
def test_gguf_kernels_take_unaligned_rows(dev, kind, m):
    """x starting 2 bytes past a 16-byte boundary stages element by
    element (K14 at m <= 16: quant_stream_kernel's byte loads; above its
    consumers store x where TMA cannot) and gives the aligned copy's
    result."""
    x, qs, scales = _gguf_problem(dev, kind, m, 512, 256)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = buf[1:].view_as(x)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    name = f"gguf_{kind}_matmul"
    assert torch.equal(getattr(tqm, name)(shifted, qs, scales),
                       getattr(tqm, name)(x, qs, scales))


# K13 and K17 at decode: (wrapper, stream counter, gemm counter, the
# controls: K13's plain version with d shifted by one group and with d
# read per 16 rows (K14's map), K17's with its column scales rolled by
# one).
_BYTE_DECODE = {
    "q8": ("gguf_q8_matmul", "GGUF_Q8_MATMUL_LAUNCHES",
           "GGUF_Q8_GEMM_LAUNCHES",
           (("d shifted by one group",
             lambda x, qs, d: tqm.gguf_q8_matmul_plain(x, qs, d.roll(1, 0))),
            ("d read per 16 rows",
             lambda x, qs, d: tqm.gguf_i8g_matmul_plain(
                 x, qs, torch.cat([d, d]))))),
    "int8": ("int8_matmul", "INT8_MATMUL_LAUNCHES", "INT8_GEMM_LAUNCHES",
             (("column scales rolled by one",
               lambda x, w, s: tqm.int8_matmul_plain(x, w, s.roll(1, 0))),)),
}


def _byte_decode_problem(dev, kind, m, K, N, seed):
    if kind == "q8":
        return _gguf_problem(dev, "q8", m, K, N, seed=seed)
    return _packed4_problem(dev, "int8", m, K, N, seed=seed)


@pytest.mark.parametrize("route", ["default", "stream", "gemm"])
@pytest.mark.parametrize("K,N", _PROJ + ((512, 384),))
@pytest.mark.parametrize("m", [1, 8, 16, 17, 33, 64])
@pytest.mark.parametrize("kind", list(_BYTE_DECODE))
def test_k13_k17_decode_matches_plain(dev, kind, m, K, N, route):
    """K13 and K17 at decode on both routes: the wrapper's own choice
    (quant_stream_kernel<8, kQ8 / kInt8> up to `Q8_STREAM_M_MAX` /
    `INT8_STREAM_M_MAX` rows, quant_gemm_kernel<8, kQ8 / kInt8> from the
    next row), and each route
    pinned (`stream`), at Mistral-7B's projections (the stream plan
    splits K; the gemm splits at N 4096 and 6144, not at 28672) and a
    small shape. One launch on the route's counter, none on the other,
    the split reduce where the gemm's plan splits; the result within
    `_close` of the plain version, and every control misses it."""
    name, stream_c, gemm_c, controls = _BYTE_DECODE[kind]
    args = _byte_decode_problem(dev, kind, m, K, N, seed=m + K + N)
    stream = {"default": None, "stream": True, "gemm": False}[route]
    limit = tqm.Q8_STREAM_M_MAX if kind == "q8" else tqm.INT8_STREAM_M_MAX
    use_stream = m <= limit if stream is None else stream
    counters = [getattr(tqm, stream_c), getattr(tqm, gemm_c),
                tqm.QUANT_GEMM_REDUCE_LAUNCHES]
    before = [c.count for c in counters]
    got = getattr(tqm, name)(*args, stream=stream)
    want = getattr(tqm, name + "_plain")(*args)
    torch.cuda.synchronize()
    reduce = 0 if use_stream else int(tqm.gemm_plan(
        m, K, N, 64, tqm.build.sm_count(dev))[0] > 1)
    assert [c.count - b for c, b in zip(counters, before)] == \
        ([1, 0, 0] if use_stream else [0, 1, reduce])
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    _close(got, want)
    for what, control in controls:
        assert _misses(got, control(*args)), what


@pytest.mark.parametrize("kind", list(_BYTE_DECODE))
@pytest.mark.parametrize("m,K,N,splits", [
    (8, 512, 28672, 1), (16, 256, 28672, 1), (1, 256, 128, 8),
    (16, 4096, 4096, 6)])
def test_k13_k17_stream_split_and_unsplit(dev, kind, m, K, N, splits):
    """quant_stream_kernel<8, kQ8 / kInt8> where `stream_plan` gives one
    split (the epilogue writes bf16, K17 times its column scales there)
    and several (the split reduce adds the partials, K17's scales
    applied there), against the plain version."""
    sms = tqm.build.sm_count(dev)
    if tqm.stream_plan(m, K, N, 32, sms, 8, 2)[1] != splits:
        pytest.skip(f"the plan splits otherwise on {sms} SMs")
    args = _byte_decode_problem(dev, kind, m, K, N, seed=m + K)
    got = getattr(tqm, _BYTE_DECODE[kind][0])(*args, stream=True)
    want = getattr(tqm, _BYTE_DECODE[kind][0] + "_plain")(*args)
    torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.parametrize("m", [1, 8, 16, 17, 40])
@pytest.mark.parametrize("K", [4160, 320])
def test_k17_takes_k_of_a_half_stage(dev, m, K):
    """K17's wrapper takes K a multiple of 64 (its JAX gate 256): K % 128
    == 64 leaves the stream kernel's split a short last stage (two k32
    steps) and the gemm a 64-row chunk; both match the plain version."""
    for stream in (True, False):
        args = _packed4_problem(dev, "int8", m, K, 1024, seed=m + K)
        got = tqm.int8_matmul(*args, stream=stream)
        want = tqm.int8_matmul_plain(*args)
        torch.cuda.synchronize()
        _close(got, want)


@pytest.mark.parametrize("kind", list(_BYTE_DECODE))
@pytest.mark.parametrize("m,K,N", [(8, 4096, 6144), (16, 14336, 4096),
                                   (5, 1024, 1152)])
def test_k13_k17_stream_takes_views_of_x(dev, kind, m, K, N):
    """K13 and K17 on quant_stream_kernel on x given as a view at a row
    offset (the cp.async path) and at an unaligned element offset
    (element loads), against the plain version on a copy."""
    x_all, *w = _byte_decode_problem(dev, kind, m + 8, K, N, seed=m)
    name = _BYTE_DECODE[kind][0]
    for what, x in _views(x_all, m).items():
        assert x.is_contiguous() and x.data_ptr() != x_all.data_ptr(), what
        got = getattr(tqm, name)(x, *w, stream=True)
        want = getattr(tqm, name + "_plain")(x.clone(), *w)
        torch.cuda.synchronize()
        _close(got, want)


@pytest.mark.parametrize("kind", list(_BYTE_DECODE))
def test_k13_k17_stream_dequantizes_exactly(dev, kind):
    """With x of 16 identity rows, K13's and K17's stream kernels return
    rows of their W: K13 bf16(q * d) bit for bit as the plain version
    rounds it (zeros of either sign taken as one), for every int8 code
    and d of either sign over 2^-20 .. 2^1 and zero; K17
    bf16(float(q) * s) for s over 2^-20 .. 2^1 (its plan splits at N
    1152: the scales come in the split reduce)."""
    K, N = 1024, 1152
    g = torch.Generator(device=dev).manual_seed(1317)
    q = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    q[:256] = torch.arange(-128, 128, device=dev, dtype=torch.int8)[:, None]
    if kind == "q8":
        e = torch.randint(-20, 2, (K // 32, N), generator=g, device=dev)
        d = ((1 + torch.rand(K // 32, N, generator=g, device=dev)) *
             torch.exp2(e.float()) *
             torch.where(torch.rand(K // 32, N, generator=g, device=dev) <
                         0.5, -1.0, 1.0))
        d[torch.rand(K // 32, N, generator=g, device=dev) < 0.05] = 0
        d = d.to(torch.bfloat16)
        w = (q.float() * d.float().repeat_interleave(32, dim=0)).to(
            torch.bfloat16)
        args = (q, d)
    else:
        s = (1 + torch.rand(N, generator=g, device=dev)) * torch.exp2(
            torch.randint(-20, 2, (N,), generator=g, device=dev).float())
        w = (q.float() * s).to(torch.bfloat16)
        args = (q, s)
    fn = getattr(tqm, _BYTE_DECODE[kind][0])
    for r0 in range(0, K, 16):
        x = torch.zeros(16, K, dtype=torch.bfloat16, device=dev)
        x[torch.arange(16, device=dev), r0 + torch.arange(16, device=dev)] = 1
        got = fn(x, *args, stream=True)
        torch.cuda.synchronize()
        assert torch.equal((got + 0).view(torch.int16),
                           (w[r0:r0 + 16] + 0).view(torch.int16)), r0


@pytest.mark.parametrize("K,N", _PROJ)
@pytest.mark.parametrize("m", [8, 33])
def test_k14_decode_control_misses_the_tolerance(dev, m, K, N):
    """K14 at decode (m 8: quant_stream_kernel<8, kI8g>; m 33:
    quant_gemm_kernel<8, kI8g> on a part-filled 128-row tile) within the
    tolerance of its plain version, and a plain version reading d16 per
    32 rows misses it, so a d16 row fault that gives plausible numbers
    cannot pass `test_gguf_matmul_kernels_match_plain`."""
    x, qs, d16 = _gguf_problem(dev, "i8g", m, K, N, seed=m + N)
    got = tqm.gguf_i8g_matmul(x, qs, d16)
    good = tqm.gguf_i8g_matmul_plain(x, qs, d16)
    bad = tqm.gguf_q8_matmul_plain(x, qs, d16[:K // 32])
    torch.cuda.synchronize()
    _close(got, good)
    assert _misses(got, bad)


@pytest.mark.parametrize("m", [8, 72, 300])
def test_gguf_w8a8_kernel_on_k9_rows_equals_the_wrapper(dev, m):
    x, qs, scales = _gguf_problem(dev, "w8a8", m, 4096, 6144)
    x8, xs = tqm.quantize_activations_int8(x)
    assert torch.equal(tqm.gguf_w8a8_launch(x8, xs, qs, scales),
                       tqm.gguf_w8a8_matmul(x, qs, scales))
    # K9's rows as a view one byte past an aligned start: the consumers
    # store them where TMA cannot.
    buf = torch.empty(x8.numel() + 1, dtype=torch.int8, device=dev)
    shifted = buf[1:].view_as(x8)
    shifted.copy_(x8)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    assert torch.equal(tqm.gguf_w8a8_launch(shifted, xs, qs, scales),
                       tqm.gguf_w8a8_launch(x8, xs, qs, scales))


# K15 at decode: the rows pinned on each route; Mistral-7B's projections,
# a small shape, and K of 9 and 33 groups, whose splits end on a short run
# of groups.
_K15_M = (1, 8, 13, 16, 17, 32, 33, 64)
_K15_SHAPES = _PROJ + ((512, 384), (1152, 384), (4224, 1024))


@pytest.mark.parametrize("route", ["default", "stream", "gemm"])
@pytest.mark.parametrize("K,N", _K15_SHAPES)
@pytest.mark.parametrize("m", _K15_M)
def test_k15_decode_matches_plain_on_both_routes(dev, m, K, N, route):
    """K15 alone on K9's rows at decode on the wrapper's own route
    (quant_stream_kernel<8, kQs8> on its a8 arm up to `K15_STREAM_M_MAX`
    rows, w8a8_gemm_kernel from the next) and on each route pinned
    (`stream`), at Mistral-7B's projections (the stream plan splits K
    into runs of 128-row groups), K of 9 and 33 groups and a small shape:
    one launch on the route's counter, none on the other, the split
    reduce where the gemm's plan splits; within `_close` of the plain
    version, and the plain version with the scale rows shifted by one
    group misses it."""
    x, qs, s128 = _gguf_problem(dev, "w8a8", m, K, N, seed=m + K + N)
    x8, xs = tqm.quantize_activations_int8(x)
    stream = {"default": None, "stream": True, "gemm": False}[route]
    use_stream = m <= tqm.K15_STREAM_M_MAX if stream is None else stream
    counters = [tqm.GGUF_W8A8_MATMUL_LAUNCHES, tqm.GGUF_W8A8_GEMM_LAUNCHES,
                tqm.QUANT_GEMM_REDUCE_LAUNCHES]
    before = [c.count for c in counters]
    got = tqm.gguf_w8a8_launch(x8, xs, qs, s128, stream=stream)
    want = tqm.gguf_w8a8_launch_plain(x8, xs, qs, s128)
    bad = tqm.gguf_w8a8_launch_plain(x8, xs, qs, s128.roll(1, 0))
    torch.cuda.synchronize()
    reduce = 0 if use_stream else int(tqm.gemm_plan(
        m, K, N, 128, tqm.build.sm_count(dev), block_n=128)[0] > 1)
    assert [c.count - b for c, b in zip(counters, before)] == \
        ([1, 0, 0] if use_stream else [0, 1, reduce])
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    _close(got, want)
    assert _misses(got, bad)


@pytest.mark.parametrize("m,K,N,splits", [
    (8, 512, 28672, 1), (16, 1024, 28672, 1), (1, 256, 128, 2),
    (8, 4096, 4096, 11)])
def test_k15_stream_split_and_unsplit(dev, m, K, N, splits):
    """K15's stream route where `stream_plan` gives one split (the
    epilogue multiplies by xs and rounds) and several (the split reduce
    adds the f32 partials in split order, then xs): within `_close` of
    the plain version; unsplit, where the group order is the plain
    version's, equal to it bit for bit."""
    sms = tqm.build.sm_count(dev)
    if tqm.stream_plan(m, K, N, 128, sms, 8, 1)[1] != splits:
        pytest.skip(f"the plan splits otherwise on {sms} SMs")
    x, qs, s128 = _gguf_problem(dev, "w8a8", m, K, N, seed=m + K)
    x8, xs = tqm.quantize_activations_int8(x)
    got = tqm.gguf_w8a8_launch(x8, xs, qs, s128, stream=True)
    want = tqm.gguf_w8a8_launch_plain(x8, xs, qs, s128)
    torch.cuda.synchronize()
    _close(got, want)
    if splits == 1:
        assert torch.equal(got, want)


def test_k15_stream_refuses_more_than_64_rows(dev):
    x, qs, s128 = _gguf_problem(dev, "w8a8", 65, 512, 256)
    before = tqm.QUANTIZE_ACTIVATIONS_INT8_LAUNCHES.count
    with pytest.raises(ValueError, match="m <= 64"):
        tqm.gguf_w8a8_matmul(x, qs, s128, stream=True)
    assert tqm.QUANTIZE_ACTIVATIONS_INT8_LAUNCHES.count == before


def test_gguf_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, qs, scales = _gguf_problem(dev, "q8", 4, 512, 256)
    with pytest.raises(TypeError):
        tqm.gguf_q8_matmul(x.float(), qs, scales)
    with pytest.raises(ValueError):
        tqm.gguf_q8_matmul(x, qs[:, :200].contiguous(), scales[:, :200])
    with pytest.raises(ValueError):
        tqm.gguf_i8g_matmul(x, qs, scales)        # scales per 32 rows
    with pytest.raises(TypeError):
        tqm.gguf_w8a8_matmul(x, qs, scales.float()[:4])


def _packed4_problem(dev, kind, m, K, N, seed=0, f32=False):
    """x and 4-bit codes with K12's dl/ml rows, K16's codebook, or K17's
    int8 weight and f32 column scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xdt = torch.float32 if f32 else torch.bfloat16
    x = torch.randn(m, K, generator=g, device=dev).to(xdt)
    if kind == "int8":
        w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand(N, generator=g, device=dev) * 0.002 + 1e-4
        return x, w, s
    qw = torch.randint(-2 ** 31, 2 ** 31, (K // 8, N), generator=g,
                       device=dev, dtype=torch.int64).to(torch.int32)
    if kind == "q4k":
        dl = (torch.rand(K // 32, N, generator=g, device=dev) * 0.01 +
              1e-3).to(torch.bfloat16)
        ml = (torch.rand(K // 32, N, generator=g, device=dev) * 0.05).to(
            torch.bfloat16)
        return x, qw, dl, ml
    lut = (torch.randn(N, 16, generator=g, device=dev) * 0.02).to(xdt)
    return x, qw, lut


_PACKED4 = {"q4k": ("gguf_q4k_matmul", "GGUF_Q4K_MATMUL_LAUNCHES"),
            "lut": ("squeezellm_matmul", "SQUEEZELLM_MATMUL_LAUNCHES"),
            "lut32": ("squeezellm_matmul", "SQUEEZELLM_MATMUL_F32_LAUNCHES"),
            "int8": ("int8_matmul", "INT8_MATMUL_LAUNCHES")}
# The counters of K12's, K16's (bf16 x) and K17's m > 64 kernels.
_PACKED4_GEMM = {"q4k": "GGUF_Q4K_GEMM_LAUNCHES",
                 "lut": "SQUEEZELLM_GEMM_LAUNCHES",
                 "lut32": "SQUEEZELLM_F32_GEMM_LAUNCHES",
                 "int8": "INT8_GEMM_LAUNCHES"}


@pytest.mark.parametrize("kind", list(_PACKED4))
@pytest.mark.parametrize("m,K,N", [
    (1, 4096, 6144), (8, 14336, 4096), (33, 512, 384), (64, 4096, 4096),
    (65, 256, 128), (300, 4096, 1024)])
def test_k12_k16_k17_kernels_match_plain(dev, kind, m, K, N):
    """Every kernel: at m <= 64 (K17 up to `INT8_STREAM_M_MAX` rows)
    quant_stream_kernel (K12, K16 on bf16 and f32 x, K17; 8-64-row
    blocks, split K); above, quant_gemm_kernel; the wrappers count one
    launch each, on their own counter (K16's f32 arms and the
    quant_gemm_kernel launches have their own)."""
    K = max(256, K // 256 * 256)
    args = _packed4_problem(dev, "lut" if kind == "lut32" else kind, m, K,
                            N, seed=m + K, f32=kind == "lut32")
    name, counter_name = _PACKED4[kind]
    if m > (tqm.INT8_STREAM_M_MAX if kind == "int8" else tqm.STREAM_M_MAX):
        counter_name = _PACKED4_GEMM[kind]
    counter = getattr(tqm, counter_name)
    others = [getattr(tqm, c) for c in sorted(
        {c for _, c in _PACKED4.values()} | set(_PACKED4_GEMM.values()))
        if c != counter_name]
    before = counter.count, [c.count for c in others]
    got = getattr(tqm, name)(*args)
    want = getattr(tqm, name + "_plain")(*args)
    torch.cuda.synchronize()
    assert counter.count == before[0] + 1
    assert [c.count for c in others] == before[1]
    assert got.dtype == args[0].dtype and got.shape == (m, N)
    if kind == "lut32":
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    else:
        _close(got, want)


@pytest.mark.parametrize("kind", ["q4k", "lut", "lut32", "int8"])
def test_k12_k16_k17_kernels_take_unaligned_rows(dev, kind):
    """x starting past a 16-byte boundary stages element by element and
    gives the aligned copy's result."""
    args = _packed4_problem(dev, "lut" if kind == "lut32" else kind, 24,
                            512, 256, f32=kind == "lut32")
    x = args[0]
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = buf[1:].view_as(x)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    fn = getattr(tqm, _PACKED4[kind][0])
    assert torch.equal(fn(shifted, *args[1:]), fn(x, *args[1:]))


@pytest.mark.parametrize("m", [65, 72, 200, 300, 1000])
@pytest.mark.parametrize("K,N", _PROJ + ((2048, 384), (1024, 1152)))
def test_k12_gemm_matches_plain(dev, m, K, N):
    """K12 at m > 64 (quant_gemm_kernel<4, kQ4k>: 128 x 256 tiles, N 384
    and 1152 ending on a half tile) against its plain version, one launch
    and, where the plan splits, the split reduce counted; a control (dl
    and ml shifted by one 32-row group) must miss the tolerance."""
    x, qw, dl, ml = _packed4_problem(dev, "q4k", m, K, N, seed=m + K + N)
    before = (tqm.GGUF_Q4K_GEMM_LAUNCHES.count,
              tqm.GGUF_Q4K_MATMUL_LAUNCHES.count,
              tqm.QUANT_GEMM_REDUCE_LAUNCHES.count)
    got = tqm.gguf_q4k_matmul(x, qw, dl, ml)
    want = tqm.gguf_q4k_matmul_plain(x, qw, dl, ml)
    bad = tqm.gguf_q4k_matmul_plain(x, qw, dl.roll(1, 0), ml.roll(1, 0))
    torch.cuda.synchronize()
    splits, _ = tqm.gemm_plan(m, K, N, 64, tqm.build.sm_count(dev))
    assert (tqm.GGUF_Q4K_GEMM_LAUNCHES.count,
            tqm.GGUF_Q4K_MATMUL_LAUNCHES.count,
            tqm.QUANT_GEMM_REDUCE_LAUNCHES.count) == \
        (before[0] + 1, before[1], before[2] + int(splits > 1))
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    _close(got, want)
    assert _misses(got, bad)


@pytest.mark.parametrize("m,K,N", [(72, 4096, 4096), (300, 14336, 4096),
                                   (200, 1024, 1152)])
def test_k12_gemm_takes_views_of_x(dev, m, K, N):
    """K12 at m > 64 on x given as a view at a row offset (TMA loads it)
    and at an unaligned element offset (the consumers store it), against
    the plain version on a copy."""
    x_all, qw, dl, ml = _packed4_problem(dev, "q4k", m + 8, K, N, seed=m)
    for what, x in _views(x_all, m).items():
        assert x.is_contiguous() and x.data_ptr() != x_all.data_ptr(), what
        got = tqm.gguf_q4k_matmul(x, qw, dl, ml)
        want = tqm.gguf_q4k_matmul_plain(x.clone(), qw, dl, ml)
        torch.cuda.synchronize()
        _close(got, want)


@pytest.mark.parametrize("spread", ["narrow", "wide", "mixed"])
def test_k12_gemm_dequantizes_exactly(dev, spread):
    """With x rows of the identity (m 128, each row one 1), K12's m > 64
    kernel returns rows of its dequantized W tile: they equal the plain
    version's bf16 W bit for bit (zeros of either sign taken as one).
    dl and ml (either sign, some ml zero) span 2^-8 .. 2^-4 ("narrow"),
    2^-20 .. 2^0 ("wide": q * dl - ml often rounds in f32 before it
    rounds to bf16, where one bf16 rounding can differ), or the two in
    alternate 32-column runs ("mixed")."""
    K, N = 1024, 1152
    g = torch.Generator(device=dev).manual_seed(12)
    qw = torch.randint(-2 ** 31, 2 ** 31, (K // 8, N), generator=g,
                       device=dev, dtype=torch.int64).to(torch.int32)

    def spread_of(lo, hi, signed):
        e = torch.randint(lo, hi + 1, (K // 32, N), generator=g, device=dev)
        v = (1 + torch.rand(K // 32, N, generator=g, device=dev)) * \
            torch.exp2(e.float())
        if signed:
            v = v * torch.where(torch.rand(K // 32, N, generator=g,
                                           device=dev) < 0.5, -1.0, 1.0)
            v[torch.rand(K // 32, N, generator=g, device=dev) < 0.05] = 0
        return v.to(torch.bfloat16)
    narrow = spread_of(-8, -5, False), spread_of(-8, -5, True)
    wide = spread_of(-20, 0, False), spread_of(-20, 0, True)
    if spread == "mixed":
        run = (torch.arange(N, device=dev) // 32) % 2 == 0
        dl, ml = (torch.where(run, a, b) for a, b in zip(narrow, wide))
    else:
        dl, ml = narrow if spread == "narrow" else wide
    w = tqm.gguf_q4k_dequantize_plain(qw, dl, ml, torch.bfloat16)
    for r0 in range(0, K, 128):
        x = torch.zeros(128, K, dtype=torch.bfloat16, device=dev)
        x[torch.arange(128, device=dev), r0 + torch.arange(128, device=dev)] = 1
        got = tqm.gguf_q4k_matmul(x, qw, dl, ml)
        torch.cuda.synchronize()
        assert torch.equal((got + 0).view(torch.int16),
                           (w[r0:r0 + 128] + 0).view(torch.int16)), r0


def test_k13_gemm_dequantizes_exactly(dev):
    """With x rows of the identity (m 128), K13's m > 64 kernel returns
    rows of its dequantized W tile: bf16(q * d) bit for bit as the plain
    version rounds it (zeros of either sign taken as one), for every int8
    code and d of either sign over 2^-20 .. 2^1."""
    K, N = 1024, 1152
    g = torch.Generator(device=dev).manual_seed(13)
    qs = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                       dtype=torch.int8)
    e = torch.randint(-20, 2, (K // 32, N), generator=g, device=dev)
    d = ((1 + torch.rand(K // 32, N, generator=g, device=dev)) *
         torch.exp2(e.float()) *
         torch.where(torch.rand(K // 32, N, generator=g, device=dev) < 0.5,
                     -1.0, 1.0)).to(torch.bfloat16)
    w = (qs.float() * d.float().repeat_interleave(32, dim=0)).to(
        torch.bfloat16)
    for r0 in range(0, K, 128):
        x = torch.zeros(128, K, dtype=torch.bfloat16, device=dev)
        x[torch.arange(128, device=dev), r0 + torch.arange(128, device=dev)] = 1
        got = tqm.gguf_q8_matmul(x, qs, d)
        torch.cuda.synchronize()
        assert torch.equal((got + 0).view(torch.int16),
                           (w[r0:r0 + 128] + 0).view(torch.int16)), r0


# K16 on bf16 x and K17 at m > 64: (wrapper, counter attribute, the
# control: the plain version with the codebook's columns, or the column
# scales, rolled by one).
_K16_K17 = {
    "lut": ("squeezellm_matmul", "SQUEEZELLM_GEMM_LAUNCHES",
            lambda x, qw, lut: tqm.squeezellm_matmul_plain(
                x, qw, lut.roll(1, 0))),
    "int8": ("int8_matmul", "INT8_GEMM_LAUNCHES",
             lambda x, w, s: tqm.int8_matmul_plain(x, w, s.roll(1, 0))),
}


@pytest.mark.parametrize("kind", list(_K16_K17))
@pytest.mark.parametrize("m", [65, 72, 200, 300, 1000])
@pytest.mark.parametrize("K,N", _PROJ + ((2048, 384), (1024, 1152)))
def test_k16_k17_gemm_matches_plain(dev, kind, m, K, N):
    """K16 on bf16 x (quant_gemm_kernel<4, kLut>) and K17
    (quant_gemm_kernel<8, kInt8>) at m > 64, 128 x 256 tiles (N 384 and
    1152 end on a half tile, whose codebook rows past N the kernel must
    not read), against their plain versions; one launch on the m > 64
    counter and, where the plan splits, the split reduce (K17's column
    scales applied there); a control must miss the tolerance."""
    name, counter_name, control = _K16_K17[kind]
    args = _packed4_problem(dev, kind, m, K, N, seed=m + K + N)
    gemm, skinny = getattr(tqm, counter_name), getattr(tqm, _PACKED4[kind][1])
    before = (gemm.count, skinny.count, tqm.QUANT_GEMM_REDUCE_LAUNCHES.count)
    got = getattr(tqm, name)(*args)
    want = getattr(tqm, name + "_plain")(*args)
    bad = control(*args)
    torch.cuda.synchronize()
    splits, _ = tqm.gemm_plan(m, K, N, 64, tqm.build.sm_count(dev))
    assert (gemm.count, skinny.count,
            tqm.QUANT_GEMM_REDUCE_LAUNCHES.count) == \
        (before[0] + 1, before[1], before[2] + int(splits > 1))
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    _close(got, want)
    assert _misses(got, bad)


@pytest.mark.parametrize("kind", list(_K16_K17))
@pytest.mark.parametrize("m,K,N", [(72, 4096, 4096), (300, 14336, 4096),
                                   (200, 1024, 1152)])
def test_k16_k17_gemm_takes_views_of_x(dev, kind, m, K, N):
    """K16 on bf16 x and K17 at m > 64 on x given as a view at a row
    offset (TMA loads it) and at an unaligned element offset (the
    consumers store it), against the plain version on a copy."""
    name = _K16_K17[kind][0]
    x_all, *w = _packed4_problem(dev, kind, m + 8, K, N, seed=m)
    for what, x in _views(x_all, m).items():
        assert x.is_contiguous() and x.data_ptr() != x_all.data_ptr(), what
        got = getattr(tqm, name)(x, *w)
        want = getattr(tqm, name + "_plain")(x.clone(), *w)
        torch.cuda.synchronize()
        _close(got, want)


def _identity_rows(dev, K, r0):
    """x [128, K] bf16 with x[i, r0 + i] = 1 and zeros elsewhere."""
    x = torch.zeros(128, K, dtype=torch.bfloat16, device=dev)
    x[torch.arange(128, device=dev), r0 + torch.arange(128, device=dev)] = 1
    return x


def test_k16_gemm_dequantizes_exactly(dev):
    """With x rows of the identity (m 128), K16's m > 64 kernel returns
    rows of its W tile: the codebook entries lut[n, q] bit for bit, as the
    plain version's bf16 W holds them (zeros of either sign taken as one),
    for codebook entries of either sign over 2^-30 .. 2^10 and a half
    tile (N 1152)."""
    K, N = 1024, 1152
    g = torch.Generator(device=dev).manual_seed(16)
    qw = torch.randint(-2 ** 31, 2 ** 31, (K // 8, N), generator=g,
                       device=dev, dtype=torch.int64).to(torch.int32)
    e = torch.randint(-30, 11, (N, 16), generator=g, device=dev)
    lut = ((1 + torch.rand(N, 16, generator=g, device=dev)) *
           torch.exp2(e.float()) *
           torch.where(torch.rand(N, 16, generator=g, device=dev) < 0.5,
                       -1.0, 1.0)).to(torch.bfloat16)
    lut[torch.rand(N, 16, generator=g, device=dev) < 0.05] = 0
    w = tqm.squeezellm_dequantize_plain(qw, lut, torch.bfloat16)
    for r0 in range(0, K, 128):
        got = tqm.squeezellm_matmul(_identity_rows(dev, K, r0), qw, lut)
        torch.cuda.synchronize()
        assert torch.equal((got + 0).view(torch.int16),
                           (w[r0:r0 + 128] + 0).view(torch.int16)), r0


def test_k17_gemm_dequantizes_exactly(dev):
    """With x rows of the identity (m 128), K17's m > 64 kernel returns
    bf16(float(q) * s) bit for bit for every int8 code (the plan splits
    here: the scales come in the split reduce), s over 2^-20 .. 2^1."""
    K, N = 1024, 1152
    g = torch.Generator(device=dev).manual_seed(17)
    q = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    q[:256] = torch.arange(-128, 128, device=dev, dtype=torch.int8)[:, None]
    s = (1 + torch.rand(N, generator=g, device=dev)) * torch.exp2(
        torch.randint(-20, 2, (N,), generator=g, device=dev).float())
    assert tqm.gemm_plan(128, K, N, 64, tqm.build.sm_count(dev))[0] > 1
    w = (q.float() * s).to(torch.bfloat16)
    for r0 in range(0, K, 128):
        got = tqm.int8_matmul(_identity_rows(dev, K, r0), q, s)
        torch.cuda.synchronize()
        assert torch.equal((got + 0).view(torch.int16),
                           (w[r0:r0 + 128] + 0).view(torch.int16)), r0


# K12 and K16 at m <= 64 (quant_stream_kernel<4, kQ4k / kLut / kLutX32):
# (counter, the control: the plain version with K12's dl and ml rows
# shifted by one 32-row group, or K16's codebook columns rolled by one).
_STREAMED = {
    "q4k": ("GGUF_Q4K_MATMUL_LAUNCHES",
            lambda x, qw, dl, ml: tqm.gguf_q4k_matmul_plain(
                x, qw, dl.roll(1, 0), ml.roll(1, 0))),
    "lut": ("SQUEEZELLM_MATMUL_LAUNCHES",
            lambda x, qw, lut: tqm.squeezellm_matmul_plain(
                x, qw, lut.roll(1, 0))),
    "lut32": ("SQUEEZELLM_MATMUL_F32_LAUNCHES",
              lambda x, qw, lut: tqm.squeezellm_matmul_plain(
                  x, qw, lut.roll(1, 0))),
}


def _close_f32(got, want):
    """K16 on f32 x: finite, within 1e-4 of max |plain|."""
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


def _misses_f32(got, want):
    return (got - want).abs().max().item() > 1e-4 * want.abs().max().item()


def _streamed_call(dev, kind, m, K, N, seed):
    args = _packed4_problem(dev, "lut" if kind == "lut32" else kind, m, K,
                            N, seed=seed, f32=kind == "lut32")
    name = "gguf_q4k_matmul" if kind == "q4k" else "squeezellm_matmul"
    return args, getattr(tqm, name), getattr(tqm, name + "_plain")


@pytest.mark.parametrize("K,N", _PROJ)
@pytest.mark.parametrize("m", [1, 3, 8, 17, 33, 64])
@pytest.mark.parametrize("kind", list(_STREAMED))
def test_k12_k16_stream_matches_plain(dev, kind, m, K, N):
    """K12 and K16 (bf16 and f32 x) at m <= 64 on quant_stream_kernel at
    Mistral-7B's projections: one launch on the skinny counter, the plan
    splitting K over runs of 32-row units (which start and end inside
    K12's 32-row dl/ml groups' runs and across K16's codebook rows), the
    result within the tolerance and a control missing it."""
    counter_name, control = _STREAMED[kind]
    args, fn, plain = _streamed_call(dev, kind, m, K, N, seed=m + K + N)
    counter = getattr(tqm, counter_name)
    before = counter.count
    got = fn(*args)
    want = plain(*args)
    bad = control(*args)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    x_bytes = 4 if kind == "lut32" else 2
    assert tqm.stream_plan(m, K, N, 32, tqm.build.sm_count(dev), 4,
                           x_bytes)[1] > 1
    if kind == "lut32":
        _close_f32(got, want)
        assert _misses_f32(got, bad)
    else:
        _close(got, want)
        assert _misses(got, bad)


@pytest.mark.parametrize("kind", list(_STREAMED))
@pytest.mark.parametrize("m,K,N", [(8, 4096, 6144), (33, 14336, 4096),
                                   (5, 1024, 1152)])
def test_k12_k16_stream_takes_views_of_x(dev, kind, m, K, N):
    """K12 and K16 at m <= 64 on x given as a view at a row offset (the
    cp.async path; f32 x 16-byte loads) and at an unaligned element
    offset (element loads), against the plain version on a copy."""
    args, fn, plain = _streamed_call(dev, kind, m + 8, K, N, seed=m)
    x_all, w = args[0], args[1:]
    for what, x in _views(x_all, m).items():
        assert x.is_contiguous() and x.data_ptr() != x_all.data_ptr(), what
        got = fn(x, *w)
        want = plain(x.clone(), *w)
        torch.cuda.synchronize()
        if kind == "lut32":
            _close_f32(got, want)
        else:
            _close(got, want)


@pytest.mark.parametrize("m", [65, 72, 200, 300, 1000])
@pytest.mark.parametrize("K,N", _PROJ + ((2048, 384), (1024, 1152)))
def test_k16_f32_gemm_matches_plain(dev, m, K, N):
    """K16 on f32 x at m > 64 (split_x32_kernel, then
    quant_gemm_kernel<4, kLutX32> on 128 x 128 tiles) against its plain
    version within 1e-4 of max |plain|; one launch on its m > 64 counter
    and, where the plan splits, the split reduce; the control (codebook
    columns rolled by one) must miss."""
    x, qw, lut = _packed4_problem(dev, "lut", m, K, N, seed=m + K + N,
                                  f32=True)
    gemm, skinny = tqm.SQUEEZELLM_F32_GEMM_LAUNCHES, \
        tqm.SQUEEZELLM_MATMUL_F32_LAUNCHES
    before = (gemm.count, skinny.count, tqm.QUANT_GEMM_REDUCE_LAUNCHES.count)
    got = tqm.squeezellm_matmul(x, qw, lut)
    want = tqm.squeezellm_matmul_plain(x, qw, lut)
    bad = tqm.squeezellm_matmul_plain(x, qw, lut.roll(1, 0))
    torch.cuda.synchronize()
    splits, _ = tqm.gemm_plan(m, K, N, 64, tqm.build.sm_count(dev),
                              block_n=tqm.X32_BLOCK_N)
    assert (gemm.count, skinny.count,
            tqm.QUANT_GEMM_REDUCE_LAUNCHES.count) == \
        (before[0] + 1, before[1], before[2] + int(splits > 1))
    assert got.shape == (m, N)
    _close_f32(got, want)
    assert _misses_f32(got, bad)


@pytest.mark.parametrize("m,K,N", [(72, 4096, 4096), (300, 14336, 4096),
                                   (200, 1024, 1152)])
def test_k16_f32_gemm_takes_views_of_x(dev, m, K, N):
    """K16 on f32 x at m > 64 on x given as a view at a row offset (the
    split pass's 16-byte loads) and at an unaligned element offset (its
    element loads), against the plain version on a copy."""
    x_all, qw, lut = _packed4_problem(dev, "lut", m + 8, K, N, seed=m,
                                      f32=True)
    for what, x in _views(x_all, m).items():
        assert x.is_contiguous() and x.data_ptr() != x_all.data_ptr(), what
        got = tqm.squeezellm_matmul(x, qw, lut)
        want = tqm.squeezellm_matmul_plain(x.clone(), qw, lut)
        torch.cuda.synchronize()
        _close_f32(got, want)


def test_k16_f32_gemm_dequantizes_exactly(dev):
    """With f32 x rows of the identity (m 128), K16's m > 64 kernel on f32
    x returns rows of its W tiles: bf16 hi + lo of each f32 codebook entry
    (hi = bf16(w), lo = bf16(w - hi)) bit for bit, for entries of either
    sign over 2^-30 .. 2^10 (the plan splits: the f32 reduce adds zeros to
    each)."""
    K, N = 1024, 1152
    g = torch.Generator(device=dev).manual_seed(1632)
    qw = torch.randint(-2 ** 31, 2 ** 31, (K // 8, N), generator=g,
                       device=dev, dtype=torch.int64).to(torch.int32)
    e = torch.randint(-30, 11, (N, 16), generator=g, device=dev)
    lut = (1 + torch.rand(N, 16, generator=g, device=dev)) * \
        torch.exp2(e.float()) * \
        torch.where(torch.rand(N, 16, generator=g, device=dev) < 0.5,
                    -1.0, 1.0)
    lut[torch.rand(N, 16, generator=g, device=dev) < 0.05] = 0
    hi = lut.to(torch.bfloat16).float()
    lo = (lut - hi).to(torch.bfloat16).float()
    w = tqm.squeezellm_dequantize_plain(qw, hi + lo, torch.float32)
    assert tqm.gemm_plan(128, K, N, 64, tqm.build.sm_count(dev),
                         block_n=tqm.X32_BLOCK_N)[0] > 1
    for r0 in range(0, K, 128):
        got = tqm.squeezellm_matmul(_identity_rows(dev, K, r0).float(), qw,
                                    lut)
        torch.cuda.synchronize()
        assert torch.equal(got + 0, w[r0:r0 + 128] + 0), r0


def test_k12_k16_k17_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, qw, dl, ml = _packed4_problem(dev, "q4k", 4, 512, 256)
    with pytest.raises(TypeError):
        tqm.gguf_q4k_matmul(x.float(), qw, dl, ml)
    with pytest.raises(ValueError):                   # dl per 16 rows
        tqm.gguf_q4k_matmul(x, qw, torch.cat([dl, dl]), ml)
    with pytest.raises(ValueError):                   # N % 128
        tqm.gguf_q4k_matmul(x, qw[:, :200].contiguous(),
                            dl[:, :200].contiguous(),
                            ml[:, :200].contiguous())
    _, qw, lut = _packed4_problem(dev, "lut", 4, 512, 256)
    with pytest.raises(ValueError):                   # lut not in x's dtype
        tqm.squeezellm_matmul(x, qw, lut.float())
    with pytest.raises(ValueError):                   # K % 64
        tqm.squeezellm_matmul(x[:, :480].contiguous(), qw[:60].contiguous(),
                              lut)
    _, w, s = _packed4_problem(dev, "int8", 4, 512, 256)
    with pytest.raises(ValueError):                   # bf16 scales
        tqm.int8_matmul(x, w, s.to(torch.bfloat16))
    with pytest.raises(ValueError, match="mixed devices"):
        tqm.int8_matmul(x, w.cpu(), s)


def test_threefry_draws_on_the_card_equal_the_cpu(dev):
    g = torch.Generator().manual_seed(3)
    bases = torch.randint(-2 ** 40, 2 ** 40, (64,), generator=g)
    salt1 = torch.randint(0, 2 ** 31 - 1, (64,), generator=g)
    salt2 = torch.randint(0, 4, (64,), generator=g)
    logits = torch.randn(64, 32000, generator=g) * 3
    keys = prng.row_keys(bases, salt1, salt2)
    keys_d = prng.row_keys(bases.to(dev), salt1.to(dev), salt2.to(dev))
    assert torch.equal(keys_d.cpu(), keys)
    assert torch.equal(prng.random_bits(keys_d, (2, 32000)).cpu(),
                       prng.random_bits(keys, (2, 32000)))
    assert torch.equal(prng.uniform(keys_d, (2, 32000)).cpu(),
                       prng.uniform(keys, (2, 32000)))
    assert torch.equal(prng.categorical(keys_d, logits.to(dev), 2).cpu(),
                       prng.categorical(keys, logits, 2))


# ------------------------------------------------------------- LoRA --

def test_lora_delta_on_the_card_matches_f64(dev):
    """The LoRA delta (`LoRALinearMethod` over a dense base: x @ A_cat^T,
    the slot mask, one addmm of B_cat; torch calls, no hand kernel) at
    Mistral-7B's four wrapped projections (qkv rank 3r, gate_up 2r),
    max_loras 4, rank 16, batches 1, 8 and 64, rows cycling through
    slots -1, 0, 1, 2 and 3, against an f64 CPU reference of base +
    (x @ A_s) @ B_s on the same bf16 values. Tolerance: 2e-2 + 2e-2
    |ref| (bf16 operands, f32 sums, x @ A rounded to bf16 once, the
    output rounded to bf16). Rows with slot -1 equal the base F.linear
    bit for bit."""
    import torch.nn.functional as F
    from aphrodite_tpu_torch.lora.layers import (LORA_A, LORA_B, LORA_IDX,
                                                 LoRALinearMethod)
    from aphrodite_tpu_torch.modeling.layers.linear import LinearMethod
    slots, rank = 4, 16
    method = LoRALinearMethod(LinearMethod(), slots, rank)
    g = torch.Generator(device=dev).manual_seed(23)
    for fan_in, fan_out, packed in ((4096, 6144, 3), (4096, 4096, 1),
                                    (4096, 28672, 2), (14336, 4096, 1)):
        r = rank * packed

        def randn(*shape, std=1.0):
            return (torch.randn(*shape, generator=g, device=dev) *
                    std).to(torch.bfloat16)
        w = randn(fan_out, fan_in, std=0.02)
        a = randn(slots * r, fan_in, std=0.02)
        b = randn(fan_out, slots * r, std=0.02)
        for m in (1, 8, 64):
            idx = torch.tensor([(i % 5) - 1 for i in range(m)],
                               dtype=torch.int32, device=dev)
            x = randn(m, 1, fan_in)
            got = method.apply({"weight": w, LORA_A: a, LORA_B: b,
                                LORA_IDX: idx}, x)
            torch.cuda.synchronize()
            x64, w64 = x.double().cpu()[:, 0], w.double().cpu()
            a64, b64 = a.double().cpu(), b.double().cpu()
            want = x64 @ w64.T
            for i, s in enumerate(idx.tolist()):
                if s >= 0:
                    rows = slice(s * r, (s + 1) * r)
                    want[i] += (x64[i] @ a64[rows].T) @ b64[:, rows].T
            err = (got.double().cpu()[:, 0] - want).abs()
            assert (err <= 2e-2 + 2e-2 * want.abs()).all(), \
                (fan_in, fan_out, m, err.max().item())
            base_rows = (idx < 0).nonzero()[:, 0]
            assert torch.equal(got[base_rows], F.linear(x, w)[base_rows])


# ---- DeepSeek-MoE-16B's attention (group 1) and the MoE FFN ----

@pytest.mark.parametrize("page_dtype", [torch.bfloat16, torch.int8,
                                        torch.float8_e5m2])
@pytest.mark.parametrize("splits", [1, 2, None],
                         ids=["1split", "2splits", "policy"])
def test_k1_at_group_one_matches_plain(dev, page_dtype, splits):
    """K1 at DeepSeek-MoE-16B's multi-head geometry, 16 query heads over
    16 KV heads of 128 (one live column of its 8-wide n-tile), on the
    ragged grid with the fused write: within the attention tolerance of
    the plain version at the same split count; fused-write codes
    exact."""
    ctxs = [1, 0, 17, 100, 1000, 2047, 33, 512]
    q, kp, vp, tb, ctx, kn, vn = _decode_problem(
        dev, ctxs, page_dtype=page_dtype, seed=5, hq=16, hkv=16)
    ppc = tpa.choose_pages_per_chunk(tb.shape[1], 32, len(ctxs))
    work = tpa.build_decode_work_list([-(-c // 32) for c in ctxs], ppc)
    n_split = splits or tpa.choose_decode_splits(
        len(ctxs), 16, tb.shape[1], ppc, tpa.sm_count(dev))
    kw = dict(scale=128 ** -0.5, pages_per_chunk=ppc,
              kv_scale=tkq.dequant_scale(page_dtype, KV_SCALE))
    kp2, vp2 = kp.clone(), vp.clone()
    before = tpa.PAGED_DECODE_ATTENTION_LAUNCHES.count
    got, _, _ = tpa.paged_decode_attention(q, kp, vp, tb, ctx, None, kn, vn,
                                           work_items=work,
                                           num_splits=splits, **kw)
    want, _, _ = tpa.paged_decode_attention_plain(q, kp2, vp2, tb, ctx, None,
                                                  kn, vn, num_splits=n_split,
                                                  **kw)
    torch.cuda.synchronize()
    assert tpa.PAGED_DECODE_ATTENTION_LAUNCHES.count == before + 1
    assert torch.equal(_bytes(kp), _bytes(kp2))
    assert torch.equal(_bytes(vp), _bytes(vp2))
    assert (got[1] == 0).all()                     # ctx 0 row
    _close(got, want)


@pytest.mark.parametrize("page_dtype", [torch.bfloat16, torch.int8,
                                        torch.float8_e5m2])
def test_writers_at_sixteen_kv_heads_are_exact(dev, page_dtype):
    """K2 (bf16 pages: 8-bit prompts take the slot scatter) and K4 with
    shared pages and padding slots at 16 KV heads of 128 (2048-value
    rows): bit for bit their plain versions."""
    g = torch.Generator(device=dev).manual_seed(16)
    hd, num_pages, ps = 16 * 128, 64, 32
    base = torch.randn(num_pages, ps, hd, generator=g, device=dev)
    kp = tkq.quantize_kv(base, page_dtype, KV_SCALE)
    knew = torch.randn(96, hd, generator=g, device=dev).to(torch.bfloat16)
    slots = torch.randperm(num_pages * ps, generator=g, device=dev)[:96].to(
        torch.int32)
    slots[::5] = num_pages * ps
    before = tkw.WRITE_KV_PAGES_LAUNCHES.count
    a = tkw.write_kv_pages(knew, knew.flip(0), kp.clone(), kp.clone(), slots,
                           kv_scale=KV_SCALE)
    b = tkw.write_kv_pages_plain(knew, knew.flip(0), kp.clone(), kp.clone(),
                                 slots, KV_SCALE)
    torch.cuda.synchronize()
    assert tkw.WRITE_KV_PAGES_LAUNCHES.count == before + 1
    assert torch.equal(_bytes(a[0]), _bytes(b[0]))
    assert torch.equal(_bytes(a[1]), _bytes(b[1]))
    if page_dtype != torch.bfloat16:
        return
    pid = torch.tensor([3, num_pages, 5, 9], dtype=torch.int32, device=dev)
    vld = torch.tensor([ps, ps, 7, 1], dtype=torch.int32, device=dev)
    rows = torch.randn(4 * ps, hd, generator=g, device=dev).to(torch.bfloat16)
    c = tkw.write_kv_pages_prefill(rows, rows.flip(0), kp.clone(), kp.clone(),
                                   pid, np.arange(4, dtype=np.int32), vld)
    d = tkw.write_kv_pages_prefill_plain(rows, rows.flip(0), kp.clone(),
                                         kp.clone(), pid, vld)
    torch.cuda.synchronize()
    assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])


@pytest.mark.parametrize("e,k,h,inter,renorm", [
    (64, 6, 2048, 1408, False),       # DeepSeek-MoE-16B's routed experts
    (8, 2, 4096, 14336, True)],       # Mixtral-8x7B's
    ids=["deepseek", "mixtral"])
@pytest.mark.parametrize("t", [8, 256])
def test_moe_ffn_on_the_card_matches_f64(dev, e, k, h, inter, renorm, t):
    """The grouped MoE FFN in bf16 on the card against an f64 evaluation
    of the same weights on the same picks (its own f32 routing: an f64
    route could flip a near tie): within 2e-2 + 2e-2 |f64| (bf16
    products rounded to bf16 at gate, up, act and down). One host read a
    call. The control, the experts rolled by one, misses."""
    import torch.nn.functional as F
    from aphrodite_tpu_torch.modeling.layers import fused_moe
    g = torch.Generator(device=dev).manual_seed(e + t)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(
            torch.bfloat16)
    params = {"gate": randn(e, h, std=h ** -0.5 * 3),
              "w_gate": randn(e, inter, h, std=h ** -0.5),
              "w_up": randn(e, inter, h, std=h ** -0.5),
              "w_down": randn(e, h, inter, std=inter ** -0.5)}
    x = randn(t, h)
    moe = fused_moe.FusedMoE(e, k, h, inter, renormalize=renorm,
                             dtype=torch.bfloat16)
    reads = fused_moe.HOST_READS.count
    got = moe(params, x)
    torch.cuda.synchronize()
    assert fused_moe.HOST_READS.count == reads + 1
    _, vals, idx = fused_moe.route(x, params["gate"], k, renorm)

    def f64(p):
        want = torch.zeros(t, h, dtype=torch.float64, device=dev)
        x64 = x.double()
        for ex in range(e):
            tok, slot = (idx == ex).nonzero(as_tuple=True)
            if not tok.numel():
                continue
            xs = x64[tok]
            act = F.silu(xs @ p["w_gate"][ex].double().T) * \
                (xs @ p["w_up"][ex].double().T)
            want.index_add_(0, tok, (act @ p["w_down"][ex].double().T) *
                            vals[tok, slot].double()[:, None])
        return want
    want = f64(params)
    err = (got.double() - want).abs()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert bool((err <= 2e-2 + 2e-2 * want.abs()).all()), err.max().item()
    rolled = {n: t_.roll(1, 0) if n != "gate" else t_
              for n, t_ in params.items()}
    bad = f64(rolled)
    assert bool(((got.double() - bad).abs() >
                 2e-2 + 2e-2 * bad.abs()).any())


# ---- the other architectures' geometries (Qwen2, Phi, NeoX, GPT-J,
# DeciLM) ----

# (Hq, Hkv, head_dim): Qwen2-7B's group 7, DeciLM's groups 16 and 32,
# Phi-2's head_dim 80, GPT-NeoX-20B's 96 and GPT-J-6B's 256.
ARCH_GEOMETRIES = [(28, 4, 128), (32, 2, 128), (32, 1, 128), (32, 32, 80),
                   (64, 64, 96), (16, 16, 256)]


def _attention_f64(q, kp, vp, tables, ctx, scale, kv_scale, alibi=None):
    """Decode attention in f64: q x scale x kv_scale x log2(e) rounded to
    the kernels' dot operand (bf16, the Pallas bodies' rounding; fp16
    under fp16 activations: `tpa.dot_operand_dtype`), ALiBi's slope x
    position where given, each
    sequence's first ctx tokens of K and V as stored, the base-2 softmax
    and the sums in f64, times kv_scale."""
    b, hq, d = q.shape
    _, ps, hd = kp.shape
    hkv = hd // d
    qs = (q.float() * (scale * kv_scale * 1.4426950408889634)).to(
        tpa.dot_operand_dtype(q.dtype, kp.dtype)).double()
    out = torch.zeros(b, hq, d, dtype=torch.float64, device=q.device)
    for i in range(b):
        n = int(ctx[i])
        if n == 0:
            continue
        pages = tables[i, :-(-n // ps)].long()
        k = kp[pages].double().reshape(-1, hkv, d)[:n]
        v = vp[pages].double().reshape(-1, hkv, d)[:n]
        k = k.repeat_interleave(hq // hkv, 1)      # [n, hq, d]
        v = v.repeat_interleave(hq // hkv, 1)
        s2 = torch.einsum("hd,nhd->hn", qs[i], k)
        if alibi is not None:
            s2 = s2 + alibi.double()[:, None] * 1.4426950408889634 * \
                torch.arange(n, device=q.device, dtype=torch.float64)
        p = torch.softmax(s2 * 0.6931471805599453, dim=-1)
        out[i] = torch.einsum("hn,nhd->hd", p, v) * kv_scale
    return out


@pytest.mark.parametrize("page_dtype", [torch.bfloat16, torch.int8,
                                        torch.float8_e5m2])
@pytest.mark.parametrize("hq,hkv,d", ARCH_GEOMETRIES,
                         ids=["group7", "group16", "group32", "d80", "d96",
                              "d256"])
def test_k1_at_the_other_architectures_matches_f64(dev, hq, hkv, d,
                                                   page_dtype):
    """K1 on the ragged grid with the fused write at each geometry, its
    policy's split count (16-row blocks past group 16): within 2e-2 +
    2e-2 |f64| of an f64 evaluation on the same pages (the fused rows
    included); the fused-write codes equal the plain version's, and the
    plain version stays within the attention tolerance too."""
    ctxs = [1, 0, 17, 100, 1000, 2047, 33, 512]
    q, kp, vp, tb, ctx, kn, vn = _decode_problem(
        dev, ctxs, page_dtype=page_dtype, seed=7, d=d, hq=hq, hkv=hkv)
    ppc = tpa.choose_pages_per_chunk(tb.shape[1], 32, len(ctxs))
    work = tpa.build_decode_work_list([-(-c // 32) for c in ctxs], ppc)
    n_split = tpa.choose_decode_splits(
        len(ctxs), hkv * tpa.row_blocks(hq // hkv), tb.shape[1], ppc,
        tpa.sm_count(dev))
    kv_scale = tkq.dequant_scale(page_dtype, KV_SCALE)
    kw = dict(scale=d ** -0.5, pages_per_chunk=ppc, kv_scale=kv_scale)
    kp2, vp2 = kp.clone(), vp.clone()
    before = tpa.PAGED_DECODE_ATTENTION_LAUNCHES.count
    got, _, _ = tpa.paged_decode_attention(q, kp, vp, tb, ctx, None, kn, vn,
                                           work_items=work, **kw)
    want, _, _ = tpa.paged_decode_attention_plain(q, kp2, vp2, tb, ctx, None,
                                                  kn, vn, num_splits=n_split,
                                                  **kw)
    torch.cuda.synchronize()
    assert tpa.PAGED_DECODE_ATTENTION_LAUNCHES.count == before + 1
    assert torch.equal(_bytes(kp), _bytes(kp2))
    assert torch.equal(_bytes(vp), _bytes(vp2))
    assert (got[1] == 0).all()                     # ctx 0 row
    _close(got, want)
    ref = _attention_f64(q, kp, vp, tb, ctx, d ** -0.5, kv_scale)
    err = (got.double() - ref).abs()
    assert bool((err <= 2e-2 + 2e-2 * ref.abs()).all()), err.max().item()


def test_k1_group_32_row_block_control_misses(dev):
    """At one KV head of 32 query rows (two 16-row blocks), the plain
    version on the query with its rows rolled by 16 (each row block
    given the other's rows) misses the tolerance K1 meets."""
    ctxs = [2047] * 8
    q, kp, vp, tb, ctx, _, _ = _decode_problem(dev, ctxs, seed=9, hq=32,
                                               hkv=1)
    ppc = tpa.choose_pages_per_chunk(tb.shape[1], 32, len(ctxs))
    work = tpa.build_decode_work_list([64] * 8, ppc)
    n_split = tpa.choose_decode_splits(8, 2, tb.shape[1], ppc,
                                       tpa.sm_count(dev))
    kw = dict(scale=128 ** -0.5, pages_per_chunk=ppc)
    got = tpa.paged_decode_attention(q, kp, vp, tb, ctx, work_items=work,
                                     **kw)
    good = tpa.paged_decode_attention_plain(q, kp, vp, tb, ctx,
                                            num_splits=n_split, **kw)
    bad = tpa.paged_decode_attention_plain(q.roll(16, 1).contiguous(), kp,
                                           vp, tb, ctx, num_splits=n_split,
                                           **kw)
    torch.cuda.synchronize()
    _close(got, good)
    err = (got.float() - bad.float()).abs()
    assert bool((err > 2e-2 + 2e-2 * bad.float().abs()).any())


@pytest.mark.parametrize("page_dtype", [torch.bfloat16, torch.int8,
                                        torch.float8_e5m2])
@pytest.mark.parametrize("hkv,d", [(4, 128), (1, 128), (32, 80), (64, 96),
                                   (16, 256)],
                         ids=["qwen2", "decilm1", "phi2", "neox20b", "gptj"])
def test_writers_at_the_other_row_widths_are_exact(dev, hkv, d,
                                                   page_dtype):
    """K4 with shared pages and padding slots, and K2 on bf16 pages (8-bit
    prompts take the slot scatter), at each architecture's page row
    width (Hkv x head_dim, 128 to 6144 values): bit for bit their plain
    versions."""
    g = torch.Generator(device=dev).manual_seed(hkv * d)
    hd, num_pages, ps = hkv * d, 64, 32
    base = torch.randn(num_pages, ps, hd, generator=g, device=dev)
    kp = tkq.quantize_kv(base, page_dtype, KV_SCALE)
    knew = torch.randn(96, hd, generator=g, device=dev).to(torch.bfloat16)
    slots = torch.randperm(num_pages * ps, generator=g, device=dev)[:96].to(
        torch.int32)
    slots[::5] = num_pages * ps
    a = tkw.write_kv_pages(knew, knew.flip(0), kp.clone(), kp.clone(), slots,
                           kv_scale=KV_SCALE)
    b = tkw.write_kv_pages_plain(knew, knew.flip(0), kp.clone(), kp.clone(),
                                 slots, KV_SCALE)
    torch.cuda.synchronize()
    assert torch.equal(_bytes(a[0]), _bytes(b[0]))
    assert torch.equal(_bytes(a[1]), _bytes(b[1]))
    if page_dtype != torch.bfloat16:
        return
    pid = torch.tensor([3, num_pages, 5, 9], dtype=torch.int32, device=dev)
    vld = torch.tensor([ps, ps, 7, 1], dtype=torch.int32, device=dev)
    rows = torch.randn(4 * ps, hd, generator=g, device=dev).to(torch.bfloat16)
    c = tkw.write_kv_pages_prefill(rows, rows.flip(0), kp.clone(), kp.clone(),
                                   pid, np.arange(4, dtype=np.int32), vld)
    e = tkw.write_kv_pages_prefill_plain(rows, rows.flip(0), kp.clone(),
                                         kp.clone(), pid, vld)
    torch.cuda.synchronize()
    assert torch.equal(c[0], e[0]) and torch.equal(c[1], e[1])


# ---- the quantized fallback route (dequantize, then matmul) ----

def _fallback_layer(kind, K, N, g):
    """CPU parameters of one layer the kernels' gates refuse: GPTQ 4-bit
    group 32 with an act-order g_idx (a permutation of arange(K) // 32),
    GPTQ 2-bit group 128, or AWQ group 64; random codes and zeros,
    scales in [0.002, 0.022)."""
    from aphrodite_tpu_torch.modeling.layers.quantization.awq import (
        AWQConfig)
    from aphrodite_tpu_torch.modeling.layers.quantization.gptq import (
        GPTQConfig)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                             dtype=torch.int64).to(torch.int32)
    bits, gs = {"gptq-g32-actorder": (4, 32), "gptq-2bit": (2, 128),
                "awq-g64": (4, 64)}[kind]
    scales = (torch.rand(K // gs, N, generator=g) * 0.02 + 0.002).to(
        torch.bfloat16)
    if kind == "awq-g64":
        return AWQConfig(4, gs).get_linear_method(), gs, {
            "qweight": words(K, N // 8), "qzeros": words(K // gs, N // 8),
            "scales": scales}
    pack = 32 // bits
    g_idx = torch.arange(K, dtype=torch.int32) // gs
    if kind == "gptq-g32-actorder":
        g_idx = g_idx[torch.randperm(K, generator=g)]
    return GPTQConfig(bits, gs, kind == "gptq-g32-actorder"
                      ).get_linear_method(), gs, {
        "qweight": words(K // pack, N), "qzeros": words(K // gs, N // pack),
        "scales": scales, "g_idx": g_idx}


@pytest.mark.parametrize("kind", ["gptq-g32-actorder", "gptq-2bit",
                                  "awq-g64"])
@pytest.mark.parametrize("m", [1, 8, 72])
def test_fallback_on_the_card_matches_the_cpu(dev, kind, m):
    """A layer the gates refuse through its method's `apply` on the card
    (the dequantize route: no quantized wrapper launches) against the
    same `apply` on the CPU: 2e-2 + 2e-2 |cpu| (the same bf16 weight,
    f32 sums in another order, bf16 outputs). A control, GPTQ's g_idx
    rolled by one group or AWQ's zero rows shifted by one, misses it."""
    from aphrodite_tpu_torch.ops.cuda import build
    g = torch.Generator().manual_seed(m)
    method, gs, params = _fallback_layer(kind, 512, 256, g)
    x = torch.randn(m, 512, generator=g).to(torch.bfloat16)
    card = {n: t.to(dev) for n, t in params.items()}
    before = {n: c.count for n, c in build.COUNTERS.items()}
    got = method.apply(card, x.to(dev)).cpu()
    assert {n: c.count for n, c in build.COUNTERS.items()} == before
    want = method.apply(params, x)
    err = (got.float() - want.float()).abs()
    assert (err <= 2e-2 + 2e-2 * want.float().abs()).all(), err.max()
    bad = dict(card, qzeros=card["qzeros"].roll(1, 0)) if kind == "awq-g64" \
        else dict(card, g_idx=card["g_idx"].roll(gs))
    miss = (method.apply(bad, x.to(dev)).cpu().float() - want.float()).abs()
    assert (miss > 2e-2 + 2e-2 * want.float().abs()).any()


def test_other_formats_fallback_on_the_card_matches_the_cpu(dev):
    """Shapes the gates refuse in bf16 (GGUF q8_0, q6_k and q4_k buckets
    and SqueezeLLM and int8 layers at in 384, QuIP#'s int8 form at 128)
    and float32 activations at shapes the gates take (GPTQ, AWQ, GGUF
    q8_0, int8): `apply` on the card against the CPU's, bf16 within 2e-2
    + 2e-2 |cpu|, f32 within 1e-4 of max |cpu|; no quantized wrapper
    launches (chip_smoke phase 21 (e)'s layers)."""
    import chip_smoke
    from aphrodite_tpu_torch.ops.cuda import build
    layers, gen = chip_smoke.other_format_layers(torch)
    for label, K, method, params, dtype in layers:
        card = {n: t.to(dev) for n, t in params.items()}
        for m in (1, 5, 72):
            x = torch.randn(m, K, generator=gen).to(dtype)
            before = {n: c.count for n, c in build.COUNTERS.items()}
            got = method.apply(card, x.to(dev)).cpu()
            assert {n: c.count for n, c in build.COUNTERS.items()} == \
                before, label
            want = method.apply(params, x)
            assert got.dtype == want.dtype == dtype, label
            err = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                assert err.max() <= 1e-4 * want.abs().max(), label
            else:
                assert (err <= 2e-2 + 2e-2 * want.float().abs()).all(), \
                    (label, err.max())


def test_act_order_gptq_engine_generates_on_the_card(dev, tmp_path,
                                                     monkeypatch):
    """An act-order GPTQ model (4 bits, group 32, desc_act; a tiny Llama,
    dummy weights) built for the card and served: every request finishes
    with tokens in the vocabulary, K1 and K2 launch, no GPTQ kernel nor
    K9 does."""
    import json
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.endpoints.llm import LLM
    from aphrodite_tpu_torch.ops.cuda import build
    monkeypatch.setenv("APHRODITE_SPEC", "0")
    (tmp_path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "num_key_value_heads": 1, "max_position_embeddings": 512,
        "quantization_config": {"quant_method": "gptq", "bits": 4,
                                "group_size": 32, "desc_act": True,
                                "sym": True}}))
    llm = LLM(model=str(tmp_path), load_format="dummy", dtype="bfloat16",
              max_model_len=256, gpu_memory_utilization=0.3,
              skip_tokenizer_init=True, disable_log_stats=True)
    for c in build.COUNTERS.values():
        c.reset()
    outs = llm.generate(prompt_token_ids=[[5 + i for i in range(n)]
                                          for n in (3, 40, 90)],
                        sampling_params=SamplingParams(
                            temperature=0.0, max_tokens=8, ignore_eos=True))
    for o in outs:
        assert len(o.outputs[0].token_ids) == 8
        assert all(0 <= t < 512 for t in o.outputs[0].token_ids)
    counts = {n: c.count for n, c in build.COUNTERS.items()}
    assert counts.get("paged_decode_attention", 0) > 0
    assert counts.get("write_kv_pages_prefill", 0) + \
        counts.get("write_kv_pages", 0) > 0
    for name in ("gptq_matmul", "gptq_matmul_stream", "gptq_matmul_a8",
                 "gptq_matmul_stream_a8", "quantize_activations_int8"):
        assert counts.get(name, 0) == 0, (name, counts)


# ---- float16: K1 / K5's fp16 instances and the writers on fp16 rows ----

def _fp16_call(dev, ctxs, page_dtype, *, ragged=True, splits=None,
               fused=True, alibi=False, amla=True, seed=3, hq=32, hkv=8,
               d=128):
    """K1 (with a work list) or K5 on fp16 activations over `page_dtype`
    pages at the given geometry (page size 32), and the plain version at
    the kernel's split count on copies of the same pages. Returns (got,
    want, pages after the kernel, pages after the plain version, the
    problem, slopes, kv_scale)."""
    q, kp, vp, tb, ctx, kn, vn = _decode_problem(
        dev, ctxs, page_dtype=page_dtype, seed=seed, d=d, hq=hq, hkv=hkv,
        act=torch.float16)
    slopes = torch.tensor([2.0 ** -(i / 4 + 1) for i in range(hq)],
                          device=dev) if alibi else None
    kn, vn = (kn, vn) if fused else (None, None)
    b = len(ctxs)
    ppc = tpa.choose_pages_per_chunk(tb.shape[1], 32, b)
    work = tpa.build_decode_work_list(
        [-(-c // 32) for c in ctxs], ppc) if ragged else None
    if splits == "chunks":
        splits = tb.shape[1] // ppc
    n_split = tpa.choose_decode_splits(
        b, hkv * tpa.row_blocks(hq // hkv), tb.shape[1], ppc,
        tpa.sm_count(dev)) if splits is None else splits
    kv_scale = tkq.dequant_scale(page_dtype, KV_SCALE)
    kw = dict(scale=d ** -0.5, kv_scale=kv_scale, pages_per_chunk=ppc,
              amla=amla)
    counter = tpa.PAGED_DECODE_ATTENTION_LAUNCHES if ragged else \
        tpa.PAGED_DECODE_ATTENTION_TM_LAUNCHES
    before = counter.count
    kp2, vp2 = kp.clone(), vp.clone()
    got = tpa.paged_decode_attention(q, kp, vp, tb, ctx, slopes, kn, vn,
                                     work_items=work, num_splits=splits,
                                     **kw)
    want = tpa.paged_decode_attention_plain(q, kp2, vp2, tb, ctx, slopes,
                                            kn, vn, num_splits=n_split,
                                            **kw)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    if fused:
        got, want = got[0], want[0]
    assert got.dtype == torch.float16
    return got, want, (kp, vp), (kp2, vp2), (q, tb, ctx), slopes, kv_scale


def _close_f64(got, pages, problem, slopes, kv_scale):
    """`_close` against `_attention_f64` on the pages as the kernel left
    them (its fused rows included)."""
    q, tb, ctx = problem
    ref = _attention_f64(q, pages[0], pages[1], tb, ctx,
                         q.shape[2] ** -0.5, kv_scale, slopes)
    _close(got, ref)
    return ref


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("page_dtype", [torch.float16, torch.int8,
                                        torch.float8_e5m2])
@pytest.mark.parametrize("ragged,splits", [
    (False, None), (True, None), (True, 1), (True, 2), (True, "chunks")],
    ids=["K5", "K1", "K1-1split", "K1-2splits", "K1-split-per-chunk"])
@pytest.mark.parametrize("fused,alibi,amla", [
    (False, False, True), (True, True, False), (True, False, True)])
def test_fp16_decode_attention_matches_f64(dev, batch, page_dtype, ragged,
                                           splits, fused, alibi, amla):
    """K1 and K5's fp16 instances at the main geometry (Hq 32, Hkv 8, d
    128) over fp16, int8 and fp8 pages, batch 1, 8 and 64, with and
    without the fused write and ALiBi, AMLA on and off, at split counts
    1, 2, one per chunk and the policy's: within 2e-2 + 2e-2 |ref| of
    an f64 evaluation (q rounded to fp16, the kernel's operand) and of
    the plain version; the fused write's pages bit-equal the plain
    version's."""
    ctxs = ([1, 0, 17, 100, 1000, 2047, 33, 512] * 8)[:batch] \
        if batch > 1 else [1000]
    got, want, pages, pages2, problem, slopes, kv_scale = _fp16_call(
        dev, ctxs, page_dtype, ragged=ragged, splits=splits, fused=fused,
        alibi=alibi, amla=amla)
    if fused:
        assert torch.equal(_bytes(pages[0]), _bytes(pages2[0]))
        assert torch.equal(_bytes(pages[1]), _bytes(pages2[1]))
    if batch > 1:
        assert (got[1] == 0).all()                 # ctx 0 row
    _close(got, want)
    _close_f64(got, pages, problem, slopes, kv_scale)


@pytest.mark.parametrize("page_dtype", [torch.float16, torch.int8,
                                        torch.float8_e5m2])
@pytest.mark.parametrize("hq,hkv,d", [(16, 16, 80), (16, 16, 96),
                                      (16, 16, 256), (32, 1, 128)],
                         ids=["group1-d80", "group1-d96", "group1-d256",
                              "group32"])
def test_fp16_k1_at_the_other_geometries_matches_f64(dev, hq, hkv, d,
                                                     page_dtype):
    """K1's fp16 instances at group 1 with head_dim 80, 96 and 256 and at
    group 32 (two 16-row blocks), fused write and ALiBi, the policy's
    split count: within 2e-2 + 2e-2 |ref| of f64 and of the plain
    version; fused codes exact."""
    got, want, pages, pages2, problem, slopes, kv_scale = _fp16_call(
        dev, [1, 0, 17, 100, 1000, 2047, 33, 512], page_dtype, alibi=True,
        seed=7, hq=hq, hkv=hkv, d=d)
    assert torch.equal(_bytes(pages[0]), _bytes(pages2[0]))
    assert torch.equal(_bytes(pages[1]), _bytes(pages2[1]))
    _close(got, want)
    _close_f64(got, pages, problem, slopes, kv_scale)


@pytest.mark.parametrize("page_dtype", [torch.float16, torch.int8,
                                        torch.float8_e5m2])
def test_fp16_k1_control_misses(dev, page_dtype):
    """The f64 evaluation over the neighbouring head's K rows (pages
    rolled by d along the lanes) misses the tolerance K1's fp16 instance
    meets."""
    got, _, pages, _, problem, _, kv_scale = _fp16_call(
        dev, [2047] * 62 + [1000, 17], page_dtype, fused=False, seed=9)
    _close_f64(got, pages, problem, None, kv_scale)
    q, tb, ctx = problem
    # Rolled as bytes: torch has no roll for float8_e5m2 on the card.
    rolled = pages[0].view(torch.uint8).roll(
        128 * pages[0].element_size(), 2).view(pages[0].dtype)
    bad = _attention_f64(q, rolled, pages[1], tb, ctx, 128 ** -0.5,
                         kv_scale)
    assert _misses(got, bad)


@pytest.mark.parametrize("ragged", [True, False], ids=["K1", "K5"])
@pytest.mark.parametrize("page_dtype", [torch.float16, torch.int8,
                                        torch.float8_e5m2])
def test_fp16_fused_write_rounds_as_the_slot_writer(dev, page_dtype,
                                                    ragged):
    """K1's and K5's fused write of fp16 rows at the write rules' edges
    (`_edge_rows` of fp16, S = 0.25 on int8 pages): page bytes equal to
    the slot writer's plain version writing the same rows at each
    sequence's position ctx - 1."""
    ctxs = [1, 0, 17, 100, 1000, 2047, 33, 512]
    b = len(ctxs)
    q, kp, vp, tb, ctx, _, _ = _decode_problem(dev, ctxs, seed=5,
                                               page_dtype=page_dtype,
                                               act=torch.float16)
    knew = _edge_rows(dev, torch.float16)[:b].contiguous()
    vnew = knew.flip(0).contiguous()
    kv_scale = tkq.dequant_scale(page_dtype, 0.25)
    ppc = tpa.choose_pages_per_chunk(tb.shape[1], 32, b)
    work = tpa.build_decode_work_list(
        [-(-c // 32) for c in ctxs], ppc) if ragged else None
    pos = (ctx.long() - 1).clamp(min=0)
    slots = tb.long().gather(1, (pos // 32)[:, None])[:, 0] * 32 + pos % 32
    slots = torch.where(ctx > 0, slots, kp.shape[0] * 32).to(torch.int32)
    want = tkw.write_kv_pages_plain(knew, vnew, kp.clone(), vp.clone(),
                                    slots, kv_scale)
    tpa.paged_decode_attention(q, kp, vp, tb, ctx, None,
                               knew.view(b, 8, 128), vnew.view(b, 8, 128),
                               work_items=work, scale=128 ** -0.5,
                               kv_scale=kv_scale, pages_per_chunk=ppc)
    torch.cuda.synchronize()
    # Bytes, on fp16 pages too: the rows hold NaN, which no value
    # comparison equals.
    assert torch.equal(kp.view(torch.uint8), want[0].view(torch.uint8))
    assert torch.equal(vp.view(torch.uint8), want[1].view(torch.uint8))


def test_fp16_slot_writer_controls_miss(dev):
    """fp16 rows: the plain version at kv_scale x 1.01 on int8 pages, and
    with every live slot moved one row on fp16 pages, miss the kernel's
    pages; K2 on fp16 pages against the plain version writing one row
    past each tail (`valids + 1`) differs."""
    g = torch.Generator(device=dev).manual_seed(6)
    slots, num_pages = _slot_round(dev, g, 64)
    knew = torch.randn(64, 1024, generator=g, device=dev).to(torch.float16)
    for page_dtype in (torch.int8, torch.float16):
        kp = tkq.quantize_kv(torch.randn(num_pages, 32, 1024, generator=g,
                                         device=dev), page_dtype, KV_SCALE)
        a = tkw.write_kv_pages(knew, knew, kp.clone(), kp.clone(), slots,
                               kv_scale=KV_SCALE)
        good = tkw.write_kv_pages_plain(knew, knew, kp.clone(), kp.clone(),
                                        slots, KV_SCALE)
        if page_dtype == torch.int8:
            bad = tkw.write_kv_pages_plain(knew, knew, kp.clone(),
                                           kp.clone(), slots,
                                           KV_SCALE * 1.01)
        else:
            moved = torch.where(slots < num_pages * 32,
                                (slots + 1) % (num_pages * 32), slots)
            bad = tkw.write_kv_pages_plain(knew, knew, kp.clone(),
                                           kp.clone(), moved, KV_SCALE)
        torch.cuda.synchronize()
        assert torch.equal(_bytes(a[0]), _bytes(good[0]))
        assert not torch.equal(_bytes(a[0]), _bytes(bad[0]))
