"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked `gpu` and skips without a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed: `python -m pytest --noconftest -m gpu
tests/test_torch_kernels_gpu.py` (tests/conftest.py imports JAX).

Tolerances: the writers copy values, so exactly equal. Attention in
bf16: |kernel - plain| <= 2e-2 + 2e-2 |plain| (the kernel keeps the
softmax weights in f32 where the plain version rounds them to bf16; both
round the output to bf16, one ulp of which is 1.6e-2 at 2-4).
"""
import numpy as np
import pytest
import torch

from aphrodite_tpu_torch.ops.cuda import kv_write as tkw
from aphrodite_tpu_torch.ops.cuda import paged_attention as tpa

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _decode_problem(dev, ctxs, page_size=32, pps=64, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, hq, hkv, d = len(ctxs), 32, 8, 128
    pages = b * pps + 1

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)
    tables = (torch.randperm(pages - 1, generator=g, device=dev)[:b * pps]
              + 1).view(b, pps).to(torch.int32).contiguous()
    return (randn(b, hq, d), randn(pages, page_size, hkv * d),
            randn(pages, page_size, hkv * d), tables,
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


def test_wrappers_count_launches_and_refuse_bad_inputs(dev):
    q, kp, vp, tb, ctx, kn, vn = _decode_problem(dev, [5, 9])
    before = tpa.PAGED_DECODE_ATTENTION_LAUNCHES.count
    tpa.paged_decode_attention(q, kp, vp, tb, ctx, scale=0.1)
    assert tpa.PAGED_DECODE_ATTENTION_LAUNCHES.count == before + 1
    with pytest.raises(TypeError):
        tpa.paged_decode_attention(q.float(), kp, vp, tb, ctx, scale=0.1)
    with pytest.raises(ValueError, match="mixed devices"):
        tpa.paged_decode_attention(q, kp, vp, tb.cpu(), ctx, scale=0.1)
    with pytest.raises(TypeError):
        tkw.write_kv_pages(kn.view(2, -1), vn.view(2, -1), kp, vp,
                           ctx.long())
