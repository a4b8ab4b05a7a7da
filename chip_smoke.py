#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`aphrodite_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card: requires `torch.cuda.is_available()`; prints the device name
   and `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`.
2. Build: compiles every kernel source under `aphrodite_tpu_torch/csrc/`
   with nvcc for sm_90a (one process per source, in parallel) and prints
   each source's `-Xptxas -v` report on one line.
3. Kernels vs plain versions at the main path's shapes (Hq 32, Hkv 8,
   head_dim 128, bf16, 16- and 32-token pages):
   - paged decode attention (K1): batch 1, 8 and 64, ragged contexts up
     to 2047 tokens, with and without the fused KV write and ALiBi.
     Tolerance: |kernel - plain| <= 2e-2 + 2e-2 |plain| (bf16 outputs;
     the kernel keeps softmax weights in f32 where the plain version
     rounds them to bf16). Pages written by the fused write: exact.
   - prefill page writer (K2): full pages, tail pages, skipped cells.
     Exact.
   - slot writer (K3/K4): shared pages, out-of-range slots. Exact.
   Times each kernel (CUDA events, L2 flushed before every launch,
   median), its plain version, one PyTorch library call computing the
   same function (scaled_dot_product_attention over the gathered KV for
   K1, index_copy_ for the writers; a yardstick only, the port never
   calls it) and the bound: the larger of the bytes the function must
   move over 3.35 TB/s and its operations over 989 TFLOP/s (bf16), from
   this run's inputs.
   A full-width 2-layer model (weights large enough that attention
   matters) is checked end to end against itself run through the plain
   versions: prompt + 3 decode steps, logits within 2e-2 relative.
4. End to end: the port's engine serves a Llama of Mistral-7B width and
   depth (hidden 4096, 32 layers, 32/8 heads, intermediate 14336, vocab
   32000), bf16, dummy weights from seed 0, 32-token pages, token ids in
   and out: 8 greedy requests (prompts of 1000, 300 and 64 tokens, then
   two of 12 tokens arriving one round later), 32 new tokens each, once
   with multi_step=1 and once with multi_step=8. The launch counters are
   reset just before and read just after; K1, K2 and K4 must each have
   launched in both runs, and every request must finish with 32 tokens
   in the vocabulary and a finite cumulative logprob. Then 4 decode
   steps of 8 sequences run under torch.profiler: wall and device
   kernel time per step, and the kernels that take the most.
5. Prints the kernel JSON line, the card line, and last
   {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HQ, HKV, HEAD_DIM = 32, 8, 128
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16
ATOL = RTOL = 2e-2

MISTRAL_7B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "bos_token_id": 1, "eos_token_id": 2,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ------------------------------------------------------------ timing --

class Timer:
    """Median kernel time over `iters` launches, each with the L2 cache
    flushed first (decode reads every layer's KV cold)."""

    def __init__(self, torch, iters: int = 20) -> None:
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(96 << 20, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------- K1 problem builder --

def decode_problem(torch, ctxs, page_size, pages_per_seq, seed,
                   alibi=False, fused=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = len(ctxs)
    num_pages = batch * pages_per_seq + 1
    hd = HKV * HEAD_DIM

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    q = randn(batch, HQ, HEAD_DIM)
    kp = randn(num_pages, page_size, hd)
    vp = randn(num_pages, page_size, hd)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    tables = perm[:batch * pages_per_seq].view(batch, pages_per_seq).to(
        torch.int32).contiguous()
    ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    slopes = torch.tensor([2.0 ** -(8 * (i + 1) / HQ) for i in range(HQ)],
                          dtype=torch.float32, device="cuda") \
        if alibi else None
    knew = randn(batch, HKV, HEAD_DIM) if fused else None
    vnew = randn(batch, HKV, HEAD_DIM) if fused else None
    return q, kp, vp, tables, ctx, slopes, knew, vnew


def check_decode_attention(torch, pa):
    """K1 vs plain across the main path's shapes."""
    import random
    rng = random.Random(0)
    worst = 0.0
    cases = 0
    for page_size in (16, 32):
        pps = 2048 // page_size
        for batch in (1, 8, 64):
            specials = [1, 17, 100, 1000, 2047]
            ctxs = [specials[i] if i < len(specials)
                    else rng.randint(1, 2047) for i in range(batch)]
            if batch == 1:
                ctxs = [2047]
            for fused in (False, True):
                for alibi in (False, True):
                    q, kp, vp, tb, ctx, sl, kn, vn = decode_problem(
                        torch, ctxs, page_size, pps, seed=cases,
                        alibi=alibi, fused=fused)
                    kp2, vp2 = kp.clone(), vp.clone()
                    got = pa.paged_decode_attention(
                        q, kp, vp, tb, ctx, sl, kn, vn,
                        scale=HEAD_DIM ** -0.5)
                    want = pa.paged_decode_attention_plain(
                        q, kp2, vp2, tb, ctx, sl, kn, vn,
                        scale=HEAD_DIM ** -0.5,
                        pages_per_chunk=pa.choose_pages_per_chunk(
                            pps, page_size, batch))
                    torch.cuda.synchronize()
                    if fused:
                        got, want = got[0], want[0]
                        if not (torch.equal(kp, kp2) and
                                torch.equal(vp, vp2)):
                            fail(f"K1 fused write differs (page "
                                 f"{page_size}, batch {batch})")
                    err = (got.float() - want.float()).abs()
                    lim = ATOL + RTOL * want.float().abs()
                    if not torch.isfinite(got.float()).all() or \
                            bool((err > lim).any()):
                        fail(f"K1 page {page_size} batch {batch} fused "
                             f"{fused} alibi {alibi}: max err "
                             f"{err.max().item()}")
                    worst = max(worst, err.max().item())
                    cases += 1
    log(f"K1 paged_decode_attention vs plain: {cases} cases, max abs err "
        f"{worst} (tolerance {ATOL} + {RTOL}|plain|); fused-write pages "
        "exact")
    return worst


def time_decode_attention(torch, pa, timer, ctxs, page_size, pps, fused):
    import torch.nn.functional as F
    q, kp, vp, tb, ctx, sl, kn, vn = decode_problem(
        torch, ctxs, page_size, pps, seed=99, fused=fused)
    scale = HEAD_DIM ** -0.5
    ms = timer(lambda: pa.paged_decode_attention(
        q, kp, vp, tb, ctx, sl, kn, vn, scale=scale))
    ppc = pa.choose_pages_per_chunk(pps, page_size, len(ctxs))
    plain_ms = timer(lambda: pa.paged_decode_attention_plain(
        q, kp, vp, tb, ctx, sl, kn, vn, scale=scale, pages_per_chunk=ppc))
    # Library yardstick: SDPA over each sequence's KV gathered to the
    # batch-max context (gather and head expansion outside the timing).
    batch, lmax = len(ctxs), max(ctxs)
    idx = tb.long()
    kg = kp[idx].view(batch, pps * page_size, HKV, HEAD_DIM)[:, :lmax]
    vg = vp[idx].view(batch, pps * page_size, HKV, HEAD_DIM)[:, :lmax]
    group = HQ // HKV
    kx = kg.permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous()
    vx = vg.permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous()
    mask = (torch.arange(lmax, device="cuda")[None] <
            ctx.long()[:, None]).view(batch, 1, 1, lmax)
    q4 = q.view(batch, HQ, 1, HEAD_DIM)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        q4, kx, vx, attn_mask=mask, scale=scale))
    total_ctx = sum(ctxs)
    nbytes = (total_ctx * HKV * HEAD_DIM * 2 * 2       # K and V read
              + 2 * batch * HQ * HEAD_DIM * 2          # q in, out
              + batch * pps * 4 + batch * 4)           # tables, ctx
    if fused:
        nbytes += 2 * batch * HKV * HEAD_DIM * 2 * 2   # knew/vnew in+out
    flops = 4 * HQ * HEAD_DIM * total_ctx
    b_ms, b_by = bound(nbytes, flops)
    return ms, plain_ms, library_ms, b_ms, b_by


# ------------------------------------------------------- K2 / K3 / K4 --

def check_and_time_writers(torch, kw, timer):
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(7)
    hd = HKV * HEAD_DIM
    page_size = 32

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    # K2 at the first prompt round of phase 4: prompts of 1000, 300, 64,
    # 1000, 300, 64 tokens padded to 1024 in a batch bucket of 8, plus a
    # cell list with tail pages and skipped cells.
    prompts = [1000, 300, 64, 1000, 300, 64]
    padded_batch, padded_len = 8, 1024
    ppp = padded_len // page_size
    num_pages = 4096
    kp, vp = randn(num_pages, page_size, hd), randn(num_pages, page_size,
                                                    hd)
    cells = padded_batch * ppp
    pid = np.full((cells,), num_pages, dtype=np.int32)
    vld = np.zeros((cells,), dtype=np.int32)
    perm = torch.randperm(num_pages, generator=gen,
                          device="cuda").cpu().numpy()
    nxt = 0
    for i, n in enumerate(prompts):
        for p in range(-(-n // page_size)):
            pid[i * ppp + p] = perm[nxt]
            vld[i * ppp + p] = min(n - p * page_size, page_size)
            nxt += 1
    knew = randn(cells * page_size, hd)
    vnew = randn(cells * page_size, hd)
    pid_t = torch.from_numpy(pid).cuda()
    vld_t = torch.from_numpy(vld).cuda()
    sblk = np.arange(cells, dtype=np.int32)
    a = kw.write_kv_pages_prefill(knew, vnew, kp.clone(), vp.clone(),
                                  pid_t, sblk, vld_t)
    b = kw.write_kv_pages_prefill_plain(knew, vnew, kp.clone(), vp.clone(),
                                        pid_t, vld_t)
    torch.cuda.synchronize()
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        fail("K2 write_kv_pages_prefill differs from its plain version")
    rows = int(vld.sum())
    # Library yardstick: index_copy_ of the valid rows into their slots.
    live = torch.from_numpy(np.repeat(pid < num_pages, page_size) &
                            (np.tile(np.arange(page_size), cells) <
                             np.repeat(vld, page_size))).cuda()
    slots = (torch.from_numpy(np.repeat(pid.astype(np.int64), page_size) *
                              page_size +
                              np.tile(np.arange(page_size),
                                      cells)).cuda())[live]
    src_k, src_v = knew[live], vnew[live]
    k_flat, v_flat = kp.view(-1, hd), vp.view(-1, hd)
    k2 = dict(
        ms=timer(lambda: kw.write_kv_pages_prefill(
            knew, vnew, kp, vp, pid_t, sblk, vld_t)),
        plain_ms=timer(lambda: kw.write_kv_pages_prefill_plain(
            knew, vnew, kp, vp, pid_t, vld_t)),
        library_ms=timer(lambda: (k_flat.index_copy_(0, slots, src_k),
                                  v_flat.index_copy_(0, slots, src_v))))
    k2["bound_ms"], k2["bound_by"] = bound(
        2 * 2 * rows * hd * 2 + cells * 8, 0)
    log(f"K2 write_kv_pages_prefill vs plain: exact ({cells} cells, "
        f"{rows} rows, tail pages and skipped cells)")

    # K3/K4: shared pages and out-of-range slots, exact.
    kp2, vp2 = randn(64, page_size, hd), randn(64, page_size, hd)
    toks = 96
    slots4 = torch.randperm(64 * page_size, generator=gen,
                            device="cuda")[:toks].to(torch.int32)
    slots4[::5] = 64 * page_size          # padding lanes
    kn, vn = randn(toks, hd), randn(toks, hd)
    for distinct in (False, True):
        a = kw.write_kv_pages(kn, vn, kp2.clone(), vp2.clone(), slots4,
                              distinct_pages=distinct)
        b = kw.write_kv_pages_plain(kn, vn, kp2.clone(), vp2.clone(),
                                    slots4)
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            fail("K3/K4 write_kv_pages differs from its plain version")
    log("K3/K4 write_kv_pages vs plain: exact (shared pages, "
        "out-of-range slots)")
    # Timed at phase 4's unaligned round: two 12-token prompts padded to
    # 16 rows each (24 live slots of 32).
    t_slots = torch.full((32,), num_pages * page_size, dtype=torch.int32,
                         device="cuda")
    t_slots[:12] = torch.arange(12, dtype=torch.int32) + 5 * page_size
    t_slots[16:28] = torch.arange(12, dtype=torch.int32) + 9 * page_size
    tk, tv = randn(32, hd), randn(32, hd)
    live4 = t_slots < num_pages * page_size
    idx4 = t_slots[live4].long()
    sk, sv = tk[live4], tv[live4]
    k4 = dict(
        ms=timer(lambda: kw.write_kv_pages(tk, tv, kp, vp, t_slots)),
        plain_ms=timer(lambda: kw.write_kv_pages_plain(tk, tv, kp, vp,
                                                       t_slots)),
        library_ms=timer(lambda: (k_flat.index_copy_(0, idx4, sk),
                                  v_flat.index_copy_(0, idx4, sv))))
    k4["bound_ms"], k4["bound_by"] = bound(2 * 2 * 24 * hd * 2 + 32 * 4, 0)
    return k2, k4


# ------------------------------------------ full-width model check --

def check_model_against_plain(torch):
    """A 2-layer Llama at Mistral-7B width, weights U(-0.05, 0.05) so
    attention shapes the output: prompt (page-aligned -> K2) and 3
    decode steps (K1 fused) through the kernels vs through the plain
    versions; logits within 2e-2 of max |logit|."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.common.sequence import (SequenceData,
                                                     SequenceGroupMetadata)
    from aphrodite_tpu_torch.executor.model_runner import ModelRunner
    from aphrodite_tpu_torch.modeling.layers import attention
    from aphrodite_tpu_torch.modeling.models.llama import LlamaForCausalLM
    from aphrodite_tpu_torch.ops.cuda import kv_write as kw
    from aphrodite_tpu_torch.ops.cuda import paged_attention as pa
    from aphrodite_tpu_torch.transformers_utils.config import (
        config_from_dict)

    cfg = config_from_dict(dict(MISTRAL_7B, num_hidden_layers=2))
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = model.init_params(dev)
    for bucket in params.values():
        for t in bucket.values():
            t.uniform_(-0.05, 0.05, generator=gen)
    for key, bucket in params.items():
        if key.endswith("layernorm") or key == "model.norm":
            bucket["weight"].fill_(1.0)

    class _Cfg:
        def get_vocab_size(self):
            return cfg.vocab_size

        def get_sliding_window(self):
            return None
    page_size, num_pages = 32, 16

    def run(plain: bool):
        runner = ModelRunner(model, params, _Cfg(), None, page_size,
                             num_pages * page_size, dev)
        kv = [(torch.zeros(num_pages, page_size, HKV * HEAD_DIM,
                           dtype=torch.bfloat16, device=dev),
               torch.zeros(num_pages, page_size, HKV * HEAD_DIM,
                           dtype=torch.bfloat16, device=dev))
              for _ in range(2)]
        saved = {}
        if plain:
            saved = {n: getattr(attention, n) for n in (
                "write_kv_pages", "write_kv_pages_prefill",
                "paged_decode_attention")}
            attention.write_kv_pages = \
                lambda k, v, kp, vp, s, **_: kw.write_kv_pages_plain(
                    k, v, kp, vp, s)
            attention.write_kv_pages_prefill = \
                lambda k, v, kp, vp, pid, sb, vld: \
                kw.write_kv_pages_prefill_plain(k, v, kp, vp, pid, vld)
            attention.paged_decode_attention = \
                pa.paged_decode_attention_plain
        try:
            tokens = [(i * 37 + 11) % 32000 for i in range(64)]
            table = [3, 9, 4, 12]
            logits_all = []
            for step in range(4):
                data = SequenceData(list(tokens) if step == 0
                                    else list(tokens[:-1]))
                if step:
                    data.append_token_id(tokens[-1], 0.0)
                md = SequenceGroupMetadata(
                    "0", step == 0, {0: data},
                    SamplingParams(temperature=0.0), {0: table}, {0: {}})
                inputs, _ = (runner._prepare_prompt([md]) if step == 0
                             else runner._prepare_decode([md]))
                meta = inputs["metadata"].replace(is_prompt=step == 0)
                logits, kv = runner._logits(
                    params, inputs["input_ids"], inputs["positions"], kv,
                    meta, inputs["sel"])
                row = logits[0].float()
                logits_all.append(row)
                tokens.append(int(row.argmax()))
            return logits_all, tokens
        finally:
            for n, f in saved.items():
                setattr(attention, n, f)

    got, got_tokens = run(plain=False)
    want, want_tokens = run(plain=True)
    torch.cuda.synchronize()
    worst = 0.0
    for g, w in zip(got, want):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        if not torch.isfinite(g).all() or rel > 2e-2:
            fail(f"full-width model: kernel path vs plain path logits "
                 f"differ by {rel} of max |logit|")
        worst = max(worst, rel)
    log(f"full-width 2-layer model, prompt + 3 decode steps: kernel path "
        f"vs plain path logits max rel err {worst}; tokens "
        f"{got_tokens[64:]} vs {want_tokens[64:]}")


# ---------------------------------------------------------- end to end --

def run_engine(torch, engine, multi_step: int, counters, card: str):
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    engine.scheduler_config.multi_step = multi_step
    sp = SamplingParams(temperature=0.0, max_tokens=32, ignore_eos=True)

    def prompt(n, salt):
        return [(i * 131 + salt * 977) % 31000 + 100 for i in range(n)]
    first = [1000, 300, 64, 1000, 300, 64]
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, n in enumerate(first):
        engine.add_request(f"m{multi_step}-{i}", None, sp,
                           prompt_token_ids=prompt(n, i))
    outputs, steps = {}, 0
    late_added = False
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                outputs[out.request_id] = out
        steps += 1
        if not late_added:
            # Two 12-token prompts one round later: alone in their prompt
            # chunk round, padded to 16 rows under 32-token pages, they
            # take the slot writer (K4).
            for j in range(2):
                engine.add_request(f"m{multi_step}-late{j}", None, sp,
                                   prompt_token_ids=prompt(12, 10 + j))
            late_added = True
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
    if len(outputs) != 8:
        fail(f"multi_step={multi_step}: {len(outputs)} of 8 finished")
    for rid, out in outputs.items():
        toks = out.outputs[0].token_ids
        if len(toks) != 32 or not all(0 <= t < 32000 for t in toks):
            fail(f"{rid}: bad tokens {toks}")
        if not (out.outputs[0].cumulative_logprob ==
                out.outputs[0].cumulative_logprob) or \
                abs(out.outputs[0].cumulative_logprob) == float("inf"):
            fail(f"{rid}: non-finite cumulative logprob")
    for name in ("paged_decode_attention", "write_kv_pages_prefill",
                 "write_kv_pages"):
        if launches.get(name, 0) <= 0:
            fail(f"multi_step={multi_step}: kernel {name} never launched "
                 f"on the main path ({launches})")
    new_tokens = 8 * 32
    log(f"e2e multi_step={multi_step}: 8 requests x 32 tokens, {steps} "
        f"engine steps, {dt:.3f} s, {new_tokens / dt:.1f} generated tok/s "
        f"on {card}, launches {launches}")
    return launches


def profile_decode(torch, engine) -> None:
    """Where a decode step's time goes at the e2e geometry: 8 running
    sequences (prompts of 64 tokens). 4 single decode steps are timed on
    the host clock (synchronised), then 4 more run under torch.profiler,
    which gives the device's kernel time per step, its share of the wall
    time, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    engine.scheduler_config.multi_step = 1
    sp = SamplingParams(temperature=0.0, max_tokens=14, ignore_eos=True)
    for i in range(8):
        engine.add_request(f"prof-{i}", None, sp, prompt_token_ids=[
            (j * 71 + i * 13) % 31000 + 100 for j in range(64)])
    for _ in range(3):                      # prefill + warm decode steps
        engine.step()
    steps = 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    while engine.has_unfinished_requests():
        engine.step()
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3 / steps
    top = "; ".join(f"{k[:48]} x{c // steps}/step {us / 1e3 / steps:.3f} ms"
                    for us, k, c in rows[:8])
    log(f"decode step, batch 8 at Mistral-7B width: wall {wall_ms:.2f} "
        f"ms/step (unprofiled), device kernels {dev_ms:.2f} ms/step "
        f"(busy share {dev_ms / wall_ms:.3f}); top kernels: {top}")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "aphrodite_tpu_torch")):
        print("chip_smoke: aphrodite_tpu_torch/ not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1

    # 1. Card.
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} (count {torch.cuda.device_count()}); "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. Build.
    from aphrodite_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {sorted(build.build_logs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in sorted(build.build_logs.items()):
        lines = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln or
                 "Compiling entry" in ln]
        log(f"ptxas {name}: " + " | ".join(lines))

    # 3. Kernels vs plain versions, and times.
    from aphrodite_tpu_torch.ops.cuda import kv_write as kw
    from aphrodite_tpu_torch.ops.cuda import paged_attention as pa
    timer = Timer(torch)
    k1_err = check_decode_attention(torch, pa)
    k2, k4 = check_and_time_writers(torch, kw, timer)
    # K1 timed at phase 4's decode batch: 8 sequences about 16 tokens
    # into their 32 new tokens, 32-token pages, fused write.
    e2e_ctx = [1016, 316, 80, 1016, 316, 80, 28, 28]
    k1 = dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                  time_decode_attention(torch, pa, timer, e2e_ctx, 32, 36,
                                        fused=True)))
    big = time_decode_attention(torch, pa, timer, [2047] * 64, 32, 64,
                                fused=True)
    log(f"K1 at batch 64 x ctx 2047 (page 32, fused): kernel {big[0]} ms, "
        f"plain {big[1]} ms, sdpa {big[2]} ms, bound {big[3]} ms "
        f"({big[4]})")
    check_model_against_plain(torch)

    # 4. End to end at Mistral-7B width and depth.
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    model_dir = os.path.join(HERE, "build", "chip_smoke_model")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(MISTRAL_7B, f)
    t0 = time.perf_counter()
    engine = AphroditeEngine.from_engine_args(EngineArgs(
        model=model_dir, load_format="dummy", dtype="bfloat16", seed=0,
        block_size=32, max_model_len=2048, skip_tokenizer_init=True,
        disable_log_stats=True))
    log(f"engine up in {time.perf_counter() - t0:.1f} s: "
        f"{engine.cache_config.num_gpu_blocks} KV pages of 32 tokens")
    counters = build.COUNTERS
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    for ms in (1, 8):
        for name, n in run_engine(torch, engine, ms, counters,
                                  smi).items():
            launches[name] = launches.get(name, 0) + n
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"e2e peak memory {peak:.2f} GiB on {smi}")
    profile_decode(torch, engine)

    entries = [
        dict(name="paged_decode_attention", route="cuda",
             source="aphrodite_tpu_torch/csrc/paged_attention.cu",
             replaces="aphrodite_tpu/ops/pallas/paged_attention.py:565",
             launches=launches["paged_decode_attention"],
             max_abs_err=k1_err, **k1),
        dict(name="write_kv_pages_prefill", route="cuda",
             source="aphrodite_tpu_torch/csrc/kv_write.cu",
             replaces="aphrodite_tpu/ops/pallas/kv_write.py:179",
             launches=launches["write_kv_pages_prefill"], max_abs_err=0.0,
             **k2),
        dict(name="write_kv_pages", route="cuda",
             source="aphrodite_tpu_torch/csrc/kv_write.cu",
             replaces="aphrodite_tpu/ops/pallas/kv_write.py:38",
             launches=launches["write_kv_pages"], max_abs_err=0.0, **k4),
    ]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in entries]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
