#!/usr/bin/env python3
"""The KV page writers' kernel times (K2, the prompt page writer, and K3 /
K4, the slot writer) in checkouts of the repository, on one CUDA card,
all taken with this checkout's `chip_smoke.Timer` (L2 flushed, the
stream held by a device spin until the call is enqueued, so the
wrapper's host time stays out; median of 20).

    python3 aphrodite_tpu_torch/tools/time_kv_write.py [--sweep]
        [--engine] [TREE ...]

Each TREE (default: this checkout) is a checkout of the repository, for
example an earlier commit unpacked with `git archive` into a directory
that .gitignore lists. Each is timed in a process of its own, with its
own package and kernels (built into TREE/build/kernels), on inputs made
from the same seed:

- an empty launch (`torch.cuda._sleep(0)`, the floor under a kernel
  that moves little);
- K2 at chip_smoke's cells (`chip_smoke.k2_problem`: phase 4's first
  prompt round, 256 cells of 32 rows, 88 live, 2728 rows, Mistral-7B's
  8 kv heads of 128 in bf16, a pool of 4096 pages), with `index_copy_`
  of the live rows, K and V, and its bound;
- K3 and K4 at `chip_smoke.slot_arms`' shapes (the window run's 2 rows
  and a 64-row decode round; phase 4's unaligned round; the same prompt
  round's 2728 rows as slots; its 8192 padded rows on bf16, int8 and fp8
  e5m2 pages, where an older tree runs its whole chain, the rows
  quantized by `quantize_kv` and then scattered; then, in a tree whose
  slot writer takes fp16 rows, K3's two shapes and the 8192 padded rows
  from fp16 rows into fp16, int8 and fp8 pages), each by
  `chip_smoke.time_slot_arm`: the wrapper, its plain version, the
  library call (`index_copy_`; on 8-bit pages none, and `index_copy_`
  of the codes as a floor), device launches a call and the bound.

With `--sweep`, each tree whose slot writer plans its slot-read order
(`kv_write.SLOT_FIRST_MIN_TOKENS`) also times both orders, pinned by
setting that threshold (`chip_smoke.slot_order`), on bf16 and int8
pages (from bf16 rows) and, where the tree takes them, on fp16 and int8
pages from fp16 rows, at 16-8192 tokens, every row live and one third live (each 1024
tokens, or each eighth of a shorter launch, live in its first third: a
padded prompt round), the plan's order beside them: where they cross
sets `SLOT_FIRST_MIN_TOKENS`. Other trees print "not pinnable".
With `--engine`, each tree serves chip_smoke's Mistral-7B-width model
with int8, then fp8 KV pages and profiles a prompt round of 4 x 512
tokens (`chip_smoke.profile_kv8_prompt_round`: its device time and
launches, the slot writer's, K4's calls); about a minute a tree.

To compare two trees within one call give them as A B B A. Prints the
card's name and power limit, then one JSON object per tree and
measurement: {"tree", "kernel", "ms", ...}.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SWEEP_TOKENS = (16, 64, 128, 256, 512, 768, 1024, 1536, 2048, 4096, 8192)


def _emit(tree, kernel, ms, **extra):
    print(json.dumps({"tree": tree, "kernel": kernel, "ms": ms, **extra}),
          flush=True)


def time_writers(tree: str, torch, kw, smoke, timer) -> None:
    gen = torch.Generator(device="cuda").manual_seed(7)
    hd = smoke.HKV * smoke.HEAD_DIM
    num_pages = 4096
    kp, vp = (torch.randn(num_pages, 32, hd, generator=gen,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2))
    c = smoke.k2_problem(torch, gen, num_pages)
    k_flat, v_flat = kp.view(-1, hd), vp.view(-1, hd)
    src_k, src_v = c["knew"][c["live"]], c["vnew"][c["live"]]
    _emit(tree, "empty launch", timer(lambda: torch.cuda._sleep(0)))
    _emit(tree, "K2", timer(lambda: kw.write_kv_pages_prefill(
        c["knew"], c["vnew"], kp, vp, c["pid"], c["sblk"], c["vld"])),
        rows=c["rows"], cells=c["cells"],
        bound_ms=smoke.bound(smoke.k2_bound_bytes(c), 0)[0])
    _emit(tree, "index_copy_ of K2's live rows", timer(lambda: (
        k_flat.index_copy_(0, c["slots"], src_k),
        v_flat.index_copy_(0, c["slots"], src_v))))
    del kp, vp, k_flat, v_flat
    pages = smoke.slot_pages(torch, gen)
    fp16 = (torch.float16, torch.float16) in kw.SLOT_KINDS
    if not fp16:
        _emit(tree, "fp16 rows", None, note="not served")
    for arm in smoke.slot_arms(torch, gen, fp16=fp16):
        name, t = smoke.time_slot_arm(torch, kw, timer, arm, pages,
                                      num_pages * 32)
        _emit(tree, name, t.pop("ms"), **t)


def sweep_slot_order(tree: str, torch, kw, smoke, timer) -> None:
    if not hasattr(kw, "SLOT_FIRST_MIN_TOKENS"):
        _emit(tree, "slot-order sweep", None, note="not pinnable")
        return
    from aphrodite_tpu_torch.ops.kv_quant import quantize_kv
    gen = torch.Generator(device="cuda").manual_seed(8)
    hd, num_pages = 1024, 4096
    num_slots = num_pages * 32
    base = torch.randn(num_pages, 32, hd, generator=gen, device="cuda")
    rows = [torch.randn(max(SWEEP_TOKENS), hd, generator=gen,
                        device="cuda") for _ in range(2)]
    perm = torch.randperm(num_slots, generator=gen, device="cuda").to(
        torch.int32)
    sms = kw.build.sm_count("cuda")
    f16 = torch.float16
    pairs = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8)]
    if (f16, f16) in kw.SLOT_KINDS:
        pairs += [(f16, f16), (f16, torch.int8)]
    for src_dtype, page_dtype in pairs:
        kn, vn = (r.to(src_dtype) for r in rows)
        kp = quantize_kv(base, page_dtype, 0.05)
        vp = kp.clone()
        for n in SWEEP_TOKENS:
            seq = max(8, min(1024, n // 8))
            for layout in ("all live", "a third live"):
                slots = perm[:n].clone()
                if layout != "all live":
                    pos = torch.arange(n, device="cuda") % seq
                    slots[pos >= -(-seq // 3)] = num_slots
                times = {}
                for first in (False, True, None):
                    with smoke.slot_order(kw, first):
                        times[str(first)] = timer(
                            lambda: kw.write_kv_pages(kn[:n], vn[:n], kp,
                                                      vp, slots,
                                                      kv_scale=0.05))
                _emit(tree, f"slot order, {src_dtype} rows, {page_dtype}",
                      None, tokens=n,
                      layout=layout, beside_ms=times["False"],
                      first_ms=times["True"], plan_ms=times["None"],
                      plan=list(kw.slot_write_plan(n, hd * 2, sms)))
        del kn, vn, kp, vp


def engine_rounds(tree: str, torch, smoke) -> None:
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    from aphrodite_tpu_torch.ops.cuda import build
    model_dir = os.path.join(os.path.abspath(tree), "build",
                             "time_kv_write_model")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(smoke.MISTRAL_7B, f)
    for kv_dtype in ("int8", "fp8"):
        engine = AphroditeEngine.from_engine_args(EngineArgs(
            model=model_dir, load_format="dummy", dtype="bfloat16", seed=0,
            block_size=32, max_model_len=2048, skip_tokenizer_init=True,
            disable_log_stats=True, kv_cache_dtype=kv_dtype))
        r = smoke.profile_kv8_prompt_round(
            torch, engine, build.COUNTERS,
            smoke.MISTRAL_7B["num_hidden_layers"], f"{kv_dtype} KV ")
        _emit(tree, f"{kv_dtype} KV prompt round (4 x 512)",
              r.pop("device_ms"), **r)
        del engine
        smoke.free_engine(torch, f"{kv_dtype} KV")


def time_tree(tree: str, sweep: bool, engine: bool) -> None:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from aphrodite_tpu_torch.ops.cuda import kv_write as kw
    timer = smoke.Timer(torch)
    time_writers(tree, torch, kw, smoke, timer)
    if sweep:
        sweep_slot_order(tree, torch, kw, smoke, timer)
    if engine:
        engine_rounds(tree, torch, smoke)


def main() -> int:
    args = sys.argv[1:]
    flags = [a for a in args if a.startswith("-")]
    trees = [a for a in args if not a.startswith("-")]
    if flags[:1] == ["--one"]:
        time_tree(trees[0], "--sweep" in flags, "--engine" in flags)
        return 0
    if set(flags) - {"--sweep", "--engine"}:
        print(f"usage: {sys.argv[0]} [--sweep] [--engine] [TREE ...]",
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    for tree in trees or [HERE]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", *flags, tree]).returncode
        if rc:
            print(f"{tree}: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
