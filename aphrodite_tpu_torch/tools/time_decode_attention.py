#!/usr/bin/env python3
"""K1's and K5's kernel time in checkouts of the repository, on one
CUDA card, all taken with this checkout's `chip_smoke.Timer` (L2
flushed, the stream held by a device spin until the call is enqueued,
so the wrapper's host time stays out; median of 20).

    python3 aphrodite_tpu_torch/tools/time_decode_attention.py [TREE ...]

Each TREE (default: this checkout) is a checkout of the repository, for
example an earlier commit unpacked with `git archive` into a directory
that .gitignore lists. Each is timed in a process of its own, with its
own package and kernels (built into TREE/build/kernels), at chip_smoke's
shapes: batch 8 with the engine's decode contexts, 64 x 2047 and 8 x
1016, 32-token pages, fused write, on bf16, int8 and fp8 pages; K1 with
a work list, K5 (the padded grid) without one. Then the same on fp16
activations over fp16, int8 and fp8 pages (K1's fp16 instances), in a
tree whose wrapper takes them; another tree prints "not served". To
compare two trees within one call give them as A B B A. Prints the
card's name and power limit, then one JSON object per tree, kernel,
activation and page type and shape: {"tree", "kernel", "act", "page",
"shape", "ms"}.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SHAPES = (("B 8", [1016, 316, 80, 1016, 316, 80, 28, 28], 36),
          ("B 64 x 2047", [2047] * 64, 64),
          ("B 8 x 1016", [1016] * 8, 32))
PAGE_SIZE = 32


def time_tree(tree: str) -> None:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from aphrodite_tpu_torch.ops.cuda import paged_attention as pa
    from aphrodite_tpu_torch.ops.kv_quant import dequant_scale
    timer = smoke.Timer(torch)
    for act, page_dtype in ((a, p) for a in ("bfloat16", "float16")
                            for p in (getattr(torch, a), torch.int8,
                                      torch.float8_e5m2)):
        if getattr(torch, act) not in getattr(pa, "_ACT_CODE", {}):
            print(json.dumps({"tree": tree, "act": act,
                              "note": "not served"}), flush=True)
            break
        for shape, ctxs, pps in SHAPES:
            with smoke.activations(act):
                q, kp, vp, tb, ctx, sl, kn, vn = smoke.decode_problem(
                    torch, ctxs, PAGE_SIZE, pps, seed=99, fused=True,
                    page_dtype=page_dtype)
            ppc = pa.choose_pages_per_chunk(pps, PAGE_SIZE, len(ctxs))
            work = pa.build_decode_work_list(
                [-(-c // PAGE_SIZE) for c in ctxs], ppc)
            kw = dict(scale=smoke.HEAD_DIM ** -0.5,
                      kv_scale=dequant_scale(page_dtype, smoke.KV_SCALE),
                      pages_per_chunk=ppc)
            page = str(page_dtype).replace("torch.", "")
            for kernel, extra in (("K1", dict(work_items=work)),
                                  ("K5", {})):
                ms = timer(lambda: pa.paged_decode_attention(
                    q, kp, vp, tb, ctx, sl, kn, vn, **extra, **kw))
                print(json.dumps({"tree": tree, "kernel": kernel,
                                  "act": act, "page": page, "shape": shape,
                                  "ms": ms}), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"] and len(args) == 2:
        time_tree(args[1])
        return 0
    if any(a.startswith("-") for a in args):
        print(f"usage: {sys.argv[0]} [TREE ...]", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    for tree in args or [HERE]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree]).returncode
        if rc:
            print(f"{tree}: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
