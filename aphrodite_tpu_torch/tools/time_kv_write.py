#!/usr/bin/env python3
"""K2's kernel time (the prompt page writer, `write_kv_pages_prefill`) in
checkouts of the repository, on one CUDA card, all taken with this
checkout's `chip_smoke.Timer` (L2 flushed, the stream held by a device
spin until the call is enqueued, so the wrapper's host time stays out;
median of 20).

    python3 aphrodite_tpu_torch/tools/time_kv_write.py [TREE ...]

Each TREE (default: this checkout) is a checkout of the repository, for
example an earlier commit unpacked with `git archive` into a directory
that .gitignore lists. Each is timed in a process of its own, with its
own package and kernels (built into TREE/build/kernels), on inputs made
from the same seed at chip_smoke's cells (`chip_smoke.k2_problem`:
phase 4's first prompt round, 256 cells of 32 rows, 88 live, 2728 rows,
Mistral-7B's 8 kv heads of 128 in bf16, a pool of 4096 pages). Beside
it, on the same timer: an empty launch (`torch.cuda._sleep(0)`, the
floor under a kernel that moves little) and the library call,
`index_copy_` of the live rows into their slots, K and V. To compare
two trees within one call give them as A B B A. Prints the card's name
and power limit, then one JSON object per tree and call: {"tree",
"kernel", "ms"}, K2's with "rows", "cells" and "bound_ms" (its bytes,
the live rows read and written once and the page ids and valids read,
over 3.35 TB/s).
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def time_tree(tree: str) -> None:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from aphrodite_tpu_torch.ops.cuda import kv_write as kw
    timer = smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(7)
    hd = smoke.HKV * smoke.HEAD_DIM
    num_pages = 4096
    kp, vp = (torch.randn(num_pages, 32, hd, generator=gen,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2))
    c = smoke.k2_problem(torch, gen, num_pages)
    k_flat, v_flat = kp.view(-1, hd), vp.view(-1, hd)
    src_k, src_v = c["knew"][c["live"]], c["vnew"][c["live"]]

    def emit(kernel, ms, **extra):
        print(json.dumps({"tree": tree, "kernel": kernel, "ms": ms,
                          **extra}), flush=True)
    emit("empty launch", timer(lambda: torch.cuda._sleep(0)))
    emit("K2", timer(lambda: kw.write_kv_pages_prefill(
        c["knew"], c["vnew"], kp, vp, c["pid"], c["sblk"], c["vld"])),
        rows=c["rows"], cells=c["cells"],
        bound_ms=smoke.bound(smoke.k2_bound_bytes(c), 0)[0])
    emit("index_copy_ of K2's live rows", timer(lambda: (
        k_flat.index_copy_(0, c["slots"], src_k),
        v_flat.index_copy_(0, c["slots"], src_v))))


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
