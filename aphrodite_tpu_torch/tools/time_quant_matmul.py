#!/usr/bin/env python3
"""K6 and K10's kernel time in checkouts of the repository, on one CUDA
card, all taken with this checkout's `chip_smoke.Timer` (L2 flushed, the
stream held by a device spin until the call is enqueued, so the
wrapper's host time stays out; median of 20).

    python3 aphrodite_tpu_torch/tools/time_quant_matmul.py [TREE ...]

Each TREE (default: this checkout) is a checkout of the repository, for
example an earlier commit unpacked with `git archive` into a directory
that .gitignore lists. Each is timed in a process of its own, with its
own package and kernels (built into TREE/build/kernels), on the same
inputs (this checkout's `chip_smoke.quant_weights`, 4-bit codes in
groups of 128, bf16 x from a seed): `gptq_matmul` (K6) and `awq_matmul`
(K10) with `stream=False`, at Mistral-7B's four projections and m 72,
128, 512 and 4096. To compare two trees within one call give them as
A B B A. Prints the card's name and power limit, then one JSON object
per tree, kernel, m and projection, {"tree", "kernel", "m", "proj",
"ms"}, and one per tree, kernel and m with the sum over the four
projections (one layer), {"tree", "kernel", "m", "layer_ms"}.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MS = (72, 128, 512, 4096)


def time_tree(tree: str) -> None:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm
    timer = smoke.Timer(torch)
    gs = smoke.GPTQ_GS
    for kernel, awq in (("K6", False), ("K10", True)):
        fn = qmm.awq_matmul if awq else qmm.gptq_matmul
        kw = dict(group_size=gs) if awq else dict(bits=4, group_size=gs)
        layer = dict.fromkeys(MS, 0.0)
        for seed, (proj, K, N) in enumerate(smoke.GPTQ_PROJ):
            qw, qz, sc = smoke.quant_weights(torch, K, N, 4, 300 + seed, awq)
            gen = torch.Generator(device="cuda").manual_seed(400 + seed)
            x_all = torch.randn(max(MS), K, generator=gen,
                                device="cuda").to(torch.bfloat16)
            for m in MS:
                x = x_all[:m]
                ms = timer(lambda: fn(x, qw, qz, sc, stream=False, **kw))
                layer[m] += ms
                print(json.dumps({"tree": tree, "kernel": kernel, "m": m,
                                  "proj": proj, "ms": ms}), flush=True)
            del qw, qz, sc, x_all
            torch.cuda.empty_cache()
        for m in MS:
            print(json.dumps({"tree": tree, "kernel": kernel, "m": m,
                              "layer_ms": layer[m]}), flush=True)


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
