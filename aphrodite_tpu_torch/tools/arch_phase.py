#!/usr/bin/env python3
"""chip_smoke's phases for the other architectures (3d and 20) alone, on
one CUDA card: the quick loop for work on the Qwen2, DeciLM, OPT, GPT-J,
GPT-NeoX and Phi models or on K1-K4 at their geometries.

    python3 aphrodite_tpu_torch/tools/arch_phase.py [--only k,a,b,c]

Builds the kernels (as chip_smoke does), then runs this checkout's
`chip_smoke` parts: (k) phase 3d, `check_arch_kernels` (K1-K4 at
Qwen2-7B's group 7, head_dim 80, 96 and 256, DeciLM's groups 8, 16 and
32: checked, with controls, and K1 timed); then phase 20 through
`run_arch_phase`: (a) the six families at full width against their plain
paths, each with a control, and through the mix; (b) Qwen2-7B whole,
with verify rounds and profiles; (c) GPTQ W4A16 over a 2-layer Qwen2.
`--only` picks parts (default all). Prints the card's name and power
limit first and each part's seconds last.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    args = sys.argv[1:]
    only = args[args.index("--only") + 1].replace(",", "") \
        if "--only" in args else "kabc"
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("arch_phase: no CUDA card visible", file=sys.stderr)
        return 1
    os.environ["APHRODITE_SPEC"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    smoke.log(f"card: {card}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}")
    from aphrodite_tpu_torch.ops.cuda import build
    from aphrodite_tpu_torch.ops.cuda import kv_write as kw
    from aphrodite_tpu_torch.ops.cuda import paged_attention as pa
    t0 = time.perf_counter()
    build.build_all()
    smoke.log(f"build: {time.perf_counter() - t0:.1f} s")
    seconds = {}
    if "k" in only:
        t0 = time.perf_counter()
        smoke.check_arch_kernels(torch, pa, kw, smoke.Timer(torch))
        seconds["k"] = round(time.perf_counter() - t0, 1)
    parts = only.replace("k", "")
    if parts:
        by_path, more = smoke.run_arch_phase(torch, build.COUNTERS, card,
                                             parts)
        seconds.update(more)
        smoke.log("launches by path: " + json.dumps(
            {p: {k: n for k, n in v.items() if n}
             for p, v in by_path.items()}))
    smoke.log(f"seconds: {json.dumps(seconds)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
