#!/usr/bin/env python3
"""chip_smoke's mixture-of-experts phase (19) alone, on one CUDA card:
the quick loop for work on `modeling/layers/fused_moe.py`, the MoE
models or K1-K4 at DeepSeek-MoE-16B's attention geometry.

    python3 aphrodite_tpu_torch/tools/moe_phase.py [--only a,b,c,d]

Builds the kernels (as chip_smoke does), then runs this checkout's
`chip_smoke.run_moe_phase`: (a) `check_moe_kernels` (K1-K4 at Hq 16 / Hkv
16, checked and timed), (b) `check_moe_two_layer` (2-layer Mixtral and
DeepSeek models against their plain paths, with the rolled-experts
control), (c) `run_moe_engine` over DeepSeek-MoE-16B whole (the mix at
multi_step 1 and 8, with oracle-drafted verify rounds, then the
profiles of (e)) and (d) over Mixtral-8x7B at 4 of its 32 layers.
`--only` picks phases (default all). Prints the card's name and power
limit first and each phase's seconds last. About 3 minutes, builds
included, on an NVIDIA H100.
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
        if "--only" in args else "abcd"
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("moe_phase: no CUDA card visible", file=sys.stderr)
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
    by_path, seconds = smoke.run_moe_phase(
        torch, pa, kw, smoke.Timer(torch), build.COUNTERS, card, only)
    smoke.log("launches by path: " + json.dumps(
        {p: {k: n for k, n in v.items() if n} for p, v in by_path.items()}))
    smoke.log(f"seconds: {json.dumps(seconds)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
