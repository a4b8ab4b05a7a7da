#!/usr/bin/env python3
"""chip_smoke's phase 21 (the quantized fallback route) alone, on one
CUDA card: the quick loop for work on the dequantize-then-matmul route of
the GPTQ, AWQ, GGUF, SqueezeLLM, int8 and QuIP# linear methods.

    python3 aphrodite_tpu_torch/tools/fallback_phase.py [--only a,b,c,d,e]

Builds the kernels (as chip_smoke does), then runs this checkout's
`chip_smoke.run_fallback_phase`: (a) the three fallback arms (GPTQ
4-bit group 32 act-order, GPTQ 2-bit, AWQ group 64) at Mistral-7B's
projections against float64, with controls, timed beside the kernel
route and torch.matmul; (b) act-order GPTQ at Mistral-7B width and
depth through phase 4's mix, profiled; (c) the kernel and fallback
routes' teacher-forced logits on a 2-layer full-width GPTQ model; (d)
Qwen2-7B-AWQ through the mix (gate_up on the kernels, the rest on the
fallback), profiled; (e) the other formats' gated shapes and float32 on
the card against the CPU. `--only` picks parts (default all). Prints the
card's name and power limit first and each part's seconds last.
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
        if "--only" in args else "abcde"
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("fallback_phase: no CUDA card visible", file=sys.stderr)
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
    t0 = time.perf_counter()
    build.build_all()
    smoke.log(f"build: {time.perf_counter() - t0:.1f} s")
    by_path, seconds = smoke.run_fallback_phase(torch, build.COUNTERS, card,
                                                only)
    smoke.log("launches by path: " + json.dumps(
        {p: {k: n for k, n in v.items() if n} for p, v in by_path.items()}))
    smoke.log(f"seconds: {json.dumps(seconds)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
