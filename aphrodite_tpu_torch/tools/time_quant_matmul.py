#!/usr/bin/env python3
"""The quantized matmuls' kernel time in checkouts of the repository,
on one CUDA card, all taken with this checkout's `chip_smoke.Timer` (L2
flushed, the stream held by a device spin until the call is enqueued, so
the wrapper's host time stays out; median of 20).

    python3 aphrodite_tpu_torch/tools/time_quant_matmul.py \\
        [--kernels K6,K7,K8,K9,K10,K11,K12,K13,K14,K15,K16,K16f32,K17] \\
        [--ptxas] [--routes] [TREE ...]

Each TREE (default: this checkout) is a checkout of the repository, for
example an earlier commit unpacked with `git archive` into a directory
that .gitignore lists. Each is timed in a process of its own, with its
own package and kernels (built into TREE/build/kernels), on the same
inputs, at Mistral-7B's four projections and m 72, 128, 512 and 4096
(K7: m 1, 8, 16, 32 and 64; K12-K17 and K16f32: m 1, 8, 16, 17, 24,
32, 33, 64, 72, 128, 512 and 4096, both of their kernels; K9: m 1, 8,
16, 32, 64, 512 and 4096). Each tree first times an empty launch
(`torch.cuda._sleep(0)`) on the same timer, the floor under a kernel
that moves almost nothing (K9 at decode): {"tree", "kernel": "empty
launch", "ms"}.
- K7, the decode product at m <= 64, its four arms: `gptq_matmul` and
  `awq_matmul` with `stream=True` ("K7 gptq", "K7 awq"; GPTQ also at 8
  bits, "K7 gptq8", and at group_size -1, one group of K rows, "K7
  gptq_gK") and the a8 matmul alone on K9's rows of the same x ("K7
  gptq_a8", "K7 awq_a8", the launch the a8 wrappers make after K9), on
  `chip_smoke.quant_weights`; beside the a16 arms `torch.matmul` over
  the weight dequantized to bf16 beforehand (the a8 arms have no
  library call);
- K6 and K10: `gptq_matmul` and `awq_matmul` with `stream=False` on
  this checkout's `chip_smoke.quant_weights` (4-bit codes in groups of
  128) and bf16 x from a seed;
- K8 and K11: the GPTQ and AWQ W4A8 matmul alone on K9's rows of the
  same x (the launch `gptq_matmul_a8` and `awq_matmul_a8` make after K9,
  `stream=False`) on the same weights; beside them `torch._int_mm` on
  the same int8 shapes, as for K15;
- K9: `quantize_activations_int8` on each projection's x (bf16 [m, K]),
  its bound the bytes (x read, the int8 rows and the f32 row scales
  written) over 3.35 TB/s; no library call;
- K12, K16, K16f32 and K17: `gguf_q4k_matmul`, `squeezellm_matmul` on
  bf16 x, `squeezellm_matmul` on f32 x (QuIP#'s form) and `int8_matmul`
  on `chip_smoke.late_weights` (random Q4_K codes, dl and ml rows per 32
  rows; random 4-bit codes with an N(0, 0.02) bf16 codebook per column;
  codes over the 12 E8P values with `chip_smoke.quip_lut`'s f32 table;
  int8 codes with f32 column scales), K16f32's bound taking three bf16
  products a term and 4-byte x and y;
- K13 and K14: `gguf_q8_matmul` and `gguf_i8g_matmul` on
  `chip_smoke.gguf_weights` (codes in [-127, 127] with a scale row per
  32 rows; Q6_K-shaped codes with one per 16), each on the route the
  wrapper takes at that m;
- K15: `gguf_w8a8_launch` on K9's rows of the same x and
  `chip_smoke.gguf_weights` (a scale row per 128 rows), on the route
  the wrapper takes at that m; beside it `torch.matmul` over the weight
  dequantized to bf16 beforehand on the bf16 x (chip_smoke's library
  yardstick) and, at m > 16 (what it takes), `torch._int_mm` on the same
  int8 shapes (the weight in column-major order, copied before the
  timing), a floor for int8 tensor-core throughput on this card (no
  group scales).
- W4A8: not a kernel but the e2e prompt round those two serve, GPTQ
  and AWQ with APHRODITE_W4A8=1: chip_smoke's phase 9 and 11 engine
  (Mistral-7B width, dummy weights, this checkout's
  `chip_smoke.quant_model_dir`) on the tree's package, one round of 4 x
  512 tokens under torch.profiler (`chip_smoke.profile_prompt_round`):
  {"tree", "kernel", "device_ms", "quant_ms"}.
Beside K12, K13, K14, K16 and K17, `torch.matmul` over the same weight
dequantized to bf16 beforehand (K16f32: to f32, on the f32 x), K17's
column scales folded in (the library yardstick of chip_smoke's phases
13 and 16). `--kernels` picks some of them (default: K6, K10, K14 and
K15). To compare two trees within one call give them as A B B
A. Prints the card's name and power limit, then one JSON object per
tree, kernel, m and projection, {"tree", "kernel", "m", "proj", "ms"},
and one per tree, kernel and m with the sum over the four projections
(one layer) and its bound (chip_smoke's: the bytes over 3.35 TB/s or
the operations over the bf16 or int8 peak, whichever is larger),
{"tree", "kernel", "m", "layer_ms", "bound_ms"}. With `--routes`, K13,
K14, K15 and K17 (where `--kernels` names them) are also timed on each
route pinned, `quant_stream_kernel` (`stream=True`) and the 128-row
warpgroup-MMA kernel (`stream=False`; K15's `w8a8_gemm_kernel`), at m 8,
9, 12-17, 24 and 32, K15 also at 33 and 64 (their m list gains 9 and
12-15), the rows around the wrappers' thresholds (`Q8_STREAM_M_MAX`,
`I8G_STREAM_M_MAX`, `K15_STREAM_M_MAX`, `INT8_STREAM_M_MAX`):
{"tree", "kernel", "route", "m", "layer_ms"}, or {"tree", "kernel",
"route": "not pinnable"} for a tree whose wrapper takes no `stream`.
With `--ptxas`, each tree first prints one object per kernel instance
of its `csrc/*.cu` builds, {"tree", "source", "ptxas", "registers",
"spill_bytes"}: the instance by its demangled name without its
parameter list (c++filt, where the toolkit's machine has it), so that
two trees' reports compare by name; and each warning of those builds (a
wgmma serialization, C7515 / C7518), {"tree", "source",
"ptxas_warning"}.
"""
from __future__ import annotations

import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MS = (72, 128, 512, 4096)
K7_MS = (1, 8, 16, 32, 64)
K9_MS = (1, 8, 16, 32, 64, 512, 4096)
LATE_MS = (1, 8, 16, 17, 24, 32, 33, 64, 72, 128, 512, 4096)
ROUTE_MS = (8, 9, 12, 13, 14, 15, 16, 17, 24, 32)
K15_ROUTE_MS = ROUTE_MS + (33, 64)
ROUTED = ("K13", "K14", "K15", "K17")
K7_ARMS = ("gptq", "gptq8", "gptq_gK", "gptq_a8", "awq", "awq_a8")
KERNELS = ("K6", "K7", "K8", "K9", "K10", "K11", "K12", "K13", "K14",
           "K15", "K16", "K16f32", "K17", "W4A8")
LATE = {"K12": "gguf_q4k_matmul", "K16": "squeezellm_matmul",
        "K16f32": "squeezellm_matmul", "K17": "int8_matmul"}
GGUF = ("K13", "K14", "K15")
DEFAULT = ("K6", "K10", "K14", "K15")


def _instance(name: str) -> str:
    """A demangled kernel name without its return type and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def ptxas_report(tree: str, build) -> None:
    """Registers and spill bytes of every kernel entry of the tree's
    sources, from the `-Xptxas -v` reports of this process's builds."""
    build.build_all()
    for source in sorted(build.build_logs):
        _ptxas_source(tree, source, build.build_logs[source])


def _ptxas_source(tree: str, source: str, log: str) -> None:
    entries, name, spill = [], None, 0
    for line in log.splitlines():
        if "warning" in line.lower():
            print(json.dumps({"tree": tree, "source": source,
                              "ptxas_warning": line.strip()}), flush=True)
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name, spill = found.group(1), 0
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if found:
            spill = int(found.group(1)) + int(found.group(2))
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            entries.append((name, int(found.group(1)), spill))
            name = None
    if not entries:
        print(json.dumps({"tree": tree, "source": source,
                          "ptxas": "no report (cached library)"}),
              flush=True)
        return
    names = [e[0] for e in entries]
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    for shown, (_, regs, spills) in sorted(zip(map(_instance, names),
                                               entries)):
        print(json.dumps({"tree": tree, "source": source, "ptxas": shown,
                          "registers": regs, "spill_bytes": spills}),
              flush=True)


def time_k7(tree: str, torch, qmm, smoke, timer) -> None:
    """K7's four arms, per projection and per layer, with the library
    call and the bound (chip_smoke's phase 8 and 10 arithmetic)."""
    for arm in K7_ARMS:
        awq, a8 = arm.startswith("awq"), arm.endswith("a8")
        bits = 8 if arm == "gptq8" else 4
        layer = dict.fromkeys(K7_MS, 0.0)
        yard = dict.fromkeys(K7_MS, 0.0)
        bound = dict.fromkeys(K7_MS, 0.0)
        for seed, (proj, K, N) in enumerate(smoke.GPTQ_PROJ):
            gs = K if arm == "gptq_gK" else smoke.GPTQ_GS
            qw, qz, sc = smoke.quant_weights(torch, K, N, bits, 500 + seed,
                                             awq, gs)
            kw = dict(group_size=gs) if awq else \
                dict(bits=bits, group_size=-1 if gs == K else gs)
            w16 = None if a8 else (qmm.dequantize_awq_plain if awq else
                                   qmm.dequantize_plain)(
                qw, qz, sc, dtype=torch.bfloat16, **kw)
            gen = torch.Generator(device="cuda").manual_seed(600 + seed)
            x_all = torch.randn(max(K7_MS), K, generator=gen,
                                device="cuda").to(torch.bfloat16)
            for m in K7_MS:
                x = x_all[:m]
                if a8:
                    x8, xs = qmm.quantize_activations_int8(x)
                    counter = getattr(qmm, f"{'AWQ' if awq else 'GPTQ'}"
                                      "_MATMUL_STREAM_A8_LAUNCHES")
                    ms = timer(lambda: qmm._launch(
                        True, x8, xs, qw, qz, sc, bits=4,
                        gs=gs, stream=True, counter=counter,
                        what="K7 a8", awq=awq))
                    x_bytes = m * K + m * 4
                    rate = smoke.INT8_OPS_PER_S
                else:
                    fn = qmm.awq_matmul if awq else qmm.gptq_matmul
                    ms = timer(lambda: fn(x, qw, qz, sc, stream=True, **kw))
                    yard[m] += timer(lambda: torch.matmul(x, w16))
                    x_bytes = m * K * 2
                    rate = smoke.BF16_FLOPS_PER_S
                nbytes = x_bytes + smoke.weight_bytes(K, N, bits, gs) + \
                    m * N * 2
                bound[m] += max(nbytes / smoke.HBM_BYTES_PER_S,
                                2 * m * K * N / rate) * 1e3
                layer[m] += ms
                print(json.dumps({"tree": tree, "kernel": f"K7 {arm}",
                                  "m": m, "proj": proj, "ms": ms}),
                      flush=True)
            del qw, qz, sc, w16, x_all
            torch.cuda.empty_cache()
        for m in K7_MS:
            print(json.dumps({"tree": tree, "kernel": f"K7 {arm}", "m": m,
                              "layer_ms": layer[m], "bound_ms": bound[m]}),
                  flush=True)
            if not a8:
                print(json.dumps({"tree": tree, "kernel": "torch.matmul "
                                  f"over K7 {arm}'s weight in bf16",
                                  "m": m, "layer_ms": yard[m]}), flush=True)


def time_k9(tree: str, torch, qmm, smoke, timer) -> None:
    """K9 per projection and per layer (the four projections' x, as
    the W4A8 arms quantize them) beside its bytes bound."""
    layer = dict.fromkeys(K9_MS, 0.0)
    bound = dict.fromkeys(K9_MS, 0.0)
    for seed, (proj, K, _) in enumerate(smoke.GPTQ_PROJ):
        gen = torch.Generator(device="cuda").manual_seed(700 + seed)
        x_all = torch.randn(max(K9_MS), K, generator=gen,
                            device="cuda").to(torch.bfloat16)
        for m in K9_MS:
            x = x_all[:m]
            ms = timer(lambda: qmm.quantize_activations_int8(x))
            layer[m] += ms
            bound[m] += (m * K * 2 + m * K + m * 4) / \
                smoke.HBM_BYTES_PER_S * 1e3
            print(json.dumps({"tree": tree, "kernel": "K9", "m": m,
                              "proj": proj, "ms": ms}), flush=True)
        del x_all
    for m in K9_MS:
        print(json.dumps({"tree": tree, "kernel": "K9", "m": m,
                          "layer_ms": layer[m], "bound_ms": bound[m]}),
              flush=True)


def time_prompt_rounds(tree: str, torch, smoke) -> None:
    """The GPTQ and AWQ W4A8 prompt round (K9 + K8 or K11 at 2048 rows)
    on chip_smoke's e2e engine, the tree's package serving it."""
    import gc
    from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    os.environ["APHRODITE_W4A8"] = "1"
    for awq in (False, True):
        engine = AphroditeEngine.from_engine_args(EngineArgs(
            model=smoke.quant_model_dir(awq), load_format="dummy",
            dtype="bfloat16", seed=0, block_size=32, max_model_len=2048,
            skip_tokenizer_init=True, disable_log_stats=True))
        fmt = "AWQ" if awq else "GPTQ"
        # quant_mma_kernel: K8 / K11 in trees before w8a8_gemm_kernel
        # took them.
        dev_ms, quant_ms = smoke.profile_prompt_round(
            torch, engine, f"{tree} {fmt} W4A8 ",
            smoke.QUANT_KERNEL_NAMES + ("quant_mma_kernel",))
        print(json.dumps({"tree": tree, "kernel": f"{fmt} W4A8 prompt "
                          "round", "device_ms": dev_ms,
                          "quant_ms": quant_ms}), flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    os.environ.pop("APHRODITE_W4A8")


def time_tree(tree: str, kernels, ptxas: bool = False,
              routes: bool = False) -> None:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timer", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from aphrodite_tpu_torch.ops.cuda import quant_matmul as qmm
    if ptxas:
        ptxas_report(tree, qmm.build)
    timer = smoke.Timer(torch)
    print(json.dumps({"tree": tree, "kernel": "empty launch",
                      "ms": timer(lambda: torch.cuda._sleep(0))}),
          flush=True)

    def emit(kernel, layer, bound=None):
        for m in layer:
            rec = {"tree": tree, "kernel": kernel, "m": m,
                   "layer_ms": layer[m]}
            if bound is not None:
                rec["bound_ms"] = bound[m]
            print(json.dumps(rec), flush=True)

    pinned = {}       # (kernel, route) -> {m: layer ms}
    for kernel in kernels:
        if kernel == "K7":
            time_k7(tree, torch, qmm, smoke, timer)
            continue
        if kernel == "W4A8":
            time_prompt_rounds(tree, torch, smoke)
            continue
        if kernel == "K9":
            time_k9(tree, torch, qmm, smoke, timer)
            continue
        ms_list = LATE_MS if kernel in LATE or kernel in GGUF else MS
        route_ms = K15_ROUTE_MS if kernel == "K15" else ROUTE_MS
        if routes and kernel in ROUTED:
            ms_list = tuple(sorted(set(ms_list) | set(route_ms)))
        f32 = kernel == "K16f32"
        layer = dict.fromkeys(ms_list, 0.0)
        yard = dict.fromkeys(ms_list, 0.0)
        int_mm = dict.fromkeys(ms_list, 0.0)   # K15's torch._int_mm
        t_bytes = dict.fromkeys(ms_list, 0.0)  # the bound's two terms
        t_ops = dict.fromkeys(ms_list, 0.0)
        for seed, (proj, K, N) in enumerate(smoke.GPTQ_PROJ):
            key = kernel.lower()
            w16 = None
            if kernel in ("K6", "K10"):
                awq = kernel == "K10"
                w = smoke.quant_weights(torch, K, N, 4, 300 + seed, awq)
                kw = dict(group_size=smoke.GPTQ_GS) if awq else \
                    dict(bits=4, group_size=smoke.GPTQ_GS)
                fn = qmm.awq_matmul if awq else qmm.gptq_matmul
                w_bytes = smoke.weight_bytes(K, N, 4)
            elif kernel in ("K8", "K11"):
                awq = kernel == "K11"
                w = smoke.quant_weights(torch, K, N, 4, 300 + seed, awq)
                counter = qmm.AWQ_MATMUL_A8_LAUNCHES if awq else \
                    qmm.GPTQ_MATMUL_A8_LAUNCHES
                w_bytes = smoke.weight_bytes(K, N, 4)
                # _int_mm's operand: int8 [K, N] in column-major order.
                w_cm = torch.randint(-16, 15, (N, K), dtype=torch.int8,
                                     device="cuda").t()
            elif kernel in LATE:
                w, w16 = smoke.late_weights(torch, qmm, key, K, N,
                                            seed * 10 + len(key))
                w_bytes = smoke.late_layer_bytes(key, K, N)
            else:
                G = smoke.GGUF_KERNELS[key][1]
                w = smoke.gguf_weights(torch, key, K, N, seed * 10 + G)
                w_bytes = smoke.gguf_layer_bytes(key, K, N)
                if kernel == "K15":
                    # _int_mm's operand in the layout cuBLAS takes
                    # without a copy (column-major), made before the
                    # timing.
                    w_cm = w[0].t().contiguous().t()
                w16 = (w[0].float() * w[1].float().repeat_interleave(
                    G, dim=0)).to(torch.bfloat16)
            gen = torch.Generator(device="cuda").manual_seed(400 + seed)
            x_all = torch.randn(max(ms_list), K, generator=gen,
                                device="cuda")
            if not f32:
                x_all = x_all.to(torch.bfloat16)
            for m in ms_list:
                x = x_all[:m]
                ops = 2 * m * K * N * (3 if f32 else 1)
                if kernel in ("K6", "K10"):
                    ms = timer(lambda: fn(x, *w, stream=False, **kw))
                elif kernel in ("K8", "K11"):
                    x8, xs = qmm.quantize_activations_int8(x)
                    ms = timer(lambda: qmm._launch(
                        True, x8, xs, *w, bits=4, gs=smoke.GPTQ_GS,
                        stream=False, counter=counter, what=kernel,
                        awq=awq))
                    yard[m] += timer(lambda: torch._int_mm(x8, w_cm))
                elif kernel == "K15":
                    x8, xs = qmm.quantize_activations_int8(x)
                    fn, args = qmm.gguf_w8a8_launch, (x8, xs, *w)
                    ms = timer(lambda: fn(*args))
                    yard[m] += timer(lambda: torch.matmul(x, w16))
                    if m > 16:        # torch._int_mm takes more rows
                        int_mm[m] += timer(lambda: torch._int_mm(x8, w_cm))
                else:
                    fn = getattr(qmm, LATE.get(kernel) or {
                        "K13": "gguf_q8_matmul",
                        "K14": "gguf_i8g_matmul"}[kernel])
                    args = (x, *w)
                    ms = timer(lambda: fn(*args))
                    yard[m] += timer(lambda: torch.matmul(x, w16))
                if routes and kernel in ROUTED and m in route_ms and \
                        "stream" in inspect.signature(fn).parameters:
                    for route, pin in (("stream", True), ("gemm", False)):
                        rec = pinned.setdefault((kernel, route), {})
                        rec[m] = rec.get(m, 0.0) + timer(
                            lambda: fn(*args, stream=pin))
                int8 = kernel in ("K8", "K11", "K15")
                size = 4 if f32 else 2
                x_bytes = m * K + m * 4 if int8 else m * K * size
                t_bytes[m] += (x_bytes + w_bytes + m * N * size) / \
                    smoke.HBM_BYTES_PER_S * 1e3
                t_ops[m] += ops / (smoke.INT8_OPS_PER_S if int8
                                   else smoke.BF16_FLOPS_PER_S) * 1e3
                layer[m] += ms
                print(json.dumps({"tree": tree, "kernel": kernel, "m": m,
                                  "proj": proj, "ms": ms}), flush=True)
            del w, w16, x_all
            if kernel in ("K8", "K11", "K15"):
                del w_cm
            torch.cuda.empty_cache()
        emit(kernel, layer,
             {m: max(t_bytes[m], t_ops[m]) for m in ms_list})
        if kernel in ("K8", "K11", "K15"):
            emit(f"torch._int_mm on {kernel}'s int8 shapes",
                 {m: v for m, v in (int_mm if kernel == "K15" else
                                    yard).items() if m > 16})
        if kernel not in ("K6", "K8", "K10", "K11"):
            emit(f"torch.matmul over {kernel}'s weight in "
                 f"{'f32' if f32 else 'bf16'}", yard)
        if routes and kernel in ROUTED:
            if (kernel, "stream") not in pinned:
                print(json.dumps({"tree": tree, "kernel": kernel,
                                  "route": "not pinnable"}), flush=True)
            for route in ("stream", "gemm"):
                for m, ms in pinned.get((kernel, route), {}).items():
                    print(json.dumps({"tree": tree, "kernel": kernel,
                                      "route": route, "m": m,
                                      "layer_ms": ms}), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"] and len(args) == 4:
        flags = args[2].split(",")
        time_tree(args[3], [k for k in args[1].split(",") if k],
                  "ptxas" in flags, "routes" in flags)
        return 0
    kernels = DEFAULT
    if args[:1] == ["--kernels"] and len(args) >= 2:
        kernels = tuple(k for k in args[1].split(",") if k)
        args = args[2:]
    flags = []
    while args[:1] in (["--ptxas"], ["--routes"]):
        flags.append(args.pop(0)[2:])
    if any(a.startswith("-") for a in args) or \
            not set(kernels) <= set(KERNELS):
        print(f"usage: {sys.argv[0]} [--kernels {','.join(KERNELS)}] "
              "[--ptxas] [--routes] [TREE ...]", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    for tree in args or [HERE]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", ",".join(kernels),
                             ",".join(flags) or "-", tree]).returncode
        if rc:
            print(f"{tree}: exit {rc}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
