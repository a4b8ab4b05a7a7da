"""Build the port's CUDA kernels at first use and load them with ctypes.

Every `*.cu` file under `aphrodite_tpu_torch/csrc/` is one kernel source
with a plain C interface. At first use all of them are compiled at once,
one `nvcc` process per source running side by side, each into its own
shared library under `build/kernels/` at the repository root (a
directory `.gitignore` lists):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here
runs at import: the CPU tests import every module, and the build needs
`nvcc` and a CUDA card.

Each C entry point returns `cudaGetLastError()` after its launch; the
wrappers raise `KernelLaunchError` when that is not 0. Pointers go in as
`ctypes.c_void_p` and the stream as
`torch.cuda.current_stream().cuda_stream`.

Every wrapper also owns a `LaunchCounter`: one is added where the
wrapper launches its kernel and nowhere else, so a run can show which
kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(_CSRC))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's standard error per source from the last build (the `-Xptxas -v`
#: register / shared-memory / spill report), empty for cached libraries.
build_logs: Dict[str, str] = {}


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused (cudaGetLastError() != 0)."""


class LaunchCounter:
    """Launches of one kernel: one per launch by its wrapper."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    """The process-wide counter of kernel `name` (created once)."""
    return COUNTERS.setdefault(name, LaunchCounter(name))


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(_CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit.")


def _target(name: str) -> str:
    with open(os.path.join(_CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns {name: library path}; raises with nvcc's output when a build
    fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {name: _target(name) for name in sources()}
    procs = {}
    for name, target in targets.items():
        if os.path.isfile(target):
            build_logs.setdefault(name, "")
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all sources at
    the first call."""
    with _lock:
        if name not in _libs:
            for lib_name, path in build_all().items():
                if lib_name not in _libs:
                    _libs[lib_name] = ctypes.CDLL(path)
        return _libs[name]


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise KernelLaunchError(
            f"{kernel}: launch failed with cudaError {err}")


def on_cuda(*tensors) -> bool:
    """True when every tensor (None skipped) is on one CUDA device,
    False when all are on the CPU; a mix raises. The wrappers launch
    their kernel for the first and run the plain version for the
    second."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) == 1:
        return True
    raise ValueError(f"tensors on mixed devices: {sorted(map(str, devs))}")


def stream_of(tensor) -> Optional[int]:
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


def ptr(tensor) -> Optional[int]:
    return None if tensor is None else tensor.data_ptr()
