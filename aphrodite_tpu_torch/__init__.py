"""aphrodite_tpu_torch: the PyTorch / CUDA port of aphrodite_tpu for one
NVIDIA H100.

The JAX package `aphrodite_tpu` stays beside it as the reference; this
package imports nothing of it (nor of JAX). Host-side engine modules are
copies of the JAX package's with their import paths rewritten; the
device side is PyTorch, with hand-written Hopper kernels (`csrc/`) for
what the JAX package wrote in Pallas.
"""

__version__ = "0.1.0"

from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.outputs import CompletionOutput, RequestOutput

__all__ = [
    "SamplingParams",
    "CompletionOutput",
    "RequestOutput",
    "__version__",
]


def __getattr__(name):
    # Lazy imports so `import aphrodite_tpu_torch` stays cheap.
    if name == "LLM":
        from aphrodite_tpu_torch.endpoints.llm import LLM
        return LLM
    if name == "EngineArgs":
        from aphrodite_tpu_torch.engine.args_tools import EngineArgs
        return EngineArgs
    if name == "AphroditeEngine":
        from aphrodite_tpu_torch.engine.aphrodite_engine import (
            AphroditeEngine)
        return AphroditeEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
