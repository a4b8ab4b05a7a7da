"""Model-path resolution (port of the JAX package's
`modeling/hf_loader.py`: `resolve_model_path` and its file lock, copied
with their import paths rewritten).

A local directory or file passes through untouched, and nothing of a
hub package is imported for it. Any other string is a model id,
downloaded once under a per-repo lock at
`$APHRODITE_CACHE/<org--name>.lock`, through ModelScope under
`APHRODITE_USE_MODELSCOPE`, else through `huggingface_hub`. Both
`transformers_utils.config.get_config` and the loader's weight iterator
resolve the model through here; the served model name stays the string
the caller gave.
"""
from __future__ import annotations

import os


def resolve_model_path(model_path: str) -> str:
    """Local dirs/files pass through; anything else resolves via the HF
    hub cache with a per-repo file lock so concurrent server replicas
    download once (reference `hf_downloader.py:89-107` lock +
    snapshot_download)."""
    if os.path.isdir(model_path) or os.path.isfile(model_path):
        return model_path
    from aphrodite_tpu_torch.common import flags
    lock_dir = flags.get_str(
        "APHRODITE_CACHE",
        default=os.path.expanduser("~/.cache/aphrodite"))
    os.makedirs(lock_dir, exist_ok=True)
    lock_path = os.path.join(
        lock_dir, model_path.replace("/", "--") + ".lock")
    if flags.get_bool("APHRODITE_USE_MODELSCOPE"):
        # Reference hf_downloader.py:30-41: ModelScope replaces the HF
        # hub when requested. Same lock: replicas download once.
        try:
            from modelscope.hub.snapshot_download import (
                snapshot_download as ms_snapshot_download)
        except ImportError as e:
            raise ImportError(
                "APHRODITE_USE_MODELSCOPE is set but the modelscope "
                "package is not installed") from e
        with _file_lock(lock_path):
            return ms_snapshot_download(model_path)
    from huggingface_hub import snapshot_download
    with _file_lock(lock_path):
        return snapshot_download(
            model_path,
            allow_patterns=["*.safetensors", "*.bin", "*.json", "*.model",
                            "*.txt"])


class _file_lock:
    """Minimal advisory flock (the reference uses the `filelock`
    package; fcntl avoids the dependency)."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._fd = None

    def __enter__(self):
        import fcntl
        self._fd = open(self._path, "w")
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        import fcntl
        fcntl.flock(self._fd, fcntl.LOCK_UN)
        self._fd.close()
