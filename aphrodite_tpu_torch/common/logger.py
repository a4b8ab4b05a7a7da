"""Logging setup (reference: aphrodite/common/logger.py).

Plain stdlib logging with a compact format; no colorlog dependency.
"""
import logging
import sys

from aphrodite_tpu_torch.common import flags

_FORMAT = "%(levelname)s %(asctime)s [%(name)s] %(message)s"
_DATEFMT = "%H:%M:%S"

_root_configured = False


def _configure_root() -> None:
    global _root_configured
    if _root_configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    root = logging.getLogger("aphrodite_tpu_torch")
    root.addHandler(handler)
    # Registry-validated (warn-and-default INFO on a bad level — a
    # typo'd env var must not break logging setup at first import).
    root.setLevel(flags.get_str("APHRODITE_TPU_LOG_LEVEL"))
    root.propagate = False
    _root_configured = True


def init_logger(name: str) -> logging.Logger:
    _configure_root()
    return logging.getLogger(name if name.startswith("aphrodite_tpu_torch")
                             else f"aphrodite_tpu_torch.{name}")
