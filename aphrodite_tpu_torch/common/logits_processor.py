"""Host-side logits processors (reference: aphrodite/common/logits_processor.py).

Processors are callables `(output_token_ids, logits) -> logits` applied on
the host between device steps (logits come back as numpy arrays for the
sequences that requested processors; the common no-processor path never
leaves the device).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List

import numpy as np


class LogitsProcessor(ABC):

    @abstractmethod
    def __call__(self, output_tokens: List[int],
                 logits: np.ndarray) -> np.ndarray:
        """Return modified logits (may modify in place and return)."""


class BiasLogitsProcessor(LogitsProcessor):
    """OpenAI-style logit_bias: {token_id: bias in [-100, 100]}."""

    def __init__(self, biases: Dict[int, float]) -> None:
        super().__init__()
        self.biases = biases
        if biases:
            self._keys = np.array(list(biases.keys()), dtype=np.int64)
            self._values = np.array(list(biases.values()), dtype=np.float32)
        else:
            self._keys = None
            self._values = None

    def __call__(self, output_tokens: List[int],
                 logits: np.ndarray) -> np.ndarray:
        if self._keys is None:
            return logits
        logits[self._keys] += self._values
        return logits


class BanEOSUntil(LogitsProcessor):
    """Ban EOS until min_tokens generated (min_tokens + ignore_eos in one)."""

    def __init__(self, min_tokens: int, eos_token_id: int) -> None:
        super().__init__()
        self._min_tokens = min_tokens
        self._eos_token_id = eos_token_id

    def __call__(self, output_tokens: List[int],
                 logits: np.ndarray) -> np.ndarray:
        if len(output_tokens) < self._min_tokens:
            logits[self._eos_token_id] = -float("inf")
        return logits
