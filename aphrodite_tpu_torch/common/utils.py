"""Small shared utilities (reference: aphrodite/common/utils.py).

`Counter` and `LRUCache` mirror the reference semantics
(`common/utils.py:35,49`); the device probe asks torch for a CUDA card.
"""
from __future__ import annotations

import socket
import uuid
from collections import OrderedDict
from typing import Generic, Hashable, Optional, TypeVar

T = TypeVar("T")


class Counter:
    """Monotonic integer id generator."""

    def __init__(self, start: int = 0) -> None:
        self.counter = start

    def __next__(self) -> int:
        value = self.counter
        self.counter += 1
        return value

    def reset(self) -> None:
        self.counter = 0


class LRUCache(Generic[T]):
    """LRU cache with a pluggable eviction hook (`_on_remove`)."""

    def __init__(self, capacity: int) -> None:
        self.cache: OrderedDict[Hashable, T] = OrderedDict()
        self.capacity = capacity

    def __contains__(self, key: Hashable) -> bool:
        return key in self.cache

    def __len__(self) -> int:
        return len(self.cache)

    def __getitem__(self, key: Hashable) -> Optional[T]:
        return self.get(key)

    def __setitem__(self, key: Hashable, value: T) -> None:
        self.put(key, value)

    def __delitem__(self, key: Hashable) -> None:
        self.remove(key)

    def touch(self, key: Hashable) -> None:
        self.cache.move_to_end(key)

    def get(self, key: Hashable,
            default_value: Optional[T] = None) -> Optional[T]:
        if key in self.cache:
            value = self.cache[key]
            self.cache.move_to_end(key)
            return value
        return default_value

    def put(self, key: Hashable, value: T) -> None:
        self.cache[key] = value
        self.cache.move_to_end(key)
        self._remove_old_if_needed()

    def _on_remove(self, key: Hashable, value: T) -> None:
        pass

    def remove_oldest(self) -> None:
        if not self.cache:
            return
        key, value = self.cache.popitem(last=False)
        self._on_remove(key, value)

    def _remove_old_if_needed(self) -> None:
        while len(self.cache) > self.capacity:
            self.remove_oldest()

    def remove(self, key: Hashable) -> None:
        if key not in self.cache:
            raise KeyError(key)
        value = self.cache.pop(key)
        self._on_remove(key, value)

    def clear(self) -> None:
        while self.cache:
            self.remove_oldest()


def random_uuid() -> str:
    return str(uuid.uuid4().hex)


def get_open_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def cdiv(a: int, b: int) -> int:
    return -(a // -b)


def pad_to_multiple(x: int, multiple: int) -> int:
    return cdiv(x, multiple) * multiple


def in_wsl() -> bool:
    return False


def get_device_platform() -> str:
    """Return the torch device platform: 'cuda' when a card is visible,
    else 'cpu'."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def is_cuda() -> bool:
    return get_device_platform() == "cuda"
