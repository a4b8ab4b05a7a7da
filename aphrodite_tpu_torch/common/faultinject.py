"""Deterministic fault-injection harness for the engine supervision
layer.

Named injection points sit on the engine's failure-relevant seams:

    engine.step               AphroditeEngine.step (round entry)
    scheduler.schedule        Scheduler.schedule (before any mutation)
    block_manager.allocate    BlockSpaceManager.allocate (admission)
    executor.execute_model    TPUExecutor._pre_step (every device round)
    tokenizer.decode          AphroditeEngine._decode_sequence (per seq)

Each point calls :func:`fire`, which is a no-op unless the
``APHRODITE_FAULT`` flag is set. The spec grammar is

    APHRODITE_FAULT=point:kind:prob:count[,point:kind:prob:count...]

- ``point``: one of :data:`POINTS`.
- ``kind``: ``transient`` (the supervised loop retries the step),
  ``request`` (aborts only the culprit request's stream), or
  ``fatal`` (moves the engine to the terminal DEAD state).
- ``prob``: per-hit firing probability in [0, 1]. Draws come from a
  per-rule ``random.Random`` seeded by ``APHRODITE_FAULT_SEED`` and
  the rule's position, so a given (spec, seed) pair replays the exact
  same fault schedule — chaos runs are reproducible.
- ``count``: maximum number of fires for the rule (0 = unlimited). A
  ``transient`` rule with ``prob=1`` and ``count=2`` fails the first
  two hits and then recovers — the canonical retry test.

The harness is compiled out when unset: ``fire`` reads the flag per
call (one env lookup) and returns immediately, so production serving
pays nothing. Malformed spec entries warn once and are skipped — a
typo'd chaos spec must never take down a real deployment.

State is process-global and keyed by the (spec, seed) pair; changing
either re-parses and resets the fired counters. Tests that reuse one
spec across cases call :func:`reset` between them.
"""
from __future__ import annotations

import dataclasses
import random
import warnings
import zlib
from typing import Dict, List, Optional

from aphrodite_tpu_torch.common import flags

#: Every legal injection-point name (spec entries naming anything else
#: warn and are ignored).
POINTS = (
    "engine.step",
    "scheduler.schedule",
    "block_manager.allocate",
    "executor.execute_model",
    "tokenizer.decode",
)

KINDS = ("transient", "request", "fatal")


class InjectedFault(Exception):
    """Base class for injected faults; `kind` drives classification."""

    kind = "fatal"

    def __init__(self, point: str, detail: str = "") -> None:
        self.point = point
        self.detail = detail
        msg = f"injected {self.kind} fault at {point}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class InjectedTransientFault(InjectedFault):
    """Engine-scoped but recoverable: the supervised loop retries."""
    kind = "transient"


class InjectedRequestFault(InjectedFault):
    """Request-scoped: only the culprit request's stream errors."""
    kind = "request"


class InjectedFatalFault(InjectedFault):
    """Unrecoverable: the engine moves to the terminal DEAD state."""
    kind = "fatal"


_KIND_TO_EXC = {
    "transient": InjectedTransientFault,
    "request": InjectedRequestFault,
    "fatal": InjectedFatalFault,
}


@dataclasses.dataclass
class _Rule:
    point: str
    kind: str
    prob: float
    count: int           # 0 = unlimited
    rng: random.Random
    fired: int = 0


class _State:
    """Parsed spec + per-rule fired counters for one (spec, seed)."""

    def __init__(self, spec: str, seed: int) -> None:
        self.spec = spec
        self.seed = seed
        self.rules: List[_Rule] = []
        for i, entry in enumerate(s for s in spec.split(",") if s.strip()):
            rule = _parse_entry(entry.strip(), seed, i)
            if rule is not None:
                self.rules.append(rule)


def _parse_entry(entry: str, seed: int, index: int) -> Optional[_Rule]:
    parts = entry.split(":")
    if len(parts) != 4:
        warnings.warn(
            f"APHRODITE_FAULT entry {entry!r} is not "
            "point:kind:prob:count; skipping it", RuntimeWarning,
            stacklevel=4)
        return None
    point, kind, prob_s, count_s = parts
    if point not in POINTS:
        warnings.warn(
            f"APHRODITE_FAULT names unknown point {point!r} "
            f"(known: {', '.join(POINTS)}); skipping it",
            RuntimeWarning, stacklevel=4)
        return None
    if kind not in KINDS:
        warnings.warn(
            f"APHRODITE_FAULT names unknown kind {kind!r} "
            f"(known: {', '.join(KINDS)}); skipping it",
            RuntimeWarning, stacklevel=4)
        return None
    try:
        prob = float(prob_s)
        count = int(count_s)
    except ValueError:
        warnings.warn(
            f"APHRODITE_FAULT entry {entry!r} has a malformed "
            "prob/count; skipping it", RuntimeWarning, stacklevel=4)
        return None
    if not 0.0 <= prob <= 1.0 or count < 0:
        warnings.warn(
            f"APHRODITE_FAULT entry {entry!r} needs prob in [0, 1] "
            "and count >= 0; skipping it", RuntimeWarning, stacklevel=4)
        return None
    # Stable per-rule stream: independent of other rules' draw order
    # (crc32 is deterministic across processes, unlike hash()).
    rng = random.Random(seed * 1_000_003 + zlib.crc32(entry.encode())
                        + index)
    return _Rule(point, kind, prob, count, rng)


_state: Optional[_State] = None


def _current_state() -> Optional[_State]:
    global _state
    spec = flags.get_str("APHRODITE_FAULT") or ""
    if not spec:
        _state = None
        return None
    seed = flags.get_int("APHRODITE_FAULT_SEED")
    if _state is None or _state.spec != spec or _state.seed != seed:
        _state = _State(spec, seed)
    return _state


def fire(point: str, detail: str = "") -> None:
    """Raise an injected fault if an active APHRODITE_FAULT rule for
    `point` fires; no-op (one env lookup) when the flag is unset."""
    state = _current_state()
    if state is None:
        return
    for rule in state.rules:
        if rule.point != point:
            continue
        if rule.count and rule.fired >= rule.count:
            continue
        if rule.prob < 1.0 and rule.rng.random() >= rule.prob:
            continue
        rule.fired += 1
        raise _KIND_TO_EXC[rule.kind](point, detail)


def reset() -> None:
    """Drop parsed state and fired counters (tests reusing a spec)."""
    global _state
    _state = None


def stats() -> Dict[str, int]:
    """Fired counts per `point:kind` of the active spec (chaos-run
    reporting); empty when injection is off."""
    state = _current_state()
    if state is None:
        return {}
    return {f"{r.point}:{r.kind}": r.fired for r in state.rules}
