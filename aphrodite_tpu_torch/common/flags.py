"""Central registry of APHRODITE_* runtime environment flags.

Every environment flag the engine (or a bench harness) reads is
declared here ONCE — typed, defaulted, documented — and read through
the `get_bool`/`get_int`/`get_float`/`get_str` accessors at CALL time,
never at import time. The static checker (`python -m tools.aphrocheck`,
rule family FLAG*) enforces both halves of the contract over the whole
tree: raw `os.environ` reads of APHRODITE_* names are findings, and so
are registered-but-never-read or read-but-unregistered names. The
registration calls below are PARSED STATICALLY by the checker (and by
`--flags-md`, which generates the README table), so each one must stay
a single literal `_register(Flag(...))` call.

Validation policy (two deliberate tiers, one per failure class):

- `strict=True` (numeric tuning knobs: tile caps, ring depths, scales):
  a malformed value raises `FlagError` — a ValueError subclass whose
  message names the flag and the offending text — at the READ site.
  These knobs change compiled-kernel geometry; silently ignoring a typo
  would run the wrong experiment. Reads happen per call, so a bad value
  fails the call, never the import.
- `strict=False` (booleans and enumerated choices): a malformed value
  warns and falls back to the default. A typo'd "ture" must never kill
  a serving step.

This module must import nothing from the rest of the package (the
logger imports it).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Dict, Optional, Tuple


class FlagError(ValueError):
    """A strictly-validated APHRODITE_* flag carried a malformed value.

    Subclasses ValueError so existing `except ValueError` call sites
    (and tests matching the flag name in the message) keep working.
    """


@dataclasses.dataclass(frozen=True)
class Flag:
    """One registered environment flag.

    default=None means the effective default is derived at the call
    site (e.g. shape-dependent tile caps); such reads pass an explicit
    `default=` to the accessor.
    """
    name: str
    type: str                 # "bool" | "int" | "float" | "str"
    default: Any
    description: str
    choices: Optional[Tuple[str, ...]] = None
    minimum: Optional[float] = None
    strict: bool = False
    uppercase: bool = False   # normalize the raw value to upper-case


_REGISTRY: Dict[str, Flag] = {}

_TRUE_WORDS = ("1", "true", "yes", "on")
_FALSE_WORDS = ("0", "false", "no", "off", "")


def _register(flag: Flag) -> None:
    if flag.name in _REGISTRY:
        raise ValueError(f"duplicate flag registration: {flag.name}")
    _REGISTRY[flag.name] = flag


def registry() -> Dict[str, Flag]:
    """Read-only view of every registered flag (tests, doc gen)."""
    return dict(_REGISTRY)


def is_set(name: str) -> bool:
    """Whether the flag is present in the environment (registered
    names only — a typo'd name is a programming error, not False)."""
    _lookup(name)
    return name in os.environ


def _lookup(name: str) -> Flag:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise FlagError(
            f"{name} is not a registered flag; add it to "
            "aphrodite_tpu_torch/common/flags.py") from None


def _bad(flag: Flag, raw: str, why: str, default: Any) -> Any:
    if flag.strict:
        raise FlagError(f"{flag.name} {why}, got {raw!r}")
    warnings.warn(
        f"{flag.name} {why}, got {raw!r}; using default {default!r}",
        RuntimeWarning, stacklevel=3)
    return default


def get_bool(name: str, default: Optional[bool] = None) -> bool:
    """Per-call validated boolean read: 1/true/yes/on and
    0/false/no/off (case-insensitive); anything else warns (or raises,
    strict flags) and yields the default."""
    flag = _lookup(name)
    dflt = flag.default if default is None else default
    raw = os.environ.get(name)
    if raw is None:
        return bool(dflt)
    word = raw.strip().lower()
    if word in _TRUE_WORDS:
        return True
    if word in _FALSE_WORDS:
        return False
    return bool(_bad(flag, raw, "must be a boolean (0/1/true/false)",
                     dflt))


def _get_number(name: str, default, caster, kind: str):
    flag = _lookup(name)
    dflt = flag.default if default is None else default
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return dflt
    try:
        value = caster(raw)
    except ValueError:
        return _bad(flag, raw, f"must be {kind}", dflt)
    if flag.minimum is not None and value < flag.minimum:
        return _bad(flag, raw, f"must be >= {flag.minimum:g}", dflt)
    return value


def get_int(name: str, default: Optional[int] = None) -> int:
    """Per-call validated integer read; strict flags raise FlagError
    on malformed values (never a bare int() ValueError mid-batch)."""
    return _get_number(name, default, int, "an integer")


def get_float(name: str, default: Optional[float] = None) -> float:
    """Per-call validated float read (same contract as get_int)."""
    return _get_number(name, default, float, "a number")


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """Per-call string read; flags declaring `choices` validate
    membership (warn-and-default unless strict)."""
    flag = _lookup(name)
    dflt = flag.default if default is None else default
    raw = os.environ.get(name)
    if raw is None:
        return dflt
    if flag.uppercase:
        raw = raw.strip().upper()
    if flag.choices is not None and raw not in flag.choices:
        return _bad(flag, raw,
                    f"must be one of {'/'.join(map(repr, flag.choices))}",
                    dflt)
    return raw


def flags_markdown() -> str:
    """The README "Runtime flags" table (`python -m tools.aphrocheck
    --flags-md` prints this)."""
    rows = ["| Flag | Type | Default | Description |",
            "| --- | --- | --- | --- |"]
    for flag in sorted(_REGISTRY.values(), key=lambda f: f.name):
        if flag.default is None:
            dflt = "derived"
        elif flag.type == "bool":
            dflt = "1" if flag.default else "0"
        elif flag.default == "":
            dflt = "unset"
        else:
            dflt = f"`{flag.default}`"
        rows.append(f"| `{flag.name}` | {flag.type} | {dflt} "
                    f"| {flag.description} |")
    return "\n".join(rows)


# --------------------------------------------------------------------
# Registrations. One literal _register(Flag(...)) per flag — parsed
# statically by tools/aphrocheck (FLAG004/005/006 and --flags-md).
# --------------------------------------------------------------------

_register(Flag(
    "APHRODITE_ATTN_PF", "int", 6,
    "Decode-attention cross-cell DMA prefetch ring depth (cell i "
    "starts cell i+depth's page loads); trimmed to the VMEM ring "
    "budget at large chunk sizes.",
    minimum=1, strict=True))

_register(Flag(
    "APHRODITE_ATTN_RAGGED", "bool", True,
    "Ragged work-list decode-attention grid; 0 pins the classic "
    "padded (batch, head-block) grid for A/B runs."))

_register(Flag(
    "APHRODITE_ATTN_AMLA", "bool", True,
    "AMLA mul-by-add online-softmax rescale in the decode-attention "
    "kernels (base-2 scores, integer running max, exponent-bias adds "
    "on the accumulator; arxiv 2509.25224); 0 pins the classic "
    "per-chunk rescale multiply for A/B runs."))

_register(Flag(
    "APHRODITE_W4A8", "bool", False,
    "GPTQ/AWQ int8-activation MXU path (weights stay int4 at rest; "
    "per-row activation rounding is the only approximation). The "
    "GPTQ/AWQ bench default; 0 selects the bit-exact W4A16 kernels."))

_register(Flag(
    "APHRODITE_QMM_DEFERRED", "str", "",
    "Pin the W4A8 deferred-rescale kernel variant: 1 forces deferred "
    "(int32 group accumulators, scales applied at k-tile flush), 0 "
    "forces classic; unset autotunes by shape (deferred at m > 64).",
    choices=("", "0", "1")))

_register(Flag(
    "APHRODITE_QMM_BLOCK_M", "int", None,
    "Cap on the quant-matmul M tile (rows). Default is kernel-chosen "
    "(512, or 256 with deferred-rescale accumulator planes).",
    minimum=1, strict=True))

_register(Flag(
    "APHRODITE_QMM_BLOCK_N", "int", 0,
    "Cap on the quant-matmul N tile (lanes); 0 = kernel default "
    "(2048, or 1024 with deferred-rescale accumulator planes).",
    minimum=0, strict=True))

_register(Flag(
    "APHRODITE_QMM_BLOCK_K", "int", 0,
    "Cap on the quant-matmul K tile (contraction depth); 0 = kernel "
    "default (1024; 512 for affine/LUT kernels, 2048 small-m W4A8).",
    minimum=0, strict=True))

_register(Flag(
    "APHRODITE_QMM_STREAM", "bool", True,
    "Streamed skinny-m quant-matmul path at m <= 64: the (n, k) tile "
    "grid flattens into one work list and weight tiles stream through "
    "an explicit cross-cell DMA ring; 0 pins the classic "
    "compiler-managed grid for A/B runs."))

_register(Flag(
    "APHRODITE_QMM_STREAM_PF", "int", 2,
    "Ring depth (VMEM tile slots) of the streamed quant-matmul weight "
    "DMA ring; cell i starts cell i+depth-1's tile loads. Malformed "
    "or < 2 values warn and fall back to the default.",
    minimum=2))

_register(Flag(
    "APHRODITE_QMM_DEFERRED_VMEM_MB", "int", 8,
    "VMEM budget (MiB) for the deferred-rescale accumulator planes; "
    "shapes that exceed it silently fall back to the classic kernel.",
    minimum=1, strict=True))

_register(Flag(
    "APHRODITE_KV_SCALE", "float", None,
    "int8 KV-cache dequant scale (owned by the CacheEngine, threaded "
    "through InputMetadata.kv_scale). Default: ops/kv_quant.py's "
    "DEFAULT_KV_SCALE.",
    strict=True))

_register(Flag(
    "APHRODITE_COMPILE_CACHE", "str", "",
    "JAX persistent compilation cache: 0 disables, a path redirects; "
    "unset uses $XDG_CACHE_HOME/aphrodite_tpu_torch/jax_cache (TPU backend "
    "only — CPU test runs skip persisting)."))

_register(Flag(
    "APHRODITE_BURST_TIMING", "bool", False,
    "Print per-burst device+sync timing lines from the scheduler/"
    "executor hot path (profiling aid)."))

_register(Flag(
    "APHRODITE_DEBUG_KV", "bool", False,
    "Enable the host-side sequence-exclusive-pages precondition check "
    "for the pipelined decode KV writer (debugging aid)."))

_register(Flag(
    "APHRODITE_TPU_LOG_LEVEL", "str", "INFO",
    "Root log level for the aphrodite_tpu_torch logger.",
    choices=("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"),
    uppercase=True))

_register(Flag(
    "APHRODITE_DISABLE_PALLAS_QUANT", "bool", False,
    "Force the XLA dequantize-then-dot fallback instead of the fused "
    "Pallas quant-matmul kernels (debugging / numerics triage)."))

_register(Flag(
    "APHRODITE_GGUF_EXACT", "bool", False,
    "Keep the bit-exact per-format GGUF kernels for every block type "
    "instead of the per-128-group int8 turbo requantization (Q8_0/"
    "Q6_K stay exact either way)."))

_register(Flag(
    "APHRODITE_CACHE", "str", None,
    "Download lock/cache directory for model resolution. Default: "
    "~/.cache/aphrodite."))

_register(Flag(
    "APHRODITE_USE_MODELSCOPE", "bool", False,
    "Resolve model paths via ModelScope snapshots instead of the "
    "HuggingFace hub."))

_register(Flag(
    "APHRODITE_PSTEP", "str", "full,nokv,nosilu,nonorm,norope",
    "Comma list of profile_step.py ablation variants to run (each "
    "costs ~2 min of compiles; subset to fit shell timeouts)."))

_register(Flag(
    "APHRODITE_STEP_RETRIES", "int", 2,
    "Max retries of a failed engine step classified as transient "
    "before the supervised loop declares the engine DEAD. Malformed "
    "values warn and fall back (a typo must not kill serving).",
    minimum=0))

_register(Flag(
    "APHRODITE_STEP_BACKOFF_S", "float", 0.05,
    "Base delay (seconds) of the exponential backoff between engine-"
    "step retries: attempt k sleeps base * 2^(k-1).",
    minimum=0))

_register(Flag(
    "APHRODITE_STEP_TIMEOUT_S", "float", 0,
    "Step watchdog: seconds an off-loop engine step may run before "
    "the engine is declared DEAD (a wedged XLA compile/device call "
    "cannot be interrupted, only detected). 0 disables the watchdog; "
    "it also bounds the last-step age before /health reports "
    "DEGRADED.",
    minimum=0))

_register(Flag(
    "APHRODITE_REINCARNATIONS", "int", 1,
    "Max automatic engine rebuilds (reincarnations) after FATAL step "
    "faults before the terminal DEAD state: the executor/model-runner/"
    "KV pool are torn down and rebuilt, restorable requests return to "
    "the waiting queue with their streams intact. 0 disables recovery "
    "(every FATAL fault is immediately terminal, the pre-lifecycle "
    "behavior).",
    minimum=0))

_register(Flag(
    "APHRODITE_REINCARNATION_BACKOFF_S", "float", 0.5,
    "Base delay (seconds) before an engine reincarnation: rebuild n "
    "waits base * 2^(n-1), so a crash-looping replica backs off "
    "instead of thrashing device init.",
    minimum=0))

_register(Flag(
    "APHRODITE_DRAIN_DEADLINE_S", "float", 30,
    "Default graceful-drain deadline (seconds): after SIGTERM or an "
    "admin drain request, in-flight requests get this long to finish "
    "before being aborted with a typed error so the process can exit. "
    "0 = wait for in-flight work indefinitely.",
    minimum=0))

_register(Flag(
    "APHRODITE_FAULT", "str", "",
    "Fault-injection spec `point:kind:prob:count[,...]` (points: "
    "engine.step, scheduler.schedule, block_manager.allocate, "
    "executor.execute_model, tokenizer.decode; kinds: transient/"
    "request/fatal). Unset = injection compiled out. See "
    "common/faultinject.py for the grammar."))

_register(Flag(
    "APHRODITE_FAULT_SEED", "int", 0,
    "Seed of the deterministic per-rule RNG behind APHRODITE_FAULT "
    "probability draws; one (spec, seed) pair replays the exact same "
    "fault schedule."))

_register(Flag(
    "APHRODITE_DEFAULT_TTFT_SLO_S", "float", 0,
    "Default per-request TTFT deadline (seconds) for requests that "
    "carry no explicit `ttft_slo_s`; drives deadline-aware admission "
    "shedding and waiting-queue expiry. 0 = no default deadline.",
    minimum=0))

_register(Flag(
    "APHRODITE_MAX_QUEUE_DEPTH", "int", 0,
    "Admission cap on the scheduler waiting-queue depth; arrivals "
    "past it are shed with HTTP 429 + Retry-After instead of "
    "queueing to death. 0 = derived (16 x max_num_seqs).",
    minimum=0))

_register(Flag(
    "APHRODITE_MAX_WAITING_TOKENS", "int", 0,
    "Admission cap on queued prefill tokens across the waiting "
    "queue; arrivals that would exceed it are shed with HTTP 429 + "
    "Retry-After. 0 = derived (8 x max_num_batched_tokens).",
    minimum=0))

_register(Flag(
    "APHRODITE_PAGE_LOW_WATERMARK", "float", 0,
    "Free-page low watermark as a fraction of the KV pool: prompt "
    "admission additionally reserves this many pages PLUS one page "
    "per running sequence, so admitting a prompt can never "
    "immediately force a preemption of a running group. 0 disables "
    "the reserve (the allocator's 1% hysteresis still applies).",
    minimum=0))

_register(Flag(
    "APHRODITE_ROUTER_POLL_S", "float", 0.25,
    "Fleet router health-poll interval (seconds): how often each "
    "replica's GET /health?probe=1 fast path is sampled for the load "
    "signal. Snapshots older than 4x this are STALE — the router "
    "then falls back to round-robin over non-circuit-broken replicas "
    "instead of trusting dead load numbers.",
    minimum=0.01))

_register(Flag(
    "APHRODITE_ROUTER_RETRIES", "int", 3,
    "Fleet router per-request retry budget: max times a request that "
    "was rejected BEFORE any token streamed (503-draining replica, "
    "connection refused/reset, replica 5xx) is re-sent to a "
    "different replica. Once streaming has begun the request is "
    "never re-issued.",
    minimum=0))

_register(Flag(
    "APHRODITE_ROUTER_BACKOFF_S", "float", 0.05,
    "Base delay (seconds) of the fleet router's exponential backoff "
    "between request retries: attempt k sleeps base * 2^(k-1), "
    "stretched to the replica's Retry-After hint when one was sent "
    "and capped by the request's ttft_slo_s deadline.",
    minimum=0))

_register(Flag(
    "APHRODITE_ROUTER_SPILL", "float", 8.0,
    "Prefix-affinity spill threshold in load-score units (~queued "
    "requests): a keyed request abandons its affinity replica for "
    "the least-loaded one when the affinity replica's load exceeds "
    "the fleet minimum by more than this — prefix-cache hits are "
    "worth a bounded queue imbalance, not an unbounded one.",
    minimum=0))

_register(Flag(
    "APHRODITE_ROUTER_CB_WINDOW_S", "float", 2.0,
    "Fleet router circuit-break window (seconds): a replica whose "
    "health poll or proxied request failed at the connection level "
    "is excluded from routing for this long after the last failure; "
    "a DEAD health report keeps re-arming the window until /health "
    "recovers.",
    minimum=0))

_register(Flag(
    "APHRODITE_ROUTER_JOURNAL_TOKENS", "int", 4096,
    "Fleet router per-stream journal bound: max emitted token ids "
    "journaled for one in-flight stream (the state a mid-stream "
    "failover resumes from). A stream that outgrows the bound stops "
    "journaling and falls back to truthful truncation on replica "
    "death. 0 disables stream journaling entirely.",
    minimum=0))

_register(Flag(
    "APHRODITE_ROUTER_JOURNAL_STREAMS", "int", 256,
    "Fleet router fleet-wide journal bound: max concurrently "
    "journaled streams. Streams past the cap are proxied without a "
    "journal (mid-stream replica death truncates truthfully instead "
    "of resuming).",
    minimum=0))

_register(Flag(
    "APHRODITE_PREEMPT_BUDGET", "int", 4,
    "Max RECOMPUTE/SWAP preemptions per scheduling round; decode "
    "rows that still lack a free page past the budget skip the round "
    "holding their pages instead of cascading evictions (every "
    "preempted group re-prefills from scratch — an undamped storm "
    "collapses goodput under page pressure).",
    minimum=1))

_register(Flag(
    "APHRODITE_DISAGG", "str", "",
    "Disaggregated prefill/decode split as 'n_prefill,n_decode' chips "
    "(e.g. '2,6' of tp=8): prefill-phase programs run on the prefill "
    "submesh, decode/burst/spec-verify on the decode submesh, and "
    "finished prefills hand their KV pages off over ICI. Unset = "
    "colocated. The --disagg-split engine arg takes precedence."))

_register(Flag(
    "APHRODITE_DISAGG_TIMING", "bool", False,
    "Print per-flush KV handoff lines (pages, bytes, transfer+sync "
    "time) from the disagg executor hot path (profiling aid)."))

_register(Flag(
    "APHRODITE_SPEC", "bool", True,
    "Self-drafting speculative decoding (n-gram/prompt-lookup "
    "drafter + multi-token verify on the decode path); 0 pins the "
    "classic single-token decode path for A/B runs."))

_register(Flag(
    "APHRODITE_SPEC_K", "int", 4,
    "Max draft tokens proposed per sequence per speculative round "
    "(the verify step scores k+1 positions per row in one dispatch).",
    minimum=1, strict=True))

_register(Flag(
    "APHRODITE_SPEC_NGRAM_MAX", "int", 4,
    "Longest suffix n-gram the drafter matches against the "
    "request's own prompt+output history (tried first; falls back "
    "to shorter n-grams down to APHRODITE_SPEC_NGRAM_MIN).",
    minimum=1, strict=True))

_register(Flag(
    "APHRODITE_SPEC_NGRAM_MIN", "int", 1,
    "Shortest suffix n-gram the drafter falls back to before "
    "declaring no proposal for this round.",
    minimum=1, strict=True))

_register(Flag(
    "APHRODITE_SPEC_BACKOFF", "float", 0.3,
    "Acceptance-EWMA back-off threshold: a sequence whose "
    "accepted/proposed EWMA falls below this drafts a single probe "
    "token per round until acceptance recovers (adaptive back-off "
    "on hostile traffic).",
    minimum=0, strict=True))
