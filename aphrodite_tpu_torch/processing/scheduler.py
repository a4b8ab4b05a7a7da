"""Iteration-level (continuous-batching) scheduler with chunked prefill.

Budget/preemption semantics follow the reference
`aphrodite/processing/scheduler.py:73,160,365`, but the round shape is
TPU-native: where the reference runs either a prompt batch OR a decode
batch per step, this scheduler emits BOTH in one round — the decode
batch plus a chunk-budgeted slice of prompt work — so the executor can
enqueue the prefill program and the decode burst back-to-back and pay
one host<->device sync for the round. A prompt longer than the chunk
budget is prefilled across several rounds (`self.prefilling` holds the
in-flight ones); only its final chunk samples a token. This removes the
dedicated per-arrival prefill round that capped low-rate serving
(SERVING_r04: ~94 out-tok/s at request rate 2.0).

TPU notes: the prompt-token budget uses the padded cost
(num_seqs * max_len), which is exactly what the fixed-shape prefill
program executes, so the budget is the real device cost, not an
approximation. Chunk boundaries stay page-aligned so the whole-page
prefill KV writer keeps running. The emitted swap/copy plans are applied
as single batched device ops by the executor.
"""
from __future__ import annotations

import enum
import time
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple, Union

from aphrodite_tpu_torch.common import faultinject, flags
from aphrodite_tpu_torch.common.config import (CacheConfig, LoRAConfig,
                                         SchedulerConfig)
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.prefix import PrefixPool
from aphrodite_tpu_torch.common.sequence import (Sequence, SequenceData,
                                           SequenceGroup,
                                           SequenceGroupMetadata,
                                           SequenceStatus)
from aphrodite_tpu_torch.processing.block_manager import (AllocStatus,
                                                    BlockSpaceManager)
from aphrodite_tpu_torch.processing.policy import PolicyFactory

logger = init_logger(__name__)


class PreemptionMode(enum.Enum):
    """RECOMPUTE drops pages and requeues as a fresh prompt (cheap, only
    valid for single-sequence groups); SWAP stages pages to host memory."""
    SWAP = enum.auto()
    RECOMPUTE = enum.auto()


class PromptChunk:
    """One round's slice of one prompt: compute tokens [ctx, ctx+length)
    against the `ctx` tokens already in the KV cache. `is_final` marks
    the slice that reaches the end of the prompt and samples a token."""

    __slots__ = ("group", "ctx", "length", "is_final")

    def __init__(self, group: SequenceGroup, ctx: int, length: int,
                 is_final: bool) -> None:
        self.group = group
        self.ctx = ctx
        self.length = length
        self.is_final = is_final


class SchedulerOutputs:
    """One round of work: prompt chunks + a decode batch (either may be
    empty), plus the block-op plans the executor applies first."""

    def __init__(
        self,
        prompt_chunks: List[PromptChunk],
        decode_groups: List[SequenceGroup],
        num_prefill_tokens: int,
        num_decode_tokens: int,
        blocks_to_swap_in: Dict[int, int],
        blocks_to_swap_out: Dict[int, int],
        blocks_to_copy: Dict[int, List[int]],
        ignored_seq_groups: List[SequenceGroup],
    ) -> None:
        self.prompt_chunks = prompt_chunks
        self.decode_groups = decode_groups
        self.num_prefill_tokens = num_prefill_tokens
        self.num_decode_tokens = num_decode_tokens
        self.blocks_to_swap_in = blocks_to_swap_in
        self.blocks_to_swap_out = blocks_to_swap_out
        self.blocks_to_copy = blocks_to_copy
        # Structural invariant: a step never swaps both directions.
        assert not (blocks_to_swap_in and blocks_to_swap_out)
        self.ignored_seq_groups = ignored_seq_groups

    @property
    def scheduled_seq_groups(self) -> List[SequenceGroup]:
        # Metadata order: prompt chunks first, then decode rows.
        return [c.group for c in self.prompt_chunks] + self.decode_groups

    @property
    def prompt_run(self) -> bool:
        # A pure-prefill round (the only kind the reference's prompt_run
        # flag could describe; combined rounds report both counts).
        return bool(self.prompt_chunks) and not self.decode_groups

    @property
    def num_batched_tokens(self) -> int:
        return self.num_prefill_tokens + self.num_decode_tokens

    def is_empty(self) -> bool:
        # Ignored groups still produce outputs but schedule no device work.
        return (not self.prompt_chunks and not self.decode_groups
                and not self.blocks_to_swap_in
                and not self.blocks_to_swap_out and not self.blocks_to_copy)


class Scheduler:

    def __init__(
        self,
        scheduler_config: SchedulerConfig,
        cache_config: CacheConfig,
        lora_config: Optional[LoRAConfig] = None,
        disagg: bool = False,
    ) -> None:
        self.scheduler_config = scheduler_config
        self.cache_config = cache_config
        self.lora_config = lora_config
        # Disaggregated prefill/decode: prompt chunks run on a chip
        # group the decode batch never touches, so the chunk throttle —
        # which exists only to keep a co-located prefill from stalling
        # the decode stream — is lifted and mixed rounds run prefill at
        # the FULL budget. Phase routing itself needs no new scheduler
        # state: the round is already emitted as prompt chunks + decode
        # groups, and the executor maps each half to its submesh.
        self.disagg = disagg

        self.prompt_limit = min(scheduler_config.max_model_len,
                                scheduler_config.max_num_batched_tokens)

        self.policy = PolicyFactory.get_policy(policy_name="fcfs")
        self.block_manager = BlockSpaceManager(
            block_size=cache_config.block_size,
            num_gpu_blocks=cache_config.num_gpu_blocks,
            num_cpu_blocks=cache_config.num_cpu_blocks,
            sliding_window=cache_config.sliding_window)
        self.prefix_pool = PrefixPool(cache_config.block_size)

        # thread-safe: two-world by sequencing, not locking — the
        # event loop only appends (engine.add_request) BETWEEN steps
        # (engine_step awaits the step future before touching the
        # scheduler), the step thread mutates only inside step()/
        # reincarnate() behind the epoch guard, and loop-side
        # monitoring reads (queue depth, queued tokens) tolerate
        # one-round staleness by design.
        self.waiting: Deque[SequenceGroup] = deque()
        # Admitted prompts whose KV is only partially written (chunked
        # prefill in flight); they hold their full page allocation and
        # graduate to `running` with their final chunk.
        self.prefilling: Deque[SequenceGroup] = deque()
        self.running: Deque[SequenceGroup] = deque()
        self.swapped: Deque[SequenceGroup] = deque()
        # Crash-barrier bookkeeping, reset per schedule() round: the
        # groups swapped OUT this round (their host pages are garbage
        # until the device copy actually runs) and the groups ignored
        # this round (popped from `waiting` before their FINISHED_
        # IGNORED outputs were delivered).
        self._round_swapped_out: List[SequenceGroup] = []
        self._round_ignored: List[SequenceGroup] = []

    @property
    def lora_enabled(self) -> bool:
        return bool(self.lora_config)

    def add_seq_group(self, seq_group: SequenceGroup) -> None:
        self.waiting.append(seq_group)

    def abort_seq_group(self, request_id: Union[str, Iterable[str]]) -> None:
        if isinstance(request_id, str):
            request_id = (request_id, )
        request_ids = set(request_id)
        for state_queue in (self.waiting, self.prefilling, self.running,
                            self.swapped):
            aborted: List[SequenceGroup] = []
            for seq_group in state_queue:
                if not request_ids:
                    break
                if seq_group.request_id in request_ids:
                    aborted.append(seq_group)
                    request_ids.remove(seq_group.request_id)
            for seq_group in aborted:
                state_queue.remove(seq_group)
                for seq in seq_group.get_seqs():
                    if seq.is_finished():
                        continue
                    seq.status = SequenceStatus.FINISHED_ABORTED
                    self.free_seq(seq)

    def has_unfinished_seqs(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running
                    or self.swapped)

    def get_num_unfinished_seq_groups(self) -> int:
        return (len(self.waiting) + len(self.prefilling) +
                len(self.running) + len(self.swapped))

    def waiting_prefill_tokens(self) -> int:
        """Prefill tokens queued across `waiting` (admission gauge;
        the deque is admission-capped so the walk stays bounded)."""
        return sum(
            seq.get_len() - seq.data.num_computed_tokens
            for group in self.waiting
            for seq in group.get_seqs(status=SequenceStatus.WAITING))

    def expire_waiting(self, now: float) -> List[SequenceGroup]:
        """Abort deadline-missed groups still sitting in `waiting`
        that were never computed — no pages were ever allocated and
        no schedule round runs for them, so the abort is free.

        Groups a preemption requeued (they already produced output
        tokens, i.e. met their TTFT) are never expired. Returns the
        expired groups so the engine can surface a typed
        RequestTimeoutError on exactly those streams.
        """
        expired: List[SequenceGroup] = []
        kept: Deque[SequenceGroup] = deque()
        for group in self.waiting:
            deadline = group.deadline
            seqs = group.get_seqs(status=SequenceStatus.WAITING)
            never_computed = all(
                seq.data.num_computed_tokens == 0 and
                seq.get_output_len() == 0 for seq in seqs)
            if deadline is not None and now > deadline and seqs and \
                    never_computed:
                for seq in seqs:
                    seq.status = SequenceStatus.FINISHED_ABORTED
                    self.free_seq(seq)       # no-op: never allocated
                expired.append(group)
            else:
                kept.append(group)
        if expired:
            self.waiting = kept
        return expired

    def _admission_page_reserve(self) -> int:
        """Extra free pages prompt admission must leave untouched:
        the APHRODITE_PAGE_LOW_WATERMARK fraction of the pool PLUS
        one page per running sequence (the worst-case next decode
        slot), so admitting a prompt can never immediately force
        `can_append_slot` to start evicting running groups. 0 (the
        default) keeps the allocator's own 1% hysteresis only."""
        frac = flags.get_float("APHRODITE_PAGE_LOW_WATERMARK")
        if not frac or frac <= 0:
            return 0
        running_slots = sum(
            g.num_seqs(status=SequenceStatus.RUNNING)
            for g in self.running)
        return int(frac * self.block_manager.num_total_gpu_blocks) + \
            running_slots

    def _reclaim_reservations(self, *queues) -> int:
        """Trim burst/speculative look-ahead pages reserved past each
        sequence's current length (block_manager.trim_reserved) across
        the given group queues. Reservations are re-granted after
        scheduling (reserve_decode_burst runs post-schedule), so a
        trimmed row loses at most one round of look-ahead, never
        correctness. Returns pages freed."""
        freed = 0
        for queue in queues:
            for group in queue:
                for seq in group.get_seqs(
                        status=SequenceStatus.RUNNING):
                    freed += self.block_manager.trim_reserved(seq)
        return freed

    # ------------------------------------------------------------------

    def _fit_chunk(self, remaining: int, seq_lens: List[int],
                   budget: int) -> int:
        """Largest chunk length for a new prompt row such that the
        padded-batch cost (rows x longest row) stays within `budget`.
        Partial chunks stay page-aligned (the whole-page prefill writer
        requires every row's cached context to be a page multiple)."""
        rows = len(seq_lens) + 1
        longest = max(seq_lens) if seq_lens else 0
        limit = budget // rows
        if limit >= longest:
            n = min(remaining, limit)
        elif rows * longest <= budget:
            # Rides in the existing padding for free.
            n = min(remaining, longest)
        else:
            return 0
        if n < remaining:
            n -= n % self.cache_config.block_size
        return n

    def _continue_prefills(self, seq_lens: List[int], budget: int,
                           chunks: List[PromptChunk]) -> None:
        """Advance partially-prefilled prompts (FCFS; they already hold
        their full page allocation so no admission checks apply)."""
        still: Deque[SequenceGroup] = deque()
        while self.prefilling:
            group = self.prefilling.popleft()
            seq = group.get_seqs(status=SequenceStatus.RUNNING)[0]
            ctx = seq.data.num_computed_tokens
            remaining = seq.get_len() - ctx
            n = self._fit_chunk(remaining, seq_lens, budget)
            if n <= 0:
                still.append(group)
                # Keep FCFS: rows behind an out-of-budget head wait too.
                still.extend(self.prefilling)
                self.prefilling.clear()
                break
            final = n == remaining
            chunks.append(PromptChunk(group, ctx, n, final))
            seq_lens.append(n)
            seq.data.num_computed_tokens = ctx + n
            if final:
                self.running.append(group)
            else:
                still.append(group)
        self.prefilling = still

    def _admit_prompts(self, seq_lens: List[int], budget: int,
                       chunks: List[PromptChunk],
                       ignored: List[SequenceGroup]) -> None:
        """Admit waiting prompts under the token/seq/padding budgets,
        splitting any that exceed the remaining chunk room. The waiting
        queue stays unsorted: preempted groups re-enter at the front,
        new arrivals at the back, preserving FCFS."""
        num_curr_seqs = sum(
            g.get_max_num_running_seqs()
            for g in list(self.running) + list(self.prefilling))
        # Mid-prefill groups occupy adapter slots too: their chunks run
        # every round, so their adapters must stay resident.
        curr_loras = (set(g.lora_int_id
                          for g in list(self.running) +
                          list(self.prefilling))
                      if self.lora_enabled else None)
        deferred: Deque[SequenceGroup] = deque()
        # Chunked prefill needs the gather-over-pages attention path,
        # which does not model sliding-window rings; such models admit
        # whole prompts only.
        can_split = self.cache_config.sliding_window is None
        page_reserve = self._admission_page_reserve()

        while self.waiting:
            group = self.waiting[0]
            seqs = group.get_seqs(status=SequenceStatus.WAITING)
            assert len(seqs) == 1, (
                "Waiting sequence group should have only one prompt "
                "sequence.")
            prompt_len = seqs[0].get_len()

            if prompt_len > self.prompt_limit:
                logger.warning(
                    "Input prompt (%d tokens) is too long and exceeds "
                    "limit of %d", prompt_len, self.prompt_limit)
                seqs[0].status = SequenceStatus.FINISHED_IGNORED
                ignored.append(group)
                self._round_ignored.append(group)
                self.waiting.popleft()
                continue

            can_allocate = self.block_manager.can_allocate(
                group, extra_reserved=page_reserve)
            if can_allocate == AllocStatus.LATER:
                break
            if can_allocate == AllocStatus.NEVER:
                logger.warning(
                    "Input prompt (%d tokens) is too long and exceeds "
                    "the capacity of the block manager", prompt_len)
                seqs[0].status = SequenceStatus.FINISHED_IGNORED
                ignored.append(group)
                self._round_ignored.append(group)
                self.waiting.popleft()
                continue

            lora_int_id = 0
            if self.lora_enabled:
                lora_int_id = group.lora_int_id
                if (lora_int_id > 0 and lora_int_id not in curr_loras
                        and len(curr_loras) >=
                        self.lora_config.max_loras):
                    # No free adapter slot: defer without blocking others.
                    deferred.appendleft(group)
                    self.waiting.popleft()
                    continue

            ctx = 0
            if group.prefix is not None and group.prefix.computed:
                # Prefix-cached tokens are already in the KV pool; the
                # chunk walk starts after them (at least the last token
                # must be computed to sample from it). The clamp is
                # PAGE-ALIGNED: a full-prefix hit recomputes its last
                # prefix page (identical KV, idempotent) instead of
                # starting the chunk mid-page — one misaligned row
                # disables the whole-page prefill KV writer for the
                # ENTIRE round (model_runner gates prefill_cells on
                # every row's ctx % page_size == 0).
                ps = self.cache_config.block_size
                ctx = min(group.prefix.get_length(),
                          (prompt_len - 1) // ps * ps)
            remaining = prompt_len - ctx
            n = self._fit_chunk(remaining, seq_lens, budget)
            if n <= 0:
                break
            final = n == remaining
            if not final and (not can_split
                              or group.sampling_params.prompt_logprobs
                              is not None):
                # Needs the whole prompt in one round; wait for one.
                break

            num_new_seqs = group.get_max_num_running_seqs()
            if (num_curr_seqs + num_new_seqs >
                    self.scheduler_config.max_num_seqs):
                break

            new_seq_lens = seq_lens + [n]
            num_paddings = (len(new_seq_lens) * max(new_seq_lens) -
                            sum(new_seq_lens))
            if num_paddings > self.scheduler_config.max_paddings:
                break
            seq_lens.append(n)

            if lora_int_id > 0:
                curr_loras.add(lora_int_id)
            # Allocate BEFORE popping from `waiting`: if the allocator
            # faults, the group is still queued and a crash-rolled-back
            # retry re-admits it instead of losing the request.
            self._allocate(group)
            self.waiting.popleft()
            num_curr_seqs += num_new_seqs
            seq = group.get_seqs(status=SequenceStatus.RUNNING)[0]
            chunks.append(PromptChunk(group, ctx, n, final))
            seq.data.num_computed_tokens = ctx + n
            if final:
                self.running.append(group)
            else:
                self.prefilling.append(group)

        self.waiting.extendleft(deferred)

    def _waiting_backlog_at_least(self, budget: int) -> bool:
        """True once the waiting deque holds >= budget queued prompt
        tokens (early-exit: the deque can be thousands deep and this
        runs every round)."""
        pending = 0
        for group in self.waiting:
            for seq in group.get_seqs(status=SequenceStatus.WAITING):
                pending += seq.get_len() - seq.data.num_computed_tokens
                if pending >= budget:
                    return True
        return False

    def _schedule_batch_building(self) -> Optional[SchedulerOutputs]:
        """A pure-prefill round when the batch-building condition holds
        (see _schedule step 0), else None. Exposed via
        schedule_prompt_only so the engine can PIPELINE consecutive
        builder rounds: prompt rounds touch disjoint fresh groups and
        depend on no prior round's sampled tokens, so their device
        programs can be enqueued back-to-back and synced once."""
        if self.swapped or len(self.waiting) <= 1 or \
                len(self.waiting) < len(self.running):
            return None
        budget = self.scheduler_config.max_num_batched_tokens
        if not self._waiting_backlog_at_least(budget):
            return None
        chunks: List[PromptChunk] = []
        ignored: List[SequenceGroup] = []
        seq_lens: List[int] = []
        self._continue_prefills(seq_lens, budget, chunks)
        self._admit_prompts(seq_lens, budget, chunks, ignored)
        if not chunks and not ignored:
            return None
        return SchedulerOutputs(
            prompt_chunks=chunks,
            decode_groups=[],
            num_prefill_tokens=(len(seq_lens) * max(seq_lens)
                                if seq_lens else 0),
            num_decode_tokens=0,
            blocks_to_swap_in={},
            blocks_to_swap_out={},
            blocks_to_copy={},
            ignored_seq_groups=ignored,
        )

    def schedule_prompt_only(
        self
    ) -> Optional[Tuple[List[SequenceGroupMetadata], SchedulerOutputs]]:
        """Next batch-building round, or None outside that regime."""
        try:
            outputs = self._schedule_batch_building()
        except Exception:
            # Mid-schedule crash: partial admissions/chunk progress of
            # unknown extent — conservatively roll back every in-flight
            # group (idempotent; the engine-level barrier may run too).
            self.crash_rollback(None)
            raise
        if outputs is None:
            return None
        mds = [
            self._group_metadata(c.group, is_prompt=True, chunk=c)
            for c in outputs.prompt_chunks
        ]
        return mds, outputs

    def _schedule(self) -> SchedulerOutputs:
        blocks_to_swap_in: Dict[int, int] = {}
        blocks_to_swap_out: Dict[int, int] = {}
        blocks_to_copy: Dict[int, List[int]] = {}
        now = time.monotonic()

        # 0. Batch-building phase: while a FULL prefill round's worth of
        # prompt work is queued across SEVERAL waiting groups, at least
        # as many as are running (offline batches, request floods —
        # breadth, not one long prompt), run pure prompt rounds with the
        # full token budget: prompts keep absolute priority exactly like
        # the reference, and decode starts once the batch is built
        # (decoding a partial batch while prompts trickle in costs
        # straggler rounds at the tail — measured 7.1k -> 4.6k
        # out-tok/s on the offline bench). A single long prompt never
        # triggers this; it chunk-mixes with decode below (the serving
        # regime). During a sustained flood this stalls decode in favor
        # of goodput — the same trade the reference's prompt-priority
        # scheduler makes.
        builder = self._schedule_batch_building()
        if builder is not None:
            return builder

        # 1. Decode batch: reserve one slot per running sequence,
        # preempting from the back of the priority order when pages run
        # out. (Groups mid-prefill are not decode rows and hold their
        # pages until done.) A per-round preemption budget
        # (APHRODITE_PREEMPT_BUDGET) damps cascade RECOMPUTE storms:
        # every preempted group re-prefills from scratch, so an
        # undamped round under page pressure evicts half the batch and
        # collapses goodput. Rows still without a free page past the
        # budget SKIP the round holding their pages (no device work, no
        # eviction) and retry next round, when the budgeted preemptions
        # have freed pages.
        preempt_budget = flags.get_int("APHRODITE_PREEMPT_BUDGET")
        self.running = self.policy.sort_by_priority(now, self.running)
        running: Deque[SequenceGroup] = deque()
        preempted: List[SequenceGroup] = []
        deferred: List[SequenceGroup] = []
        reclaimed = False
        while self.running:
            seq_group = self.running.popleft()
            while not self.block_manager.can_append_slot(seq_group):
                if not reclaimed:
                    # First resort under page pressure: pull back
                    # burst/speculative look-ahead pages reserved past
                    # each row's current length before evicting anyone
                    # — a k-token speculative reservation must never
                    # force an eviction cascade while its own unused
                    # pages could cover the shortfall. One sweep per
                    # round (it reclaims everything reclaimable).
                    reclaimed = True
                    if self._reclaim_reservations(
                            (seq_group,), running, self.running) > 0:
                        continue
                if len(preempted) >= preempt_budget:
                    deferred.append(seq_group)
                    break
                if self.running:
                    victim = self.running.pop()
                    self._preempt(victim, blocks_to_swap_out)
                    preempted.append(victim)
                else:
                    self._preempt(seq_group, blocks_to_swap_out)
                    preempted.append(seq_group)
                    break
            else:
                self._append_slot(seq_group, blocks_to_copy)
                running.append(seq_group)
        self.running = running
        decode_groups = list(self.running)
        # Deferred rows stay RUNNING (they keep their pages and their
        # priority) but are not decode rows this round.
        self.running.extend(deferred)

        # 2. Bring swapped groups back while there is room (unless this
        # very step preempted or deferred — swapping both directions is
        # forbidden, and deferred rows mean the pool is exhausted).
        self.swapped = self.policy.sort_by_priority(now, self.swapped)
        if not preempted and not deferred:
            num_curr_seqs = sum(g.get_max_num_running_seqs()
                                for g in self.running)
            curr_loras = (set(g.lora_int_id for g in self.running)
                          if self.lora_enabled else None)
            leftover_swapped: Deque[SequenceGroup] = deque()
            while self.swapped:
                seq_group = self.swapped[0]
                lora_int_id = 0
                if self.lora_enabled:
                    lora_int_id = seq_group.lora_int_id
                    if (lora_int_id > 0 and lora_int_id not in curr_loras
                            and len(curr_loras) >=
                            self.lora_config.max_loras):
                        leftover_swapped.appendleft(seq_group)
                        self.swapped.popleft()
                        continue
                if not self.block_manager.can_swap_in(seq_group):
                    break
                num_new_seqs = seq_group.get_max_num_running_seqs()
                if (num_curr_seqs + num_new_seqs >
                        self.scheduler_config.max_num_seqs):
                    break
                if lora_int_id > 0:
                    curr_loras.add(lora_int_id)
                self.swapped.popleft()
                self._swap_in(seq_group, blocks_to_swap_in)
                self._append_slot(seq_group, blocks_to_copy)
                num_curr_seqs += num_new_seqs
                self.running.append(seq_group)
                decode_groups.append(seq_group)
            self.swapped.extendleft(leftover_swapped)

        # 3. Prompt chunks, sharing the round with the decode batch.
        # Rounds that carry decode work cap prefill at the chunk budget
        # so arrivals cannot stall the decode stream; otherwise the full
        # prefill budget applies. Under memory pressure (a preemption
        # this round, or groups still swapped out) no NEW prompts are
        # admitted — but in-flight chunked prefills keep advancing
        # (their pages are already allocated).
        chunks: List[PromptChunk] = []
        ignored: List[SequenceGroup] = []
        seq_lens: List[int] = []
        full = self.scheduler_config.max_num_batched_tokens
        budget = (self.scheduler_config.max_chunk_tokens
                  if decode_groups and not self.disagg else full)
        if decode_groups and 0 < budget < full and \
                not self.prefilling and \
                not self._waiting_backlog_at_least(full + 1):
            # The ENTIRE waiting queue fits one round (and no chunked
            # prefill is mid-flight, whose tail must keep draining at
            # the chunk budget): absorb it whole alongside the decode
            # burst instead of trickling it in chunk-budget slices —
            # trickled admissions decode at partial batch and finish
            # as stragglers (measured: AWQ batch 423 = 256 +
            # 167-below-the-builder-threshold ran 4.99k -> 3.67k
            # out-tok/s). The price is one decode round stalled by up
            # to a full prefill (~0.6 s at 8k tokens) when a big burst
            # arrives mid-decode; steady low-rate serving arrivals are
            # far below the chunk budget either way.
            budget = full
        if budget > 0:
            self._continue_prefills(seq_lens, budget, chunks)
            if not preempted and not deferred and not self.swapped:
                self._admit_prompts(seq_lens, budget, chunks, ignored)
        elif self.prefilling:
            # max_chunk_tokens == 0 disables chunk-mixing for NEW
            # prompts, but a group mid-prefill (admitted by a
            # batch-building round, which always runs the full budget)
            # already holds its FULL page allocation — if it never
            # advances while decode rows exist it starves holding its
            # pages indefinitely. Keep draining in-flight prefills at
            # the full budget; admission stays disabled.
            self._continue_prefills(seq_lens, full, chunks)

        num_prefill_tokens = (len(seq_lens) * max(seq_lens)
                              if seq_lens else 0)
        num_decode_tokens = sum(
            g.num_seqs(status=SequenceStatus.RUNNING)
            for g in decode_groups)

        return SchedulerOutputs(
            prompt_chunks=chunks,
            decode_groups=decode_groups,
            num_prefill_tokens=num_prefill_tokens,
            num_decode_tokens=num_decode_tokens,
            blocks_to_swap_in=blocks_to_swap_in,
            blocks_to_swap_out=blocks_to_swap_out,
            blocks_to_copy=blocks_to_copy,
            ignored_seq_groups=ignored,
        )

    def _group_metadata(self, seq_group: SequenceGroup, *, is_prompt: bool,
                        chunk: Optional[PromptChunk] = None
                        ) -> SequenceGroupMetadata:
        seq_data: Dict[int, SequenceData] = {}
        block_tables: Dict[int, List[int]] = {}
        persistent_data: Dict[int, dict] = {}
        for seq in seq_group.get_seqs(status=SequenceStatus.RUNNING):
            seq_data[seq.seq_id] = seq.data
            block_tables[seq.seq_id] = (
                self.block_manager.get_block_table(seq))
            persistent_data[seq.seq_id] = seq.persistent_data
        return SequenceGroupMetadata(
            request_id=seq_group.request_id,
            is_prompt=is_prompt,
            seq_data=seq_data,
            sampling_params=seq_group.sampling_params,
            block_tables=block_tables,
            persistent_data=persistent_data,
            prefix=seq_group.prefix,
            lora_request=seq_group.lora_request,
            computed_ctx=chunk.ctx if chunk else 0,
            chunk_len=chunk.length if chunk else None,
            is_final_chunk=chunk.is_final if chunk else True,
        )

    def schedule(
            self) -> Tuple[List[SequenceGroupMetadata], SchedulerOutputs]:
        faultinject.fire("scheduler.schedule")
        self._round_swapped_out = []
        self._round_ignored = []
        try:
            scheduler_outputs = self._schedule()
            seq_group_metadata_list = [
                self._group_metadata(c.group, is_prompt=True, chunk=c)
                for c in scheduler_outputs.prompt_chunks
            ] + [
                self._group_metadata(g, is_prompt=False)
                for g in scheduler_outputs.decode_groups
            ]
            return seq_group_metadata_list, scheduler_outputs
        except Exception:
            # Mid-schedule crash: some admissions/slot appends/chunk
            # advances may have landed, some not — conservatively roll
            # back EVERY in-flight group so a retried schedule starts
            # from a consistent queue + page state.
            self.crash_rollback(None)
            raise

    # -- crash barrier ------------------------------------------------

    def crash_rollback(self, rounds=None) -> List[str]:
        """Roll back this round's scheduler/block-manager mutations
        after a failed step, so a retried step neither leaks KV pages
        nor double-schedules.

        `rounds` is the list of SchedulerOutputs committed by the
        failed engine step (several when the step pipelined builder
        rounds); None means the failure happened MID-SCHEDULE and the
        mutation extent is unknown, so every in-flight group rolls
        back.

        The rollback reuses preemption's RECOMPUTE machinery: a
        single-sequence group drops its pages, resets its computed-
        token count, and re-enters the waiting queue as a fresh prompt
        (original + generated tokens) — re-prefilling reproduces its
        KV exactly, and the failed round's sampled tokens were never
        applied. Groups RECOMPUTE cannot restore (forked KV, or a
        swap-out whose device copy never ran) are aborted; their
        request ids are returned so the caller can propagate the
        failure to exactly those streams. Idempotent: a group already
        rolled back (its seq back to WAITING) is skipped."""
        casualties: List[str] = []

        def abort_group(group: SequenceGroup) -> None:
            casualties.append(group.request_id)
            for queue in (self.waiting, self.prefilling, self.running,
                          self.swapped):
                if group in queue:
                    queue.remove(group)
            for seq in group.get_seqs():
                if seq.is_finished():
                    continue
                seq.status = SequenceStatus.FINISHED_ABORTED
                self.free_seq(seq)

        # Swapped OUT this round: their HBM pages are already freed
        # but the device copy backing the host pages never executed.
        for group in self._round_swapped_out:
            if not group.is_finished():
                abort_group(group)
        self._round_swapped_out = []

        if rounds is None:
            groups = list(self.prefilling) + list(self.running)
        else:
            seen, groups = set(), []
            for out in rounds:
                for group in out.scheduled_seq_groups:
                    if id(group) not in seen:
                        seen.add(id(group))
                        groups.append(group)

        # Reversed: each recompute rollback appendlefts its group, so
        # walking back-to-front restores the groups' RELATIVE order at
        # the head of `waiting` (FCFS survives the rollback — and a
        # reincarnation restore sees the true queue order).
        for group in reversed(groups):
            if group.is_finished():
                # Fully processed before the failure; just make sure it
                # is off the queues (free_finished never ran).
                for queue in (self.running, self.prefilling):
                    if group in queue:
                        queue.remove(group)
                continue
            unfinished = [s for s in group.get_seqs()
                          if not s.is_finished()]
            if len(unfinished) == 1 and \
                    unfinished[0].status == SequenceStatus.WAITING:
                continue        # already rolled back (nested barrier)
            if len(unfinished) == 1 and \
                    unfinished[0].status == SequenceStatus.RUNNING:
                self._rollback_by_recompute(group, unfinished[0])
            else:
                abort_group(group)

        # Re-queue this round's ignored groups so the retried round
        # re-emits their FINISHED_IGNORED outputs (they were already
        # popped from `waiting`; without this their streams hang).
        # Reversed for the same relative-order reason as above.
        for group in reversed(self._round_ignored):
            requeued = False
            for seq in group.get_seqs():
                if seq.status == SequenceStatus.FINISHED_IGNORED:
                    seq.status = SequenceStatus.WAITING
                    requeued = True
            if requeued:
                self.waiting.appendleft(group)
        self._round_ignored = []
        return casualties

    def _rollback_by_recompute(self, group: SequenceGroup,
                               seq: Sequence) -> None:
        """RECOMPUTE-style rollback of one single-sequence group (the
        _preempt_by_recompute seam, applied by object instead of by
        scheduling priority)."""
        for queue in (self.running, self.prefilling):
            if group in queue:
                queue.remove(group)
        seq.status = SequenceStatus.WAITING
        self.block_manager.free(seq)
        seq.data.num_computed_tokens = 0
        self.waiting.appendleft(group)

    def reserve_decode_burst(self, seq_group_metadata_list,
                             max_extra: int, extra_cap=None,
                             groups=None) -> int:
        """Reserve KV pages so the next `1 + returned` decode steps can
        run device-side without host scheduling (multi-step decode).

        Grants the largest t <= max_extra for which every running
        sequence's future slots fit in the free pool, allocates them, and
        refreshes the metadata's block-table snapshots. Returns 0 (plain
        single-step decode) when a shared tail makes slot positions
        CoW-dependent.

        `extra_cap` (seq_id -> int) bounds how many extra slots a
        sequence can actually USE (tokens remaining / model-len room):
        a nearly-finished row reserves only that many pages — the
        device loop clamps its position there — instead of the full
        burst length.

        `groups` restricts the reservation to this round's decode
        groups (a combined round's freshly-admitted prompts are not in
        the burst and must not have burst pages reserved for them).
        """
        groups = self.running if groups is None else groups
        seqs = [
            seq for g in groups
            for seq in g.get_seqs(status=SequenceStatus.RUNNING)
        ]
        if not seqs:
            return 0
        for seq in seqs:
            if not self.block_manager.has_unshared_tail(seq):
                return 0

        def cap(seq, t: int) -> int:
            if extra_cap is None:
                return t
            return min(t, extra_cap.get(seq.seq_id, t))

        # Leave the allocator watermark untouched so speculative burst
        # reservations never starve prompt admission (can_allocate) or
        # peer decode groups (can_append_slot); also keep waiting work
        # from stalling behind long bursts. The admission low-watermark
        # reserve (APHRODITE_PAGE_LOW_WATERMARK + one page per running
        # sequence) is honored too: a k-token speculative reservation
        # is best-effort and must never eat the pages that keep
        # can_append_slot from evicting running groups next round —
        # reservation shrinks, it never forces an eviction cascade.
        free = (self.block_manager.get_num_free_gpu_blocks() -
                self.block_manager.watermark_blocks -
                self._admission_page_reserve())
        granted = 0
        for t in range(1, max_extra + 1):
            needed = sum(
                self.block_manager.burst_blocks_needed(seq, cap(seq, t))
                for seq in seqs)
            if needed > free:
                break
            granted = t
        if granted < max_extra and \
                flags.get_bool("APHRODITE_BURST_TIMING"):
            need_full = sum(
                self.block_manager.burst_blocks_needed(
                    seq, cap(seq, max_extra))
                for seq in seqs)
            print(f"[burst reserve] want {max_extra} granted {granted}: "
                  f"free {free} needed(full) {need_full} seqs "
                  f"{len(seqs)} len0 {seqs[0].get_len()}", flush=True)
        if granted:
            for seq in seqs:
                self.block_manager.reserve_slots(seq, cap(seq, granted))
            for md in seq_group_metadata_list:
                for seq_id in md.block_tables:
                    md.block_tables[seq_id] = \
                        self.block_manager.block_numbers(seq_id)
        return granted

    def prefix_pinned_pages(self) -> int:
        """Pages pinned by the prefix cache (the gauge the /health
        overload section and the bench's exact zero-leak accounting
        read; pinned pages are held on purpose, not leaked)."""
        return self.prefix_pool.pinned_pages()

    def clear_prefixes(self) -> int:
        """Drop every prefix pin and empty the pool, routing the
        pinned pages through the block manager's free seam. Returns
        the number of pages released. Run by `reincarnate()` on the
        torn-down scheduler so a rebuilt pool can never resurrect
        stale pins (and so the old pool's accounting ends exact)."""
        released = 0
        for prefix in self.prefix_pool.clear():
            released += self.block_manager.free_prefix(prefix)
        return released

    def fork_seq(self, parent_seq: Sequence, child_seq: Sequence) -> None:
        self.block_manager.fork(parent_seq, child_seq)

    def free_seq(self, seq: Sequence) -> None:
        self.block_manager.free(seq)

    def free_finished_seq_groups(self) -> None:
        self.running = deque(g for g in self.running if not g.is_finished())

    # ------------------------------------------------------------------

    def _allocate(self, seq_group: SequenceGroup) -> None:
        self.block_manager.allocate(seq_group)
        for seq in seq_group.get_seqs(status=SequenceStatus.WAITING):
            seq.status = SequenceStatus.RUNNING

    def _append_slot(self, seq_group: SequenceGroup,
                     blocks_to_copy: Dict[int, List[int]]) -> None:
        for seq in seq_group.get_seqs(status=SequenceStatus.RUNNING):
            cow = self.block_manager.append_slot(seq)
            if cow is not None:
                src_block, dst_block = cow
                blocks_to_copy.setdefault(src_block, []).append(dst_block)

    def _preempt(
        self,
        seq_group: SequenceGroup,
        blocks_to_swap_out: Dict[int, int],
        preemption_mode: Optional[PreemptionMode] = None,
    ) -> None:
        # Single-sequence groups recompute (cheaper than staging pages to
        # host over PCIe); multi-sequence groups (beam/parallel) must swap
        # because recompute cannot reproduce forked KV state.
        if preemption_mode is None:
            if seq_group.get_max_num_running_seqs() == 1:
                preemption_mode = PreemptionMode.RECOMPUTE
            else:
                preemption_mode = PreemptionMode.SWAP
        if preemption_mode == PreemptionMode.RECOMPUTE:
            self._preempt_by_recompute(seq_group)
        elif preemption_mode == PreemptionMode.SWAP:
            self._preempt_by_swap(seq_group, blocks_to_swap_out)
        else:
            raise AssertionError("Invalid preemption mode.")

    def _preempt_by_recompute(self, seq_group: SequenceGroup) -> None:
        seqs = seq_group.get_seqs(status=SequenceStatus.RUNNING)
        assert len(seqs) == 1
        for seq in seqs:
            seq.status = SequenceStatus.WAITING
            self.block_manager.free(seq)
            # The pages are gone; the re-admitted "prompt" (original +
            # generated tokens) prefills from scratch.
            seq.data.num_computed_tokens = 0
        # FCFS: preempted groups go to the front of the waiting queue.
        self.waiting.appendleft(seq_group)

    def _preempt_by_swap(self, seq_group: SequenceGroup,
                         blocks_to_swap_out: Dict[int, int]) -> None:
        self._swap_out(seq_group, blocks_to_swap_out)
        self.swapped.append(seq_group)
        # Crash barrier: until the device executes this round's swap
        # plan, the group's host pages are garbage (see crash_rollback).
        self._round_swapped_out.append(seq_group)

    def _swap_in(self, seq_group: SequenceGroup,
                 blocks_to_swap_in: Dict[int, int]) -> None:
        mapping = self.block_manager.swap_in(seq_group)
        blocks_to_swap_in.update(mapping)
        for seq in seq_group.get_seqs(status=SequenceStatus.SWAPPED):
            seq.status = SequenceStatus.RUNNING

    def _swap_out(self, seq_group: SequenceGroup,
                  blocks_to_swap_out: Dict[int, int]) -> None:
        if not self.block_manager.can_swap_out(seq_group):
            raise RuntimeError(
                "Aborted due to the lack of CPU swap space. Please increase "
                "the swap space to avoid this error.")
        mapping = self.block_manager.swap_out(seq_group)
        blocks_to_swap_out.update(mapping)
        for seq in seq_group.get_seqs(status=SequenceStatus.RUNNING):
            seq.status = SequenceStatus.SWAPPED
