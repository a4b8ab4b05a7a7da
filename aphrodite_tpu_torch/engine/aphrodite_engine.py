"""The core engine of the PyTorch port: request lifecycle + step loop.

The JAX package's engine (`aphrodite_tpu/engine/aphrodite_engine.py`)
copied, with these changes: the single-GPU `GPUExecutor` replaces
`TPUExecutor`; the JAX compilation cache and `jax.profiler` hooks are
gone; the tokenizer and the Prometheus metrics are imported only when
asked for (`skip_tokenizer_init=True` and `log_stats=False` need
neither `transformers` nor `prometheus_client`). `step()` is
schedule -> executor -> process outputs, with the same round kinds
(combined prompt + decode rounds, pipelined prompt rounds, decode
bursts), stop conditions, beam search and crash barrier.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import (Callable, Dict, Iterable, List, Optional, Tuple,
                    Union)

from aphrodite_tpu_torch.common import faultinject, flags
from aphrodite_tpu_torch.common.config import (CacheConfig, DeviceConfig,
                                         LoRAConfig, ModelConfig,
                                         ParallelConfig, SchedulerConfig)
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.outputs import RequestOutput
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.sequence import (SamplerOutput, Sequence,
                                           SequenceGroup,
                                           SequenceGroupOutput,
                                           SequenceStatus)
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.engine.supervisor import (FaultClass,
                                             RequestLostOnRebuild,
                                             StaleEngineStepError,
                                             classify_failure)
from aphrodite_tpu_torch.executor.executor import GPUExecutor
from aphrodite_tpu_torch.processing.admission import (AdmissionController,
                                                AdmissionSnapshot,
                                                RequestTimeoutError)
from aphrodite_tpu_torch.processing.drafter import NgramDrafter
from aphrodite_tpu_torch.processing.scheduler import (Scheduler,
                                                SchedulerOutputs)
from aphrodite_tpu_torch.common.utils import Counter

logger = init_logger(__name__)


@dataclasses.dataclass
class ReincarnationOutcome:
    """What one engine rebuild restored vs lost (health counters)."""
    restored: int
    lost: List[str]


class AphroditeEngine:
    """Synchronous engine; AsyncAphrodite wraps it for serving."""

    def __init__(
        self,
        model_config: ModelConfig,
        cache_config: CacheConfig,
        parallel_config: ParallelConfig,
        scheduler_config: SchedulerConfig,
        device_config: DeviceConfig,
        lora_config: Optional[LoRAConfig],
        log_stats: bool = False,
        skip_tokenizer_init: bool = False,
    ) -> None:
        logger.info(
            "Initializing engine: model=%r dtype=%s max_len=%d "
            "tp=%d pp=%d dp=%d kv_dtype=%s seed=%d",
            model_config.model, model_config.dtype,
            model_config.max_model_len,
            parallel_config.tensor_parallel_size,
            parallel_config.pipeline_parallel_size,
            parallel_config.data_parallel_size,
            cache_config.cache_dtype, model_config.seed)
        self.model_config = model_config
        self.cache_config = cache_config
        self.parallel_config = parallel_config
        self.scheduler_config = scheduler_config
        self.device_config = device_config
        self.lora_config = lora_config
        self.log_stats = log_stats

        if skip_tokenizer_init:
            self.tokenizer = None
        else:
            self._init_tokenizer()
        self.seq_counter = Counter()

        self.executor = GPUExecutor(model_config, cache_config,
                                    parallel_config, scheduler_config,
                                    device_config, lora_config)
        self.scheduler = Scheduler(scheduler_config, cache_config,
                                   lora_config,
                                   disagg=parallel_config.disagg)
        # Self-drafting speculative decoding: host-side prompt-lookup
        # drafter feeding the widened verify dispatch (_spec_round).
        # Advisory per-seq acceptance state only — it survives
        # reincarnation harmlessly (seq_ids never repeat).
        self.drafter = NgramDrafter()
        # Overload control: throughput EWMAs + shed/expired counters
        # (processing/admission.py). The async frontend consults it
        # via try_admit BEFORE a request touches the tracker.
        self.admission = AdmissionController()
        self.stat_logger = None
        if log_stats:
            from aphrodite_tpu_torch.engine.metrics import StatLogger
            self.stat_logger = StatLogger(
                labels=dict(model_name=model_config.model))
        # Latency samples accumulated between stat-logger flushes.
        self._ttft_samples: List[float] = []
        self._tpot_samples: List[float] = []
        self._e2e_samples: List[float] = []
        self._profiling = False
        # Fault-isolation bookkeeping: (request_id, exception) pairs
        # for requests aborted by request-scoped failures or crash-
        # barrier casualties this step; the async layer drains them and
        # propagates each exception to exactly that stream.
        # thread-safe: two-world by design — the step thread appends
        # (inside step()/reincarnate(), which the loop awaits) and the
        # loop drains strictly BETWEEN those awaits via a list swap
        # that is atomic under the GIL; the two writers never run
        # concurrently.
        self._step_faults: List[Tuple[str, Exception]] = []
        # Continuations whose emitted output already satisfied a stop
        # condition on arrival: finished groups whose RequestOutput
        # the next step delivers without scheduling any device work.
        # thread-safe: same sequencing as _step_faults — the loop
        # appends (add_request) strictly BETWEEN the awaits that run
        # step(), and step() drains via an atomic list swap; the two
        # writers never run concurrently.
        self._arrival_finished: List[SequenceGroup] = []
        # SchedulerOutputs committed by the current step (several when
        # the step pipelines builder rounds) — the crash barrier's
        # rollback scope.
        self._inflight_rounds: List[SchedulerOutputs] = []
        # Reincarnation epoch: bumped by reincarnate(). Each step
        # thread stamps the epoch it started under in thread-local
        # storage; a step that outlives a rebuild (a watchdog-
        # abandoned thread waking up) sees the mismatch and raises
        # StaleEngineStepError instead of committing tokens or
        # rollbacks against the rebuilt scheduler.
        self._epoch = 0
        self._step_tls = threading.local()
        # Optional lifecycle-stats provider (set by the async wrapper:
        # health state code, reincarnation counters, drain remaining)
        # merged into every Stats snapshot for Prometheus.
        self.lifecycle_source: Optional[Callable[[], Dict]] = None

    # -- construction --

    @classmethod
    def from_engine_args(cls, engine_args: EngineArgs) -> "AphroditeEngine":
        configs = engine_args.create_engine_configs()
        engine = cls(*configs, log_stats=not engine_args.disable_log_stats,
                     skip_tokenizer_init=engine_args.skip_tokenizer_init)
        return engine

    def _init_tokenizer(self, **kwargs) -> None:
        init_kwargs = dict(
            enable_lora=bool(self.lora_config),
            max_num_seqs=self.scheduler_config.max_num_seqs,
            max_input_length=None,
            tokenizer_mode=self.model_config.tokenizer_mode,
            trust_remote_code=self.model_config.trust_remote_code,
            tokenizer_revision=self.model_config.tokenizer_revision)
        init_kwargs.update(kwargs)
        from aphrodite_tpu_torch.transformers_utils.tokenizer import (
            TokenizerGroup)
        self.tokenizer = TokenizerGroup(self.model_config.tokenizer,
                                        **init_kwargs)

    # -- request lifecycle --

    def add_request(
        self,
        request_id: str,
        prompt: Optional[str],
        sampling_params: SamplingParams,
        prompt_token_ids: Optional[List[int]] = None,
        arrival_time: Optional[float] = None,
        prefix_pos: Optional[int] = None,
        lora_request=None,
        emitted_token_ids: Optional[List[int]] = None,
    ) -> None:
        """Tokenize, build the seq group, hand to the scheduler
        (reference add_request :387-469).

        `emitted_token_ids` is the CONTINUATION form (the mid-stream
        failover resume seam): the request previously generated these
        output tokens on another replica (or a prior incarnation) and
        must continue from them. The tokens enter the sequence as
        already-sampled OUTPUT tokens, so:

        - chunked prefill rebuilds their KV exactly like a RECOMPUTE-
          preempted request (the "prompt" is original + generated, and
          prefix-cache hits make the rebuild cheap);
        - the sampler's seeded per-row PRNG salt — derived from the
          OUTPUT length (`sampler._key_parts`) — continues at position
          n, so seeded requests resume bit-identically;
        - `max_tokens`, stop strings, EOS, and length penalties are
          evaluated over the JOINT output (baseline text included, so
          a stop string may span the splice boundary);
        - incremental detokenization replays the emitted tokens
          through the same per-token path the original stream took,
          so the continuation resumes mid-word cleanly and
          `resumed_text` is byte-equal to what the client already
          received.

        A continuation whose emitted output already satisfies a stop
        condition is resolved on arrival (its finished RequestOutput
        is delivered by the next step without scheduling any work).
        """
        if lora_request is not None and not self.lora_config:
            raise ValueError("LoRA is not enabled (set enable_lora).")
        if arrival_time is None:
            # replay-ok: arrival stamp orders FCFS admission, never tokens
            # (token values derive from seed + output position alone)
            arrival_time = time.monotonic()
        if prompt_token_ids is None:
            assert prompt is not None
            prompt_token_ids = self.tokenizer.encode(prompt)

        block_size = self.cache_config.block_size
        seq_id = next(self.seq_counter)
        seq = Sequence(seq_id, prompt, prompt_token_ids, block_size,
                       lora_request=lora_request)

        if emitted_token_ids:
            if (sampling_params.n > 1 or sampling_params.best_of > 1
                    or sampling_params.use_beam_search):
                raise ValueError(
                    "continuation (emitted_token_ids) supports "
                    "single-sequence requests only (n=1, best_of=1, "
                    "no beam search)")
            # Replay the emitted tokens through the exact per-token
            # append + incremental-detok path the original stream
            # took: identical detok state evolution means identical
            # text, so the resumed deltas splice mid-word cleanly.
            for tid in emitted_token_ids:
                seq.append_token_id(int(tid), {int(tid): 0.0})
                self._decode_sequence(seq, sampling_params)

        prefix = None
        if prefix_pos is not None:
            prefix = self.scheduler.prefix_pool.intern(
                prompt_token_ids[:prefix_pos])

        seq_group = SequenceGroup(request_id, [seq], sampling_params,
                                  arrival_time, prefix=prefix,
                                  lora_request=lora_request,
                                  deadline=self._deadline_of(
                                      sampling_params, arrival_time))
        if emitted_token_ids:
            seq_group.resumed_tokens = len(emitted_token_ids)
            # The joint output may already satisfy a stop condition
            # (the original replica died between its last token and
            # the stream's closing writes): resolve on arrival
            # instead of scheduling a round that would overrun the
            # stop. The baseline text is captured AFTER the stop
            # check, which strips a matched stop string exactly like
            # the original stream did before the client saw it.
            self._check_stop(seq, sampling_params)
            seq_group.resumed_text = seq.output_text
            if not seq.is_finished() and \
                    sampling_params.max_tokens is not None and \
                    seq.get_output_len() >= sampling_params.max_tokens:
                seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
            if seq.is_finished():
                self._arrival_finished.append(seq_group)
                return
        self.scheduler.add_seq_group(seq_group)

    @staticmethod
    def _deadline_of(sampling_params: SamplingParams,
                     arrival_time: float) -> Optional[float]:
        """Absolute TTFT deadline (monotonic clock) from the request's
        `ttft_slo_s` or the APHRODITE_DEFAULT_TTFT_SLO_S default;
        None when neither sets a deadline."""
        slo = sampling_params.ttft_slo_s
        if slo is None:
            slo = flags.get_float("APHRODITE_DEFAULT_TTFT_SLO_S")
        if not slo or slo <= 0:
            return None
        return arrival_time + slo

    # -- overload control (processing/admission.py) --

    def admission_limits(self) -> Tuple[int, int]:
        """(max queue depth, max queued prefill tokens) with the
        0 = derived defaults resolved against the scheduler config."""
        depth = flags.get_int("APHRODITE_MAX_QUEUE_DEPTH")
        if depth <= 0:
            depth = 16 * self.scheduler_config.max_num_seqs
        tokens = flags.get_int("APHRODITE_MAX_WAITING_TOKENS")
        if tokens <= 0:
            tokens = 8 * self.scheduler_config.max_num_batched_tokens
        return depth, tokens

    def try_admit(self, num_tokens: int,
                  sampling_params: SamplingParams,
                  extra_depth: int = 0, extra_tokens: int = 0) -> None:
        """Admission gate for a new request of ~`num_tokens` prompt
        tokens: raises RequestRejectedError (with a Retry-After
        estimate) when the queue caps or the request's predicted TTFT
        vs its deadline say it cannot be served in time. Touches no
        allocator state — a shed request costs queue inspection only.
        `extra_depth`/`extra_tokens` account load the async tracker
        holds that has not reached the scheduler queue yet."""
        slo = sampling_params.ttft_slo_s
        if slo is None:
            slo = flags.get_float("APHRODITE_DEFAULT_TTFT_SLO_S")
        max_depth, max_tokens = self.admission_limits()
        self.admission.admit_or_raise(
            num_tokens=num_tokens,
            deadline_s=slo if slo and slo > 0 else None,
            queue_depth=len(self.scheduler.waiting) + extra_depth,
            queued_tokens=(self.scheduler.waiting_prefill_tokens() +
                           extra_tokens),
            max_depth=max_depth, max_tokens=max_tokens)

    def overload_snapshot(self) -> AdmissionSnapshot:
        """Queue depth, queued prefill tokens, shed/expired counters,
        and throughput EWMAs — serialized into /health (the metrics
        rider) so load balancers see DEGRADED-while-shedding before
        DEAD."""
        return self.admission.snapshot(
            queue_depth=len(self.scheduler.waiting),
            waiting_tokens=self.scheduler.waiting_prefill_tokens(),
            prefix_pinned_pages=self.scheduler.prefix_pinned_pages())

    def _check_epoch(self) -> None:
        """Epoch guard for off-loop scheduler commits: a step thread
        that outlived a reincarnation (watchdog-abandoned, woke up
        later) must raise instead of touching the rebuilt scheduler —
        its groups were already restored or errored by the rebuild."""
        if getattr(self._step_tls, "epoch", self._epoch) != self._epoch:
            raise StaleEngineStepError(
                "engine step outlived a reincarnation; refusing to "
                "touch the rebuilt scheduler")

    def _expire_deadlines(self) -> None:
        """Expire deadline-missed groups still in `waiting` (never
        computed — no pages, no schedule round) and record a typed
        RequestTimeoutError for each stream via the step-fault seam."""
        self._check_epoch()
        expired = self.scheduler.expire_waiting(time.monotonic())
        if not expired:
            return
        self.admission.record_expired(len(expired))
        for group in expired:
            self._step_faults.append((group.request_id,
                                      RequestTimeoutError(
                f"request {group.request_id} missed its TTFT deadline "
                "while queued (never scheduled); shed by deadline "
                "expiry")))

    def abort_request(self, request_id: Union[str, Iterable[str]]) -> None:
        self.scheduler.abort_seq_group(request_id)

    def get_model_config(self) -> ModelConfig:
        return self.model_config

    def get_num_unfinished_requests(self) -> int:
        # Arrival-resolved continuations count until step() delivers
        # their outputs (a caller looping on this must keep stepping).
        return (self.scheduler.get_num_unfinished_seq_groups() +
                len(self._arrival_finished))

    def has_unfinished_requests(self) -> bool:
        return bool(self._arrival_finished) or \
            self.scheduler.has_unfinished_seqs()

    # -- the step --

    def step(self) -> List[RequestOutput]:
        """One engine iteration = one scheduling round. A round carries
        prompt chunks and/or a decode batch (chunked prefill: both ride
        one round, reference step :754-828 runs one or the other); an
        eligible decode batch with multi_step>1 runs as a device-side
        burst of K tokens per seq. A combined round enqueues the prefill
        program and the burst back-to-back and pays ONE host sync.

        Failure semantics (the crash barrier): if anything after
        scheduling fails, every mutation of this round — scheduled
        groups, freshly allocated/forked pages, swap/copy plans — is
        rolled back via `Scheduler.crash_rollback` before the exception
        propagates, so a retried step neither leaks KV pages nor
        double-schedules. Requests the rollback could not restore are
        recorded in `_step_faults` (drained by `drain_step_faults`)."""
        self._step_tls.epoch = self._epoch
        faultinject.fire("engine.step")
        self._inflight_rounds = []
        self._expire_deadlines()
        seq_group_metadata_list, scheduler_outputs = \
            self.scheduler.schedule()
        self._inflight_rounds.append(scheduler_outputs)
        # Continuations resolved on arrival (emitted output already at
        # a stop): deliver their finished outputs ahead of the round.
        # Drained only once scheduling succeeded, so a mid-schedule
        # crash retries with them still stashed.
        resolved: List[SequenceGroup] = []
        if self._arrival_finished:
            resolved, self._arrival_finished = self._arrival_finished, []
        try:
            outputs = self._execute_round(seq_group_metadata_list,
                                          scheduler_outputs)
            if resolved:
                outputs = [RequestOutput.from_seq_group(g)
                           for g in resolved] + outputs
            return outputs
        except Exception as exc:
            # Re-stash arrival-resolved outputs so a retried step (or
            # the reincarnation restore) still delivers them.
            self._arrival_finished = resolved + self._arrival_finished
            if self._step_tls.epoch != self._epoch:
                # The engine reincarnated under this step (a watchdog-
                # abandoned thread waking up): the rounds it holds
                # belong to the torn-down scheduler — rolling them
                # back against the rebuilt one would corrupt restored
                # requests.
                raise StaleEngineStepError(
                    "engine step outlived a reincarnation; its "
                    "rollback is discarded") from exc
            for rid in self.scheduler.crash_rollback(
                    self._inflight_rounds):
                err: Exception = RuntimeError(
                    f"request {rid} aborted: its KV state could not "
                    "be rolled back after a failed engine step "
                    f"({type(exc).__name__}: {exc})")
                err.__cause__ = exc
                self._step_faults.append((rid, err))
            raise

    # -- reincarnation (FATAL-fault recovery) --------------------------

    def reincarnate(self) -> "ReincarnationOutcome":
        """Tear down and rebuild the device half of the engine after a
        FATAL step fault, restoring every restorable request.

        The executor (model, runner, KV pool) and the scheduler (block
        manager, prefix pool, queues) are rebuilt from the original
        configs, so the free-page count returns exactly to its boot
        value. Restorable requests — everything the crash barrier can
        express as a recompute prompt, i.e. single-sequence groups plus
        anything still waiting — re-enter the fresh waiting queue in
        FCFS order with their prefixes re-keyed into the new prefix
        pool (the old pool's KV pages are gone; a re-keyed prefix
        simply recomputes). Un-restorable groups (forked beam KV,
        swapped-out pages whose host copies die with the pool) get a
        typed :class:`RequestLostOnRebuild` on the step-fault seam.

        Bumps the reincarnation epoch so a step that was still wedged
        in the OLD executor when the watchdog abandoned it can never
        commit tokens or rollbacks against the rebuilt state
        (:class:`StaleEngineStepError`). Blocking (model load + cache
        init); the async wrapper runs it off-loop under REBUILDING.
        """
        self._epoch += 1
        old_sched = self.scheduler
        # Conservatively roll back anything mid-flight (idempotent —
        # the step's own crash barrier usually already ran).
        lost = list(old_sched.crash_rollback(None))
        # Swapped-out groups: their KV lives in the host pool this
        # rebuild discards, and recompute cannot reproduce it.
        for group in list(old_sched.swapped):
            lost.append(group.request_id)
            old_sched.abort_seq_group(group.request_id)
        restorable = [g for g in old_sched.waiting
                      if not g.is_finished()]
        # Drop the old pool's prefix pins THROUGH the free seam: the
        # torn-down scheduler's accounting ends exact (free pages ==
        # boot value, pinned gauge 0) and no stale pin can be
        # resurrected into the rebuilt pool.
        old_sched.clear_prefixes()
        logger.warning(
            "Reincarnating engine: rebuilding executor + KV pool, "
            "restoring %d request(s), %d unrestorable.",
            len(restorable), len(lost))
        # Device half first: if THIS throws the engine is beyond
        # saving and the caller falls through to DEAD.
        self.executor = GPUExecutor(self.model_config, self.cache_config,
                                    self.parallel_config,
                                    self.scheduler_config,
                                    self.device_config, self.lora_config)
        self.scheduler = Scheduler(self.scheduler_config,
                                   self.cache_config, self.lora_config,
                                   disagg=self.parallel_config.disagg)
        for group in restorable:
            if group.prefix is not None:
                group.prefix = self.scheduler.prefix_pool.intern(
                    group.prefix.token_ids)
            self.scheduler.add_seq_group(group)
        self._inflight_rounds = []
        for rid in lost:
            self._step_faults.append((rid, RequestLostOnRebuild(
                f"request {rid} could not be restored across an "
                "engine rebuild (forked or swapped KV state is not "
                "recomputable from tokens)")))
        return ReincarnationOutcome(restored=len(restorable),
                                    lost=lost)

    def drain_step_faults(self) -> List[Tuple[str, Exception]]:
        """(request_id, exception) pairs for requests this step aborted
        with request-scoped blast radius; each exception belongs to
        exactly that request's stream."""
        faults, self._step_faults = self._step_faults, []
        return faults

    def _execute_round(self, seq_group_metadata_list,
                       scheduler_outputs) -> List[RequestOutput]:
        if scheduler_outputs.is_empty():
            return self._process_round(None, [], scheduler_outputs)

        n_chunks = len(scheduler_outputs.prompt_chunks)
        prompt_mds = seq_group_metadata_list[:n_chunks]
        decode_mds = seq_group_metadata_list[n_chunks:]

        if decode_mds and not prompt_mds:
            # Speculative round first: when the drafter has proposals,
            # one verify dispatch can emit up to k+1 tokens per row —
            # strictly better amortization of the weight stream than
            # the burst scan's one token per device step. Falls back
            # to the classic burst/single-step path (None) whenever
            # drafting or eligibility fails.
            spec = self._spec_round(decode_mds, scheduler_outputs)
            if spec is not None:
                return spec

        burst, extra_cap = (self._burst_steps(decode_mds,
                                              scheduler_outputs)
                            if decode_mds else (1, None))

        if prompt_mds and decode_mds:
            prompt_output, decode_outputs = \
                self.executor.execute_combined(
                    prompt_mds, decode_mds,
                    scheduler_outputs.blocks_to_swap_in,
                    scheduler_outputs.blocks_to_swap_out,
                    scheduler_outputs.blocks_to_copy,
                    num_steps=burst, extra_cap=extra_cap)
            self._flush_kv_handoff(prompt_mds)
            return self._process_round(prompt_output, decode_outputs,
                                       scheduler_outputs)

        if decode_mds and burst > 1:
            outputs_list = self.executor.execute_decode_burst(
                decode_mds,
                scheduler_outputs.blocks_to_swap_in,
                scheduler_outputs.blocks_to_swap_out,
                scheduler_outputs.blocks_to_copy,
                num_steps=burst, extra_cap=extra_cap)
            return self._process_round(None, outputs_list,
                                       scheduler_outputs)

        if prompt_mds and not scheduler_outputs.blocks_to_swap_in \
                and not scheduler_outputs.blocks_to_swap_out \
                and self._prompt_fast_path_ok(prompt_mds):
            pipelined = self._pipelined_prompt_rounds(
                prompt_mds, scheduler_outputs)
            if pipelined is not None:
                return pipelined

        output = self.executor.execute_model(
            seq_group_metadata_list,
            scheduler_outputs.blocks_to_swap_in,
            scheduler_outputs.blocks_to_swap_out,
            scheduler_outputs.blocks_to_copy)
        if prompt_mds:
            self._flush_kv_handoff(prompt_mds)
            return self._process_round(output, [], scheduler_outputs)
        return self._process_round(None, [output], scheduler_outputs)

    def _flush_kv_handoff(self, prompt_mds) -> None:
        """Disagg only: push the pages of every group whose FINAL
        prompt chunk ran this round from the prefill pool to the decode
        pool, batched into one executor.kv_handoff flush. Timing is the
        invariant: the group enters decode no earlier than the NEXT
        round, and its pages are still owned here (a free can only
        follow _process_round), so the decode pool always sees the full
        prefix before the first decode step reads it. Non-final chunks
        stay prefill-local — their KV is only ever read by later chunks
        on the same submesh."""
        if not self.executor.disagg:
            return
        pages = set()
        for md in prompt_mds:
            if md.is_prompt and md.is_final_chunk:
                for table in md.block_tables.values():
                    pages.update(table)
        if pages:
            self.executor.kv_handoff(sorted(pages))

    @staticmethod
    def _prompt_fast_path_ok(prompt_mds) -> bool:
        """Cheap metadata-level precheck mirroring EVERY one of
        dispatch_prompt's authoritative plan-based bail conditions
        (logits processors, need_logprobs, max_best_of != 1,
        num_topk != 0), so rounds the dispatch would bail on skip the
        pipelined probe instead of paying the padded batch build
        twice."""
        for md in prompt_mds:
            p = md.sampling_params
            if (p.logits_processors or p.use_beam_search
                    or p.prompt_logprobs is not None or p.best_of > 1
                    # plan.num_topk mirror: the fused program pulls
                    # top-k logprob rows whenever any row requests
                    # >= 1 logprobs; logprobs=0 keeps num_topk at 0
                    # and stays on the fast path (the sampled token's
                    # own logprob always rides in the packed result).
                    or (p.logprobs or 0) > 0):
                return False
        return True

    def _pipelined_prompt_rounds(self, prompt_mds, scheduler_outputs):
        """Batch-building: enqueue up to 4 consecutive pure-prefill
        rounds (they touch disjoint fresh groups and depend on no
        sampled token) and pay ONE sync — each avoided round saves a
        host<->device round trip plus the inter-round host gap. Returns
        None when the sampling config needs the synced path."""
        handle = self.executor.dispatch_prompt_round(
            prompt_mds, scheduler_outputs.blocks_to_copy)
        if handle is None:
            return None
        # Off-loop admission commits follow (schedule_prompt_only
        # allocates pages and advances chunk progress): never against
        # a scheduler this step does not own.
        self._check_epoch()
        rounds = [scheduler_outputs]
        handles = [handle]
        all_prompt_mds = list(prompt_mds)
        while len(handles) < 4:
            nxt = self.scheduler.schedule_prompt_only()
            if nxt is None:
                break
            mds2, outputs2 = nxt
            if not mds2:
                # Ignored-only round (over-limit prompts dropped, none
                # admitted): no device work, but the FINISHED_IGNORED
                # outputs must still flow to their streams.
                rounds.append(outputs2)
                self._inflight_rounds.append(outputs2)
                handles.append([])
                break
            # schedule_prompt_only() has already committed this round's
            # admissions (pages allocated, chunk progress advanced), so
            # an ineligible round must still EXECUTE — synced — not be
            # dropped: its KV writes and sampled tokens are owed.
            self._inflight_rounds.append(outputs2)
            all_prompt_mds.extend(mds2)
            h2 = None
            if self._prompt_fast_path_ok(mds2):
                h2 = self.executor.dispatch_prompt_round(
                    mds2, outputs2.blocks_to_copy)
            rounds.append(outputs2)
            if h2 is None:
                # Raw-logits sampling config mid-stream: run this round
                # synced THROUGH THE EXECUTOR (prompt-only rounds carry
                # no swaps, but outputs2's CoW copy plan and the LoRA
                # adapter activation must still apply — a direct
                # model_runner call silently dropped blocks_to_copy);
                # earlier dispatches are already in flight and touch
                # disjoint groups.
                out2 = self.executor.execute_model(
                    mds2, {}, {}, outputs2.blocks_to_copy)
                handles.append(out2)        # already finalized
                break
            handles.append(h2)
        # Disagg: hand off every final-chunk group of the batch-built
        # rounds BEFORE the finalize sync — the handoff gather chains
        # on the in-flight prompt programs' donated pool handles (JAX
        # data dependency), so the ICI transfer rides inside the one
        # sync we were paying anyway.
        self._flush_kv_handoff(all_prompt_mds)
        pending = [h for h in handles if hasattr(h, "packed")]
        finalized = iter(self.executor.finalize_prompt_rounds(pending))
        request_outputs = []
        for outputs_i, h in zip(rounds, handles):
            out_i = next(finalized) if hasattr(h, "packed") else h
            request_outputs.extend(
                self._process_round(out_i, [], outputs_i))
        return request_outputs

    def _burst_steps(self, seq_group_metadata_list,
                     scheduler_outputs):
        """(burst length, per-seq useful-step caps) for this round —
        the caps map is the single source of truth shared by the page
        reservation and the device position clamp.

        Eligible: decode round, no sliding window, and every group is a
        single-sequence greedy/random group without history-dependent
        sampling stages (penalties, mirostat), custom processors, or
        full-logprob needs — everything the device loop can't feed back.
        """
        max_steps = self.scheduler_config.multi_step
        if max_steps <= 1:
            return 1, None
        if self.model_config.get_sliding_window() is not None:
            return 1, None
        remaining = []
        extra_cap = {}          # seq_id -> max USEFUL extra slots
        for md in seq_group_metadata_list:
            p = md.sampling_params
            if (len(md.seq_data) != 1 or p.use_beam_search
                    or p.logits_processors or p.mirostat_mode == 2
                    or p.prompt_logprobs is not None
                    or abs(p.presence_penalty) >= 1e-5
                    or abs(p.frequency_penalty) >= 1e-5
                    or abs(p.repetition_penalty - 1.0) >= 1e-5):
                return 1, None
            seq_id = next(iter(md.seq_data))
            data = md.seq_data[seq_id]
            # Per-row useful steps: tokens remaining (unbounded groups
            # want the full burst) clamped by model-len room. The burst
            # may run PAST a row's cap — the device loop pins the row's
            # position at its last reserved slot (ModelRunner._burst_step
            # pos_cap) — so a nearly-finished row neither shortens the
            # burst nor inflates the page reservation.
            r = max_steps if p.max_tokens is None else \
                p.max_tokens - data.get_output_len()
            r = max(0, min(r, self.scheduler_config.max_model_len -
                           data.get_len()))
            remaining.append(r)
            extra_cap[seq_id] = r
        want = max(1, min(max_steps,
                          max(remaining) if remaining else max_steps))
        if want <= 1:
            return 1, None
        # Bucket to powers of two: each burst length is its own compiled
        # scan program, and compiles are expensive. Round UP when the
        # overshoot is small (overshot rows' extra tokens are dropped by
        # _process_round): e.g. 31 remaining runs one 32-burst
        # instead of the 16+8+4+2+1 ladder of ever-worse per-step
        # rates. Round DOWN when the waste would exceed the per-burst
        # overhead (~2-3 steps' worth of device time).
        up = 1 << (want - 1).bit_length()
        if up - want <= max(2, up // 8) and up <= max_steps:
            want = up
        else:
            want = 1 << (want.bit_length() - 1)
        # Blocks reserved beyond the bucketed length stay on the
        # sequences' block tables and satisfy the next round's
        # reservation.
        self._check_epoch()
        granted = self.scheduler.reserve_decode_burst(
            seq_group_metadata_list, want - 1, extra_cap,
            groups=scheduler_outputs.decode_groups)
        return 1 << ((1 + granted).bit_length() - 1), extra_cap

    # -- speculative decoding (self-drafting verify rounds) --

    def _spec_eligible(self, decode_mds) -> bool:
        """Every group must fit the fused-sampler verify dispatch:
        the burst-scan conditions (single-seq, no beam / custom
        processors / mirostat-2 / prompt logprobs / history-dependent
        penalties) PLUS no per-token logprob requests and best_of=1 —
        the verify step reuses the pinned fast-path program
        (max_best_of=1, num_topk=0), and a single ineligible row
        routes the whole round to the classic path."""
        for md in decode_mds:
            p = md.sampling_params
            if (len(md.seq_data) != 1 or p.use_beam_search
                    or p.logits_processors or p.mirostat_mode == 2
                    or p.prompt_logprobs is not None
                    or (p.logprobs or 0) > 0 or p.best_of > 1
                    or abs(p.presence_penalty) >= 1e-5
                    or abs(p.frequency_penalty) >= 1e-5
                    or abs(p.repetition_penalty - 1.0) >= 1e-5):
                return False
        return True

    def _spec_round(self, decode_mds,
                    scheduler_outputs) -> Optional[List[RequestOutput]]:
        """One speculative decode round, or None for the classic path.

        Drafts per sequence from its own joint (prompt + output) token
        history, reserves KV pages for the drafted positions through
        the same watermark-respecting seam as the burst scan, verifies
        all rows in one widened dispatch, and applies the accepted
        runs. `APHRODITE_SPEC=0` pins the classic path for A/B."""
        if not flags.get_bool("APHRODITE_SPEC"):
            return None
        if self.model_config.get_sliding_window() is not None:
            return None
        if not self._spec_eligible(decode_mds):
            return None

        k_max = flags.get_int("APHRODITE_SPEC_K")
        drafts: Dict[int, List[int]] = {}
        extra_cap: Dict[int, int] = {}
        for md in decode_mds:
            (seq_id,) = md.seq_data.keys()
            data = md.seq_data[seq_id]
            p = md.sampling_params
            draft = self.drafter.propose(seq_id, data.get_token_ids(),
                                         k_max)
            # Clamp to USEFUL width: the round emits up to k+1 tokens,
            # and the verify rows write KV at positions L-1+j, so k is
            # bounded by model-len room and tokens remaining.
            room = self.scheduler_config.max_model_len - data.get_len()
            if p.max_tokens is not None:
                room = min(room,
                           p.max_tokens - data.get_output_len() - 1)
            draft = draft[:max(0, room)]
            drafts[seq_id] = draft
            extra_cap[seq_id] = len(draft)
        want = max(extra_cap.values(), default=0)
        if want <= 0:
            return None

        # Page reservation for the drafted positions — same seam and
        # same watermark/preempt-budget discipline as the burst scan
        # (reserve_decode_burst honors the allocator watermark AND the
        # admission low-watermark reserve; it shrinks the grant, never
        # evicts). A zero grant under pressure degrades to classic.
        self._check_epoch()
        granted = self.scheduler.reserve_decode_burst(
            decode_mds, want, extra_cap,
            groups=scheduler_outputs.decode_groups)
        if granted < want:
            drafts = {sid: d[:granted] for sid, d in drafts.items()}
        if not any(drafts.values()):
            return None

        results = self.executor.execute_spec_verify(
            decode_mds, drafts,
            scheduler_outputs.blocks_to_swap_in,
            scheduler_outputs.blocks_to_swap_out,
            scheduler_outputs.blocks_to_copy)
        return self._process_spec_round(results, scheduler_outputs)

    def _process_spec_round(
            self, results,
            scheduler_outputs: SchedulerOutputs) -> List[RequestOutput]:
        """Apply each group's accepted token run (multi-token append +
        incremental detok per token; tokens past a stop are dropped)
        and feed the drafter's acceptance EWMA."""
        if getattr(self._step_tls, "epoch", self._epoch) != self._epoch:
            raise StaleEngineStepError(
                "engine step outlived a reincarnation; its outputs "
                "are discarded")
        decode_groups = scheduler_outputs.decode_groups
        tokens_of = {}
        failed: set = set()
        for group, res in zip(decode_groups, results):
            tokens_of[id(group)] = 0
            if group.is_finished():
                continue
            seq = group.get_seqs(status=SequenceStatus.RUNNING)[0]
            before = seq.get_output_len()
            outputs = SequenceGroupOutput(list(res.samples), None)
            if self._process_group_isolated(group, outputs,
                                            multi_token=True):
                tokens_of[id(group)] = seq.get_output_len() - before
                if res.proposed:
                    self.drafter.observe(seq.seq_id, res.proposed,
                                         res.accepted)
                if seq.is_finished():
                    self.drafter.forget(seq.seq_id)
            else:
                failed.add(id(group))
        touched = [g for g in decode_groups if id(g) not in failed]
        self._record_latencies(touched, tokens_of=tokens_of)
        self.scheduler.free_finished_seq_groups()

        request_outputs = [
            RequestOutput.from_seq_group(g) for g in touched
        ]
        for seq_group in scheduler_outputs.ignored_seq_groups:
            request_outputs.append(
                RequestOutput.from_seq_group(seq_group))
        generation_tokens = sum(tokens_of[id(g)] for g in decode_groups)
        self.admission.observe_round(
            scheduler_outputs.num_prefill_tokens, generation_tokens)
        if self.stat_logger is not None:
            self.stat_logger.log(self._get_stats(
                scheduler_outputs,
                generation_tokens=generation_tokens))
        return request_outputs

    # -- output processing (reference :550-752) --

    def _process_round(
            self, prompt_output: Optional[SamplerOutput],
            decode_outputs_list: List[SamplerOutput],
            scheduler_outputs: SchedulerOutputs) -> List[RequestOutput]:
        """Apply one round's sampled tokens: final prompt chunks first
        (mid-prompt chunks wrote KV but sample nothing), then each decode
        step's outputs (a burst passes several)."""
        if getattr(self._step_tls, "epoch", self._epoch) != self._epoch:
            # This thread's step started before a reincarnation: its
            # groups were already restored (or errored) by the rebuild
            # — committing its tokens now would double-append.
            raise StaleEngineStepError(
                "engine step outlived a reincarnation; its outputs "
                "are discarded")
        touched: List = []
        tokens_of = {}
        failed: set = set()
        if prompt_output:
            for chunk, outputs in zip(scheduler_outputs.prompt_chunks,
                                      prompt_output):
                if not chunk.is_final:
                    continue
                if self._process_group_isolated(chunk.group, outputs):
                    touched.append(chunk.group)
                    tokens_of[id(chunk.group)] = len(outputs.samples)
        decode_groups = scheduler_outputs.decode_groups
        for group in decode_groups:
            tokens_of[id(group)] = 0
        for output in decode_outputs_list:
            for seq_group, outputs in zip(decode_groups, output):
                if seq_group.is_finished():
                    # Burst overran this group's stop, or a request-
                    # scoped failure aborted it earlier in this burst.
                    continue
                if self._process_group_isolated(seq_group, outputs):
                    tokens_of[id(seq_group)] += len(outputs.samples)
                else:
                    failed.add(id(seq_group))
        touched.extend(g for g in decode_groups
                       if id(g) not in failed)
        self._record_latencies(touched, tokens_of=tokens_of)
        self.scheduler.free_finished_seq_groups()

        request_outputs = [
            RequestOutput.from_seq_group(g) for g in touched
        ]
        for seq_group in scheduler_outputs.ignored_seq_groups:
            request_outputs.append(RequestOutput.from_seq_group(seq_group))
        generation_tokens = sum(tokens_of[id(g)] for g in decode_groups)
        # Feed the admission controller's throughput EWMAs — the basis
        # of predicted-TTFT shedding and Retry-After estimates.
        self.admission.observe_round(scheduler_outputs.num_prefill_tokens,
                                     generation_tokens)
        if self.stat_logger is not None:
            # Reference semantics: the token sampled off a prefill
            # counts under prompt throughput; generation counts decode
            # rows only (K per row for a K-step burst).
            self.stat_logger.log(self._get_stats(
                scheduler_outputs,
                generation_tokens=generation_tokens))
        return request_outputs

    def _record_latencies(self, scheduled_seq_groups,
                          tokens_of=None) -> None:
        """Stamp per-request TTFT / per-token / e2e latency samples
        (reference _get_stats aphrodite_engine.py:830-891; the reference
        stamps inside RequestMetrics, we batch per processed round). A
        burst that produced K tokens for a group records K amortized
        per-token samples — `tokens_of` maps id(group) to the count the
        group ACTUALLY got (stops mid-burst produce fewer)."""
        if self.stat_logger is None:
            return          # samples are only drained by the stat logger
        now = time.monotonic()
        for group in scheduled_seq_groups:
            k = 1 if tokens_of is None else tokens_of.get(id(group), 0)
            if group.first_token_time is None:
                group.first_token_time = now
                self._ttft_samples.append(now - group.arrival_time)
            elif k > 0:
                dt = (now - group.last_token_time) / k
                self._tpot_samples.extend([dt] * k)
            group.last_token_time = now
            if group.is_finished() and group.finished_time is None:
                group.finished_time = now
                self._e2e_samples.append(now - group.arrival_time)

    def _process_group_isolated(self, seq_group: SequenceGroup,
                                outputs: SequenceGroupOutput,
                                multi_token: bool = False) -> bool:
        """Apply one group's sampled outputs, quarantining request-
        scoped failures (tokenizer/decode errors, per-sequence sampler
        state bugs): the culprit request is aborted, its pages freed,
        and its exception recorded for `drain_step_faults` — concurrent
        requests in the same round are untouched. Engine-scoped
        failures re-raise into the crash barrier. Returns True when
        processing succeeded."""
        try:
            self._process_sequence_group_outputs(seq_group, outputs,
                                                 multi_token=multi_token)
            return True
        except Exception as exc:
            cls = classify_failure(exc, default=FaultClass.REQUEST)
            if cls is not FaultClass.REQUEST:
                raise
            logger.warning(
                "request %s aborted by a request-scoped failure during "
                "output processing: %s: %s", seq_group.request_id,
                type(exc).__name__, exc)
            self._fail_request(seq_group, exc)
            return False

    def _fail_request(self, seq_group: SequenceGroup,
                      exc: Exception) -> None:
        """Abort one request with request-scoped blast radius: free its
        sequences' pages and record the exception for its stream."""
        for seq in seq_group.get_seqs():
            if seq.is_finished():
                continue
            seq.status = SequenceStatus.FINISHED_ABORTED
            self.scheduler.free_seq(seq)
        self._step_faults.append((seq_group.request_id, exc))

    def _process_sequence_group_outputs(
            self, seq_group: SequenceGroup,
            outputs: SequenceGroupOutput,
            multi_token: bool = False) -> None:
        # Forks/frees below commit against the scheduler; a stale
        # (reincarnation-outlived) step must not touch the rebuilt one.
        self._check_epoch()
        if multi_token:
            # Speculative verify: `samples` is an ACCEPTED RUN of
            # consecutive tokens for ONE sequence (not sibling samples
            # of a step). Append in order with per-token incremental
            # detok and stop checks — tokens past the first satisfied
            # stop are dropped, exactly as a classic round-by-round
            # decode would never have produced them.
            params = seq_group.sampling_params
            (seq,) = seq_group.get_seqs(status=SequenceStatus.RUNNING)
            for sample in outputs.samples:
                seq.append_token_id(sample.output_token,
                                    sample.logprobs)
                seq.persistent_data = sample.persistent_data
                self._decode_sequence(seq, params)
                self._check_stop(seq, params)
                if seq.is_finished():
                    break
            if seq.is_finished():
                self.scheduler.free_seq(seq)
            return
        # Prompt logprobs.
        if outputs.prompt_logprobs is not None:
            seq_group.prompt_logprobs = outputs.prompt_logprobs

        samples = outputs.samples
        parent_seqs = seq_group.get_seqs(status=SequenceStatus.RUNNING)
        existing_finished_seqs = seq_group.get_finished_seqs()
        parent_child_dict = {seq.seq_id: [] for seq in parent_seqs}
        for sample in samples:
            parent_child_dict[sample.parent_seq_id].append(sample)

        child_seqs = []
        for parent in parent_seqs:
            child_samples = parent_child_dict[parent.seq_id]
            if not child_samples:
                # Dropped by beam pruning: free.
                parent.status = SequenceStatus.FINISHED_ABORTED
                seq_group.remove(parent.seq_id)
                self.scheduler.free_seq(parent)
                continue
            for child_sample in child_samples[:-1]:
                new_child_seq_id = next(self.seq_counter)
                child = parent.fork(new_child_seq_id)
                child.append_token_id(child_sample.output_token,
                                      child_sample.logprobs)
                child.persistent_data = child_sample.persistent_data
                child_seqs.append((child, parent))
            last = child_samples[-1]
            parent.append_token_id(last.output_token, last.logprobs)
            parent.persistent_data = last.persistent_data
            child_seqs.append((parent, parent))

        for seq, _ in child_seqs:
            self._decode_sequence(seq, seq_group.sampling_params)
            self._check_stop(seq, seq_group.sampling_params)

        if not seq_group.sampling_params.use_beam_search:
            # Non-beam: fork new children in the scheduler, free finished.
            for seq, parent in child_seqs:
                if seq is not parent:
                    seq_group.add(seq)
                    self.scheduler.fork_seq(parent, seq)
            for seq, parent in child_seqs:
                if seq is parent and seq.is_finished():
                    self.scheduler.free_seq(seq)
            return

        # ---- beam search selection (reference :622-721) ----
        params = seq_group.sampling_params
        beam_width = params.best_of
        length_penalty = params.length_penalty

        new_finished = [(seq, parent) for seq, parent in child_seqs
                        if seq.is_finished()]
        existing_finished = [(seq, None) for seq in existing_finished_seqs]
        all_finished = existing_finished + new_finished
        all_finished.sort(
            key=lambda x: x[0].get_beam_search_score(length_penalty),
            reverse=True)
        for seq, parent in all_finished[:beam_width]:
            if parent is not None and seq is not parent:
                seq_group.add(seq)
                if not seq.is_finished():
                    self.scheduler.fork_seq(parent, seq)
            elif parent is not None and seq.is_finished():
                # Selected finished parent: keep its data in the group but
                # release its KV blocks (reference frees finished parents
                # after selection; holding them leaks the pool).
                self.scheduler.free_seq(seq)
        for seq, parent in all_finished[beam_width:]:
            if parent is None:
                seq_group.remove(seq.seq_id)      # existing, now pruned
            elif seq is not parent:
                pass                              # never added: drop
            else:
                seq_group.remove(seq.seq_id)
                self.scheduler.free_seq(seq)

        running = [(seq, parent) for seq, parent in child_seqs
                   if not seq.is_finished()]
        running.sort(
            key=lambda x: x[0].get_beam_search_score(length_penalty),
            reverse=True)
        stop = self._check_beam_search_early_stopping(
            params.early_stopping, params, all_finished, running)
        if stop:
            # Beam search is done: no running beam can beat the selected
            # finished set (reference aphrodite_engine.py:682-698).
            for seq, parent in running:
                if seq is parent:
                    seq_group.remove(seq.seq_id)
                    self.scheduler.free_seq(seq)
            return

        for seq, parent in running[:beam_width]:
            if seq is not parent:
                seq_group.add(seq)
                self.scheduler.fork_seq(parent, seq)
        for seq, parent in running[beam_width:]:
            if seq is parent:
                seq_group.remove(seq.seq_id)
                self.scheduler.free_seq(seq)

    def _check_beam_search_early_stopping(self, early_stopping, params,
                                          finished, running) -> bool:
        """True when no running beam can still enter the finished top-k
        (reference `_check_beam_search_early_stopping`,
        aphrodite_engine.py:622-660)."""
        if len(finished) < params.best_of or not running:
            return False
        if early_stopping is True:
            return True
        length_penalty = params.length_penalty
        worst_finished = min(
            s.get_beam_search_score(length_penalty)
            for s, _ in finished[:params.best_of])
        best_running = running[0][0]
        if early_stopping is False:
            # Compare against the running beam's CURRENT score: logprobs
            # only decrease, so with length_penalty<=1 it cannot improve.
            attainable = best_running.get_beam_search_score(length_penalty)
        else:   # "never": assume the best case over all future lengths
            if length_penalty > 0.0:
                horizon = self.scheduler_config.max_model_len \
                    if params.max_tokens is None \
                    else best_running.get_prompt_len() + params.max_tokens
                max_possible = max(horizon,
                                   self.scheduler_config.max_model_len)
                attainable = best_running.get_beam_search_score(
                    length_penalty, seq_len=max_possible)
            else:
                attainable = best_running.get_beam_search_score(
                    length_penalty)
        return worst_finished >= attainable

    def _decode_sequence(self, seq: Sequence,
                         params: SamplingParams) -> None:
        """Incremental detokenization (reference :893-911)."""
        if self.tokenizer is None:     # token-id-only mode (benchmarks)
            return
        faultinject.fire("tokenizer.decode", detail=f"seq {seq.seq_id}")
        from aphrodite_tpu_torch.transformers_utils.tokenizer import (
            detokenize_incrementally)
        tokenizer = self.tokenizer.get_lora_tokenizer()
        (new_tokens, new_output_text, prefix_offset,
         read_offset) = detokenize_incrementally(
             tokenizer,
             all_input_ids=seq.get_token_ids(),
             prev_tokens=seq.tokens,
             prefix_offset=seq.prefix_offset,
             read_offset=seq.read_offset,
             skip_special_tokens=params.skip_special_tokens,
             spaces_between_special_tokens=
             params.spaces_between_special_tokens)
        if seq.tokens is None:
            seq.tokens = new_tokens
        else:
            seq.tokens.extend(new_tokens)
        seq.prefix_offset = prefix_offset
        seq.read_offset = read_offset
        seq.output_text += new_output_text

    def _check_stop(self, seq: Sequence,
                    params: SamplingParams) -> None:
        """Stop conditions (reference _check_stop :913-959)."""
        for stop_str in params.stop:
            if seq.output_text.endswith(stop_str):
                if not params.include_stop_str_in_output:
                    seq.output_text = \
                        seq.output_text[:-len(stop_str)]
                seq.status = SequenceStatus.FINISHED_STOPPED
                return
        if seq.get_last_token_id() in params.stop_token_ids:
            seq.status = SequenceStatus.FINISHED_STOPPED
            return
        if seq.get_len() > self.scheduler_config.max_model_len:
            seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
            return
        if seq.get_output_len() == params.max_tokens:
            seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
            return
        if (not params.ignore_eos and self.tokenizer is not None and
                seq.get_last_token_id() ==
                self.tokenizer.get_lora_tokenizer().eos_token_id):
            seq.status = SequenceStatus.FINISHED_STOPPED
            return

    # -- stats (reference _get_stats :830-891) --

    def _get_stats(self,
                   scheduler_outputs: Optional[SchedulerOutputs],
                   generation_tokens: Optional[int] = None):
        from aphrodite_tpu_torch.engine.metrics import Stats
        now = time.monotonic()
        num_total_gpu = self.cache_config.num_gpu_blocks or 1
        num_free_gpu = \
            self.scheduler.block_manager.get_num_free_gpu_blocks()
        gpu_cache_usage = 1.0 - num_free_gpu / num_total_gpu
        num_total_cpu = self.cache_config.num_cpu_blocks or 0
        cpu_cache_usage = 0.0
        if num_total_cpu > 0:
            num_free_cpu = \
                self.scheduler.block_manager.get_num_free_cpu_blocks()
            cpu_cache_usage = 1.0 - num_free_cpu / num_total_cpu

        num_prompt_tokens = 0
        num_generation_tokens = 0
        if scheduler_outputs is not None:
            num_prompt_tokens = scheduler_outputs.num_prefill_tokens
            # A multi-step burst passes the exact count it produced.
            num_generation_tokens = generation_tokens \
                if generation_tokens is not None \
                else scheduler_outputs.num_decode_tokens

        ttfts, self._ttft_samples = self._ttft_samples, []
        tpots, self._tpot_samples = self._tpot_samples, []
        e2es, self._e2e_samples = self._e2e_samples, []
        lifecycle: Dict = {}
        if self.lifecycle_source is not None:
            try:
                lifecycle = self.lifecycle_source() or {}
            except Exception as e:
                # Stats must never kill a step; the gauges just skip
                # one tick.
                logger.debug("lifecycle stats unavailable: %s", e)
        return Stats(
            **lifecycle,
            now=now,
            num_running=(len(self.scheduler.running) +
                         len(self.scheduler.prefilling)),
            num_waiting=len(self.scheduler.waiting),
            num_swapped=len(self.scheduler.swapped),
            gpu_cache_usage=gpu_cache_usage,
            cpu_cache_usage=cpu_cache_usage,
            num_prompt_tokens=num_prompt_tokens,
            num_generation_tokens=num_generation_tokens,
            time_to_first_tokens=ttfts,
            time_per_output_tokens=tpots,
            time_e2e_requests=e2es,
            num_waiting_tokens=self.scheduler.waiting_prefill_tokens(),
            prefix_pinned_pages=self.scheduler.prefix_pinned_pages(),
            sheds_total=self.admission.sheds_total,
            expired_total=self.admission.expired_total,
            ewma_prefill_tok_s=self.admission.ewma_prefill_tok_s,
            ewma_decode_tok_s=self.admission.ewma_decode_tok_s)
