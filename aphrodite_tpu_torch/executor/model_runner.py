"""Builds padded batches and runs the model (port of
`aphrodite_tpu/executor/model_runner.py`, one GPU).

The host batch builders are the JAX package's: ragged host lists are
padded into the InputMetadata layout (the same batch buckets, with
out-of-range pad slots and page ids the cache ops skip), prompt chunks
that start on a page boundary get whole-page writer cells, and decode
batches get the ragged (sequence, chunk) work list. PyTorch runs
eagerly, so a "step program" is a plain call:

- `execute_model`: model + LM head on the selected rows + fused sampler,
  one host transfer of the packed result;
- `dispatch_prompt` / `dispatch_burst`: enqueue work on the device and
  return a handle whose packed result the caller pulls later, so a
  combined round pays one host synchronisation;
- the decode burst (multi_step > 1) is a Python loop of K model steps
  with device-side feedback of tokens, positions, slots and context
  lengths — no host synchronisation inside (CUDA graphs are a later
  step).

KV pages are updated in place by the attention layer.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common import flags
from aphrodite_tpu_torch.common.config import ModelConfig, SchedulerConfig
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.sampling_params import SamplingType
from aphrodite_tpu_torch.common.sequence import (SamplerOutput,
                                                 SequenceGroupMetadata)
from aphrodite_tpu_torch.modeling.input_metadata import InputMetadata
from aphrodite_tpu_torch.modeling.layers.sampler import (Sampler,
                                                         fused_sample)
from aphrodite_tpu_torch.modeling.sampling_metadata import (
    PersistentMetadata, SamplingMetadata)
from aphrodite_tpu_torch.ops.cuda.paged_attention import (
    build_decode_work_list, choose_pages_per_chunk)
from aphrodite_tpu_torch.ops.kv_cache import copy_blocks as _copy_blocks_op

logger = init_logger(__name__)

KVCaches = List[Tuple[torch.Tensor, torch.Tensor]]

# Batch buckets and table-width granularity of the JAX runner, kept so
# both sides pad batches identically.
_DECODE_BATCH_BUCKETS = [1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                         192, 256, 384, 512]
_PREFILL_BATCH_BUCKETS = [1, 2, 4, 8, 16, 32]
_PAGES_BUCKET = 8


def _bucket(value: int, buckets: List[int]) -> int:
    idx = bisect.bisect_left(buckets, value)
    if idx == len(buckets):
        return buckets[-1] if value <= buckets[-1] else value
    return buckets[idx]


def _pow2_bucket(value: int, lo: int = 16) -> int:
    b = lo
    while b < value:
        b *= 2
    return b


class StepHandle:
    """Work enqueued on the device and not yet synchronised: `packed`
    is the device result; `ModelRunner.finalize_step/finalize_burst`
    turn the pulled numpy array into SamplerOutputs."""

    __slots__ = ("packed", "sampling", "plan", "num_steps")

    def __init__(self, packed, sampling, plan,
                 num_steps: Optional[int] = None) -> None:
        self.packed = packed
        self.sampling = sampling
        self.plan = plan
        self.num_steps = num_steps


class ModelRunner:
    """Drives one model replica on one device."""

    def __init__(
        self,
        model,
        params,
        model_config: ModelConfig,
        scheduler_config: SchedulerConfig,
        page_size: int,
        num_slots: int,
        device: torch.device,
        kv_cache_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        self.model = model
        self.params = params
        self.model_config = model_config
        self.scheduler_config = scheduler_config
        self.page_size = page_size
        self.num_slots = num_slots          # OOB pad value for slots
        self.device = device
        self.kv_scale = 1.0
        # Whole-page prompt writes (K2) need float pages; quantized pages
        # are refused by the config, so this holds for every cache the
        # port allocates.
        self._prefill_writer_ok = kv_cache_dtype in (torch.bfloat16,
                                                     torch.float32)
        self.sampler = Sampler(model_config.get_vocab_size(), device)
        self.pages_bucket = _PAGES_BUCKET if page_size <= 16 else \
            max(2, _PAGES_BUCKET // 2)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ---- step bodies ----

    def _logits(self, params, input_ids, positions, kv_caches, metadata,
                sel):
        hidden, new_caches = self.model(params, input_ids, positions,
                                        kv_caches, metadata)
        flat = hidden.reshape(-1, hidden.shape[-1])
        rows = flat.index_select(0, sel.long())
        return self.model.compute_logits(params, rows), new_caches

    def _burst(self, params, ids, pos, kv_caches, meta, plan, greedy_mask,
               pos_cap, num_steps: int):
        """K decode iterations with device-side feedback: the sampled
        token, the advanced position (pinned at `pos_cap`, each row's last
        reserved position), its slot from the block table, and ctx = pos+1
        feed the next step without a host synchronisation. Returns the
        stacked packed results [num_steps, rows, w]."""
        all_packed = []
        ps = self.page_size
        for t in range(num_steps):
            hidden, kv_caches = self.model(params, ids, pos, kv_caches,
                                           meta)
            logits = self.model.compute_logits(
                params, hidden.reshape(-1, hidden.shape[-1]))
            packed, _ = fused_sample(
                logits, plan.tensors, plan.bases, plan.salt1 + t,
                plan.salt2, max_best_of=plan.max_best_of,
                num_topk=plan.num_topk, need_logprobs=False,
                draw_rows=plan.draw_rows)
            all_packed.append(packed)
            if t == num_steps - 1:
                # No step follows: its position may lie past the
                # reservation, so its slot is never looked up.
                break
            next_tok = torch.where(greedy_mask, packed[:, 0], packed[:, 1])
            ids = next_tok[:, None]
            pos = torch.minimum(pos + 1, pos_cap)
            p = pos[:, 0].long()
            page = meta.block_tables.gather(1, (p // ps)[:, None])[:, 0]
            slots = torch.clamp(page.long() * ps + p % ps,
                                max=self.num_slots)
            meta = meta.replace(slot_mapping=slots.to(torch.int32),
                                context_lens=(p + 1).to(torch.int32))
        return torch.stack(all_packed), kv_caches

    # ---- host batch builders ----

    def _prepare_prompt(
        self, seq_group_metadata_list: List[SequenceGroupMetadata]
    ) -> Tuple[dict, SamplingMetadata]:
        batch = len(seq_group_metadata_list)
        padded_batch = _bucket(batch, _PREFILL_BATCH_BUCKETS)

        prompt_lens: List[int] = []
        ctxs: List[int] = []
        seq_groups, seq_data_map = [], {}
        use_prefix = False
        newly_computed = []
        for md in seq_group_metadata_list:
            seq_id = next(iter(md.seq_data))
            data = md.seq_data[seq_id]
            # Chunk = tokens not yet in cache (the scheduler's computed
            # context or a computed prefix), clamped page-aligned so at
            # least the last token is computed.
            ctx = md.computed_ctx
            if md.prefix is not None and md.prefix.computed:
                ctx = max(ctx, md.prefix.get_length())
            ctx = min(ctx, (data.get_len() - 1) // self.page_size *
                      self.page_size)
            end = data.get_len() if md.chunk_len is None \
                else min(ctx + md.chunk_len, data.get_len())
            if md.prefix is not None and not md.prefix.computed \
                    and end >= md.prefix.get_length():
                newly_computed.append(md.prefix)
            use_prefix = use_prefix or ctx > 0
            ctxs.append(ctx)
            prompt_lens.append(end - ctx)
            seq_groups.append(([seq_id], md.sampling_params))
            seq_data_map[seq_id] = data

        max_len = max(prompt_lens)
        padded_len = _pow2_bucket(max_len)

        ids = np.zeros((padded_batch, padded_len), dtype=np.int32)
        pos = np.zeros((padded_batch, padded_len), dtype=np.int32)
        slots = np.full((padded_batch * padded_len,), self.num_slots,
                        dtype=np.int32)
        ctx_lens = np.zeros((padded_batch,), dtype=np.int32)
        plens = np.zeros((padded_batch,), dtype=np.int32)
        pb = self.pages_bucket
        max_pages = max(
            pb,
            -(-max((len(next(iter(md.block_tables.values()), []))
                    for md in seq_group_metadata_list),
                   default=1) // pb) * pb)
        num_pages_oob = self.num_slots // self.page_size
        tables = np.full((padded_batch, max_pages), num_pages_oob,
                         dtype=np.int32)

        selected: List[int] = []
        for i, md in enumerate(seq_group_metadata_list):
            seq_id = next(iter(md.seq_data))
            data = md.seq_data[seq_id]
            all_tokens = data.get_token_ids()
            ctx = ctxs[i]
            n = prompt_lens[i]
            ids[i, :n] = all_tokens[ctx:ctx + n]
            pos[i, :n] = np.arange(ctx, ctx + n)
            ctx_lens[i] = ctx
            plens[i] = n
            table = md.block_tables.get(seq_id, [])
            tables[i, :len(table)] = table
            abs_pos = np.arange(ctx, ctx + n)
            table_arr = np.asarray(table, dtype=np.int64)
            slots[i * padded_len:i * padded_len + n] = (
                table_arr[abs_pos // self.page_size] * self.page_size +
                abs_pos % self.page_size)
            if md.sampling_params.prompt_logprobs is not None:
                selected.extend(range(i * padded_len, i * padded_len + n))
            else:
                selected.append(i * padded_len + n - 1)

        # Whole-page writer cells (K2) when every chunk starts on a page
        # boundary and the padded length is page-aligned: one cell per
        # (sequence, page); cell c reads source rows [c*S, (c+1)*S).
        prefill_cells = None
        ps = self.page_size
        if self._prefill_writer_ok and padded_len % ps == 0 and \
                all(int(c) % ps == 0 for c in ctx_lens[:batch]):
            ppp = padded_len // ps               # pages per prompt
            n_cells = padded_batch * ppp
            pid = np.full((n_cells,), num_pages_oob, dtype=np.int32)
            vld = np.zeros((n_cells,), dtype=np.int32)
            for i, md in enumerate(seq_group_metadata_list):
                seq_id = next(iter(md.seq_data))
                table = md.block_tables.get(seq_id, [])
                n = int(plens[i])
                ctx_pages = int(ctx_lens[i]) // ps
                for p in range(-(-n // ps)):
                    pid[i * ppp + p] = table[ctx_pages + p]
                    vld[i * ppp + p] = min(n - p * ps, ps)
            prefill_cells = (self._dev(pid),
                             np.arange(n_cells, dtype=np.int32),
                             self._dev(vld))

        metadata = InputMetadata(
            slot_mapping=self._dev(slots),
            block_tables=self._dev(tables),
            context_lens=self._dev(ctx_lens),
            prompt_lens=self._dev(plens),
            kv_scale=self.kv_scale,
            prefill_cells=prefill_cells,
        )
        sampling = SamplingMetadata(
            seq_groups=seq_groups,
            seq_data=seq_data_map,
            prompt_lens=prompt_lens,
            selected_token_indices=np.asarray(selected, dtype=np.int32),
            categorized_sample_indices={},
            prompt_offsets=[int(c) for c in ctx_lens[:batch]],
        )
        num_rows = len(selected)
        padded_rows = -(-num_rows // _PAGES_BUCKET) * _PAGES_BUCKET
        sel = np.zeros((padded_rows,), dtype=np.int32)
        sel[:num_rows] = selected
        inputs = dict(input_ids=self._dev(ids), positions=self._dev(pos),
                      metadata=metadata, sel=self._dev(sel),
                      num_rows=num_rows, is_prompt=True,
                      use_prefix=use_prefix, newly_computed=newly_computed)
        return inputs, sampling

    @staticmethod
    def _mark_prefixes(inputs: dict) -> None:
        """Flip prefixes to computed once the step writing their KV has
        been enqueued."""
        for prefix in inputs.get("newly_computed", ()):
            prefix.computed = True

    def _prepare_decode(
        self, seq_group_metadata_list: List[SequenceGroupMetadata]
    ) -> Tuple[dict, SamplingMetadata]:
        seq_groups, seq_data_map, persistent = [], {}, {}
        tokens, positions, slot_list, ctx_list, tables_list = \
            [], [], [], [], []
        sliding_window = self.model_config.get_sliding_window()
        for md in seq_group_metadata_list:
            group_ids = list(md.seq_data.keys())
            seq_groups.append((group_ids, md.sampling_params))
            for seq_id in group_ids:
                data = md.seq_data[seq_id]
                seq_data_map[seq_id] = data
                persistent[seq_id] = md.persistent_data.get(seq_id, {})
                tokens.append(data.get_last_token_id())
                pos = data.get_len() - 1
                positions.append(pos)
                table = md.block_tables[seq_id]
                slot_pos = pos
                ctx = pos + 1
                if sliding_window is not None:
                    ctx = min(ctx, sliding_window)
                    slot_pos = pos % (len(table) * self.page_size) \
                        if len(table) * self.page_size <= sliding_window \
                        else pos
                page = table[(slot_pos // self.page_size) % len(table)]
                slot_list.append(page * self.page_size +
                                 slot_pos % self.page_size)
                ctx_list.append(ctx)
                tables_list.append(table)

        batch = len(tokens)
        padded_batch = _bucket(batch, _DECODE_BATCH_BUCKETS)
        max_pages = max(len(t) for t in tables_list)
        max_pages = -(-max_pages // self.pages_bucket) * self.pages_bucket

        ids = np.zeros((padded_batch, 1), dtype=np.int32)
        pos_arr = np.zeros((padded_batch, 1), dtype=np.int32)
        slots = np.full((padded_batch,), self.num_slots, dtype=np.int32)
        ctx_lens = np.zeros((padded_batch,), dtype=np.int32)
        num_pages_oob = self.num_slots // self.page_size
        tables = np.full((padded_batch, max_pages), num_pages_oob,
                         dtype=np.int32)
        ids[:batch, 0] = tokens
        pos_arr[:batch, 0] = positions
        slots[:batch] = slot_list
        ctx_lens[:batch] = ctx_list
        for i, t in enumerate(tables_list):
            tables[i, :len(t)] = t

        if __debug__ and flags.get_bool("APHRODITE_DEBUG_KV"):
            written = [s // self.page_size for s in slot_list]
            assert len(set(written)) == len(written), (
                "decode slots share a page — sequence-exclusive-pages "
                f"precondition violated: {sorted(written)}")

        # Ragged work list over each row's reserved pages (kept for the
        # kernel's signature; the CUDA kernel walks pages itself).
        ppc = choose_pages_per_chunk(max_pages, self.page_size,
                                     padded_batch)
        page_counts = [len(t) for t in tables_list] + \
            [0] * (padded_batch - batch)
        nw_real = sum(max(1, -(-c // ppc)) for c in page_counts)
        chunks_cap = -(-max_pages // ppc)
        mix = 1
        while padded_batch * mix < nw_real:
            mix *= 2
        work = build_decode_work_list(
            page_counts, ppc, pad_to=padded_batch * min(mix, chunks_cap))

        metadata = InputMetadata(
            slot_mapping=self._dev(slots),
            block_tables=self._dev(tables),
            context_lens=self._dev(ctx_lens),
            kv_scale=self.kv_scale,
            decode_work=work,
            decode_ppc=ppc,
        )
        sampling = SamplingMetadata(
            seq_groups=seq_groups,
            seq_data=seq_data_map,
            prompt_lens=[],
            selected_token_indices=np.arange(batch, dtype=np.int32),
            categorized_sample_indices={},
            persistent_metadata=PersistentMetadata(persistent),
        )
        inputs = dict(input_ids=self._dev(ids),
                      positions=self._dev(pos_arr), metadata=metadata,
                      sel=self._dev(np.arange(padded_batch,
                                              dtype=np.int32)),
                      num_rows=batch, is_prompt=False, use_prefix=False)
        return inputs, sampling

    # ---- public API ----

    def _apply_block_copies(self, kv_caches: KVCaches,
                            blocks_to_copy) -> KVCaches:
        """CoW copies scheduled this round, applied in place before the
        step (pad lanes carry the out-of-range page id)."""
        if not blocks_to_copy:
            return kv_caches
        src, dst = [], []
        for s, ds in blocks_to_copy.items():
            for d in ds:
                src.append(s)
                dst.append(d)
        oob = self.num_slots // self.page_size
        padded = _pow2_bucket(len(src), lo=8)
        src_arr = np.full((padded,), oob, dtype=np.int32)
        dst_arr = np.full((padded,), oob, dtype=np.int32)
        src_arr[:len(src)] = src
        dst_arr[:len(dst)] = dst
        src_t, dst_t = self._dev(src_arr), self._dev(dst_arr)
        for k, v in kv_caches:
            _copy_blocks_op(k, v, src_t, dst_t)
        return kv_caches

    def _prepare(self, seq_group_metadata_list):
        if seq_group_metadata_list[0].is_prompt:
            return self._prepare_prompt(seq_group_metadata_list)
        return self._prepare_decode(seq_group_metadata_list)

    def execute_model(
        self,
        seq_group_metadata_list: List[SequenceGroupMetadata],
        kv_caches: KVCaches,
        blocks_to_copy: Optional[Dict[int, List[int]]] = None,
    ) -> Tuple[SamplerOutput, KVCaches]:
        kv_caches = self._apply_block_copies(kv_caches, blocks_to_copy)
        if not seq_group_metadata_list:
            return [], kv_caches
        inputs, sampling = self._prepare(seq_group_metadata_list)
        meta = inputs["metadata"].replace(is_prompt=inputs["is_prompt"],
                                          use_prefix=inputs["use_prefix"])
        logits, kv_caches = self._logits(
            self.params, inputs["input_ids"], inputs["positions"],
            kv_caches, meta, inputs["sel"])
        self._mark_prefixes(inputs)
        logits = logits[:inputs["num_rows"]]
        if any(p.logits_processors for _, p in sampling.seq_groups):
            return self.sampler(logits, sampling), kv_caches
        plan = self.sampler.plan(sampling)
        packed, logprobs = fused_sample(
            logits, plan.tensors, plan.bases, plan.salt1, plan.salt2,
            max_best_of=plan.max_best_of, num_topk=plan.num_topk,
            need_logprobs=plan.need_logprobs, draw_rows=plan.draw_rows)
        output = self.sampler.finalize(sampling, plan,
                                       packed.cpu().numpy(), logprobs)
        return output, kv_caches

    def dispatch_prompt(
        self,
        seq_group_metadata_list: List[SequenceGroupMetadata],
        kv_caches: KVCaches,
    ) -> Tuple[Optional[StepHandle], KVCaches]:
        """Enqueue a prompt step without synchronising (fused sampler
        path only). Returns (None, kv_caches untouched) when the batch
        needs the raw-logits route (host logits processors, logprobs,
        best_of > 1); the caller then runs synced steps."""
        inputs, sampling = self._prepare_prompt(seq_group_metadata_list)
        if any(p.logits_processors for _, p in sampling.seq_groups):
            return None, kv_caches
        plan = self.sampler.plan(sampling, pad_to=inputs["sel"].shape[0])
        if plan.need_logprobs or plan.max_best_of != 1 or \
                plan.num_topk != 0:
            return None, kv_caches
        meta = inputs["metadata"].replace(is_prompt=True,
                                          use_prefix=inputs["use_prefix"])
        logits, kv_caches = self._logits(
            self.params, inputs["input_ids"], inputs["positions"],
            kv_caches, meta, inputs["sel"])
        packed, _ = fused_sample(
            logits, plan.tensors, plan.bases, plan.salt1, plan.salt2,
            max_best_of=plan.max_best_of, num_topk=plan.num_topk,
            need_logprobs=False, draw_rows=plan.draw_rows)
        self._mark_prefixes(inputs)
        return StepHandle(packed, sampling, plan), kv_caches

    def finalize_step(self, handle: StepHandle,
                      packed_np: np.ndarray) -> SamplerOutput:
        return self.sampler.finalize(handle.sampling, handle.plan,
                                     packed_np, None)

    def finalize_burst(self, handle: StepHandle,
                       all_packed: np.ndarray) -> List[SamplerOutput]:
        return [
            self.sampler.finalize(handle.sampling, handle.plan,
                                  all_packed[t], None)
            for t in range(handle.num_steps)
        ]

    def execute_decode_burst(
        self,
        seq_group_metadata_list: List[SequenceGroupMetadata],
        kv_caches: KVCaches,
        num_steps: int,
        blocks_to_copy: Optional[Dict[int, List[int]]] = None,
        extra_cap: Optional[Dict[int, int]] = None,
    ) -> Tuple[List[SamplerOutput], KVCaches]:
        """`num_steps` decode iterations with device-side token feedback
        and one host synchronisation (the stacked packed results)."""
        kv_caches = self._apply_block_copies(kv_caches, blocks_to_copy)
        handle, kv_caches = self.dispatch_burst(
            seq_group_metadata_list, kv_caches, num_steps, extra_cap)
        return self.finalize_burst(handle, handle.packed.cpu().numpy()), \
            kv_caches

    def dispatch_burst(
        self,
        seq_group_metadata_list: List[SequenceGroupMetadata],
        kv_caches: KVCaches,
        num_steps: int,
        extra_cap: Optional[Dict[int, int]] = None,
    ) -> Tuple[StepHandle, KVCaches]:
        """Enqueue the K-step decode burst without synchronising."""
        inputs, sampling = self._prepare_decode(seq_group_metadata_list)
        padded = inputs["input_ids"].shape[0]
        plan = self.sampler.plan(sampling, pad_to=padded)
        greedy = np.zeros((padded,), dtype=bool)
        # Per-row last reserved position: overshot rows pin here instead
        # of walking the block table past their reservation.
        pos_cap = np.zeros((padded, 1), dtype=np.int32)
        cap_of = extra_cap or {}
        row = 0
        for md in seq_group_metadata_list:
            n = len(md.seq_data)
            if md.sampling_params.sampling_type == SamplingType.GREEDY:
                greedy[row:row + n] = True
            for seq_id, data in md.seq_data.items():
                r = min(cap_of.get(seq_id, num_steps), num_steps)
                pos_cap[row, 0] = data.get_len() - 1 + r
                row += 1
        packed, kv_caches = self._burst(
            self.params, inputs["input_ids"], inputs["positions"],
            kv_caches, inputs["metadata"], plan, self._dev(greedy),
            self._dev(pos_cap), num_steps)
        return StepHandle(packed, sampling, plan,
                          num_steps=num_steps), kv_caches

    def execute_spec_verify(self, *args, **kwargs):
        raise NotImplementedError(
            "speculative verify is not in the PyTorch port yet (the "
            "config refuses APHRODITE_SPEC=1)")

    def profile_run(self, num_seqs: int, seq_len: int) -> None:
        """Cache-less prefill of num_seqs x seq_len tokens plus the LM
        head and sampler on their last rows: the largest prompt round,
        for memory profiling."""
        ids = torch.zeros((num_seqs, seq_len), dtype=torch.int32,
                          device=self.device)
        pos = torch.arange(seq_len, dtype=torch.int32,
                           device=self.device).repeat(num_seqs, 1)
        lens = torch.full((num_seqs,), seq_len, dtype=torch.int32,
                          device=self.device)
        meta = InputMetadata(
            slot_mapping=torch.zeros((num_seqs * seq_len,),
                                     dtype=torch.int32, device=self.device),
            block_tables=torch.zeros((num_seqs, 1), dtype=torch.int32,
                                     device=self.device),
            context_lens=torch.zeros_like(lens), prompt_lens=lens,
            is_prompt=True)
        sel = torch.arange(num_seqs, device=self.device) * seq_len + \
            seq_len - 1
        self._logits(self.params, ids, pos, None, meta, sel)
