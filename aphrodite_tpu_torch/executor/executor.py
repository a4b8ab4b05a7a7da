"""The executor: owns the model, the KV cache and the model runner on one
device (port of `aphrodite_tpu/executor/executor.py`, single GPU).

Cache sizing (`_profile_and_size_cache`) runs the largest prompt round
once without a cache, reads the peak memory PyTorch allocated, and gives
the KV pool `gpu_memory_utilization` of the card's memory
(`torch.cuda.mem_get_info`) minus that peak. On the CPU (tests) there is
no memory to read, and a fixed budget applies unless the pool is sized
explicitly.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from aphrodite_tpu_torch.common import faultinject
from aphrodite_tpu_torch.common.config import (CacheConfig, DeviceConfig,
                                               ModelConfig, ParallelConfig,
                                               SchedulerConfig)
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.sequence import (SamplerOutput,
                                                 SequenceGroupMetadata)
from aphrodite_tpu_torch.executor.cache_engine import CacheEngine
from aphrodite_tpu_torch.executor.model_runner import ModelRunner
from aphrodite_tpu_torch.modeling.loader import get_model

logger = init_logger(__name__)

_GB = 1 << 30
# KV budget when the device reports no memory (the CPU).
_FALLBACK_CACHE_BYTES = 256 << 20


class GPUExecutor:
    """Single-device executor (the engine's only worker)."""

    def __init__(
        self,
        model_config: ModelConfig,
        cache_config: CacheConfig,
        parallel_config: ParallelConfig,
        scheduler_config: SchedulerConfig,
        device_config: DeviceConfig,
        lora_config=None,
    ) -> None:
        if lora_config is not None:
            raise NotImplementedError("LoRA is not in the PyTorch port yet")
        self.model_config = model_config
        self.cache_config = cache_config
        self.parallel_config = parallel_config
        self.scheduler_config = scheduler_config
        self.device = torch.device(device_config.resolve())
        logger.info("Loading model %s on %s ...", model_config.model,
                    self.device)
        self.model, self.params = get_model(model_config, self.device)
        self.model_runner = ModelRunner(
            self.model, self.params, model_config, scheduler_config,
            page_size=cache_config.block_size,
            num_slots=0, device=self.device)
        self._profile_and_size_cache()
        self.cache_engine = CacheEngine(cache_config, model_config,
                                        self.device)
        self.model_runner.num_slots = self.cache_engine.num_slots
        self.model_runner.kv_scale = self.cache_engine.kv_scale

    @property
    def disagg(self) -> bool:
        return False

    def kv_handoff(self, pages: List[int]) -> int:
        raise NotImplementedError(
            "the disaggregated split is not in the PyTorch port yet")

    # -- sizing --

    def _profile_and_size_cache(self) -> None:
        block_bytes = CacheEngine.get_cache_block_size(self.cache_config,
                                                       self.model_config)
        if self.cache_config.num_cpu_blocks is None:
            self.cache_config.num_cpu_blocks = int(
                self.cache_config.swap_space_bytes // block_bytes)
        if self.cache_config.num_gpu_blocks is not None:
            return          # pool sized explicitly (tests)
        if self.device.type != "cuda":
            budget = _FALLBACK_CACHE_BYTES
        else:
            sched = self.scheduler_config
            seq_len = min(sched.max_model_len, sched.max_num_batched_tokens)
            num_seqs = max(1, min(sched.max_num_seqs,
                                  sched.max_num_batched_tokens // seq_len))
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self.model_runner.profile_run(num_seqs, seq_len)
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.empty_cache()
            _, total = torch.cuda.mem_get_info(self.device)
            budget = int(total * self.cache_config.gpu_memory_utilization
                         - peak)
            logger.info("Profile run %dx%d tokens: peak %.2f GiB of %.2f "
                        "GiB", num_seqs, seq_len, peak / _GB, total / _GB)
        num_pages = max(budget // block_bytes, 16)
        self.cache_config.num_gpu_blocks = int(num_pages)
        logger.info("KV cache: %d device pages, %d host pages (%.2f GiB "
                    "device)", self.cache_config.num_gpu_blocks,
                    self.cache_config.num_cpu_blocks,
                    num_pages * block_bytes / _GB)

    # -- step execution --

    def _pre_step(self, blocks_to_swap_in, blocks_to_swap_out) -> None:
        faultinject.fire("executor.execute_model")
        if blocks_to_swap_out:
            self.cache_engine.swap_out(blocks_to_swap_out)
        if blocks_to_swap_in:
            self.cache_engine.swap_in(blocks_to_swap_in)

    def execute_model(
        self,
        seq_group_metadata_list: List[SequenceGroupMetadata],
        blocks_to_swap_in: Dict[int, int],
        blocks_to_swap_out: Dict[int, int],
        blocks_to_copy: Dict[int, List[int]],
    ) -> SamplerOutput:
        self._pre_step(blocks_to_swap_in, blocks_to_swap_out)
        output, self.cache_engine.kv_caches = \
            self.model_runner.execute_model(seq_group_metadata_list,
                                            self.cache_engine.kv_caches,
                                            blocks_to_copy)
        return output

    def execute_decode_burst(
        self,
        seq_group_metadata_list: List[SequenceGroupMetadata],
        blocks_to_swap_in: Dict[int, int],
        blocks_to_swap_out: Dict[int, int],
        blocks_to_copy: Dict[int, List[int]],
        num_steps: int,
        extra_cap=None,
    ) -> List[SamplerOutput]:
        """Multi-step decode: one scheduling round drives `num_steps`
        device iterations."""
        self._pre_step(blocks_to_swap_in, blocks_to_swap_out)
        outputs, self.cache_engine.kv_caches = \
            self.model_runner.execute_decode_burst(
                seq_group_metadata_list, self.cache_engine.kv_caches,
                num_steps, blocks_to_copy, extra_cap)
        return outputs

    def execute_spec_verify(self, *args, **kwargs):
        raise NotImplementedError(
            "speculative verify is not in the PyTorch port yet")

    def dispatch_prompt_round(
        self,
        prompt_metadata: List[SequenceGroupMetadata],
        blocks_to_copy: Dict[int, List[int]],
    ):
        """Enqueue one pure-prefill round without synchronising (None =
        the caller must run the synced path)."""
        self._pre_step({}, {})
        kv = self.model_runner._apply_block_copies(
            self.cache_engine.kv_caches, blocks_to_copy)
        handle, self.cache_engine.kv_caches = \
            self.model_runner.dispatch_prompt(prompt_metadata, kv)
        return handle

    def finalize_prompt_rounds(self, handles):
        """One host transfer for every pending round's packed results."""
        pulled = [h.packed.cpu().numpy() for h in handles]
        return [self.model_runner.finalize_step(h, p)
                for h, p in zip(handles, pulled)]

    def execute_combined(
        self,
        prompt_metadata: List[SequenceGroupMetadata],
        decode_metadata: List[SequenceGroupMetadata],
        blocks_to_swap_in: Dict[int, int],
        blocks_to_swap_out: Dict[int, int],
        blocks_to_copy: Dict[int, List[int]],
        num_steps: int,
        extra_cap=None,
    ) -> Tuple[SamplerOutput, List[SamplerOutput]]:
        """One round with prompt chunks AND the decode batch: the prompt
        step and the decode burst are enqueued back to back and one host
        synchronisation collects both; sampling configs off the fused
        path fall back to two synced steps within the round."""
        self._pre_step(blocks_to_swap_in, blocks_to_swap_out)
        runner = self.model_runner
        kv = runner._apply_block_copies(self.cache_engine.kv_caches,
                                        blocks_to_copy)
        handle = None
        if num_steps > 1:
            handle, kv = runner.dispatch_prompt(prompt_metadata, kv)
        if handle is not None:
            bhandle, kv = runner.dispatch_burst(decode_metadata, kv,
                                                num_steps, extra_cap)
            self.cache_engine.kv_caches = kv
            p_np = handle.packed.cpu().numpy()
            b_np = bhandle.packed.cpu().numpy()
            return (runner.finalize_step(handle, p_np),
                    runner.finalize_burst(bhandle, b_np))
        prompt_out, kv = runner.execute_model(prompt_metadata, kv)
        if num_steps > 1:
            decode_outs, kv = runner.execute_decode_burst(
                decode_metadata, kv, num_steps, extra_cap=extra_cap)
        else:
            out, kv = runner.execute_model(decode_metadata, kv)
            decode_outs = [out]
        self.cache_engine.kv_caches = kv
        return prompt_out, decode_outs
