"""Engine CLI/constructor arguments -> validated config objects.

Reference: `aphrodite/engine/args_tools.py` (EngineArgs `:11`,
add_cli_args `:52`, create_engine_configs `:278`, AsyncEngineArgs `:314`).
Flag names are kept CLI-compatible with the reference so existing deploy
scripts port over. In the PyTorch port, configurations outside its
ported slices (multi-GPU, quantized methods whose kernels do not take a
layer's shape on the card) are refused here or by the config classes,
naming the later slice that brings them.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from aphrodite_tpu_torch.common.config import (CacheConfig, DeviceConfig,
                                               LoRAConfig, ModelConfig,
                                               ParallelConfig,
                                               SchedulerConfig)


@dataclass
class EngineArgs:
    """Arguments for the PyTorch engine."""
    model: str
    tokenizer: Optional[str] = None
    tokenizer_mode: str = "auto"
    # Run token-ids-in/token-ids-out with no tokenizer (benchmarks,
    # embedding-level integrations).
    skip_tokenizer_init: bool = False
    trust_remote_code: bool = False
    download_dir: Optional[str] = None
    load_format: str = "auto"
    dtype: str = "auto"
    kv_cache_dtype: str = "auto"
    seed: int = 0
    max_model_len: Optional[int] = None
    worker_use_ray: bool = False
    pipeline_parallel_size: int = 1
    tensor_parallel_size: int = 1
    data_parallel_size: int = 1
    sequence_parallel_size: int = 1
    sp_prefill_threshold: int = 1024
    # Disaggregated prefill/decode split "n_prefill,n_decode" (e.g.
    # "2,6" of tp=8); None falls back to APHRODITE_DISAGG, "" colocates.
    disagg_split: Optional[str] = None
    max_parallel_loading_workers: Optional[int] = None
    block_size: int = 16
    swap_space: float = 4          # GiB
    gpu_memory_utilization: float = 0.90
    max_num_batched_tokens: Optional[int] = None
    max_num_seqs: int = 256
    max_paddings: int = 256
    multi_step: int = 1
    max_chunk_tokens: Optional[int] = None
    disable_log_stats: bool = False
    revision: Optional[str] = None
    tokenizer_revision: Optional[str] = None
    quantization: Optional[str] = None
    enforce_eager: bool = False
    max_context_len_to_capture: int = 8192
    disable_custom_all_reduce: bool = False
    enable_lora: bool = False
    max_loras: int = 1
    max_lora_rank: int = 16
    lora_extra_vocab_size: int = 256
    lora_dtype: str = "auto"
    max_cpu_loras: Optional[int] = None
    device: str = "auto"

    def __post_init__(self):
        if self.tokenizer is None:
            self.tokenizer = self.model

    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser
                     ) -> argparse.ArgumentParser:
        """Shared CLI flags (reference `args_tools.py:52-268`)."""
        parser.add_argument("--model", type=str,
                            default="EleutherAI/pythia-70m")
        parser.add_argument("--tokenizer", type=str, default=None)
        parser.add_argument("--tokenizer-mode", type=str, default="auto",
                            choices=["auto", "slow"])
        parser.add_argument("--trust-remote-code", action="store_true")
        parser.add_argument("--download-dir", type=str, default=None)
        parser.add_argument("--load-format", type=str, default="auto",
                            choices=["auto", "pt", "safetensors",
                                     "npcache", "dummy", "gguf"])
        parser.add_argument("--dtype", type=str, default="auto",
                            choices=["auto", "half", "float16", "bfloat16",
                                     "float", "float32"])
        parser.add_argument("--kv-cache-dtype", type=str, default="auto",
                            choices=["auto", "fp8", "fp8_e5m2", "int8"])
        parser.add_argument("--max-model-len", type=int, default=None)
        parser.add_argument("--worker-use-ray", action="store_true",
                            help="accepted for reference CLI parity; "
                            "the engine has no Ray workers")
        parser.add_argument("--pipeline-parallel-size", "-pp", type=int,
                            default=1)
        # --tp is the spelling the bench harnesses document; all three
        # land on tensor_parallel_size.
        parser.add_argument("--tensor-parallel-size", "-tp", "--tp",
                            type=int, default=1)
        parser.add_argument("--data-parallel-size", "-dp", type=int,
                            default=1)
        parser.add_argument("--sequence-parallel-size", "-sp", type=int,
                            default=1,
                            help="ring-attention mesh axis for long "
                                 "prompt prefill")
        parser.add_argument("--sp-prefill-threshold", type=int,
                            default=1024,
                            help="route prefill through ring attention "
                                 "at/above this padded prompt length")
        parser.add_argument("--disagg-split", type=str, default=None,
                            help="disaggregated prefill/decode chip "
                                 "split 'n_prefill,n_decode' (e.g. "
                                 "'2,6' of tp=8); unset falls back to "
                                 "APHRODITE_DISAGG, '' colocates")
        parser.add_argument("--max-parallel-loading-workers", type=int,
                            default=None)
        parser.add_argument("--block-size", type=int, default=16,
                            choices=[8, 16, 32, 64, 128])
        parser.add_argument("--seed", type=int, default=0)
        parser.add_argument("--swap-space", type=float, default=4)
        parser.add_argument("--gpu-memory-utilization", type=float,
                            default=0.90)
        parser.add_argument("--max-num-batched-tokens", type=int,
                            default=None)
        parser.add_argument("--max-num-seqs", type=int, default=256)
        parser.add_argument("--max-paddings", type=int, default=256)
        parser.add_argument("--multi-step", type=int, default=1,
                            help="decode steps per scheduling round "
                                 "(device-side token feedback)")
        parser.add_argument("--max-chunk-tokens", type=int, default=None,
                            help="prefill-token cap for rounds that also "
                                 "carry decode work (chunked prefill); "
                                 "0 disables mixing")
        parser.add_argument("--disable-log-stats", action="store_true")
        parser.add_argument("--revision", type=str, default=None)
        parser.add_argument("--tokenizer-revision", type=str, default=None)
        parser.add_argument("--quantization", "-q", type=str, default=None)
        parser.add_argument("--enforce-eager", action="store_true")
        parser.add_argument("--max-context-len-to-capture", type=int,
                            default=8192)
        parser.add_argument("--disable-custom-all-reduce",
                            action="store_true")
        parser.add_argument("--enable-lora", action="store_true")
        parser.add_argument("--max-loras", type=int, default=1)
        parser.add_argument("--max-lora-rank", type=int, default=16)
        parser.add_argument("--lora-extra-vocab-size", type=int,
                            default=256)
        parser.add_argument("--lora-dtype", type=str, default="auto")
        parser.add_argument("--max-cpu-loras", type=int, default=None)
        parser.add_argument("--device", type=str, default="auto",
                            choices=["auto", "cuda", "cpu"])
        return parser

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "EngineArgs":
        attrs = [f.name for f in dataclasses.fields(cls)]
        return cls(**{a: getattr(args, a) for a in attrs
                      if hasattr(args, a)})

    def create_engine_configs(self) -> Tuple[
            ModelConfig, CacheConfig, ParallelConfig, SchedulerConfig,
            DeviceConfig, Optional[LoRAConfig]]:
        from aphrodite_tpu_torch.common import flags
        model_config = ModelConfig(
            self.model, self.tokenizer, self.tokenizer_mode,
            self.trust_remote_code, self.download_dir, self.load_format,
            self.dtype, self.seed, self.revision, self.tokenizer_revision,
            self.max_model_len, self.quantization, self.enforce_eager,
            self.max_context_len_to_capture)
        cache_config = CacheConfig(
            self.block_size, self.gpu_memory_utilization, self.swap_space,
            self.kv_cache_dtype, model_config.get_sliding_window())
        # --disagg-split wins; None defers to the APHRODITE_DISAGG
        # flag (registry-validated read), "" explicitly colocates.
        disagg_spec = self.disagg_split
        if disagg_spec is None:
            disagg_spec = flags.get_str("APHRODITE_DISAGG")
        parallel_config = ParallelConfig(
            self.pipeline_parallel_size, self.tensor_parallel_size,
            self.data_parallel_size, self.worker_use_ray,
            self.max_parallel_loading_workers,
            self.disable_custom_all_reduce,
            sequence_parallel_size=self.sequence_parallel_size,
            sp_prefill_threshold=self.sp_prefill_threshold,
            disagg_split=ParallelConfig.parse_disagg_split(disagg_spec))
        scheduler_config = SchedulerConfig(
            self.max_num_batched_tokens, self.max_num_seqs,
            model_config.max_model_len, self.max_paddings,
            multi_step=self.multi_step,
            max_chunk_tokens=self.max_chunk_tokens)
        device_config = DeviceConfig(self.device)
        lora_config = None
        if self.enable_lora:
            lora_config = LoRAConfig(
                max_lora_rank=self.max_lora_rank,
                max_loras=self.max_loras,
                max_cpu_loras=self.max_cpu_loras,
                lora_extra_vocab_size=self.lora_extra_vocab_size,
                lora_dtype=self.lora_dtype)
            lora_config.verify_with_model_config(model_config)
            lora_config.verify_with_scheduler_config(scheduler_config)
        model_config.verify_with_parallel_config(parallel_config)
        cache_config.verify_with_parallel_config(parallel_config)
        return (model_config, cache_config, parallel_config,
                scheduler_config, device_config, lora_config)


@dataclass
class AsyncEngineArgs(EngineArgs):
    """Async-engine extras (reference `args_tools.py:314-338`)."""
    engine_use_ray: bool = False
    disable_log_requests: bool = False
    max_log_len: Optional[int] = None

    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser
                     ) -> argparse.ArgumentParser:
        parser = EngineArgs.add_cli_args(parser)
        parser.add_argument("--engine-use-ray", action="store_true")
        parser.add_argument("--disable-log-requests", action="store_true")
        parser.add_argument("--max-log-len", type=int, default=None)
        return parser
