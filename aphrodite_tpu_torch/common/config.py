"""Engine configuration objects for the PyTorch port.

Copied from the JAX package's `common/config.py` with the same classes
and semantics, narrowed to what the port serves so far: a dense
Mixtral or DeepSeek-MoE model, or a dense, GPTQ-quantized (2, 4 or 8
bits, any group size, act-order included), AWQ-quantized (4 bits), GGUF
(a `.gguf` file, dense or at rest), SqueezeLLM, load-time int8 or QuIP#
model of every other architecture the JAX package registers (the Llama
family, DeciLM, Qwen2, OPT, GPT-J, GPT-NeoX, Phi), Mistral's sliding
window included, on one CUDA card (or the CPU, when the caller asks for
it), in bfloat16, float16 or float32; KV pages in the model dtype, int8
or fp8 (e5m2). Quantized layers whose shape, bits, act-order or activation
dtype a kernel's gate refuses take the JAX package's dequantize-then-
matmul route in plain torch (each linear method's `apply`). Every
configuration outside that is refused HERE, with a message naming the
later slice that brings it (`refuse`), so nothing is silently ignored:

- tensor/data/sequence parallelism and the disaggregated split;
- LoRA on the MoE architectures (`LoRAConfig.verify_with_model_config`).

Quantization of any kind on an MoE architecture is refused as well, for
good: the reference serves no quantized experts (its FusedMoE stacks
float experts and takes no linear method); so is an architecture
neither package registers, and an OPT config whose
`word_embed_proj_dim` differs from `hidden_size`, which the reference
OPT (no `project_in` / `project_out`) cannot run.

`DeviceConfig` resolves to "cuda" or "cpu" only, and never falls back
to the CPU on its own.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.transformers_utils.config import get_config

logger = init_logger(__name__)

_GB = 1 << 30


def refuse(what: str, later: str) -> None:
    """Raise for a configuration this slice of the port does not serve,
    naming the later slice (ROADMAP.md Queue 1) that brings it."""
    raise NotImplementedError(
        f"{what} is not supported by the PyTorch port yet; it arrives "
        f"with a later slice: {later} (see ROADMAP.md).")


# String names avoid importing jax at config time.
_STR_DTYPE_TO_JAX = {
    "half": "float16",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "float": "float32",
    "float32": "float32",
}


class ModelConfig:
    """Model + tokenizer + dtype + max-length configuration.

    Args mirror the reference ModelConfig (`common/config.py:19-110`), minus
    CUDA-specific knobs; `model` may be a local path or HF repo id.
    """

    def __init__(
        self,
        model: str,
        tokenizer: Optional[str] = None,
        tokenizer_mode: str = "auto",
        trust_remote_code: bool = False,
        download_dir: Optional[str] = None,
        load_format: str = "auto",
        dtype: str = "auto",
        seed: int = 0,
        revision: Optional[str] = None,
        tokenizer_revision: Optional[str] = None,
        max_model_len: Optional[int] = None,
        quantization: Optional[str] = None,
        enforce_eager: bool = False,
        max_context_len_to_capture: Optional[int] = None,
        hf_config=None,
    ) -> None:
        self.model = model
        self.tokenizer = tokenizer or model
        self.tokenizer_mode = tokenizer_mode
        self.trust_remote_code = trust_remote_code
        self.download_dir = download_dir
        self.load_format = load_format
        self.seed = seed
        self.revision = revision
        self.tokenizer_revision = tokenizer_revision
        self.quantization = quantization
        self.enforce_eager = enforce_eager
        self.max_context_len_to_capture = max_context_len_to_capture

        self.hf_config = hf_config if hf_config is not None else get_config(
            model, trust_remote_code, revision)
        self.dtype = _get_and_verify_dtype(self.hf_config, dtype)
        self.max_model_len = _get_and_verify_max_len(self.hf_config,
                                                    max_model_len)
        self._verify_load_format()
        self._verify_tokenizer_mode()
        self._verify_quantization()
        self._verify_port_slice()

    def _verify_port_slice(self) -> None:
        """Refuse configurations outside the ported slices."""
        from aphrodite_tpu_torch.modeling.models import (ModelRegistry,
                                                         moe_architecture)
        moe = moe_architecture(self.hf_config)
        if moe and self.quantization is not None:
            raise NotImplementedError(
                f"quantization {self.quantization!r} on the MoE "
                f"architecture {moe}: the reference serves no quantized "
                "experts (its FusedMoE stacks float expert weights and "
                "takes no linear method, so a quantized expert's qweight "
                "cannot load there), and neither does the PyTorch port.")
        if self.quantization is not None:
            # The method's own checks (GPTQ's bit widths, AWQ's 4 bits)
            # run here, not at load.
            from aphrodite_tpu_torch.modeling.layers.quantization import (
                get_quantization_config)
            get_quantization_config(self)
        archs = getattr(self.hf_config, "architectures", None) or []
        if not any(ModelRegistry.load_model_cls(a) is not None
                   for a in archs):
            raise NotImplementedError(
                f"architecture {archs} is served by neither the JAX package "
                "nor its PyTorch port (supported architectures: "
                f"{ModelRegistry.get_supported_archs()}).")
        if "OPTForCausalLM" in archs and \
                self.hf_config.word_embed_proj_dim != \
                self.hf_config.hidden_size:
            raise NotImplementedError(
                f"OPT with word_embed_proj_dim "
                f"{self.hf_config.word_embed_proj_dim} != hidden_size "
                f"{self.hf_config.hidden_size} (opt-350m): the reference OPT "
                "has no project_in / project_out, so such a config does not "
                "run there, and the PyTorch port adds no projection of its "
                "own.")

    def _verify_load_format(self) -> None:
        load_format = self.load_format.lower()
        if load_format not in ("auto", "pt", "safetensors", "npcache",
                               "dummy", "gguf"):
            raise ValueError(
                f"Unknown load format: {self.load_format}. Must be one of "
                "'auto', 'pt', 'safetensors', 'npcache', 'gguf', or 'dummy'.")
        self.load_format = load_format

    def _verify_tokenizer_mode(self) -> None:
        tokenizer_mode = self.tokenizer_mode.lower()
        if tokenizer_mode not in ("auto", "slow"):
            raise ValueError(
                f"Unknown tokenizer mode: {self.tokenizer_mode}. Must be "
                "either 'auto' or 'slow'.")
        self.tokenizer_mode = tokenizer_mode

    def _verify_quantization(self) -> None:
        supported = ("awq", "gptq", "gguf", "squeezellm", "int8", "quip")
        if self.quantization is not None:
            self.quantization = self.quantization.lower()
            if self.quantization not in supported:
                raise ValueError(
                    f"Unknown quantization method: {self.quantization}. "
                    f"Must be one of {supported}.")
        hf_quant_config = getattr(self.hf_config, "quantization_config", None)
        if hf_quant_config is not None:
            hf_quant_method = str(hf_quant_config.get("quant_method",
                                                      "")).lower()
            if self.quantization is None:
                self.quantization = hf_quant_method
            elif self.quantization != hf_quant_method:
                raise ValueError(
                    "Quantization method specified in the model config "
                    f"({hf_quant_method}) does not match the quantization "
                    f"method specified in the `quantization` argument "
                    f"({self.quantization}).")

    def verify_with_parallel_config(
            self, parallel_config: "ParallelConfig") -> None:
        total_num_attention_heads = self.hf_config.num_attention_heads
        tp = parallel_config.tensor_parallel_size
        if total_num_attention_heads % tp != 0:
            raise ValueError(
                f"Total number of attention heads "
                f"({total_num_attention_heads}) must be divisible by "
                f"tensor parallel size ({tp}).")
        total_num_hidden_layers = self.hf_config.num_hidden_layers
        pp = parallel_config.pipeline_parallel_size
        if total_num_hidden_layers % pp != 0:
            raise ValueError(
                f"Total number of hidden layers ({total_num_hidden_layers}) "
                f"must be divisible by pipeline parallel size ({pp}).")
        if parallel_config.disagg_split is not None:
            # Each disagg group is its own tp submesh: every tp-sharded
            # weight dim must divide BOTH group sizes (jax rejects an
            # uneven NamedSharding at device_put time, so fail here
            # with the real constraint instead of mid-load).
            for group, n in zip(("prefill", "decode"),
                                parallel_config.disagg_split):
                if total_num_attention_heads % n != 0:
                    raise ValueError(
                        f"Total number of attention heads "
                        f"({total_num_attention_heads}) must be divisible "
                        f"by the disagg {group} group size ({n}).")

    def get_sliding_window(self) -> Optional[int]:
        return getattr(self.hf_config, "sliding_window", None)

    def get_vocab_size(self) -> int:
        return self.hf_config.vocab_size

    def get_hidden_size(self) -> int:
        return self.hf_config.hidden_size

    def get_head_size(self) -> int:
        if hasattr(self.hf_config, "head_dim") and self.hf_config.head_dim:
            return self.hf_config.head_dim
        return (self.hf_config.hidden_size //
                self.hf_config.num_attention_heads)

    def get_total_num_kv_heads(self) -> int:
        """Total KV heads before TP sharding (GQA/MQA aware)."""
        # Falcon-style multi_query flag.
        if getattr(self.hf_config, "multi_query", False):
            return 1
        for attr in ("n_head_kv", "num_kv_heads", "num_key_value_heads",
                     "multi_query_group_num"):
            value = getattr(self.hf_config, attr, None)
            if value is not None:
                return value
        return self.hf_config.num_attention_heads

    def get_num_kv_heads(self, parallel_config: "ParallelConfig") -> int:
        """KV heads per TP shard (at least 1: replicate if heads < tp)."""
        total = self.get_total_num_kv_heads()
        return max(1, total // parallel_config.tensor_parallel_size)

    def get_kv_heads_per_layer(self) -> list:
        """Per-layer KV head counts (DeciLM-style variable GQA,
        reference models/decilm.py); uniform for everything else."""
        per_layer = getattr(self.hf_config, "num_key_value_heads_per_layer",
                            None)
        if per_layer is not None:
            return list(per_layer)
        return [self.get_total_num_kv_heads()] * \
            self.hf_config.num_hidden_layers

    def get_num_attention_heads(
            self, parallel_config: "ParallelConfig") -> int:
        return (self.hf_config.num_attention_heads //
                parallel_config.tensor_parallel_size)

    def get_num_layers(self, parallel_config: "ParallelConfig") -> int:
        return (self.hf_config.num_hidden_layers //
                parallel_config.pipeline_parallel_size)


class CacheConfig:
    """Paged KV-cache configuration (reference: common/config.py:280-357).

    block_size defaults to 16 like the reference; on TPU, larger pages
    (64-128 tokens) amortize the per-page DMA into VMEM better and are
    worth setting explicitly for long-context serving.
    """

    def __init__(
        self,
        block_size: int = 16,
        gpu_memory_utilization: float = 0.90,
        swap_space: float = 4,
        cache_dtype: str = "auto",
        sliding_window: Optional[int] = None,
    ) -> None:
        self.block_size = block_size
        self.gpu_memory_utilization = gpu_memory_utilization
        self.swap_space_bytes = int(swap_space * _GB)
        self.cache_dtype = cache_dtype
        self.sliding_window = sliding_window
        self._verify_args()
        self._verify_cache_dtype()

        # Set after profiling:
        self.num_gpu_blocks: Optional[int] = None
        self.num_cpu_blocks: Optional[int] = None

    def _verify_args(self) -> None:
        if self.gpu_memory_utilization > 1.0:
            raise ValueError(
                "HBM memory utilization must be less than 1.0. Got "
                f"{self.gpu_memory_utilization}.")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")

    def _verify_cache_dtype(self) -> None:
        if self.cache_dtype not in ("auto", "fp8", "fp8_e5m2", "int8"):
            raise ValueError(
                f"Unknown kv cache dtype: {self.cache_dtype}. Must be one of "
                "'auto', 'fp8', 'fp8_e5m2', 'int8'.")
        if self.cache_dtype == "fp8_e5m2":
            self.cache_dtype = "fp8"

    def verify_with_parallel_config(
            self, parallel_config: "ParallelConfig") -> None:
        total_cpu_memory = _get_total_host_memory()
        num_replicas = parallel_config.tensor_parallel_size
        required = num_replicas * self.swap_space_bytes
        if required > 0.7 * total_cpu_memory:
            raise ValueError(
                "Too large swap space. "
                f"{required / _GB:.2f} GiB out of the "
                f"{total_cpu_memory / _GB:.2f} GiB total CPU memory is "
                "allocated for the swap space.")
        elif required > 0.4 * total_cpu_memory:
            logger.warning(
                "Possibly too large swap space. %.2f GiB out of the %.2f GiB "
                "total CPU memory is allocated for the swap space.",
                required / _GB, total_cpu_memory / _GB)


class ParallelConfig:
    """Mesh-axis sizes for the SPMD step function.

    Replaces the reference's Ray/NCCL world description
    (`common/config.py:359-405`): tp/sp/dp are named axes of one
    `jax.sharding.Mesh`; collectives ride ICI within a slice and DCN across
    slices (XLA picks based on mesh topology). Pipeline parallelism is NOT
    implemented — like the reference (`config.py:392-394`) pp>1 raises
    below, rather than silently building a mesh axis no PartitionSpec uses.
    """

    def __init__(
        self,
        pipeline_parallel_size: int = 1,
        tensor_parallel_size: int = 1,
        data_parallel_size: int = 1,
        worker_use_ray: bool = False,  # accepted for CLI parity; unused
        max_parallel_loading_workers: Optional[int] = None,
        disable_custom_all_reduce: bool = False,
        sequence_parallel_size: int = 1,
        sp_prefill_threshold: int = 1024,
        disagg_split: Optional[Tuple[int, int]] = None,
    ) -> None:
        self.pipeline_parallel_size = pipeline_parallel_size
        self.tensor_parallel_size = tensor_parallel_size
        self.data_parallel_size = data_parallel_size
        self.max_parallel_loading_workers = max_parallel_loading_workers
        self.disable_custom_all_reduce = disable_custom_all_reduce
        # Disaggregated prefill/decode (TPLA, arxiv 2508.15881): split
        # the tp chips into a (prefill, decode) group pair — e.g.
        # (2, 6) of 8 — each its own submesh. Prefill-phase programs
        # compile against the prefill submesh, decode/burst/spec-verify
        # against the decode submesh, and finished prefills hand their
        # KV pages off over ICI (CacheEngine.kv_handoff). None =
        # colocated (the classic single mesh).
        self.disagg_split = tuple(disagg_split) if disagg_split else None
        # Sequence/context parallelism: prompts whose (padded) length is
        # >= sp_prefill_threshold run prefill attention as a ring over
        # the sp mesh axis (ops/ring_attention.py) — K/V shards rotate
        # via ppermute on ICI, peak per-chip activation memory is
        # O(seq/sp). Beyond the reference's capabilities (it has no
        # SP/CP at all, SURVEY.md §2.3); decode stays on tp.
        self.sequence_parallel_size = sequence_parallel_size
        self.sp_prefill_threshold = sp_prefill_threshold
        self.world_size = (pipeline_parallel_size * tensor_parallel_size *
                           data_parallel_size * sequence_parallel_size)
        self._verify_args()

    #: Mesh axis names, in executor.build_mesh's construction order.
    MESH_AXES = ("dp", "pp", "sp", "tp")

    @property
    def mesh_shape(self) -> tuple:
        """(dp, pp, sp, tp) — ONE source of truth for the mesh layout,
        shared by executor.build_mesh and the bench harnesses' output
        JSON (so every capture records the topology it ran on)."""
        return (self.data_parallel_size, self.pipeline_parallel_size,
                self.sequence_parallel_size, self.tensor_parallel_size)

    @property
    def disagg(self) -> bool:
        """Whether the engine serves disaggregated (split submeshes)."""
        return self.disagg_split is not None

    def group_mesh_shape(self, group: str) -> tuple:
        """(dp, pp, sp, tp) of one disagg submesh ("prefill" or
        "decode") — same axis names as the colocated mesh so every
        PartitionSpec in the tree resolves unchanged on either group."""
        assert self.disagg_split is not None
        n = self.disagg_split[0 if group == "prefill" else 1]
        return (1, 1, 1, n)

    @staticmethod
    def parse_disagg_split(spec: Optional[str]
                           ) -> Optional[Tuple[int, int]]:
        """Parse a "2,6"-style split spec (CLI / APHRODITE_DISAGG);
        empty or None disables the split."""
        if not spec:
            return None
        parts = [p.strip() for p in str(spec).split(",")]
        if len(parts) != 2:
            raise ValueError(
                f"disagg split must be 'n_prefill,n_decode', got {spec!r}")
        return (int(parts[0]), int(parts[1]))

    def _verify_args(self) -> None:
        for name, value in (
            ("pipeline_parallel_size", self.pipeline_parallel_size),
            ("tensor_parallel_size", self.tensor_parallel_size),
            ("data_parallel_size", self.data_parallel_size),
            ("sequence_parallel_size", self.sequence_parallel_size),
        ):
            if value < 1:
                raise ValueError(f"{name} must be >= 1, got {value}.")
        if self.disagg_split is not None:
            refuse("the disaggregated prefill/decode split",
                   "multi-GPU")
        if (self.tensor_parallel_size, self.data_parallel_size,
                self.sequence_parallel_size) != (1, 1, 1):
            refuse("tensor, data or sequence parallelism", "multi-GPU")
        if self.pipeline_parallel_size > 1:
            raise NotImplementedError(
                "Pipeline parallelism is not supported yet: no PartitionSpec "
                "uses the pp mesh axis, so pp>1 would allocate chips that do "
                "no work. Shard with tensor_parallel_size and/or "
                "sequence_parallel_size instead.")
        if self.disagg_split is not None:
            n_p, n_d = self.disagg_split
            if n_p < 1 or n_d < 1:
                raise ValueError(
                    f"disagg_split groups must be >= 1 chip each, got "
                    f"{self.disagg_split}.")
            if n_p + n_d != self.tensor_parallel_size:
                raise ValueError(
                    f"disagg_split {self.disagg_split} must sum to "
                    f"tensor_parallel_size ({self.tensor_parallel_size}): "
                    "the split partitions the tp chips into a prefill "
                    "group and a decode group.")
            if (self.data_parallel_size, self.pipeline_parallel_size,
                    self.sequence_parallel_size) != (1, 1, 1):
                raise NotImplementedError(
                    "disagg_split composes with tensor parallelism only "
                    "(dp = pp = sp = 1): each group is a pure-tp "
                    "submesh.")


class SchedulerConfig:
    """Continuous-batching budgets (reference: common/config.py:407-452)."""

    def __init__(
        self,
        max_num_batched_tokens: Optional[int],
        max_num_seqs: int,
        max_model_len: int,
        max_paddings: int,
        multi_step: int = 1,
        max_chunk_tokens: Optional[int] = None,
    ) -> None:
        if max_num_batched_tokens is not None:
            self.max_num_batched_tokens = max_num_batched_tokens
        else:
            # Reasonable prefill budget; at least one full-length prompt.
            self.max_num_batched_tokens = max(max_model_len, 2048)
        self.max_num_seqs = max_num_seqs
        self.max_model_len = max_model_len
        self.max_paddings = max_paddings
        # Decode steps per scheduling round (>1 = device-side multi-step
        # decode with token feedback; eligibility checked per batch).
        self.multi_step = max(1, multi_step)
        # Prefill-token cap for rounds that ALSO carry decode work
        # (chunked prefill): bounds how long an arrival can stall the
        # decode stream. Pure-prefill rounds (nothing running) use the
        # full max_num_batched_tokens budget. 0 disables mixing —
        # prompts then wait for a dedicated round like the reference.
        self.max_chunk_tokens = max_chunk_tokens \
            if max_chunk_tokens is not None else 2048
        self._verify_args()

    def _verify_args(self) -> None:
        if self.max_num_batched_tokens < self.max_model_len:
            raise ValueError(
                f"max_num_batched_tokens ({self.max_num_batched_tokens}) is "
                f"smaller than max_model_len ({self.max_model_len}). "
                "This effectively limits the maximum sequence length to "
                "max_num_batched_tokens and makes the scheduler reject "
                "longer sequences.")
        if self.max_num_batched_tokens < self.max_num_seqs:
            raise ValueError(
                f"max_num_batched_tokens ({self.max_num_batched_tokens}) "
                "must be greater than or equal to max_num_seqs "
                f"({self.max_num_seqs}).")


class DeviceConfig:
    """torch device selection: 'auto' and 'cuda' need a CUDA card and
    raise without one; the CPU runs only when the caller asks for it
    (`device="cpu"`, as the tests do)."""

    def __init__(self, device: str = "auto") -> None:
        if device not in ("auto", "cuda", "cpu"):
            raise ValueError(f"Unknown device: {device}. "
                             "Must be 'auto', 'cuda', or 'cpu'.")
        self.device_type = device

    def resolve(self) -> str:
        if self.device_type == "cpu":
            return "cpu"
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={self.device_type!r} needs a CUDA card and none "
                "is visible; pass device='cpu' to run on the CPU.")
        return "cuda"


class LoRAConfig:
    """Multi-LoRA serving limits (reference: common/config.py:461-520)."""

    SUPPORTED_RANKS = (8, 16, 32, 64)

    def __init__(
        self,
        max_lora_rank: int = 16,
        max_loras: int = 1,
        max_cpu_loras: Optional[int] = None,
        lora_extra_vocab_size: int = 256,
        lora_dtype: Optional[str] = None,
    ) -> None:
        self.max_lora_rank = max_lora_rank
        self.max_loras = max_loras
        self.max_cpu_loras = max_cpu_loras
        self.lora_extra_vocab_size = lora_extra_vocab_size
        self.lora_dtype = lora_dtype
        self._verify_args()

    def _verify_args(self) -> None:
        if self.max_lora_rank not in self.SUPPORTED_RANKS:
            raise ValueError(f"max_lora_rank ({self.max_lora_rank}) must be "
                             f"one of {self.SUPPORTED_RANKS}.")
        if self.max_loras < 1:
            raise ValueError(f"max_loras ({self.max_loras}) must be >= 1.")
        if self.max_cpu_loras is None:
            self.max_cpu_loras = self.max_loras
        elif self.max_cpu_loras < self.max_loras:
            raise ValueError(
                f"max_cpu_loras ({self.max_cpu_loras}) must be >= "
                f"max_loras ({self.max_loras}).")

    def verify_with_model_config(self, model_config: ModelConfig) -> None:
        from aphrodite_tpu_torch.modeling.models import moe_architecture
        moe = moe_architecture(model_config.hf_config)
        if moe:
            refuse(f"LoRA on the MoE architecture {moe}",
                   "LoRA on MoE models (ROADMAP.md Queue 1)")
        if self.lora_dtype in (None, "auto"):
            self.lora_dtype = model_config.dtype

    def verify_with_scheduler_config(
            self, scheduler_config: SchedulerConfig) -> None:
        if scheduler_config.max_num_batched_tokens > 65528:
            raise ValueError(
                "Due to limitations of the LoRA gather kernel, "
                "max_num_batched_tokens must be <= 65528 when "
                "LoRA is enabled.")


def _get_total_host_memory() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 64 * _GB


def _get_and_verify_dtype(hf_config, dtype: Union[str, "object"]) -> str:
    """Resolve 'auto' to a concrete dtype string.

    'auto' maps float16-trained checkpoints to bfloat16, as the JAX
    package does, so both sides pick the same compute dtype.
    """
    config_dtype = getattr(hf_config, "torch_dtype", None)
    config_dtype = str(config_dtype).replace("torch.", "") if config_dtype \
        else "float32"

    if isinstance(dtype, str):
        dtype = dtype.lower()
        if dtype == "auto":
            if config_dtype in ("float16", "float32"):
                resolved = "bfloat16" if config_dtype == "float16" \
                    else "float32"
            else:
                resolved = config_dtype
        else:
            if dtype not in _STR_DTYPE_TO_JAX:
                raise ValueError(f"Unknown dtype: {dtype}")
            resolved = _STR_DTYPE_TO_JAX[dtype]
    else:
        raise ValueError(f"Unknown dtype: {dtype}")

    if resolved not in ("float16", "bfloat16", "float32"):
        raise ValueError(f"Unsupported compute dtype: {resolved}")
    return resolved


def _get_and_verify_max_len(hf_config,
                            max_model_len: Optional[int]) -> int:
    """Derive max model length from HF config (reference config.py:560-626),
    including RoPE-scaling multipliers and auto-extension."""
    derived_max_model_len = float("inf")
    possible_keys = [
        "max_position_embeddings",
        "n_positions",
        "max_seq_len",
        "seq_length",
        "max_sequence_length",
        "max_seq_length",
        "seq_len",
    ]
    for key in possible_keys:
        max_len_key = getattr(hf_config, key, None)
        if max_len_key is not None:
            derived_max_model_len = min(derived_max_model_len, max_len_key)
    if derived_max_model_len == float("inf"):
        if max_model_len is not None:
            return max_model_len
        default_max_len = 2048
        logger.warning(
            "The model's config.json does not contain any of the following "
            "keys to determine the original maximum length of the model: "
            "%s. Assuming the model's maximum length is %d.", possible_keys,
            default_max_len)
        derived_max_model_len = default_max_len

    rope_scaling = getattr(hf_config, "rope_scaling", None)
    if rope_scaling is not None:
        factor = rope_scaling.get("factor", 1.0)
        scaling_type = rope_scaling.get("type",
                                        rope_scaling.get("rope_type", ""))
        if scaling_type == "yarn":
            derived_max_model_len = rope_scaling.get(
                "original_max_position_embeddings", derived_max_model_len)
        derived_max_model_len *= factor

    if max_model_len is None:
        return int(derived_max_model_len)
    if max_model_len > derived_max_model_len:
        # Auto-enable dynamic rope scaling to honor the request
        # (reference: config.py:607-626).
        scaling_factor = max_model_len / derived_max_model_len
        logger.warning(
            "Requested max_model_len %d exceeds the derived maximum %d; "
            "enabling dynamic RoPE scaling with factor %.2f.", max_model_len,
            int(derived_max_model_len), scaling_factor)
        hf_config.rope_scaling = {
            "type": "dynamic",
            "factor": scaling_factor,
        }
    return int(max_model_len)
