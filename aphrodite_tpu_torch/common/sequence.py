"""Sequence data model: per-request token state and scheduler metadata.

Covers the roles of the reference's `aphrodite/common/sequence.py:15,52,
101,233,354,395,434,458` (SequenceStatus/SequenceData/Sequence/
SequenceGroup/SequenceGroupMetadata/SequenceOutput/SequenceGroupOutput/
SamplerOutput) with one TPU-native simplification: the reference
maintains per-block token-id lists (`LogicalTokenBlock` append/full
bookkeeping) because its CPU path re-reads them; here KV content only
ever reaches the device through slot mappings built from token COUNTS,
so a sequence's logical-block structure is pure arithmetic on its
length and `logical_token_blocks` is a derived view.
"""
from __future__ import annotations

import copy
import enum
from typing import Dict, List, Optional

from aphrodite_tpu_torch.common.prefix import Prefix
from aphrodite_tpu_torch.common.sampling_params import SamplingParams

PromptLogprobs = List[Optional[Dict[int, float]]]
SampleLogprobs = List[Dict[int, float]]


class SequenceStatus(enum.Enum):
    WAITING = enum.auto()
    RUNNING = enum.auto()
    SWAPPED = enum.auto()
    FINISHED_STOPPED = enum.auto()
    FINISHED_LENGTH_CAPPED = enum.auto()
    FINISHED_ABORTED = enum.auto()
    FINISHED_IGNORED = enum.auto()

    @staticmethod
    def is_finished(status: "SequenceStatus") -> bool:
        return status in _FINISHED

    @staticmethod
    def get_finished_reason(status: "SequenceStatus") -> Optional[str]:
        return _FINISH_REASON.get(status)


_FINISHED = frozenset({
    SequenceStatus.FINISHED_STOPPED,
    SequenceStatus.FINISHED_LENGTH_CAPPED,
    SequenceStatus.FINISHED_ABORTED,
    SequenceStatus.FINISHED_IGNORED,
})

_FINISH_REASON = {
    SequenceStatus.FINISHED_STOPPED: "stop",
    SequenceStatus.FINISHED_LENGTH_CAPPED: "length",
    SequenceStatus.FINISHED_ABORTED: "abort",
    # An ignored prompt exceeded max_model_len: report it like a
    # length stop, matching the reference's API surface.
    SequenceStatus.FINISHED_IGNORED: "length",
}


class SequenceData:
    """Token ids + cumulative logprob for one sequence."""

    __slots__ = ("prompt_token_ids", "output_token_ids",
                 "cumulative_logprob", "num_computed_tokens")

    def __init__(self, prompt_token_ids: List[int]) -> None:
        self.prompt_token_ids = prompt_token_ids
        self.output_token_ids: List[int] = []
        self.cumulative_logprob = 0.0
        # Prompt tokens whose KV is already written (chunked-prefill
        # progress); reset to 0 on recompute-preemption.
        self.num_computed_tokens = 0

    def append_token_id(self, token_id: int, logprob: float) -> None:
        self.output_token_ids.append(token_id)
        self.cumulative_logprob += logprob

    def get_len(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    def get_prompt_len(self) -> int:
        return len(self.prompt_token_ids)

    def get_output_len(self) -> int:
        return len(self.output_token_ids)

    def get_token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    def get_last_token_id(self) -> int:
        tail = self.output_token_ids or self.prompt_token_ids
        return tail[-1]

    def __repr__(self) -> str:
        return (f"SequenceData(prompt_len={len(self.prompt_token_ids)}, "
                f"output_len={len(self.output_token_ids)}, "
                f"cumulative_logprob={self.cumulative_logprob})")


class Sequence:
    """One generation stream: token data, page math, detok state."""

    def __init__(
        self,
        seq_id: int,
        prompt: str,
        prompt_token_ids: List[int],
        block_size: int,
        lora_request=None,
    ) -> None:
        self.seq_id = seq_id
        self.prompt = prompt
        self.block_size = block_size
        self.lora_request = lora_request
        self.data = SequenceData(prompt_token_ids)
        self.status = SequenceStatus.WAITING

        self.output_logprobs: SampleLogprobs = []
        self.output_text = ""
        # Incremental detokenization cursor
        # (transformers_utils/tokenizer.py detokenize_incrementally).
        self.prefix_offset = 0
        self.read_offset = 0
        self.tokens: Optional[List[str]] = None

        # Stateful-sampler state (mirostat mu) round-trips host-side
        # per sequence (see sampling_metadata.PersistentMetadata).
        self.persistent_data: dict = {}

    @property
    def lora_int_id(self) -> int:
        return self.lora_request.lora_int_id if self.lora_request else 0

    @property
    def logical_token_blocks(self) -> range:
        """Derived block structure: the ceil-div page count of the
        token length. A `range` so `len()` (the only operation the
        block manager and tests perform) stays O(1) with nothing to
        maintain on append/fork."""
        size = self.block_size
        return range((self.get_len() + size - 1) // size)

    def append_token_id(self, token_id: int,
                        logprobs: Dict[int, float]) -> None:
        assert token_id in logprobs
        self.output_logprobs.append(logprobs)
        self.data.append_token_id(token_id, logprobs[token_id])

    def get_len(self) -> int:
        return self.data.get_len()

    def get_prompt_len(self) -> int:
        return self.data.get_prompt_len()

    def get_output_len(self) -> int:
        return self.data.get_output_len()

    def get_token_ids(self) -> List[int]:
        return self.data.get_token_ids()

    def get_last_token_id(self) -> int:
        return self.data.get_last_token_id()

    def get_output_token_ids(self) -> List[int]:
        return self.data.output_token_ids

    def get_cumulative_logprob(self) -> float:
        return self.data.cumulative_logprob

    def get_beam_search_score(self,
                              length_penalty: float = 1.0,
                              seq_len: Optional[int] = None,
                              eos_token_id: Optional[int] = None
                              ) -> float:
        """GNMT-style length-normalized cumulative logprob."""
        if seq_len is None:
            seq_len = self.get_len()
            if (eos_token_id is not None
                    and self.get_last_token_id() == eos_token_id):
                seq_len -= 1
        return self.get_cumulative_logprob() / (seq_len ** length_penalty)

    def is_finished(self) -> bool:
        return self.status in _FINISHED

    def fork(self, new_seq_id: int) -> "Sequence":
        child = copy.deepcopy(self)
        child.seq_id = new_seq_id
        return child

    def __repr__(self) -> str:
        return (f"Sequence(seq_id={self.seq_id}, "
                f"status={self.status.name}, "
                f"num_blocks={len(self.logical_token_blocks)})")


class SequenceGroup:
    """All sequences generated from the same prompt (one request)."""

    def __init__(
        self,
        request_id: str,
        seqs: List[Sequence],
        sampling_params: SamplingParams,
        arrival_time: float,
        prefix: Optional[Prefix] = None,
        lora_request=None,
        deadline: Optional[float] = None,
    ) -> None:
        self.request_id = request_id
        self.seqs_dict = {seq.seq_id: seq for seq in seqs}
        self.sampling_params = sampling_params
        self.arrival_time = arrival_time
        self.prefix = prefix
        self.lora_request = lora_request
        # Absolute TTFT deadline (monotonic clock, arrival + SLO):
        # the scheduler expires the group if it is still waiting,
        # never computed, past this instant. None = no deadline.
        self.deadline = deadline
        # Mid-stream continuation (engine resume seam): how many
        # output tokens were already emitted to the client by a prior
        # incarnation of this request, and the text they detokenized
        # to — frontends resume their delta stream from this baseline
        # instead of re-emitting the spliced prefix.
        self.resumed_tokens: int = 0
        self.resumed_text: str = ""
        self.prompt_logprobs: Optional[PromptLogprobs] = None
        # Latency stamps (reference RequestMetrics): written by the
        # engine as tokens arrive, drained by _get_stats.
        self.first_token_time: Optional[float] = None
        self.last_token_time: float = arrival_time
        self.finished_time: Optional[float] = None

    @property
    def prompt(self) -> str:
        return self._any_seq().prompt

    @property
    def prompt_token_ids(self) -> List[int]:
        return self._any_seq().data.prompt_token_ids

    @property
    def lora_int_id(self) -> int:
        return self.lora_request.lora_int_id if self.lora_request else 0

    def _any_seq(self) -> Sequence:
        return next(iter(self.seqs_dict.values()))

    def get_max_num_running_seqs(self) -> int:
        """Upper bound on simultaneously-running sequences over the
        request's remaining lifetime (the scheduler's seat count)."""
        params = self.sampling_params
        if params.use_beam_search or params.best_of > self.num_seqs():
            # Beam width, or a prompt whose best_of children have not
            # forked yet.
            return params.best_of
        return self.num_unfinished_seqs()

    def get_seqs(self, status: Optional[SequenceStatus] = None
                 ) -> List[Sequence]:
        seqs = self.seqs_dict.values()
        if status is None:
            return list(seqs)
        return [s for s in seqs if s.status == status]

    def get_unfinished_seqs(self) -> List[Sequence]:
        return [s for s in self.seqs_dict.values() if not s.is_finished()]

    def get_finished_seqs(self) -> List[Sequence]:
        return [s for s in self.seqs_dict.values() if s.is_finished()]

    def num_seqs(self, status: Optional[SequenceStatus] = None) -> int:
        return len(self.get_seqs(status))

    def num_unfinished_seqs(self) -> int:
        return len(self.get_unfinished_seqs())

    def num_finished_seqs(self) -> int:
        return len(self.get_finished_seqs())

    def find(self, seq_id: int) -> Sequence:
        try:
            return self.seqs_dict[seq_id]
        except KeyError:
            raise ValueError(f"Sequence {seq_id} not found.") from None

    def add(self, seq: Sequence) -> None:
        if seq.seq_id in self.seqs_dict:
            raise ValueError(f"Sequence {seq.seq_id} already exists.")
        self.seqs_dict[seq.seq_id] = seq

    def remove(self, seq_id: int) -> None:
        if self.seqs_dict.pop(seq_id, None) is None:
            raise ValueError(f"Sequence {seq_id} not found.")

    def is_finished(self) -> bool:
        return all(s.is_finished() for s in self.seqs_dict.values())

    def __repr__(self) -> str:
        return (f"SequenceGroup(request_id={self.request_id}, "
                f"sampling_params={self.sampling_params}, "
                f"num_seqs={len(self.seqs_dict)})")


class SequenceGroupMetadata:
    """Per-round scheduling metadata handed to the executor for one
    group. Chunked prefill rides here: `computed_ctx` tokens are
    already in the KV cache and this round computes `chunk_len` more
    (None = the rest); only the final chunk samples a token."""

    def __init__(
        self,
        request_id: str,
        is_prompt: bool,
        seq_data: Dict[int, SequenceData],
        sampling_params: SamplingParams,
        block_tables: Dict[int, List[int]],
        persistent_data: Dict[int, dict],
        prefix: Optional[Prefix] = None,
        lora_request=None,
        computed_ctx: int = 0,
        chunk_len: Optional[int] = None,
        is_final_chunk: bool = True,
    ) -> None:
        self.request_id = request_id
        self.is_prompt = is_prompt
        self.seq_data = seq_data
        self.sampling_params = sampling_params
        self.block_tables = block_tables
        self.persistent_data = persistent_data
        self.prefix = prefix
        self.lora_request = lora_request
        self.computed_ctx = computed_ctx
        self.chunk_len = chunk_len
        self.is_final_chunk = is_final_chunk

    @property
    def lora_int_id(self) -> int:
        return self.lora_request.lora_int_id if self.lora_request else 0


class SequenceOutput:
    """One sampled token for one (parent) sequence."""

    def __init__(self, parent_seq_id: int, output_token: int,
                 logprobs: Dict[int, float],
                 persistent_data: dict) -> None:
        self.parent_seq_id = parent_seq_id
        self.output_token = output_token
        self.logprobs = logprobs
        self.persistent_data = persistent_data

    def __repr__(self) -> str:
        return (f"SequenceOutput(parent_seq_id={self.parent_seq_id}, "
                f"output_token={self.output_token})")

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SequenceOutput):
            raise NotImplementedError()
        return (self.parent_seq_id == other.parent_seq_id
                and self.output_token == other.output_token
                and self.logprobs == other.logprobs)


class SequenceGroupOutput:
    """Sampler output for one sequence group in one step."""

    def __init__(self, samples: List[SequenceOutput],
                 prompt_logprobs: Optional[PromptLogprobs]) -> None:
        self.samples = samples
        self.prompt_logprobs = prompt_logprobs

    def __repr__(self) -> str:
        return (f"SequenceGroupOutput(samples={self.samples}, "
                f"prompt_logprobs={self.prompt_logprobs})")

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SequenceGroupOutput):
            raise NotImplementedError()
        return (self.samples == other.samples
                and self.prompt_logprobs == other.prompt_logprobs)


# One entry per scheduled sequence group, in schedule order.
SamplerOutput = List[SequenceGroupOutput]
