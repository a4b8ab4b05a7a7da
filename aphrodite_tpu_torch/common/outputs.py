"""User-facing request outputs (reference: aphrodite/common/outputs.py:8,53,85)."""
from __future__ import annotations

from typing import List, Optional

from aphrodite_tpu_torch.common.sequence import (PromptLogprobs, SampleLogprobs,
                                           SequenceGroup, SequenceStatus)


class CompletionOutput:
    """One generated completion of a request."""

    def __init__(
        self,
        index: int,
        text: str,
        token_ids: List[int],
        cumulative_logprob: float,
        logprobs: Optional[SampleLogprobs],
        finish_reason: Optional[str] = None,
    ) -> None:
        self.index = index
        self.text = text
        self.token_ids = token_ids
        self.cumulative_logprob = cumulative_logprob
        self.logprobs = logprobs
        self.finish_reason = finish_reason

    def finished(self) -> bool:
        return self.finish_reason is not None

    def __repr__(self) -> str:
        return (f"CompletionOutput(index={self.index}, "
                f"text={self.text!r}, "
                f"token_ids={self.token_ids}, "
                f"cumulative_logprob={self.cumulative_logprob}, "
                f"finish_reason={self.finish_reason})")


class RequestOutput:
    """Output of one request: prompt info + n completions."""

    def __init__(
        self,
        request_id: str,
        prompt: str,
        prompt_token_ids: List[int],
        prompt_logprobs: Optional[PromptLogprobs],
        outputs: List[CompletionOutput],
        finished: bool,
        resumed_tokens: int = 0,
        resumed_text: str = "",
    ) -> None:
        self.request_id = request_id
        self.prompt = prompt
        self.prompt_token_ids = prompt_token_ids
        self.prompt_logprobs = prompt_logprobs
        self.outputs = outputs
        self.finished = finished
        # Continuation baseline (engine resume seam): output tokens /
        # text already delivered by a prior incarnation of this
        # request — `outputs[].token_ids`/`.text` INCLUDE them, and a
        # resuming frontend streams only what lies beyond.
        self.resumed_tokens = resumed_tokens
        self.resumed_text = resumed_text

    @classmethod
    def from_seq_group(cls, seq_group: SequenceGroup) -> "RequestOutput":
        # Pick the top-n sequences by cumulative logprob (beam score when
        # beam searching), matching reference outputs.py:85.
        seqs = seq_group.get_seqs()
        n = seq_group.sampling_params.n
        if seq_group.sampling_params.use_beam_search:
            sorting_key = lambda seq: seq.get_beam_search_score(
                seq_group.sampling_params.length_penalty)
        else:
            sorting_key = lambda seq: seq.get_cumulative_logprob()
        sorted_seqs = sorted(seqs, key=sorting_key, reverse=True)
        top_n_seqs = sorted_seqs[:n]

        include_logprobs = seq_group.sampling_params.logprobs is not None
        outputs = [
            CompletionOutput(
                # Stable per-sequence index (insertion order), not the
                # sorted rank: streaming clients key chunks by index.
                index=seqs.index(seq),
                text=seq.output_text,
                token_ids=seq.get_output_token_ids(),
                cumulative_logprob=seq.get_cumulative_logprob(),
                logprobs=seq.output_logprobs if include_logprobs else None,
                finish_reason=SequenceStatus.get_finished_reason(seq.status),
            ) for seq in top_n_seqs
        ]

        return cls(
            request_id=seq_group.request_id,
            prompt=seq_group.prompt,
            prompt_token_ids=seq_group.prompt_token_ids,
            prompt_logprobs=seq_group.prompt_logprobs,
            outputs=outputs,
            finished=seq_group.is_finished(),
            resumed_tokens=seq_group.resumed_tokens,
            resumed_text=seq_group.resumed_text,
        )

    def __repr__(self) -> str:
        return (f"RequestOutput(request_id={self.request_id}, "
                f"prompt={self.prompt!r}, "
                f"outputs={self.outputs}, "
                f"finished={self.finished})")
