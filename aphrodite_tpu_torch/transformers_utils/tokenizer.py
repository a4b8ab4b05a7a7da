"""Tokenizer utilities + incremental detokenization.

Reference semantics: `aphrodite/transformers_utils/tokenizer.py:70,149,246`
(get_tokenizer / TokenizerGroup / detokenize_incrementally). The
incremental detokenizer keeps (tokens, prefix_offset, read_offset) per
sequence and only re-decodes a small sliding window, so the per-token host
cost stays O(window) — the host also runs the scheduler between device steps.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

from transformers import (AutoTokenizer, PreTrainedTokenizer,
                          PreTrainedTokenizerFast)

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.utils import LRUCache

logger = init_logger(__name__)

AnyTokenizer = Union[PreTrainedTokenizer, PreTrainedTokenizerFast]

# Number of tokens to look back when re-joining the decoded text.
_INITIAL_INCREMENTAL_DETOKENIZATION_OFFSET = 5


def convert_gguf_to_tokenizer(checkpoint: str):
    """Build a fast tokenizer from GGUF `tokenizer.ggml.*` metadata
    (reference `transformers_utils/tokenizer.py:17-70`).

    The reference serializes a sentencepiece ModelProto and loads it via
    the slow LlamaTokenizer (needs the sentencepiece package). Here the
    proto goes straight through transformers' LlamaConverter — which
    parses it with protobuf only — yielding the fast tokenizer directly.
    """
    import tempfile

    from transformers import PreTrainedTokenizerFast
    from transformers.convert_slow_tokenizer import (LlamaConverter,
                                                     import_protobuf)

    from aphrodite_tpu_torch.modeling.gguf import GGUFReader

    reader = GGUFReader(checkpoint)
    fields = reader.fields
    tokens = fields["tokenizer.ggml.tokens"]
    scores = fields.get("tokenizer.ggml.scores",
                        [0.0] * len(tokens))
    types = fields.get("tokenizer.ggml.token_type", [1] * len(tokens))

    unk_id = int(fields.get("tokenizer.ggml.unknown_token_id", 0))
    model_pb2 = import_protobuf()
    proto = model_pb2.ModelProto()
    proto.trainer_spec.model_type = 2          # BPE
    proto.trainer_spec.vocab_size = len(tokens)
    proto.trainer_spec.byte_fallback = True
    proto.trainer_spec.unk_piece = tokens[unk_id]
    proto.normalizer_spec.remove_extra_whitespaces = False
    for piece, score, ttype in zip(tokens, scores, types):
        sp = proto.SentencePiece()
        sp.piece = piece
        sp.score = float(score)
        sp.type = int(ttype)
        proto.pieces.append(sp)

    with tempfile.NamedTemporaryFile(mode="wb", suffix=".model",
                                     delete=False) as f:
        f.write(proto.SerializeToString())
        vocab_file = f.name

    def tok_of(field, default):
        idx = fields.get(field)
        return tokens[int(idx)] if idx is not None and \
            int(idx) < len(tokens) else default

    class _SlowShim:
        """The minimal surface LlamaConverter reads from a slow
        tokenizer: the proto path, legacy flags, and id->token for the
        first three (special) pieces."""
        def __init__(self):
            self.vocab_file = vocab_file
            self.legacy = True
            self.add_prefix_space = True

        def convert_ids_to_tokens(self, idx):
            return tokens[idx]

    class _MergesExtractor:
        """Drop-in for SentencePieceExtractor: transformers only uses it
        to derive BPE merges, and its generate_merges helper needs just
        (vocab, scores) — no sentencepiece dependency."""
        def __init__(self, _path):
            pass

        def extract(self, vocab_scores):
            from transformers.convert_slow_tokenizer import \
                generate_merges
            vocab = {piece: i for i, (piece, _) in
                     enumerate(vocab_scores)}
            return vocab, generate_merges(vocab, vocab_scores)

    class _Converter(LlamaConverter):
        SpmExtractor = _MergesExtractor

    try:
        fast = _Converter(_SlowShim()).converted()
    finally:
        os.unlink(vocab_file)
    return PreTrainedTokenizerFast(
        tokenizer_object=fast,
        bos_token=tok_of("tokenizer.ggml.bos_token_id", "<s>"),
        eos_token=tok_of("tokenizer.ggml.eos_token_id", "</s>"),
        unk_token=tokens[unk_id],
        pad_token=tok_of("tokenizer.ggml.padding_token_id", None),
    )


def get_tokenizer(
    tokenizer_name: str,
    *args,
    tokenizer_mode: str = "auto",
    trust_remote_code: bool = False,
    tokenizer_revision: Optional[str] = None,
    **kwargs,
) -> AnyTokenizer:
    if tokenizer_name.endswith(".gguf"):
        return convert_gguf_to_tokenizer(tokenizer_name)
    if tokenizer_mode == "slow":
        if kwargs.get("use_fast", False):
            raise ValueError(
                "Cannot use the fast tokenizer in slow tokenizer mode.")
        kwargs["use_fast"] = False
    try:
        tokenizer = AutoTokenizer.from_pretrained(
            tokenizer_name,
            *args,
            trust_remote_code=trust_remote_code,
            revision=tokenizer_revision,
            **kwargs)
    except ValueError as e:
        if (not trust_remote_code and "requires you to execute" in str(e)):
            raise RuntimeError(
                "Failed to load the tokenizer. Consider setting "
                "`trust_remote_code=True`.") from e
        raise
    if not isinstance(tokenizer, PreTrainedTokenizerFast):
        logger.warning(
            "Using a slow tokenizer. This might cause a significant "
            "slowdown. Consider using a fast tokenizer instead.")
    return tokenizer


class TokenizerGroup:
    """A group of tokenizers: base + (future) per-LoRA adapters."""

    def __init__(self,
                 tokenizer_id: str,
                 enable_lora: bool = False,
                 max_num_seqs: Optional[int] = None,
                 max_input_length: Optional[int] = None,
                 **tokenizer_config) -> None:
        self.tokenizer_id = tokenizer_id
        self.tokenizer_config = tokenizer_config
        self.enable_lora = enable_lora
        self.max_input_length = max_input_length
        self.tokenizer = get_tokenizer(tokenizer_id, **tokenizer_config)
        if enable_lora:
            self.lora_tokenizers: Optional[LRUCache] = LRUCache(
                capacity=max_num_seqs or 64)
        else:
            self.lora_tokenizers = None

    def encode(self,
               prompt: str,
               request_id: Optional[str] = None,
               lora_request=None) -> List[int]:
        tokenizer = self.get_lora_tokenizer(lora_request)
        return tokenizer.encode(prompt)

    async def encode_async(self,
                           prompt: str,
                           request_id: Optional[str] = None,
                           lora_request=None) -> List[int]:
        return self.encode(prompt, request_id, lora_request)

    def get_lora_tokenizer(self, lora_request=None) -> AnyTokenizer:
        if not lora_request or self.lora_tokenizers is None:
            return self.tokenizer
        tokenizer = self.lora_tokenizers.get(lora_request.lora_int_id)
        if tokenizer is None:
            try:
                tokenizer = get_tokenizer(lora_request.lora_local_path,
                                          **self.tokenizer_config)
            except OSError:
                # No per-adapter tokenizer; fall back to base.
                tokenizer = self.tokenizer
            self.lora_tokenizers.put(lora_request.lora_int_id, tokenizer)
        return tokenizer


def _convert_tokens_to_string_with_added_encoders(
    tokenizer: AnyTokenizer,
    output_tokens: List[str],
    skip_special_tokens: bool,
    spaces_between_special_tokens: bool,
) -> str:
    """Handle added (non-vocab) tokens which the fast path can't batch."""
    sub_texts: List[str] = []
    current_sub_text: List[str] = []
    all_special_tokens = set(tokenizer.all_special_tokens)
    for token in output_tokens:
        if skip_special_tokens and token in all_special_tokens:
            continue
        if token in tokenizer.get_added_vocab():
            if current_sub_text:
                sub_texts.append(
                    tokenizer.convert_tokens_to_string(current_sub_text))
                current_sub_text = []
            sub_texts.append(token)
        else:
            current_sub_text.append(token)
    if current_sub_text:
        sub_texts.append(tokenizer.convert_tokens_to_string(current_sub_text))
    if spaces_between_special_tokens:
        return " ".join(sub_texts)
    return "".join(sub_texts)


def convert_prompt_ids_to_tokens(
    tokenizer: AnyTokenizer,
    prompt_ids: List[int],
    skip_special_tokens: bool = False,
) -> Tuple[List[str], int, int]:
    """Seed incremental detok state from the tail of the prompt."""
    # Only the last few prompt tokens are needed to stitch text correctly.
    num_input = _INITIAL_INCREMENTAL_DETOKENIZATION_OFFSET + 1
    new_tokens = tokenizer.convert_ids_to_tokens(
        prompt_ids[-num_input:], skip_special_tokens=skip_special_tokens)
    prefix_offset = max(
        len(new_tokens) - _INITIAL_INCREMENTAL_DETOKENIZATION_OFFSET, 0)
    read_offset = len(new_tokens)
    return new_tokens, prefix_offset, read_offset


def detokenize_incrementally(
    tokenizer: AnyTokenizer,
    all_input_ids: List[int],
    prev_tokens: Optional[List[str]],
    prefix_offset: int,
    read_offset: int,
    skip_special_tokens: bool = False,
    spaces_between_special_tokens: bool = True,
) -> Tuple[List[str], str, int, int]:
    """Decode only the newly appended token, reusing prior detok state.

    Returns (new_tokens, new_decoded_text, new_prefix_offset,
    new_read_offset). The sliding (prefix_offset, read_offset) window
    avoids re-decoding the full sequence every step and handles multi-token
    unicode (e.g. byte-fallback emoji) by emitting nothing until the
    decoded window no longer ends in a replacement char.
    """
    new_token_id = all_input_ids[-1]
    if prev_tokens is None:
        # First call: decode everything so far.
        new_tokens = tokenizer.convert_ids_to_tokens(
            all_input_ids, skip_special_tokens=skip_special_tokens)
        # Out-of-vocab ids decode to None (GGUF conversions, padded
        # vocab): treat as empty.
        new_tokens = [t if t is not None else "" for t in new_tokens]
        output_tokens = new_tokens
        prefix_offset = max(
            len(output_tokens) - _INITIAL_INCREMENTAL_DETOKENIZATION_OFFSET,
            0)
        if (skip_special_tokens
                and new_token_id in tokenizer.all_special_ids):
            # The new token was skipped: the window already ends at the
            # last prompt token.
            read_offset = len(output_tokens)
        else:
            read_offset = max(len(output_tokens) - 1, 0)
    else:
        new_tokens = tokenizer.convert_ids_to_tokens(
            [new_token_id], skip_special_tokens=skip_special_tokens)
        if new_tokens and new_tokens[0] is None:
            # Out-of-vocab id (can happen with some GGUF conversions).
            new_tokens = [""]
        output_tokens = prev_tokens + new_tokens

    # Fast tokenizers handle added vocab natively; only slow tokenizers
    # with added tokens need the segmented path.
    if tokenizer.is_fast or not tokenizer.get_added_vocab():
        prefix_text = tokenizer.convert_tokens_to_string(
            output_tokens[prefix_offset:read_offset])
        new_text = tokenizer.convert_tokens_to_string(
            output_tokens[prefix_offset:])
    else:
        prefix_text = _convert_tokens_to_string_with_added_encoders(
            tokenizer,
            output_tokens[prefix_offset:read_offset],
            skip_special_tokens=skip_special_tokens,
            spaces_between_special_tokens=spaces_between_special_tokens)
        new_text = _convert_tokens_to_string_with_added_encoders(
            tokenizer,
            output_tokens[prefix_offset:],
            skip_special_tokens=skip_special_tokens,
            spaces_between_special_tokens=spaces_between_special_tokens)

    if len(new_text) > len(prefix_text) and not new_text.endswith("�"):
        # Complete new text chunk; slide the window forward.
        new_text = new_text[len(prefix_text):]
        return new_tokens, new_text, read_offset, len(output_tokens)
    # Incomplete multi-byte sequence: emit nothing yet.
    return new_tokens, "", prefix_offset, read_offset
