"""The batch descriptor handed to the model (port of
`aphrodite_tpu/modeling/input_metadata.py`): the same fields, as a plain
dataclass of torch tensors. PyTorch runs eagerly, so there are no
static/traced field kinds; `replace` returns a copy with fields changed,
as the flax dataclass did."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class InputMetadata:
    # [num_tokens] flat slot index per new token; pads hold an
    # out-of-range slot (>= num_pages * page_size).
    slot_mapping: torch.Tensor
    # [batch, pages_per_seq] int32 page ids; pads hold an out-of-range id.
    block_tables: torch.Tensor
    # [batch] tokens in cache AFTER this step's writes (decode) or before
    # this chunk (prefill prefix length).
    context_lens: torch.Tensor
    # [batch] valid new tokens per sequence (prompt steps).
    prompt_lens: Optional[torch.Tensor] = None
    # Prefill page-writer cells (page_ids, src_blocks, valids), one per
    # (sequence, page), when the prompt layout is page-aligned; src_blocks
    # stays on the host (it only validates the layout).
    prefill_cells: Optional[tuple] = None
    # Ragged decode work list (wi_seq [NW+1], wi_chunk [NW]) as host numpy
    # arrays (see ops/cuda/paged_attention.build_decode_work_list).
    decode_work: Optional[tuple] = None
    is_prompt: bool = False
    # Speculative verify batch: k+1 rows a sequence share its pages, so
    # the attention layer writes them with the slot scatter and attends
    # read-only.
    spec_verify: bool = False
    # Tensor-parallel degree; always 1 in the port.
    tp: int = 1
    # Prefill against a cached prefix (prefix caching / chunked prefill).
    use_prefix: bool = False
    # int8 KV quantization scale S (the CacheEngine's); unused by other
    # page dtypes.
    kv_scale: float = 1.0
    # pages_per_chunk the decode work list was built with (0 = none).
    decode_ppc: int = 0
    # Sequence-parallel prefill routing; always None in the port.
    sp: object = None

    def replace(self, **changes) -> "InputMetadata":
        return dataclasses.replace(self, **changes)
