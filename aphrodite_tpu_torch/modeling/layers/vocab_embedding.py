"""Vocab embedding and LM head (port of
`aphrodite_tpu/modeling/layers/vocab_embedding.py`, one GPU). The table
is [padded_vocab, hidden]; logits = hidden @ W.T with the padding
columns sliced off."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

DEFAULT_VOCAB_PADDING_SIZE = 64


def pad_vocab_size(vocab_size: int,
                   pad_to: int = DEFAULT_VOCAB_PADDING_SIZE) -> int:
    return ((vocab_size + pad_to - 1) // pad_to) * pad_to


class VocabParallelEmbedding:
    """Embedding table [padded_vocab, hidden]."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 dtype: torch.dtype = torch.bfloat16,
                 org_num_embeddings: Optional[int] = None,
                 padding_size: int = DEFAULT_VOCAB_PADDING_SIZE) -> None:
        self.org_vocab_size = org_num_embeddings or num_embeddings
        self.num_embeddings = num_embeddings
        self.num_embeddings_padded = pad_vocab_size(num_embeddings,
                                                    padding_size)
        self.embedding_dim = embedding_dim
        self.dtype = dtype

    def init(self, device: torch.device) -> Dict[str, torch.Tensor]:
        return {"weight": torch.empty(
            (self.num_embeddings_padded, self.embedding_dim),
            dtype=self.dtype, device=device)}

    def __call__(self, params: Dict[str, torch.Tensor],
                 input_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(input_ids.long(), params["weight"])

    def weight_loader(self, params: Dict[str, torch.Tensor], name: str,
                      hf_tensor: torch.Tensor, shard_id=None) -> None:
        """Zero-pad rows beyond the checkpoint vocab."""
        padded = torch.zeros((self.num_embeddings_padded,
                              self.embedding_dim), dtype=hf_tensor.dtype)
        padded[:hf_tensor.shape[0]] = hf_tensor
        params[name] = padded


class ParallelLMHead(VocabParallelEmbedding):
    """LM head: logits = hidden @ W.T over the true vocab."""

    def compute_logits(self, params: Dict[str, torch.Tensor],
                       hidden: torch.Tensor) -> torch.Tensor:
        logits = hidden @ params["weight"].t()
        return logits[..., :self.org_vocab_size]
