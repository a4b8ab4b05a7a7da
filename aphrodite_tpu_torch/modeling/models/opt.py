"""OPT in PyTorch (port of `aphrodite_tpu/modeling/models/opt.py`).

Learned positions with OPT's +2 offset, LayerNorm before or after each
block by `do_layer_norm_before`, the config's activation (ReLU), and
the LM head tied to `embed_tokens` over `word_embed_proj_dim`. As in
the JAX model there is no `project_in` / `project_out`, so a config
whose `word_embed_proj_dim` differs from `hidden_size` (opt-350m) is
refused at config time (`common/config.py`). Checkpoints name their
tensors under "model.decoder." or bare "decoder.".
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from aphrodite_tpu_torch.modeling.input_metadata import InputMetadata
from aphrodite_tpu_torch.modeling.layers.activation import get_act_fn
from aphrodite_tpu_torch.modeling.layers.attention import PagedAttention
from aphrodite_tpu_torch.modeling.layers.layernorm import (
    layer_norm, layer_norm_params)
from aphrodite_tpu_torch.modeling.layers.linear import (
    ColumnParallelLinear, LinearMethod, QKVParallelLinear, RowParallelLinear)
from aphrodite_tpu_torch.modeling.layers.vocab_embedding import (
    ParallelLMHead, VocabParallelEmbedding)
from aphrodite_tpu_torch.modeling.models.llama import (QKV_STACKED,
                                                       load_linear)

KVCache = Tuple[torch.Tensor, torch.Tensor]
Params = Dict[str, Dict[str, torch.Tensor]]

#: HF's offset of OPT's learned position table.
POSITION_OFFSET = 2


class OPTAttention:

    def __init__(self, config, prefix: str, dtype,
                 linear_method: Optional[LinearMethod]) -> None:
        self.prefix = prefix
        hidden = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = hidden // self.num_heads
        self.qkv_proj = QKVParallelLinear(
            hidden, self.head_dim, self.num_heads, bias=config.enable_bias,
            dtype=dtype, linear_method=linear_method)
        self.out_proj = RowParallelLinear(
            hidden, hidden, bias=config.enable_bias, dtype=dtype,
            linear_method=linear_method)
        self.attn = PagedAttention(self.num_heads, self.head_dim,
                                   scale=self.head_dim ** -0.5)

    def linears(self) -> Dict[str, object]:
        return {f"{self.prefix}.qkv_proj": self.qkv_proj,
                f"{self.prefix}.out_proj": self.out_proj}

    def __call__(self, params: Params, hidden: torch.Tensor,
                 kv_cache: Optional[KVCache], metadata: InputMetadata):
        qkv = self.qkv_proj(params[f"{self.prefix}.qkv_proj"], hidden)
        q, k, v = self.qkv_proj.split(qkv)
        k_pages, v_pages = kv_cache if kv_cache is not None else (None, None)
        out, k_pages, v_pages = self.attn(q, k, v, k_pages, v_pages,
                                          metadata)
        out = self.out_proj(params[f"{self.prefix}.out_proj"], out)
        return out, (None if k_pages is None else (k_pages, v_pages))


class OPTDecoderLayer:

    def __init__(self, config, idx: int, dtype, linear_method) -> None:
        self.prefix = f"model.decoder.layers.{idx}"
        self.config = config
        self.self_attn = OPTAttention(config, f"{self.prefix}.self_attn",
                                      dtype, linear_method)
        hidden = config.hidden_size
        self.fc1 = ColumnParallelLinear(hidden, config.ffn_dim,
                                        bias=config.enable_bias, dtype=dtype,
                                        linear_method=linear_method)
        self.fc2 = RowParallelLinear(config.ffn_dim, hidden,
                                     bias=config.enable_bias, dtype=dtype,
                                     linear_method=linear_method)
        self.act = get_act_fn(config.activation_function)
        self.dtype = dtype
        self.hidden = hidden

    def linears(self) -> Dict[str, object]:
        return {**self.self_attn.linears(), f"{self.prefix}.fc1": self.fc1,
                f"{self.prefix}.fc2": self.fc2}

    def init(self, device) -> Params:
        params = {key: layer.init(device)
                  for key, layer in self.linears().items()}
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            params[f"{self.prefix}.{name}"] = layer_norm_params(
                self.hidden, self.dtype, device)
        return params

    def __call__(self, params: Params, hidden, kv_cache, metadata):
        before = self.config.do_layer_norm_before
        residual = hidden
        ln1 = params[f"{self.prefix}.self_attn_layer_norm"]
        if before:
            hidden = layer_norm(hidden, ln1["weight"], ln1["bias"])
        attn_out, new_cache = self.self_attn(params, hidden, kv_cache,
                                             metadata)
        hidden = residual + attn_out
        if not before:
            hidden = layer_norm(hidden, ln1["weight"], ln1["bias"])
        residual = hidden
        ln2 = params[f"{self.prefix}.final_layer_norm"]
        if before:
            hidden = layer_norm(hidden, ln2["weight"], ln2["bias"])
        hidden = self.fc2(params[f"{self.prefix}.fc2"], self.act(
            self.fc1(params[f"{self.prefix}.fc1"], hidden)))
        hidden = residual + hidden
        if not before:
            hidden = layer_norm(hidden, ln2["weight"], ln2["bias"])
        return hidden, new_cache


class OPTForCausalLM:
    """OPT over a parameter dict, the LM head tied to embed_tokens."""

    def __init__(self, config, dtype: torch.dtype = torch.bfloat16,
                 linear_method: Optional[LinearMethod] = None) -> None:
        self.config = config
        self.dtype = dtype
        self.linear_method = linear_method
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.word_embed_proj_dim, dtype=dtype)
        self.layers = [OPTDecoderLayer(config, i, dtype, linear_method)
                       for i in range(config.num_hidden_layers)]
        self.lm_head = ParallelLMHead(config.vocab_size,
                                      config.word_embed_proj_dim,
                                      dtype=dtype)
        self.tie_word_embeddings = True
        self.final_layer_norm = config.do_layer_norm_before and not getattr(
            config, "_remove_final_layer_norm", False)

    def init_params(self, device) -> Params:
        cfg = self.config
        params: Params = {
            "model.decoder.embed_tokens": self.embed_tokens.init(device),
            "model.decoder.embed_positions": {"weight": torch.empty(
                (cfg.max_position_embeddings + POSITION_OFFSET,
                 cfg.hidden_size), dtype=self.dtype, device=device)}}
        for layer in self.layers:
            params.update(layer.init(device))
        if self.final_layer_norm:
            params["model.decoder.final_layer_norm"] = layer_norm_params(
                cfg.hidden_size, self.dtype, device)
        return params

    def __call__(self, params: Params, input_ids: torch.Tensor,
                 positions: torch.Tensor, kv_caches: Optional[List[KVCache]],
                 metadata: InputMetadata):
        hidden = self.embed_tokens(params["model.decoder.embed_tokens"],
                                   input_ids)
        hidden = hidden + F.embedding(
            positions.long() + POSITION_OFFSET,
            params["model.decoder.embed_positions"]["weight"])
        new_caches: List[KVCache] = []
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            hidden, new_cache = layer(params, hidden, cache, metadata)
            if new_cache is not None:
                new_caches.append(new_cache)
        final_ln = params.get("model.decoder.final_layer_norm")
        if final_ln is not None:
            hidden = layer_norm(hidden, final_ln["weight"], final_ln["bias"])
        return hidden, (new_caches if kv_caches is not None else None)

    def compute_logits(self, params: Params,
                       hidden: torch.Tensor) -> torch.Tensor:
        return self.lm_head.compute_logits(
            params["model.decoder.embed_tokens"], hidden)

    def load_weights(self, weights: Iterable[Tuple[str, torch.Tensor]]
                     ) -> Params:
        loaders = {}
        for layer in self.layers:
            loaders.update(layer.linears())
        params: Params = {}

        def bucket(key: str) -> Dict[str, torch.Tensor]:
            return params.setdefault(key, {})

        for name, tensor in weights:
            if name.startswith("lm_head"):
                continue                      # tied
            if name.startswith("decoder."):
                name = "model." + name
            if "embed_tokens" in name:
                self.embed_tokens.weight_loader(
                    bucket("model.decoder.embed_tokens"), "weight", tensor)
            elif "embed_positions" in name:
                bucket("model.decoder.embed_positions")["weight"] = tensor
            elif "layer_norm" in name:
                key, pname = name.rsplit(".", 1)
                bucket(key)[pname] = tensor
            else:
                load_linear(loaders, bucket, name, tensor, QKV_STACKED)
        return params
