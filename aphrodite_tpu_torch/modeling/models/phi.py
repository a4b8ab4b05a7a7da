"""Phi-1.5 / Phi-2 in PyTorch (port of `aphrodite_tpu/modeling/models/phi.py`).

Attention and MLP in parallel from one pre-LayerNorm, partial neox-style
rotary (`partial_rotary_factor` of each head), biased projections and a
biased LM head, `gelu_new`.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from aphrodite_tpu_torch.modeling.input_metadata import InputMetadata
from aphrodite_tpu_torch.modeling.layers.activation import get_act_fn
from aphrodite_tpu_torch.modeling.layers.attention import PagedAttention
from aphrodite_tpu_torch.modeling.layers.layernorm import (
    layer_norm, layer_norm_params)
from aphrodite_tpu_torch.modeling.layers.linear import (
    ColumnParallelLinear, LinearMethod, QKVParallelLinear, RowParallelLinear)
from aphrodite_tpu_torch.modeling.layers.rotary_embedding import get_rope
from aphrodite_tpu_torch.modeling.layers.vocab_embedding import (
    ParallelLMHead, VocabParallelEmbedding)
from aphrodite_tpu_torch.modeling.models.llama import (QKV_STACKED,
                                                       load_linear)

KVCache = Tuple[torch.Tensor, torch.Tensor]
Params = Dict[str, Dict[str, torch.Tensor]]


class PhiAttention:

    def __init__(self, config, prefix: str, dtype,
                 linear_method: Optional[LinearMethod]) -> None:
        self.prefix = prefix
        hidden = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = hidden // self.num_heads
        self.qkv_proj = QKVParallelLinear(
            hidden, self.head_dim, self.num_heads, bias=True, dtype=dtype,
            linear_method=linear_method)
        self.dense = RowParallelLinear(hidden, hidden, bias=True, dtype=dtype,
                                       linear_method=linear_method)
        self.rotary = get_rope(
            self.head_dim,
            int(self.head_dim * getattr(config, "partial_rotary_factor",
                                        0.5)),
            max_position=config.max_position_embeddings,
            base=getattr(config, "rope_theta", 10000.0), is_neox_style=True)
        self.attn = PagedAttention(self.num_heads, self.head_dim,
                                   scale=self.head_dim ** -0.5)

    def linears(self) -> Dict[str, object]:
        return {f"{self.prefix}.qkv_proj": self.qkv_proj,
                f"{self.prefix}.dense": self.dense}

    def __call__(self, params: Params, positions, hidden, kv_cache,
                 metadata: InputMetadata):
        qkv = self.qkv_proj(params[f"{self.prefix}.qkv_proj"], hidden)
        q, k, v = self.qkv_proj.split(qkv)
        b, s = q.shape[:2]
        q, k = self.rotary(positions,
                           q.reshape(b, s, self.num_heads, self.head_dim),
                           k.reshape(b, s, self.num_heads, self.head_dim))
        k_pages, v_pages = kv_cache if kv_cache is not None else (None, None)
        out, k_pages, v_pages = self.attn(
            q.reshape(b, s, -1), k.reshape(b, s, -1), v, k_pages, v_pages,
            metadata)
        out = self.dense(params[f"{self.prefix}.dense"], out)
        return out, (None if k_pages is None else (k_pages, v_pages))


class PhiLayer:

    def __init__(self, config, idx: int, dtype, linear_method) -> None:
        self.prefix = f"model.layers.{idx}"
        self.self_attn = PhiAttention(config, f"{self.prefix}.self_attn",
                                      dtype, linear_method)
        hidden = config.hidden_size
        self.fc1 = ColumnParallelLinear(hidden, config.intermediate_size,
                                        bias=True, dtype=dtype,
                                        linear_method=linear_method)
        self.fc2 = RowParallelLinear(config.intermediate_size, hidden,
                                     bias=True, dtype=dtype,
                                     linear_method=linear_method)
        self.act = get_act_fn(config.hidden_act)
        self.dtype = dtype
        self.hidden = hidden
        self.eps = config.layer_norm_eps

    def linears(self) -> Dict[str, object]:
        return {**self.self_attn.linears(),
                f"{self.prefix}.mlp.fc1": self.fc1,
                f"{self.prefix}.mlp.fc2": self.fc2}

    def init(self, device) -> Params:
        params = {key: layer.init(device)
                  for key, layer in self.linears().items()}
        params[f"{self.prefix}.input_layernorm"] = layer_norm_params(
            self.hidden, self.dtype, device)
        return params

    def __call__(self, params: Params, positions, hidden, kv_cache,
                 metadata):
        ln = params[f"{self.prefix}.input_layernorm"]
        normed = layer_norm(hidden, ln["weight"], ln["bias"], self.eps)
        attn_out, new_cache = self.self_attn(params, positions, normed,
                                             kv_cache, metadata)
        mlp_out = self.fc2(params[f"{self.prefix}.mlp.fc2"], self.act(
            self.fc1(params[f"{self.prefix}.mlp.fc1"], normed)))
        return hidden + attn_out + mlp_out, new_cache


class PhiForCausalLM:

    def __init__(self, config, dtype: torch.dtype = torch.bfloat16,
                 linear_method: Optional[LinearMethod] = None) -> None:
        self.config = config
        self.dtype = dtype
        self.linear_method = linear_method
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, dtype=dtype)
        self.layers = [PhiLayer(config, i, dtype, linear_method)
                       for i in range(config.num_hidden_layers)]
        self.lm_head = ParallelLMHead(config.vocab_size, config.hidden_size,
                                      bias=True, dtype=dtype)
        self.tie_word_embeddings = False

    def init_params(self, device) -> Params:
        params: Params = {"model.embed_tokens":
                          self.embed_tokens.init(device)}
        for layer in self.layers:
            params.update(layer.init(device))
        params["model.final_layernorm"] = layer_norm_params(
            self.config.hidden_size, self.dtype, device)
        params["lm_head"] = self.lm_head.init(device)
        return params

    def __call__(self, params: Params, input_ids: torch.Tensor,
                 positions: torch.Tensor, kv_caches: Optional[List[KVCache]],
                 metadata: InputMetadata):
        hidden = self.embed_tokens(params["model.embed_tokens"], input_ids)
        new_caches: List[KVCache] = []
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            hidden, new_cache = layer(params, positions, hidden, cache,
                                      metadata)
            if new_cache is not None:
                new_caches.append(new_cache)
        ln = params["model.final_layernorm"]
        hidden = layer_norm(hidden, ln["weight"], ln["bias"],
                            self.config.layer_norm_eps)
        return hidden, (new_caches if kv_caches is not None else None)

    def compute_logits(self, params: Params,
                       hidden: torch.Tensor) -> torch.Tensor:
        return self.lm_head.compute_logits(params["lm_head"], hidden)

    def load_weights(self, weights: Iterable[Tuple[str, torch.Tensor]]
                     ) -> Params:
        loaders = {}
        for layer in self.layers:
            loaders.update(layer.linears())
        params: Params = {}

        def bucket(key: str) -> Dict[str, torch.Tensor]:
            return params.setdefault(key, {})

        for name, tensor in weights:
            if "rotary_emb" in name:
                continue
            if name == "model.embed_tokens.weight":
                self.embed_tokens.weight_loader(
                    bucket("model.embed_tokens"), "weight", tensor)
            elif name in ("lm_head.weight", "lm_head.bias"):
                self.lm_head.weight_loader(bucket("lm_head"),
                                           name.split(".")[1], tensor)
            elif "layernorm" in name:
                key, pname = name.rsplit(".", 1)
                bucket(key)[pname] = tensor
            else:
                load_linear(loaders, bucket, name, tensor, QKV_STACKED)
        return params
