"""GPT-NeoX in PyTorch (port of `aphrodite_tpu/modeling/models/gpt_neox.py`;
Pythia and GPT-NeoX-20B).

Partial neox-style rotary (`rotary_pct` of each head), LayerNorms with
biases, both residual forms (`use_parallel_residual`) and an untied
`embed_out` head. HF stores `query_key_value` interleaved per head
([h0_q h0_k h0_v h1_q ...]); the loader de-interleaves it into the
merged [Q | K | V] layout. The rotary and causal-mask buffers are
skipped.
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
from aphrodite_tpu_torch.modeling.models.llama import load_linear

KVCache = Tuple[torch.Tensor, torch.Tensor]
Params = Dict[str, Dict[str, torch.Tensor]]


def deinterleave_qkv(tensor: torch.Tensor, num_heads: int) -> torch.Tensor:
    """HF's per-head interleaved [heads * 3 * d, ...] -> [Q | K | V]."""
    rest = tuple(tensor.shape[1:])
    t = tensor.reshape((num_heads, 3, -1) + rest)
    return torch.cat([t[:, 0], t[:, 1], t[:, 2]], dim=0).reshape(
        (-1,) + rest)


class GPTNeoXAttention:

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
            self.head_dim, int(self.head_dim * config.rotary_pct),
            max_position=config.max_position_embeddings,
            base=getattr(config, "rotary_emb_base", 10000.0),
            is_neox_style=True)
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


class GPTNeoXLayer:

    def __init__(self, config, idx: int, dtype, linear_method) -> None:
        self.prefix = f"gpt_neox.layers.{idx}"
        self.config = config
        self.attention = GPTNeoXAttention(
            config, f"{self.prefix}.attention", dtype, linear_method)
        hidden = config.hidden_size
        self.dense_h_to_4h = ColumnParallelLinear(
            hidden, config.intermediate_size, bias=True, dtype=dtype,
            linear_method=linear_method)
        self.dense_4h_to_h = RowParallelLinear(
            config.intermediate_size, hidden, bias=True, dtype=dtype,
            linear_method=linear_method)
        self.act = get_act_fn(config.hidden_act)
        self.dtype = dtype
        self.hidden = hidden
        self.eps = config.layer_norm_eps

    def linears(self) -> Dict[str, object]:
        return {**self.attention.linears(),
                f"{self.prefix}.mlp.dense_h_to_4h": self.dense_h_to_4h,
                f"{self.prefix}.mlp.dense_4h_to_h": self.dense_4h_to_h}

    def init(self, device) -> Params:
        params = {key: layer.init(device)
                  for key, layer in self.linears().items()}
        for name in ("input_layernorm", "post_attention_layernorm"):
            params[f"{self.prefix}.{name}"] = layer_norm_params(
                self.hidden, self.dtype, device)
        return params

    def _mlp(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = self.dense_h_to_4h(params[f"{self.prefix}.mlp.dense_h_to_4h"], x)
        return self.dense_4h_to_h(params[f"{self.prefix}.mlp.dense_4h_to_h"],
                                  self.act(x))

    def __call__(self, params: Params, positions, hidden, kv_cache,
                 metadata):
        ln1 = params[f"{self.prefix}.input_layernorm"]
        ln2 = params[f"{self.prefix}.post_attention_layernorm"]
        attn_in = layer_norm(hidden, ln1["weight"], ln1["bias"], self.eps)
        attn_out, new_cache = self.attention(params, positions, attn_in,
                                             kv_cache, metadata)
        if self.config.use_parallel_residual:
            # x + attn(ln1(x)) + mlp(ln2(x))
            mlp_in = layer_norm(hidden, ln2["weight"], ln2["bias"], self.eps)
            return hidden + attn_out + self._mlp(params, mlp_in), new_cache
        attn_out = attn_out + hidden
        mlp_in = layer_norm(attn_out, ln2["weight"], ln2["bias"], self.eps)
        return attn_out + self._mlp(params, mlp_in), new_cache


class GPTNeoXForCausalLM:

    def __init__(self, config, dtype: torch.dtype = torch.bfloat16,
                 linear_method: Optional[LinearMethod] = None) -> None:
        self.config = config
        self.dtype = dtype
        self.linear_method = linear_method
        self.embed_in = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, dtype=dtype)
        self.layers = [GPTNeoXLayer(config, i, dtype, linear_method)
                       for i in range(config.num_hidden_layers)]
        self.embed_out = ParallelLMHead(config.vocab_size,
                                        config.hidden_size, dtype=dtype)
        self.tie_word_embeddings = False

    def init_params(self, device) -> Params:
        params: Params = {"gpt_neox.embed_in": self.embed_in.init(device)}
        for layer in self.layers:
            params.update(layer.init(device))
        params["gpt_neox.final_layer_norm"] = layer_norm_params(
            self.config.hidden_size, self.dtype, device)
        params["embed_out"] = self.embed_out.init(device)
        return params

    def __call__(self, params: Params, input_ids: torch.Tensor,
                 positions: torch.Tensor, kv_caches: Optional[List[KVCache]],
                 metadata: InputMetadata):
        hidden = self.embed_in(params["gpt_neox.embed_in"], input_ids)
        new_caches: List[KVCache] = []
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            hidden, new_cache = layer(params, positions, hidden, cache,
                                      metadata)
            if new_cache is not None:
                new_caches.append(new_cache)
        ln = params["gpt_neox.final_layer_norm"]
        hidden = layer_norm(hidden, ln["weight"], ln["bias"],
                            self.config.layer_norm_eps)
        return hidden, (new_caches if kv_caches is not None else None)

    def compute_logits(self, params: Params,
                       hidden: torch.Tensor) -> torch.Tensor:
        return self.embed_out.compute_logits(params["embed_out"], hidden)

    def load_weights(self, weights: Iterable[Tuple[str, torch.Tensor]]
                     ) -> Params:
        loaders = {}
        for layer in self.layers:
            loaders.update(layer.linears())
        params: Params = {}

        def bucket(key: str) -> Dict[str, torch.Tensor]:
            return params.setdefault(key, {})

        for name, tensor in weights:
            if "rotary_emb" in name or "attention.bias" in name or \
                    "attention.masked_bias" in name:
                continue
            if name == "gpt_neox.embed_in.weight":
                self.embed_in.weight_loader(bucket("gpt_neox.embed_in"),
                                            "weight", tensor)
            elif name == "embed_out.weight":
                self.embed_out.weight_loader(bucket("embed_out"), "weight",
                                             tensor)
            elif "layernorm" in name or "final_layer_norm" in name:
                key, pname = name.rsplit(".", 1)
                bucket(key)[pname] = tensor
            elif "query_key_value" in name:
                key, pname = name.replace("query_key_value",
                                          "qkv_proj").rsplit(".", 1)
                loaders[key].weight_loader(
                    bucket(key), pname, deinterleave_qkv(
                        tensor, self.config.num_attention_heads))
            else:
                load_linear(loaders, bucket, name, tensor, ())
        return params
