"""GPT-J in PyTorch (port of `aphrodite_tpu/modeling/models/gpt_j.py`).

Interleaved (GPT-J style) rotary over the first `rotary_dim` dims of
each head, attention and MLP in parallel from one pre-LayerNorm, and a
biased LM head. The checkpoint's causal-mask buffers (`attn.bias`,
`attn.masked_bias`) are skipped, as the JAX model skips them.
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


class GPTJAttention:

    def __init__(self, config, prefix: str, dtype,
                 linear_method: Optional[LinearMethod]) -> None:
        self.prefix = prefix
        hidden = config.n_embd
        self.num_heads = config.n_head
        self.head_dim = hidden // self.num_heads
        self.qkv_proj = QKVParallelLinear(
            hidden, self.head_dim, self.num_heads, bias=False, dtype=dtype,
            linear_method=linear_method)
        self.out_proj = RowParallelLinear(hidden, hidden, bias=False,
                                          dtype=dtype,
                                          linear_method=linear_method)
        self.rotary = get_rope(self.head_dim, config.rotary_dim,
                               max_position=config.n_positions,
                               base=10000.0, is_neox_style=False)
        self.attn = PagedAttention(self.num_heads, self.head_dim,
                                   scale=self.head_dim ** -0.5)

    def linears(self) -> Dict[str, object]:
        return {f"{self.prefix}.qkv_proj": self.qkv_proj,
                f"{self.prefix}.out_proj": self.out_proj}

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
        out = self.out_proj(params[f"{self.prefix}.out_proj"], out)
        return out, (None if k_pages is None else (k_pages, v_pages))


class GPTJBlock:

    def __init__(self, config, idx: int, dtype, linear_method) -> None:
        self.prefix = f"transformer.h.{idx}"
        self.attn = GPTJAttention(config, f"{self.prefix}.attn", dtype,
                                  linear_method)
        hidden = config.n_embd
        inner = getattr(config, "n_inner", None) or 4 * hidden
        self.fc_in = ColumnParallelLinear(hidden, inner, bias=True,
                                          dtype=dtype,
                                          linear_method=linear_method)
        self.fc_out = RowParallelLinear(inner, hidden, bias=True,
                                        dtype=dtype,
                                        linear_method=linear_method)
        self.act = get_act_fn(config.activation_function)
        self.dtype = dtype
        self.hidden = hidden
        self.eps = config.layer_norm_epsilon

    def linears(self) -> Dict[str, object]:
        return {**self.attn.linears(), f"{self.prefix}.mlp.fc_in": self.fc_in,
                f"{self.prefix}.mlp.fc_out": self.fc_out}

    def init(self, device) -> Params:
        params = {key: layer.init(device)
                  for key, layer in self.linears().items()}
        params[f"{self.prefix}.ln_1"] = layer_norm_params(
            self.hidden, self.dtype, device)
        return params

    def __call__(self, params: Params, positions, hidden, kv_cache,
                 metadata):
        ln = params[f"{self.prefix}.ln_1"]
        normed = layer_norm(hidden, ln["weight"], ln["bias"], self.eps)
        attn_out, new_cache = self.attn(params, positions, normed, kv_cache,
                                        metadata)
        mlp_out = self.fc_out(
            params[f"{self.prefix}.mlp.fc_out"],
            self.act(self.fc_in(params[f"{self.prefix}.mlp.fc_in"], normed)))
        return hidden + attn_out + mlp_out, new_cache


class GPTJForCausalLM:

    def __init__(self, config, dtype: torch.dtype = torch.bfloat16,
                 linear_method: Optional[LinearMethod] = None) -> None:
        self.config = config
        self.dtype = dtype
        self.linear_method = linear_method
        self.wte = VocabParallelEmbedding(config.vocab_size, config.n_embd,
                                          dtype=dtype)
        self.layers = [GPTJBlock(config, i, dtype, linear_method)
                       for i in range(config.n_layer)]
        self.lm_head = ParallelLMHead(config.vocab_size, config.n_embd,
                                      bias=True, dtype=dtype)
        self.tie_word_embeddings = False

    def init_params(self, device) -> Params:
        params: Params = {"transformer.wte": self.wte.init(device)}
        for layer in self.layers:
            params.update(layer.init(device))
        params["transformer.ln_f"] = layer_norm_params(
            self.config.n_embd, self.dtype, device)
        params["lm_head"] = self.lm_head.init(device)
        return params

    def __call__(self, params: Params, input_ids: torch.Tensor,
                 positions: torch.Tensor, kv_caches: Optional[List[KVCache]],
                 metadata: InputMetadata):
        hidden = self.wte(params["transformer.wte"], input_ids)
        new_caches: List[KVCache] = []
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            hidden, new_cache = layer(params, positions, hidden, cache,
                                      metadata)
            if new_cache is not None:
                new_caches.append(new_cache)
        ln = params["transformer.ln_f"]
        hidden = layer_norm(hidden, ln["weight"], ln["bias"],
                            self.config.layer_norm_epsilon)
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
            if "attn.bias" in name or "attn.masked_bias" in name:
                continue
            if name == "transformer.wte.weight":
                self.wte.weight_loader(bucket("transformer.wte"), "weight",
                                       tensor)
            elif name in ("lm_head.weight", "lm_head.bias"):
                self.lm_head.weight_loader(bucket("lm_head"),
                                           name.split(".")[1], tensor)
            elif ".ln_1." in name or name.startswith("transformer.ln_f"):
                key, pname = name.rsplit(".", 1)
                bucket(key)[pname] = tensor
            else:
                load_linear(loaders, bucket, name, tensor, QKV_STACKED)
        return params
