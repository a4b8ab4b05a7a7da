"""Llama-family causal LM (Llama, Llama-2, Mistral, Yi) in PyTorch.

Port of `aphrodite_tpu/modeling/models/llama.py`: the model is a set of
plain functions over a flat parameter dict (dotted HF-style bucket keys
-> {name: tensor}, the JAX package's tree with torch's [out, in] linear
layout), with the fused `qkv_proj` / `gate_up_proj` projections.
`__call__` returns the final hidden states and the (in place updated)
KV caches; `compute_logits` applies the LM head to selected rows. The
MoE models (`mixtral.py`, `deepseek.py`) subclass `LlamaForCausalLM`
with their own FFN per layer (`_make_mlp`) and checkpoint tensors
(`_load_other`).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from aphrodite_tpu_torch.modeling.input_metadata import InputMetadata
from aphrodite_tpu_torch.modeling.layers.activation import silu_and_mul
from aphrodite_tpu_torch.modeling.layers.attention import PagedAttention
from aphrodite_tpu_torch.modeling.layers.layernorm import (
    fused_add_rms_norm, rms_norm)
from aphrodite_tpu_torch.modeling.layers.linear import (
    LinearMethod, MergedColumnParallelLinear, QKVParallelLinear,
    RowParallelLinear)
from aphrodite_tpu_torch.modeling.layers.rotary_embedding import get_rope
from aphrodite_tpu_torch.modeling.layers.vocab_embedding import (
    ParallelLMHead, VocabParallelEmbedding)

KVCache = Tuple[torch.Tensor, torch.Tensor]
Params = Dict[str, Dict[str, torch.Tensor]]


# The q / k / v checkpoint tensors of a merged qkv_proj: (HF name
# fragment, merged layer, shard id).
QKV_STACKED = [("q_proj", "qkv_proj", "q"), ("k_proj", "qkv_proj", "k"),
               ("v_proj", "qkv_proj", "v")]


def load_linear(loaders: Dict[str, object], bucket, name: str,
                tensor: torch.Tensor, stacked) -> None:
    """One checkpoint tensor of a linear layer, as the JAX models load
    it: a stacked projection's (`stacked`: (HF name fragment, merged
    layer, shard id)) into its shard of the merged layer, any other
    into the layer its bucket names (quantized checkpoints' qweight,
    qzeros, scales and g_idx included); a name of no known layer is
    skipped."""
    for hf_frag, merged, shard_id in stacked:
        if f".{hf_frag}." in name:
            key, pname = name.replace(hf_frag, merged).rsplit(".", 1)
            loaders[key].weight_loader(bucket(key), pname, tensor, shard_id)
            return
    key, pname = name.rsplit(".", 1)
    if key in loaders:
        loaders[key].weight_loader(bucket(key), pname, tensor)


class LlamaAttention:

    def __init__(self, config, layer_prefix: str, dtype,
                 linear_method: Optional[LinearMethod]) -> None:
        hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = getattr(config, "num_key_value_heads",
                                    self.num_heads)
        self.head_dim = getattr(config, "head_dim", None) or \
            hidden_size // self.num_heads
        self.prefix = layer_prefix
        attention_bias = getattr(config, "attention_bias", False)
        self.qkv_proj = QKVParallelLinear(
            hidden_size, self.head_dim, self.num_heads, self.num_kv_heads,
            bias=attention_bias or getattr(config, "qkv_bias", False),
            dtype=dtype, linear_method=linear_method)
        self.o_proj = RowParallelLinear(
            self.num_heads * self.head_dim, hidden_size,
            bias=attention_bias, dtype=dtype, linear_method=linear_method)
        self.rotary = get_rope(
            self.head_dim, self.head_dim,
            max_position=getattr(config, "max_position_embeddings", 8192),
            base=getattr(config, "rope_theta", 10000.0),
            is_neox_style=True,
            rope_scaling=getattr(config, "rope_scaling", None))
        self.attn = PagedAttention(
            self.num_heads, self.head_dim, scale=self.head_dim ** -0.5,
            num_kv_heads=self.num_kv_heads,
            sliding_window=getattr(config, "sliding_window", None))

    def linears(self) -> Dict[str, object]:
        """Bucket key -> linear layer (the checkpoint loader's map)."""
        return {f"{self.prefix}.self_attn.qkv_proj": self.qkv_proj,
                f"{self.prefix}.self_attn.o_proj": self.o_proj}

    def init(self, device) -> Params:
        return {key: layer.init(device)
                for key, layer in self.linears().items()}

    def __call__(self, params: Params, positions: torch.Tensor,
                 hidden: torch.Tensor, kv_cache: Optional[KVCache],
                 metadata: InputMetadata
                 ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        qkv = self.qkv_proj(params[f"{self.prefix}.self_attn.qkv_proj"],
                            hidden)
        q, k, v = self.qkv_proj.split(qkv)
        b, s = q.shape[:2]
        q = q.reshape(b, s, self.num_heads, self.head_dim)
        k = k.reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k = self.rotary(positions, q, k)
        q = q.reshape(b, s, self.num_heads * self.head_dim)
        k = k.reshape(b, s, self.num_kv_heads * self.head_dim)
        k_pages, v_pages = kv_cache if kv_cache is not None else (None, None)
        out, k_pages, v_pages = self.attn(q, k, v, k_pages, v_pages,
                                          metadata)
        out = self.o_proj(params[f"{self.prefix}.self_attn.o_proj"], out)
        new_cache = None if k_pages is None else (k_pages, v_pages)
        return out, new_cache


class LlamaMLP:

    def __init__(self, config, layer_prefix: str, dtype,
                 linear_method: Optional[LinearMethod]) -> None:
        self.prefix = layer_prefix
        self.gate_up_proj = MergedColumnParallelLinear(
            config.hidden_size, [config.intermediate_size] * 2,
            dtype=dtype, linear_method=linear_method)
        self.down_proj = RowParallelLinear(
            config.intermediate_size, config.hidden_size, dtype=dtype,
            linear_method=linear_method)

    def linears(self) -> Dict[str, object]:
        return {f"{self.prefix}.mlp.gate_up_proj": self.gate_up_proj,
                f"{self.prefix}.mlp.down_proj": self.down_proj}

    def init(self, device) -> Params:
        return {key: layer.init(device)
                for key, layer in self.linears().items()}

    def __call__(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        gate_up = self.gate_up_proj(
            params[f"{self.prefix}.mlp.gate_up_proj"], hidden)
        return self.down_proj(params[f"{self.prefix}.mlp.down_proj"],
                              silu_and_mul(gate_up))


class LlamaDecoderLayer:
    """Attention, then the layer's FFN (`mlp`: a `LlamaMLP`, or an MoE
    block of `mixtral.py` / `deepseek.py` with the same `init`,
    `linears` and call)."""

    def __init__(self, config, layer_idx: int, dtype,
                 linear_method: Optional[LinearMethod], mlp) -> None:
        self.prefix = f"model.layers.{layer_idx}"
        self.rms_eps = config.rms_norm_eps
        self.self_attn = LlamaAttention(config, self.prefix, dtype,
                                        linear_method)
        self.mlp = mlp
        self.dtype = dtype
        self.hidden_size = config.hidden_size

    def init(self, device) -> Params:
        params = {}
        params.update(self.self_attn.init(device))
        params.update(self.mlp.init(device))
        for name in ("input_layernorm", "post_attention_layernorm"):
            params[f"{self.prefix}.{name}"] = {"weight": torch.empty(
                (self.hidden_size,), dtype=self.dtype, device=device)}
        return params

    def __call__(self, params: Params, positions, hidden, residual,
                 kv_cache, metadata):
        normed, residual = fused_add_rms_norm(
            hidden, residual,
            params[f"{self.prefix}.input_layernorm"]["weight"],
            self.rms_eps)
        attn_out, new_cache = self.self_attn(params, positions, normed,
                                             kv_cache, metadata)
        normed, residual = fused_add_rms_norm(
            attn_out, residual,
            params[f"{self.prefix}.post_attention_layernorm"]["weight"],
            self.rms_eps)
        return self.mlp(params, normed), residual, new_cache


class LlamaForCausalLM:
    """Functional Llama over a parameter dict."""

    def __init__(self, config, dtype: torch.dtype = torch.bfloat16,
                 linear_method: Optional[LinearMethod] = None) -> None:
        self.config = config
        self.dtype = dtype
        self.linear_method = linear_method
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, dtype=dtype)
        self.layers = [
            LlamaDecoderLayer(config, i, dtype, linear_method,
                              self._make_mlp(config, i, dtype, linear_method))
            for i in range(config.num_hidden_layers)
        ]
        self.lm_head = ParallelLMHead(config.vocab_size,
                                      config.hidden_size, dtype=dtype)
        self.rms_eps = config.rms_norm_eps
        self.tie_word_embeddings = getattr(config, "tie_word_embeddings",
                                           False)

    def _make_mlp(self, config, layer_idx: int, dtype,
                  linear_method: Optional[LinearMethod]):
        """Layer `layer_idx`'s FFN (the MoE models override this)."""
        return LlamaMLP(config, f"model.layers.{layer_idx}", dtype,
                        linear_method)

    # ---- params ----
    def init_params(self, device) -> Params:
        """Allocate every parameter (uninitialized) on `device`."""
        params: Params = {"model.embed_tokens":
                          self.embed_tokens.init(device)}
        for layer in self.layers:
            params.update(layer.init(device))
        params["model.norm"] = {"weight": torch.empty(
            (self.config.hidden_size,), dtype=self.dtype, device=device)}
        if not self.tie_word_embeddings:
            params["lm_head"] = self.lm_head.init(device)
        return params

    # ---- forward ----
    def __call__(
        self,
        params: Params,
        input_ids: torch.Tensor,       # [batch, seq]
        positions: torch.Tensor,       # [batch, seq]
        kv_caches: Optional[List[KVCache]],
        metadata: InputMetadata,
    ) -> Tuple[torch.Tensor, Optional[List[KVCache]]]:
        hidden = self.embed_tokens(params["model.embed_tokens"], input_ids)
        residual = None
        new_caches: List[KVCache] = []
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            hidden, residual, new_cache = layer(params, positions, hidden,
                                                residual, cache, metadata)
            if new_cache is not None:
                new_caches.append(new_cache)
        hidden = rms_norm(hidden + residual,
                          params["model.norm"]["weight"], self.rms_eps)
        return hidden, (new_caches if kv_caches is not None else None)

    def compute_logits(self, params: Params,
                       hidden: torch.Tensor) -> torch.Tensor:
        head = params["model.embed_tokens"] if self.tie_word_embeddings \
            else params["lm_head"]
        return self.lm_head.compute_logits(head, hidden)

    # ---- checkpoint loading ----
    # (HF name fragment, merged param, shard id), as in the JAX model.
    _STACKED = QKV_STACKED + [
        ("gate_proj", "gate_up_proj", 0),
        ("up_proj", "gate_up_proj", 1),
    ]

    def load_weights(self, weights: Iterable[Tuple[str, torch.Tensor]]
                     ) -> Params:
        """Consume HF (name, tensor) pairs; return the parameter dict
        (host tensors, HF [out, in] layout kept)."""
        loaders = {}
        for layer in self.layers:
            loaders.update(layer.self_attn.linears())
            loaders.update(layer.mlp.linears())
        params: Params = {}

        def bucket(key: str) -> Dict[str, torch.Tensor]:
            return params.setdefault(key, {})

        for name, tensor in weights:
            if "rotary_emb.inv_freq" in name:
                continue
            if name.startswith("lm_head"):
                if not self.tie_word_embeddings:
                    self.lm_head.weight_loader(bucket("lm_head"), "weight",
                                               tensor)
                continue
            if name == "model.embed_tokens.weight":
                self.embed_tokens.weight_loader(
                    bucket("model.embed_tokens"), "weight", tensor)
                continue
            if name == "model.norm.weight" or \
                    name.endswith("_layernorm.weight"):
                key, pname = name.rsplit(".", 1)
                bucket(key)[pname] = tensor
                continue
            name = self._load_other(bucket, name, tensor)
            if name is not None:
                load_linear(loaders, bucket, name, tensor, self._STACKED)
        return params

    def _load_other(self, bucket, name: str, tensor: torch.Tensor
                    ) -> Optional[str]:
        """A model's own checkpoint tensors (the MoE models' experts and
        routers): None once consumed, else the name the linear layers'
        loaders take (renamed where the model maps it)."""
        return name
