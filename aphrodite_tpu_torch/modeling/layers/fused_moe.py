"""Mixture-of-Experts layer of the PyTorch port.

Port of `aphrodite_tpu/modeling/layers/fused_moe.py` at tp=1 (the expert
axis is never sharded, so JAX's `sharded` is always False here). Routing
as in JAX: router logits in float32 (x f32 against the gate f32),
softmax, top-k, then renormalized when asked. Two combines, chosen as
JAX chooses them:

- dense (`num_experts <= 4`): every expert's SwiGLU on every token,
  einsums in x's dtype, combined with the [T, E] routing weights in the
  expert outputs' dtype;
- grouped (otherwise): the (token, slot) pairs sorted by expert with a
  stable sort (a token's k contributions are then summed in JAX's
  order), each expert's contiguous rows multiplied by its own weights
  (gate and up into [T * k, I] buffers, `silu(gate) * up` in float32
  cast back to x's dtype, then down), and the rows scatter-added into a
  float32 [T, H] with their routing weights.

Layout: the stacked expert weights keep torch's linear layout, [E, out,
in]: `w_gate` and `w_up` [E, I, H], `w_down` [E, H, I], and the router
`gate` [E, H] (HF's `gate.weight`). A checkpoint's per-expert [out, in]
tensors stack without a transpose. The JAX package keeps [E, in, out]
and a [H, E] gate; `modeling/convert.py` transposes between the two.

No hand kernel replaces a TPU kernel here: the JAX package computes the
experts with `jnp.einsum` and `jax.lax.ragged_dot`, outside any Pallas
body. The grouped products are `torch.mm` on each expert's rows, which
needs the group sizes on the host: one device-to-host read per grouped
call, counted in `HOST_READS`. A grouped product with device-side
offsets (the reference's moe_align_block_size + fused_moe) is later
work (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from aphrodite_tpu_torch.ops.cuda.build import LaunchCounter

Params = Dict[str, torch.Tensor]

#: Device-to-host reads of the grouped path (one per call: the experts'
#: group sizes). Not a kernel counter, so not in `build.COUNTERS`.
HOST_READS = LaunchCounter("fused_moe_host_reads")

#: Up to this many experts the dense combine runs (JAX's threshold).
DENSE_MAX_EXPERTS = 4


def route(x: torch.Tensor, gate: torch.Tensor, top_k: int,
          renormalize: bool
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, H], router gate [E, H] -> (probs [T, E], top-k weights
    [T, k], top-k expert ids [T, k]), all routing in float32."""
    probs = torch.softmax(F.linear(x.float(), gate.float()), dim=-1)
    top_vals, top_idx = torch.topk(probs, top_k, dim=-1)
    if renormalize:
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    return probs, top_vals, top_idx


class FusedMoE:
    """Stacked-expert SwiGLU MoE with top-k softmax routing."""

    def __init__(self, num_experts: int, top_k: int, hidden_size: int,
                 intermediate_size: int, *, renormalize: bool = True,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        self.num_experts = num_experts
        self.top_k = top_k
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.renormalize = renormalize
        self.dtype = dtype

    def init(self, device: torch.device) -> Params:
        e, h, i = self.num_experts, self.hidden_size, self.intermediate_size

        def empty(*shape):
            return torch.empty(shape, dtype=self.dtype, device=device)
        return {"gate": empty(e, h), "w_gate": empty(e, i, h),
                "w_up": empty(e, i, h), "w_down": empty(e, h, i)}

    def __call__(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        """hidden [..., hidden_size] -> the same shape and dtype."""
        x = hidden.reshape(-1, self.hidden_size)
        probs, top_vals, top_idx = route(x, params["gate"], self.top_k,
                                         self.renormalize)
        if self.num_experts > DENSE_MAX_EXPERTS:
            out = self._grouped_ffn(params, x, top_vals, top_idx)
        else:
            out = self._dense_ffn(params, x, probs, top_vals, top_idx)
        return out.reshape(hidden.shape).to(hidden.dtype)

    def _dense_ffn(self, params, x, probs, top_vals, top_idx):
        combine = torch.zeros_like(probs).scatter_(1, top_idx, top_vals)
        gate = torch.einsum("th,eih->eti", x, params["w_gate"])
        up = torch.einsum("th,eih->eti", x, params["w_up"])
        act = F.silu(gate) * up
        expert_out = torch.einsum("eti,ehi->eth", act, params["w_down"])
        return torch.einsum("eth,te->th", expert_out,
                            combine.to(expert_out.dtype))

    def _grouped_ffn(self, params, x, top_vals, top_idx):
        """Each expert's rows of the expert-sorted pairs through its own
        weights (the host reads the group sizes once), scatter-added in
        float32. The per-expert views come from one `split` / `unbind`
        each, so the host's loop is one `torch.mm` per product."""
        pairs = top_idx.numel()
        order = torch.argsort(top_idx.reshape(-1), stable=True)
        tok_sorted = order // self.top_k
        x_sorted = x.index_select(0, tok_sorted)
        sizes = torch.bincount(top_idx.reshape(-1),
                               minlength=self.num_experts).tolist()
        HOST_READS.add()
        live = [e for e, n in enumerate(sizes) if n]
        gate = x.new_empty((pairs, self.intermediate_size))
        up = torch.empty_like(gate)
        # [in, out] views of the [E, out, in] stacks: cuBLAS reads them
        # transposed, nothing is copied.
        w_gate, w_up, w_down = (params[n].transpose(1, 2).unbind(0)
                                for n in ("w_gate", "w_up", "w_down"))
        xs, gs, us = (t.split(sizes) for t in (x_sorted, gate, up))
        for e in live:
            torch.mm(xs[e], w_gate[e], out=gs[e])
            torch.mm(xs[e], w_up[e], out=us[e])
        act = (F.silu(gate.float()) * up.float()).to(x.dtype)
        del gate, up, gs, us
        down = x.new_empty((pairs, self.hidden_size))
        acts, downs = act.split(sizes), down.split(sizes)
        for e in live:
            torch.mm(acts[e], w_down[e], out=downs[e])
        weighted = down.float() * \
            top_vals.reshape(-1)[order].float()[:, None]
        out = torch.zeros((x.shape[0], self.hidden_size),
                          dtype=torch.float32, device=x.device)
        return out.index_add_(0, tok_sorted, weighted)

    # -- host-side weight placement --

    def load_expert_weight(self, params: Params, which: str,
                           expert_id: int, hf_tensor: torch.Tensor) -> None:
        """Place one expert's HF [out, in] tensor into the stacked
        [E, out, in] param `which` (w_gate, w_up or w_down)."""
        if which not in params:
            e, h, i = (self.num_experts, self.hidden_size,
                       self.intermediate_size)
            shape = (e, h, i) if which == "w_down" else (e, i, h)
            params[which] = torch.zeros(shape, dtype=hf_tensor.dtype)
        params[which][expert_id] = hf_tensor

    def load_gate_weight(self, params: Params,
                         hf_tensor: torch.Tensor) -> None:
        """The router's HF `gate.weight` [E, H], as it is."""
        params["gate"] = hf_tensor
