"""LoRA checkpoint loading + slot management (port of
`aphrodite_tpu/lora/models.py`: the same host-side numpy merge, slot
assignment and eviction order).

A LoRAModel holds host-side numpy (A, B) per TARGET MODULE KEY (our
merged param-bucket keys, e.g. "model.layers.0.self_attn.qkv_proj").
peft per-projection tensors (q/k/v, gate/up) are merged block-diagonally:
A = [A_q | A_k | A_v] along rank, B places each projection's rows into
its output slice, so the merged-matmul layers need no special cases.

The manager owns `max_loras` device slots; activating an adapter writes
its (A, B) into slot s of every wrapped bucket's stacked arrays.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common.config import LoRAConfig
from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.common.utils import LRUCache

logger = init_logger(__name__)

# HF/peft projection name -> (our merged module suffix, shard id).
_PEFT_TO_MERGED = {
    "q_proj": ("self_attn.qkv_proj", "q"),
    "k_proj": ("self_attn.qkv_proj", "k"),
    "v_proj": ("self_attn.qkv_proj", "v"),
    "o_proj": ("self_attn.o_proj", None),
    "gate_proj": ("mlp.gate_up_proj", 0),
    "up_proj": ("mlp.gate_up_proj", 1),
    "down_proj": ("mlp.down_proj", None),
}


class LoRALayerWeights:
    """One module's (A [in, r], B [r, out]) with scaling pre-applied."""

    def __init__(self, a: np.ndarray, b: np.ndarray) -> None:
        self.a = a
        self.b = b

    @property
    def rank(self) -> int:
        return self.a.shape[1]


class LoRAModel:
    """All module weights of one adapter (host-side)."""

    def __init__(self, lora_id: int, rank: int,
                 loras: Dict[str, LoRALayerWeights]) -> None:
        self.id = lora_id
        self.rank = rank
        self.loras = loras

    @classmethod
    def from_local_checkpoint(cls, path: str, lora_id: int,
                              module_layouts: Optional[Dict[str, Dict]]
                              = None) -> "LoRAModel":
        """Load a peft-format adapter dir (adapter_config.json +
        adapter_model.{safetensors,bin}); reference `models.py:220`.

        `module_layouts` maps merged-module key -> {shard_id: (offset,
        size)} from the target layer's true layout (reference
        PackedLoRALayerWeights.pack keeps None placeholders for absent
        sub-modules so slices stay aligned; we place each B block at the
        layer-derived offset instead)."""
        with open(os.path.join(path, "adapter_config.json")) as f:
            config = json.load(f)
        rank = config["r"]
        alpha = config.get("lora_alpha", rank)
        scaling = alpha / rank

        tensors: Dict[str, np.ndarray] = {}
        st_path = os.path.join(path, "adapter_model.safetensors")
        bin_path = os.path.join(path, "adapter_model.bin")
        if os.path.isfile(st_path):
            # As the JAX package's reader gives them: bf16 widened to
            # f32, every other dtype as stored. Imported only here: the
            # card machine has no safetensors package.
            from safetensors.torch import load_file
            tensors = {k: (v.float() if v.dtype == torch.bfloat16
                           else v).numpy()
                       for k, v in load_file(st_path).items()}
        elif os.path.isfile(bin_path):
            state = torch.load(bin_path, map_location="cpu",
                               weights_only=True)
            tensors = {k: v.float().numpy() for k, v in state.items()}
        else:
            raise ValueError(f"No adapter weights found in {path}")

        # Group per (layer-module key, projection): collect A/B pairs.
        per_module: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
        for name, arr in tensors.items():
            # e.g. base_model.model.model.layers.0.self_attn.q_proj.
            #        lora_A.weight
            if ".lora_A." in name:
                side = "A"
                mod_name = name.split(".lora_A.")[0]
            elif ".lora_B." in name:
                side = "B"
                mod_name = name.split(".lora_B.")[0]
            else:
                continue
            mod_name = mod_name.replace("base_model.model.", "")
            proj = mod_name.rsplit(".", 1)[1]
            layer_path = mod_name.rsplit(".", 1)[0]
            per_module.setdefault(layer_path, {}).setdefault(
                proj, {})[side] = arr

        loras: Dict[str, LoRALayerWeights] = {}
        for layer_path, projs in per_module.items():
            # layer_path like "model.layers.0.self_attn" or
            # "model.layers.0.mlp".
            merged: Dict[str, List[Tuple[object, np.ndarray,
                                         np.ndarray]]] = {}
            for proj, sides in projs.items():
                if proj not in _PEFT_TO_MERGED:
                    logger.warning("Skipping unsupported LoRA module %s",
                                   proj)
                    continue
                suffix, shard_id = _PEFT_TO_MERGED[proj]
                # torch layout: A [r, in], B [out, r] -> ours A [in, r],
                # B [r, out]; fold scaling into B.
                a = sides["A"].T.astype(np.float32)
                b = (sides["B"].T * scaling).astype(np.float32)
                layer_prefix = layer_path.rsplit(".", 1)[0]
                key = f"{layer_prefix}.{suffix}"
                merged.setdefault(key, []).append((shard_id, a, b))

            for key, pieces in merged.items():
                layout = (module_layouts or {}).get(key)
                loras[key] = _merge_block_diagonal(key, pieces, layout)
        return cls(lora_id, rank, loras)


def layouts_from_model(model) -> Dict[str, Dict]:
    """Build {merged key -> {shard_id: (offset, size)}} from the live
    model's packed linear layers (QKVParallelLinear.shard_offsets /
    MergedColumnParallelLinear.output_sizes), so adapters that target a
    SUBSET of a packed layer still place each B block at its true output
    slice."""
    layouts: Dict[str, Dict] = {}
    for layer in getattr(model, "layers", []):
        prefix = getattr(layer, "prefix", None)
        if prefix is None:
            continue
        attn = getattr(layer, "self_attn", None)
        qkv = getattr(attn, "qkv_proj", None) if attn is not None else None
        if qkv is not None and hasattr(qkv, "shard_offsets"):
            layouts[f"{prefix}.self_attn.qkv_proj"] = dict(
                qkv.shard_offsets())
        mlp = getattr(layer, "mlp", None)
        gu = getattr(mlp, "gate_up_proj", None) if mlp is not None else None
        sizes = getattr(gu, "output_sizes", None)
        if sizes:
            d, off = {}, 0
            for i, s in enumerate(sizes):
                d[i] = (off, s)
                off += s
            layouts[f"{prefix}.mlp.gate_up_proj"] = d
    return layouts


def _merge_block_diagonal(key: str, pieces,
                          layout: Optional[Dict] = None
                          ) -> LoRALayerWeights:
    """Merge per-projection (A, B) into block-diagonal merged-layer
    (A [in, R], B [R, out_total]) where R = sum of PRESENT piece ranks.

    Output offsets come from `layout` (the target layer's true shard
    placement) when available, so an adapter targeting only q+v still
    writes the v delta at offset q_out + k_out — absent projections
    simply contribute no rank columns and leave their slice zero. With
    no layout we fall back to inferring the gap sizes for the known
    packed families (qkv: a missing k/v shard is the same width as its
    sibling; gate/up: equal widths)."""
    order = {"q": 0, "k": 1, "v": 2, 0: 0, 1: 1, None: 0}
    pieces = sorted(pieces, key=lambda p: order[p[0]])
    if len(pieces) == 1 and pieces[0][0] is None:
        _, a, b = pieces[0]
        return LoRALayerWeights(a, b)

    sizes_of = {sid: b.shape[1] for sid, _, b in pieces}
    if layout is not None:
        offsets = {sid: off for sid, (off, _) in layout.items()}
        total_out = max(off + size for off, size in layout.values())
        for sid, _, b in pieces:
            if sid not in layout:
                raise ValueError(
                    f"LoRA shard {sid!r} not in layout of {key}")
            if b.shape[1] != layout[sid][1]:
                raise ValueError(
                    f"LoRA B width {b.shape[1]} != layer shard width "
                    f"{layout[sid][1]} for {key}.{sid}")
    else:
        expected = ["q", "k", "v"] if any(
            s in sizes_of for s in ("q", "k", "v")) else \
            list(range(max(sizes_of) + 1))
        full_sizes = []
        for sid in expected:
            if sid in sizes_of:
                full_sizes.append(sizes_of[sid])
            elif sid in ("k", "v"):
                # k and v always share a width.
                sib = sizes_of.get("v" if sid == "k" else "k")
                if sib is None:
                    raise ValueError(
                        f"Cannot infer width of absent shard {sid!r} in "
                        f"{key}; pass module_layouts")
                full_sizes.append(sib)
            elif sid == "q":
                # Under GQA q's width differs from k/v — refusing beats
                # silently shifting every downstream slice.
                raise ValueError(
                    f"Cannot infer width of absent q shard in {key}; "
                    "pass module_layouts")
            else:
                # gate/up (and other same-width packs).
                full_sizes.append(next(iter(sizes_of.values())))
        offsets, off = {}, 0
        for sid, s in zip(expected, full_sizes):
            offsets[sid] = off
            off += s
        total_out = off

    total_rank = sum(p[1].shape[1] for p in pieces)
    in_features = pieces[0][1].shape[0]
    a_merged = np.zeros((in_features, total_rank), dtype=np.float32)
    b_merged = np.zeros((total_rank, total_out), dtype=np.float32)
    r_off = 0
    for sid, a, b in pieces:
        r = a.shape[1]
        a_merged[:, r_off:r_off + r] = a
        b_merged[r_off:r_off + r,
                 offsets[sid]:offsets[sid] + b.shape[1]] = b
        r_off += r
    return LoRALayerWeights(a_merged, b_merged)


class LoRAModelManager:
    """Slot allocator + device writer (reference `models.py:266`).

    `write_slot_fn(bucket_key, slot, a, b)` and
    `clear_slot_fn(bucket_key, slot)` are provided by the model runner
    (it owns the device param tree).
    """

    def __init__(self, lora_config: LoRAConfig,
                 write_slot_fn: Callable[[str, int, np.ndarray,
                                          np.ndarray], None],
                 clear_slot_fn: Callable[[str, int], None]) -> None:
        self.lora_config = lora_config
        self.capacity = lora_config.max_loras
        self._write_slot = write_slot_fn
        self._clear_slot = clear_slot_fn
        self._registered: Dict[int, LoRAModel] = {}
        self._slot_of: Dict[int, int] = {}
        self._free_slots = list(range(self.capacity))

    # -- registry (host) --

    def add_lora(self, lora: LoRAModel) -> bool:
        if lora.id in self._registered:
            return False
        if lora.rank > self.lora_config.max_lora_rank:
            raise ValueError(
                f"LoRA rank {lora.rank} exceeds max_lora_rank "
                f"{self.lora_config.max_lora_rank}")
        self._registered[lora.id] = lora
        return True

    def remove_lora(self, lora_id: int) -> bool:
        self.deactivate_lora(lora_id)
        return self._registered.pop(lora_id, None) is not None

    def list_loras(self) -> Dict[int, LoRAModel]:
        return dict(self._registered)

    # -- slots (device) --

    def slot_of(self, lora_id: int) -> int:
        return self._slot_of[lora_id]

    def is_active(self, lora_id: int) -> bool:
        return lora_id in self._slot_of

    def activate_lora(self, lora_id: int) -> bool:
        if lora_id in self._slot_of:
            return False
        if not self._free_slots:
            raise RuntimeError("No free LoRA slots")
        lora = self._registered[lora_id]
        slot = self._free_slots.pop(0)
        self._slot_of[lora_id] = slot
        for key, weights in lora.loras.items():
            self._write_slot(key, slot, weights.a, weights.b)
        logger.debug("Activated LoRA %d in slot %d", lora_id, slot)
        return True

    def deactivate_lora(self, lora_id: int) -> bool:
        slot = self._slot_of.pop(lora_id, None)
        if slot is None:
            return False
        lora = self._registered.get(lora_id)
        if lora is not None:
            for key in lora.loras:
                self._clear_slot(key, slot)
        self._free_slots.insert(0, slot)
        return True

    def set_active_loras(self, lora_ids: Set[int]) -> None:
        """Ensure this batch's adapters are resident; deactivate others
        only when slots are needed."""
        missing = [i for i in lora_ids if i not in self._slot_of]
        if len(lora_ids) > self.capacity:
            raise RuntimeError(
                f"Batch needs {len(lora_ids)} LoRAs > {self.capacity} "
                "slots")
        for lora_id in missing:
            if not self._free_slots:
                victim = next(i for i in self._slot_of
                              if i not in lora_ids)
                self.deactivate_lora(victim)
            self.activate_lora(lora_id)


class _EvictingLRU(LRUCache):

    def __init__(self, capacity: int, on_evict) -> None:
        super().__init__(capacity)
        self._on_evict = on_evict

    def _on_remove(self, key, value) -> None:
        self._on_evict(key)


class LRUCacheLoRAModelManager(LoRAModelManager):
    """Keeps up to max_cpu_loras registered host-side with LRU eviction
    (reference `models.py:579`)."""

    def __init__(self, lora_config: LoRAConfig, write_slot_fn,
                 clear_slot_fn) -> None:
        super().__init__(lora_config, write_slot_fn, clear_slot_fn)
        self._lru = _EvictingLRU(
            lora_config.max_cpu_loras,
            on_evict=lambda lora_id: LoRAModelManager.remove_lora(
                self, lora_id))

    def add_lora(self, lora: LoRAModel) -> bool:
        added = super().add_lora(lora)
        self._lru.put(lora.id, lora)
        return added

    def touch(self, lora_id: int) -> None:
        self._lru.get(lora_id)
