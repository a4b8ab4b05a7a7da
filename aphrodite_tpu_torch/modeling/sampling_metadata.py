"""Per-batch sampling bookkeeping and vectorized sampler knobs, in
PyTorch.

Port of `aphrodite_tpu/modeling/sampling_metadata.py`: the host builds
`SamplingMetadata` (Python lists, ragged); it is flattened once per step
into `SamplingTensors` — fixed-width torch tensors on the device, padded
to the logits row count. The `do_*` flags skip whole pipeline stages
that no sequence in the batch uses.

Mirostat state (`mu`) persists across steps host-side in
`PersistentMetadata`, round-tripping through `OutputMetadata` exactly as
the reference (`sampling_metadata.py:13-28`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common.sampling_params import (SamplingParams,
                                                        SamplingType)
from aphrodite_tpu_torch.common.sequence import SequenceData

_SAMPLING_EPS = 1e-5


class PersistentMetadata:
    """Per-seq state that survives across steps (mirostat mu)."""

    def __init__(self, data: Optional[Dict[int, dict]] = None) -> None:
        self._metadata: Dict[int, dict] = data or {}

    def get(self, seq_id: int) -> dict:
        return self._metadata.get(seq_id, {})


class OutputMetadata(PersistentMetadata):
    """Mutable variant the sampler writes back into."""

    def add(self, seq_id: int, key: str, val) -> None:
        self._metadata.setdefault(seq_id, {})[key] = val


@dataclass
class SamplingMetadata:
    """Ragged per-group sampling info for one step.

    seq_groups: per scheduled group, (seq_ids, sampling_params).
    seq_data: seq id -> SequenceData (for penalties' token histories).
    prompt_lens: per prompt group, the prompt length (empty for decode).
    selected_token_indices: flat indices into the [rows, vocab] logits for
        the tokens we sample from (last token of each prompt / each decode
        row), reference `_prepare_sample` (`model_runner.py:372-451`).
    categorized_sample_indices: SamplingType -> row indices within the
        selected logits, post-selection.
    """
    seq_groups: List[Tuple[List[int], SamplingParams]]
    seq_data: Dict[int, SequenceData]
    prompt_lens: List[int]
    selected_token_indices: np.ndarray
    categorized_sample_indices: Dict[SamplingType, List[int]]
    persistent_metadata: PersistentMetadata = field(
        default_factory=PersistentMetadata)
    output_metadata: OutputMetadata = field(default_factory=OutputMetadata)
    # Per prompt group: tokens already in cache before this chunk (prefix
    # caching / chunked prefill). Aligns prompt-logprobs attribution.
    prompt_offsets: List[int] = field(default_factory=list)


@dataclass
class SamplingTensors:
    """Fixed-shape sampler knobs on the device, one row per sampled
    token. All tensors are [rows] or [rows, k]; token-history tensors are
    padded with vocab_size (an out-of-range id the penalty stage drops).
    """
    temperatures: torch.Tensor
    dynatemp_mins: torch.Tensor
    dynatemp_maxs: torch.Tensor
    dynatemp_exps: torch.Tensor
    top_ps: torch.Tensor
    top_ks: torch.Tensor
    top_as: torch.Tensor
    min_ps: torch.Tensor
    tfss: torch.Tensor
    eta_cutoffs: torch.Tensor
    epsilon_cutoffs: torch.Tensor
    typical_ps: torch.Tensor
    miro_taus: torch.Tensor
    miro_etas: torch.Tensor
    miro_mus: torch.Tensor
    smoothing_factors: torch.Tensor
    presence_penalties: torch.Tensor
    frequency_penalties: torch.Tensor
    repetition_penalties: torch.Tensor
    prompt_tokens: torch.Tensor      # [rows, width] padded w/ vocab
    output_tokens: torch.Tensor      # [rows, width] padded w/ vocab
    banned_tokens: torch.Tensor      # [rows, max_bans] padded w/ vocab
    do_penalties: bool = False
    do_temperatures: bool = False
    do_top_p_top_k: bool = False
    do_top_as: bool = False
    do_min_p: bool = False
    do_tfss: bool = False
    do_eta_cutoffs: bool = False
    do_epsilon_cutoffs: bool = False
    do_typical_ps: bool = False
    do_quadratic: bool = False
    do_mirostat: bool = False
    do_token_bans: bool = False


def _pad_2d(rows: List[List[int]], pad_value: int,
            width: Optional[int] = None) -> np.ndarray:
    if width is None:
        width = max(1, max((len(r) for r in rows), default=1))
    out = np.full((len(rows), width), pad_value, dtype=np.int32)
    for i, r in enumerate(rows):
        n = min(len(r), width)
        out[i, :n] = r[:n]
    return out


def _pow2_width(rows: List[List[int]], lo: int) -> int:
    """Bucket the ragged width to a power of two so the compiled sampler
    program's shape is stable as histories grow step to step."""
    need = max((len(r) for r in rows), default=1)
    w = lo
    while w < need:
        w *= 2
    return w


def build_sampling_tensors(
    metadata: SamplingMetadata,
    vocab_size: int,
    dtype=torch.float32,
    pad_to: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> Tuple[SamplingTensors, Dict[int, int]]:
    """Flatten SamplingMetadata into SamplingTensors.

    Mirrors `SamplingTensors.from_sampling_metadata`
    (`sampling_metadata.py:108-261`) incl. the prompt-logprobs row
    expansion: when a prompt group requests prompt_logprobs, the penalty/
    temperature rows are replicated for every prompt position.

    Returns (tensors, row_to_seq_id) where row_to_seq_id maps sampled rows
    to sequence ids (for mirostat state round-trip).
    """
    temperatures, top_ps, top_ks, top_as, min_ps = [], [], [], [], []
    tfss, eta, eps, typical, smoothing = [], [], [], [], []
    dynatemp_mins, dynatemp_maxs, dynatemp_exps = [], [], []
    miro_taus, miro_etas, miro_mus = [], [], []
    pres_pen, freq_pen, rep_pen = [], [], []
    prompt_tokens: List[List[int]] = []
    output_tokens: List[List[int]] = []
    banned_tokens: List[List[int]] = []
    row_to_seq: Dict[int, int] = {}

    do = dict(penalties=False, temperatures=False, top_p_top_k=False,
              top_as=False, min_p=False, tfss=False, eta=False,
              epsilon=False, typical=False, quadratic=False,
              mirostat=False, bans=False)

    prompt_idx = 0
    for group_idx, (seq_ids, p) in enumerate(metadata.seq_groups):
        temperature = p.temperature
        if temperature < _SAMPLING_EPS:
            temperature = 1.0      # zero temp == greedy: no-op scaling
        else:
            if temperature != 1.0 or p.dynatemp_range > 0:
                do["temperatures"] = True
        if p.dynatemp_range > 0:
            do["temperatures"] = True
        if p.top_p < 1.0 - _SAMPLING_EPS or p.top_k not in (-1, vocab_size):
            do["top_p_top_k"] = True
        if p.top_a > 0.0:
            do["top_as"] = True
        if p.min_p > _SAMPLING_EPS:
            do["min_p"] = True
        if p.tfs < 1.0 - _SAMPLING_EPS:
            do["tfss"] = True
        if p.eta_cutoff > _SAMPLING_EPS:
            do["eta"] = True
        if p.epsilon_cutoff > _SAMPLING_EPS:
            do["epsilon"] = True
        if p.typical_p < 1.0 - _SAMPLING_EPS:
            do["typical"] = True
        if p.smoothing_factor > _SAMPLING_EPS:
            do["quadratic"] = True
        if p.mirostat_mode == 2:
            do["mirostat"] = True
        if p.custom_token_bans:
            do["bans"] = True
        if abs(p.presence_penalty) >= _SAMPLING_EPS or \
                abs(p.frequency_penalty) >= _SAMPLING_EPS or \
                abs(p.repetition_penalty - 1.0) >= _SAMPLING_EPS:
            do["penalties"] = True

        is_prompt = group_idx < len(metadata.prompt_lens)
        rows: List[int] = []
        if is_prompt and p.prompt_logprobs is not None:
            rows.extend([seq_ids[0]] * (metadata.prompt_lens[group_idx] - 1))
        rows.extend(seq_ids)
        if is_prompt:
            prompt_idx += 1

        for seq_id in rows:
            data = metadata.seq_data[seq_id]
            temperatures.append(temperature)
            dyn_range = p.dynatemp_range
            dynatemp_mins.append(max(temperature - dyn_range, 0.0))
            dynatemp_maxs.append(temperature + dyn_range)
            dynatemp_exps.append(p.dynatemp_exponent)
            top_ps.append(p.top_p)
            top_ks.append(vocab_size if p.top_k == -1
                          else min(p.top_k, vocab_size))
            top_as.append(p.top_a)
            min_ps.append(p.min_p)
            tfss.append(p.tfs)
            eta.append(p.eta_cutoff)
            eps.append(p.epsilon_cutoff)
            typical.append(p.typical_p)
            smoothing.append(p.smoothing_factor)
            # tau/eta/mu are zeroed unless mode==2 so the device row gate
            # (tau > 0) agrees with the host mu write-back gate.
            is_miro = p.mirostat_mode == 2
            miro_taus.append(p.mirostat_tau if is_miro else 0.0)
            miro_etas.append(p.mirostat_eta if is_miro else 0.0)
            mu = metadata.persistent_metadata.get(seq_id).get(
                "miro_mu", 2.0 * p.mirostat_tau) if is_miro else 0.0
            miro_mus.append(mu)
            pres_pen.append(p.presence_penalty)
            freq_pen.append(p.frequency_penalty)
            rep_pen.append(p.repetition_penalty)
            prompt_tokens.append(list(data.prompt_token_ids))
            output_tokens.append(list(data.output_token_ids))
            banned_tokens.append(list(p.custom_token_bans))
            row_to_seq[len(temperatures) - 1] = seq_id

    # Pad to the jitted program's row bucket with neutral knob rows
    # (sampled results for pad rows are sliced off host-side).
    num_rows = len(temperatures)
    n_pad = max(0, (pad_to or 0) - num_rows)
    if n_pad:
        temperatures += [1.0] * n_pad
        dynatemp_mins += [0.0] * n_pad
        dynatemp_maxs += [0.0] * n_pad
        dynatemp_exps += [1.0] * n_pad
        top_ps += [1.0] * n_pad
        top_ks += [vocab_size] * n_pad
        top_as += [0.0] * n_pad
        min_ps += [0.0] * n_pad
        tfss += [1.0] * n_pad
        eta += [0.0] * n_pad
        eps += [0.0] * n_pad
        typical += [1.0] * n_pad
        smoothing += [0.0] * n_pad
        miro_taus += [0.0] * n_pad
        miro_etas += [0.0] * n_pad
        miro_mus += [0.0] * n_pad
        pres_pen += [0.0] * n_pad
        freq_pen += [0.0] * n_pad
        rep_pen += [1.0] * n_pad
        prompt_tokens += [[]] * n_pad
        output_tokens += [[]] * n_pad
        banned_tokens += [[]] * n_pad

    # Token-history tensors only exist when a stage reads them: a
    # zero-width array otherwise, a pow2-bucketed width when used (the
    # JAX package's compile-stable widths, kept for identical tensors).
    hist_width = _pow2_width(prompt_tokens + output_tokens, 32) \
        if do["penalties"] else 0
    bans_width = _pow2_width(banned_tokens, 8) if do["bans"] else 0

    dev = torch.device("cpu") if device is None else device

    def f(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    def i(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int32)).to(dev)
    tensors = SamplingTensors(
        temperatures=f(temperatures),
        dynatemp_mins=f(dynatemp_mins),
        dynatemp_maxs=f(dynatemp_maxs),
        dynatemp_exps=f(dynatemp_exps),
        top_ps=f(top_ps),
        top_ks=i(top_ks),
        top_as=f(top_as),
        min_ps=f(min_ps),
        tfss=f(tfss),
        eta_cutoffs=f(eta),
        epsilon_cutoffs=f(eps),
        typical_ps=f(typical),
        miro_taus=f(miro_taus),
        miro_etas=f(miro_etas),
        miro_mus=f(miro_mus),
        smoothing_factors=f(smoothing),
        presence_penalties=f(pres_pen),
        frequency_penalties=f(freq_pen),
        repetition_penalties=f(rep_pen),
        prompt_tokens=i(_pad_2d(prompt_tokens, vocab_size, hist_width)),
        output_tokens=i(_pad_2d(output_tokens, vocab_size, hist_width)),
        banned_tokens=i(_pad_2d(banned_tokens, vocab_size, bans_width)),
        do_penalties=do["penalties"],
        do_temperatures=do["temperatures"],
        do_top_p_top_k=do["top_p_top_k"],
        do_top_as=do["top_as"],
        do_min_p=do["min_p"],
        do_tfss=do["tfss"],
        do_eta_cutoffs=do["eta"],
        do_epsilon_cutoffs=do["epsilon"],
        do_typical_ps=do["typical"],
        do_quadratic=do["quadratic"],
        do_mirostat=do["mirostat"],
        do_token_bans=do["bans"],
    )
    return tensors, row_to_seq
