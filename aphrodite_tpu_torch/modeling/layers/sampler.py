"""The sampler: the full logits-processing pipeline and token selection,
in PyTorch.

Port of `aphrodite_tpu/modeling/layers/sampler.py`: the same stages in
the same order (penalties, temperature/dynatemp, top-p/top-k/top-a/
min-p, TFS, eta, epsilon, typical, quadratic, token bans, mirostat v2),
dense over a [rows, vocab] float32 logits matrix with per-row knob
tensors; stages nobody in the batch uses are skipped through the
`do_*` flags. The device result is packed into one int32 tensor with the
JAX layout, so the host needs one transfer per step and `finalize` /
`_assemble` are the JAX package's.

Random draws: each row that samples gets its own `torch.Generator`,
seeded from the row's (base, salt1, salt2) — the request seed and its
output position for seeded requests — and draws Gumbel noise for
argmax(logits + noise), the categorical draw JAX makes. Seeded requests
are therefore reproducible within the port, regardless of batch
composition; they do not reproduce JAX's threefry bits.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aphrodite_tpu_torch.common.sampling_params import SamplingType
from aphrodite_tpu_torch.common.sequence import (SamplerOutput,
                                                 SequenceGroupOutput,
                                                 SequenceOutput)
from aphrodite_tpu_torch.modeling.sampling_metadata import (
    SamplingMetadata, SamplingTensors, build_sampling_tensors)

_NEG_INF = float("-inf")
_MASK64 = (1 << 64) - 1


# ---------------------------------------------------------------- stages --

def _bin_counts_and_mask(tokens: torch.Tensor, vocab_size: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [rows, width] padded with vocab_size -> (counts, mask) over
    [rows, vocab]; the pad id lands in an extra column sliced off."""
    rows = tokens.shape[0]
    counts = torch.zeros((rows, vocab_size + 1), dtype=torch.int32,
                         device=tokens.device)
    counts.scatter_add_(1, tokens.long(), torch.ones_like(tokens))
    counts = counts[:, :vocab_size]
    return counts, counts > 0


def _apply_penalties(logits, t: SamplingTensors) -> torch.Tensor:
    vocab = logits.shape[-1]
    _, prompt_mask = _bin_counts_and_mask(t.prompt_tokens, vocab)
    out_counts, out_mask = _bin_counts_and_mask(t.output_tokens, vocab)
    rep = torch.where(prompt_mask | out_mask,
                      t.repetition_penalties[:, None],
                      torch.ones_like(logits))
    logits = torch.where(logits > 0, logits / rep, logits * rep)
    logits = logits - t.frequency_penalties[:, None] * out_counts
    logits = logits - t.presence_penalties[:, None] * out_mask
    return logits


def _apply_temperatures(logits, t: SamplingTensors) -> torch.Tensor:
    """Plain temperature + dynatemp (entropy-interpolated)."""
    dyn_mask = (t.dynatemp_maxs - t.dynatemp_mins) > 0
    shifted = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(shifted)
    entropies = -torch.nansum(probs * shifted, dim=-1)
    num_valid = (logits > _NEG_INF).sum(dim=-1).float()
    max_entropies = torch.log(num_valid)
    normalized = torch.where(max_entropies > 0, entropies / max_entropies,
                             torch.zeros_like(entropies))
    dyn_temps = (t.dynatemp_mins + (t.dynatemp_maxs - t.dynatemp_mins) *
                 torch.pow(normalized, t.dynatemp_exps))
    temps = torch.where(dyn_mask, dyn_temps, t.temperatures)
    temps = torch.where(temps == 0.0, torch.ones_like(temps), temps)
    return logits / temps[:, None]


def _sort_desc(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending sort with JAX's tie order (a stable ascending sort,
    reversed)."""
    vals, order = torch.sort(logits, dim=-1, stable=True)
    return vals.flip(-1), order.flip(-1)


def _unsort(sorted_vals: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(sorted_vals).scatter_(1, order, sorted_vals)


def _apply_alphabet_soup(logits, t: SamplingTensors) -> torch.Tensor:
    """Fused top-p / top-k / top-a / min-p on one sort."""
    sorted_logits, order = _sort_desc(logits)
    probs_sort = torch.softmax(sorted_logits, dim=-1)
    probs_cum = torch.cumsum(probs_sort, dim=-1) - probs_sort
    top_probs = probs_sort[:, :1]
    threshold = torch.maximum(top_probs * t.min_ps[:, None],
                              (top_probs ** 2) * t.top_as[:, None])
    mask = probs_sort < threshold
    mask |= probs_cum > t.top_ps[:, None]
    positions = torch.arange(logits.shape[-1], device=logits.device)[None]
    mask |= positions >= t.top_ks[:, None]
    mask[:, 0] = False                  # always keep the argmax
    sorted_logits = sorted_logits.masked_fill(mask, _NEG_INF)
    return _unsort(sorted_logits, order)


def _apply_tfs(logits, t: SamplingTensors) -> torch.Tensor:
    """Tail-free sampling: cull the low-curvature tail."""
    sorted_logits, order = _sort_desc(logits)
    probs = torch.softmax(sorted_logits, dim=-1)
    d2 = torch.abs(torch.diff(torch.diff(probs, dim=-1), dim=-1))
    d2_sum = d2.sum(dim=-1, keepdim=True)
    norm_d2 = torch.where(d2_sum > 0, d2 / d2_sum, torch.zeros_like(d2))
    cdf = torch.cumsum(norm_d2, dim=-1)
    tail = cdf > t.tfss[:, None]
    rows = logits.shape[0]
    mask = torch.cat([
        torch.zeros((rows, 1), dtype=torch.bool, device=logits.device),
        tail,
        torch.ones((rows, 1), dtype=torch.bool, device=logits.device),
    ], dim=-1)
    sorted_logits = sorted_logits.masked_fill(mask, _NEG_INF)
    return _unsort(sorted_logits, order)


def _entropy_cutoff_mask(probs, eps):
    """Shared guard: never mask the max-probability token."""
    top = probs.amax(dim=-1, keepdim=True)
    return (probs < eps) & (probs < top)


def _apply_eta_cutoff(logits, t: SamplingTensors) -> torch.Tensor:
    eta = t.eta_cutoffs * 1e-4
    shifted = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(shifted)
    neg_entropy = torch.nansum(probs * shifted, dim=-1)
    eps = torch.minimum(eta, torch.sqrt(eta) * torch.exp(neg_entropy))
    return logits.masked_fill(_entropy_cutoff_mask(probs, eps[:, None]),
                              _NEG_INF)


def _apply_epsilon_cutoff(logits, t: SamplingTensors) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    eps = (t.epsilon_cutoffs * 1e-4)[:, None]
    return logits.masked_fill(_entropy_cutoff_mask(probs, eps), _NEG_INF)


def _apply_typical_sampling(logits, t: SamplingTensors) -> torch.Tensor:
    """Locally typical sampling: keep tokens whose surprisal is closest
    to the entropy, up to mass typical_p."""
    shifted = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(shifted)
    neg_entropy = torch.nansum(probs * shifted, dim=-1, keepdim=True)
    deviations = torch.abs(neg_entropy - shifted)
    order = torch.argsort(deviations, dim=-1, stable=True)
    reordered = torch.gather(probs, 1, order)
    mask_sorted = torch.cumsum(reordered, dim=-1) >= t.typical_ps[:, None]
    mask_sorted[:, 0] = False
    mask = torch.zeros_like(mask_sorted).scatter_(1, order, mask_sorted)
    return logits.masked_fill(mask, _NEG_INF)


def _apply_token_bans(logits, t: SamplingTensors) -> torch.Tensor:
    """custom_token_bans -> -inf; the pad id (vocab) lands in an extra
    column that is sliced off."""
    rows, vocab = logits.shape
    wide = torch.cat([logits, torch.zeros((rows, 1), dtype=logits.dtype,
                                          device=logits.device)], dim=-1)
    wide.scatter_(1, t.banned_tokens.long(), _NEG_INF)
    return wide[:, :vocab]


def _apply_quadratic(logits, t: SamplingTensors) -> torch.Tensor:
    max_logits = logits.amax(dim=-1, keepdim=True)
    transformed = -(t.smoothing_factors[:, None] *
                    (logits - max_logits) ** 2) + max_logits
    # factor == 0 must be a no-op for that row.
    return torch.where(t.smoothing_factors[:, None] > 0, transformed,
                       logits)


def _apply_mirostat_v2(logits, t: SamplingTensors,
                       seeds: Sequence[Optional[int]]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mirostat v2: mask tokens above the surprise target mu, sample,
    one-hot the logits; returns updated mus."""
    surprise = -torch.log2(torch.softmax(logits, dim=-1))
    mask = surprise > t.miro_mus[:, None]
    min_idx = surprise.argmin(dim=-1)
    rows = torch.arange(logits.shape[0], device=logits.device)
    mask[rows, min_idx] = False
    masked = logits.masked_fill(mask, _NEG_INF)
    sampled = _categorical(masked, seeds, 1)[:, 0]
    picked = surprise[rows, sampled]
    new_mus = t.miro_mus - t.miro_etas * (picked - t.miro_taus)
    onehot = torch.full_like(logits, _NEG_INF)
    onehot[rows, sampled] = 1.0
    return onehot, new_mus


# -------------------------------------------------------- random draws --

def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def row_seed(base: int, salt1: int, salt2: int) -> int:
    """Generator seed of one row from its (base, salt1, salt2), the
    counterpart of fold_in(fold_in(PRNGKey(base), salt1), salt2)."""
    h = _splitmix64(int(base) & _MASK64)
    h = _splitmix64(h ^ (int(salt1) & _MASK64))
    h = _splitmix64(h ^ (int(salt2) & _MASK64))
    return h & ((1 << 63) - 1)


def row_seeds(bases, salt1, salt2, rows: Optional[np.ndarray] = None
              ) -> List[Optional[int]]:
    """Per-row seeds; None for rows that draw nothing (rows[r] False)."""
    return [row_seed(b, s1, s2) if rows is None or rows[r] else None
            for r, (b, s1, s2) in enumerate(zip(bases, salt1, salt2))]


def _categorical(logits: torch.Tensor, seeds: Sequence[Optional[int]],
                 num: int) -> torch.Tensor:
    """[rows, num] draws from softmax(logits) by the Gumbel-max trick,
    one generator per row; rows whose seed is None take the argmax."""
    out = logits.argmax(dim=-1, keepdim=True).repeat(1, num)
    for r, seed in enumerate(seeds):
        if seed is None:
            continue
        gen = torch.Generator(device=logits.device).manual_seed(seed)
        u = torch.rand((num, logits.shape[-1]), generator=gen,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        out[r] = (logits[r][None] + gumbel).argmax(dim=-1)
    return out


# ------------------------------------------------------------ pipeline --

def _process_logits(logits: torch.Tensor, t: SamplingTensors,
                    miro_seeds: Sequence[Optional[int]]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pipeline in reference order; do_* flags skip unused stages."""
    logits = logits.float()
    if t.do_penalties:
        logits = _apply_penalties(logits, t)
    if t.do_temperatures:
        logits = _apply_temperatures(logits, t)
    if t.do_top_p_top_k or t.do_top_as or t.do_min_p:
        logits = _apply_alphabet_soup(logits, t)
    if t.do_tfss:
        logits = _apply_tfs(logits, t)
    if t.do_eta_cutoffs:
        logits = _apply_eta_cutoff(logits, t)
    if t.do_epsilon_cutoffs:
        logits = _apply_epsilon_cutoff(logits, t)
    if t.do_typical_ps:
        logits = _apply_typical_sampling(logits, t)
    if t.do_quadratic:
        logits = _apply_quadratic(logits, t)
    if t.do_token_bans:
        logits = _apply_token_bans(logits, t)
    new_mus = t.miro_mus
    if t.do_mirostat:
        miro_logits, new_mus_all = _apply_mirostat_v2(logits, t,
                                                      miro_seeds)
        is_miro = t.miro_taus > 0
        logits = torch.where(is_miro[:, None], miro_logits, logits)
        new_mus = torch.where(is_miro, new_mus_all, t.miro_mus)
    return logits, new_mus


def _sample_tokens(logits: torch.Tensor, seeds: Sequence[Optional[int]],
                   max_best_of: int, num_topk: int):
    """Token selection and the small result tensors: (greedy [rows],
    random [rows, max_best_of], lp_greedy [rows], lp_random
    [rows, max_best_of], topk_vals / topk_idx [rows, num_topk],
    logprobs [rows, vocab])."""
    greedy = logits.argmax(dim=-1)
    random = _categorical(logits, seeds, max_best_of)
    logprobs = torch.log_softmax(logits, dim=-1)
    lp_greedy = logprobs.gather(1, greedy[:, None])[:, 0]
    lp_random = logprobs.gather(1, random)
    if num_topk > 0:
        topk_vals, topk_idx = torch.topk(logprobs, num_topk, dim=-1)
    else:
        topk_vals = torch.zeros((logits.shape[0], 0), dtype=logprobs.dtype,
                                device=logits.device)
        topk_idx = torch.zeros((logits.shape[0], 0), dtype=torch.int64,
                               device=logits.device)
    return greedy, random, lp_greedy, lp_random, topk_vals, topk_idx, \
        logprobs


def fused_sample(logits: torch.Tensor, t: SamplingTensors, bases, salt1,
                 salt2, *, max_best_of: int, num_topk: int,
                 need_logprobs: bool, draw_rows: Optional[np.ndarray] = None):
    """The whole device-side sampling step, packed into ONE int32 tensor
    with the JAX layout (W = 1 + B + K):

      [0]                greedy token
      [1 : 1+B]          multinomial draws (B = max_best_of)
      [1+B : 1+B+K]      top-k logprob token ids (K = num_topk)
      [W : W+1]          lp(greedy)      } float32 bit patterns
      [W+1 : W+1+B]      lp(draws)       }
      [W+1+B : W+1+B+K]  top-k logprob values }
      [-1]               updated mirostat mu  }

    bases / salt1 / salt2 are host arrays (one entry per row); rows with
    `draw_rows` False draw nothing (their draw columns hold the argmax).
    Full [rows, vocab] logprobs come back only with `need_logprobs`."""
    seeds = row_seeds(bases, salt1, salt2, draw_rows)
    miro_seeds = row_seeds(bases, salt1, salt2) if t.do_mirostat else ()
    processed, new_mus = _process_logits(logits, t, miro_seeds)
    greedy, random, lp_greedy, lp_random, topk_vals, topk_idx, logprobs = \
        _sample_tokens(processed, seeds, max_best_of, num_topk)
    ints = torch.cat([greedy[:, None], random, topk_idx],
                     dim=1).to(torch.int32)
    floats = torch.cat([lp_greedy[:, None], lp_random, topk_vals,
                        new_mus[:, None]], dim=1).float()
    packed = torch.cat([ints, floats.view(torch.int32)], dim=1)
    return packed, (logprobs if need_logprobs else None)


# ------------------------------------------------------------- host side --

class SamplePlan:
    """Host-side bookkeeping for one sampling step, shared between the
    device dispatch (`fused_sample` args) and `finalize`."""

    __slots__ = ("tensors", "bases", "salt1", "salt2", "max_best_of",
                 "num_topk", "need_logprobs", "num_rows", "row_to_seq",
                 "group_of", "draw_rows")

    def __init__(self, tensors, bases, salt1, salt2, max_best_of,
                 num_topk, need_logprobs, num_rows, row_to_seq, group_of,
                 draw_rows):
        self.tensors = tensors
        self.bases = bases
        self.salt1 = salt1
        self.salt2 = salt2
        self.max_best_of = max_best_of
        self.num_topk = num_topk
        self.need_logprobs = need_logprobs
        self.num_rows = num_rows
        self.row_to_seq = row_to_seq
        self.group_of = group_of
        # Rows that sample at random (the others skip their draws).
        self.draw_rows = draw_rows


class Sampler:
    """Host orchestrator: tensorize knobs, run the jitted pipeline, and
    assemble per-group outputs (greedy/random/beam) like the reference
    `_sample` + `_get_logprobs` (`sampler.py:545-650`)."""

    def __init__(self, vocab_size: int,
                 device: Optional[torch.device] = None) -> None:
        self.vocab_size = vocab_size
        self.device = torch.device("cpu") if device is None else device
        self._step = 0
        # Process entropy so unseeded sampling differs across restarts
        # (seeded requests are unaffected: their keys derive from the
        # request seed only).
        import os as _os
        self._base_seed = int.from_bytes(_os.urandom(4), "little") \
            & 0x7FFFFFFF

    def __call__(self, logits: torch.Tensor,
                 metadata: SamplingMetadata) -> SamplerOutput:
        assert logits.ndim == 2
        logits = self._apply_logits_processors(logits, metadata)
        plan = self.plan(metadata)
        packed, logprobs = fused_sample(
            logits, plan.tensors, plan.bases, plan.salt1, plan.salt2,
            max_best_of=plan.max_best_of, num_topk=plan.num_topk,
            need_logprobs=plan.need_logprobs, draw_rows=plan.draw_rows)
        return self.finalize(metadata, plan, packed.cpu().numpy(),
                             logprobs)

    def plan(self, metadata: SamplingMetadata,
             pad_to: Optional[int] = None) -> SamplePlan:
        """Build the host-side step plan: device knob tensors (padded to
        the program's row bucket), PRNG key parts, and static shapes."""
        tensors, row_to_seq = build_sampling_tensors(
            metadata, self.vocab_size, pad_to=pad_to, device=self.device)
        num_rows = len(row_to_seq)
        rows = tensors.temperatures.shape[0]
        group_of = self._seq_to_group(metadata)
        draw_rows = np.zeros((rows,), dtype=bool)
        for row, seq_id in row_to_seq.items():
            entry = group_of.get(seq_id)
            if entry is not None and \
                    entry[1].sampling_type == SamplingType.RANDOM:
                draw_rows[row] = True
        self._step += 1
        bases, salt1, salt2 = self._key_parts(metadata, rows, row_to_seq,
                                              group_of)
        max_best_of = max([1] + [
            p.best_of for (_, p) in metadata.seq_groups
            if p.sampling_type == SamplingType.RANDOM
        ])
        max_logprobs = max([0] + [
            min(p.logprobs or 0, self.vocab_size - 1)
            for (_, p) in metadata.seq_groups
        ] + [
            min(p.prompt_logprobs or 0, self.vocab_size - 1)
            for (_, p) in metadata.seq_groups
        ])
        need_logprobs = any(
            p.sampling_type == SamplingType.BEAM or
            (p.prompt_logprobs is not None and
             metadata.prompt_lens)
            for (_, p) in metadata.seq_groups)
        return SamplePlan(tensors, bases, salt1, salt2, max_best_of,
                          max_logprobs, need_logprobs, num_rows,
                          row_to_seq, group_of, draw_rows)

    def finalize(self, metadata: SamplingMetadata, plan: SamplePlan,
                 packed: np.ndarray,
                 logprobs_dev: Optional[torch.Tensor]) -> SamplerOutput:
        """Unpack the single transferred result array and assemble
        per-group outputs; the full logprobs come to the host only for
        the rare beam / prompt-logprobs paths."""
        if logprobs_dev is not None:
            logprobs_dev = logprobs_dev.cpu()
        B, K = plan.max_best_of, plan.num_topk
        w_int = 1 + B + K
        packed = packed[:plan.num_rows]
        ints = packed[:, :w_int]
        floats = packed[:, w_int:].view(np.float32)
        greedy = ints[:, 0]
        random = ints[:, 1:1 + B]
        topk_idx = ints[:, 1 + B:w_int]
        lp_greedy = floats[:, 0]
        lp_random = floats[:, 1:1 + B]
        topk_vals = floats[:, 1 + B:1 + B + K]
        if plan.tensors.do_mirostat:
            new_mus = floats[:, 1 + B + K]
            for row, seq_id in plan.row_to_seq.items():
                _, params = plan.group_of.get(seq_id, (None, None))
                if params is not None and params.mirostat_mode == 2:
                    metadata.output_metadata.add(seq_id, "miro_mu",
                                                 float(new_mus[row]))
        return self._assemble(metadata, greedy, random, lp_greedy,
                              lp_random, topk_vals, topk_idx, logprobs_dev)

    # -- helpers --

    @staticmethod
    def _seq_to_group(metadata: SamplingMetadata) -> Dict[int, tuple]:
        """seq_id -> (seq_ids, params), built once per step."""
        return {
            seq_id: (seq_ids, params)
            for seq_ids, params in metadata.seq_groups
            for seq_id in seq_ids
        }

    def _key_parts(self, metadata: SamplingMetadata, rows: int,
                   row_to_seq: Dict[int, int],
                   group_of: Dict[int, tuple]):
        """Per-row PRNG key ingredients (folded together on device).

        Seeded rows: base=request seed, salts=(output_len, sibling index)
        — reproducible regardless of batch composition or restarts.
        Unseeded rows: base mixes process entropy, step, and row so that
        the per-step salt1 offset added by decode bursts (+t) never
        collides across (row, step) diagonals.
        """
        bases = np.empty((rows,), dtype=np.int64)
        salt1 = np.empty((rows,), dtype=np.int32)
        salt2 = np.empty((rows,), dtype=np.int32)
        step_mix = (self._base_seed ^ (self._step * 0x9E3779B1)) \
            & 0x7FFFFFFF
        for row in range(rows):
            seq_id = row_to_seq.get(row)
            entry = group_of.get(seq_id) if seq_id is not None else None
            if entry is not None and entry[1].seed is not None:
                seq_ids, params = entry
                bases[row] = params.seed
                salt1[row] = len(
                    metadata.seq_data[seq_id].output_token_ids)
                salt2[row] = seq_ids.index(seq_id)
            else:
                bases[row] = (step_mix ^ (row * 0x85EBCA77)) & 0x7FFFFFFF
                salt1[row] = 0
                salt2[row] = 0
        return bases, salt1, salt2

    def _apply_logits_processors(self, logits, metadata):
        """Host-side per-request callables (logit_bias, grammar, min-tokens
        EOS ban; reference `sampler.py:180-204`)."""
        has_any = any(p.logits_processors
                      for _, p in metadata.seq_groups)
        if not has_any:
            return logits
        arr = logits.float().cpu().numpy().copy()   # writable copy
        offset = 0
        for i, (seq_ids, params) in enumerate(metadata.seq_groups):
            # Prompt-logprob rows are never processed (reference
            # `_apply_logits_processors` advances past them).
            if i < len(metadata.prompt_lens) and \
                    params.prompt_logprobs is not None:
                offset += metadata.prompt_lens[i] - 1
            if params.logits_processors:
                for j, sid in enumerate(seq_ids):
                    toks = metadata.seq_data[sid].output_token_ids
                    row = arr[offset + j]
                    for proc in params.logits_processors:
                        row = proc(toks, row)
                    arr[offset + j] = row
            offset += len(seq_ids)
        return torch.from_numpy(arr).to(logits.device)

    def _assemble(self, metadata: SamplingMetadata, greedy: np.ndarray,
                  random: np.ndarray, lp_greedy: np.ndarray,
                  lp_random: np.ndarray, topk_vals: np.ndarray,
                  topk_idx: np.ndarray,
                  logprobs_dev: Optional[torch.Tensor]) -> SamplerOutput:
        """Per-group output assembly. Fast paths (greedy/random) touch
        only the small host tensors; beam and prompt-logprobs groups
        transfer just their own logprob rows from device."""
        outputs: List[SequenceGroupOutput] = []
        row = 0
        for group_idx, (seq_ids, params) in enumerate(metadata.seq_groups):
            is_prompt = group_idx < len(metadata.prompt_lens)

            # Prompt-logprobs rows (one per prompt position before last).
            group_prompt_logprobs = None
            if is_prompt and params.prompt_logprobs is not None:
                n = metadata.prompt_lens[group_idx] - 1
                ctx = metadata.prompt_offsets[group_idx] \
                    if metadata.prompt_offsets else 0
                group_prompt_logprobs = [None] if ctx == 0 else []
                prompt_token_ids = \
                    metadata.seq_data[seq_ids[0]].prompt_token_ids
                rows_np = np.asarray(logprobs_dev[row:row + n])
                for j in range(n):
                    tok = prompt_token_ids[ctx + j + 1]
                    group_prompt_logprobs.append(
                        self._full_top_logprobs(rows_np[j],
                                                params.prompt_logprobs,
                                                tok))
                row += n

            samples: List[SequenceOutput] = []
            if params.sampling_type == SamplingType.GREEDY:
                token = int(greedy[row])
                lp = self._topk_logprobs(topk_vals, topk_idx, row, params,
                                         token, float(lp_greedy[row]))
                samples.append(SequenceOutput(
                    seq_ids[0], token, lp,
                    metadata.output_metadata.get(seq_ids[0])))
            elif params.sampling_type == SamplingType.BEAM:
                samples = self._beam_sample(metadata, seq_ids, params,
                                            logprobs_dev, row, is_prompt)
            else:
                if is_prompt:
                    for i in range(params.best_of):
                        token = int(random[row, i])
                        lp = self._topk_logprobs(
                            topk_vals, topk_idx, row, params, token,
                            float(lp_random[row, i]))
                        samples.append(SequenceOutput(
                            seq_ids[0], token, lp,
                            metadata.output_metadata.get(seq_ids[0])))
                else:
                    for offset, seq_id in enumerate(seq_ids):
                        token = int(random[row + offset, 0])
                        lp = self._topk_logprobs(
                            topk_vals, topk_idx, row + offset, params,
                            token, float(lp_random[row + offset, 0]))
                        samples.append(SequenceOutput(
                            seq_id, token, lp,
                            metadata.output_metadata.get(seq_id)))
            row += len(seq_ids)
            outputs.append(SequenceGroupOutput(samples,
                                               group_prompt_logprobs))
        return outputs

    def _beam_sample(self, metadata, seq_ids, params, logprobs_dev, row,
                     is_prompt) -> List[SequenceOutput]:
        """Beam search select (reference `_beam_search_sample`,
        `sampler.py:462-527`): 2*best_of candidates. Transfers only this
        group's logprob rows."""
        beam_width = params.best_of
        out_meta = metadata.output_metadata

        def mk(seq_id, token, row_np):
            lp = self._full_top_logprobs(row_np, params.logprobs, token)
            return SequenceOutput(seq_id, token, lp, out_meta.get(seq_id))

        if is_prompt:
            lp = np.asarray(logprobs_dev[row])
            top_idx = np.argpartition(-lp, 2 * beam_width)[:2 * beam_width]
            top_idx = top_idx[np.argsort(-lp[top_idx])]
            return [mk(seq_ids[0], int(tok), lp) for tok in top_idx]

        seq_lp = np.asarray(logprobs_dev[row:row + len(seq_ids)])
        cum = np.asarray([
            metadata.seq_data[sid].cumulative_logprob for sid in seq_ids
        ])
        flat = (seq_lp + cum[:, None]).reshape(-1)
        top_idx = np.argpartition(-flat, 2 * beam_width)[:2 * beam_width]
        top_idx = top_idx[np.argsort(-flat[top_idx])]
        vocab = seq_lp.shape[-1]
        return [
            mk(seq_ids[int(i) // vocab], int(i) % vocab,
               seq_lp[int(i) // vocab]) for i in top_idx
        ]

    @staticmethod
    def _topk_logprobs(topk_vals: np.ndarray, topk_idx: np.ndarray,
                       row: int, params, sampled_token: int,
                       sampled_lp: float) -> Dict[int, float]:
        """Top-n logprobs dict from the device-side top-k, always
        including the sampled token (reference `_get_logprobs`)."""
        result = {sampled_token: sampled_lp}
        n = params.logprobs or 0
        for k in range(min(n, topk_idx.shape[-1])):
            result[int(topk_idx[row, k])] = float(topk_vals[row, k])
        return result

    @staticmethod
    def _full_top_logprobs(row: np.ndarray, num_logprobs: Optional[int],
                           sampled_token: int) -> Dict[int, float]:
        """Top-n over a full host row (beam / prompt-logprobs paths)."""
        result = {sampled_token: float(row[sampled_token])}
        if num_logprobs:
            num_logprobs = min(num_logprobs, row.shape[-1] - 1)
            top_idx = np.argpartition(-row, num_logprobs)[:num_logprobs]
            for tok in top_idx:
                result[int(tok)] = float(row[tok])
        return result
