"""Modified rejection sampling for speculative decoding (port of
`aphrodite_tpu/modeling/layers/rejection.py`).

The engine's self-drafting path (processing/drafter.py +
ModelRunner.execute_spec_verify) uses the delta-proposal form,
`delta_rejection_length`: an n-gram drafter proposes a point mass
q = one-hot(draft), for which the accept / recover rule collapses to
"the target's sample equals the draft". That emits the target's
distribution, and greedy and seeded streams equal classic decode.

`rejection_sample` is the general form over [batch, k, vocab]
probability tensors (arXiv:2302.01318), kept for model-drafted
proposals. It draws its uniforms and its Gumbel noise with the port's
threefry (`prng.py`) from a JAX-style key [2], split as
`jax.random.split` splits one, so a JAX key's draws are reproduced.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from aphrodite_tpu_torch.modeling.layers import prng


def delta_rejection_length(sampled: Sequence[int],
                           drafted: Sequence[int]) -> int:
    """Accepted-prefix length for a point-mass draft distribution.

    With q = one-hot(d_j), accepting d_j with probability p(d_j) and
    otherwise drawing from norm(max(0, p - q)) (p restricted to tokens
    != d_j) is the same as drawing s_j ~ p and accepting iff s_j == d_j.
    The verify step samples every row from the target with the row's
    own positional salt; this counts the matched prefix on the host.
    The emitted tokens are the accepted drafts plus the first-mismatch
    sample, or the bonus sample on full acceptance."""
    n = 0
    for s, d in zip(sampled, drafted):
        if int(s) != int(d):
            break
        n += 1
    return n


def split_key(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` under partitionable threefry: key i
    is threefry of the counter pair (0, i), i.e. fold_in(key, i)."""
    keys = key.reshape(1, 2).expand(num, 2)
    return prng.fold_in(keys, torch.arange(num, dtype=torch.int64,
                                           device=key.device))


def _categorical(key: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Sample from the trailing-axis distribution via the Gumbel trick
    (probs may hold zeros; the log is floored)."""
    logits = torch.log(torch.clamp(probs, min=1e-38))
    gumbel = prng.gumbel(key.reshape(1, 2), tuple(probs.shape))[0]
    return torch.argmax(logits + gumbel, dim=-1)


def rejection_sample(
    key: torch.Tensor,                # [2] JAX key words (uint32 in int64)
    target_probs: torch.Tensor,       # [batch, k, vocab] f32
    bonus_token_ids: torch.Tensor,    # [batch] int
    draft_probs: torch.Tensor,        # [batch, k, vocab] f32
    draft_token_ids: torch.Tensor,    # [batch, k] int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accept/reject k speculative tokens per sequence.

    Returns (output_token_ids [batch, k+1] int32, num_accepted [batch]).
    Position j emits the draft token while every earlier draft was
    accepted, the token drawn from the recovered distribution
    norm(max(0, p_target - p_draft)) at the first rejection, and -1
    after it. If every draft is accepted, the bonus token fills slot k."""
    batch, k, _ = target_probs.shape
    key_u, key_r = split_key(key)
    draft = draft_token_ids.long()

    # Acceptance: u < p_target(tok) / p_draft(tok).
    p_t = torch.gather(target_probs, -1, draft[..., None])[..., 0]
    p_d = torch.gather(draft_probs, -1, draft[..., None])[..., 0]
    u = prng.uniform(key_u.reshape(1, 2), (batch, k))[0]
    accepted = u * torch.clamp(p_d, min=1e-38) < p_t          # [batch, k]

    # Recovered distribution at each position (used only at the first
    # rejection); an all-zero difference falls back to the target.
    diff = torch.clamp(target_probs - draft_probs, min=0.0)
    denom = diff.sum(dim=-1, keepdim=True)
    recovered = torch.where(denom > 0,
                            diff / torch.clamp(denom, min=1e-38),
                            target_probs)
    recovered_ids = _categorical(key_r, recovered)            # [batch, k]

    all_prev = torch.cumprod(accepted.to(torch.int32), dim=-1)
    num_accepted = all_prev.sum(dim=-1).to(torch.int32)       # [batch]
    idx = torch.arange(k, device=target_probs.device)[None, :]
    keep_draft = idx < num_accepted[:, None]
    is_first_reject = idx == num_accepted[:, None]
    minus_one = torch.full_like(draft, -1)
    tokens_k = torch.where(keep_draft, draft,
                           torch.where(is_first_reject, recovered_ids,
                                       minus_one))
    bonus = torch.where(num_accepted == k, bonus_token_ids.long(),
                        torch.full_like(bonus_token_ids.long(), -1))
    out = torch.cat([tokens_k, bonus[:, None]], dim=1).to(torch.int32)
    return out, num_accepted
