"""Self-drafting n-gram (prompt-lookup) token drafter.

No second model: each request drafts against its OWN token history.
The last n-gram of (prompt + output so far) is matched against every
earlier position in the same stream; on a hit, the tokens that
followed the earlier occurrence are proposed as the draft suffix.
Repetitive traffic (code, multi-turn chat with quoting, structured
output) pays off; adversarial traffic degrades to a single probe
token per round via an acceptance EWMA back-off, so the worst case
is one extra verify row, never a stall.

The drafter runs on the host between engine rounds — it is on the
step path (aphrocheck's SYNC family treats every function in this
module as hot), so everything here is plain-Python list work: no
device values, no numpy round trips.

Acceptance bookkeeping is per sequence: `observe()` folds each
round's accepted/proposed ratio into an EWMA (initialised to 1.0 so
new streams draft at full width), and `propose()` scales the draft
width by it. Below ``APHRODITE_SPEC_BACKOFF`` the width collapses to
a single probe token — the probe keeps feeding `observe()`, so a
stream whose tail becomes predictable again recovers on its own.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from aphrodite_tpu_torch.common import flags

#: Per-sequence acceptance state is bounded: aborted requests never
#: call `forget()`, so the table self-prunes past this many entries.
_MAX_TRACKED_SEQS = 8192

#: EWMA smoothing for the per-round acceptance ratio.
_EWMA_ALPHA = 0.5


class NgramDrafter:
    """Prompt-lookup drafter with per-sequence adaptive back-off."""

    def __init__(self) -> None:
        # seq_id -> acceptance EWMA in [0, 1]; insertion-ordered so
        # overflow pruning drops the oldest streams first.
        self._ewma: Dict[int, float] = {}

    def _width(self, seq_id: int, k: int) -> int:
        """Draft width for this round: ``k`` scaled by the sequence's
        acceptance EWMA, collapsing to a single probe token below the
        back-off threshold."""
        ewma = self._ewma.get(seq_id, 1.0)
        if ewma < flags.get_float("APHRODITE_SPEC_BACKOFF"):
            return 1
        return max(1, int(round(k * ewma)))

    def propose(self, seq_id: int, token_ids: Sequence[int],
                k: int) -> List[int]:
        """Propose up to ``k`` draft tokens for ``seq_id``.

        Matches the longest suffix n-gram (``APHRODITE_SPEC_NGRAM_MAX``
        down to ``APHRODITE_SPEC_NGRAM_MIN``) of ``token_ids`` — the
        request's joint prompt+output history, which is exactly what a
        mid-stream resume replays, so resumed streams re-draft
        identically — against every earlier position, most recent
        occurrence first. Returns ``[]`` when no n-gram recurs."""
        k = min(k, self._width(seq_id, k))
        n_max = flags.get_int("APHRODITE_SPEC_NGRAM_MAX")
        n_min = flags.get_int("APHRODITE_SPEC_NGRAM_MIN")
        history = list(token_ids)
        size = len(history)
        for n in range(min(n_max, size - 1), n_min - 1, -1):
            suffix = history[size - n:]
            # Most recent earlier occurrence wins; the continuation
            # may overlap the suffix itself (periodic streams), and
            # when the copy source runs off the end of history it
            # wraps into the draft built so far — a period-p stream
            # drafts the full width even when p < k.
            for start in range(size - n - 1, -1, -1):
                if history[start:start + n] == suffix:
                    src = start + n
                    draft: List[int] = []
                    for i in range(k):
                        idx = src + i
                        draft.append(history[idx] if idx < size
                                     else draft[idx - size])
                    return draft
        return []

    def observe(self, seq_id: int, proposed: int, accepted: int) -> None:
        """Fold one verify round's outcome into the acceptance EWMA."""
        if proposed <= 0:
            return
        ratio = min(1.0, max(0.0, accepted / proposed))
        prev = self._ewma.get(seq_id, 1.0)
        # Re-insert so the table stays recency-ordered for pruning.
        self._ewma.pop(seq_id, None)
        self._ewma[seq_id] = prev + _EWMA_ALPHA * (ratio - prev)
        while len(self._ewma) > _MAX_TRACKED_SEQS:
            self._ewma.pop(next(iter(self._ewma)))

    def forget(self, seq_id: int) -> None:
        """Drop per-sequence state once the stream finishes."""
        self._ewma.pop(seq_id, None)
