"""Self-drafting n-gram / prompt-lookup drafter for the serving engine,
port of kubeshare_tpu/serving/drafter.py.

Each decode lane drafts from text it has already seen: the longest
suffix of its own prompt + generated history is looked up for an earlier
occurrence, and the tokens that followed it become the draft
(prompt-lookup decoding).  Every proposal is verified against the target
model's own picks in one width-W dispatch (``paged.paged_verify_span``),
so a draft can never change a stream, only how many tokens a dispatch
emits.  The rules:

- the LONGEST matching suffix wins (``max_order`` down to 1) and, within
  an order, the MOST RECENT earlier occurrence;
- the primary window is the lane's prompt + generated history; a
  secondary HINT window (on cache-hit lanes: the prompt plus the radix
  trie's cached continuation of it) is searched at the same order when
  the primary misses;
- the state is a token list, rebuilt from ``prompt + generated`` on
  preemption-resume, so a resumed lane drafts from the window an
  unpreempted lane would.

:class:`NGramDrafter` is the engine's host drafter;
:func:`ngram_propose_rows` is its tensor twin, which the speculative
device loop (``paged.paged_spec_loop``) runs inside a CUDA graph: a
static loop over orders, no value read back to the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


class NGramDrafter:
    """One lane's drafting state: a token history window plus the
    suffix-lookup proposer (a plain backward scan: histories are bounded
    by the engine's ``max_request_len``)."""

    def __init__(self, max_order: int = 3,
                 history: Optional[Sequence[int]] = None) -> None:
        if max_order < 1:
            raise ValueError(f"max_order must be >= 1, got {max_order}")
        self.max_order = max_order
        self._history: List[int] = []
        self._hint: List[int] = []
        if history is not None:
            self.extend(history)

    @property
    def history(self) -> List[int]:
        """The primary lookup window (prompt + generated so far)."""
        return list(self._history)

    @property
    def hint_window(self) -> Optional[List[int]]:
        """The secondary lookup window, or None when none was installed."""
        return list(self._hint) if self._hint else None

    def extend(self, tokens: Sequence[int]) -> None:
        """Append emitted (verified) tokens to the lookup window."""
        self._history.extend(int(t) for t in tokens)

    def hint(self, tokens: Sequence[int]) -> None:
        """Install the secondary lookup window, searched only when the
        lane's own history has no occurrence of the current suffix."""
        self._hint = [int(t) for t in tokens]

    def propose(self, k: int) -> List[int]:
        """Up to ``k`` drafted tokens continuing the current history, or
        [] when no suffix of any order has an earlier occurrence.
        Longest suffix wins across orders; within an order the lane's own
        history beats the hint, and the most recent occurrence beats
        older ones."""
        if k < 1:
            return []
        h = self._history
        for order in range(min(self.max_order, len(h) - 1), 0, -1):
            pattern = h[-order:]
            found = self._find(h, pattern, k)
            if not found:
                found = self._find(self._hint, pattern, k)
            if found:
                return found
        return []

    @staticmethod
    def _find(seq: List[int], pattern: List[int], k: int) -> List[int]:
        """Most recent occurrence of ``pattern`` in ``seq`` with at least
        one following token; returns up to ``k`` followers.  The scan
        starts at ``len - order - 1``, so the history's own current suffix
        is never the match."""
        order = len(pattern)
        for i in range(len(seq) - order - 1, -1, -1):
            if seq[i: i + order] == pattern:
                return seq[i + order: i + order + k]
        return []


def ngram_propose_rows(hist: torch.Tensor, hist_len: torch.Tensor,
                       caps: torch.Tensor, max_order: int,
                       width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vectorised twin of :meth:`NGramDrafter.propose`, the drafting
    step of the speculative device loop.

    ``hist`` [S, H] holds every lane's RIGHT-ALIGNED token-history window
    (newest token at column H-1; only the last ``hist_len[s]`` columns
    are real), ``caps`` [S] the per-lane draft budget.  Returns (draft
    [S, width], n_draft [S]): up to ``width`` proposed tokens per lane,
    -1 past ``n_draft[s]``.  The selection rule is the host drafter's,
    order for order; the window is the bounded device window and there
    is no hint window (the trie lives on the host), which moves only the
    acceptance rate, never a stream."""
    s, h = hist.shape
    device = hist.device
    draft = torch.full((s, width), -1, dtype=hist.dtype, device=device)
    n_draft = torch.zeros((s,), dtype=hist.dtype, device=device)
    col = torch.arange(width, device=device)[None, :]
    for order in range(max_order, 0, -1):
        if h < order + 2:
            continue
        # candidate starts p in [0, h-order-1]: window [p, p+order) with a
        # follower at p+order <= h-1; the suffix's own start h-order is
        # excluded by construction
        starts = torch.arange(h - order, device=device)
        windows = hist.unfold(1, order, 1)[:, : h - order]  # [S, h-o, o]
        pattern = hist[:, h - order:]  # [S, order]
        match = (windows == pattern[:, None, :]).all(dim=-1)
        # the whole candidate window must lie in the lane's real history
        match = match & (starts[None, :] >= (h - hist_len)[:, None])
        best = torch.where(match, starts[None, :],
                           torch.full_like(match, -1, dtype=hist.dtype)
                           ).amax(dim=1)
        found = best >= 0
        fstart = best.clamp(min=0) + order  # first follower column
        n = torch.minimum(torch.minimum(h - fstart, caps),
                          torch.full_like(caps, width))
        n = torch.where(found, n.clamp(min=0), torch.zeros_like(n))
        idx = (fstart[:, None] + col).clamp(0, h - 1)
        cand = torch.gather(hist, 1, idx)
        cand = torch.where(col < n[:, None], cand, torch.full_like(cand, -1))
        use = (n_draft == 0) & (n > 0)
        draft = torch.where(use[:, None], cand, draft)
        n_draft = torch.where(use, n, n_draft)
    return draft, n_draft
