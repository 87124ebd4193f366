"""Port parity: kubeshare_tpu_torch.serving.drafter against
kubeshare_tpu.serving.drafter.

The host drafter's proposals (with and without a hint window) and the
vectorised device proposer's drafts must equal JAX's exactly, on random
windows drawn from a small vocabulary (so suffixes repeat), random caps
and n-gram orders 1-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.serving.drafter import NGramDrafter as JaxDrafter
from kubeshare_tpu.serving.drafter import \
    ngram_propose_rows as jax_propose_rows
from kubeshare_tpu_torch.serving import NGramDrafter, ngram_propose_rows

torch.set_num_threads(1)


@pytest.mark.parametrize("max_order", [1, 2, 3])
def test_propose_equals_jax(max_order):
    rng = np.random.default_rng(max_order)
    proposals = 0
    for case in range(60):
        history = rng.integers(0, 4, int(rng.integers(0, 24))).tolist()
        hint = (rng.integers(0, 4, int(rng.integers(1, 30))).tolist()
                if case % 2 else None)
        ours = NGramDrafter(max_order, history)
        ref = JaxDrafter(max_order, history)
        if hint is not None:
            ours.hint(hint)
            ref.hint(hint)
        assert ours.hint_window == ref.hint_window
        for k in (0, 1, 3, 5):
            got = ours.propose(k)
            assert got == ref.propose(k), (history, hint, k)
            proposals += bool(got)
        extra = rng.integers(0, 4, 3).tolist()
        ours.extend(extra)
        ref.extend(extra)
        assert ours.history == ref.history
        assert ours.propose(4) == ref.propose(4)
    assert proposals > 60  # the small vocabulary makes suffixes repeat


def test_hint_is_searched_when_the_history_misses():
    drafter = NGramDrafter(2, [5, 6, 7])
    assert drafter.propose(3) == []
    drafter.hint([9, 6, 7, 1, 2, 3])
    assert drafter.propose(3) == [1, 2, 3]
    with pytest.raises(ValueError, match="max_order"):
        NGramDrafter(0)


@pytest.mark.parametrize("max_order,width", [(1, 4), (2, 3), (3, 4), (3, 1)])
def test_propose_rows_equal_jax(max_order, width):
    rng = np.random.default_rng(10 * max_order + width)
    s, h = 16, 24
    hist = rng.integers(0, 5, (s, h))
    hist_len = rng.integers(0, h + 1, s)
    hist_len[:3] = (h, 0, 1)
    caps = rng.integers(-1, width + 2, s)
    hist[np.arange(h)[None, :] < (h - hist_len)[:, None]] = 0  # left pad
    want = jax_propose_rows(jnp.asarray(hist, jnp.int32),
                            jnp.asarray(hist_len, jnp.int32),
                            jnp.asarray(caps, jnp.int32), max_order, width)
    got = ngram_propose_rows(torch.from_numpy(hist),
                             torch.from_numpy(hist_len),
                             torch.from_numpy(caps), max_order, width)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[1].sum()) > 0


def test_propose_rows_follow_the_host_drafter():
    # a full-length window and an uncapped budget: the device proposer is
    # the host drafter's rule without the hint
    rng = np.random.default_rng(4)
    rows = [rng.integers(0, 3, 12).tolist() for _ in range(8)]
    hist = torch.tensor(rows)
    draft, n = ngram_propose_rows(hist, torch.full((8,), 12),
                                  torch.full((8,), 4), 3, 4)
    for i, row in enumerate(rows):
        assert draft[i, : int(n[i])].tolist() == NGramDrafter(3, row).propose(4)
