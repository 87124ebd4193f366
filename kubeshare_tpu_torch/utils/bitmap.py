"""Round-robin bitmap used as the per-node pod-manager port pool.

The port's own copy of kubeshare_tpu/utils/bitmap.py (the port imports
nothing of the JAX package).

Behavioral parity with the reference allocator (ref pkg/lib/bitmap/
bitmap.go:11-51, rrbitmap.go:17-43): allocation is round-robin starting
after the most recently granted index and exhaustion returns -1.  As in the
reference, the pool *creator* masks index 0 (so the first granted port is
base+1; ref node.go:38-39) — the bitmap itself reserves nothing.

Implemented with a Python int as the bit store (arbitrary precision) rather
than a uint64 slice — same observable behavior, no manual word management.
"""

from __future__ import annotations


class Bitmap:
    """Growable bitmap over non-negative indices."""

    def __init__(self) -> None:
        self._bits = 0

    def is_masked(self, pos: int) -> bool:
        return bool(self._bits >> pos & 1)

    def mask(self, pos: int) -> None:
        self._bits |= 1 << pos

    def unmask(self, pos: int) -> None:
        self._bits &= ~(1 << pos)

    def clear(self) -> None:
        self._bits = 0

    def count_masked_below(self, length: int) -> int:
        """Popcount of the first ``length`` positions."""
        return (self._bits & ((1 << length) - 1)).bit_count()

    def find_next_and_set(self) -> int:
        pos = 0
        bits = self._bits
        while bits & 1:
            bits >>= 1
            pos += 1
        self.mask(pos)
        return pos


class RRBitmap:
    """Fixed-capacity round-robin bitmap; scans forward from the last grant."""

    def __init__(self, length: int) -> None:
        self._bitmap = Bitmap()
        self._length = length
        self._current = 0

    @property
    def capacity(self) -> int:
        return self._length

    def find_next_from_current(self) -> int:
        """Next free index in round-robin order, without claiming it; -1 if full."""
        for i in range(self._current, self._current + self._length):
            ii = i % self._length
            if not self._bitmap.is_masked(ii):
                return ii
        return -1

    def has_free(self) -> bool:
        """O(1) pool-not-full check (popcount), for the Filter hot path —
        find_next_from_current is an O(length) scan per call."""
        return self._bitmap.count_masked_below(self._length) < self._length

    def find_next_from_current_and_set(self) -> int:
        """Claim and return the next free index in round-robin order; -1 if full."""
        for i in range(self._current, self._current + self._length):
            ii = i % self._length
            if not self._bitmap.is_masked(ii):
                self._bitmap.mask(ii)
                self._current = ii + 1
                return ii
        return -1

    def is_masked(self, pos: int) -> bool:
        return self._bitmap.is_masked(pos)

    def mask(self, pos: int) -> None:
        self._bitmap.mask(pos)

    def unmask(self, pos: int) -> None:
        self._bitmap.unmask(pos)

    def clear(self) -> None:
        self._bitmap.clear()
        self._current = 0
