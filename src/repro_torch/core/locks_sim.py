"""The host atomic word (copy of `repro.core.locks_sim._AtomicWord`)."""

from __future__ import annotations

import threading


class _AtomicWord:
    """A 64-bit word supporting the three DMAPP AMOs the paper needs."""

    __slots__ = ("v", "_mu", "amo_count")

    def __init__(self) -> None:
        self.v = 0
        self._mu = threading.Lock()
        self.amo_count = 0

    def fetch_add(self, delta: int) -> int:
        with self._mu:
            old = self.v
            self.v = (self.v + delta) & ((1 << 64) - 1)
            self.amo_count += 1
            return old

    def cas(self, expected: int, new: int) -> int:
        with self._mu:
            old = self.v
            if old == expected:
                self.v = new
            self.amo_count += 1
            return old

    def read(self) -> int:
        with self._mu:
            self.amo_count += 1
            return self.v
