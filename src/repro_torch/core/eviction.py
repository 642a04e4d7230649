"""The shared recency policy every cache tier consults: the port's own copy
of ``repro/core/eviction.py``'s ``LRUClock``."""
from __future__ import annotations

import itertools
from typing import Hashable, Iterable


class LRUClock:
    """One monotonic recency clock shared across cache tiers.

    Every tier that has to pick a victim -- the serving layer's L1 host
    page cache, the §3.10 radix block index, and the per-satellite chunk
    stores (L2) -- stamps accesses on the *same* clock, so "least
    recently used" means the same thing everywhere: a block kept hot by
    radix prefix hits at the LLM host is not evicted first by a satellite
    store that never saw those lookups, and an offloaded sequence's host
    pages age against the same timeline as constellation blocks.

    Keys are arbitrary hashables (block hashes for L2/radix, sequence
    keys for L1); the clock never dereferences them.  An unknown key has
    recency 0 -- older than anything ever touched.

    Scale-out clusters stamp this clock from several replica threads at
    once, so the tick is drawn from an ``itertools.count`` (atomic under
    CPython) rather than a read-modify-write counter.
    """

    def __init__(self) -> None:
        self._counter = itertools.count(1)
        self._stamp: dict[Hashable, int] = {}

    def __len__(self) -> int:
        return len(self._stamp)

    def touch(self, key: Hashable) -> int:
        """Stamp an access; returns the new clock value."""
        stamp = next(self._counter)
        self._stamp[key] = stamp
        return stamp

    def recency(self, key: Hashable) -> int:
        """Last access stamp (0 = never touched / forgotten)."""
        return self._stamp.get(key, 0)

    def victim(self, keys: Iterable[Hashable]) -> Hashable | None:
        """The least-recently-used key among ``keys`` (stable: the first
        minimal entry wins, so callers iterating in insertion order keep
        FIFO behavior for never-touched keys)."""
        best, best_r = None, None
        for k in keys:
            r = self.recency(k)
            if best_r is None or r < best_r:
                best, best_r = k, r
        return best

    def forget(self, key: Hashable) -> None:
        self._stamp.pop(key, None)
