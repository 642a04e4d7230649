"""Per-satellite chunk store with LRU eviction (paper §3.9).

The port's own copy of ``repro/core/store.py``.

Each satellite hosts an in-memory hashtable keyed by ``(block_hash,
chunk_id)``.  Under memory pressure the least-recently-used chunk is evicted;
an eviction callback lets the owning constellation propagate the eviction
(gossip / lazy policies live in ``eviction.py``).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

ChunkKey = tuple[bytes, int]  # (block_hash, chunk_id)
# (store, victim key, victim bytes): the value rides along because the
# owner may need to spill it to a lower tier -- by callback time it is
# already out of the store, so this is the last reference
EvictionCallback = Callable[["SatelliteStore", ChunkKey, bytes], None]


@dataclass
class StoreStats:
    hits: int = 0
    misses: int = 0
    sets: int = 0
    evictions: int = 0
    bytes_stored: int = 0


@dataclass
class SatelliteStore:
    """LRU key-value store for KVC chunks on one satellite.

    ``policy`` is an optional shared recency clock (``core.eviction.
    LRUClock``, keyed by block hash): when present, victim selection uses
    the *cross-tier* recency stamp instead of this store's private
    insertion order, so radix prefix hits and presence probes at the LLM
    host count as uses here too.  Without it the store falls back to its
    own OrderedDict LRU (seed behavior).
    """

    capacity_bytes: int | None = None
    on_evict: EvictionCallback | None = None
    policy: object | None = None
    _data: OrderedDict = field(default_factory=OrderedDict)
    stats: StoreStats = field(default_factory=StoreStats)

    def __len__(self) -> int:
        return len(self._data)

    @property
    def used_bytes(self) -> int:
        return self.stats.bytes_stored

    def set(self, key: ChunkKey, value: bytes) -> None:
        if key in self._data:
            self.stats.bytes_stored -= len(self._data[key])
            del self._data[key]
        self._data[key] = value
        self.stats.bytes_stored += len(value)
        self.stats.sets += 1
        if self.policy is not None:
            self.policy.touch(key[0])
        self._enforce_capacity()

    def get(self, key: ChunkKey) -> bytes | None:
        if key not in self._data:
            self.stats.misses += 1
            return None
        self._data.move_to_end(key)  # LRU touch
        if self.policy is not None:
            self.policy.touch(key[0])
        self.stats.hits += 1
        return self._data[key]

    def contains(self, key: ChunkKey) -> bool:
        return key in self._data

    def peek(self, key: ChunkKey) -> bytes | None:
        """Read without side effects: no LRU promotion, no policy stamp,
        no hit/miss accounting.  Control-plane movers (rotation
        migration, repair) use this so shuffling a cold chunk between
        satellites does not make it look recently *used* and scramble
        eviction order."""
        return self._data.get(key)

    def touch(self, key: ChunkKey) -> None:
        """Stamp ``key`` as used without reading it.  Presence probes
        (``has_block``'s chunk-0 check) go through ``contains``, which --
        by design -- does not move the LRU clock; before this hook
        existed, a block confirmed present over and over by lookups still
        aged as if untouched and was evicted first (the LRU-clock
        staleness fixed alongside the shared policy)."""
        if key in self._data:
            self._data.move_to_end(key)
            if self.policy is not None:
                self.policy.touch(key[0])

    def delete(self, key: ChunkKey) -> bool:
        if key in self._data:
            self.stats.bytes_stored -= len(self._data[key])
            del self._data[key]
            return True
        return False

    def keys(self) -> list[ChunkKey]:
        return list(self._data.keys())

    def inventory(self) -> dict[bytes, list[int]]:
        """Anti-entropy inventory report: ``block_hash -> chunk ids``
        this satellite holds.  Read-only like ``peek`` -- no recency
        stamps, no hit/miss accounting -- so a ``reconcile`` pass over a
        healthy fabric leaves eviction order untouched."""
        inv: dict[bytes, list[int]] = {}
        for block_hash, cid in self._data:
            inv.setdefault(block_hash, []).append(cid)
        return inv

    def pop_all(self) -> list[tuple[ChunkKey, bytes]]:
        """Drain the store (used by rotation migration)."""
        items = list(self._data.items())
        self._data.clear()
        self.stats.bytes_stored = 0
        return items

    def _enforce_capacity(self) -> None:
        if self.capacity_bytes is None:
            return
        order = None
        while self.stats.bytes_stored > self.capacity_bytes and self._data:
            if self.policy is not None:
                # cross-tier LRU: coldest block-hash stamp first; ties
                # fall back to this store's insertion order.  The order is
                # computed ONCE per enforcement (recency only changes via
                # the evictions themselves), so displacing k chunks costs
                # one O(n log n) sort, not k O(n) scans -- and on_evict
                # typically purges the victim's sibling chunks too, so a
                # stale entry in the order is just skipped.
                if order is None:
                    order = iter(sorted(
                        self._data, key=lambda k: self.policy.recency(k[0])))
                key = next((k for k in order if k in self._data), None)
                if key is None:
                    order = None
                    continue
                value = self._data.pop(key)
            else:
                key, value = self._data.popitem(last=False)  # LRU out
            self.stats.bytes_stored -= len(value)
            self.stats.evictions += 1
            if self.on_evict is not None:
                self.on_evict(self, key, value)
