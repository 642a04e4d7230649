"""Eviction policies (paper §3.9): the port's own copy of
``repro/core/eviction.py``.

Three policies over ``ConstellationKVC``:

* **gossip**  -- an LRU eviction of one chunk triggers an immediate
  neighborhood broadcast purging the block's remaining chunks (the default
  wired into ``ConstellationKVC._on_evict`` -> ``purge_block``).  The
  concentric-ring placement keeps all affected chunks in the immediate
  neighborhood, so a simple broadcast in all directions suffices.
* **lazy**    -- nothing is propagated; a later ``get_block`` discovering a
  missing chunk purges the block and notifies the radix index.
* **periodic** -- ``sweep_incomplete`` scans for blocks with missing chunks.

This module adds the shared recency policy every cache tier consults
(``LRUClock``), the gossip *cost model* (how many ISL messages a broadcast
takes), and a helper to run the periodic sweep policy.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Hashable, Iterable

from repro_torch.core.chunking import chunk_server
from repro_torch.core.protocol import ConstellationKVC


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


@dataclass(frozen=True)
class GossipCost:
    messages: int
    max_hops: int


def gossip_cost(kvc: ConstellationKVC, block_hash: bytes) -> GossipCost:
    """Cost of broadcasting an eviction of ``block_hash`` from its chunk-0
    server to every other server holding chunks of the block."""
    n_chunks = kvc.directory.get(block_hash)
    if not n_chunks:
        return GossipCost(messages=0, max_hops=0)
    origin = kvc.server_sat(chunk_server(0, kvc.num_servers))
    targets = {
        kvc.server_sat(chunk_server(cid, kvc.num_servers))
        for cid in range(n_chunks)
    } - {origin}
    hops = [kvc.spec.hops(origin, t) for t in targets]
    return GossipCost(messages=len(targets), max_hops=max(hops, default=0))


def run_periodic_sweep(kvc: ConstellationKVC) -> int:
    """Periodic cleanup policy: purge all incomplete blocks."""
    return kvc.sweep_incomplete()
