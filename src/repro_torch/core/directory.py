"""Striped, replicated block-metadata directory (the fabric's lookup state).

The port's own copy of ``repro/core/directory.py``.

Before striping, the block directory -- ``block_hash -> n_chunks`` for every
block believed stored -- was one host-side dict consulted for free and
immune to churn: the last omniscient-oracle piece of the protocol.  Here
it becomes fabric state, like the chunks it describes:

* every block's entry lives on a *stripe* whose home server is derived
  from the block hash (``stripe_of``, the metadata analogue of
  ``chunking.chunk_server``), replicated ``dir_replication`` times with
  the same ``replica_delta`` plane-diverse geometry as chunk replicas;
* the stripe homes are resolved through the live ``server_map``, so
  rotation migration moves a stripe's entries along with the server
  whose satellite hosts them;
* a satellite death destroys its shard (``drop``) exactly like its
  chunk store -- lookups fall through the surviving stripe replicas
  (priced, degraded), and ``ConstellationKVC.reconcile`` rebuilds lost
  shards from surviving replicas plus per-satellite chunk inventories.

Shards are deliberately NOT stored inside ``SatelliteStore``: chunk
stores hold data bytes subject to LRU capacity eviction, while directory
entries are metadata that must never be displaced by data pressure --
they are only ever destroyed by the satellite dying.
"""
from __future__ import annotations

from repro_torch.core.constellation import Sat


def stripe_of(block_hash: bytes, num_servers: int) -> int:
    """Hash-derived directory stripe (virtual server id) owning a
    block's metadata entry."""
    return int.from_bytes(block_hash[:8], "big") % num_servers


class StripedDirectory:
    """Per-satellite metadata shards: ``sat -> {block_hash: n_chunks}``.

    This class is pure storage; the owning ``ConstellationKVC`` does the
    geometry (which satellites home a stripe's replicas) and the pricing
    (directory ops run on the ``IslTransport`` like any chunk op).
    """

    def __init__(self) -> None:
        self._shards: dict[Sat, dict[bytes, int]] = {}

    def shard(self, sat: Sat) -> dict[bytes, int]:
        """The (mutable) shard hosted by ``sat``, created on first use."""
        return self._shards.setdefault(sat, {})

    def shard_len(self, sat: Sat) -> int:
        """Entry count of ``sat``'s shard without creating one."""
        return len(self._shards.get(sat, ()))

    def drop(self, sat: Sat) -> int:
        """``sat`` died: its shard's entries are destroyed (metadata is
        fabric state -- it does not outlive its host).  Returns the
        number of entries lost."""
        shard = self._shards.pop(sat, None)
        return 0 if shard is None else len(shard)

    def entries(self) -> dict[bytes, int]:
        """Merged view over every surviving shard (control-plane only:
        data-plane lookups must go through the priced stripe walk)."""
        merged: dict[bytes, int] = {}
        for shard in self._shards.values():
            merged.update(shard)
        return merged
