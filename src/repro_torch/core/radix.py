"""Local radix block index (paper §3.10).

The port's own copy of ``repro/core/radix.py``.

A path-compressed radix tree over *block hash sequences*, kept at the LLM
host.  It answers longest-prefix lookups without touching the constellation
and stores per-block metadata (chunk count, set time) from which the current
chunk locations are computable (rotation is predictable, §3.10).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass
class BlockMeta:
    """Metadata stored for one cached block (paper §3.10).

    ``stored=False`` marks a Set KVC that failed to land a single copy
    of some chunk (total outage on a stripe member): the write is NOT in
    the constellation directory, and callers must not index the hash --
    a phantom index entry would re-probe a block that never existed for
    as long as the outage lasts."""

    n_chunks: int
    set_time: float
    payload_bytes: int = 0
    stored: bool = True
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class _Node:
    # Path compression: an edge carries a *sequence* of block hashes.
    edge: tuple[bytes, ...] = ()
    children: dict[bytes, "_Node"] = field(default_factory=dict)
    # meta[i] = metadata for the block ending at edge position i (if cached).
    meta: dict[int, BlockMeta] = field(default_factory=dict)


class RadixBlockIndex:
    """Path-compressed radix tree keyed by chained block hashes.

    ``policy`` is an optional shared recency clock (``core.eviction.
    LRUClock``): every cached block matched by a lookup -- and every
    block inserted -- is stamped on it, so tier victim selection (host
    page cache, satellite stores) sees radix prefix hits as *uses* even
    though they never touch the constellation.  Without the stamp, the
    hottest blocks (the ones the radix answers for locally) look coldest
    to the stores and are evicted first.
    """

    def __init__(self, policy=None) -> None:
        self._root = _Node()
        self._count = 0
        self._policy = policy

    def __len__(self) -> int:
        return self._count

    # ------------------------------------------------------------------
    def insert(self, hashes: Sequence[bytes], metas: Sequence[BlockMeta | None]) -> None:
        """Insert a hash chain; ``metas[i]`` annotates ``hashes[i]`` (None =
        block not cached, path only)."""
        if len(hashes) != len(metas):
            raise ValueError("hashes and metas must align")
        node = self._root
        i = 0
        while i < len(hashes):
            first = hashes[i]
            child = node.children.get(first)
            if child is None:
                child = _Node(edge=tuple(hashes[i:]))
                node.children[first] = child
                for j, m in enumerate(metas[i:]):
                    if m is not None:
                        child.meta[j] = m
                        self._count += 1
                        if self._policy is not None:
                            self._policy.touch(hashes[i + j])
                return
            # Walk the compressed edge.
            edge = child.edge
            k = 0
            while k < len(edge) and i + k < len(hashes) and edge[k] == hashes[i + k]:
                m = metas[i + k]
                if m is not None:
                    if k not in child.meta:
                        self._count += 1
                    child.meta[k] = m
                    if self._policy is not None:
                        self._policy.touch(hashes[i + k])
                k += 1
            if k == len(edge):
                node = child
                i += k
                continue
            # Split the edge at k.
            tail = _Node(
                edge=edge[k:],
                children=child.children,
                meta={p - k: m for p, m in child.meta.items() if p >= k},
            )
            child.edge = edge[:k]
            child.children = {edge[k]: tail}
            child.meta = {p: m for p, m in child.meta.items() if p < k}
            node = child
            i += k
        return

    # ------------------------------------------------------------------
    def longest_cached_prefix(
        self, hashes: Sequence[bytes]
    ) -> tuple[int, BlockMeta | None]:
        """Return (n_blocks, meta) for the longest prefix of ``hashes`` whose
        final block has cached metadata; (0, None) when nothing matches."""
        best_len, best_meta = 0, None
        node = self._root
        i = 0
        while i < len(hashes):
            child = node.children.get(hashes[i])
            if child is None:
                break
            edge = child.edge
            k = 0
            while k < len(edge) and i + k < len(hashes) and edge[k] == hashes[i + k]:
                if k in child.meta:
                    best_len, best_meta = i + k + 1, child.meta[k]
                    if self._policy is not None:
                        self._policy.touch(hashes[i + k])
                k += 1
            if k < len(edge):
                break
            node = child
            i += k
        return best_len, best_meta

    def get(self, hashes: Sequence[bytes]) -> BlockMeta | None:
        """Exact-match metadata for the block ending the given chain."""
        n, meta = self.longest_cached_prefix(hashes)
        return meta if n == len(hashes) else None

    def remove(self, hashes: Sequence[bytes]) -> bool:
        """Remove the metadata of the block ending the chain (lazy eviction)."""
        node = self._root
        i = 0
        while i < len(hashes):
            child = node.children.get(hashes[i])
            if child is None:
                return False
            edge = child.edge
            k = 0
            while k < len(edge) and i + k < len(hashes) and edge[k] == hashes[i + k]:
                k += 1
            if i + k == len(hashes) and k >= 1 and (k - 1) in child.meta:
                del child.meta[k - 1]
                self._count -= 1
                if self._policy is not None:
                    self._policy.forget(hashes[-1])
                return True
            if k < len(edge):
                return False
            node = child
            i += k
        return False
