"""TieredKVManager: the serving stack's three-level KV fabric, ported
from ``repro/serving/kv_manager.py`` (pure host logic, copied; the page
moves go through the port's ``PagedKVCache``).

* **L0 -- device page pool** (``repro_torch.models.cache.PagedKVCache``): the
  pages decode and chunked prefill read/write in place.  Pages are
  allocated *lazily* as sequences grow (no worst-case reservation), so
  the pool can run more live sequences than it could hold at their
  maximum lengths.
* **L1 -- host-RAM page cache** (``HostPageCache``): preempted
  sequences' pages, exported in one gathered device read per pool.  A
  hit restores bit-identical K/V -- including the non-block-aligned tail
  page -- so a resumed sequence replays nothing.
* **L2 -- the constellation**: any object with ``KVCManager``'s
  interface (``get_cache_tokens``, ``add_blocks_tokens``,
  ``add_precomputed_blocks``, ``block_size``, ``policy``, ``cache``).
  When the host cache overflows, the shared LRU policy picks a victim
  whose *block-aligned* prefix is spilled as Set KVC payloads built
  directly from the exported pages (no model recompute).  A restore that
  misses L1 runs Get KVC on the sequence's exact token chain, drops
  fetched blocks into pool pages, and leaves only the unaligned tail for
  the scheduler to replay through the chunked-prefill path.  On a
  *clocked* fabric (a ``clock`` on the cache's ``transport``) every Get
  completes at a virtual time: ``lookup_prefix`` hands the scheduler a
  ``ready_at`` so it can defer consuming the payload, and ``wait_fetch``
  settles -- and accounts, as ``EngineStats.l2_wait_s`` -- whatever
  flight time could not be hidden.  ``_observe_l2`` attributes the
  fabric's fault counters to this replica's ``EngineStats``.

One ``LRUClock`` (the manager's ``policy``) stamps accesses across the
levels plus the radix index, so "least recently used" is one timeline,
not three.  Admission refusal and pool exhaustion stop being failure
modes: under memory pressure the scheduler calls ``offload`` on a
victim and the fabric absorbs it.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from repro_torch.core.eviction import LRUClock
from repro_torch.models.cache import PagedKVCache
from repro_torch.serving.skycache import SkyKVCAdapter
from repro_torch.serving.stats import EngineStats


@dataclass
class HostEntry:
    """One offloaded sequence's pages in host RAM.

    ``pinned`` entries are exempt from capacity eviction: MoE sequences
    must restore bit-exact from here (replaying their tail as a chunk
    group would re-route experts -- capacity routing is group-composition
    dependent -- and change the rebuilt K/V), so their pages may not be
    spilled-and-dropped the way dense families' can.
    """

    k: object                 # host tensor [layers, n_pages, page, Hkv, hd]
    v: object
    tokens: list[int]         # the tokens those pages cover, in order
    pinned: bool = False
    n_pages: int = field(init=False)

    def __post_init__(self) -> None:
        self.n_pages = int(self.k.shape[1])

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


class HostPageCache:
    """L1: offloaded page sets keyed by sequence, bounded in pages.

    ``capacity_pages=None`` means unbounded (host RAM is the backstop);
    ``0`` disables the tier (every offload spills straight to L2 /
    recompute -- the ablation knob).  Victims are chosen by the shared
    ``LRUClock``; the ``spill`` callback receives each evicted entry
    before it is dropped.
    """

    def __init__(self, capacity_pages: int | None, policy: LRUClock,
                 spill=None) -> None:
        self.capacity_pages = capacity_pages
        self.policy = policy
        self.spill = spill
        self._entries: dict[object, HostEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def used_pages(self) -> int:
        return sum(e.n_pages for e in self._entries.values())

    def put(self, key, entry: HostEntry) -> None:
        self._entries[key] = entry
        self.policy.touch(("l1", key))
        if self.capacity_pages is None:
            return
        while self.used_pages > self.capacity_pages:
            victim = self.policy.victim(
                ("l1", k) for k, e in self._entries.items()
                if not e.pinned)
            if victim is None:
                break             # only pinned entries remain: keep them
            _, vkey = victim
            evicted = self._entries.pop(vkey)
            self.policy.forget(victim)
            if self.spill is not None:
                self.spill(vkey, evicted)

    def pop(self, key) -> HostEntry | None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self.policy.forget(("l1", key))
        return entry


class TieredKVManager:
    """Owns the page pool and moves K/V between the three tiers.

    The scheduler speaks tokens (``*_tokens`` arguments); this class
    translates to pages.  All device writes happen between jitted steps,
    exactly like the pre-tiered engine's page drops.
    """

    def __init__(
        self,
        pool: PagedKVCache,
        adapter: SkyKVCAdapter,
        manager,
        *,
        host_cache_pages: int | None = None,
        write_back: bool = True,
    ) -> None:
        self.pool = pool
        self.adapter = adapter
        self.manager = manager
        self.write_back = write_back
        self.stats = EngineStats()       # facade re-points this per run
        self.policy: LRUClock = (
            manager.policy if manager is not None else LRUClock())
        self.host = HostPageCache(host_cache_pages, self.policy,
                                  spill=self._spill_to_l2)
        self._wb_future = None           # in-flight async Set KVC
        # clocked fabric: L2 Gets complete at a virtual time on the
        # constellation transport's SimClock (None = legacy instant L2)
        self._transport = (None if manager is None
                           else getattr(manager.cache, "transport", None))
        self.clock = None if self._transport is None else self._transport.clock

    # -- L0: lazy page accounting --------------------------------------
    def can_admit_tokens(self, n_tokens: int) -> bool:
        return self.pool.can_admit(n_tokens)

    def reserve(self, slot: int, n_tokens: int) -> bool:
        """Allocate pages for ``n_tokens`` now (admission/restore); True
        when the block table changed."""
        return self.pool.ensure_capacity(slot, n_tokens)

    def try_grow(self, slot: int, n_tokens: int) -> tuple[bool, bool]:
        """Grow ``slot`` to hold ``n_tokens`` tokens if the free list
        allows: ``(ok, table_changed)``.  ``ok=False`` means the pool is
        exhausted -- the scheduler's cue to preempt a victim, never an
        exception."""
        need = self.pool.pages_for(n_tokens)
        have = self.pool.pages_allocated(slot)
        if need <= have:
            return True, False
        if self.pool.free_pages < need - have:
            return False, False
        return True, self.pool.ensure_capacity(slot, n_tokens)

    def release(self, slot: int) -> None:
        self.pool.free_slot(slot)

    # -- preemption-by-offload ------------------------------------------
    def offload(self, key, slot: int, tokens: list[int]) -> int:
        """Export the pages covering ``tokens`` (one gathered read per
        pool) into the host tier under ``key``.  Returns pages moved.
        The slot itself is NOT freed here -- the scheduler releases it,
        keeping page bookkeeping in one place."""
        n_pages = self.pool.pages_for(len(tokens))
        if n_pages == 0:
            return 0
        if self.manager is not None:
            # the spill path mutates the radix index; settle any async
            # write-back first so index updates stay single-threaded
            self.drain_write_back()
        k, v = self.pool.export_pages(slot, n_pages)
        # MoE restores must be bit-exact (tail replay would re-route
        # experts), so their host entries are pinned against eviction
        pinned = self.pool.cfg.num_experts > 0
        self.host.put(key, HostEntry(k=k, v=v, tokens=list(tokens),
                                     pinned=pinned))
        self.stats.offloaded_pages += n_pages
        return n_pages

    def take_host(self, key) -> HostEntry | None:
        """Claim ``key``'s host-tier pages (bit-exact restore source)."""
        return self.host.pop(key)

    def restore(self, key, slot: int, tokens: list[int]) -> int:
        """Repopulate ``slot``'s pages for ``tokens``; returns how many
        leading tokens are covered (the scheduler replays the rest).

        L1 hit: the exact exported pages come back -- full coverage,
        including the unaligned tail page, nothing to replay.  L1 miss:
        Get KVC on the token chain restores the longest block-aligned
        prefix the constellation still holds (possibly spilled there by
        the host tier, possibly written back long ago, possibly gone --
        then the whole sequence replays, the recompute flavor of
        preemption)."""
        entry = self.take_host(key)
        if entry is not None:
            self.pool.write_pages(slot, 0, entry.k, entry.v)
            return min(entry.n_tokens, len(tokens))
        if self.manager is None:
            return 0
        self.drain_write_back()
        if self._transport is not None:
            self._transport.last_ready_at = None
        with self._observe_l2():
            payload, cached = self.manager.get_cache_tokens(tokens)
        if payload is None or not cached:
            return 0
        # a restore is already a stall point: experience the Get's flight
        # time here rather than deferring (nothing else can run for this
        # slot until its pages are back)
        if self._transport is not None:
            self.wait_fetch(self._transport.last_ready_at)
        cached = min(cached, len(tokens))
        k_blocks, v_blocks = self.adapter.payload_to_pages(
            payload, cached, self.pool.page_size)
        self.pool.write_pages(slot, 0, k_blocks, v_blocks)
        return cached

    def _spill_to_l2(self, key, entry: HostEntry) -> None:
        """Host-tier eviction: push the entry's block-aligned prefix to
        the constellation as exact-page payloads (no model recompute);
        the unaligned tail is dropped and recomputed at restore."""
        if self.manager is None:
            return
        bs = self.manager.block_size
        n_blocks = entry.n_tokens // bs
        if n_blocks == 0:
            return
        added = self.manager.add_precomputed_blocks(
            entry.tokens[: n_blocks * bs],
            # tokens let a +delta codec recompute back-pointer hashes,
            # so spilled chains are O(1) bytes per block too
            lambda nb: self.adapter.pages_to_payload(
                entry.k, entry.v, nb * bs,
                tokens=entry.tokens[: n_blocks * bs]),
        )
        self.stats.spilled_blocks += added

    # -- L2: SkyMemory prefix lookups / write-back ----------------------
    @contextmanager
    def _observe_l2(self):
        """Attribute the fabric's fault counters to this replica: any
        degraded reads (dead-replica fallthrough) the wrapped L2 call
        experienced land in ``EngineStats.degraded_reads``, detoured
        chunk ops (killed links rerouted around) in
        ``EngineStats.detoured_ops``, ground-tier answers (every orbital
        replica out, the durable tier served) in
        ``EngineStats.ground_hits``, degraded directory lookups (a dead
        metadata-stripe home probed before a surviving replica answered)
        in ``EngineStats.degraded_lookups``, fabric-shortened prefixes
        (a promised later chunk gone from every replica, served shorter)
        in ``EngineStats.shortened_prefixes``, and a block-miss delta --
        the radix index pointed at blocks the fabric could no longer
        serve from *any* tier, so (part of) the prefix falls back to
        recompute, never an exception -- bumps
        ``EngineStats.lost_blocks``."""
        # resolved per call: benchmarks re-point a view's CacheStats
        # between the warmup and the timed run
        cs = (None if self.manager is None
              else getattr(self.manager.cache, "stats", None))
        if cs is None:
            yield
            return
        degraded0, misses0 = cs.degraded_reads, cs.block_misses
        detoured0, ground0 = cs.detoured_ops, cs.ground_hits
        dlook0, short0 = cs.degraded_lookups, cs.shortened_prefixes
        try:
            yield
        finally:
            self.stats.degraded_reads += cs.degraded_reads - degraded0
            self.stats.detoured_ops += cs.detoured_ops - detoured0
            self.stats.ground_hits += cs.ground_hits - ground0
            self.stats.degraded_lookups += cs.degraded_lookups - dlook0
            self.stats.shortened_prefixes += (
                cs.shortened_prefixes - short0)
            if cs.block_misses > misses0:
                self.stats.lost_blocks += 1

    def lookup_prefix(
        self, tokens: list[int]
    ) -> tuple[bytes | None, int, float | None]:
        """Get KVC for the longest cached prefix, draining any in-flight
        write-back first so duplicate contexts queued together still hit
        (the paper's repeated-context workload).

        Returns ``(payload, n_cached_tokens, ready_at)``.  ``ready_at``
        is the Get's completion time on the fabric clock (None when the
        fabric is unclocked or nothing was fetched): the payload bytes
        are in hand, but the scheduler must not *use* them before the
        clock passes ``ready_at`` -- it defers the consuming chunk to
        overlap the flight with decode steps, and ``wait_fetch`` settles
        whatever could not be hidden.

        Under constellation faults an unrecoverable block simply
        shortens (or zeroes) the returned prefix: the KVC manager walks
        back to the longest still-servable boundary, and the scheduler
        recomputes the rest -- churn degrades the hit rate, never a
        request."""
        if self.manager is None:
            return None, 0, None
        self.drain_write_back()
        if self._transport is not None:
            self._transport.last_ready_at = None
        with self._observe_l2():
            payload, cached = self.manager.get_cache_tokens(tokens)
        ready_at = None
        if (payload is not None and self._transport is not None
                and self.clock is not None):
            ready_at = self._transport.last_ready_at
        return payload, cached, ready_at

    def fetch_pending(self, ready_at: float | None) -> bool:
        """True while a fetched payload is still in simulated flight."""
        return (ready_at is not None and self.clock is not None
                and self.clock.now() < ready_at)

    def wait_fetch(self, ready_at: float | None) -> float:
        """Block until the clock passes ``ready_at`` -- the experienced
        part of an L2 flight the scheduler could not hide behind decode
        steps.  Returns virtual seconds waited."""
        if ready_at is None or self.clock is None:
            return 0.0
        waited = self.clock.wait_until(ready_at)
        if waited > 0.0:
            self.stats.l2_wait_s += waited
            self.stats.l2_fetch_waits += 1
        return waited

    def pages_async(self, payload: bytes, n_tokens: int):
        """Fetch-ahead payload -> pages decode on the adapter worker.

        Under a quantized codec this is where the dequantize leg runs:
        on the worker, overlapped with live decode steps, never on the
        serving loop.  The wall-clock it spends there is accounted as
        ``EngineStats.dequant_overlap_s`` -- decompression time the
        requests did not experience."""
        def decode():
            t0 = time.perf_counter()
            out = self.adapter.payload_to_pages(payload, n_tokens,
                                                self.pool.page_size)
            self.stats.dequant_overlap_s += time.perf_counter() - t0
            return out

        return self.adapter.run_async(decode)

    def write_back_async(self, tokens: list[int]) -> None:
        """Set KVC for a finished prefill *off* the decode loop: the
        block payload computation (one forward per uncached block) runs
        on the adapter's worker thread and the next lookup drains it, so
        write-back no longer stalls running decodes."""
        if self.manager is None:
            return
        self._wb_future = self.adapter.run_async(
            self.manager.add_blocks_tokens, tokens)

    def drain_write_back(self) -> None:
        if self._wb_future is not None:
            self._wb_future.result()
            self._wb_future = None
