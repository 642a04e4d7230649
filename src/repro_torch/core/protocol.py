"""The SkyMemory Set/Get KVC protocol (paper §3.1, §3.8).

The port's own copy of ``repro/core/protocol.py``, whole: numpy and
plain Python, importing no ``torch``.

``ConstellationKVC`` is the distributed chunk store spread over the torus:
chunks of a block's payload are striped ``chunk_id mod num_servers`` across
virtual servers placed on satellites by a strategy (``mapping.py``).  All
chunk operations of one block run in parallel, so the modeled latency of a
block set/get is the *max* over its chunk operations (paper §4).

Scale-out additions: a ``SimClock`` gives every Get/Set KVC op a
*completion time* (``IslTransport.last_ready_at``), so serving layers can
defer consuming a fetched payload until its simulated flight is over
instead of treating the constellation as a zero-latency dict.
``ConstellationKVC.view`` hands N serving replicas anchored handles on ONE
shared store: same satellites, directory and eviction policy, but per-view
transports (per-anchor hop costs) and per-view cache stats.

``KVCManager`` is the paper's §3.3 interface bound to a tokenizer and a
KVC-producing model function, with the §3.10 local radix index in front;
``KVCManager.sibling`` binds additional replicas to the same radix index,
recency policy, and lock.
"""
from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Sequence

from repro_torch.core import migration as migration_mod
from repro_torch.core.chunking import (
    cat_payloads,
    chunk_server,
    is_delta_payload,
    join_chunks,
    num_chunks,
    payload_raw_bytes,
    replica_delta,
    split_chunks,
)
from repro_torch.core.constellation import ConstellationSpec, LosWindow, Sat
from repro_torch.core.directory import StripedDirectory, stripe_of
from repro_torch.core.hashing import chain_hashes, split_token_blocks
from repro_torch.core.mapping import Strategy, place_servers
from repro_torch.core.radix import BlockMeta, RadixBlockIndex
from repro_torch.core.store import SatelliteStore


# ---------------------------------------------------------------------------
# Virtual serving clock.
# ---------------------------------------------------------------------------

class SimClock:
    """The fabric's virtual clock: Get/Set completion times live on it.

    Anchored to the host monotonic clock, so everything that takes real
    time (decode steps, payload deserialization) advances it for free and
    a transport op issued at ``now()`` with latency ``L`` completes at
    ``now() + L``.  ``rate`` compresses virtual time -- at ``rate=10``,
    ten virtual seconds pass per wall second, so tests can simulate long
    ISL flights without sleeping through them.  ``wait_until`` blocks
    (sleeps wall time) until the clock passes a completion time and
    accounts the virtual time spent blocked -- the *experienced* part of
    a fetch the caller could not hide behind useful work.
    """

    def __init__(self, rate: float = 1.0) -> None:
        if rate <= 0.0:
            raise ValueError("clock rate must be positive")
        self.rate = rate
        self._t0 = time.perf_counter()
        self.waited_s = 0.0          # virtual seconds spent blocked
        self.waits = 0
        # one clock is shared by every replica thread of a cluster, so
        # the wait accounting must not lose updates to interleaving
        self._lock = threading.Lock()

    def now(self) -> float:
        """Virtual seconds since the clock was created."""
        return (time.perf_counter() - self._t0) * self.rate

    def wait_until(self, t: float) -> float:
        """Block until virtual time ``t``; returns virtual seconds waited
        (0.0 when ``t`` already passed)."""
        dt = t - self.now()
        if dt <= 0.0:
            return 0.0
        time.sleep(dt / self.rate)
        with self._lock:
            self.waited_s += dt
            self.waits += 1
        return dt


# ---------------------------------------------------------------------------
# Transport cost model.
# ---------------------------------------------------------------------------

@dataclass
class TransportStats:
    """Bounded op-latency record.

    ``op_latencies_s`` is a uniform reservoir over the whole run, capped
    at ``reservoir_size`` samples so a long serving run cannot grow it
    without bound.  Runs shorter than the cap keep every sample in
    arrival order (the pre-reservoir behavior); ``last_latency_s`` /
    ``max_latency_s`` are exact regardless of sampling, and
    ``latency_percentiles`` summarizes the reservoir as p50/p95/p99.
    """

    messages: int = 0
    bytes_moved: int = 0
    # dtype-true bytes the *block payloads* among bytes_moved decode to
    # (codec compression accounting; probe/metadata traffic not included)
    bytes_raw: int = 0
    total_latency_s: float = 0.0
    ops: int = 0
    last_latency_s: float = 0.0
    max_latency_s: float = 0.0
    reservoir_size: int = 512
    op_latencies_s: list[float] = field(default_factory=list)
    _rng: random.Random = field(
        default_factory=lambda: random.Random(0x5EED), repr=False)

    def record(self, latency_s: float) -> None:
        self.ops += 1
        self.total_latency_s += latency_s
        self.last_latency_s = latency_s
        if latency_s > self.max_latency_s:
            self.max_latency_s = latency_s
        if len(self.op_latencies_s) < self.reservoir_size:
            self.op_latencies_s.append(latency_s)
        else:
            j = self._rng.randrange(self.ops)
            if j < self.reservoir_size:
                self.op_latencies_s[j] = latency_s

    def latency_percentiles(self) -> dict[str, float]:
        if not self.op_latencies_s:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        xs = sorted(self.op_latencies_s)
        n = len(xs)
        pick = lambda q: xs[min(n - 1, int(q * (n - 1) + 0.5))]  # noqa: E731
        return {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99)}


@dataclass
class IslTransport:
    """Latency accounting for chunk ops; execution itself is in-process.

    ``ground_hosted``: the LLM sits on the ground under the window center
    (one reliable uplink to the closest satellite, then ISL routing) --
    paper's rotation / rotation+hop scenario.  Otherwise the LLM is on board
    the center satellite (hop-aware scenario) and only ISL legs apply.

    ``anchor``: the satellite this transport's ops originate from -- a
    serving replica's attachment point on the torus.  ``None`` keeps the
    single-engine behavior (ops originate at the LOS window center).

    ``clock``: optional ``SimClock``.  When set, ``record_op`` stamps
    ``last_ready_at = clock.now() + latency`` -- the op's completion time
    -- so callers can defer consuming the result until the flight is over
    (and overlap the flight with other work) instead of experiencing the
    constellation as a free local dict.

    ``probe_timeout_s``: the explicit cost of one FAILED replica attempt
    (a dead or partitioned home that never answers).  ``None`` keeps the
    implicit model -- a failed probe charges the 0-byte round trip it
    would have taken -- while a value models a real timeout budget.  The
    Get fall-through and ``estimate_get_latency_s`` both price failed
    attempts through ``probe_latency_s``, so the router prices exactly
    what the fetch pays.
    """

    spec: ConstellationSpec
    ground_hosted: bool = True
    chunk_processing_time_s: float = 0.0
    link_bandwidth_bytes_s: float | None = None
    anchor: Sat | None = None
    clock: SimClock | None = None
    stats: TransportStats = field(default_factory=TransportStats)
    last_ready_at: float | None = field(default=None, repr=False)
    probe_timeout_s: float | None = None

    def src_for(self, center: Sat) -> Sat:
        return self.anchor if self.anchor is not None else center

    def _isl_leg_s(self, src: Sat, target: Sat, faults) -> float:
        """One-way ISL latency of the route an op actually runs: the
        clean greedy path, or -- under link faults -- the cheapest
        detour (``FaultState.route_hops``).  A partitioned pair falls
        back to the clean-path price: the op itself is already failed by
        reachability, this only prices its timed-out probe."""
        if faults is not None and faults.dead_links:
            lat = faults.routed_latency_s(self.spec, src, target)
            if lat is not None:
                return lat
        return self.spec.isl_latency_s(src, target, routed=True)

    def op_latency_s(
        self, src: Sat, target: Sat, n_bytes: int, *,
        round_trip: bool, faults=None,
    ) -> float:
        """Pure cost model -- no accounting.  The serving router calls
        this to *estimate* fetch costs from candidate anchors without
        polluting transport stats.  ``faults`` (a ``FaultState``) prices
        the ISL leg over the detoured route killed links force."""
        lat = 0.0
        if self.ground_hosted:
            lat += self.spec.uplink_latency_s()
        lat += self._isl_leg_s(src, target, faults)
        if round_trip:
            lat *= 2.0
        lat += self.chunk_processing_time_s
        if self.link_bandwidth_bytes_s:
            lat += n_bytes / self.link_bandwidth_bytes_s
        return lat

    def probe_latency_s(self, src: Sat, target: Sat, *, faults=None) -> float:
        """Cost of one failed replica attempt (dead/partitioned home):
        the explicit ``probe_timeout_s`` when configured, else the
        timed-out 0-byte round trip the attempt would have taken."""
        if self.probe_timeout_s is not None:
            return self.probe_timeout_s
        return self.op_latency_s(src, target, 0, round_trip=True,
                                 faults=faults)

    def chunk_op_latency_s(
        self, center: Sat, target: Sat, n_bytes: int, *,
        round_trip: bool, faults=None,
    ) -> float:
        lat = self.op_latency_s(
            self.src_for(center), target, n_bytes, round_trip=round_trip,
            faults=faults)
        self.stats.messages += 1
        self.stats.bytes_moved += n_bytes
        return lat

    def chunk_probe_latency_s(self, center: Sat, target: Sat, *,
                              faults=None) -> float:
        """Accounting flavor of ``probe_latency_s`` (data-plane failed
        attempts bump the message counter like any other chunk op)."""
        lat = self.probe_latency_s(self.src_for(center), target,
                                   faults=faults)
        self.stats.messages += 1
        return lat

    def record_op(self, latency_s: float) -> float | None:
        """Account one block-level op; returns (and remembers) its
        completion time on the clock, or None when unclocked."""
        self.stats.record(latency_s)
        self.last_ready_at = (
            None if self.clock is None else self.clock.now() + latency_s)
        return self.last_ready_at


# ---------------------------------------------------------------------------
# Distributed constellation-hosted KVC.
# ---------------------------------------------------------------------------

@dataclass
class CacheStats:
    block_hits: int = 0
    block_misses: int = 0
    blocks_set: int = 0
    blocks_purged: int = 0
    migrations: int = 0
    lookup_probes: int = 0
    # fault tolerance (k-replica placement + churn):
    degraded_reads: int = 0   # ops served only after dead-replica fallthrough
    lost_blocks: int = 0      # blocks with an unrecoverable chunk (purged)
    repaired_chunks: int = 0  # chunk copies re-replicated by repair passes
    # graded link faults (detours) + the L3 ground tier:
    detoured_ops: int = 0     # chunk ops completed over a rerouted path
    detour_hops: int = 0      # extra hops those detours cost, summed
    ground_hits: int = 0      # ops answered by the ground tier fall-through
    ground_spills: int = 0    # orbit-evicted blocks demoted to ground
    repaired_from_ground: int = 0  # blocks re-replicated from ground
    # decentralized directory (striped metadata on the fabric):
    dir_lookups: int = 0      # priced directory lookups issued
    degraded_lookups: int = 0  # lookups that probed >=1 dead stripe home
    dir_repaired_entries: int = 0  # entry copies rewritten by reconcile()
    orphaned_chunks: int = 0  # inventoried chunks with no provable entry
    shortened_prefixes: int = 0  # index prefixes walked back at Get time
    # payload codec (quantized / delta-encoded block payloads): what the
    # fabric actually shipped vs what those bytes decode to -- the
    # compression the ISL bandwidth and satellite capacity never paid
    bytes_encoded: int = 0    # block payload bytes moved (Set + served Get)
    bytes_raw: int = 0        # dtype-true bytes those payloads decode to


def _note_codec_bytes(cs: "CacheStats", tr: "IslTransport",
                      payload: bytes) -> None:
    """Account one block payload's encoded-vs-raw size (a header-only
    scan; nothing dequantizes) on the cache and transport stats."""
    raw = payload_raw_bytes(payload)
    cs.bytes_encoded += len(payload)
    cs.bytes_raw += raw
    tr.stats.bytes_raw += raw


# ---------------------------------------------------------------------------
# L3: the durable ground-station tier below the constellation.
# ---------------------------------------------------------------------------

@dataclass
class GroundStats:
    puts: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_stored: int = 0


class GroundStationTier:
    """A bigger, slower, durable block store below the constellation.

    The MegaCacheX-style hierarchical tier: whole payloads keyed by
    block hash (no striping -- ground stations are not satellites), with
    capacity counted in *blocks* and LRU eviction when bounded
    (``capacity_blocks=None`` = unbounded: durable by construction).
    The station sits under the LOS window center, so an op from a
    serving anchor runs anchor -> center over the ISLs (detour-priced
    under link faults, like any chunk op) and then one Eq-4 downlink leg
    -- ``op_latency_s`` prices the round trip on the same transport
    model / ``SimClock`` the orbital ops complete on, plus the tier's
    own (slower) processing and bandwidth terms.

    ``ConstellationKVC`` attaches one via ``ground=`` / ``attach_ground``
    and its ``ground_write`` policy decides what lands here; Gets fall
    through replicas -> ground -> clean miss, and ``repair`` re-seeds
    orbital copies from here when no replica survived.
    """

    def __init__(
        self,
        spec: ConstellationSpec,
        *,
        capacity_blocks: int | None = None,
        processing_time_s: float = 0.0,
        link_bandwidth_bytes_s: float | None = None,
    ) -> None:
        if capacity_blocks is not None and capacity_blocks < 1:
            raise ValueError("ground capacity must be >= 1 block (or None)")
        self.spec = spec
        self.capacity_blocks = capacity_blocks
        self.processing_time_s = processing_time_s
        self.link_bandwidth_bytes_s = link_bandwidth_bytes_s
        self.stats = GroundStats()
        self._blocks: "OrderedDict[bytes, bytes]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, block_hash: bytes) -> bool:
        return block_hash in self._blocks

    # -- cost model -----------------------------------------------------
    def op_latency_s(
        self, transport: IslTransport, center: Sat, n_bytes: int, *,
        round_trip: bool = True, faults=None,
    ) -> float:
        """One ground-tier op from ``transport``'s origin: the ISL path
        to the window center (0 bytes -- the tier's own bandwidth term
        prices the payload) plus the downlink to the station under it,
        doubled for a round trip, plus ground processing."""
        lat = transport.op_latency_s(
            transport.src_for(center), center, 0,
            round_trip=round_trip, faults=faults)
        leg = self.spec.uplink_latency_s()
        lat += leg * (2.0 if round_trip else 1.0)
        lat += self.processing_time_s
        if self.link_bandwidth_bytes_s:
            lat += n_bytes / self.link_bandwidth_bytes_s
        return lat

    # -- storage --------------------------------------------------------
    def put(self, block_hash: bytes, payload: bytes) -> None:
        """Durable write (write-through or spill).  Re-putting a known
        hash refreshes recency only -- content addressing makes the
        bytes identical."""
        if block_hash in self._blocks:
            self._blocks.move_to_end(block_hash)
            return
        self._blocks[block_hash] = payload
        self.stats.puts += 1
        self.stats.bytes_stored += len(payload)
        if self.capacity_blocks is not None:
            while len(self._blocks) > self.capacity_blocks:
                _, victim = self._blocks.popitem(last=False)
                self.stats.evictions += 1
                self.stats.bytes_stored -= len(victim)

    def get(self, block_hash: bytes) -> bytes | None:
        """Data-plane read: counts hit/miss, refreshes recency."""
        payload = self._blocks.get(block_hash)
        if payload is None:
            self.stats.misses += 1
            return None
        self._blocks.move_to_end(block_hash)
        self.stats.hits += 1
        return payload

    def peek(self, block_hash: bytes) -> bytes | None:
        """Control-plane read (repair): no stats, no recency."""
        return self._blocks.get(block_hash)

    def contains(self, block_hash: bytes) -> bool:
        return block_hash in self._blocks

    def delete(self, block_hash: bytes) -> bool:
        """Explicit invalidation (purge gossip reaching the ground)."""
        payload = self._blocks.pop(block_hash, None)
        if payload is None:
            return False
        self.stats.bytes_stored -= len(payload)
        return True


class ConstellationKVC:
    """Chunk store striped over the constellation with rotation migration.

    ``replication`` stores ``k`` copies of every chunk: replica 0 on the
    chunk's server satellite, replica ``r`` offset by
    ``chunking.replica_delta`` (plane-diverse while ``k <= num_planes``,
    always a distinct satellite).  Reads fall through dead replicas
    (``degraded_reads``), charging the experienced latency of every
    failed attempt; ``repair`` re-replicates surviving copies after
    churn.  Fault sources attach via ``attach_faults`` (see
    ``core.faults.FaultInjector``); with none attached every path is
    byte-identical to the fault-free protocol.

    ``ground`` attaches a durable ``GroundStationTier`` below the
    constellation.  ``ground_write`` decides what lands there:
    ``"none"`` (reads may still fall through to externally seeded
    content), ``"spill"`` (only orbit-evicted victims are demoted down),
    or ``"all"`` (write-through: every Set also lands on ground, so
    total orbital loss is never data loss).  Gets fall through replicas
    -> ground -> clean miss, and ``repair`` re-replicates from ground
    when no orbital copy survived -- a block is only purged through
    ``on_block_lost`` when ground misses too.
    """

    GROUND_WRITE_POLICIES = ("none", "spill", "all")

    def __init__(
        self,
        spec: ConstellationSpec,
        window: LosWindow,
        strategy: Strategy = Strategy.ROTATION_HOP,
        *,
        num_servers: int | None = None,
        chunk_bytes: int = 6 * 1024,
        per_sat_capacity_bytes: int | None = None,
        transport: IslTransport | None = None,
        replication: int = 1,
        dir_replication: int | None = None,
        ground: "GroundStationTier | None" = None,
        ground_write: str = "none",
    ) -> None:
        self.spec = spec
        self.window = window
        self.strategy = strategy
        self.num_servers = num_servers or (window.rows * window.cols)
        self.chunk_bytes = chunk_bytes
        self.transport = transport or IslTransport(spec)
        self.stats = CacheStats()
        if not 1 <= replication <= spec.num_sats:
            raise ValueError(
                f"replication must be in [1, {spec.num_sats}] "
                f"(got {replication})")
        self.replication = replication
        if dir_replication is None:
            dir_replication = replication
        if not 1 <= dir_replication <= spec.num_sats:
            raise ValueError(
                f"dir_replication must be in [1, {spec.num_sats}] "
                f"(got {dir_replication})")
        self.dir_replication = dir_replication
        self.ground: GroundStationTier | None = None
        self.ground_write = "none"
        # blocks deliberately demoted to ground-only residency (capacity
        # spills): repair must not re-promote them -- the orbit evicted
        # them for a reason -- but Gets keep serving them from below
        self._ground_demoted: set[bytes] = set()
        if ground is not None:
            self.attach_ground(ground, write=ground_write)
        elif ground_write != "none":
            raise ValueError("ground_write needs a ground tier attached")
        self.server_map: list[Sat] = place_servers(
            strategy, spec, window, self.num_servers
        )
        self._stores: dict[Sat, SatelliteStore] = {}
        self._capacity = per_sat_capacity_bytes
        self.policy = None   # shared LRU clock, injected via adopt_policy
        # Block metadata lives ON the fabric: ``block_hash -> n_chunks``
        # entries are striped over the satellites (stripe home =
        # hash-derived server, ``dir_replication`` plane-diverse copies)
        # and die with their hosts.  ``_known_blocks`` is this client's
        # own journal of what it ever registered -- control-plane
        # bookkeeping (sweeps, the purge/lost decision, prefetch), never
        # consulted by a priced data-plane lookup.
        self._dir = StripedDirectory()
        self._known_blocks: dict[bytes, int] = {}
        self.on_block_lost: Callable[[bytes], None] | None = None
        self.injector = None  # core.faults.FaultInjector, via attach_faults
        self._repaired_at_event = -1   # rotate-repair gating

    # -- plumbing ------------------------------------------------------
    def adopt_policy(self, policy) -> None:
        """Share a recency clock (``core.eviction.LRUClock``) with every
        satellite store, present and future, so L2 victim selection sees
        the same access timeline as the host-side tiers (radix index, L1
        page cache)."""
        self.policy = policy
        for store in self._stores.values():
            store.policy = policy

    def store_for(self, sat: Sat) -> SatelliteStore:
        sat = self.spec.wrap(sat)
        if sat not in self._stores:
            self._stores[sat] = SatelliteStore(
                capacity_bytes=self._capacity, on_evict=self._on_evict,
                policy=self.policy,
            )
        return self._stores[sat]

    def attach_ground(self, tier: "GroundStationTier",
                      write: str = "all") -> None:
        """Attach the durable L3 tier with a write policy (see class
        docstring).  Callable after construction so benchmarks can run
        the same fabric with and without a ground segment."""
        if write not in self.GROUND_WRITE_POLICIES:
            raise ValueError(
                f"ground_write must be one of {self.GROUND_WRITE_POLICIES} "
                f"(got {write!r})")
        self.ground = tier
        self.ground_write = write

    def _ground_latency_s(self, tr: IslTransport, n_bytes: int, *,
                          round_trip: bool = True) -> float:
        return self.ground.op_latency_s(
            tr, self.center, n_bytes, round_trip=round_trip,
            faults=self.faults)

    def _on_evict(self, store: SatelliteStore, key: tuple[bytes, int],
                  value: bytes) -> None:
        """LRU eviction of one chunk invalidates its whole block (§3.9)
        -- unless the ground tier holds (or, under ``ground_write=
        "spill"``, receives) the payload, in which case the block is
        *demoted*: orbital chunks dropped, directory entry kept, and
        Gets fall through to ground instead of recomputing."""
        block_hash, cid = key
        if self.ground is not None and block_hash in self._known_blocks:
            if self.ground.contains(block_hash):
                self._demote_to_ground(block_hash)
                return
            if self.ground_write == "spill":
                payload = self._reassemble(block_hash, cid, value)
                if payload is not None:
                    self.ground.put(block_hash, payload)
                    self.stats.ground_spills += 1
                    self.transport.stats.messages += 1
                    self.transport.stats.bytes_moved += len(payload)
                    self._demote_to_ground(block_hash)
                    return
        self.purge_block(block_hash)

    def _reassemble(self, block_hash: bytes, evicted_cid: int,
                    evicted_value: bytes) -> bytes | None:
        """Rebuild a full payload from surviving orbital chunk copies
        (plus the just-evicted one, already out of its store).  Returns
        None when any chunk has no copy left -- then there is nothing
        whole to spill and the eviction degenerates to a purge."""
        n_chunks = self._known_blocks[block_hash]
        chunks: list[bytes] = []
        for cid in range(n_chunks):
            if cid == evicted_cid:
                chunks.append(evicted_value)
                continue
            sid = chunk_server(cid, self.num_servers)
            chunk = None
            for r in range(self.replication):
                chunk = self.store_for(self.replica_sat(sid, r)).peek(
                    (block_hash, cid))
                if chunk is not None:
                    break
            if chunk is None:
                return None
            chunks.append(chunk)
        return join_chunks(chunks)

    def _demote_to_ground(self, block_hash: bytes) -> None:
        """Drop a block's orbital chunks but keep it servable: the
        directory entry stays (ground holds the bytes), no
        ``on_block_lost`` fires, and repair skips it until a fresh Set
        re-promotes it."""
        self._ground_demoted.add(block_hash)
        for store in self._stores.values():
            for key in [k for k in store.keys() if k[0] == block_hash]:
                store.delete(key)

    def server_sat(self, server_id0: int) -> Sat:
        return self.server_map[server_id0]

    def _offset_sat(self, base: Sat, replica: int) -> Sat:
        if replica == 0:
            return base
        dp, ds = replica_delta(
            replica, self.spec.num_planes, self.spec.sats_per_plane)
        return self.spec.wrap(Sat(base.plane + dp, base.slot + ds))

    def replica_sat(self, server_id0: int, replica: int = 0) -> Sat:
        """Home satellite of replica ``replica`` of server
        ``server_id0``'s chunks (replica 0 = the server's own satellite).
        Derived from the live ``server_map``, so rotation migration moves
        every replica's home along with its server.  Directory stripes
        use the same geometry: stripe ``sid`` replica ``r`` lives here
        too (metadata moves with the server it describes)."""
        return self._offset_sat(self.server_map[server_id0], replica)

    # -- the decentralized directory (metadata plane) -------------------
    @property
    def directory(self) -> dict[bytes, int]:
        """Control-plane merged view of the block metadata: the client's
        journal plus every surviving stripe shard.  This is what sweeps,
        gossip-cost models and tests read; it is *free* and therefore
        never consulted by a data-plane op -- ``get_block``/``has_block``
        resolve ``n_chunks`` through the priced stripe walk
        (``_dir_lookup``), which really does lose entries when every
        shard replica dies."""
        merged = dict(self._known_blocks)
        merged.update(self._dir.entries())
        return merged

    def dir_shard_len(self, sat: Sat) -> int:
        """Entry count of the directory shard hosted by ``sat``."""
        return self._dir.shard_len(self.spec.wrap(sat))

    def _replica_order(self, sid: int, src: Sat, tr: IslTransport,
                       f, k: int) -> list[int]:
        """Swarm read order: replica indices of server/stripe ``sid``
        sorted by the round-trip price ``src`` would pay to each home
        (ties by replica index, so a single-replica fabric reduces to
        placement order).  Shared by the Get fall-through, presence
        probes, directory lookups and ``estimate_get_latency_s``, so the
        router prices exactly the walk the fetch will run.  Dead homes
        are NOT filtered: liveness is only learned by paying the probe,
        so a cheap-but-dead home is charged before the cheapest live
        one -- precisely what the estimator prices."""
        if k == 1:
            return [0]
        costs = sorted(
            (tr.op_latency_s(src, self.replica_sat(sid, r), 0,
                             round_trip=True, faults=f), r)
            for r in range(k))
        return [r for _, r in costs]

    def _fallthrough_cost_s(
        self, sid: int, src: Sat, tr: IslTransport, f, k: int,
        n_bytes: int,
    ) -> tuple[float, bool]:
        """Pure price of one replica fall-through walk from ``src``:
        every dead home charges its timed-out probe, the first reachable
        home answers a round trip of ``n_bytes``.  Returns
        ``(latency_s, served)`` -- ``served`` False when every home is
        out (the caller prices the ground leg or declares the op
        unreachable).  No accounting: this is the estimator's half of
        the estimate/fetch agreement."""
        lat = 0.0
        for r in self._replica_order(sid, src, tr, f, k):
            sat = self.replica_sat(sid, r)
            if self._reachable(src, sat):
                lat += tr.op_latency_s(src, sat, n_bytes,
                                       round_trip=True, faults=f)
                return lat, True
            lat += tr.probe_latency_s(src, sat, faults=f)
        return lat, False

    def _dir_lookup(
        self, block_hash: bytes, tr: IslTransport, cs: CacheStats,
    ) -> tuple[int | None, float, bool]:
        """Priced lookup of a block's metadata entry on its stripe.

        Walks the stripe's replica homes in swarm (cheapest-first)
        order, exactly like a degraded data read: a dead or partitioned
        home charges its timed-out probe, a live home answers at its
        real round trip.  A live home *without* the entry falls through
        too -- it may have healed empty after a crash -- and the entry
        is a miss only once every live home answered empty.  Returns
        ``(n_chunks | None, latency_s, unreachable)``; ``unreachable``
        is True only when no home answered at all (genuine partition:
        the metadata may still exist, so callers must not purge on it).
        ``degraded_lookups`` counts lookups that probed at least one
        dead home -- found or not, the metadata plane degraded them."""
        f = self.faults
        src = tr.src_for(self.center)
        sid = stripe_of(block_hash, self.num_servers)
        cs.dir_lookups += 1
        lat = 0.0
        n: int | None = None
        dead_fall = False
        answered = False
        for r in self._replica_order(sid, src, tr, f,
                                     self.dir_replication):
            sat = self.replica_sat(sid, r)
            if not self._reachable(src, sat):
                lat += tr.chunk_probe_latency_s(self.center, sat, faults=f)
                dead_fall = True
                continue
            lat += tr.chunk_op_latency_s(self.center, sat, 0,
                                         round_trip=True, faults=f)
            answered = True
            hit = self._dir.shard(sat).get(block_hash)
            if hit is not None:
                n = hit
                break
        if dead_fall:
            cs.degraded_lookups += 1
        return n, lat, not answered

    def _dir_register(
        self, block_hash: bytes, n_chunks: int, tr: IslTransport,
    ) -> float:
        """Priced register on Set: write the entry to every *reachable*
        stripe replica home (one-way messages, parallel with the data
        writes -- the caller folds the returned worst leg into the Set's
        max).  Dead homes are skipped; ``reconcile`` back-fills them.
        The client always journals the block host-side: it remembers
        what it wrote even when the metadata plane cannot."""
        f = self.faults
        src = tr.src_for(self.center)
        sid = stripe_of(block_hash, self.num_servers)
        self._known_blocks[block_hash] = n_chunks
        worst = 0.0
        for r in range(self.dir_replication):
            sat = self.replica_sat(sid, r)
            if not self._reachable(src, sat):
                continue
            self._dir.shard(sat)[block_hash] = n_chunks
            worst = max(worst, tr.chunk_op_latency_s(
                self.center, sat, 0, round_trip=False, faults=f))
        return worst

    def _dir_unregister(self, block_hash: bytes) -> int | None:
        """Purge-side metadata gossip: drop the entry from every stripe
        home holding it (one message each) and the client journal.
        Modeled as always landing -- a stale entry surviving a missed
        purge would make a later Get charge a full fetch walk, discover
        nothing, and count the block lost, polluting the loss counters
        with blocks that were deliberately purged.  Returns the
        journaled ``n_chunks`` (None when the block was unknown)."""
        n = self._known_blocks.pop(block_hash, None)
        sid = stripe_of(block_hash, self.num_servers)
        for r in range(self.dir_replication):
            sat = self.replica_sat(sid, r)
            if self._dir.shard(sat).pop(block_hash, None) is not None:
                self.transport.stats.messages += 1
        return n

    # -- fault plumbing ------------------------------------------------
    def attach_faults(self, injector) -> None:
        """Bind a ``core.faults.FaultInjector``: its ``FaultState`` gates
        reachability on every chunk op, and ops tick it so scheduled
        kills/heals land at their clock times without a poller thread."""
        self.injector = injector

    @property
    def faults(self):
        return None if self.injector is None else self.injector.state

    def _tick_faults(self) -> None:
        if self.injector is not None:
            self.injector.advance()

    def _reachable(self, src: Sat, sat: Sat) -> bool:
        f = self.faults
        return f is None or f.reachable(self.spec, src, sat)

    def _note_detour(self, cs: CacheStats, src: Sat, sat: Sat) -> None:
        """Account a completed chunk op that ran over a rerouted path
        (killed links on the greedy route): ops keep completing, the
        counters make the grading visible."""
        f = self.faults
        if f is None or not f.dead_links:
            return
        extra = f.extra_hops(self.spec, src, sat)
        if extra > 0:
            cs.detoured_ops += 1
            cs.detour_hops += extra

    def drop_satellite(self, sat: Sat) -> int:
        """A satellite died: its chunk store's contents are destroyed,
        and so is the directory shard it hosted -- metadata is fabric
        state and does not outlive its satellite.

        Not an eviction -- no ``on_evict`` gossip -- because the data
        *may* survive elsewhere: degraded reads fall through to the
        other replicas, degraded lookups to the other stripe homes, and
        ``reconcile`` rebuilds lost shards / re-replicates (or finally
        purges) what the crash orphaned.  Returns the number of chunks
        destroyed (``dir_shard_len`` before the kill tells a fault
        source how many metadata entries died with them)."""
        sat = self.spec.wrap(sat)
        self._dir.drop(sat)
        store = self._stores.get(sat)
        if store is None:
            return 0
        return len(store.pop_all())

    @property
    def center(self) -> Sat:
        return self.window.center

    def view(self, anchor: Sat, *, clock: SimClock | None = None
             ) -> "ConstellationView":
        """A serving replica's anchored handle on this shared store.

        The view shares every byte of storage state (chunk stores,
        directory, server map, eviction policy) with the base, but its
        ops originate from ``anchor`` through the view's own
        ``IslTransport`` -- per-replica hop costs, per-replica transport
        stats, per-replica ``CacheStats`` -- and complete on ``clock``
        (defaulting to the base transport's clock)."""
        base_t = self.transport
        transport = IslTransport(
            self.spec,
            ground_hosted=base_t.ground_hosted,
            chunk_processing_time_s=base_t.chunk_processing_time_s,
            link_bandwidth_bytes_s=base_t.link_bandwidth_bytes_s,
            anchor=self.spec.wrap(anchor),
            clock=clock if clock is not None else base_t.clock,
            probe_timeout_s=base_t.probe_timeout_s,
        )
        return ConstellationView(self, transport)

    def estimate_get_latency_s(
        self,
        anchor: Sat,
        *,
        payload_bytes: int | None = None,
        transport: IslTransport | None = None,
        block_hash: bytes | None = None,
    ) -> float:
        """Predicted Get KVC block latency from ``anchor``: the max
        round-trip chunk op over the chunk servers a block of
        ``payload_bytes`` (default: a full stripe) lands on, plus -- when
        the caller knows which block it will fetch (``block_hash``) --
        the priced directory-stripe lookup that fronts the fetch.  Pure
        -- no stats, no data movement -- this is the router's
        hop-awareness signal, priced by the same swarm walk the fetch
        will run (``_replica_order`` / ``_fallthrough_cost_s``): under
        faults each server is priced as the degraded read would run it
        -- failed probes of dead replicas first (``probe_latency_s``,
        the same explicit timeout the fall-through charges), then the
        cheapest live replica over its detoured route, then -- when
        every replica is out -- the ground tier's round trip.  Detours,
        timeouts, the metadata leg and the ground leg all show up in
        routing scores before any engine experiences them.  Without
        ``block_hash`` the metadata leg is omitted: it is a 0-byte round
        trip every candidate anchor pays alike, so the relative ranking
        the router needs is preserved."""
        self._tick_faults()   # due kills/heals land before pricing
        tr = transport if transport is not None else self.transport
        f = self.faults
        nb = (self.num_servers if payload_bytes is None
              else num_chunks(payload_bytes, self.chunk_bytes))
        servers = {chunk_server(cid, self.num_servers)
                   for cid in range(min(nb, self.num_servers))}
        anchor = self.spec.wrap(anchor)
        pb = (payload_bytes if payload_bytes is not None
              else nb * self.chunk_bytes)
        dir_lat = 0.0
        if block_hash is not None:
            dir_lat, _ = self._fallthrough_cost_s(
                stripe_of(block_hash, self.num_servers), anchor, tr, f,
                self.dir_replication, 0)
        worst = 0.0
        for sid in servers:
            lat, served = self._fallthrough_cost_s(
                sid, anchor, tr, f, self.replication, self.chunk_bytes)
            if not served and self.ground is not None:
                # no orbital copy answerable: the fetch would fall
                # through to ground for the whole payload
                lat += self.ground.op_latency_s(
                    tr, self.center, pb, round_trip=True, faults=f)
            worst = max(worst, lat)
        return dir_lat + worst

    # -- Set KVC (paper §3.8) ------------------------------------------
    def set_block(
        self, block_hash: bytes, payload: bytes, *,
        via: IslTransport | None = None, stats: CacheStats | None = None,
    ) -> BlockMeta:
        """Store (all ``replication`` copies of) every chunk; the block
        latency is the max over the parallel per-copy writes.  Replicas
        whose home is currently dead/unreachable are simply skipped --
        the next ``repair`` pass back-fills them from a surviving copy
        (or, failing that, from ground).  Under ``ground_write="all"``
        the payload also lands on the ground tier, which makes even a
        write whose every orbital copy was refused durable: the block
        registers and Gets fall through to ground until repair
        re-seeds the orbit."""
        tr = via or self.transport
        cs = stats or self.stats
        self._tick_faults()
        f = self.faults
        chunks = split_chunks(payload, self.chunk_bytes)
        src = tr.src_for(self.center)
        worst = 0.0
        complete = True   # every chunk landed at least one copy
        for cid, chunk in enumerate(chunks):
            sid = chunk_server(cid, self.num_servers)
            stored = 0
            for r in range(self.replication):
                sat = self.replica_sat(sid, r)
                if not self._reachable(src, sat):
                    continue
                self.store_for(sat).set((block_hash, cid), chunk)
                stored += 1
                worst = max(
                    worst,
                    tr.chunk_op_latency_s(
                        self.center, sat, len(chunk), round_trip=False,
                        faults=f,
                    ),
                )
                self._note_detour(cs, src, sat)
            complete &= stored > 0
        grounded = False
        if self.ground is not None and self.ground_write == "all":
            # synchronous write-through: the durable copy is part of the
            # Set's critical path, so its (one-way) leg joins the max
            self.ground.put(block_hash, payload)
            tr.stats.messages += 1
            tr.stats.bytes_moved += len(payload)
            worst = max(worst,
                        self._ground_latency_s(tr, len(payload),
                                               round_trip=False))
            grounded = True
        stored_ok = complete or grounded
        if stored_ok:
            # a chunk with zero landed copies makes a purely orbital
            # write a failure: registering it would make the directory
            # (and through it the metrics) claim a block that never
            # existed.  A pre-existing entry for the same hash stays --
            # content addressing makes the old bytes identical to what
            # this write carried.  A grounded write registers even when
            # incomplete: the data exists below, repair promotes it.
            # The register runs in parallel with the chunk writes, so
            # its worst one-way leg joins the Set's max.
            worst = max(worst,
                        self._dir_register(block_hash, len(chunks), tr))
            cs.blocks_set += 1
            _note_codec_bytes(cs, tr, payload)
            self._ground_demoted.discard(block_hash)
        tr.record_op(worst)
        if not stored_ok and block_hash not in self._known_blocks:
            # failed fresh write: drop the partial chunks that did land,
            # or they would linger as orphans no sweep walks (the sweep
            # and repair passes scan the directory, which never learned
            # of this block)
            for cid in range(len(chunks)):
                sid = chunk_server(cid, self.num_servers)
                for r in range(self.replication):
                    self.store_for(self.replica_sat(sid, r)).delete(
                        (block_hash, cid))
        return BlockMeta(
            n_chunks=len(chunks), set_time=time.time(),
            payload_bytes=len(payload), stored=stored_ok,
        )

    # -- Get KVC (paper §3.8) ------------------------------------------
    def _probe_chunk(
        self, block_hash: bytes, cid: int, tr: IslTransport,
        cs: CacheStats, f, src: Sat,
    ) -> tuple[bool, float, bool]:
        """One presence probe with swarm replica fall-through: returns
        ``(present, latency_s, fell_through)``.  A dead home's probe
        times out (``chunk_probe_latency_s``), an empty live home
        answers negatively at its real round trip; either way the next
        cheapest copy is tried.  A positive probe *touches* the chunk's
        LRU clock: a presence check is a use (the caller is about to
        rely on the block), and leaving it unstamped made repeatedly-
        probed blocks look cold and get evicted first."""
        sid = chunk_server(cid, self.num_servers)
        lat = 0.0
        fell = False
        for r in self._replica_order(sid, src, tr, f, self.replication):
            sat = self.replica_sat(sid, r)
            if not self._reachable(src, sat):
                # failed attempt: the probe times out
                lat += tr.chunk_probe_latency_s(self.center, sat, faults=f)
                fell = True
                continue
            lat += tr.chunk_op_latency_s(self.center, sat, 0,
                                         round_trip=True, faults=f)
            store = self.store_for(sat)
            if store.contains((block_hash, cid)):
                store.touch((block_hash, cid))
                self._note_detour(cs, src, sat)
                return True, lat, fell
            fell = True
        return False, lat, fell

    def has_block(
        self, block_hash: bytes, *,
        via: IslTransport | None = None, stats: CacheStats | None = None,
    ) -> bool:
        """Priced presence check: resolve the entry on its directory
        stripe, then probe the block's first AND last chunk at their
        replica homes.  (Chunk 0 alone read as present after a *later*
        chunk died with all its homes -- the false positive that made
        ``lookup_longest`` promise prefixes ``get_block`` could not
        serve.)  The two chunk probes fan out in parallel after the
        lookup, so the op's latency is the lookup plus their max.

        Degraded probes fall through replicas exactly like a degraded
        read (see ``_probe_chunk``).  When the directory entry is
        missing or its stripe unreachable, a ground tier is the
        authority of last resort: one ground round trip answers, and
        absent now means absent from the metadata plane *and* ground.
        A middle chunk lost everywhere can still slip through -- probing
        every chunk would cost a full Get -- but ``get_cache_tokens``
        walks a failed Get back to the longest servable boundary
        (``shortened_prefixes``), so the residue is a shorter prefix,
        never a crash."""
        tr = via or self.transport
        cs = stats or self.stats
        self._tick_faults()
        f = self.faults
        cs.lookup_probes += 1
        src = tr.src_for(self.center)
        n_chunks, lat, _unreach = self._dir_lookup(block_hash, tr, cs)
        present = False
        fell_through = False
        if n_chunks is not None:
            present = True
            probe_worst = 0.0
            for cid in sorted({0, n_chunks - 1}):
                got, plat, pfell = self._probe_chunk(
                    block_hash, cid, tr, cs, f, src)
                probe_worst = max(probe_worst, plat)
                fell_through |= pfell
                present &= got
            lat += probe_worst
        if not present and self.ground is not None \
                and self.ground.contains(block_hash):
            lat += self._ground_latency_s(tr, 0, round_trip=True)
            tr.stats.messages += 1
            cs.ground_hits += 1
            present = True
        tr.record_op(lat)
        if present and fell_through:
            cs.degraded_reads += 1
        return present

    def get_block(
        self, block_hash: bytes, n_chunks: int | None = None, *,
        via: IslTransport | None = None, stats: CacheStats | None = None,
    ) -> bytes | None:
        """Fetch a block's chunks (all chunks in parallel, so the block
        latency is the max over per-chunk fetch sequences).

        The fetch is fronted by a priced directory lookup on the block's
        metadata stripe (``_dir_lookup``) resolving ``n_chunks``; its
        latency is the sequential prelude to the parallel chunk fan-out.
        A lookup miss is a clean block miss -- unless a ground tier is
        attached, in which case the durable tier is the authority of
        last resort and answers the whole payload (metadata loss is not
        data loss).

        Degraded reads: per chunk, replicas are tried cheapest-first
        (the swarm order ``estimate_get_latency_s`` prices) and every
        failed attempt -- a dead/unreachable home's timed-out probe
        (``probe_latency_s``), or a live home that lost the copy
        answering at its real round trip -- charges *before* the next
        replica is tried, so the experienced latency of a degraded fetch
        really contains the detours; ops over routes with killed links
        pay (and count) their rerouted extra hops.  A chunk with no live
        copy falls through to the ground tier when one is attached: the
        whole payload comes back up at one uplink-priced round trip
        (``ground_hits``) and the block survives.  Only when ground
        misses too does the block fail (§3.1): a clean miss, never an
        exception.  The block is lazily purged only when every replica
        home answered empty AND ground missed (it is *gone*); while a
        home is merely unreachable the metadata keeps its entries -- the
        data may still be there when the fault heals."""
        tr = via or self.transport
        cs = stats or self.stats
        self._tick_faults()
        f = self.faults
        dir_lat = 0.0
        if n_chunks is None:
            n_chunks, dir_lat, _unreach = self._dir_lookup(
                block_hash, tr, cs)
            if n_chunks is None:
                if self.ground is not None:
                    payload = self.ground.get(block_hash)
                    if payload is not None:
                        lat = dir_lat + self._ground_latency_s(
                            tr, len(payload), round_trip=True)
                        tr.stats.messages += 1
                        tr.stats.bytes_moved += len(payload)
                        tr.record_op(lat)
                        cs.block_hits += 1
                        cs.ground_hits += 1
                        _note_codec_bytes(cs, tr, payload)
                        return payload
                cs.block_misses += 1
                tr.record_op(dir_lat)
                return None
        src = tr.src_for(self.center)
        chunks: list[bytes] = []
        worst = 0.0
        degraded = False
        for cid in range(n_chunks):
            sid = chunk_server(cid, self.num_servers)
            attempt_s = 0.0
            chunk = None
            unreachable = False
            order = self._replica_order(sid, src, tr, f, self.replication)
            for j, r in enumerate(order):
                sat = self.replica_sat(sid, r)
                if not self._reachable(src, sat):
                    # failed attempt: the probe times out
                    attempt_s += tr.chunk_probe_latency_s(
                        self.center, sat, faults=f)
                    unreachable = True
                    degraded = True
                    continue
                got = self.store_for(sat).get((block_hash, cid))
                if got is None:
                    if j + 1 < len(order):
                        # empty live replica: charge the (answered)
                        # probe and fall through (the copy may have
                        # died with a crash this home has since healed
                        # from)
                        attempt_s += tr.chunk_op_latency_s(
                            self.center, sat, 0, round_trip=True,
                            faults=f)
                        degraded = True
                    continue
                attempt_s += tr.chunk_op_latency_s(
                    self.center, sat, len(got), round_trip=True, faults=f)
                chunk = got
                self._note_detour(cs, src, sat)
                break
            if chunk is None:
                payload = (None if self.ground is None
                           else self.ground.get(block_hash))
                if payload is not None:
                    # replicas -> ground: the durable tier answers with
                    # the whole payload; its round trip stacks on this
                    # chunk's failed attempts (the other chunks' flights
                    # ran in parallel and are already inside `worst`)
                    attempt_s += self._ground_latency_s(
                        tr, len(payload), round_trip=True)
                    tr.stats.messages += 1
                    tr.stats.bytes_moved += len(payload)
                    tr.record_op(dir_lat + max(worst, attempt_s))
                    cs.block_hits += 1
                    cs.ground_hits += 1
                    _note_codec_bytes(cs, tr, payload)
                    if degraded:
                        cs.degraded_reads += 1
                    return payload
                # replicas -> ground -> clean miss (§3.1).
                cs.block_misses += 1
                if not unreachable:
                    # every home answered empty and ground missed too:
                    # unrecoverable
                    self.purge_block(block_hash)
                    cs.lost_blocks += 1
                return None
            worst = max(worst, attempt_s)
            chunks.append(chunk)
        tr.record_op(dir_lat + worst)
        cs.block_hits += 1
        if degraded:
            cs.degraded_reads += 1
        payload = join_chunks(chunks)
        _note_codec_bytes(cs, tr, payload)
        return payload

    def lookup_longest(
        self, hashes: Sequence[bytes], *,
        via: IslTransport | None = None, stats: CacheStats | None = None,
    ) -> int:
        """Binary search for the furthest cached hash (Get steps 3-6).

        The chained-hash prefix property makes presence monotone in the block
        index, so bisect for the rightmost present block.  Returns the number
        of cached prefix blocks (0 = none).
        """
        lo, hi = 0, len(hashes)  # invariant: blocks < lo present
        while lo < hi:
            mid = (lo + hi) // 2
            if self.has_block(hashes[mid], via=via, stats=stats):
                lo = mid + 1
            else:
                hi = mid
        return lo

    # -- eviction (§3.9) -------------------------------------------------
    def purge_block(self, block_hash: bytes) -> int:
        """Gossip-style purge: remove every chunk of the block everywhere
        -- the ground tier included (an invalidation, unlike demotion)
        -- and unregister the entry from its directory stripe (one
        priced message per shard copy dropped)."""
        n = self._dir_unregister(block_hash)
        self._ground_demoted.discard(block_hash)
        removed = 0
        for store in self._stores.values():
            for key in [k for k in store.keys() if k[0] == block_hash]:
                store.delete(key)
                removed += 1
        if self.ground is not None and self.ground.delete(block_hash):
            removed += 1
        if removed or n:
            self.stats.blocks_purged += 1
            if self.on_block_lost is not None:
                self.on_block_lost(block_hash)
        return removed

    def sweep_incomplete(self) -> int:
        """Periodic cleanup: purge blocks with missing chunks (§3.9) --
        under replication, missing means *no replica home* has a copy.
        Blocks the ground tier holds are exempt: they are still
        servable (Get falls through) and repair re-seeds them.  The scan
        walks the client journal -- control-plane housekeeping over what
        this client wrote, not a priced metadata lookup."""
        purged = 0
        for block_hash, n_chunks in list(self._known_blocks.items()):
            ok = all(
                any(
                    self.store_for(
                        self.replica_sat(chunk_server(cid, self.num_servers),
                                         r)
                    ).contains((block_hash, cid))
                    for r in range(self.replication)
                )
                for cid in range(n_chunks)
            )
            if not ok:
                if self.ground is not None \
                        and self.ground.contains(block_hash):
                    continue
                self.purge_block(block_hash)
                purged += 1
        return purged

    # -- anti-entropy reconcile + repair (fault tolerance) -----------------
    def repair(self) -> int:
        """Back-compat name for ``reconcile`` (rotation housekeeping,
        heal hooks and the chaos suite call it by this name).  Returns
        the number of chunk copies re-replicated, as before."""
        return self.reconcile()

    def _reconstruct_n(
        self, block_hash: bytes, slots: dict[int, list[Sat]],
    ) -> int | None:
        """Rebuild a lost directory entry from a chunk inventory alone.

        Provable only when the tail chunk is identifiable: the ground
        tier knows the exact payload length, or the highest inventoried
        chunk is shorter than ``chunk_bytes`` (every non-tail chunk is
        exactly ``chunk_bytes``, so a short chunk IS the tail).  A
        full-size highest chunk proves nothing -- the real tail may have
        died with its homes, and registering a truncated ``n_chunks``
        would serve corrupt payloads -- so those chunks stay orphans."""
        if self.ground is not None:
            gp = self.ground.peek(block_hash)
            if gp is not None:
                return num_chunks(len(gp), self.chunk_bytes)
        max_cid = max(slots)
        for sat in slots[max_cid]:
            tail = self.store_for(sat).peek((block_hash, max_cid))
            if tail is not None and len(tail) < self.chunk_bytes:
                return max_cid + 1
        return None

    def reconcile(self) -> int:
        """Inventory-driven anti-entropy pass, in two phases.

        **Phase 1 -- metadata.**  Every live satellite reports its chunk
        inventory (``SatelliteStore.inventory``, read-only).  Authority
        for directory entries is the union of surviving stripe shards,
        the client journal, and -- for hashes known to neither --
        entries reconstructed from the inventories themselves
        (``_reconstruct_n``): the decentralized replacement for the old
        omniscient directory scan.  Inventoried chunks whose entry
        cannot be proven are deleted and counted (``orphaned_chunks``);
        every reconciled entry is rewritten onto each *live* stripe home
        missing it (``dir_repaired_entries``, one message per copy) --
        this is what rebuilds a wiped directory stripe.

        **Phase 2 -- data.**  The replica repair pass over the reconciled
        entries: restore every block to its full replica set by copying
        a surviving chunk copy onto each live replica home that lost (or
        never received) its own.  A chunk with no surviving *orbital*
        copy re-replicates from the ground tier when one holds the
        payload -- ``repaired_from_ground`` counts each block so rescued
        -- and only when ground misses too is the block unrecoverable:
        purged, ``on_block_lost`` fired so the radix index prunes,
        counted in ``stats.lost_blocks``.  Deliberately ground-demoted
        blocks (capacity spills) are skipped: re-promoting them would
        undo the eviction.

        Runs on ``rotate()`` when a fault source is attached, on heal
        events (``FaultInjector(repair_on_heal=True)``), or explicitly.
        Unlike the data-plane ops this is control-plane work: it only
        requires the source and destination satellites to be *alive*
        (background traffic can route around dead ISLs), not the serving
        path's greedy route -- and it must never stamp LRU recency
        (inventories and peeks only).  Returns the number of chunk
        copies re-replicated (also in ``stats.repaired_chunks``)."""
        f = self.faults
        # -- phase 1: reconcile the metadata plane ----------------------
        inv: dict[bytes, dict[int, list[Sat]]] = {}
        for sat, store in self._stores.items():
            if f is not None and not f.sat_alive(sat):
                continue   # a dead satellite cannot report
            for block_hash, cids in store.inventory().items():
                slots = inv.setdefault(block_hash, {})
                for cid in cids:
                    slots.setdefault(cid, []).append(sat)
        entries: dict[bytes, int] = self._dir.entries()
        for block_hash, n in self._known_blocks.items():
            entries.setdefault(block_hash, n)
        for block_hash, slots in list(inv.items()):
            if block_hash in entries:
                continue
            n = self._reconstruct_n(block_hash, slots)
            if n is None:
                # chunks with no provable block: orphans, swept out
                for cid, sats in slots.items():
                    for sat in sats:
                        if self.store_for(sat).delete((block_hash, cid)):
                            self.stats.orphaned_chunks += 1
                del inv[block_hash]
                continue
            entries[block_hash] = n
            self._known_blocks[block_hash] = n
        for block_hash, n in entries.items():
            sid = stripe_of(block_hash, self.num_servers)
            for r in range(self.dir_replication):
                sat = self.replica_sat(sid, r)
                if f is not None and not f.sat_alive(sat):
                    continue
                shard = self._dir.shard(sat)
                if shard.get(block_hash) != n:
                    shard[block_hash] = n
                    self.transport.stats.messages += 1
                    self.stats.dir_repaired_entries += 1
        # -- phase 2: re-replicate the data plane -----------------------
        repaired = 0
        for block_hash, n_chunks in list(entries.items()):
            if block_hash in self._ground_demoted:
                continue
            lost = False
            from_ground = False
            gchunks: list[bytes] | None | bool = None   # lazy, per block
            for cid in range(n_chunks):
                sid = chunk_server(cid, self.num_servers)
                live = [self.replica_sat(sid, r)
                        for r in range(self.replication)
                        if f is None or f.sat_alive(
                            self.replica_sat(sid, r))]
                holders = [sat for sat in live
                           if self.store_for(sat).contains(
                               (block_hash, cid))]
                if not holders:
                    if self.ground is not None and gchunks is None:
                        gp = self.ground.peek(block_hash)
                        gchunks = (split_chunks(gp, self.chunk_bytes)
                                   if gp is not None else False)
                    if gchunks:
                        if not live:
                            # no live home to re-seed right now; the
                            # block stays ground-served (and counted)
                            # until a home heals
                            continue
                        chunk = gchunks[cid]
                        for sat in live:
                            self.store_for(sat).set((block_hash, cid),
                                                    chunk)
                            self.transport.stats.messages += 1
                            self.transport.stats.bytes_moved += len(chunk)
                            repaired += 1
                        from_ground = True
                        continue
                    lost = True
                    break
                missing = [sat for sat in live if sat not in holders]
                if not missing:
                    continue   # full replica set: no read, no LRU touch
                chunk = self.store_for(holders[0]).peek((block_hash, cid))
                for sat in missing:
                    self.store_for(sat).set((block_hash, cid), chunk)
                    self.transport.stats.messages += 1
                    self.transport.stats.bytes_moved += len(chunk)
                    repaired += 1
            if lost:
                self.purge_block(block_hash)
                self.stats.lost_blocks += 1
            elif from_ground:
                self.stats.repaired_from_ground += 1
        self.stats.repaired_chunks += repaired
        return repaired

    # -- predictive prefetch (§3.7, closing remark) -----------------------
    def prefetch_for_rotation(self, block_hash: bytes, steps: int) -> int:
        """Pre-position a block's chunks where they will be needed after
        ``steps`` rotation steps (paper: 'the set of satellites in the LOS
        at that future time is known exactly').

        Copies each chunk to the satellites that will host *all* ``k``
        of its server's replica homes after the rotation (not just
        replica 0 -- a degraded read right after the window arrives
        should find its fall-through copies pre-positioned too);
        harmless double-residency until the window arrives (§3.7).  The
        source is the first live holder in placement order, so a dead
        replica-0 home does not defeat the prefetch; a currently-dead
        *destination* is skipped -- writing into it would resurrect data
        on heal that the dead satellite could never have received (the
        same rule migration applies to copies in transit).  Returns the
        number of chunk copies placed."""
        n_chunks = self._known_blocks.get(block_hash)
        if not n_chunks or self.strategy is Strategy.HOP:
            return 0
        f = self.faults
        # simulate the window/servers 'steps' ahead without moving data
        future_window = self.window
        future_map = list(self.server_map)
        for _ in range(steps):
            nw = future_window.shifted(self.spec, d_slot=1)
            for mv in migration_mod.plan_migration(
                    self.spec, future_window, nw, future_map):
                future_map[mv.server_id - 1] = mv.dst
            future_window = nw
        copied = 0
        for cid in range(n_chunks):
            sid = chunk_server(cid, self.num_servers)
            if self.server_sat(sid) == future_map[sid]:
                continue
            chunk = None
            for r in range(self.replication):
                src = self.replica_sat(sid, r)
                if f is not None and not f.sat_alive(src):
                    continue
                chunk = self.store_for(src).get((block_hash, cid))
                if chunk is not None:
                    break
            if chunk is None:
                continue
            for r in range(self.replication):
                dst = self._offset_sat(future_map[sid], r)
                if dst == self.replica_sat(sid, r):
                    continue
                if f is not None and not f.sat_alive(dst):
                    continue   # no resurrection on heal
                self.store_for(dst).set((block_hash, cid), chunk)
                self.transport.stats.messages += 1
                self.transport.stats.bytes_moved += len(chunk)
                copied += 1
        return copied

    # -- rotation (§3.4) --------------------------------------------------
    def execute_move(self, mv: migration_mod.Move) -> None:
        """Apply one planned migration: move the server's chunks -- every
        replica copy from its old home to the new one -- and repoint the
        server map.  With ``replication == 1`` a server's base home
        cannot cohabit with other servers' data, so the store drains
        wholesale (the seed fast path); replica homes *can* land on other
        servers' satellites, so under replication only this server's
        chunks (``chunk_server(cid) == sid``) are moved."""
        sid0 = mv.server_id - 1
        f = self.faults
        for r in range(self.replication):
            src_store = self.store_for(self._offset_sat(mv.src, r))
            dst = self._offset_sat(mv.dst, r)
            if self.replication == 1:
                items = src_store.pop_all()
            else:
                # peek, not get: migration is data shuffling, not use --
                # promoting every moved chunk on the shared LRU would
                # evict genuinely hot blocks in its place (the k=1
                # pop_all path touches nothing either)
                items = [
                    (key, src_store.peek(key))
                    for key in src_store.keys()
                    if chunk_server(key[1], self.num_servers) == sid0
                ]
                for key, _ in items:
                    src_store.delete(key)
            if f is not None and not f.sat_alive(dst):
                # a dead destination cannot receive the migration: the
                # copies are lost in transit (degraded reads fall through
                # to the other replicas; repair re-replicates once the
                # home -- old or new -- is alive again).  Writing them
                # anyway would "resurrect" data on heal that the dead
                # satellite could never have held.
                continue
            dst_store = self.store_for(dst)
            for key, value in items:
                dst_store.set(key, value)
                self.transport.stats.messages += 1
                self.transport.stats.bytes_moved += len(value)
        # the server's directory stripe rides along: every replica copy
        # of each entry homed on this stripe moves with it (one priced
        # message per entry), under the same dead-destination rule --
        # entries in transit to a dead satellite are dropped; lookups
        # fall through the surviving stripe copies and ``reconcile``
        # rewrites what the move lost.
        for r in range(self.dir_replication):
            src_shard = self._dir.shard(self._offset_sat(mv.src, r))
            moved = [(h, n) for h, n in src_shard.items()
                     if stripe_of(h, self.num_servers) == sid0]
            for h, _ in moved:
                del src_shard[h]
            dst = self._offset_sat(mv.dst, r)
            if f is not None and not f.sat_alive(dst):
                continue
            dst_shard = self._dir.shard(dst)
            for h, n in moved:
                dst_shard[h] = n
                self.transport.stats.messages += 1
        self.server_map[sid0] = mv.dst
        self.stats.migrations += 1

    def rotate(self, steps: int = 1) -> list[migration_mod.Move]:
        """Advance the LOS window ``steps`` within-plane positions and
        migrate chunks of exiting satellites (no-op for HOP: on-board).
        A step ends with a ``repair`` pass when the attached fault
        source has applied events since the last pass or still has live
        faults (active outages let migrations drop copies in transit):
        churn losses are re-replicated as part of the orbital
        housekeeping the window shift already is.  Over a clean fabric
        partial replica sets cannot arise -- set writes every home and
        purges sweep them all -- so the scan is skipped rather than paid
        under the serving lock."""
        self._tick_faults()
        all_moves: list[migration_mod.Move] = []
        for _ in range(steps):
            new_window = self.window.shifted(self.spec, d_slot=1)
            if self.strategy is Strategy.HOP:
                self.window = new_window
                continue
            moves = migration_mod.plan_migration(
                self.spec, self.window, new_window, self.server_map
            )
            for mv in moves:
                self.execute_move(mv)
            self.window = new_window
            all_moves.extend(moves)
            if self.injector is not None and (
                    not self.injector.state.clean
                    or self.injector.stats.events_applied
                    != self._repaired_at_event):
                # partial replica sets only arise from fault events (or,
                # while faults are ACTIVE, from migrations whose dead
                # destinations drop copies in transit) -- an armed-but-
                # quiet injector over a clean fabric has nothing to
                # repair, so skip the directory scan on those steps
                self.repair()
                self._repaired_at_event = (
                    self.injector.stats.events_applied)
        return all_moves


# ---------------------------------------------------------------------------
# Per-replica anchored views over one shared constellation.
# ---------------------------------------------------------------------------

class ConstellationView:
    """An anchored, per-replica facade over a shared ``ConstellationKVC``.

    Storage state -- satellite chunk stores, the block directory, the
    server map, the shared eviction policy -- belongs to the base and is
    visible through every view, so N serving replicas share ONE orbital
    cache.  What is private per view: the ``IslTransport`` (ops originate
    from this view's ``anchor``, so hop costs, completion times, and
    transport stats are the replica's own) and a ``CacheStats`` (per-
    replica hit/miss accounting).  Mutating ops (rotation, purges) always
    go through the base, so views can never diverge.
    """

    def __init__(self, base: ConstellationKVC,
                 transport: IslTransport) -> None:
        self.base = base
        self.transport = transport
        self.stats = CacheStats()

    @property
    def anchor(self) -> Sat:
        return self.transport.src_for(self.base.center)

    # -- shared-state passthrough --------------------------------------
    @property
    def spec(self) -> ConstellationSpec:
        return self.base.spec

    @property
    def window(self) -> LosWindow:
        return self.base.window

    @property
    def strategy(self) -> Strategy:
        return self.base.strategy

    @property
    def num_servers(self) -> int:
        return self.base.num_servers

    @property
    def chunk_bytes(self) -> int:
        return self.base.chunk_bytes

    @property
    def replication(self) -> int:
        return self.base.replication

    @property
    def dir_replication(self) -> int:
        return self.base.dir_replication

    @property
    def faults(self):
        return self.base.faults

    @property
    def ground(self) -> "GroundStationTier | None":
        return self.base.ground

    def repair(self) -> int:
        return self.base.repair()

    def reconcile(self) -> int:
        return self.base.reconcile()

    @property
    def directory(self) -> dict[bytes, int]:
        return self.base.directory

    @property
    def policy(self):
        return self.base.policy

    def adopt_policy(self, policy) -> None:
        self.base.adopt_policy(policy)

    @property
    def on_block_lost(self) -> Callable[[bytes], None] | None:
        return self.base.on_block_lost

    @on_block_lost.setter
    def on_block_lost(self, cb: Callable[[bytes], None] | None) -> None:
        self.base.on_block_lost = cb

    def server_sat(self, server_id0: int) -> Sat:
        return self.base.server_sat(server_id0)

    def store_for(self, sat: Sat) -> SatelliteStore:
        return self.base.store_for(sat)

    def rotate(self, steps: int = 1) -> list[migration_mod.Move]:
        return self.base.rotate(steps)

    def purge_block(self, block_hash: bytes) -> int:
        return self.base.purge_block(block_hash)

    # -- anchored ops --------------------------------------------------
    def set_block(self, block_hash: bytes, payload: bytes) -> BlockMeta:
        return self.base.set_block(block_hash, payload,
                                   via=self.transport, stats=self.stats)

    def has_block(self, block_hash: bytes) -> bool:
        return self.base.has_block(block_hash,
                                   via=self.transport, stats=self.stats)

    def get_block(self, block_hash: bytes,
                  n_chunks: int | None = None) -> bytes | None:
        return self.base.get_block(block_hash, n_chunks,
                                   via=self.transport, stats=self.stats)

    def lookup_longest(self, hashes: Sequence[bytes]) -> int:
        return self.base.lookup_longest(hashes,
                                        via=self.transport, stats=self.stats)

    def estimate_get_latency_s(
        self, *, payload_bytes: int | None = None,
        block_hash: bytes | None = None,
    ) -> float:
        return self.base.estimate_get_latency_s(
            self.anchor, payload_bytes=payload_bytes,
            transport=self.transport, block_hash=block_hash)


# ---------------------------------------------------------------------------
# Paper §3.3 interface.
# ---------------------------------------------------------------------------

# (tokens, past_payload|None, past_len) -> payload bytes for the next block.
KvcFn = Callable[[Sequence[int], bytes | None, int], bytes]


class KVCManager:
    """``init(model, tokenizer) / add_blocks(prompt) / get_cache(prompt)``.

    ``kvc_fn`` computes the serialized KVC payload of one token block given
    the payload covering the preceding blocks -- supplied by the serving
    layer (any model family: K/V lists or SSM state snapshots; the protocol
    only sees bytes).  The §3.10 radix tree indexes block hashes locally so
    lookups usually skip the constellation entirely.

    Scale-out: ``sibling(cache_view)`` binds another serving replica to
    the SAME radix index, recency policy, hash-chain map and lock -- one
    prefix index over one shared constellation, N anchored entry points.
    Every index-mutating / index-reading method takes the (reentrant)
    ``lock``, so sibling replicas may call in concurrently from their own
    threads.
    """

    def __init__(
        self,
        tokenize: Callable[[str], list[int]],
        kvc_fn: KvcFn,
        cache: "ConstellationKVC | ConstellationView",
        *,
        block_size: int = 128,
        use_radix: bool = True,
        policy=None,
        index: RadixBlockIndex | None = None,
        chain_map: dict[bytes, list[bytes]] | None = None,
        lock: "threading.RLock | None" = None,
    ) -> None:
        self.tokenize = tokenize
        self.kvc_fn = kvc_fn
        self.cache = cache
        self.block_size = block_size
        self.use_radix = use_radix
        if policy is None:
            # local import: eviction imports this module at its top level
            from repro_torch.core.eviction import LRUClock

            policy = LRUClock()
        self.policy = policy
        self.index = index if index is not None else RadixBlockIndex(
            policy=policy)
        self.lock = lock if lock is not None else threading.RLock()
        cache.adopt_policy(policy)
        cache.on_block_lost = self._on_block_lost
        self._hash_to_chain: dict[bytes, list[bytes]] = (
            chain_map if chain_map is not None else {})

    def sibling(self, cache: "ConstellationKVC | ConstellationView"
                ) -> "KVCManager":
        """A manager over the same radix index / policy / chain map /
        lock, bound to a different cache handle (typically an anchored
        ``ConstellationView``) -- the per-replica handle in a scale-out
        cluster.  All siblings see one shared prefix index; only
        transport anchoring and stats attribution differ."""
        return KVCManager(
            self.tokenize, self.kvc_fn, cache,
            block_size=self.block_size, use_radix=self.use_radix,
            policy=self.policy, index=self.index,
            chain_map=self._hash_to_chain, lock=self.lock,
        )

    def _on_block_lost(self, block_hash: bytes) -> None:
        with self.lock:
            chain = self._hash_to_chain.pop(block_hash, None)
            if chain is not None:
                self.index.remove(chain)

    # ------------------------------------------------------------------
    def add_blocks(self, prompt: str) -> int:
        """Compute + store the KVC for every uncached full block (Set KVC)."""
        return self.add_blocks_tokens(self.tokenize(prompt))

    def add_blocks_tokens(self, tokens: Sequence[int]) -> int:
        """Token-level Set KVC (serving engines pass their exact, possibly
        truncated token sequence so cache coverage matches what they run).

        The lock is held for index reads and store writes only -- the
        payload computation (one model forward per uncached block) runs
        *outside* it, so sibling replicas keep looking up and writing
        while this replica computes.  A concurrent duplicate therefore
        really misses until the write-back lands (the race prefix-
        affinity routing exists to win); if two replicas compute the same
        block, the second insert overwrites it with identical bytes."""
        hashes = chain_hashes(tokens, self.block_size)
        if not hashes:
            return 0
        blocks = split_token_blocks(tokens, self.block_size)
        with self.lock:
            n_cached, _ = (
                self.index.longest_cached_prefix(hashes)
                if self.use_radix
                else (self.cache.lookup_longest(hashes), None)
            )
            past: bytes | None = None
            if n_cached:
                # lazily-evicted tails (or broken delta chains) shrink
                # the resumable prefix; a None past means recompute all
                past, n_cached = self._fetch_cumulative(hashes, n_cached)
        payloads: list[bytes] = []
        for i in range(n_cached, len(hashes)):
            block_tokens = [t for b in blocks[: i + 1] for t in b]
            payload = self.kvc_fn(block_tokens, past, i * self.block_size)
            payloads.append(payload)
            # a delta payload covers only its own block: the *cumulative*
            # resume state for the next kvc_fn call is the running cat
            if past is not None and is_delta_payload(payload):
                past = cat_payloads([past, payload])
            else:
                past = payload
        if not payloads:
            return 0
        with self.lock:
            metas: list[BlockMeta | None] = [None] * len(hashes)
            stored_upto = len(hashes)
            for i, payload in zip(range(n_cached, len(hashes)), payloads):
                meta = self.cache.set_block(hashes[i], payload)
                if not meta.stored:
                    # the fabric could not land a single copy of some
                    # chunk (total outage on a stripe member): indexing
                    # the hash would create a phantom entry the
                    # directory knows nothing about and no repair pass
                    # could ever prune.  Later blocks of the chain are
                    # unreachable through the radix walk anyway; stop.
                    stored_upto = i
                    break
                metas[i] = meta
                self._hash_to_chain[hashes[i]] = list(hashes[: i + 1])
            if self.use_radix and stored_upto:
                self.index.insert(hashes[:stored_upto], metas[:stored_upto])
        return min(len(payloads), max(0, stored_upto - n_cached))

    def add_precomputed_blocks(
        self,
        tokens: Sequence[int],
        payload_for: Callable[[int], bytes],
    ) -> int:
        """Set KVC for uncached full blocks whose payloads the caller
        already *has* -- ``payload_for(n_blocks)`` returns the serialized
        payload covering blocks ``[0, n_blocks)``.

        This is the swap-tier write path: a preempted sequence's pool
        pages hold the exact K/V of its block-aligned prefix, so spilling
        them to the constellation must not re-run the model the way
        ``add_blocks_tokens`` does -- the bytes are rebuilt from the
        exported pages instead.  Radix indexing and chain hashing are
        identical to the computed path, so later lookups cannot tell the
        difference."""
        hashes = chain_hashes(tokens, self.block_size)
        if not hashes:
            return 0
        with self.lock:
            n_cached, _ = (
                self.index.longest_cached_prefix(hashes)
                if self.use_radix
                else (self.cache.lookup_longest(hashes), None)
            )
            added = 0
            metas: list[BlockMeta | None] = [None] * len(hashes)
            stored_upto = len(hashes)
            for i in range(n_cached, len(hashes)):
                payload = payload_for(i + 1)
                meta = self.cache.set_block(hashes[i], payload)
                if not meta.stored:       # see add_blocks_tokens
                    stored_upto = i
                    break
                metas[i] = meta
                self._hash_to_chain[hashes[i]] = list(hashes[: i + 1])
                added += 1
            if self.use_radix and added:
                self.index.insert(hashes[:stored_upto], metas[:stored_upto])
            return added

    def get_cache(self, prompt: str) -> tuple[bytes | None, int]:
        """Longest-prefix KVC for ``prompt`` (Get KVC).

        Returns ``(payload, n_cached_tokens)``; ``(None, 0)`` on full miss.
        """
        return self.get_cache_tokens(self.tokenize(prompt))

    def get_cache_tokens(
        self, tokens: Sequence[int]
    ) -> tuple[bytes | None, int]:
        """Token-level Get KVC (longest cached prefix of ``tokens``)."""
        hashes = chain_hashes(tokens, self.block_size)
        if not hashes:
            return None, 0
        with self.lock:
            if self.use_radix:
                n, _meta = self.index.longest_cached_prefix(hashes)
            else:
                n = self.cache.lookup_longest(hashes)
            n0 = n
            payload, n = self._fetch_cumulative(hashes, n)
            if payload is not None:
                if n < n0:
                    self._count_shortened_prefix()
                return payload, n * self.block_size
            if n0 > 0:
                self._count_shortened_prefix()
            return None, 0

    def _fetch_cumulative(
        self, hashes: Sequence[bytes], n: int
    ) -> tuple[bytes | None, int]:
        """Payload covering blocks ``[0, n')`` for the largest ``n' <= n``
        the fabric can still serve, walking back on lazy evictions.

        A non-delta payload is cumulative: one Get covers the whole
        prefix.  A delta payload covers only its own block, so the chain
        is fetched back to its nearest cumulative base -- every leg a
        real, priced Get -- and reassembled into a cat container whose
        decode concatenates the segments along the token axis.  A
        missing block below a delta makes everything above it
        unreconstructible: the walk restarts from just under the hole.
        """
        while n > 0:
            segs: list[bytes] = []
            j = n - 1
            while True:
                payload = self.cache.get_block(hashes[j])
                if payload is None:
                    n = j      # blocks >= j are gone or chained onto j
                    break
                segs.append(payload)
                if not is_delta_payload(payload):
                    segs.reverse()
                    return cat_payloads(segs), n
                if j == 0:     # a delta with no base under it: unusable
                    n = 0
                    break
                j -= 1
        return None, 0

    def _count_shortened_prefix(self) -> None:
        """The index/lookup promised a prefix the fabric could not serve
        (e.g. a *later* chunk evicted from every replica while chunk-0
        probes still answered): the walk-back above degraded it to a
        shorter prefix instead of failing.  Count it so serving stats can
        surface the mismatch."""
        stats = getattr(self.cache, "stats", None)
        if stats is not None and hasattr(stats, "shortened_prefixes"):
            stats.shortened_prefixes += 1
