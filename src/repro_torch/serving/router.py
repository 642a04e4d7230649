"""Request routing across Engine replicas sharing one constellation.

(A copy of ``repro/serving/router.py``.)

The cluster's front door: every request is scored against each replica
before it is handed to that replica's engine.  Two policies:

* ``PrefixAffinityRouter`` -- the hop-aware, prefix-affinity policy the
  scale-out design is built around.  Per candidate replica the score
  combines three signals, all in token units:

  - **affinity**: the longest leading run of the request's block-hash
    chain this router previously sent to the replica.  Duplicated
    contexts (the paper's RAG workload) land on the replica whose
    write-back is already in flight or indexed, so they hit instead of
    racing a concurrent miss on another replica.
  - **hop cost**: when the shared radix index says a prefix is already
    in the constellation, fetching it costs a Get KVC whose latency
    depends on the replica's *anchor* satellite
    (``ConstellationView.estimate_get_latency_s`` -- the same transport
    model the fetch will later experience).  Nearer anchors win among
    replicas whose affinity/load score ties; hop distance never outbids
    cached history.
  - **load**: outstanding assigned tokens, as a weighted penalty
    (``w_load``, 0 by default) AND as the explicit tie-break -- equal
    scores go to the emptier replica, so fresh traffic round-robins.

* ``RandomRouter`` -- the seeded uniform baseline every benchmark
  compares against.

Routers are deliberately engine-agnostic: they speak token lists and
replica indices, and track their own assignment state, so they can be
unit-tested without building a single engine.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

from repro_torch.core.hashing import chain_hashes


@dataclass
class ReplicaHandle:
    """What the router knows about one replica.

    ``view`` is the replica's anchored ``ConstellationView`` (or None for
    a fabric-less cluster): its only use here is hop-cost estimation.
    ``load_tokens`` counts outstanding assigned work (prompt plus
    requested new tokens); ``seen_blocks`` are the block hashes of
    prompts routed to this replica -- the affinity memory, an
    insertion-ordered dict so it can be FIFO-bounded
    (``Router.max_seen_blocks``) instead of accreting every hash a
    long-lived cluster ever routed.
    """

    index: int
    view: object | None = None
    load_tokens: int = 0
    seen_blocks: dict = field(default_factory=dict)

    def affinity_blocks(self, hashes: list[bytes]) -> int:
        """Longest leading run of ``hashes`` previously routed here."""
        n = 0
        for h in hashes:
            if h not in self.seen_blocks:
                break
            n += 1
        return n

    def note_blocks(self, hashes: list[bytes], cap: int) -> None:
        """Record routed hashes; re-insertion refreshes recency, and the
        oldest entries are dropped past ``cap``."""
        for h in hashes:
            self.seen_blocks.pop(h, None)
            self.seen_blocks[h] = None
        while len(self.seen_blocks) > cap:
            del self.seen_blocks[next(iter(self.seen_blocks))]

    def reset(self) -> None:
        self.load_tokens = 0
        self.seen_blocks.clear()


@dataclass(frozen=True)
class RouteDecision:
    """One routing verdict, with the signals that produced it (the
    benchmark and the tests read these instead of re-deriving them)."""

    replica: int
    affinity_tokens: int      # router-local prefix match on the winner
    cached_blocks: int        # shared-index cached prefix (any replica)
    hop_latency_s: float      # est. Get latency from the winner's anchor
    load_tokens: int          # winner's load BEFORE this assignment
    committed_tokens: int = 0  # load this assignment added (for release)


class Router:
    """Base: assignment bookkeeping shared by every policy."""

    def __init__(self, handles: list[ReplicaHandle], *,
                 manager=None, block_size: int | None = None,
                 max_seen_blocks: int = 65536,
                 bytes_per_token: float | None = None,
                 delta_payloads: bool = False) -> None:
        if not handles:
            raise ValueError("router needs at least one replica")
        self.handles = handles
        self.manager = manager          # shared KVCManager (index + lock)
        self.block_size = (block_size if block_size is not None
                           else (manager.block_size if manager else 128))
        self.max_seen_blocks = max_seen_blocks
        # codec-derived size model (SkyKVCAdapter.payload_bytes_per_token):
        # when a cached block carries no registered payload_bytes, hop
        # estimates price encoded bytes from this instead of assuming a
        # full f32 stripe -- so a quantized fabric's router and its
        # experienced fetches agree on sizes by construction.  Under
        # delta payloads the tail Get ships one block, not the prefix.
        self.bytes_per_token = bytes_per_token
        self.delta_payloads = delta_payloads
        # streaming serves route at the front door while per-request
        # releases arrive from engine worker threads (future callbacks):
        # one lock keeps load accounting and affinity memory coherent.
        # Always taken BEFORE the manager lock (never after), so it
        # cannot deadlock against engines holding the fabric lock.
        self.lock = threading.Lock()

    # -- shared signals -------------------------------------------------
    def _cached_prefix(
        self, hashes: list[bytes]
    ) -> tuple[int, int | None, bytes | None]:
        """(blocks, payload_bytes, tail_hash) of the request's longest
        prefix in the shared radix index.  ``payload_bytes`` sizes the
        single Get KVC a hit will actually issue (the final block's
        cumulative payload) and ``tail_hash`` is that block's hash, so
        hop estimates can price the chunk servers the block really spans
        AND the exact directory-stripe lookup leg the fetch will pay --
        keeping the router's estimate and the experienced latency on the
        same path."""
        if self.manager is None or not hashes:
            return 0, None, None
        with self.manager.lock:
            n, meta = self.manager.index.longest_cached_prefix(hashes)
        tail = hashes[n - 1] if n else None
        if n and meta is not None and meta.payload_bytes:
            return n, meta.payload_bytes, tail
        if n and self.bytes_per_token:
            # unregistered block: fall back to the codec's size model
            blocks = 1 if self.delta_payloads else n
            return n, max(1, round(blocks * self.block_size
                                   * self.bytes_per_token)), tail
        return n, None, tail

    def _commit(self, h: ReplicaHandle, hashes: list[bytes],
                n_tokens: int, est_new_tokens: int) -> int:
        committed = n_tokens + est_new_tokens
        h.load_tokens += committed
        h.note_blocks(hashes, self.max_seen_blocks)
        return committed

    def release(self, replica: int, n_tokens: int) -> None:
        """Return finished work's tokens to the load accounting (per
        request on the streaming path; batch serves release at end)."""
        with self.lock:
            h = self.handles[replica]
            h.load_tokens = max(0, h.load_tokens - n_tokens)

    def total_load(self) -> int:
        """Outstanding committed tokens across every replica -- the
        overload signal the streaming admission controller sheds on."""
        with self.lock:
            return sum(h.load_tokens for h in self.handles)

    def reset(self) -> None:
        with self.lock:
            for h in self.handles:
                h.reset()

    def route(self, tokens: list[int], *,
              est_new_tokens: int = 0) -> RouteDecision:
        raise NotImplementedError


class RandomRouter(Router):
    """Uniform seeded assignment -- the scale-out baseline."""

    def __init__(self, handles: list[ReplicaHandle], *, manager=None,
                 block_size: int | None = None, seed: int = 0,
                 max_seen_blocks: int = 65536) -> None:
        super().__init__(handles, manager=manager, block_size=block_size,
                         max_seen_blocks=max_seen_blocks)
        self._rng = random.Random(seed)

    def route(self, tokens: list[int], *,
              est_new_tokens: int = 0) -> RouteDecision:
        hashes = chain_hashes(tokens, self.block_size)
        cached = self._cached_prefix(hashes)[0]
        with self.lock:
            h = self.handles[self._rng.randrange(len(self.handles))]
            load_before = h.load_tokens
            return RouteDecision(
                replica=h.index,
                affinity_tokens=h.affinity_blocks(hashes) * self.block_size,
                cached_blocks=cached,
                hop_latency_s=0.0,
                load_tokens=load_before,
                committed_tokens=self._commit(h, hashes, len(tokens),
                                              est_new_tokens),
            )


class PrefixAffinityRouter(Router):
    """Hop-aware, prefix-affinity scoring (see the module docstring).

    The criteria are *lexicographic*: the primary score is affinity
    tokens minus the (optional, ``w_load``-weighted) load penalty; the
    anchor-to-home-satellite fetch latency decides only between
    replicas whose primary scores tie.  Hop distance therefore stays
    fully discriminative among equal-affinity candidates but can never
    outbid cached history -- on wide-window constellations anchor
    latencies differ by >100 ms, which a weighted sum would let split a
    duplicate group away from its affinity home.  Remaining ties go to
    the emptier replica, then the lower index.  ``w_load`` defaults to
    0 (load is still the tie-break); raise it to trade affinity against
    queue balance.
    """

    def __init__(self, handles: list[ReplicaHandle], *, manager=None,
                 block_size: int | None = None, w_affinity: float = 1.0,
                 w_load: float = 0.0, max_seen_blocks: int = 65536,
                 bytes_per_token: float | None = None,
                 delta_payloads: bool = False) -> None:
        super().__init__(handles, manager=manager, block_size=block_size,
                         max_seen_blocks=max_seen_blocks,
                         bytes_per_token=bytes_per_token,
                         delta_payloads=delta_payloads)
        self.w_affinity = w_affinity
        self.w_load = w_load

    def route(self, tokens: list[int], *,
              est_new_tokens: int = 0) -> RouteDecision:
        hashes = chain_hashes(tokens, self.block_size)
        cached, payload_bytes, tail_hash = self._cached_prefix(hashes)
        with self.lock:
            best_h: ReplicaHandle | None = None
            best_key = None
            best_aff = 0
            best_hop = 0.0
            for h in self.handles:
                aff_tokens = h.affinity_blocks(hashes) * self.block_size
                hop_s = 0.0
                if cached and h.view is not None:
                    hop_s = h.view.estimate_get_latency_s(
                        payload_bytes=payload_bytes, block_hash=tail_hash)
                score = (self.w_affinity * aff_tokens
                         - self.w_load * h.load_tokens)
                # hop latency splits equal-score candidates; remaining
                # ties go to the emptier replica, then the lower index
                key = (score, -hop_s, -h.load_tokens, -h.index)
                if best_key is None or key > best_key:
                    best_h, best_key = h, key
                    best_aff, best_hop = aff_tokens, hop_s
            load_before = best_h.load_tokens
            return RouteDecision(
                replica=best_h.index,
                affinity_tokens=best_aff,
                cached_blocks=cached,
                hop_latency_s=best_hop,
                load_tokens=load_before,
                committed_tokens=self._commit(best_h, hashes, len(tokens),
                                              est_new_tokens),
            )


def make_router(policy: str, handles: list[ReplicaHandle], *,
                manager=None, block_size: int | None = None,
                seed: int = 0, bytes_per_token: float | None = None,
                delta_payloads: bool = False) -> Router:
    """``"prefix_affinity"`` or ``"random"`` -> a configured router."""
    if policy == "prefix_affinity":
        return PrefixAffinityRouter(handles, manager=manager,
                                    block_size=block_size,
                                    bytes_per_token=bytes_per_token,
                                    delta_payloads=delta_payloads)
    if policy == "random":
        return RandomRouter(handles, manager=manager,
                            block_size=block_size, seed=seed)
    raise ValueError(f"unknown routing policy: {policy!r}")
