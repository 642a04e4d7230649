"""The port's own copy of SkyMemory's core (``repro/core``): the
constellation geometry, server placement, rotation migration, the
striped directory, per-satellite stores, the radix index, the Set/Get
KVC protocol with its ``KVCManager``, the KVC payload format and its
codecs, the eviction policies, and the fault model (``FaultPlan``,
``FaultInjector``).  Numpy and plain Python.  The simulator and the TPU
torus cache are not ported here."""
from repro_torch.core.chunking import (
    PayloadCodec,
    arrays_to_bytes,
    bytes_to_arrays,
    cat_payloads,
    chunk_server,
    decode_payload_arrays,
    delta_info,
    encode_arrays,
    is_cat_payload,
    is_delta_payload,
    join_chunks,
    make_delta_payload,
    num_chunks,
    payload_raw_bytes,
    replica_delta,
    split_cat_payload,
    split_chunks,
)
from repro_torch.core.constellation import (
    C_KM_S,
    R_EARTH_KM,
    ConstellationSpec,
    LosWindow,
    Sat,
)
from repro_torch.core.directory import StripedDirectory, stripe_of
from repro_torch.core.eviction import GossipCost, LRUClock, gossip_cost, run_periodic_sweep
from repro_torch.core.faults import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
    FaultState,
    plan_survivable_kills,
)
from repro_torch.core.hashing import NULL_HASH, chain_hashes, hash_block, split_token_blocks
from repro_torch.core.mapping import Strategy, bounding_box_side, layout_grid, place_servers
from repro_torch.core.migration import Move, migration_planes, plan_migration
from repro_torch.core.protocol import (
    CacheStats,
    ConstellationKVC,
    ConstellationView,
    GroundStats,
    GroundStationTier,
    IslTransport,
    KVCManager,
    SimClock,
    TransportStats,
)
from repro_torch.core.radix import BlockMeta, RadixBlockIndex
from repro_torch.core.store import SatelliteStore
