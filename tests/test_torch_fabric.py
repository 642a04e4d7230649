"""The port's SkyMemory fabric (``repro_torch.core``) against the
reference (``repro.core``), on the CPU.

The same seeded inputs go through both packages:

* the pure functions, value by value: block hashes, chunk striping,
  payload header scans, server placement, rotation migration, directory
  stripes, the radix index and the satellite stores' eviction order;
* a seeded trace of a few hundred operations over ``ConstellationKVC``
  (two replicas, stores small enough to evict, a spill-to-ground tier):
  every return value, the fabric's stored keys and directory, and every
  field of ``CacheStats``, ``GroundStats`` and ``TransportStats`` after
  each step.  Float latencies match to 1e-12.  The wall-clock fields
  (``BlockMeta.set_time``, ``SimClock``) are never compared;
* ``KVCManager`` over each package's fabric, with and without the radix
  index, and a toy ``kvc_fn``;
* ``Engine(kvc=)``: each package's engine over its own constellation on
  the TinyLlama smoke config (chunked and stop-the-world admission) and
  the mamba2 smoke config: identical greedy streams, cached tokens and
  fabric counters.

Objects of the two packages never compare equal (each has its own
dataclasses), so satellites and moves are compared as tuples.
"""
import dataclasses
import hashlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs import get_config, smoke_config
from repro.core import chunking as jchunking
from repro.core import eviction as jeviction
from repro.core import hashing as jhashing
from repro.models.model import Model as JaxModel
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import chunking as tchunking
from repro_torch.core import eviction as teviction
from repro_torch.core import hashing as thashing
from repro_torch.serving import Engine, Request, SamplingParams

torch.set_num_threads(2)
LAT = dict(rel=0, abs=1e-12)


def _norm(x):
    """A value of either package as plain Python: satellites and moves
    as tuples, block metadata without its wall-clock ``set_time``."""
    name = type(x).__name__
    if name == "Sat":
        return (x.plane, x.slot)
    if name == "Move":
        return (x.server_id, _norm(x.src), _norm(x.dst))
    if name == "BlockMeta":
        return (x.n_chunks, x.payload_bytes, x.stored)
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_size", [1, 16, 128])
def test_block_hashes_match(block_size):
    rng = np.random.default_rng(block_size)
    for n in (0, 1, block_size - 1, block_size, 3 * block_size + 5, 300):
        toks = rng.integers(0, 32000, max(n, 0)).tolist()
        assert (thashing.chain_hashes(toks, block_size)
                == jhashing.chain_hashes(toks, block_size))
        assert (thashing.split_token_blocks(toks, block_size)
                == jhashing.split_token_blocks(toks, block_size))
        for prev in (T.NULL_HASH, hashlib.sha256(b"x").digest()):
            assert (thashing.hash_block(prev, toks)
                    == jhashing.hash_block(prev, toks))
    assert T.NULL_HASH == J.NULL_HASH


def test_chunk_striping_matches():
    rng = np.random.default_rng(0)
    for size in (0, 1, 63, 64, 65, 1000, 6 * 1024 * 3 + 7):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for cb in (1, 7, 64, 6 * 1024):
            got = T.split_chunks(data, cb)
            assert got == J.split_chunks(data, cb)
            assert T.num_chunks(len(data), cb) == J.num_chunks(len(data), cb)
            assert len(got) == T.num_chunks(len(data), cb)
            assert T.join_chunks(got) == data
    for exc_side in (T.split_chunks, J.split_chunks):
        with pytest.raises(ValueError):
            exc_side(b"ab", 0)
    assert ([T.chunk_server(c, n) for c in range(40) for n in (1, 7, 10)]
            == [J.chunk_server(c, n) for c in range(40) for n in (1, 7, 10)])
    for planes, slots in ((5, 19), (3, 4), (1, 1), (15, 15)):
        assert ([T.replica_delta(r, planes, slots) for r in range(12)]
                == [J.replica_delta(r, planes, slots) for r in range(12)])
    for fn in (T.replica_delta, J.replica_delta):
        with pytest.raises(ValueError):
            fn(-1, 5, 19)


def _reference_payloads():
    """Payloads the reference's encoder writes: SKYM (f32, bf16, int8),
    int8 and int4 ENC containers over a bf16 source, a DELTA segment,
    a CAT container, and bytes no header describes."""
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
    bf16 = f32.astype(ml_dtypes.bfloat16)
    i8 = rng.integers(-100, 100, (2, 8, 2, 4)).astype(np.int8)
    skym = jchunking.arrays_to_bytes([f32, bf16, i8])
    out = {"skym": skym, "skym_bf16": jchunking.arrays_to_bytes([bf16])}
    for name in ("int8", "int4"):
        codec = jchunking.PayloadCodec(name, block_tokens=4)
        out[f"enc_{name}"] = jchunking.encode_arrays([f32, bf16, i8], codec)
        out[f"enc_{name}_bf16"] = jchunking.encode_arrays([bf16], codec)
    prev = hashlib.sha256(b"prev").digest()
    out["delta"] = jchunking.make_delta_payload(out["enc_int8"], prev, 16)
    out["cat"] = jchunking.cat_payloads([skym, out["delta"]])
    out["cat_nested"] = jchunking.cat_payloads([out["cat"],
                                                out["enc_int4_bf16"]])
    out["opaque"] = b"not a payload at all"
    out["truncated"] = out["enc_int8"][:40]
    out["empty"] = b""
    return out, bf16


def test_payload_headers_match_reference():
    """The header-only scans agree on every container the reference
    writes.  A bf16 ENC payload counts 2 bytes per value: the port maps
    the ``bfloat16`` tag itself, with no ``ml_dtypes``."""
    payloads, bf16 = _reference_payloads()
    for name, p in payloads.items():
        assert T.payload_raw_bytes(p) == J.payload_raw_bytes(p), name
        assert T.is_delta_payload(p) == J.is_delta_payload(p), name
        assert T.is_cat_payload(p) == jchunking.is_cat_payload(p), name
        if J.is_delta_payload(p):
            assert T.delta_info(p) == jchunking.delta_info(p)
        if jchunking.is_cat_payload(p):
            assert T.split_cat_payload(p) == jchunking.split_cat_payload(p)
    assert T.payload_raw_bytes(payloads["enc_int8_bf16"]) == bf16.size * 2
    assert T.payload_raw_bytes(payloads["enc_int4_bf16"]) == bf16.size * 2
    assert T.payload_raw_bytes(payloads["opaque"]) == len(payloads["opaque"])
    for parts in (["skym", "delta"], ["cat", "enc_int4_bf16"], ["skym"],
                  ["cat_nested", "cat"]):
        ps = [payloads[k] for k in parts]
        assert T.cat_payloads(ps) == J.cat_payloads(ps)
    # a bf16 tensor the port encodes is counted like the reference's own
    tb = torch.from_numpy(bf16.view(np.int16).copy()).view(torch.bfloat16)
    tbytes = T.arrays_to_bytes([tb])
    assert tbytes == payloads["skym_bf16"]
    assert T.payload_raw_bytes(tbytes) == J.payload_raw_bytes(tbytes)
    with pytest.raises(ValueError, match="not a delta"):
        T.delta_info(payloads["skym"])
    # and the bodies decode as the reference decodes them (the nested cat
    # joins 3-array segments to a 1-array one: both refuse it)
    for mod in (J, T):
        with pytest.raises(ValueError, match="ragged"):
            mod.decode_payload_arrays(payloads["cat_nested"])
    for name in ("delta", "cat", "enc_int4_bf16"):
        got = T.decode_payload_arrays(payloads[name])
        want = J.decode_payload_arrays(payloads[name])
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            if w.dtype == bf16.dtype:
                g, w = g.view(torch.int16).numpy(), w.view(np.int16)
            np.testing.assert_array_equal(g, w)


SPECS = [((15, 15), (7, 7), 9, 9), ((5, 19), (2, 9), 5, 5),
         ((4, 6), (0, 0), 3, 3)]


def _specs(mod, i):
    (planes, slots), (cp, cs), rows, cols = SPECS[i]
    spec = mod.ConstellationSpec(planes, slots, 550.0)
    return spec, mod.LosWindow(mod.Sat(cp, cs), rows, cols)


@pytest.mark.parametrize("spec_i", range(len(SPECS)))
def test_placement_and_migration_match(spec_i):
    """``place_servers`` for every strategy, then ``plan_migration`` of
    that map over window shifts, as tuples; the geometry they rest on
    (hops, latencies) agrees too."""
    jspec, jwin = _specs(J, spec_i)
    tspec, twin = _specs(T, spec_i)
    for js, ts in zip(J.Strategy, T.Strategy):
        assert js.value == ts.value
        for n in (1, 4, 5, 9, 10, 25):
            try:
                jmap = J.place_servers(js, jspec, jwin, n)
            except ValueError as e:
                # more servers than the window (ROTATION) or the torus holds
                with pytest.raises(ValueError, match=str(e)[:20]):
                    T.place_servers(ts, tspec, twin, n)
                continue
            tmap = T.place_servers(ts, tspec, twin, n)
            assert _norm(tmap) == _norm(jmap)
            for d_slot in (1, 2, -1, 3):
                jm = J.plan_migration(jspec, jwin,
                                      jwin.shifted(jspec, d_slot), jmap)
                tm = T.plan_migration(tspec, twin,
                                      twin.shifted(tspec, d_slot), tmap)
                assert _norm(tm) == _norm(jm)
                assert ({p: _norm(ms) for p, ms in
                         T.migration_planes(tm).items()}
                        == {p: _norm(ms) for p, ms in
                            J.migration_planes(jm).items()})
        for side in (3, 5):
            assert T.layout_grid(ts, side) == J.layout_grid(js, side)
    assert ([T.bounding_box_side(n) for n in range(1, 50)]
            == [J.bounding_box_side(n) for n in range(1, 50)])
    sats = [(p, s) for p in range(jspec.num_planes)
            for s in range(jspec.sats_per_plane)][::3]
    for a in sats[:8]:
        for b in sats:
            ja, jb, ta, tb = J.Sat(*a), J.Sat(*b), T.Sat(*a), T.Sat(*b)
            assert tspec.hops(ta, tb) == jspec.hops(ja, jb)
            assert tspec.isl_latency_s(ta, tb, routed=True) == pytest.approx(
                jspec.isl_latency_s(ja, jb, routed=True), **LAT)
    assert tspec.uplink_latency_s() == jspec.uplink_latency_s()


def test_directory_stripes_match():
    rng = np.random.default_rng(5)
    hashes = [rng.bytes(32) for _ in range(200)]
    for n in (1, 7, 10, 25):
        assert ([T.stripe_of(h, n) for h in hashes]
                == [J.stripe_of(h, n) for h in hashes])


@pytest.mark.parametrize("with_policy", [False, True],
                         ids=["no_policy", "lru_clock"])
def test_radix_index_matches(with_policy):
    """Inserts of chains with shared prefixes, longest-prefix lookups and
    removals: the same answers, and the same recency stamps."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 500, 64).tolist()
    chains = []
    for i in range(12):
        cut = int(rng.integers(0, 64))
        toks = base[:cut] + rng.integers(0, 500, int(rng.integers(0, 40))).tolist()
        chains.append(J.chain_hashes(toks, 8))
    jpol = jeviction.LRUClock() if with_policy else None
    tpol = teviction.LRUClock() if with_policy else None
    jidx, tidx = J.RadixBlockIndex(policy=jpol), T.RadixBlockIndex(policy=tpol)
    for step in range(300):
        ch = chains[int(rng.integers(len(chains)))]
        op = int(rng.integers(4))
        if op == 0 and ch:
            k = int(rng.integers(1, len(ch) + 1))
            metas = [None if rng.random() < 0.2 else (k, i) for i in range(k)]
            jidx.insert(ch[:k], [None if m is None else J.BlockMeta(*m)
                                 for m in metas])
            tidx.insert(ch[:k], [None if m is None else T.BlockMeta(*m)
                                 for m in metas])
        elif op == 1 and ch:
            k = int(rng.integers(1, len(ch) + 1))
            assert tidx.remove(ch[:k]) == jidx.remove(ch[:k])
        else:
            jn, jm = jidx.longest_cached_prefix(ch)
            tn, tm = tidx.longest_cached_prefix(ch)
            assert (tn, _norm(tm)) == (jn, _norm(jm))
            assert _norm(tidx.get(ch)) == _norm(jidx.get(ch))
        assert len(tidx) == len(jidx)
        if with_policy:
            assert ([tpol.recency(h) for c in chains for h in c]
                    == [jpol.recency(h) for c in chains for h in c])


@pytest.mark.parametrize("with_policy", [False, True],
                         ids=["own_lru", "lru_clock"])
def test_satellite_store_eviction_order_matches(with_policy):
    rng = np.random.default_rng(17)
    evicted = {"j": [], "t": []}
    stores = {}
    for side, mod, ev in (("j", J, jeviction), ("t", T, teviction)):
        stores[side] = mod.SatelliteStore(
            capacity_bytes=300,
            on_evict=lambda st, k, v, side=side: evicted[side].append((k, v)),
            policy=ev.LRUClock() if with_policy else None)
    keys = [(bytes([i]) * 4, c) for i in range(8) for c in range(3)]
    for _ in range(400):
        key = keys[int(rng.integers(len(keys)))]
        op = int(rng.integers(6))
        value = rng.integers(0, 256, int(rng.integers(1, 80)),
                             dtype=np.uint8).tobytes()
        vals = []
        for st in stores.values():
            if op <= 1:
                vals.append(st.set(key, value))
            elif op == 2:
                vals.append(st.get(key))
            elif op == 3:
                vals.append(st.delete(key))
            elif op == 4:
                if st.policy is not None:
                    st.policy.touch(key[0])
                vals.append(st.touch(key))
            else:
                vals.append((st.peek(key), st.contains(key)))
        assert vals[0] == vals[1]
        js, ts = stores["j"], stores["t"]
        assert ts.keys() == js.keys()
        assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
        assert ts.inventory() == js.inventory()
    assert evicted["t"] == evicted["j"] and evicted["j"]


# ---------------------------------------------------------------------------
# a seeded differential trace over ConstellationKVC
# ---------------------------------------------------------------------------

def _fabric(mod, ev, *, replication=2, capacity=420, ground=True):
    spec = mod.ConstellationSpec(7, 9, 550.0)
    transport = mod.IslTransport(
        spec, chunk_processing_time_s=1e-4, link_bandwidth_bytes_s=5e6,
        stats=mod.TransportStats(reservoir_size=24))
    tier = (mod.GroundStationTier(spec, capacity_blocks=6,
                                  processing_time_s=2e-3,
                                  link_bandwidth_bytes_s=1e7)
            if ground else None)
    kvc = mod.ConstellationKVC(
        spec, mod.LosWindow(mod.Sat(3, 4), 3, 3), mod.Strategy.ROTATION_HOP,
        num_servers=9, chunk_bytes=48, per_sat_capacity_bytes=capacity,
        transport=transport, replication=replication, ground=tier,
        ground_write="spill" if ground else "none")
    kvc.adopt_policy(ev.LRUClock())
    lost = []
    kvc.on_block_lost = lost.append
    return kvc, lost


def _transport_fields(ts):
    return {f.name: getattr(ts, f.name) for f in dataclasses.fields(ts)
            if f.name != "_rng"}


def _assert_same_state(tk, jk, step):
    assert (dataclasses.asdict(tk.stats) == dataclasses.asdict(jk.stats)), step
    if jk.ground is not None:
        assert (dataclasses.asdict(tk.ground.stats)
                == dataclasses.asdict(jk.ground.stats)), step
        assert list(tk.ground._blocks) == list(jk.ground._blocks), step
    tt, jt = _transport_fields(tk.transport.stats), _transport_fields(
        jk.transport.stats)
    for name, want in jt.items():
        got = tt[name]
        if isinstance(want, float):
            assert got == pytest.approx(want, **LAT), (step, name)
        elif isinstance(want, list):
            assert got == pytest.approx(want, **LAT), (step, name)
        else:
            assert got == want, (step, name)
    assert tk.directory == jk.directory, step
    assert _norm(tk.server_map) == _norm(jk.server_map), step
    assert ({_norm(s): st.keys() for s, st in tk._stores.items()}
            == {_norm(s): st.keys() for s, st in jk._stores.items()}), step


def _trace_inputs(seed):
    """Hash chains with shared prefixes (block size 4) and their payloads:
    SKYM arrays (so raw-byte accounting runs) or opaque bytes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 300, 24).tolist()
    chains = []
    for _ in range(8):
        cut = int(rng.integers(0, 24))
        toks = base[:cut] + rng.integers(0, 300, int(rng.integers(4, 20))).tolist()
        chains.append(J.chain_hashes(toks, 4))
    payload = {}
    for ch in chains:
        for h in ch:
            if h in payload:
                continue
            n = int(rng.integers(1, 60))
            if rng.random() < 0.5:
                payload[h] = jchunking.arrays_to_bytes(
                    [rng.standard_normal(n).astype(np.float32)])
            else:
                payload[h] = rng.integers(0, 256, 4 * n, dtype=np.uint8).tobytes()
    return rng, chains, payload


OPS = ("set", "set", "set", "get", "get", "has", "lookup", "rotate",
       "prefetch", "purge", "drop", "repair", "reconcile", "sweep", "gossip")


@pytest.mark.parametrize("seed,replication,ground",
                         [(0, 2, True), (1, 2, True), (2, 1, False)],
                         ids=["r2_ground_a", "r2_ground_b", "r1_orbit_only"])
def test_constellation_trace_matches(seed, replication, ground):
    rng, chains, payload = _trace_inputs(seed)
    hashes = list(payload)
    jk, jlost = _fabric(J, jeviction, replication=replication, ground=ground)
    tk, tlost = _fabric(T, teviction, replication=replication, ground=ground)
    seen = set()
    for step in range(300):
        op = OPS[int(rng.integers(len(OPS)))]
        h = hashes[int(rng.integers(len(hashes)))]
        if op == "set":
            want, got = jk.set_block(h, payload[h]), tk.set_block(h, payload[h])
        elif op == "get":
            want, got = jk.get_block(h), tk.get_block(h)
        elif op == "has":
            want, got = jk.has_block(h), tk.has_block(h)
        elif op == "lookup":
            ch = chains[int(rng.integers(len(chains)))]
            want, got = jk.lookup_longest(ch), tk.lookup_longest(ch)
        elif op == "rotate":
            steps = int(rng.integers(1, 3))
            want, got = jk.rotate(steps), tk.rotate(steps)
        elif op == "prefetch":
            steps = int(rng.integers(1, 3))
            want = jk.prefetch_for_rotation(h, steps)
            got = tk.prefetch_for_rotation(h, steps)
        elif op == "purge":
            want, got = jk.purge_block(h), tk.purge_block(h)
        elif op == "drop":
            # a server's home satellite, or a replica one plane east
            sat = _norm(jk.server_map[int(rng.integers(9))])
            sat = (sat[0] + int(rng.integers(replication)), sat[1])
            want = jk.drop_satellite(J.Sat(*sat))
            got = tk.drop_satellite(T.Sat(*sat))
        elif op == "repair":
            want, got = jk.repair(), tk.repair()
        elif op == "reconcile":
            want, got = jk.reconcile(), tk.reconcile()
        elif op == "sweep":
            want, got = (jeviction.run_periodic_sweep(jk),
                         teviction.run_periodic_sweep(tk))
        else:
            want = dataclasses.astuple(jeviction.gossip_cost(jk, h))
            got = dataclasses.astuple(teviction.gossip_cost(tk, h))
        seen.add(op if not want else op + "+")
        assert _norm(got) == _norm(want), (step, op)
        assert tlost == jlost, (step, op)
        _assert_same_state(tk, jk, (step, op))
    # the trace reached the paths it is meant to hold equal
    assert jk.stats.block_hits and jk.stats.block_misses
    assert jk.stats.migrations and jk.stats.blocks_purged and jlost
    assert sum(st.stats.evictions for st in jk._stores.values())
    assert jk.transport.stats.ops > jk.transport.stats.reservoir_size
    if ground:
        assert jk.stats.ground_spills and jk.ground.stats.hits
    if replication > 1:
        assert jk.stats.degraded_reads and jk.stats.repaired_chunks
    assert {"rotate+", "drop+", "get+", "prefetch+"} <= seen


# ---------------------------------------------------------------------------
# KVCManager
# ---------------------------------------------------------------------------

def _toy_kvc_fn(log):
    """A payload that is a function of the tokens (an int32 SKYM array of
    them, doubled), checking that a resume's ``past`` covers exactly the
    first ``past_len`` tokens."""
    def kvc_fn(tokens, past, past_len):
        if past is not None:
            (prev,) = jchunking.bytes_to_arrays(past)
            assert prev.tolist() == [2 * t for t in tokens[:past_len]]
        log.append((len(tokens), past_len))
        return jchunking.arrays_to_bytes(
            [np.asarray(tokens, dtype=np.int32) * 2])
    return kvc_fn


def _manager(mod, ev, use_radix, log):
    kvc, _ = _fabric(mod, ev, capacity=1200)
    return mod.KVCManager(lambda s: list(s.encode()), _toy_kvc_fn(log), kvc,
                          block_size=4, use_radix=use_radix)


@pytest.mark.parametrize("use_radix", [True, False], ids=["radix", "fabric"])
def test_kvc_manager_matches(use_radix):
    """Set KVC (computed and precomputed), Get KVC, and block loss through
    ``on_block_lost``: the same values and counters from both managers."""
    rng = np.random.default_rng(21)
    base = rng.integers(1, 200, 20).tolist()
    seqs = [base[:int(rng.integers(0, 21))]
            + rng.integers(1, 200, int(rng.integers(0, 14))).tolist()
            for _ in range(10)]
    jlog, tlog = [], []
    jm = _manager(J, jeviction, use_radix, jlog)
    tm = _manager(T, teviction, use_radix, tlog)
    for step in range(160):
        toks = seqs[int(rng.integers(len(seqs)))]
        op = int(rng.integers(5))
        if op == 0:
            want, got = jm.add_blocks_tokens(toks), tm.add_blocks_tokens(toks)
        elif op == 1:
            def payload_for(nb, toks=toks):
                return jchunking.arrays_to_bytes(
                    [np.asarray(toks[:nb * 4], dtype=np.int32) * 2])
            want = jm.add_precomputed_blocks(toks, payload_for)
            got = tm.add_precomputed_blocks(toks, payload_for)
        elif op == 2:
            hashes = J.chain_hashes(toks, 4)
            if not hashes:
                continue
            h = hashes[int(rng.integers(len(hashes)))]
            want, got = jm.cache.purge_block(h), tm.cache.purge_block(h)
        else:
            want, got = jm.get_cache_tokens(toks), tm.get_cache_tokens(toks)
        assert got == want, (step, op)
        assert tlog == jlog, step
        assert len(tm.index) == len(jm.index), step
        assert (dataclasses.asdict(tm.cache.stats)
                == dataclasses.asdict(jm.cache.stats)), step
    s = jm.cache.stats
    assert s.block_hits and s.blocks_set and s.blocks_purged
    assert any(p for _, p in jlog)          # some Set resumed from a past
    prompt = "SkyMemory"
    assert tm.get_cache(prompt) == jm.get_cache(prompt)
    assert tm.add_blocks(prompt) == jm.add_blocks(prompt) > 0
    assert tm.get_cache(prompt) == jm.get_cache(prompt)


# ---------------------------------------------------------------------------
# Engine(kvc=)
# ---------------------------------------------------------------------------

def _make_kvc(mod):
    return mod.ConstellationKVC(
        mod.ConstellationSpec(15, 15, 550.0),
        mod.LosWindow(mod.Sat(7, 7), 9, 9), mod.Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=6 * 1024)


def _models(name, **kw):
    cfg = smoke_config(get_config(name)).replace(dtype="float32", **kw)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = tsmoke(tget(name)).replace(dtype="float32", **kw)
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return jm, params, tm


PROMPT = "SkyMemory stripes KV cache chunks across LEO satellites. "
BASE = "SkyMemory stripes KV cache chunks across LEO satellites and more text. "
CASES = {
    # the prompts share a 2-block prefix; the second pass hits it
    "tinyllama_chunked": ("skymemory-tinyllama", {"num_kv_heads": 2},
                          {}, [PROMPT * 2 + f"q{i}" for i in range(3)]),
    "tinyllama_stop_the_world": ("skymemory-tinyllama", {"num_kv_heads": 2},
                                 {"chunk_tokens": 0},
                                 [PROMPT * 2 + f"q{i}" for i in range(3)]),
    # snapshot hits that leave at least K-1 tokens to prefill, where the
    # reference is right (ROADMAP.md queue 3)
    "mamba2": ("mamba2-1.3b", {}, {},
               [BASE[:69], BASE[:45] + " and a tail"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_kvc_serves_the_reference_hits(case):
    """Each engine builds its own ``KVCManager`` over its own package's
    constellation; a first pass writes back through ``kvc_fn``, the
    second hits.  Identical greedy streams, cached tokens, and fabric
    counters (payload lengths are identical, so chunk and message counts
    are too)."""
    name, model_kw, engine_kw, prompts = CASES[case]
    jm, params, tm = _models(name, **model_kw)
    kw = dict(block_size=16, max_seq_len=256, max_batch=2, **engine_kw)
    jeng = JaxEngine(jm, params, kvc=_make_kvc(J), **kw)
    teng = Engine(tm, kvc=_make_kvc(T), device="cpu", **kw)
    assert type(teng.manager).__module__ == "repro_torch.core.protocol"
    assert type(teng.manager.policy).__module__ == "repro_torch.core.eviction"
    assert teng.paged == jeng.paged == (name != "mamba2-1.3b")
    if teng.paged:
        assert teng.kv.policy is teng.manager.policy
    jreqs = [JaxRequest(prompt=p, sampling=JaxSampling(max_new_tokens=5))
             for p in prompts]
    treqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=5))
             for p in prompts]
    for _ in range(2):
        jres, tres = jeng.generate(jreqs), teng.generate(treqs)
        assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
        assert ([r.cached_tokens for r in tres]
                == [r.cached_tokens for r in jres])
    assert all(r.cached_tokens > 0 for r in tres)
    assert teng.stats.cached_tokens == jeng.stats.cached_tokens
    ts, js = teng.manager.cache.stats, jeng.manager.cache.stats
    assert ts.block_hits == js.block_hits > 0
    assert ts.block_misses == js.block_misses
    assert ts.blocks_set == js.blocks_set > 0
    tt, jt = teng.manager.cache.transport.stats, jeng.manager.cache.transport.stats
    assert (tt.messages, tt.bytes_moved, tt.ops) == (
        jt.messages, jt.bytes_moved, jt.ops)
    assert tt.bytes_raw == jt.bytes_raw > 0


def test_engine_manager_precedence():
    """``manager=`` wins over ``kvc=``, as in the reference; a manager of
    another block size is refused."""
    _, _, tm = _models("skymemory-tinyllama")
    eng = Engine(tm, kvc=_make_kvc(T), device="cpu", block_size=16,
                 max_seq_len=64, max_batch=1)
    mgr = T.KVCManager(eng.tokenizer.encode, eng.adapter.kvc_fn,
                       _make_kvc(T), block_size=16)
    both = Engine(tm, kvc=_make_kvc(T), manager=mgr, device="cpu",
                  block_size=16, max_seq_len=64, max_batch=1)
    assert both.manager is mgr and both.kv.manager is mgr
    with pytest.raises(ValueError, match="block_size"):
        Engine(tm, manager=mgr, device="cpu", block_size=32,
               max_seq_len=64, max_batch=1)
