"""The port's payload codecs (``repro_torch.core.chunking``) against the
reference (``repro.core.chunking``), on the CPU.

* Every codec (``f32``, ``int8``, ``int4``, ``int8+delta``,
  ``int4+delta``) over f32 and bf16 arrays: the port's payload bytes
  equal the reference's exactly, and its decoded arrays equal the
  reference's decode exactly (a bf16 array decodes to a
  ``torch.bfloat16`` tensor with the reference's bits).  The port takes
  torch tensors, the reference numpy (``ml_dtypes`` for bf16).
* Corrupt payloads (the cases of ``tests/test_codec.py``) raise the same
  ``ValueError`` with the same message.
* Delta chains: the port's ``KVCManager`` over the port's fabric
  reassembles a chain -- and a chain with a hole -- exactly as the
  reference's does over the reference's.
* The adapter: ``payload_bytes_per_token``, ``pages_to_payload`` under
  every codec (``+delta`` with the token chain's back-pointer), and the
  engines: the port's greedy streams under a quantized codec equal the
  reference's on the same weights, TinyLlama through the paged engine
  and mamba2 through the dense runtime.
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs import get_config, smoke_config
from repro.core import chunking as jchunking
from repro.models.model import Model as JaxModel
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving.skycache import SkyKVCAdapter as JaxAdapter
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import chunking as tchunking
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving.skycache import SkyKVCAdapter

torch.set_num_threads(2)
SPECS = ["f32", "int8", "int4", "int8+delta", "int4+delta"]
BF16 = np.dtype(ml_dtypes.bfloat16)


def _bf16_tensor(a: np.ndarray) -> torch.Tensor:
    """The torch bf16 tensor holding the bits of a numpy bf16 array."""
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == BF16:
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16
            assert tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _arrays(dtype: str, seed: int = 0):
    """K/V-shaped arrays with a ragged token axis (13 tokens over
    4-token scale chunks), a rank-2 and a rank-1 array, an outlier
    channel, an all-zero channel, and integer and bool arrays (stored
    verbatim): the reference's numpy list and the port's tensor list."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2, 13, 2, 8)).astype(np.float32)
    k[:, 3, 0, 5] = 40.0
    k[..., 7] = 0.0
    flat = rng.standard_normal((6, 5)).astype(np.float32)
    vec = rng.standard_normal(9).astype(np.float32)
    ints = rng.integers(-128, 128, (2, 3, 4)).astype(np.int8)
    tbl = rng.integers(0, 1 << 30, 7).astype(np.int32)
    mask = rng.integers(0, 2, (3, 5)).astype(bool)
    floats = [k, flat, vec]
    if dtype == "bf16":
        ref = [a.astype(BF16) for a in floats]
        port = [_bf16_tensor(a) for a in ref]
    else:
        ref = floats
        port = [torch.from_numpy(a.copy()) for a in floats]
    return ref + [ints, tbl, mask], port + [torch.from_numpy(ints), tbl, mask]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("spec", SPECS)
def test_codec_bytes_and_decode_match_reference(spec, dtype):
    ref, port = _arrays(dtype)
    for block_tokens in (0, 4, 16) if "delta" not in spec else (4, 16):
        jc = jchunking.PayloadCodec.parse(spec, block_tokens)
        tc = tchunking.PayloadCodec.parse(spec, block_tokens)
        assert (tc.name, tc.block_tokens, tc.delta, tc.quantized) == (
            jc.name, jc.block_tokens, jc.delta, jc.quantized)
        got = tc.encode(port)
        want = jc.encode(ref)
        assert got == want, block_tokens
        assert tchunking.encode_arrays(port, tc) == want
        # the port decodes the reference's bytes as the reference does
        _assert_same_arrays(tchunking.decode_payload_arrays(want),
                            jchunking.decode_payload_arrays(want))
        assert (tchunking.payload_raw_bytes(got)
                == jchunking.payload_raw_bytes(want))
        # a delta segment and a cat container over it decode alike too
        prev = b"\x07" * 32
        delta = tchunking.make_delta_payload(got, prev, 13)
        assert delta == jchunking.make_delta_payload(want, prev, 13)
        assert tchunking.delta_info(delta) == (prev, 13, got)
        _assert_same_arrays(tchunking.decode_payload_arrays(delta),
                            jchunking.decode_payload_arrays(delta))
        cat = tchunking.cat_payloads([got, delta])
        assert cat == jchunking.cat_payloads([want, delta])
        _assert_same_arrays(tchunking.decode_payload_arrays(cat),
                            jchunking.decode_payload_arrays(cat))
    assert tchunking.encode_arrays([], tc) == jchunking.encode_arrays([], jc)
    assert tchunking.decode_payload_arrays(tc.encode([])) == []


def test_codec_parse_matches_reference():
    for spec in [None, *SPECS, "int4"]:
        for bt in (0, 16):
            if spec and "delta" in spec and bt == 0:
                for mod in (jchunking, tchunking):
                    with pytest.raises(ValueError, match="block_tokens"):
                        mod.PayloadCodec.parse(spec, bt)
                continue
            j = jchunking.PayloadCodec.parse(spec, bt)
            t = tchunking.PayloadCodec.parse(spec, bt)
            assert (t.name, t.block_tokens, t.delta) == (
                j.name, j.block_tokens, j.delta)
            assert [t.bytes_per_value(n) for n in (2, 4)] == [
                j.bytes_per_value(n) for n in (2, 4)]
    c = tchunking.PayloadCodec("int8", 8)
    assert tchunking.PayloadCodec.parse(c) is c
    for bad in ("int2", "int8+zip"):
        for mod in (jchunking, tchunking):
            with pytest.raises(ValueError, match="unknown payload codec"):
                mod.PayloadCodec.parse(bad, 16)


def _enc(n_tok=8, seg=4, name="int8"):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, n_tok, 3)).astype(np.float32)
    return jchunking.encode_arrays([a], jchunking.PayloadCodec(name, seg))


# the corrupt payloads of tests/test_codec.py, and truncations of each
# container kind
_SEG_OFF = 12 + 1 + 3 + 1 + 24 + 1        # the scale-table chunk, int32
CORRUPT = {
    "version": lambda e: e[:4] + b"\x63\x00" + e[6:],
    "kind": lambda e: e[:6] + b"\x09" + e[7:],
    "codec_id": lambda e: e[:7] + b"\x2a" + e[8:],
    "scale_table_chunking": lambda e: (
        e[:_SEG_OFF] + (1).to_bytes(4, "little") + e[_SEG_OFF + 4:]),
    "truncated_header": lambda e: e[:40],
    "truncated_codes": lambda e: e[:-5],
    "truncated_int4_codes": lambda e: _enc(name="int4")[:-1],
    "dtype_tag": lambda e: e[:13] + b"zz9" + e[16:],
    "delta_truncated_hash": lambda e: jchunking.make_delta_payload(
        e, b"\x01" * 32, 8)[:20],
    "cat_truncated_segment": lambda e: jchunking.cat_payloads([e, e])[:-3],
    "cat_ragged": lambda e: jchunking.cat_payloads(
        [e, jchunking.encode_arrays([np.zeros((2, 4, 3), np.float32)] * 2,
                                    jchunking.PayloadCodec("int8", 4))]),
}


@pytest.mark.parametrize("case", list(CORRUPT))
def test_corrupt_payloads_raise_the_reference_error(case):
    bad = CORRUPT[case](_enc())
    with pytest.raises(ValueError) as want:
        jchunking.decode_payload_arrays(bad)
    with pytest.raises(ValueError) as got:
        tchunking.decode_payload_arrays(bad)
    assert str(got.value) == str(want.value)
    assert (tchunking.payload_raw_bytes(bad)
            == jchunking.payload_raw_bytes(bad))


def test_header_accessors_reject_what_the_reference_rejects():
    enc = _enc()
    for fn in ("delta_info", "split_cat_payload"):
        for mod in (jchunking, tchunking):
            with pytest.raises(ValueError, match="not a"):
                getattr(mod, fn)(enc)
    for mod in (jchunking, tchunking):
        with pytest.raises(ValueError, match="zero payloads"):
            mod.cat_payloads([])
    assert tchunking.cat_payloads([enc]) is enc


# ---------------------------------------------------------------------------
# KVCManager delta chains over each package's fabric
# ---------------------------------------------------------------------------

BS = 8


def _tokenize(prompt):
    return [ord(c) % 96 for c in prompt]


def _delta_kvc_fn(mod, chunking):
    codec = chunking.PayloadCodec("int8", BS)

    def series(tokens):
        return np.cumsum(np.asarray(tokens, np.float32)).reshape(1, -1, 1)

    def kvc_fn(tokens, past, past_len):
        arr = series(tokens)
        if past is None or past_len == 0:
            return chunking.encode_arrays([arr[:, :BS]], codec)
        prev = mod.chain_hashes(list(tokens[:past_len]), BS)[-1]
        inner = chunking.encode_arrays([arr[:, past_len:]], codec)
        return chunking.make_delta_payload(inner, prev, past_len)
    return kvc_fn


def _delta_manager(mod, chunking):
    spec = mod.ConstellationSpec(15, 15, 550.0)
    kvc = mod.ConstellationKVC(
        spec, mod.LosWindow(mod.Sat(7, 7), 9, 9), mod.Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=1024,
        transport=mod.IslTransport(spec, chunk_processing_time_s=1e-4))
    return kvc, mod.KVCManager(_tokenize, _delta_kvc_fn(mod, chunking), kvc,
                               block_size=BS)


def test_delta_chain_reassembles_like_the_reference():
    """A 4-block delta chain, then the same chain with its second block
    evicted behind the index's back (the prefix shortens to the base
    block), then the re-add that repairs it: the same payload bytes,
    decoded arrays, cached lengths and fabric counters."""
    jk, jm = _delta_manager(J, jchunking)
    tk, tm = _delta_manager(T, tchunking)
    tokens = _tokenize("delta chains over the constellation!")[:4 * BS]
    hashes = J.chain_hashes(tokens, BS)

    def same(step):
        jp, jn = jm.get_cache_tokens(tokens)
        tp, tn = tm.get_cache_tokens(tokens)
        assert (tp, tn) == (jp, jn), step
        _assert_same_arrays(tchunking.decode_payload_arrays(tp),
                            jchunking.decode_payload_arrays(jp))
        assert tk.stats.block_hits == jk.stats.block_hits, step
        assert tk.stats.blocks_set == jk.stats.blocks_set, step
        assert tk.transport.stats.messages == jk.transport.stats.messages
        return tn

    assert tm.add_blocks_tokens(tokens) == jm.add_blocks_tokens(tokens) == 4
    blocks = [tk.get_block(h) for h in hashes]
    assert blocks == [jk.get_block(h) for h in hashes]
    assert all(T.is_delta_payload(b) for b in blocks[1:])
    assert same("chain") == 4 * BS
    for kvc in (jk, tk):
        kvc.on_block_lost = None           # evict without notifying
        kvc.purge_block(hashes[1])
    assert same("hole") == BS
    jk.on_block_lost, tk.on_block_lost = jm._on_block_lost, tm._on_block_lost
    assert tm.add_blocks_tokens(tokens) == jm.add_blocks_tokens(tokens) == 3
    assert same("repaired") == 4 * BS


# ---------------------------------------------------------------------------
# the adapter and the engines under quantized codecs
# ---------------------------------------------------------------------------

def _models(name, **kw):
    cfg = smoke_config(get_config(name)).replace(dtype="float32", **kw)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = tsmoke(tget(name)).replace(dtype="float32", **kw)
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def tiny():
    return _models("skymemory-tinyllama", num_kv_heads=2)


@pytest.mark.parametrize("spec", SPECS)
def test_adapter_payloads_match_reference(tiny, spec):
    """``payload_bytes_per_token`` (the router's size model) and
    ``pages_to_payload`` over the same pages -- cumulative, or the last
    block behind its back-pointer under ``+delta`` -- are the
    reference's; the pages decode back to the reference's arrays."""
    jm, params, tm = tiny
    ja = JaxAdapter(jm, params, codec=jchunking.PayloadCodec.parse(spec, 16))
    ta = SkyKVCAdapter(tm, codec=tchunking.PayloadCodec.parse(spec, 16))
    assert ta.payload_bytes_per_token() == ja.payload_bytes_per_token()
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 3, 16, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 3, 16, 2, 64)).astype(np.float32)
    tokens = rng.integers(0, 300, 48).tolist()
    for n, toks in ((16, None), (32, tokens), (48, tokens)):
        want = ja.pages_to_payload(k, v, n, tokens=toks)
        got = ta.pages_to_payload(torch.from_numpy(k), torch.from_numpy(v),
                                  n, tokens=toks)
        assert got == want, n
        assert T.is_delta_payload(got) == ("delta" in spec and n > 16
                                           and toks is not None)
        _assert_same_arrays(tchunking.decode_payload_arrays(got),
                            jchunking.decode_payload_arrays(want))


def test_ssm_payloads_have_no_token_price():
    jm, params, tm = _models("mamba2-1.3b")
    for spec in ("f32", "int8+delta"):
        ja = JaxAdapter(jm, params,
                        codec=jchunking.PayloadCodec.parse(spec, 16))
        ta = SkyKVCAdapter(tm, codec=tchunking.PayloadCodec.parse(spec, 16))
        assert ta.payload_bytes_per_token() is ja.payload_bytes_per_token()
        assert ta.payload_bytes_per_token() is None


def _make_kvc(mod):
    return mod.ConstellationKVC(
        mod.ConstellationSpec(15, 15, 550.0),
        mod.LosWindow(mod.Sat(7, 7), 9, 9), mod.Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=6 * 1024)


PROMPT = "SkyMemory stripes KV cache chunks across LEO satellites. "
BASE = "SkyMemory stripes KV cache chunks across LEO satellites and more text. "
ENGINE_CASES = {
    "tinyllama_int8": ("skymemory-tinyllama", {"num_kv_heads": 2}, "int8",
                       [PROMPT * 3 + f"q{i}" for i in range(3)]),
    "tinyllama_int4_delta": ("skymemory-tinyllama", {"num_kv_heads": 2},
                             "int4+delta",
                             [PROMPT * 3 + f"q{i}" for i in range(3)]),
    "tinyllama_int8_delta": ("skymemory-tinyllama", {"num_kv_heads": 2},
                             "int8+delta",
                             [PROMPT * 3 + f"q{i}" for i in range(3)]),
    "mamba2_int8": ("mamba2-1.3b", {}, "int8",
                    [BASE[:69], BASE[:45] + " and a tail"]),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_quantized_payloads_serve_the_reference_streams(case,
                                                               request):
    """``Engine(payload_codec=...)`` in both packages over each package's
    fabric: the write-back pass, then the warm pass restoring from
    quantized (and, for ``+delta``, reassembled) payloads.  Identical
    greedy streams and cached tokens; the fabric moved the same number
    of messages and bytes (the payload lengths are equal)."""
    name, model_kw, spec, prompts = ENGINE_CASES[case]
    jm, params, tm = (request.getfixturevalue("tiny")
                      if name == "skymemory-tinyllama"
                      else _models(name, **model_kw))
    kw = dict(block_size=16, max_seq_len=256, max_batch=2,
              payload_codec=spec)
    jeng = JaxEngine(jm, params, kvc=_make_kvc(J), **kw)
    teng = Engine(tm, kvc=_make_kvc(T), device="cpu", **kw)
    assert teng.adapter.codec.name == spec.split("+")[0]
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
    ts, js = teng.manager.cache.stats, jeng.manager.cache.stats
    assert ts.block_hits == js.block_hits > 0
    assert ts.blocks_set == js.blocks_set > 0
    assert ts.bytes_encoded == js.bytes_encoded
    assert ts.bytes_raw == js.bytes_raw > ts.bytes_encoded
    tt, jt = (teng.manager.cache.transport.stats,
              jeng.manager.cache.transport.stats)
    assert (tt.messages, tt.bytes_moved, tt.ops) == (
        jt.messages, jt.bytes_moved, jt.ops)



@pytest.mark.parametrize("spec", ["int8+delta", "int4"])
def test_spilled_blocks_match_reference(tiny, spec):
    """Growth pressure on a 16-page pool preempts; a 4-page host cache
    spills the preempted sequences' block-aligned pages to the fabric
    (``pages_to_payload`` with the token chain, so ``+delta`` writes
    back-pointers) and restores read them back.  The same streams,
    preemptions, spills and fabric bytes as the reference."""
    jm, params, tm = tiny
    kw = dict(block_size=16, max_seq_len=256, max_batch=4, num_pages=1 + 16,
              host_cache_pages=4, payload_codec=spec)
    jeng = JaxEngine(jm, params, kvc=_make_kvc(J), **kw)
    teng = Engine(tm, kvc=_make_kvc(T), device="cpu", **kw)
    prompts = [f"grow {i} " + "x" * 24 for i in range(4)]
    jres = jeng.generate([JaxRequest(prompt=p, sampling=JaxSampling(
        max_new_tokens=60)) for p in prompts])
    tres = teng.generate([Request(prompt=p, sampling=SamplingParams(
        max_new_tokens=60)) for p in prompts])
    assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
    for k in ("preemptions", "restores", "spilled_blocks", "replayed_tokens"):
        assert getattr(teng.stats, k) == getattr(jeng.stats, k), k
    assert teng.stats.spilled_blocks > 0
    ts, js = teng.manager.cache.stats, jeng.manager.cache.stats
    assert (ts.blocks_set, ts.bytes_encoded, ts.bytes_raw) == (
        js.blocks_set, js.bytes_encoded, js.bytes_raw)
