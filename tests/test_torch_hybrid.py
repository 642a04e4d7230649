"""The port's hybrid (zamba2) and the dense-cache attention decode against
the reference, on the CPU in f32.

The same inputs, made from a numpy seed, and the same weights (the
reference's ``Model.init``, converted with ``params_from_numpy``) go
through ``repro`` and ``repro_torch``.  Two hybrid configs: zamba2's
``smoke_config`` (2 layers, the shared block after each, d 256, state 16,
chunk 16) and a 7-layer variant with the full model's period of 6 (one
shared-block call, then a 1-layer tail segment).  Beside them the
sliding-window ring: the dense-cache decode of a windowed smoke
TinyLlama, and a windowed zamba2, served past the ring's wrap.

* ``init_cache`` shapes, dtypes and bytes;
* ``attention_decode`` (ring wrap, int8 caches);
* ``forward`` logits and the ``ssm`` and ``kv`` state, a resume from a
  prefix state, and 16 ``decode_step``s with per-row positions;
* ``DenseRuntime``'s greedy streams, cold and warm from a seeded
  constellation, against the reference engine's; a block-aligned prompt
  served warm gives the cold stream (the port looks up ``tokens[:-1]``,
  ROADMAP.md section 3);
* the hybrid payload's bytes under ``f32``, ``int8`` and ``int8+delta``.

Tolerances are the reference kernels' (``tests/test_kernels.py``): f32
atol 2e-5 / rtol 2e-4 for outputs and logits; the f32 SSM state and the
cache K/V at atol 1e-4 / rtol 1e-3, as ``tests/test_torch_ssm.py`` holds
them.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs import get_config, smoke_config
from repro.core import chunking as jchunking
from repro.models import cache as jcache
from repro.models.attention import attention_decode as jattention_decode
from repro.models.attention import init_attention
from repro.models.model import Model as JaxModel
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving.skycache import SkyKVCAdapter as JaxAdapter
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import chunking as tchunking
from repro_torch.models import cache as tcache
from repro_torch.models.attention import Attention, attention_decode
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving.skycache import SkyKVCAdapter
from repro_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-4)
STATE_TOL = dict(atol=1e-4, rtol=1e-3)
BASE = "SkyMemory stripes KV cache chunks across LEO satellites and more text. "

# name -> (registered arch, smoke overrides)
CONFIGS = {
    "zamba2-smoke": ("zamba2-1.2b", {}),
    "zamba2-p6": ("zamba2-1.2b", {"num_layers": 7, "attn_layer_period": 6}),
    "zamba2-ring": ("zamba2-1.2b", {"sliding_window": 24}),
    "tinyllama-ring": ("skymemory-tinyllama",
                       {"num_kv_heads": 2, "sliding_window": 24}),
}


def _cfgs(name):
    arch, kw = CONFIGS[name]
    cfg = smoke_config(get_config(arch)).replace(dtype="float32", **kw)
    tcfg = tsmoke(tget(arch)).replace(dtype="float32", **kw)
    assert asdict(tcfg) == asdict(cfg)
    return cfg, tcfg


class Zoo(dict):
    """(reference model, its params, the port's model) per config name,
    each built on first use."""

    def __missing__(self, name):
        cfg, tcfg = _cfgs(name)
        jm = JaxModel(cfg)
        params = jm.init(jax.random.PRNGKey(0))
        tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
        self[name] = (jm, params, tm)
        return self[name]


@pytest.fixture(scope="module")
def zoo():
    return Zoo()


def _tokens(vocab, seed, shape):
    return np.random.default_rng(seed).integers(3, vocab, shape)


def _close_state(got: dict, want: dict, parts=("ssm", "kv")):
    for part in parts:
        if part not in want:
            assert part not in got
            continue
        for k, w in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), np.asarray(w),
                                       **STATE_TOL, err_msg=f"{part}.{k}")


# ---------------------------------------------------------------------------
# configs and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvc_dtype", ["", "int8"], ids=["model", "int8"])
@pytest.mark.parametrize("name,window", [
    ("zamba2-smoke", 0), ("zamba2-p6", 0), ("zamba2-p6", 100),
    ("tinyllama-ring", 24), ("zamba2-full", 0), ("zamba2-full", 384)])
def test_init_cache_and_cache_bytes_match_reference(name, window, kvc_dtype):
    """Shapes and dtypes of every leaf of ``init_cache``, and its bytes
    against the reference's ``cache_bytes``, with and without a window (a
    ring when it is shorter than the sequence) and with an int8 K/V
    cache."""
    if name == "zamba2-full":
        cfg, tcfg = get_config("zamba2-1.2b"), tget("zamba2-1.2b")
    else:
        cfg, tcfg = _cfgs(name)
    kw = dict(sliding_window=window, kvc_dtype=kvc_dtype)
    cfg, tcfg = cfg.replace(**kw), tcfg.replace(**kw)
    want = jcache.init_cache(cfg, 3, 1024, specs_only=True)
    got = tcache.init_cache(tcfg, 3, 1024, device="meta")
    assert tcache.n_attn_layers(tcfg) == jcache.n_attn_layers(cfg)
    assert tcache.cache_len(tcfg, 1024) == jcache.cache_len(cfg, 1024)
    assert set(got) == set(want)
    for part in want:
        for k, w in want[part].items():
            g = got[part][k]
            assert tuple(g.shape) == tuple(w.shape), (part, k)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (part, k)
    assert (sum(t.numel() * t.element_size()
                for part in got.values() for t in part.values())
            == jcache.cache_bytes(cfg, 3, 1024))


def test_dense_cache_needs_seq_len_for_kv():
    _, tcfg = _cfgs("zamba2-smoke")
    with pytest.raises(ValueError, match="seq_len"):
        tcache.init_cache(tcfg, 1, device="cpu")
    ssm = tsmoke(tget("mamba2-1.3b"))
    assert set(tcache.init_cache(ssm, 1, device="cpu")) == {"ssm"}


# ---------------------------------------------------------------------------
# attention_decode over a dense cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvc_dtype", ["", "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("window,s_cache", [(0, 40), (16, 16), (128, 128)],
                         ids=["full", "ring16", "ring128"])
def test_attention_decode_matches_reference(window, s_cache, kvc_dtype):
    """Decode steps at per-row positions over one layer's dense cache:
    without a window (a row past the cache writes nothing), and rings of
    16 slots (one page of 16) and of 128 slots (one page of 128) that
    the positions wrap.  The outputs and the updated cache are the
    reference's; the int8 cache holds the same codes."""
    cfg, tcfg = _cfgs("zamba2-smoke")
    kw = dict(sliding_window=window, kvc_dtype=kvc_dtype)
    cfg, tcfg = cfg.replace(**kw), tcfg.replace(**kw)
    params = init_attention(jax.random.PRNGKey(1), cfg)
    attn = Attention(tcfg, "cpu")
    for name in ("wq", "wk", "wv", "wo"):
        getattr(attn, name).data.copy_(torch.from_numpy(
            np.array(params[name])))
    b, hkv, hd = 3, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(7)
    dt = np.int8 if kvc_dtype else np.float32
    k0 = (rng.integers(-60, 60, (b, s_cache, hkv, hd)) if kvc_dtype
          else rng.standard_normal((b, s_cache, hkv, hd))).astype(dt)
    v0 = (rng.integers(-60, 60, (b, s_cache, hkv, hd)) if kvc_dtype
          else rng.standard_normal((b, s_cache, hkv, hd))).astype(dt)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    pos = np.asarray([s_cache - 3, 5, 2 * s_cache + 1], np.int32)
    steps = 6 if window else 4
    for step in range(steps):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        want, jk, jv = jattention_decode(
            params, jnp.asarray(x), cfg, k_cache=jk, v_cache=jv,
            pos=jnp.asarray(pos), sliding_window=window or None)
        with torch.no_grad():
            got = attention_decode(attn, torch.from_numpy(x), tcfg,
                                   k_cache=tk, v_cache=tv,
                                   pos=torch.from_numpy(pos),
                                   sliding_window=window or None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {step}")
        for t, j in ((tk, jk), (tv, jv)):
            if kvc_dtype:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           **STATE_TOL)
        pos = pos + 1


# ---------------------------------------------------------------------------
# the hybrid model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["zamba2-smoke", "zamba2-p6"])
def test_hybrid_forward_logits_and_state_match_reference(zoo, name):
    """45 tokens: the SSD scan's two whole chunks of 16 and a padded
    third; the state holds every layer's snapshot and the K/V of each
    shared-block call."""
    jm, params, tm = zoo[name]
    toks = _tokens(tm.cfg.vocab_size, 0, (2, 45))
    lw, _, sw = jm.forward(params, jnp.asarray(toks), collect_state=True)
    lt, st = tm.forward(torch.from_numpy(toks), collect_state=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lw), **TOL)
    n_attn = tcache.n_attn_layers(tm.cfg)
    assert st["kv"]["k"].shape == (n_attn, 2, 45, 4, 64)
    assert st["ssm"]["conv"].shape[0] == tm.cfg.num_layers
    _close_state(st, sw)


@pytest.mark.parametrize("name", ["zamba2-smoke", "zamba2-p6"])
def test_hybrid_resume_from_prefix_state(zoo, name):
    """Forward over the first 32 tokens, then over the rest from that
    state (the SSM snapshot and the shared block's K/V at ``q_offset``
    32): the reference's logits and state, and the uninterrupted
    forward's."""
    jm, params, tm = zoo[name]
    toks = _tokens(tm.cfg.vocab_size, 1, (1, 45))
    _, _, jsnap = jm.forward(params, jnp.asarray(toks[:, :32]),
                             collect_state=True)
    lw, _, sw = jm.forward(params, jnp.asarray(toks[:, 32:]), q_offset=32,
                           prefix_state=jsnap, collect_state=True)
    _, tsnap = tm.forward(torch.from_numpy(toks[:, :32]), collect_state=True)
    lt, st = tm.forward(torch.from_numpy(toks[:, 32:]), q_offset=32,
                        prefix_state=tsnap, collect_state=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lw), **TOL)
    _close_state(st, sw)
    assert st["kv"]["k"].shape[2] == 45          # prefix + suffix
    full, fst = tm.forward(torch.from_numpy(toks), collect_state=True)
    np.testing.assert_allclose(lt.numpy(), full[:, 32:].numpy(), **TOL)
    _close_state(st, {p: {k: v.numpy() for k, v in fst[p].items()}
                      for p in fst})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_steps_match_reference(zoo, name):
    """16 decode steps from a prefilled cache at per-row positions (rows
    of 9, 13 and 20 prompt tokens): the reference's logits and cache.
    The windowed configs' 24-slot ring wraps for every row.  Each row's
    logits also equal the prefill logits of the same tokens while its
    positions stay inside the ring."""
    jm, params, tm = zoo[name]
    cfg = tm.cfg
    lens = [9, 13, 20]
    toks = _tokens(cfg.vocab_size, 2, (3, 36))
    jc = jm.init_cache(3, 64)
    tc = tm.init_cache(3, 64)
    for i, n in enumerate(lens):
        _, _, js = jm.forward(params, jnp.asarray(toks[i:i + 1, :n]),
                              collect_state=True)
        _, ts = tm.forward(torch.from_numpy(toks[i:i + 1, :n]),
                           collect_state=True)
        for part in js:
            for k in js[part]:
                w = js[part][k][:, 0]
                if part == "kv":
                    jc[part][k] = jc[part][k].at[:, i, :n].set(w[:, :n])
                    tc[part][k][:, i, :n] = ts[part][k][:, 0]
                else:
                    jc[part][k] = jc[part][k].at[:, i].set(w)
                    tc[part][k][:, i] = ts[part][k][:, 0]
    full, _ = tm.forward(torch.from_numpy(toks))
    pos = np.asarray(lens, np.int32)
    ring = tcache.cache_len(cfg, 64)
    for step in range(16):
        tok = toks[np.arange(3), pos][:, None]
        jl, jc = jm.decode_step(params, jc, jnp.asarray(tok),
                                jnp.asarray(pos))
        tl = tm.decode_step(tc, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        for i in range(3):
            if pos[i] < ring:
                np.testing.assert_allclose(tl[i, 0].numpy(),
                                           full[i, pos[i]].numpy(), **TOL)
        pos = pos + 1
    assert (pos > ring).all() == bool(cfg.sliding_window)
    _close_state(tc, jc)


# ---------------------------------------------------------------------------
# the engine (DenseRuntime) and the payloads
# ---------------------------------------------------------------------------

def make_kvc(mod):
    """The same constellation, built from ``repro.core`` or
    ``repro_torch.core``."""
    return mod.ConstellationKVC(
        mod.ConstellationSpec(15, 15, 550.0),
        mod.LosWindow(mod.Sat(7, 7), 9, 9), mod.Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=6 * 1024,
    )


ENGINE_KW = dict(block_size=16, max_seq_len=256, max_batch=2)


def _engines(zoo, name, *, cached: bool, **kw):
    jm, params, tm = zoo[name]
    kw = {**ENGINE_KW, **kw}
    if not cached:
        return JaxEngine(jm, params, **kw), Engine(tm, device="cpu", **kw)
    return (JaxEngine(jm, params, kvc=make_kvc(J), **kw),
            Engine(tm, kvc=make_kvc(T), device="cpu", **kw))


def _run(eng, prompts, max_new, jax_side: bool):
    req, sp = ((JaxRequest, JaxSampling) if jax_side
               else (Request, SamplingParams))
    return eng.generate([req(prompt=p, sampling=sp(max_new_tokens=max_new))
                         for p in prompts])


@pytest.mark.parametrize("name", ["zamba2-smoke", "zamba2-p6"])
def test_engine_cold_and_warm_streams_identical(zoo, name):
    """Three prompts on two slots through ``DenseRuntime``, no cache;
    then each engine over its own package's constellation serves two
    prompts twice: the second pass resumes from the snapshot and the
    shared block's K/V at the longest cached block boundary (at least
    K-1 tokens left to prefill, where the reference is right), with the
    reference's streams, hits and block counts."""
    jeng, teng = _engines(zoo, name, cached=False)
    prompts = [BASE[:40], "short one", BASE * 2]
    want = _run(jeng, prompts, 6, True)
    got = _run(teng, prompts, 6, False)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert teng.stats.decode_steps == jeng.stats.decode_steps > 0
    assert not teng.paged

    prompts = [BASE[:69], BASE[:45] + " and a tail"]
    jeng, teng = _engines(zoo, name, cached=True)
    for jax_side, eng in ((True, jeng), (False, teng)):
        _run(eng, prompts, 6, jax_side)
    want = _run(jeng, prompts, 6, True)
    got = _run(teng, prompts, 6, False)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.cached_tokens for r in got] == [r.cached_tokens for r in want]
    assert all(r.cached_tokens > 0 for r in got)
    ts, js = teng.manager.cache.stats, jeng.manager.cache.stats
    assert ts.block_hits == js.block_hits > 0
    assert ts.blocks_set == js.blocks_set > 0


def test_block_aligned_prompt_gives_the_cold_stream(zoo):
    """A 64-token prompt whose every block is cached: served warm it
    resumes 48 tokens in (the lookup leaves the last token out) and
    gives the cold stream, the port's and the reference's.  The
    reference replays the last token over a snapshot that holds it."""
    prompts = [BASE[:63]]                       # + BOS = 64 tokens
    jeng, cold = _engines(zoo, "zamba2-smoke", cached=False)
    _, warm = _engines(zoo, "zamba2-smoke", cached=True)
    want = [r.token_ids for r in _run(jeng, prompts, 6, True)]
    assert [r.token_ids for r in _run(cold, prompts, 6, False)] == want
    _run(warm, prompts, 6, False)
    res = _run(warm, prompts, 6, False)
    assert [r.token_ids for r in res] == want
    assert [r.cached_tokens for r in res] == [48]


@pytest.mark.parametrize("name", ["tinyllama-ring", "zamba2-ring"])
def test_windowed_engine_serves_past_the_wrap(zoo, name):
    """A model with a 24-token window goes to ``DenseRuntime`` (no paged
    layout), which decodes over a 24-slot ring: 16-22 token prompts and
    12 new tokens wrap every row.  The streams are the reference
    engine's; a prompt longer than the ring raises."""
    jeng, teng = _engines(zoo, name, cached=False)
    assert not teng.paged
    prompts = [BASE[:15], BASE[:21], "ring buffer"]
    want = _run(jeng, prompts, 12, True)
    got = _run(teng, prompts, 12, False)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert all(r.prompt_tokens + 12 > 24 for r in got[:2])
    with pytest.raises(ValueError, match="24-slot"):
        _run(teng, [BASE], 2, False)


@pytest.mark.parametrize("spec", ["f32", "int8", "int8+delta"])
def test_hybrid_payload_bytes_match_reference(zoo, spec):
    """The reference's hybrid state (snapshot, then the shared block's
    K/V) encodes to the reference's bytes under each codec -- cumulative
    under ``+delta`` too, since the snapshot half is not token-sliceable
    -- and decodes back to the same state.  The payload has no per-token
    price, and ``kvc_fn`` writes the same format (f32 values at the
    state tolerance)."""
    jm, params, tm = zoo["zamba2-smoke"]
    ja = JaxAdapter(jm, params, codec=jchunking.PayloadCodec.parse(spec, 16))
    ta = SkyKVCAdapter(tm, codec=tchunking.PayloadCodec.parse(spec, 16))
    assert ta.payload_bytes_per_token() is None
    assert ja.payload_bytes_per_token() is None
    toks = ByteTokenizer(tm.cfg.vocab_size).encode(BASE)[:32]
    _, _, jstate = jm.forward(params, jnp.asarray(toks)[None],
                              collect_state=True)
    tstate = {p: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
              for p, d in jstate.items()}
    prev = b"\x01" * 16
    for past_len, prev_hash in ((0, None), (16, prev)):
        want = ja.state_to_payload(jstate, 32, past_len=past_len,
                                   prev_hash=prev_hash)
        got = ta.state_to_payload(tstate, 32, past_len=past_len,
                                  prev_hash=prev_hash)
        assert got == want
        assert not T.is_delta_payload(got)
    back = ta.payload_to_state(want)
    jback = ja.payload_to_state(want)
    assert set(back) == set(jback) == {"ssm", "kv"}
    for p in jback:
        for k in jback[p]:
            np.testing.assert_array_equal(back[p][k].numpy(),
                                          np.asarray(jback[p][k]))
    if spec == "f32":
        j16, t16 = ja.kvc_fn(toks[:16], None, 0), ta.kvc_fn(toks[:16], None, 0)
        j32, t32 = ja.kvc_fn(toks, j16, 16), ta.kvc_fn(toks, j16, 16)
        for tb, jb in ((t16, j16), (t32, j32)):
            assert len(tb) == len(jb)
            for g, w in zip(tchunking.bytes_to_arrays(tb),
                            jchunking.bytes_to_arrays(jb)):
                np.testing.assert_allclose(g, w, **STATE_TOL)
    with pytest.raises(ValueError, match="not plain paged"):
        ta.payload_to_pages(want, 16, 16)


def test_int8_ring_holds_the_quantized_prompt(zoo):
    """With an int8 K/V cache the prompt's K/V enter the ring quantized,
    as the decode step's own rows are.  (The reference casts the float
    K/V to int8 when it stacks them, which truncates: ROADMAP.md
    section 3.)"""
    _, _, tm = zoo["tinyllama-ring"]
    model = tm.__class__(tm.cfg.replace(kvc_dtype="int8"), device="cpu")
    model.load_state_dict(tm.state_dict())
    eng = Engine(model, device="cpu", **ENGINE_KW)
    seqs = [eng._dense._prefill_one(Request(prompt=p)) for p in
            (BASE[:15], "ring buffer")]
    kv = [s.dense_state["kv"] for s in seqs]
    cache = eng._dense._stack_dense_caches(seqs)
    for i, (s, st) in enumerate(zip(seqs, kv)):
        n = len(s.tokens)
        for key in ("k", "v"):
            got = cache["kv"][key][:, i]
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(
                got[:, :n].numpy(), tcache.quant_kvc(st[key][:, 0]).numpy())
            assert not got[:, n:].any()
