"""The port's MLA family (deepseek-v3) against the reference, on the CPU
in f32.

The same inputs, made from a numpy seed, and the same weights (the
reference's ``Model.init``, converted with ``params_from_numpy``) go
through ``repro`` and ``repro_torch``.  The config is deepseek-v3's
``smoke_config``: 2 layers (the first dense, ``first_k_dense`` 1, the
second MoE with 4 experts top-2), d 256, 4 heads, MLA ranks 32 / 16
(query / latent) and head dims 16 / 8 / 16 (nope / rope / v).  Beside it
two variants: ``deepseek-nodrop`` (``capacity_factor`` 2, so no expert
ever drops a token and a resumed prefill routes as the uninterrupted
one: capacity routing depends on the group, ROADMAP.md section 3 of the
MoE family) and ``deepseek-ring`` (a 24-token sliding window, so the
latent cache is a ring).

* ``init_cache``'s latent layout, and the int8 latent cache refused;
* ``mla_prefill`` with and without a latent prefix, and ``mla_decode``
  over several positions, a ring that wraps included;
* ``forward`` logits and latents, a resume from a latent prefix, and
  ``decode_step`` with per-row positions;
* the latent payload's bytes under ``f32``, ``int8`` and ``int8+delta``;
* ``Engine(kvc=)`` greedy streams, cold and warm, against the reference
  engine's;
* ``params_from_numpy`` (the dense stack, the skipped ``mtp`` head, a
  wrong shape), the plain attention at Dq 192 / Dv 128, and the body
  ``prefill_body`` picks for MLA's prefill.

Tolerances are the reference kernels' (``tests/test_kernels.py``): f32
atol 2e-5 / rtol 2e-4 for outputs and logits; the latents and caches at
atol 1e-4 / rtol 1e-3, as ``tests/test_torch_hybrid.py`` holds its
states.
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
from repro.kernels.ref import attention_ref as jattention_ref
from repro.models import cache as jcache
from repro.models.mla import init_mla
from repro.models.mla import mla_decode as jmla_decode
from repro.models.mla import mla_prefill as jmla_prefill
from repro.models.model import Model as JaxModel
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving.skycache import SkyKVCAdapter as JaxAdapter
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import chunking as tchunking
from repro_torch.kernels.chunked_prefill import TENSOR_CORE_SHAPES, prefill_body
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import cache as tcache
from repro_torch.models.mla import MLA, mla_decode, mla_prefill
from repro_torch.models.model import Model
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving.skycache import SkyKVCAdapter
from repro_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-4)
STATE_TOL = dict(atol=1e-4, rtol=1e-3)
BASE = "SkyMemory stripes KV cache chunks across LEO satellites and more text. "
ARCH = "deepseek-v3-671b"

# name -> smoke overrides
CONFIGS = {
    "deepseek-smoke": {},
    "deepseek-nodrop": {"capacity_factor": 2.0},
    "deepseek-ring": {"sliding_window": 24},
}


def _cfgs(name):
    kw = CONFIGS[name]
    cfg = smoke_config(get_config(ARCH)).replace(dtype="float32", **kw)
    tcfg = tsmoke(tget(ARCH)).replace(dtype="float32", **kw)
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


def _close_mla(got: dict, want: dict):
    assert set(got) == set(want) == {"mla"}
    for k, w in want["mla"].items():
        np.testing.assert_allclose(got["mla"][k].numpy(), np.asarray(w),
                                   **STATE_TOL, err_msg=f"mla.{k}")


def _mla_module(cfg, tcfg, seed):
    """One MLA layer's reference params (norm scales drawn away from 1)
    and the port's ``MLA`` holding the same weights."""
    params = init_mla(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for norm in ("q_norm", "kv_norm"):
        scale = params[norm]["scale"]
        params[norm]["scale"] = jnp.asarray(
            rng.uniform(0.5, 1.5, scale.shape).astype(np.float32))
    attn = MLA(tcfg, "cpu")
    with torch.no_grad():
        for name, p in attn.named_parameters():
            node = params
            for key in name.split("."):
                node = node[key]
            p.copy_(torch.from_numpy(np.array(node)))
    return params, attn


# ---------------------------------------------------------------------------
# configs and caches
# ---------------------------------------------------------------------------

def test_config_and_smoke_variant_match_reference():
    assert asdict(tget(ARCH)) == asdict(get_config(ARCH))
    cfg, tcfg = _cfgs("deepseek-smoke")
    assert tcfg.use_mla and tcfg.first_k_dense == 1 and tcfg.num_experts == 4
    assert (tcfg.q_lora_rank, tcfg.kv_lora_rank) == (32, 16)
    assert (tcfg.qk_nope_head_dim, tcfg.qk_rope_head_dim,
            tcfg.v_head_dim) == (16, 8, 16)


@pytest.mark.parametrize("name,window", [
    ("deepseek-smoke", 0), ("deepseek-smoke", 100), ("deepseek-full", 0),
    ("deepseek-full", 384)])
def test_init_cache_matches_reference(name, window):
    """The latent cache: ``ckv`` [L, B, S, r] and ``kr`` [L, B, S, dr],
    a ring of ``sliding_window`` slots when that is shorter; shapes,
    dtypes and bytes as the reference's."""
    if name == "deepseek-full":
        cfg, tcfg = get_config(ARCH), tget(ARCH)
    else:
        cfg, tcfg = _cfgs(name)
    cfg, tcfg = (c.replace(sliding_window=window) for c in (cfg, tcfg))
    want = jcache.init_cache(cfg, 3, 1024, specs_only=True)
    got = tcache.init_cache(tcfg, 3, 1024, device="meta")
    assert set(got) == set(want) == {"mla"}
    for k, w in want["mla"].items():
        g = got["mla"][k]
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k
    assert (sum(t.numel() * t.element_size() for t in got["mla"].values())
            == jcache.cache_bytes(cfg, 3, 1024))


def test_int8_latent_cache_is_refused():
    """The reference casts each new latent into an int8 cache by
    truncation (ROADMAP.md section 3); the port refuses the cache."""
    _, tcfg = _cfgs("deepseek-smoke")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcache.init_cache(tcfg.replace(kvc_dtype="int8"), 1, 64, device="cpu")
    with pytest.raises(ValueError, match="seq_len"):
        tcache.init_cache(tcfg, 1, device="cpu")


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix", [0, 19], ids=["cold", "latent-prefix"])
def test_mla_prefill_matches_reference(prefix):
    """23 fresh tokens at ``q_offset = prefix``, over a restored latent
    prefix of ``prefix`` tokens when there is one: the output and the
    latents (covering prefix and fresh tokens) are the reference's."""
    cfg, tcfg = _cfgs("deepseek-smoke")
    params, attn = _mla_module(cfg, tcfg, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 23, cfg.d_model)).astype(np.float32)
    jpre = tpre = None
    if prefix:
        ckv = rng.standard_normal((2, prefix, cfg.kv_lora_rank))
        kr = rng.standard_normal((2, prefix, cfg.qk_rope_head_dim))
        jpre = (jnp.asarray(ckv, jnp.float32), jnp.asarray(kr, jnp.float32))
        tpre = (torch.from_numpy(ckv).float(), torch.from_numpy(kr).float())
    want, (jc, jk) = jmla_prefill(params, jnp.asarray(x), cfg,
                                  q_offset=prefix, latent_prefix=jpre)
    with torch.no_grad():
        got, (tc, tk) = mla_prefill(attn, torch.from_numpy(x), tcfg,
                                    q_offset=prefix, latent_prefix=tpre)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tc.shape == (2, prefix + 23, cfg.kv_lora_rank)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **STATE_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **STATE_TOL)


@pytest.mark.parametrize("window,s_cache", [(0, 40), (16, 16)],
                         ids=["full", "ring16"])
def test_mla_decode_matches_reference(window, s_cache):
    """Absorbed decode at per-row positions over one layer's latent
    cache, 6 steps: without a window (a row past the cache writes
    nothing) and over a 16-slot ring the positions wrap.  The outputs
    and the updated caches are the reference's."""
    cfg, tcfg = _cfgs("deepseek-smoke")
    params, attn = _mla_module(cfg, tcfg, 5)
    b = 3
    rng = np.random.default_rng(6)
    ckv0 = rng.standard_normal((b, s_cache, cfg.kv_lora_rank)).astype(
        np.float32)
    kr0 = rng.standard_normal((b, s_cache, cfg.qk_rope_head_dim)).astype(
        np.float32)
    jc, jk = jnp.asarray(ckv0), jnp.asarray(kr0)
    tc, tk = torch.from_numpy(ckv0.copy()), torch.from_numpy(kr0.copy())
    pos = np.asarray([s_cache - 3, 5, 2 * s_cache + 1], np.int32)
    for step in range(6):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        want, jc, jk = jmla_decode(params, jnp.asarray(x), cfg, ckv_cache=jc,
                                   krope_cache=jk, pos=jnp.asarray(pos),
                                   sliding_window=window or None)
        with torch.no_grad():
            got = mla_decode(attn, torch.from_numpy(x), tcfg, ckv_cache=tc,
                             krope_cache=tk, pos=torch.from_numpy(pos),
                             sliding_window=window or None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **STATE_TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **STATE_TOL)
        pos = pos + 1


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_blocks_dense_then_moe(zoo):
    """Layer 0 is dense (``first_k_dense`` 1), layer 1 MoE, both MLA;
    the multi-token-prediction head (training's) is built, one dense MLA
    block deep, and serving never reads it."""
    _, params, tm = zoo["deepseek-smoke"]
    assert [b.is_moe for b in tm.blocks] == [False, True]
    assert all(isinstance(b.attn, MLA) for b in tm.blocks)
    assert "mtp" in params and len(tm.mtp.blocks) == 1
    assert isinstance(tm.mtp.blocks[0].attn, MLA)
    assert not tm.mtp.blocks[0].is_moe
    assert not tm.supports_paged_decode


@pytest.mark.parametrize("name", ["deepseek-smoke", "deepseek-nodrop"])
def test_forward_logits_and_latents_match_reference(zoo, name):
    jm, params, tm = zoo[name]
    toks = _tokens(tm.cfg.vocab_size, 0, (2, 45))
    lw, _, sw = jm.forward(params, jnp.asarray(toks), collect_state=True)
    lt, st = tm.forward(torch.from_numpy(toks), collect_state=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lw), **TOL)
    cfg = tm.cfg
    assert st["mla"]["ckv"].shape == (2, 2, 45, cfg.kv_lora_rank)
    assert st["mla"]["kr"].shape == (2, 2, 45, cfg.qk_rope_head_dim)
    _close_mla(st, sw)


@pytest.mark.parametrize("name", ["deepseek-smoke", "deepseek-nodrop"])
def test_resume_from_latent_prefix(zoo, name):
    """Forward over the first 32 tokens, then over the rest from their
    latents at ``q_offset`` 32: the reference's logits and latents, which
    cover all 45 tokens.  Without capacity drops (``deepseek-nodrop``)
    the resume also gives the uninterrupted forward's logits and
    latents; with them, a resumed MoE layer routes its suffix in a group
    of its own, as the reference does."""
    jm, params, tm = zoo[name]
    toks = _tokens(tm.cfg.vocab_size, 1, (1, 45))
    _, _, jpre = jm.forward(params, jnp.asarray(toks[:, :32]),
                            collect_state=True)
    lw, _, sw = jm.forward(params, jnp.asarray(toks[:, 32:]), q_offset=32,
                           prefix_state=jpre, collect_state=True)
    _, tpre = tm.forward(torch.from_numpy(toks[:, :32]), collect_state=True)
    lt, st = tm.forward(torch.from_numpy(toks[:, 32:]), q_offset=32,
                        prefix_state=tpre, collect_state=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lw), **TOL)
    _close_mla(st, sw)
    assert st["mla"]["ckv"].shape[2] == 45          # prefix + suffix
    if name == "deepseek-nodrop":
        full, fst = tm.forward(torch.from_numpy(toks), collect_state=True)
        np.testing.assert_allclose(lt.numpy(), full[:, 32:].numpy(), **TOL)
        _close_mla(st, {"mla": {k: v.numpy()
                                for k, v in fst["mla"].items()}})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_steps_match_reference(zoo, name):
    """16 decode steps from a prefilled latent cache at per-row positions
    (rows of 9, 13 and 20 prompt tokens): the reference's logits and
    cache.  The windowed config's 24-slot ring wraps for every row.
    Without capacity drops each row's logits also equal the prefill
    logits of the same tokens."""
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
        for k in js["mla"]:
            jc["mla"][k] = jc["mla"][k].at[:, i, :n].set(js["mla"][k][:, 0])
            tc["mla"][k][:, i, :n] = ts["mla"][k][:, 0]
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
        if name == "deepseek-nodrop":
            np.testing.assert_allclose(
                tl[:, 0].numpy(), full[np.arange(3), pos].numpy(), **TOL)
        pos = pos + 1
    assert (pos > ring).all() == bool(cfg.sliding_window)
    _close_mla(tc, jc)


# ---------------------------------------------------------------------------
# payloads and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["f32", "int8", "int8+delta"])
def test_mla_payload_bytes_match_reference(zoo, spec):
    """The latent payload ``[ckv [L, T, r], kr [L, T, dr]]``: its price
    per token ((r + dr) x L values under the codec), its bytes under each
    codec -- cumulative under ``+delta`` too, as the reference writes MLA
    blocks -- and the state it decodes back to, all the reference's;
    ``kvc_fn`` writes the same format (f32 values at the state
    tolerance), and the latents are no paged K/V."""
    jm, params, tm = zoo["deepseek-smoke"]
    cfg = tm.cfg
    ja = JaxAdapter(jm, params, codec=jchunking.PayloadCodec.parse(spec, 16))
    ta = SkyKVCAdapter(tm, codec=tchunking.PayloadCodec.parse(spec, 16))
    assert ta.payload_bytes_per_token() == ja.payload_bytes_per_token()
    values = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * cfg.num_layers
    assert ta.payload_bytes_per_token() == values * ta.codec.bytes_per_value(4)
    toks = ByteTokenizer(cfg.vocab_size).encode(BASE)[:32]
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
    back, jback = ta.payload_to_state(want), ja.payload_to_state(want)
    assert set(back) == set(jback) == {"mla"}
    for k in jback["mla"]:
        assert back["mla"][k].shape[1] == 1
        np.testing.assert_array_equal(back["mla"][k].numpy(),
                                      np.asarray(jback["mla"][k]))
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


def test_full_width_payload_is_576_values_per_token_and_layer():
    """deepseek-v3's latent payload at its published widths, in bf16:
    (512 + 64) values x 2 bytes per token and layer, the reference's
    price too."""
    cfg = get_config(ARCH).replace(num_layers=4)
    tcfg = tget(ARCH).replace(num_layers=4)
    # the price reads the config alone: narrow every other width
    model = Model(tcfg.replace(vocab_size=8, d_model=8, num_heads=1,
                               q_lora_rank=8, qk_nope_head_dim=8,
                               v_head_dim=8, d_ff=8, moe_d_ff=8,
                               num_experts=2, num_experts_per_tok=1),
                  device="cpu")
    adapter = SkyKVCAdapter(model)
    assert adapter.payload_bytes_per_token() == 576 * 4 * 2 == 4608
    assert tcfg.kv_cache_bytes_per_token() == cfg.kv_cache_bytes_per_token()
    assert tcfg.kv_cache_bytes_per_token() == 4608


def make_kvc(mod):
    """The same constellation, built from ``repro.core`` or
    ``repro_torch.core``."""
    return mod.ConstellationKVC(
        mod.ConstellationSpec(15, 15, 550.0),
        mod.LosWindow(mod.Sat(7, 7), 9, 9), mod.Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=6 * 1024,
    )


ENGINE_KW = dict(block_size=16, max_seq_len=256, max_batch=2)


def _run(eng, prompts, max_new, jax_side: bool):
    req, sp = ((JaxRequest, JaxSampling) if jax_side
               else (Request, SamplingParams))
    return eng.generate([req(prompt=p, sampling=sp(max_new_tokens=max_new))
                         for p in prompts])


def test_engine_cold_and_warm_streams_identical(zoo):
    """Three prompts on two slots through ``DenseRuntime``, no cache;
    then each engine over its own package's constellation serves two
    prompts twice: the second pass resumes from the latents at the
    longest cached block boundary, with the reference's streams, hits
    and block counts (the prompts are not block-aligned, where the port
    and the reference look up the same prefix)."""
    jm, params, tm = zoo["deepseek-smoke"]
    jeng, teng = JaxEngine(jm, params, **ENGINE_KW), Engine(
        tm, device="cpu", **ENGINE_KW)
    assert not teng.paged
    prompts = [BASE[:40], "short one", BASE * 2]
    want = _run(jeng, prompts, 6, True)
    got = _run(teng, prompts, 6, False)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert teng.stats.decode_steps == jeng.stats.decode_steps > 0

    prompts = [BASE[:69], BASE[:45] + " and a tail"]
    jeng = JaxEngine(jm, params, kvc=make_kvc(J), **ENGINE_KW)
    teng = Engine(tm, kvc=make_kvc(T), device="cpu", **ENGINE_KW)
    cold = [r.token_ids for r in _run(teng, prompts, 6, False)]
    assert cold == [r.token_ids for r in _run(jeng, prompts, 6, True)]
    want = _run(jeng, prompts, 6, True)
    got = _run(teng, prompts, 6, False)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.cached_tokens for r in got] == [r.cached_tokens for r in want]
    assert all(r.cached_tokens > 0 for r in got)
    ts, js = teng.manager.cache.stats, jeng.manager.cache.stats
    assert ts.block_hits == js.block_hits > 0
    assert ts.blocks_set == js.blocks_set > 0


# ---------------------------------------------------------------------------
# conversion, the plain attention and the kernel's body
# ---------------------------------------------------------------------------

def test_convert_reads_both_stacks_skips_mtp_and_rejects_bad_trees(zoo):
    """Layer 0 comes from ``blocks_dense``, layer 1 from ``blocks``;
    ``mtp`` is read into ``Model.mtp`` (it was skipped before training
    came); a subtree the port has no place for and a weight of the wrong
    shape raise."""
    _, params, tm = zoo["deepseek-smoke"]
    tree = jax.tree.map(np.asarray, params)
    np.testing.assert_array_equal(tm.blocks[0].attn.w_uk.numpy(),
                                  tree["blocks_dense"]["attn"]["w_uk"][0])
    np.testing.assert_array_equal(tm.blocks[1].attn.w_uk.numpy(),
                                  tree["blocks"]["attn"]["w_uk"][0])
    np.testing.assert_array_equal(tm.blocks[0].mlp.wo.numpy(),
                                  tree["blocks_dense"]["mlp"]["wo"][0])
    np.testing.assert_array_equal(tm.mtp.proj.numpy(), tree["mtp"]["proj"])
    np.testing.assert_array_equal(tm.mtp.blocks[0].attn.wq_b.numpy(),
                                  tree["mtp"]["blocks"]["attn"]["wq_b"][0])
    with pytest.raises(ValueError, match="does not read"):
        params_from_numpy(tm.cfg, {**tree, "encoder": tree["blocks"]},
                          device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    w = bad["blocks_dense"]["attn"]["w_uv"]
    bad["blocks_dense"]["attn"]["w_uv"] = w[..., :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tm.cfg, bad, device="cpu")


@pytest.mark.parametrize("q_offset,causal", [(0, True), (17, True),
                                             (0, False)])
def test_plain_attention_at_dq192_dv128_matches_reference(q_offset, causal):
    """The plain version the CPU runs for MLA's prefill, at deepseek-v3's
    head dims (Dq 128 + 64, Dv 128) and its scale, against the
    reference's ``attention_ref``."""
    rng = np.random.default_rng(8)
    sq, skv = 20, 20 + q_offset
    q = rng.standard_normal((1, sq, 2, 192)).astype(np.float32)
    k = rng.standard_normal((1, skv, 2, 192)).astype(np.float32)
    v = rng.standard_normal((1, skv, 2, 128)).astype(np.float32)
    kw = dict(causal=causal, q_offset=q_offset, softmax_scale=192 ** -0.5)
    want = jattention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **kw)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kw)
    assert got.shape == (1, sq, 2, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype,layout,body", [
    (torch.bfloat16, "dense", "tensor-core"),
    (torch.float32, "dense", "fma"),
    (torch.bfloat16, "paged", "fma"),
])
def test_mla_prefill_body(dtype, layout, body):
    """MLA's prefill shape (Dq 192, Dv 128) has a tensor-core instance in
    the dense layout, the only one it is called in; f32 keeps the FMA
    body, and the paged layout has no such instance."""
    assert prefill_body(dtype, 192, 128, layout) == body
    assert ((192, 128) in TENSOR_CORE_SHAPES[layout]) == (layout == "dense")


def test_model_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg = _cfgs("deepseek-smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(Model(tcfg, device="cpu"), **ENGINE_KW)
