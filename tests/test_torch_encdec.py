"""The port's encoder-decoder family (seamless-m4t) against the reference,
on the CPU in f32.

The same inputs, made from a numpy seed, and the same weights (the
reference's ``Model.init``, every norm's scale and bias then drawn away
from 1 and 0 so that a norm read from the wrong place shows, converted
with ``params_from_numpy``) go through ``repro`` and ``repro_torch``.
The config is seamless-m4t-large-v2's ``smoke_config``: 2 encoder and 2
decoder layers, d 256, 4 heads of 64, gelu, LayerNorm, vocab 512.
``frames`` (the stubbed speech frontend's embeddings) are drawn from a
normal distribution times 0.5, as ``tests/test_arch_smoke.py`` draws
them; a source of 37 frames is one page of 37 to the decode kernel's
layout, a source of 256 two pages of 128.

* ``encode`` (the reference's ``_encode``), ``forward`` logits with the
  collected self and cross K/V;
* ``attention_prefill`` with ``kv_x`` (cross-attention) and non-causal
  encoder self-attention; ``attention_decode`` with ``cross_kv``;
* 8 ``decode_step``s from the prefill state, and the port's own
  decode-vs-forward consistency (``tests/test_arch_smoke.py``'s check);
* ``init_cache(src_len=)`` and its refusals, the engine's refusal, and
  ``params_from_numpy``'s ``encoder`` and ``cross`` subtrees.

Tolerance: atol 1e-4 / rtol 1e-3 (``tests/test_torch_model.py``'s model
tolerance: 2 + 2 layers of f32 products summed in another order); the
port's own decode-vs-forward check at ``tests/test_arch_smoke.py``'s
atol 2e-4 / rtol 2e-3.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.models.attention import attention_decode as jattention_decode
from repro.models.attention import attention_prefill as jattention_prefill
from repro.models.attention import init_attention
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.models import cache as tcache
from repro_torch.models.attention import (
    Attention,
    attention_decode,
    attention_prefill,
)
from repro_torch.serving import Engine

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-3)
CONSISTENCY_TOL = dict(atol=2e-4, rtol=2e-3)
ARCH = "seamless-m4t-large-v2"
B = 2


def _cfgs():
    cfg = smoke_config(get_config(ARCH)).replace(dtype="float32")
    tcfg = tsmoke(tget(ARCH)).replace(dtype="float32")
    assert asdict(tcfg) == asdict(cfg)
    return cfg, tcfg


def _perturb_norms(tree, rng):
    """Every norm's ``scale`` and ``bias`` leaf drawn from U(0.5, 1.5)
    and U(-0.2, 0.2) (the reference initialises them to ones and
    zeros)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _perturb_norms(val, rng)
        elif key == "scale":
            out[key] = rng.uniform(0.5, 1.5, val.shape).astype(val.dtype)
        elif key == "bias":
            out[key] = rng.uniform(-0.2, 0.2, val.shape).astype(val.dtype)
        else:
            out[key] = val
    return out


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, the port's model on them)."""
    cfg, tcfg = _cfgs()
    jm = JaxModel(cfg)
    tree = _perturb_norms(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0))), np.random.default_rng(11))
    params = jax.tree.map(jnp.asarray, tree)
    tm = params_from_numpy(tcfg, tree, device="cpu")
    return jm, params, tm


def _frames(d, s_src, seed=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, s_src, d)) * 0.5).astype(np.float32)


def _tokens(vocab, seed, shape):
    return np.random.default_rng(seed).integers(3, vocab, shape)


def _close(t, j, tol=TOL, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol,
                               err_msg=msg)


def _attention(cfg, tcfg, seed):
    params = init_attention(jax.random.PRNGKey(seed), cfg)
    attn = Attention(tcfg, "cpu")
    for name in ("wq", "wk", "wv", "wo"):
        getattr(attn, name).data.copy_(torch.from_numpy(
            np.array(params[name])))
    return params, attn


# ---------------------------------------------------------------------------
# the encoder and the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_src", [37, 256])
def test_encode_matches_reference(pair, s_src):
    jm, params, tm = pair
    fr = _frames(tm.cfg.d_model, s_src)
    want = jm._encode(params, jnp.asarray(fr))
    got = tm.encode(torch.from_numpy(fr))
    assert got.shape == (B, s_src, tm.cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("s_src", [37, 256])
def test_forward_logits_and_state_match_reference(pair, s_src):
    """Logits, each decoder layer's self K/V and the cross K/V it
    projected from the encoder output."""
    jm, params, tm = pair
    cfg = tm.cfg
    toks = _tokens(cfg.vocab_size, 0, (B, 24))
    fr = _frames(cfg.d_model, s_src)
    jl, _, js = jm.forward(params, jnp.asarray(toks), frames=jnp.asarray(fr),
                           collect_state=True)
    tl, ts = tm.forward(torch.from_numpy(toks), frames=torch.from_numpy(fr),
                        collect_state=True)
    _close(tl, jl, msg="logits")
    assert set(ts) == set(js) == {"kv", "cross"}
    for part in ("kv", "cross"):
        for k in ("k", "v"):
            _close(ts[part][k], js[part][k], msg=f"{part}.{k}")
    assert ts["cross"]["k"].shape == (cfg.num_layers, B, s_src,
                                      cfg.num_kv_heads, cfg.head_dim)
    # without collect_state no state comes back
    assert tm.forward(torch.from_numpy(toks),
                      frames=torch.from_numpy(fr))[1] is None


def test_forward_needs_frames(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="frames"):
        tm.forward(torch.zeros((1, 4), dtype=torch.int64))


@pytest.mark.parametrize("mode", ["cross", "encoder"])
def test_attention_prefill_matches_reference(mode):
    """``kv_x=``: queries of 19 target tokens over K/V projected from 37
    source positions, no RoPE, non-causal.  ``causal=False``: encoder
    self-attention over 37 positions with RoPE."""
    cfg, tcfg = _cfgs()
    params, attn = _attention(cfg, tcfg, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 19 if mode == "cross" else 37,
                             cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, 37, cfg.d_model)).astype(np.float32)
    jkw = (dict(kv_x=jnp.asarray(src), causal=False) if mode == "cross"
           else dict(causal=False))
    tkw = (dict(kv_x=torch.from_numpy(src), causal=False) if mode == "cross"
           else dict(causal=False))
    want, (jk, jv) = jattention_prefill(params, jnp.asarray(x), cfg, **jkw)
    with torch.no_grad():
        got, (tk, tv) = attention_prefill(attn, torch.from_numpy(x), tcfg,
                                          **tkw)
    _close(got, want)
    _close(tk, jk, msg="k")
    _close(tv, jv, msg="v")
    assert tk.shape[1] == 37


@pytest.mark.parametrize("s_src", [256, 37], ids=["pages", "one-page"])
def test_attention_decode_cross_matches_reference(s_src):
    """One-token cross-attention over a frozen cross K/V: every row
    attends all ``s_src`` positions (two pages of 128, or one page of
    37), and the self cache is neither read nor written."""
    cfg, tcfg = _cfgs()
    params, attn = _attention(cfg, tcfg, 5)
    rng = np.random.default_rng(8)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    ck = rng.standard_normal((B, s_src, hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((B, s_src, hkv, hd)).astype(np.float32)
    self_k = np.zeros((B, 8, hkv, hd), np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    want, jk, _ = jattention_decode(
        params, jnp.asarray(x), cfg, k_cache=jnp.asarray(self_k),
        v_cache=jnp.asarray(self_k), pos=jnp.int32(3),
        cross_kv=(jnp.asarray(ck), jnp.asarray(cv)))
    with torch.no_grad():
        got = attention_decode(attn, torch.from_numpy(x), tcfg,
                               cross_kv=(torch.from_numpy(ck),
                                         torch.from_numpy(cv)))
    _close(got, want)
    np.testing.assert_array_equal(np.asarray(jk), self_k)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _prefilled_caches(jm, params, tm, toks, fr, seq_len):
    """The reference's and the port's decode caches holding the prompt's
    self K/V and the cross K/V, each from its own ``forward``."""
    cfg, n = tm.cfg, toks.shape[1]
    _, _, js = jm.forward(params, jnp.asarray(toks), frames=jnp.asarray(fr),
                          collect_state=True)
    _, ts = tm.forward(torch.from_numpy(toks), frames=torch.from_numpy(fr),
                       collect_state=True)
    jc = jm.init_cache(B, seq_len, src_len=fr.shape[1])
    for k in ("k", "v"):
        jc["kv"][k] = jc["kv"][k].at[:, :, :n].set(js["kv"][k])
    jc["cross"] = js["cross"]
    tc = tm.init_cache(B, seq_len, src_len=fr.shape[1])
    for k in ("k", "v"):
        tc["kv"][k][:, :, :n] = ts["kv"][k]
        tc["cross"][k].copy_(ts["cross"][k])
    return jc, tc


@pytest.mark.parametrize("s_src", [37, 256])
def test_decode_steps_match_reference(pair, s_src):
    """8 ``decode_step``s after a 20-token prompt, both fed the
    reference's greedy tokens: the logits each step and the self cache
    after the last."""
    jm, params, tm = pair
    cfg = tm.cfg
    toks = _tokens(cfg.vocab_size, 1, (B, 20))
    fr = _frames(cfg.d_model, s_src, seed=9)
    jc, tc = _prefilled_caches(jm, params, tm, toks, fr, seq_len=32)
    nxt = toks[:, -1:]
    for i in range(8):
        pos = np.full((B,), 20 + i, np.int32)
        jl, jc = jm.decode_step(params, jc, jnp.asarray(nxt),
                                jnp.asarray(pos))
        tl = tm.decode_step(tc, torch.from_numpy(nxt),
                            torch.from_numpy(pos))
        _close(tl, jl, msg=f"step {i}")
        nxt = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    for k in ("k", "v"):
        _close(tc["kv"][k], jc["kv"][k], msg=f"kv.{k}")
        _close(tc["cross"][k], jc["cross"][k], msg=f"cross.{k}")


def test_decode_matches_forward(pair):
    """The port against itself, as ``tests/test_arch_smoke.py`` holds the
    reference: a decode step after the prefill state gives the last
    logits of a ``forward`` over the prompt and the new token."""
    _, _, tm = pair
    cfg = tm.cfg
    s = 32
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, (B, s)))
    fr = torch.from_numpy(_frames(cfg.d_model, s, seed=10))
    _, state = tm.forward(toks, frames=fr, collect_state=True)
    cache = tm.init_cache(B, s + 8, src_len=s)
    for k in ("k", "v"):
        cache["kv"][k][:, :, :s] = state["kv"][k]
        cache["cross"][k].copy_(state["cross"][k])
    nxt = torch.from_numpy(_tokens(cfg.vocab_size, 3, (B, 1)))
    lg = tm.decode_step(cache, nxt, torch.full((B,), s, dtype=torch.int32))
    full, _ = tm.forward(torch.cat([toks, nxt], 1), frames=fr)
    _close(lg[:, 0], full[:, -1].numpy(), tol=CONSISTENCY_TOL)


# ---------------------------------------------------------------------------
# caches, refusals, conversion
# ---------------------------------------------------------------------------

def test_init_cache_shapes_match_reference():
    cfg, tcfg = _cfgs()
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        JaxModel(cfg).init_cache(3, 40, src_len=37))
    got = tcache.init_cache(tcfg, 3, 40, src_len=37, device="cpu")
    assert set(got) == set(want) == {"kv", "cross"}
    for part in got:
        for k, t in got[part].items():
            assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) \
                == want[part][k], part
            assert not t.any()


def test_init_cache_refuses_what_the_reference_gets_wrong():
    """Without ``src_len`` the reference sizes the cross K/V at
    ``seq_len`` and attends its zero rows as valid; with an int8 cache
    it reads the cross K/V without dequantizing it.  The port refuses
    both (ROADMAP.md section 3)."""
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="src_len"):
        tcache.init_cache(tcfg, 2, 40, device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        tcache.init_cache(tcfg.replace(kvc_dtype="int8"), 2, 40, src_len=37,
                          device="cpu")


def test_engine_refuses_the_family(pair):
    """The reference's engine cannot serve it (its prefill has no
    ``frames`` and its dense caches drop ``cross``), so neither does the
    port's."""
    _, _, tm = pair
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        Engine(tm, block_size=16, max_seq_len=64, max_batch=1, device="cpu")


def test_convert_reads_encoder_and_cross_and_rejects_bad_trees(pair):
    """Encoder layer ``i`` and cross block ``l`` come from the stacked
    subtrees; a subtree the port has no place for and a weight of the
    wrong shape raise."""
    _, params, tm = pair
    tree = jax.tree.map(np.asarray, params)
    for i in range(tm.cfg.num_encoder_layers):
        np.testing.assert_array_equal(tm.encoder[i].attn.wq.numpy(),
                                      tree["encoder"]["blocks"]["attn"]["wq"][i])
        np.testing.assert_array_equal(
            tm.encoder[i].norm2.bias.numpy(),
            tree["encoder"]["blocks"]["norm2"]["bias"][i])
    np.testing.assert_array_equal(tm.encoder_norm.scale.numpy(),
                                  tree["encoder"]["norm"]["scale"])
    for l in range(tm.cfg.num_layers):
        np.testing.assert_array_equal(tm.cross[l].attn.wv.numpy(),
                                      tree["cross"]["attn"]["wv"][l])
        np.testing.assert_array_equal(tm.cross[l].norm.bias.numpy(),
                                      tree["cross"]["norm"]["bias"][l])
    with pytest.raises(ValueError, match="does not read"):
        params_from_numpy(tm.cfg, {**tree, "frontend": tree["cross"]},
                          device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["cross"]["attn"]["wk"] = bad["cross"]["attn"]["wk"][..., :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tm.cfg, bad, device="cpu")
