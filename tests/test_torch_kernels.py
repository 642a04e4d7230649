"""The port's attention kernels' plain versions against the reference.

Every case draws its inputs from a numpy seed and feeds the same arrays
to ``repro_torch.kernels.ref`` (and ``repro_torch.kernels.ops`` on CPU
tensors, which dispatches there), ``repro.kernels.ref``, and the Pallas
kernel in ``interpret=True`` mode as ``tests/test_kernels.py`` runs it.
Tolerance: f32 atol 2e-5 / rtol 2e-4, the reference's own kernel
tolerance (the two frameworks sum in different orders).  The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.chunked_prefill import (
    chunked_prefill_attention,
    chunked_prefill_paged,
)
from repro.kernels.paged_attention import paged_attention
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.chunked_prefill import flash_prefill, prefill_body
from repro_torch.kernels.chunked_prefill import (
    chunked_prefill_paged as chunked_prefill_paged_kernel,
)
from repro_torch.kernels import paged_attention as paged_attention_mod
from repro_torch.kernels.paged_attention import (
    SPLIT,
    decode_splits,
    paged_decode,
)
from repro_torch.kernels.ssd_scan import ENTRY as SSD_ENTRY
from repro_torch.kernels.ssd_scan import ssd_body, ssd_chunk_scan
from repro_torch.kernels import ssd_backward as sb
from repro_torch.kernels import flash_backward as fb
from repro_torch.kernels.flash_backward import bwd_body, flash_prefill_bwd

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-4)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got_torch, want_jax):
    np.testing.assert_allclose(got_torch.numpy(), np.asarray(want_jax), **TOL)


# ---------------------------------------------------------------------------
# dense prefill (K4: chunked_prefill.py::_kernel)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "b,sq,skv,h,hkv,d,dv,off,win,causal",
    [
        (2, 16, 16, 4, 2, 8, 8, 0, None, True),      # GQA, square
        (1, 8, 24, 4, 4, 16, 16, 16, None, True),    # prefix offset
        (2, 8, 20, 4, 1, 8, 8, 12, 6, True),         # MQA + sliding window
        (1, 12, 12, 2, 2, 8, 8, 0, None, False),     # non-causal
        (1, 8, 16, 4, 2, 12, 8, 8, None, True),      # Dq != Dv (MLA shape)
    ],
)
def test_flash_attention_plain_matches_reference(b, sq, skv, h, hkv, d, dv,
                                                 off, win, causal):
    rng = np.random.default_rng(sq * 100 + skv)
    q, k = _rand(rng, (b, sq, h, d)), _rand(rng, (b, skv, hkv, d))
    v = _rand(rng, (b, skv, hkv, dv))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              q_offset=off, sliding_window=win)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_offset=off,
                              sliding_window=win)
    _close(got, want)
    pallas = chunked_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=off, sliding_window=win, interpret=True)
    _close(got, pallas)


@pytest.mark.parametrize(
    "b,sq,skv,h,hkv,d,dv,off,win,causal,block_k",
    [
        (2, 12, 45, 4, 2, 8, 8, 33, None, True, 16),   # causal, ragged tail
        (1, 10, 37, 4, 4, 16, 16, 0, None, False, 8),  # non-causal
        (2, 9, 50, 4, 1, 8, 8, 41, 13, True, 16),      # window: blocks
                                                       # fully masked first
        (1, 8, 29, 4, 2, 12, 8, 21, None, True, 8),    # Dq != Dv
    ],
)
def test_attention_streaming_plain_matches_reference(b, sq, skv, h, hkv, d, dv,
                                                     off, win, causal,
                                                     block_k):
    """The streaming plain version (online softmax over key blocks of
    ``block_k``, the last one ragged) against the reference's
    ``attention_streaming_ref`` and the full-matrix ``attention_ref``."""
    rng = np.random.default_rng(skv * 10 + block_k)
    q, k = _rand(rng, (b, sq, h, d)), _rand(rng, (b, skv, hkv, d))
    v = _rand(rng, (b, skv, hkv, dv))
    kw = dict(causal=causal, q_offset=off, sliding_window=win)
    got = tref.attention_streaming_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        block_k=block_k, **kw)
    want = jref.attention_streaming_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_k=block_k,
        **kw)
    _close(got, want)
    _close(got, jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw))


@pytest.mark.parametrize("skv,streams", [(8192, True), (8191, False)])
def test_flash_attention_streams_long_keys_on_cpu(monkeypatch, skv, streams):
    """On the CPU ``ops.flash_attention`` takes the streaming plain
    version from ``STREAMING_KV_THRESHOLD`` keys on, in blocks of
    ``STREAMING_BLOCK_K``, as the reference's jnp path does, and gives
    the reference's answer."""
    assert (tref.STREAMING_KV_THRESHOLD, tref.STREAMING_BLOCK_K) == (
        jref.STREAMING_KV_THRESHOLD, jref.STREAMING_BLOCK_K)
    calls = []
    real = tref.attention_streaming_ref

    def spy(*a, **kw):
        calls.append(kw["block_k"])
        return real(*a, **kw)

    monkeypatch.setattr(tref, "attention_streaming_ref", spy)
    rng = np.random.default_rng(skv)
    q, k, v = (_rand(rng, (1, 3, 2, 8)), _rand(rng, (1, skv, 1, 8)),
               _rand(rng, (1, skv, 1, 8)))
    kw = dict(causal=True, q_offset=skv - 3)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    assert calls == ([tref.STREAMING_BLOCK_K] if streams else [])
    _close(got, jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw))


# ---------------------------------------------------------------------------
# paged decode (K1 contiguous pages, K2 block tables)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "b,p,page,h,hkv,d,lengths",
    [
        (2, 3, 8, 4, 2, 8, [5, 24]),        # GQA, partial + full
        (3, 2, 16, 8, 1, 16, [0, 1, 17]),   # MQA, zero-length row
        (2, 4, 4, 2, 2, 8, [16, 9]),        # MHA, ragged last page
    ],
)
@pytest.mark.parametrize("tables", [False, True])
def test_paged_attention_plain_matches_reference(b, p, page, h, hkv, d,
                                                 lengths, tables):
    rng = np.random.default_rng(b * 10 + p)
    q = _rand(rng, (b, h, d))
    lens = np.asarray(lengths, np.int32)
    if tables:
        n = b * p + 3
        kp, vp = _rand(rng, (n, page, hkv, d)), _rand(rng, (n, page, hkv, d))
        bt = rng.permutation(n)[: b * p].reshape(b, p).astype(np.int32)
        got = ops.paged_attention(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(lens), block_tables=torch.from_numpy(bt))
        args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(lens))
        want = jref.paged_attention_ref(*args, block_tables=jnp.asarray(bt))
        pallas = paged_attention(*args, block_tables=jnp.asarray(bt),
                                 interpret=True)
    else:
        kp = _rand(rng, (b, p, page, hkv, d))
        vp = _rand(rng, (b, p, page, hkv, d))
        got = ops.paged_attention(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(lens))
        args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(lens))
        want = jref.paged_attention_ref(*args)
        pallas = paged_attention(*args, interpret=True)
    _close(got, want)
    _close(got, pallas)
    for i, n_tok in enumerate(lengths):
        if n_tok == 0:
            assert got[i].abs().max().item() == 0.0


@pytest.mark.parametrize(
    "b,p,page,h,hkv,d,lengths",
    [
        (2, 3, 8, 4, 2, 8, [5, 24]),        # GQA, partial + full
        (3, 2, 16, 8, 1, 16, [0, 1, 17]),   # MQA, zero-length row
        (2, 4, 4, 2, 2, 8, [16, 9]),        # MHA, ragged last page
    ],
)
@pytest.mark.parametrize("tables", [False, True])
def test_paged_attention_plain_lse_matches_logsumexp(b, p, page, h, hkv, d,
                                                     lengths, tables):
    """``return_lse``: each head's log-sum-exp of its valid scaled scores
    (natural log), -inf at length 0, against ``torch.logsumexp`` of the
    scores written out; the output is bitwise the one without."""
    rng = np.random.default_rng(b * 10 + p + 1)
    q = torch.from_numpy(_rand(rng, (b, h, d)))
    lens = torch.tensor(lengths, dtype=torch.int32)
    if tables:
        n = b * p + 3
        kp = torch.from_numpy(_rand(rng, (n, page, hkv, d)))
        vp = torch.from_numpy(_rand(rng, (n, page, hkv, d)))
        bt = torch.from_numpy(
            rng.permutation(n)[: b * p].reshape(b, p).astype(np.int32))
        k_seq = kp[bt.long()].reshape(b, p * page, hkv, d)
    else:
        kp = torch.from_numpy(_rand(rng, (b, p, page, hkv, d)))
        vp = torch.from_numpy(_rand(rng, (b, p, page, hkv, d)))
        bt = None
        k_seq = kp.reshape(b, p * page, hkv, d)
    out, lse = ops.paged_attention(q, kp, vp, lens, block_tables=bt,
                                   return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    assert torch.equal(out, ops.paged_attention(q, kp, vp, lens,
                                                block_tables=bt))
    rep = h // hkv
    for i, n_tok in enumerate(lengths):
        for ih in range(h):
            if n_tok == 0:
                assert lse[i, ih].item() == -np.inf
                continue
            scores = (k_seq[i, :n_tok, ih // rep] @ q[i, ih]) * d ** -0.5
            np.testing.assert_allclose(lse[i, ih].item(),
                                       torch.logsumexp(scores, 0).item(),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stripes", [1, 2, 4, 8])
def test_stripes_merged_by_their_lse_equal_the_whole(stripes):
    """A cache cut into sequence stripes: the plain decode attention of
    each stripe, with its LSE, merged by ``distributed.decode.
    merge_partials`` equals the attention over the whole, rows that
    leave later stripes empty and a row of length 0 (zeros) included."""
    from repro_torch.distributed.decode import merge_partials

    b, s, h, hkv, d = 6, 64, 4, 2, 8
    rng = np.random.default_rng(stripes)
    q = torch.from_numpy(_rand(rng, (b, h, d)))
    k = torch.from_numpy(_rand(rng, (b, s, hkv, d)))
    v = torch.from_numpy(_rand(rng, (b, s, hkv, d)))
    lens = torch.tensor([64, 40, 17, 8, 1, 0], dtype=torch.int32)

    def attend(kk, vv, n):
        pages = (b, kk.shape[1] // 8, 8, hkv, d)
        return ops.paged_attention(q, kk.reshape(pages), vv.reshape(pages),
                                   n, return_lse=True)

    want, _ = attend(k, v, lens)
    length = s // stripes
    outs, lses = [], []
    for r in range(stripes):
        part = slice(r * length, (r + 1) * length)
        o, lse = attend(k[:, part].contiguous(), v[:, part].contiguous(),
                        torch.clamp(lens - r * length, 0, length))
        outs.append(o)
        lses.append(lse)
    got = merge_partials(torch.stack(outs), torch.stack(lses))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-5)
    assert got[-1].abs().max().item() == 0.0
    if stripes == 1:
        assert torch.equal(got, outs[0])


def test_merge_partials_gives_zeros_where_every_stripe_is_empty():
    from repro_torch.distributed.decode import merge_partials

    outs = torch.ones(3, 2, 4, 8)
    lses = torch.full((3, 2, 4), -torch.inf)
    lses[1, 0] = 0.5
    got = merge_partials(outs, lses)
    assert torch.equal(got[0], torch.ones(4, 8))
    assert torch.equal(got[1], torch.zeros(4, 8))


@pytest.mark.parametrize("tables", [False, True])
def test_paged_attention_gqa_head_mapping(tables):
    """Query head h reads kv head h // (H / Hkv): V is constant per kv
    head, so any mapping mistake shifts the output by >= 1."""
    b, p, page, h, hkv, d = 1, 2, 8, 8, 4, 4
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_rand(rng, (b, h, d)))
    k = torch.from_numpy(_rand(rng, (b, p, page, hkv, d)))
    v = torch.arange(hkv, dtype=torch.float32)[None, None, None, :, None]
    v = v.expand(b, p, page, hkv, d).contiguous()
    lens = torch.tensor([11], dtype=torch.int32)
    if tables:
        bt = torch.tensor([[1, 0]], dtype=torch.int32)
        out = ops.paged_attention(q, k[0], v[0], lens, block_tables=bt)
    else:
        out = ops.paged_attention(q, k, v, lens)
    rep = h // hkv
    for ih in range(h):
        np.testing.assert_allclose(out[0, ih].numpy(), ih // rep, atol=1e-5)


# ---------------------------------------------------------------------------
# paged chunked prefill (K3: chunked_prefill.py::_kernel_paged)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "b,sq,h,hkv,d,page,p_max,offs,lens",
    [
        (2, 12, 4, 2, 8, 8, 4, [5, 17], [17, 29]),  # offsets mid-page
        (2, 8, 4, 4, 16, 8, 3, [8, 16], [16, 24]),  # page-aligned chunks
        (2, 8, 2, 1, 8, 8, 3, [0, 3], [0, 11]),     # zero-length row
        (1, 1, 4, 2, 16, 8, 4, [15], [16]),         # one-token replay
    ],
)
def test_chunked_prefill_paged_plain_matches_reference(b, sq, h, hkv, d, page,
                                                       p_max, offs, lens):
    rng = np.random.default_rng(sq + d)
    n = b * p_max + 2
    q = _rand(rng, (b, sq, h, d))
    kp, vp = _rand(rng, (n, page, hkv, d)), _rand(rng, (n, page, hkv, d))
    bt = rng.permutation(n)[: b * p_max].reshape(b, p_max).astype(np.int32)
    offs, lens = np.asarray(offs, np.int32), np.asarray(lens, np.int32)
    got = ops.chunked_prefill_paged(
        *map(torch.from_numpy, (q, kp, vp, lens, bt, offs)))
    jargs = tuple(map(jnp.asarray, (q, kp, vp, lens, bt, offs)))
    _close(got, jref.chunked_prefill_paged_ref(*jargs))
    _close(got, chunked_prefill_paged(*jargs, interpret=True))
    for i in range(b):
        if lens[i] == 0:
            assert got[i].abs().max().item() == 0.0


def test_chunked_prefill_paged_matches_dense_gather():
    """Reading the prefix in place through the block table == gathering
    the pages into sequence order and running dense attention with the
    chunk's offset."""
    rng = np.random.default_rng(3)
    b, sq, h, hkv, d, page, p_max = 1, 12, 4, 2, 8, 8, 4
    q = torch.from_numpy(_rand(rng, (b, sq, h, d)))
    kp = torch.from_numpy(_rand(rng, (8, page, hkv, d)))
    vp = torch.from_numpy(_rand(rng, (8, page, hkv, d)))
    bt = torch.tensor([[6, 2, 5, 0]], dtype=torch.int32)
    off, kv_len = 5, 5 + sq
    got = ops.chunked_prefill_paged(
        q, kp, vp, torch.tensor([kv_len], dtype=torch.int32), bt,
        torch.tensor([off], dtype=torch.int32))
    k_seq = kp[bt[0].long()].reshape(1, p_max * page, hkv, d)[:, :kv_len]
    v_seq = vp[bt[0].long()].reshape(1, p_max * page, hkv, d)[:, :kv_len]
    want = ops.flash_attention(q, k_seq, v_seq, causal=True, q_offset=off)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the kernel wrappers and their build
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel on CUDA tensors or raises; the plain
    version is reached only through ``ops`` on CPU tensors."""
    q = torch.zeros(1, 2, 8)
    pool = torch.zeros(2, 4, 2, 8)
    lens = torch.ones(1, dtype=torch.int32)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode(q, pool, pool, lens, bt)
    with pytest.raises(ValueError, match="CUDA"):
        chunked_prefill_paged_kernel(q[:, None], pool, pool, lens, bt, lens)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(q[:, None], q[:, None], q[:, None])
    with pytest.raises(NotImplementedError):
        flash_prefill(q[:, None], q[:, None], q[:, None], lengths=lens)
    x = torch.zeros(1, 4, 2, 8)
    bc = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_scan(x, torch.zeros(1, 4, 2), torch.zeros(2), bc, bc,
                       chunk_size=4)
    assert ssd_chunk_scan.launches == 0
    assert paged_decode.launches == 0
    assert chunked_prefill_paged_kernel.launches == 0
    assert flash_prefill.launches == 0


def test_kernels_without_a_backward_refuse_a_graph():
    """No wrapper silently detaches an autograd graph: with grad enabled
    and an input that requires it, the decode, the paged prefill and the
    SSD scan (no backward yet) raise ``NotImplementedError`` before any
    device check, and so does the dense prefill's wrapper called
    directly (its gradient goes through ``ops.FlashAttention``).  Under
    ``torch.no_grad()`` the device check speaks again."""
    q = torch.zeros(1, 2, 8, requires_grad=True)
    pool = torch.zeros(2, 4, 2, 8)
    lens = torch.ones(1, dtype=torch.int32)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no backward"):
        paged_decode(q, pool, pool, lens, bt)
    with pytest.raises(NotImplementedError, match="no backward"):
        chunked_prefill_paged_kernel(q[:, None], pool, pool, lens, bt, lens)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_prefill(q[:, None], q[:, None].detach(), q[:, None].detach())
    x = torch.zeros(1, 4, 2, 8)
    bc = torch.zeros(1, 4, 1, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ssd_chunk_scan(x, torch.zeros(1, 4, 2), torch.zeros(2), bc, bc,
                       chunk_size=4)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            paged_decode(q, pool, pool, lens, bt)
        with pytest.raises(ValueError, match="CUDA"):
            ssd_chunk_scan(x, torch.zeros(1, 4, 2), torch.zeros(2), bc, bc,
                           chunk_size=4)
    # the backward's own wrapper launches on CUDA tensors or raises
    t = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_bwd(t, t, t, t, torch.zeros(1, 2, 2), t)
    assert flash_prefill_bwd.launches == 0 and ssd_chunk_scan.launches == 0
    # the backward's body, chosen as the forward's is
    assert bwd_body(torch.bfloat16, 64, 64) == "tensor-core"
    assert bwd_body(torch.bfloat16, 192, 128) == "tensor-core"
    assert bwd_body(torch.bfloat16, 96, 64) == "fma"
    assert bwd_body(torch.float32, 64, 64) == "fma"


def test_build_names_every_source_and_entry_point():
    """Each csrc/*.cu builds into its own library whose name carries the
    source hash, and every C entry point it defines has a ctypes
    signature (pointers and the stream as c_void_p)."""
    sources = {f.stem for f in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
    for name, fns in _build.SIGNATURES.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        for fn, argtypes in fns.items():
            assert f'extern "C" int {fn}(' in text
            assert argtypes[-1] is _build.P          # the stream
        path = _build.library_path(name)
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert "build" in path.parts
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize(
    "dtype,dq,dv,body",
    [
        (torch.bfloat16, 64, 64, "tensor-core"),    # TinyLlama's heads
        (torch.bfloat16, 128, 128, "tensor-core"),  # the second instance
        (torch.bfloat16, 160, 160, "tensor-core"),  # stablelm-12b
        (torch.bfloat16, 192, 192, "tensor-core"),  # nemotron-4-340b
        (torch.float32, 160, 160, "fma"),
        (torch.bfloat16, 192, 128, "tensor-core"),  # MLA (deepseek-v3)
        (torch.float32, 64, 64, "fma"),        # TF32 would miss f32 limits
        (torch.float32, 128, 128, "fma"),
        (torch.bfloat16, 96, 64, "fma"),       # MLA-shaped Dq != Dv
        (torch.bfloat16, 256, 256, "fma"),     # no template instance
    ],
)
def test_prefill_body_is_a_function_of_dtype_and_head_dims(dtype, dq, dv,
                                                           body):
    assert prefill_body(dtype, dq, dv) == body


def _ssd_bwd_args(b=1, l=8, h=2, p=4, g=1, n=16, dtype=torch.float32):
    x = torch.zeros(b, l, h, p, dtype=dtype)
    bc = torch.zeros(b, l, g, n, dtype=dtype)
    return [x, torch.zeros(b, l, h), torch.zeros(h), bc, bc, x.clone()]


@pytest.mark.parametrize("change,error,match", [
    ({}, ValueError, "CUDA"),                          # CPU tensors
    ({"chunk_size": 3}, ValueError, "bad shapes"),     # L % chunk != 0
    ({"l": 0}, ValueError, "bad shapes"),              # an empty sequence
    ({"b": 0}, ValueError, "bad shapes"),              # an empty batch
    ({"chunk_size": 256, "l": 256}, ValueError, "bad shapes"),
    ({"n": 160}, ValueError, "bad shapes"),            # N above 128
    ({"p": 96}, ValueError, "bad shapes"),             # P above one slab
    ({"h": 3, "g": 2}, ValueError, "bad shapes"),      # H % G != 0
    ({"dy": "short"}, ValueError, "bad shapes"),
    ({"d_final": "wrong"}, ValueError, "bad shapes"),
    ({"dtype": torch.float16}, TypeError, "x/B/C"),
    ({"dt": torch.bfloat16}, TypeError, "dt must be float32"),
    ({"d_final": torch.bfloat16}, TypeError, "d_final must be float32"),
    ({"dy": torch.bfloat16}, TypeError, "dy must be"),
])
def test_ssd_backward_refuses_before_any_launch(change, error, match):
    """``ssd_chunk_scan_bwd`` checks shapes, dtypes and devices before it
    allocates or launches anything: each bad call raises, and its launch
    count stays 0."""
    kw = {k: change[k] for k in ("b", "l", "h", "p", "g", "n", "dtype")
          if k in change}
    x, dt, a, bm, cm, dy = _ssd_bwd_args(**kw)
    dfin = None
    if change.get("dt") is torch.bfloat16:
        dt = dt.to(torch.bfloat16)
    if change.get("dy") == "short":
        dy = dy[:, :-1]
    elif change.get("dy") is torch.bfloat16:
        dy = dy.to(torch.bfloat16)
    if change.get("d_final") == "wrong":
        dfin = torch.zeros(1, 2, 4, 8)
    elif change.get("d_final") is torch.bfloat16:
        dfin = torch.zeros(1, 2, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(error, match=match):
        sb.ssd_chunk_scan_bwd(x, dt, a, bm, cm, dy,
                              chunk_size=change.get("chunk_size", 4),
                              d_final=dfin)
    assert sb.ssd_chunk_scan_bwd.launches == 0


def test_ssd_backward_body_and_scratch():
    """The backward's body is chosen by dtype alone (bf16 on wgmma, f32
    on 3xTF32 mma.sync); its C entry points take 15 pointers, 7 sizes
    and the stream (and its plan three sizes and an output pointer); its
    scratch is the state and cotangent slots of each (sequence, chunk,
    head), their decays and C . dC_state, and the da partials: no term
    holds a per-position copy of N for each head (no [B, L, H, ., N]
    partials of dB and dC)."""
    assert sb.bwd_body(torch.bfloat16) == "tensor-core"
    assert sb.bwd_body(torch.float32) == "tf32x3"
    assert set(sb.ENTRY) == {"tensor-core", "tf32x3"}
    for entry in sb.ENTRY.values():
        argtypes = _build.SIGNATURES["ssd_backward"][entry]
        assert argtypes == (_build.P,) * 15 + (_build.I,) * 7 + (_build.P,)
    assert _build.SIGNATURES["ssd_backward"]["ssd_scan_bwd_plan"] == (
        _build.I, _build.I, _build.I, _build.P)
    # mamba2-1.3b's training shape: a slot of two bf16 planes of 64 x 128
    b, l, h, p, n, q = 4, 2048, 64, 64, 128, 128
    bch = b * (l // q) * h
    assert sb.slot_floats(n) == 2 * 64 * 128 // 2 == p * n
    want = bch * (2 * p * n + 4 * 128 + 2 * 128 + 4) + bch + 4
    for body in sb.ENTRY:
        assert sb.scratch_floats(b, l, h, p, n, q, body) == want
    # 0.28 GB in all at mamba2's training shape
    assert 4 * want < 0.29e9
    # the slots are the floor (the states in HBM); beyond them the
    # scratch grows with B L H (decays, C . dC_state), never with N
    for n_ in (20, 64, 100, 128):
        rest = (sb.scratch_floats(b, l, h, p, n_, q, "tensor-core")
                - 2 * bch * sb.slot_floats(n_))
        assert rest == bch * (4 * 128 + 2 * 128 + 4 + 1) + 4
    # an f32 [P][N] state fits the bf16 image's slot at every N
    for n_ in range(1, 129):
        assert 64 * n_ <= sb.slot_floats(n_)
    assert sb.scratch_floats(1, 37, 4, 12, 20, 37, "tensor-core") == (
        4 * (2 * 2 * 64 * 64 // 2 + 4 * 128 + 2 * 128 + 4) + 4 + 4)


@pytest.mark.parametrize("rep,cs", [(64, 8), (32, 8), (8, 8), (4, 4),
                                    (2, 2), (1, 1), (3, 1), (12, 4),
                                    (24, 8), (6, 2)])
def test_ssd_backward_cluster_size(rep, cs):
    """A cluster splits one group's heads among its CTAs: the largest
    power of two up to 8 (the portable cluster size) that divides H / G,
    so every CTA walks the same number of heads, in a fixed order.  The
    dB / dC launch also splits N's 64-column slabs among its CTAs."""
    assert sb.cluster_size(rep) == cs
    assert rep % cs == 0 and cs <= 8 and cs & (cs - 1) == 0
    for units in (1, 3, 16, 64, 4096):
        ar = sb.arrangement(rep, 128, units)
        ctas, slices, heads = ar["dbc"]
        # a cluster: every slab's slices, or one slab's (few chunks)
        assert ctas in (slices, 2 * slices) and ctas <= 8
        assert slices * heads == rep and 64 // slices % 4 == 0
        assert ar == sb.arrangement(rep, 20, units) or ctas == 2 * slices
        ctas, slices, heads = ar["dx"]
        assert ctas == cs and slices % cs == 0 and slices * heads == rep
        # few chunks: more slices, down to one head a CTA
        assert slices == rep or units * slices >= 264 or rep // slices % 2


def test_ssd_backward_tensor_maps():
    """The bf16 body loads x and dy [B, L, H, P] and B and C [B, L, G,
    N] by TMA only where every stride is a whole number of 16 bytes and a
    head's row is one 64-column slab; the maps' dims run innermost first,
    their boxes are one slab of one head's 128 chunk rows."""
    dims, strides, box = sb.tma_dims(4, 2048, 64, 64)
    assert dims == (64, 64, 2048, 4)
    assert strides == (128, 64 * 128, 2048 * 64 * 128)
    assert box == (64, 1, 128, 1)
    assert all(s % 16 == 0 for s in strides)
    assert 64 * 2 == 128                       # one box row: a 128 B slab
    dims, strides, box = sb.tma_dims(4, 2048, 1, 128)   # B, C at G1 N128
    assert dims == (128, 1, 2048, 4) and strides[0] == 256
    assert sb.uses_tma(64, 128) and sb.uses_tma(64, 64)
    # P12 N20: strides of 24 and 40 bytes, which TMA refuses: copies
    assert not sb.uses_tma(12, 20)
    assert not sb.uses_tma(64, 20) and not sb.uses_tma(32, 128)
    assert 12 * 2 % 16 and 20 * 2 % 16


@pytest.mark.parametrize("n", [1, 20, 64, 65, 100, 128])
def test_ssd_backward_shared_memory_fits(n):
    """Every chunk CTA of the tensor-core body fits the H100's 232,448
    bytes of shared memory at every N (and so every chunk: the tiles hold
    128 rows whatever the chunk), with its f32 reduction buffer of one
    slab, [128][68], inside the two stages it reuses; so does every pass
    CTA."""
    smem = sb.chunk_smem(n)
    assert smem <= sb.SMEM_LIMIT and sb.pass_smem(n) <= sb.SMEM_LIMIT
    ns = -(-n // 64)
    stages = smem - 1024 - 40 - 2 * 128 * ns * 128
    assert 4 * 128 * 68 <= stages
    assert sb.chunk_smem(128) == 216_104


def test_ssd_scan_refuses_an_empty_call_before_any_launch():
    """The forward's empty-shape repair: an empty batch or sequence is a
    bad shape, refused on the CPU before any device check, allocation or
    launch (the kernel used to return without writing the final state)."""
    before = ssd_chunk_scan.launches
    for bsz, l in ((0, 4), (1, 0), (0, 0)):
        x = torch.zeros(bsz, l, 2, 8)
        bc = torch.zeros(bsz, l, 1, 16)
        with pytest.raises(ValueError, match="bad shapes"):
            ssd_chunk_scan(x, torch.zeros(bsz, l, 2), torch.zeros(2), bc, bc,
                           chunk_size=4)
    assert ssd_chunk_scan.launches == before == 0


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "tensor-core"),
                                        (torch.float32, "fma")])
def test_ssd_body_is_a_function_of_dtype(dtype, body):
    """bf16 scans on tensor cores and f32 on FMAs; the body's C entry point
    takes the f32 C.B^T scratch (a ninth pointer before the sizes) exactly
    when the body is the FMA one, so the wrapper's one choice fixes both."""
    assert ssd_body(dtype) == body
    argtypes = _build.SIGNATURES["ssd_scan"][SSD_ENTRY[body]]
    assert argtypes.index(_build.I) == (9 if body == "fma" else 8)


# ---------------------------------------------------------------------------
# the backward's tensor-core body on the host: its tiling and its TMA maps
# (the kernel itself is held against its plain version by chip_smoke.py)
# ---------------------------------------------------------------------------

def _slab_tile(rows, d):
    return rows * -(-d // 64) * 128     # 64-column slabs of 128-byte rows


@pytest.mark.parametrize("dq,dv,br,blocks", [
    (64, 64, 64, 2),      # TinyLlama: two blocks a SM
    (128, 128, 64, 1),
    (160, 160, 32, 1),    # stablelm-12b
    (192, 192, 16, 1),    # nemotron-4-340b
    (192, 128, 32, 1),    # MLA (deepseek-v3)
])
def test_backward_tile_plan_fits_the_card(dq, dv, br, blocks):
    """Each tensor-core instance keeps dK, dV, S^T and dP^T of a consumer
    thread ((dq + dv + 2 br) / 2 floats) within 208 registers, and the
    rings of the blocks that share an SM within its 232,448 bytes of
    shared memory; the plan's constants are the source's."""
    plan = fb.tc_plan(dq, dv)
    assert (plan["br"], plan["blocks"], plan["bc"]) == (br, blocks, 64)
    assert (dq + dv + 2 * br) // 2 <= 208
    for kern in ("dkdv", "dq"):
        assert plan[f"smem_{kern}"] * plan["blocks"] <= fb.SMEM_LIMIT
    assert 2 <= plan["kv_stages"] <= 4 and 2 <= plan["q_stages"] <= 4
    s = plan["q_stages"]
    assert plan["smem_dq"] == (_slab_tile(64, dq) + _slab_tile(64, dv)
                               + s * (_slab_tile(64, dq) + _slab_tile(64, dv))
                               + (2 * s + 1) * 8 + 1024)
    s = plan["kv_stages"]
    assert plan["smem_dkdv"] == (_slab_tile(64, dq) + _slab_tile(64, dv)
                                 + s * (_slab_tile(br, dq) + _slab_tile(br, dv)
                                        + 8 * br + 8)
                                 + (2 * s + 1) * 8 + 1024)
    src = (_build.CSRC / "flash_backward.cu").read_text()
    assert "return dq + dv <= 256 ? 64 : dq + dv <= 320 ? 32 : 16;" in src
    assert "constexpr int THREADS = WG + 32;" in src


def test_backward_tile_plan_refuses_other_head_dims():
    """Only the instances the source has get a plan; the wrapper sends
    every other bf16 pair to the FMA body."""
    for dq, dv in ((96, 64), (256, 256), (64, 128)):
        with pytest.raises(ValueError, match="no tensor-core instance"):
            fb.tc_plan(dq, dv)
        assert bwd_body(torch.bfloat16, dq, dv) == "fma"


@pytest.mark.parametrize("shape,rows,dims,strides", [
    ((4, 2048, 32, 64), 64, (64, 32, 2048, 4), (128, 4096, 8388608)),
    ((1, 512, 8, 160), 32, (160, 8, 512, 1), (320, 2560, 1310720)),
    ((1, 369, 128, 192), 16, (192, 128, 369, 1), (384, 49152, 18137088)),
])
def test_backward_tensor_maps(shape, rows, dims, strides):
    """The 4-D TMA map of a [B, S, heads, D] bf16 tensor: dims innermost
    first, byte strides of the heads, positions and sequences, and a box of
    one head's rows by one 64-column slab."""
    assert fb.tensor_map(shape, rows) == dict(dims=dims, strides=strides,
                                              box=(64, 1, rows, 1))


def test_backward_tensor_map_refusals():
    """TMA takes strides of 16-byte multiples and boxes of at most 256
    rows; anything else is refused, never encoded."""
    with pytest.raises(ValueError, match="no TMA map"):
        fb.tensor_map((1, 8, 3, 4), 64)        # 8-byte head rows
    with pytest.raises(ValueError, match="no TMA map"):
        fb.tensor_map((1, 8, 2, 64), 512)      # a box of 512 rows


def test_backward_refuses_misaligned_operands():
    """The tensor-core body reads q, k, v and d_out by TMA and out and
    d_out 16 bytes at a time: an operand off a 16-byte boundary is named
    in the refusal, an aligned set is taken."""
    def at(offset):
        n = 2 * 4 * 2 * 64
        buf = torch.zeros(n + 8, dtype=torch.bfloat16)
        return buf[offset:offset + n].view(2, 4, 2, 64)

    good = [at(0) for _ in range(5)]
    assert fb.tc_refusal(*good) is None
    for i, name in enumerate(("q", "k", "v", "out", "d_out")):
        ops = list(good)
        ops[i] = at(1)
        assert fb.tc_refusal(*ops) == f"{name} is not 16-byte aligned"


def _split_plan_replay(q, k_pages, v_pages, lengths, block_tables):
    """The decode kernel's arithmetic in plain torch: per-split softmax
    partials over the splits ``decode_splits`` plans, then the combine
    the last split of each (sequence, kv head) runs."""
    if block_tables is not None:
        k_pages, v_pages = k_pages[block_tables.long()], v_pages[block_tables.long()]
    b, p, page, hkv, d = k_pages.shape
    h, dv = q.shape[1], v_pages.shape[-1]
    rep = h // hkv
    k = k_pages.reshape(b, p * page, hkv, d)
    v = v_pages.reshape(b, p * page, hkv, dv)
    out = torch.zeros(b, h, dv)
    splits = decode_splits(p, page)
    for i in range(b):
        n = min(int(lengths[i]), p * page)
        live = [s for s in range(splits) if s * SPLIT < n]
        for g in range(hkv):
            qg = q[i, g * rep:(g + 1) * rep]                      # [rep, D]
            parts = []
            for s in live:
                lo, hi = s * SPLIT, min(n, (s + 1) * SPLIT)
                sc = qg @ k[i, lo:hi, g].T * d ** -0.5            # [rep, T]
                m = sc.max(dim=1).values
                w = torch.exp(sc - m[:, None])
                parts.append((m, w.sum(dim=1), w @ v[i, lo:hi, g]))
            if not parts:
                continue                                          # zeros
            big_m = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            num = sum(torch.exp(m - big_m)[:, None] * a for m, _, a in parts)
            den = sum(torch.exp(m - big_m) * l for m, l, _ in parts)
            out[i, g * rep:(g + 1) * rep] = num / torch.clamp(den, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("tables", [False, True])
def test_decode_split_plan_matches_reference(tables):
    """Splitting each sequence into ``SPLIT``-token partials and combining
    them gives the reference's decode attention, at lengths around a
    split's edge, of one token, of zero and of the whole table."""
    assert f"constexpr int SPLIT = {SPLIT};" in (
        _build.CSRC / "paged_attention.cu").read_text()
    b, p, page, h, hkv, d = 5, 8, 128, 8, 2, 16
    rng = np.random.default_rng(11)
    q = _rand(rng, (b, h, d))
    lens = np.asarray([0, 1, 64, 65, 1024], np.int32)
    if tables:
        n = b * p + 1
        kp, vp = _rand(rng, (n, page, hkv, d)), _rand(rng, (n, page, hkv, d))
        bt = (rng.permutation(n - 1)[: b * p] + 1).reshape(b, p).astype(np.int32)
        args = (q, kp, vp, lens)
        got = _split_plan_replay(*map(torch.from_numpy, args),
                                 torch.from_numpy(bt))
        want = tref.paged_attention_ref(*map(torch.from_numpy, args),
                                        block_tables=torch.from_numpy(bt))
        jwant = jref.paged_attention_ref(*map(jnp.asarray, args),
                                         block_tables=jnp.asarray(bt))
    else:
        kp = _rand(rng, (b, p, page, hkv, d))
        vp = _rand(rng, (b, p, page, hkv, d))
        args = (q, kp, vp, lens)
        got = _split_plan_replay(*map(torch.from_numpy, args), None)
        want = tref.paged_attention_ref(*map(torch.from_numpy, args))
        jwant = jref.paged_attention_ref(*map(jnp.asarray, args))
    assert decode_splits(p, page) == 16
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    _close(got, jwant)
    assert got[0].abs().max().item() == 0.0


def test_launch_counts_survive_two_threads():
    """The serving engine launches kernels from its decode loop and its
    write-back worker at once: ``_build.count`` loses no launch when
    more threads than cores count the same wrapper, switching often."""
    import sys
    import threading

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per_thread = 16, 500

    def work():
        for _ in range(per_thread):
            _build.count(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * per_thread


def test_decode_counters_grow_once_across_threads():
    """``paged_decode``'s arrival-counter buffer is shared per device by
    every serving thread (cluster replicas, adapter workers, the stream
    worker).  Growing it from more threads than cores, switching often,
    appends each size once: the buffers grow strictly, and every call
    gets one at least as large as it asked for.  A CPU device stands in
    for the card; the buffer logic is the same."""
    import random
    import sys
    import threading

    dev = torch.device("cpu")
    n_threads, calls = 16, 200
    barrier = threading.Barrier(n_threads)
    short = []

    def work(seed):
        rng = random.Random(seed)
        barrier.wait(timeout=30)
        for _ in range(calls):
            n = 1024 * rng.randint(1, 96)
            if paged_attention_mod._counters(dev, n).numel() < n:
                short.append(n)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        sizes = [b.numel() for b in paged_attention_mod._COUNTERS[dev]]
    finally:
        sys.setswitchinterval(old)
        paged_attention_mod._COUNTERS.pop(dev, None)
    assert not any(t.is_alive() for t in threads)
    assert not short
    assert sizes == sorted(set(sizes)) and sizes[-1] == 96 * 1024
