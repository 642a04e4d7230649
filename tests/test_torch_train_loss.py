"""The port's training loss and its gradients against the reference's
``Model.train_loss`` under ``jax.value_and_grad``, and the dense
prefill's autograd function (``ops.FlashAttention``) against
``jax.vjp`` of the reference's jnp oracle.

Weights are the reference's ``Model.init(PRNGKey(seed))`` carried to
the port by ``params_from_numpy``; tokens, image embeddings, frames and
cotangents come from a numpy seed and feed both packages.  Every config
runs its smoke variant at f32 on the CPU.  Tolerances: the loss and its
metrics atol 2e-5 / rtol 2e-4 (one reduction over the logits, as the
kernels' limit); every gradient leaf atol 1e-4 / rtol 1e-3, the logits'
limit of ``test_torch_model.py`` (XLA and torch sum each matmul in
another order, forward and backward); the attention function's outputs,
LSE and gradients atol 2e-5 / rtol 2e-4, the kernels' limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.kernels.ref import attention_ref as jattention_ref
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import named_from_numpy, params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.training.loop import trainable

torch.set_num_threads(2)
LOSS_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
KERNEL_TOL = dict(atol=2e-5, rtol=2e-4)

# name -> (arch, config overrides, sequence length)
CONFIGS = {
    "tinyllama": ("skymemory-tinyllama", {}, 32),
    "tinyllama-window16": ("skymemory-tinyllama", {"sliding_window": 16}, 64),
    "granite": ("granite-moe-3b-a800m", {}, 32),
    "deepseek": ("deepseek-v3-671b", {}, 32),
    "llava": ("llava-next-34b", {}, 32),
    "mamba2": ("mamba2-1.3b", {}, 32),
    "zamba2": ("zamba2-1.2b", {}, 32),
    "seamless": ("seamless-m4t-large-v2", {}, 32),
}


def _pair(arch: str, seed: int = 0, **kw):
    """(reference model, its params, the port's model on them) for the
    smoke variant of ``arch`` at f32."""
    cfg = smoke_config(get_config(arch)).replace(dtype="float32", **kw)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tcfg = tsmoke(tget(arch)).replace(dtype="float32", **kw)
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return jm, params, tm


def _batch(cfg, seq: int, seed: int = 1, batch: int = 2) -> dict:
    """A numpy batch with the family's frontend inputs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"tokens": toks, "targets": toks}
    if cfg.arch_type == "vlm":
        out["image_embeds"] = (rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)) * 0.1
        ).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = (rng.standard_normal((batch, seq, cfg.d_model))
                         * 0.5).astype(np.float32)
    return out


def _port_loss_and_grads(tm, batch, remat=None):
    params = trainable(tm)
    for p in params.values():
        p.grad = None
    loss, metrics = tm.train_loss(
        {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
    loss.backward()
    grads = {n: p.grad for n, p in params.items()}
    return loss, metrics, grads


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_every_gradient_match_reference(name):
    arch, kw, seq = CONFIGS[name]
    jm, params, tm = _pair(arch, **kw)
    batch = _batch(tm.cfg, seq)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        lambda p: jm.train_loss(p, jb), has_aux=True)(params)
    loss, metrics, grads = _port_loss_and_grads(tm, batch)
    np.testing.assert_allclose(loss.item(), float(j_loss), **LOSS_TOL)
    assert set(metrics) == set(j_metrics) == {"ce", "aux", "loss"}
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   err_msg=k, **LOSS_TOL)
    if tm.cfg.num_experts:
        assert metrics["aux"].item() > 0
    want = named_from_numpy(tm, jax.tree.map(np.asarray, j_grads))
    assert set(want) == set(grads)
    for n, g in grads.items():
        assert g is not None, f"{n}: no gradient"
        np.testing.assert_allclose(g.numpy(), want[n], err_msg=n, **GRAD_TOL)


def test_mtp_head_takes_part_in_the_loss():
    """deepseek-v3's loss is the CE plus 0.3 x the MTP loss plus the aux;
    ``ce`` is the first term alone, and the MTP head gets gradients."""
    _, _, tm = _pair("deepseek-v3-671b")
    loss, metrics, grads = _port_loss_and_grads(tm, _batch(tm.cfg, 32))
    mtp = loss.item() - metrics["ce"].item() - metrics["aux"].item()
    assert mtp > 0.3          # 0.3 x a cross-entropy over a 512 vocab
    assert grads["mtp.proj"].abs().sum() > 0
    assert grads["mtp.blocks.0.attn.wq_a"].abs().sum() > 0


@pytest.mark.parametrize("arch,remat", [
    pytest.param("skymemory-tinyllama", "full", id="full"),
    pytest.param("skymemory-tinyllama", "dots", id="dots"),
    pytest.param("skymemory-tinyllama", "dots_no_batch", id="dots_no_batch"),
    pytest.param("mamba2-1.3b", "full", id="mamba2-1.3b-full"),
])
def test_remat_gives_the_same_loss_and_gradients(arch, remat):
    """Recomputing each block in the backward changes nothing: the loss
    and every gradient equal those without it, as
    ``tests/test_training.py`` requires of the reference.  mamba2's SSD
    layers run the scan through ``ops.SSDScan`` twice under
    ``remat="full"``."""
    _, _, tm = _pair(arch)
    batch = _batch(tm.cfg, 32)
    l0, _, g0 = _port_loss_and_grads(tm, batch)
    g0 = {n: g.clone() for n, g in g0.items()}
    l1, _, g1 = _port_loss_and_grads(tm, batch, remat=remat)
    assert l1.item() == pytest.approx(l0.item(), rel=1e-6)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_unknown_remat_policy_raises():
    _, _, tm = _pair("skymemory-tinyllama")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg, 8).items()}
    trainable(tm)
    with pytest.raises(ValueError, match="remat"):
        tm.train_loss(batch, remat="everything")


# ---------------------------------------------------------------------------
# the dense prefill's gradient
# ---------------------------------------------------------------------------

# (label, B, Sq, Skv, H, Hkv, Dq, Dv, causal, q_offset, window)
ATTN_CASES = [
    ("gqa causal", 2, 24, 24, 4, 2, 16, 16, True, 0, None),
    ("non-causal", 2, 20, 20, 4, 4, 16, 16, False, 0, None),
    ("cross Sq<Skv", 1, 7, 29, 4, 2, 16, 16, False, 0, None),
    ("q_offset", 1, 13, 37, 4, 1, 16, 16, True, 24, None),
    ("window", 2, 33, 33, 4, 2, 16, 16, True, 0, 8),
    ("window q_offset", 1, 17, 41, 4, 2, 16, 16, True, 24, 5),
    ("Dq != Dv", 1, 19, 19, 4, 4, 24, 16, True, 0, None),
    ("ragged", 3, 5, 5, 2, 1, 8, 8, True, 0, None),
]


def _attn_inputs(b, sq, skv, h, hkv, dq, dv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dq)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dq)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    g = rng.standard_normal((b, sq, h, dv)).astype(np.float32)
    return q, k, v, g


def _port_vjp(q, k, v, g, **kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, **kw)
    assert out.grad_fn is not None
    # a non-contiguous cotangent: the function makes it contiguous
    gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 2, 1, 3)))
    out.backward(gt.transpose(1, 2))
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), \
        vt.grad.numpy()


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_flash_attention_gradients_match_jax_vjp(case):
    _, b, sq, skv, h, hkv, dq, dv, causal, off, win = case
    q, k, v, g = _attn_inputs(b, sq, skv, h, hkv, dq, dv)
    kw = dict(causal=causal, q_offset=off, sliding_window=win)
    out, dq_, dk_, dv_ = _port_vjp(q, k, v, g, **kw)
    want, vjp = jax.vjp(lambda a, b_, c: jattention_ref(a, b_, c, **kw),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jq, jk, jv = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out, np.asarray(want), **KERNEL_TOL)
    for name, got, w in (("dq", dq_, jq), ("dk", dk_, jk), ("dv", dv_, jv)):
        np.testing.assert_allclose(got, np.asarray(w), err_msg=name,
                                   **KERNEL_TOL)


def test_rows_with_no_visible_key_get_zero_gradients():
    """With ``q_offset`` -2 the first two query rows see no key: their
    output is zeros and their LSE -inf (the kernel's contract), their
    gradients are zeros, never NaN, and they add nothing to dK / dV.
    The other rows' gradients equal ``jax.vjp`` of the reference's oracle
    (whose fully masked rows average every value instead, so their
    cotangent is zero there)."""
    q, k, v, g = _attn_inputs(2, 9, 9, 4, 2, 8, 8, seed=3)
    kw = dict(causal=True, q_offset=-2)
    _, lse = ref.attention_fwd_lse_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert torch.isinf(lse[:, :, :2]).all() and torch.isfinite(
        lse[:, :, 2:]).all()
    out, dq_, dk_, dv_ = _port_vjp(q, k, v, g, **kw)
    assert np.isfinite(dq_).all() and np.isfinite(dk_).all() \
        and np.isfinite(dv_).all()
    assert (out[:, :2] == 0).all() and (dq_[:, :2] == 0).all()
    g0 = g.copy()
    g0[:, :2] = 0
    _, vjp = jax.vjp(lambda a, b_, c: jattention_ref(a, b_, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jq, jk, jv = vjp(jnp.asarray(g0))
    for name, got, w in (("dq", dq_, jq), ("dk", dk_, jk), ("dv", dv_, jv)):
        np.testing.assert_allclose(got, np.asarray(w), err_msg=name,
                                   **KERNEL_TOL)


@pytest.mark.parametrize("case", ATTN_CASES[:6], ids=[c[0] for c in
                                                      ATTN_CASES[:6]])
def test_forward_lse_matches_jax_logsumexp(case):
    _, b, sq, skv, h, hkv, dq, dv, causal, off, win = case
    q, k, v, _ = _attn_inputs(b, sq, skv, h, hkv, dq, dv, seed=5)
    out, lse = ref.attention_fwd_lse_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        q_offset=off, sliding_window=win)
    kr = np.repeat(k, h // hkv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, kr) * dq ** -0.5
    qp = np.arange(sq)[:, None] + off
    kp = np.arange(skv)[None]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= kp <= qp
    if win:
        mask &= kp > qp - win
    want = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), **KERNEL_TOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jattention_ref(
            q, k, v, causal=causal, q_offset=off, sliding_window=win)),
        **KERNEL_TOL)


def test_streaming_forward_and_backward_match_the_full_ones():
    """From ``STREAMING_KV_THRESHOLD`` keys on, the plain forward with
    its LSE and the plain backward go block by block; at a small block
    they equal the one-block results."""
    q, k, v, g = (torch.from_numpy(a) for a in
                  _attn_inputs(1, 20, 45, 4, 2, 8, 8, seed=7))
    kw = dict(causal=True, q_offset=25, sliding_window=17,
              softmax_scale=None)
    out, lse = ref.attention_fwd_lse_ref(q, k, v, **kw)
    s_out, s_lse = ref._streaming(q, k, v, block_k=8, **kw)
    np.testing.assert_allclose(s_out.numpy(), out.numpy(), **KERNEL_TOL)
    np.testing.assert_allclose(s_lse.numpy(), lse.numpy(), **KERNEL_TOL)
    full = ref.attention_bwd_ref(q, k, v, out, lse, g, **kw)
    blocked = ref.attention_bwd_ref(q, k, v, out, lse, g, block_k=8, **kw)
    for a, b in zip(full, blocked):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **KERNEL_TOL)


def test_attention_is_recomputed_under_checkpoint():
    """``FlashAttention`` under ``torch.utils.checkpoint`` (non-reentrant)
    runs its forward again in the backward and gives the same
    gradients."""
    q, k, v, g = _attn_inputs(1, 12, 12, 4, 2, 8, 8, seed=9)

    def grads(ckpt):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))

        def f(a, b, c):
            return ops.flash_attention(a * 1.0, b, c, sliding_window=5)

        out = (torch.utils.checkpoint.checkpoint(f, qt, kt, vt,
                                                 use_reentrant=False)
               if ckpt else f(qt, kt, vt))
        out.backward(torch.from_numpy(g))
        return [t.grad for t in (qt, kt, vt)]

    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)


def test_only_the_inputs_that_need_it_get_a_gradient():
    q, k, v, g = (torch.from_numpy(a) for a in
                  _attn_inputs(1, 6, 6, 2, 1, 8, 8, seed=11))
    k.requires_grad_(True)
    out = ops.flash_attention(q, k, v)
    out.backward(g)
    assert k.grad is not None and q.grad is None and v.grad is None
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
