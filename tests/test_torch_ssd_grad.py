"""The gradient of the SSD chunked scan: the port's plain backward
(``ref.ssd_scan_bwd_ref``, the steps the card's ``ssd_chunk_scan_bwd``
takes) and its autograd function (``ops.SSDScan``, which ``ops.ssd_scan``
goes through under grad) against ``jax.vjp`` of the reference's
``repro.kernels.ref.ssd_scan_ref``, and against ``torch.autograd.grad`` of
the port's plain forward.

Inputs and cotangents come from a numpy seed and feed both packages, at
f32 on the CPU.  Tolerance: atol 1e-4 / rtol 1e-3 on every gradient, the
repo's gradient limit (``tests/test_torch_train_loss.py``): XLA and torch
sum each product in another order, and the backward sums over chunks,
heads and positions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_scan_ref as jssd_scan_ref
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
NAMES = ("dx", "ddt", "da", "dB", "dC", "d_initial_state")

# (label, B, L, H, P, G, N, chunk, initial state?, d_final?, dt = 0 rows
# at the end: the padding of a prefill to a chunk multiple)
CASES = [
    ("G1 N16 chunk 16", 2, 32, 4, 8, 1, 16, 16, False, False, 0),
    ("G2 N16 with initial state and d_final", 2, 32, 4, 8, 2, 16, 8, True,
     True, 0),
    ("one ragged chunk of 37, N20", 1, 37, 2, 6, 1, 20, 37, False, False, 0),
    ("two chunks of 37, G2 N20, initial state, d_final", 2, 74, 4, 5, 2, 20,
     37, True, True, 0),
    ("chunk 1, G2", 2, 6, 4, 3, 2, 16, 1, True, True, 0),
    ("N20, 5 padding rows, d_final", 2, 24, 4, 8, 1, 20, 8, False, True, 5),
    ("G2 N16, 7 padding rows, initial state", 1, 32, 4, 4, 2, 16, 16, True,
     False, 7),
]
IDS = [c[0] for c in CASES]


def _inputs(case, seed=0):
    """numpy x, dt, a, B, C, initial state (zeros when the case has none),
    dy and d_final (zeros when none), with the reference kernel test's
    step and decay ranges."""
    _, b, l, h, p, g, n, _, _, _, pad = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (rng.random((b, l, h)) * 0.19 + 0.01).astype(np.float32)
    if pad:
        dt[:, l - pad:] = 0.0
        x[:, l - pad:] = 0.0
    a = (-(rng.random(h) * 1.5 + 0.5)).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dfin = rng.standard_normal((b, h, p, n)).astype(np.float32)
    if not case[8]:
        s0 = np.zeros_like(s0)
    if not case[9]:
        dfin = np.zeros_like(dfin)
    return x, dt, a, bm, cm, s0, dy, dfin


def _jax_grads(case, x, dt, a, bm, cm, s0, dy, dfin):
    chunk = case[7]

    def f(*args):
        return jssd_scan_ref(*args[:5], chunk_size=chunk,
                             initial_state=args[5])

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, dt, a, bm, cm, s0)))
    return [np.asarray(t) for t in vjp((jnp.asarray(dy),
                                        jnp.asarray(dfin)))]


def _assert_grads(got, want, case):
    for name, g, w in zip(NAMES, got, want):
        if g is None:
            continue
        np.testing.assert_allclose(np.asarray(g), w,
                                   err_msg=f"{case[0]}: {name}", **GRAD_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    x, dt, a, bm, cm, s0, dy, dfin = _inputs(case)
    want = _jax_grads(case, x, dt, a, bm, cm, s0, dy, dfin)
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm, s0, dy, dfin)]
    got = ref.ssd_scan_bwd_ref(
        *t[:5], t[5] if case[8] else None, t[6], t[7] if case[9] else None,
        case[7])
    assert got[0].dtype == got[3].dtype == got[4].dtype == torch.float32
    _assert_grads([g.numpy() for g in got], want, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ssd_scan_function_matches_jax_vjp(case):
    """``ops.ssd_scan`` on tensors that require grad goes through
    ``SSDScan``; its output equals the plain forward's, and its
    gradients, with ``d_final`` as the final state's cotangent, equal
    ``jax.vjp``'s."""
    x, dt, a, bm, cm, s0, dy, dfin = _inputs(case)
    want = _jax_grads(case, x, dt, a, bm, cm, s0, dy, dfin)
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (x, dt, a, bm, cm)]
    init = torch.from_numpy(s0).requires_grad_(True) if case[8] else None
    y, final = ops.ssd_scan(*leaves, chunk_size=case[7], initial_state=init)
    assert y.grad_fn is not None
    with torch.no_grad():
        y0, f0 = ref.ssd_scan_ref(*leaves, chunk_size=case[7],
                                  initial_state=init)
    assert torch.equal(y.detach(), y0) and torch.equal(final.detach(), f0)
    outs, cots = [y], [torch.from_numpy(dy)]
    if case[9]:
        outs.append(final)
        cots.append(torch.from_numpy(dfin))
    torch.autograd.backward(outs, cots)
    got = [t.grad.numpy() for t in leaves]
    got.append(init.grad.numpy() if init is not None else None)
    _assert_grads(got, want, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    x, dt, a, bm, cm, s0, dy, dfin = _inputs(case, seed=1)
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (x, dt, a, bm, cm, s0)]
    y, final = ref.ssd_scan_ref(*leaves[:5], chunk_size=case[7],
                                initial_state=leaves[5])
    want = torch.autograd.grad(
        (y, final), leaves, (torch.from_numpy(dy), torch.from_numpy(dfin)))
    with torch.no_grad():
        got = ref.ssd_scan_bwd_ref(*leaves, torch.from_numpy(dy),
                                   torch.from_numpy(dfin), case[7])
    _assert_grads([g.numpy() for g in got], [w.numpy() for w in want], case)


def test_only_the_inputs_that_need_it_get_a_gradient():
    """Only x and B require grad: they get gradients, equal to those of
    the full backward; dt, a, C and the initial state get none, and a
    final state left unused counts as a zero cotangent."""
    case = CASES[1]
    x, dt, a, bm, cm, s0, dy, _ = _inputs(case)
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm, s0)]
    t[0].requires_grad_(True)
    t[3].requires_grad_(True)
    y, _ = ops.ssd_scan(*t[:5], chunk_size=case[7], initial_state=t[5])
    y.backward(torch.from_numpy(dy))
    full = ref.ssd_scan_bwd_ref(*t[:6], torch.from_numpy(dy), None, case[7])
    assert torch.equal(t[0].grad, full[0]) and torch.equal(t[3].grad, full[3])
    for i in (1, 2, 4, 5):
        assert t[i].grad is None


def test_ssd_scan_without_grad_takes_the_plain_scan():
    """With no input that requires grad, or under ``torch.no_grad()``,
    ``ops.ssd_scan`` is the plain scan and builds no graph."""
    x, dt, a, bm, cm, s0, _, _ = _inputs(CASES[1])
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm, s0)]
    y, final = ops.ssd_scan(*t[:5], chunk_size=8, initial_state=t[5])
    want = ref.ssd_scan_ref(*t[:5], chunk_size=8, initial_state=t[5])
    assert y.grad_fn is None and torch.equal(y, want[0])
    assert torch.equal(final, want[1])
    t[0].requires_grad_(True)
    with torch.no_grad():
        y, _ = ops.ssd_scan(*t[:5], chunk_size=8, initial_state=t[5])
    assert y.grad_fn is None
