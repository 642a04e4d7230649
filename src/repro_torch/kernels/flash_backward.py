"""The backward of the dense flash prefill on the card: the wrapper of
``csrc/flash_backward.cu``.

``flash_prefill_bwd`` computes the gradient of ``flash_prefill`` (K4,
which replaces the Pallas ``_kernel`` of
``repro/kernels/chunked_prefill.py``).  The reference has no backward
kernel -- its ``jax.grad`` differentiates the jnp oracle -- so this is
the port's own: the FlashAttention-2 backward from the forward's output
and its per-row LSE, in three launches (``delta = rowsum(dO o O)``, then
dK/dV per key tile with GQA summed in the block, then dQ per query tile),
deterministic.  It takes CUDA tensors only; ``kernels/ops.py`` routes a
CPU graph to the plain ``ref.attention_bwd_ref`` through the same
``FlashAttention`` function.  Each launch runs one of two bodies, chosen
by ``bwd_body`` from the dtype and the head dims alone: bf16 at a (Dq,
Dv) pair of ``TENSOR_CORE_SHAPES`` on tensor cores (WMMA), everything
else on f32 FMAs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the (Dq, Dv) pairs with an instance of bwd_tc: the GQA head dims of the
# served families and MLA's Dq 192 / Dv 128
TENSOR_CORE_SHAPES = ((64, 64), (128, 128), (160, 160), (192, 192),
                      (192, 128))


def bwd_body(dtype: torch.dtype, dq: int, dv: int) -> str:
    """Which body of ``csrc/flash_backward.cu`` a launch runs:
    ``"tensor-core"`` for bf16 with ``(dq, dv)`` in ``TENSOR_CORE_SHAPES``,
    else ``"fma"`` (f32, whose limit tensor cores would miss by rounding
    through TF32, and bf16 at other head dims)."""
    if dtype == torch.bfloat16 and (dq, dv) in TENSOR_CORE_SHAPES:
        return "tensor-core"
    return "fma"


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      d_out: torch.Tensor, *, causal: bool = True,
                      q_offset: int = 0, sliding_window: int | None = None,
                      softmax_scale: float | None = None):
    """``(dq, dk, dv)`` of ``flash_prefill(q, k, v, ...)`` at the same mask
    arguments, from its output ``out`` [B, Sq, H, Dv], its ``lse`` [B, H,
    Sq] f32 and ``d_out`` [B, Sq, H, Dv].  q/k/v/out/d_out share f32 or
    bf16; every tensor is contiguous on the card.  Launches on the current
    stream without synchronising."""
    tensors = {"q": q, "k": k, "v": v, "out": out, "d_out": d_out,
               "lse": lse}
    for n, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"flash_prefill_bwd: {n} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"flash_prefill_bwd: {n} must be contiguous")
    dts = {t.dtype for n, t in tensors.items() if n != "lse"}
    if len(dts) != 1 or next(iter(dts)) not in _DTYPES:
        raise TypeError("flash_prefill_bwd: q/k/v/out/d_out must share one "
                        f"of {list(_DTYPES)}, got {sorted(map(str, dts))}")
    if lse.dtype != torch.float32:
        raise TypeError("flash_prefill_bwd: lse must be float32")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_prefill_bwd: q/k/v must be [B, S, heads, D]")
    b, sq, h, d = q.shape
    _, skv, hkv, dk_dim = k.shape
    dv = v.shape[-1]
    if (k.shape[0] != b or dk_dim != d or v.shape[:3] != k.shape[:3]
            or h % hkv or max(d, dv) > 256
            or out.shape != (b, sq, h, dv) or d_out.shape != out.shape
            or lse.shape != (b, h, sq)):
        raise ValueError(
            f"flash_prefill_bwd: bad shapes q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} out {tuple(out.shape)} "
            f"d_out {tuple(d_out.shape)} lse {tuple(lse.shape)} "
            "(head_dim <= 256, H % Hkv == 0)")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    tc = int(bwd_body(q.dtype, d, dv) == "tensor-core")
    if tc and any(t.data_ptr() % 16 for t in (q, k, v, d_out)):
        raise ValueError("flash_prefill_bwd: the tensor-core body needs "
                         "q/k/v/d_out 16-byte aligned")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dvt = torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = getattr(_build.load("flash_backward"),
                 f"flash_prefill_bwd_{_DTYPES[q.dtype]}")
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dvt.data_ptr(), b, sq, skv, h,
              hkv, d, dv, scale, int(q_offset), int(bool(causal)),
              int(sliding_window or 0), tc,
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_prefill_bwd")
    _build.count(flash_prefill_bwd)
    return dq, dk, dvt


flash_prefill_bwd.launches = 0
