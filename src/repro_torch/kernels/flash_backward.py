"""The backward of the dense flash prefill on the card: the wrapper of
``csrc/flash_backward.cu``.

``flash_prefill_bwd`` computes the gradient of ``flash_prefill`` (K4,
which replaces the Pallas ``_kernel`` of
``repro/kernels/chunked_prefill.py``).  The reference has no backward
kernel -- its ``jax.grad`` differentiates the jnp oracle -- so this is
the port's own: the FlashAttention-2 backward from the forward's output
and its per-row LSE, deterministic: dK/dV per key tile with GQA summed
in the block, dQ per query tile, and ``delta = rowsum(dO o O)``.  It
takes CUDA tensors only; ``kernels/ops.py`` routes a CPU graph to the
plain ``ref.attention_bwd_ref`` through the same ``FlashAttention``
function.  Two bodies, chosen by ``bwd_body`` from the dtype and the
head dims alone: bf16 at a (Dq, Dv) pair of ``TENSOR_CORE_SHAPES`` on
Hopper's tensor cores (``wgmma`` fed by a TMA producer warp, two
launches: dq, whose prologue writes delta, then dkdv; its tiling is
``tc_plan``, each operand's TMA map ``tensor_map``), everything else on
f32 FMAs (three launches: delta, dkdv, dq).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the (Dq, Dv) pairs with an instance of bwd_tc: the GQA head dims of the
# served families and MLA's Dq 192 / Dv 128
TENSOR_CORE_SHAPES = ((64, 64), (128, 128), (160, 160), (192, 192),
                      (192, 128))
# the tensor-core body's blocks: one consumer warpgroup of 64 rows (keys in
# dkdv, query rows in dq) beside one producer warp; shared-memory tiles are
# cut into 64-column slabs of 128-byte rows (csrc/hopper.cuh)
SLAB = 64
SMEM_LIMIT = 232_448    # dynamic shared memory of one block on the H100
PLAN_KEYS = ("br", "bc", "blocks", "kv_stages", "q_stages", "smem_dkdv",
             "smem_dq")


def _tile_bytes(rows: int, d: int) -> int:
    return rows * -(-d // SLAB) * 2 * SLAB


def _ring(fixed: int, stage: int, blocks: int) -> tuple[int, int]:
    """(stages, bytes) of a ring beside ``fixed`` bytes staged once: as
    many stages, up to 4, as fit ``blocks`` blocks on an SM, with the
    barriers and 1024 bytes of slack for the swizzle's alignment."""
    for s in (4, 3, 2):
        smem = fixed + s * stage + (2 * s + 1) * 8 + 1024
        if smem * blocks <= SMEM_LIMIT or s == 2:
            return s, smem


def tc_plan(dq: int, dv: int) -> dict:
    """The tiling of the tensor-core instance ``(dq, dv)``, as
    ``wg_body::Plan`` in ``csrc/flash_backward.cu`` lays it out (the card
    reports its own through ``flash_prefill_bwd_plan``): ``br``, the dkdv
    query tile, keeps dK, dV, S^T and dP^T of the consumer thread within
    its registers; ``bc`` is the dq key tile; ``blocks`` share an SM (two
    at D 64, 168 registers a thread; else one, 255); each ring takes as
    many stages, up to 4, as fit them.  A dkdv stage also holds the tile's
    LSE and delta rows and its position (8 Br + 8 bytes)."""
    if (dq, dv) not in TENSOR_CORE_SHAPES:
        raise ValueError(f"no tensor-core instance at Dq {dq}, Dv {dv}")
    br = 64 if dq + dv <= 256 else 32 if dq + dv <= 320 else 16
    bc = 64
    blocks = 2 if dq + dv <= 128 else 1
    kv_stages, smem_dkdv = _ring(
        _tile_bytes(64, dq) + _tile_bytes(64, dv),
        _tile_bytes(br, dq) + _tile_bytes(br, dv) + 8 * br + 8, blocks)
    q_stages, smem_dq = _ring(_tile_bytes(64, dq) + _tile_bytes(64, dv),
                              _tile_bytes(bc, dq) + _tile_bytes(bc, dv),
                              blocks)
    return dict(br=br, bc=bc, blocks=blocks, kv_stages=kv_stages,
                q_stages=q_stages, smem_dkdv=smem_dkdv, smem_dq=smem_dq)


def card_plan(dq: int, dv: int) -> dict:
    """``tc_plan`` as the built library lays the instance out
    (``flash_prefill_bwd_plan``); builds the library on first use."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    fn = _build.load("flash_backward").flash_prefill_bwd_plan
    _build.check(fn(dq, dv, ctypes.addressof(out)), "flash_prefill_bwd_plan")
    return dict(zip(PLAN_KEYS, out))


def tensor_map(shape, box_rows: int) -> dict:
    """The TMA map the tensor-core body encodes for a contiguous bf16
    tensor of ``shape`` [B, S, heads, D]: its dims innermost first, the
    byte strides of dims 1-3, and the box, one head's ``box_rows`` rows by
    one 64-column slab (columns and rows past the ends read as zeros).
    Raises where TMA cannot describe it: a stride off a 16-byte multiple,
    or a box of more than 256 rows."""
    b, s, heads, d = shape
    strides = (2 * d, 2 * heads * d, 2 * s * heads * d)
    if any(x % 16 for x in strides) or not 0 < box_rows <= 256:
        raise ValueError(f"flash_prefill_bwd: no TMA map for {tuple(shape)} "
                         f"with {box_rows}-row boxes")
    return dict(dims=(d, heads, s, b), strides=strides,
                box=(SLAB, 1, box_rows, 1))


def tc_refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, d_out: torch.Tensor) -> str | None:
    """Why the tensor-core body cannot take these operands, or None: TMA
    reads q, k, v and d_out from 16-byte-aligned addresses through
    ``tensor_map``, and the dq launch reads out and d_out 16 bytes at a
    time."""
    for n, t in (("q", q), ("k", k), ("v", v), ("out", out),
                 ("d_out", d_out)):
        if t.data_ptr() % 16:
            return f"{n} is not 16-byte aligned"
    plan = tc_plan(q.shape[-1], v.shape[-1])
    try:
        for t, rows in ((q, plan["br"]), (d_out, plan["br"]), (k, 64),
                        (v, 64), (q, 64), (d_out, 64), (k, plan["bc"]),
                        (v, plan["bc"])):
            tensor_map(t.shape, rows)
    except ValueError as e:
        return str(e)
    return None


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
    why = tc_refusal(q, k, v, out, d_out) if tc else None
    if why:
        raise ValueError(f"flash_prefill_bwd: the tensor-core body refuses "
                         f"these operands: {why}")
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
