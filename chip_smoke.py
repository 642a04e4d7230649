#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SkyMemory on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, compute capability (9, 0);
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes (TinyLlama's attention, mamba2-1.3b's SSD
   scan; bf16 and f32) and at edge cases, with its time, the plain
   version's time, its bound and, for the dense prefill and the
   contiguous decode pool, ``scaled_dot_product_attention``'s time as a
   yardstick only.  Each case's line names the body it ran: the
   prefills run bf16 with head dim 64 or 128 on tensor cores
   (``tensor-core``), the SSD scan runs bf16 on tensor cores, and
   everything else runs on f32 FMAs (``fma``);
4. model: TinyLlama's widths at 2 layers, f32, seeded: ``forward``,
   ``prefill_chunk_paged`` and ``decode_step_paged`` logits on the card
   against the same on the CPU.  Then mamba2-1.3b's widths at 2 layers,
   f32: ``forward`` logits and state on the card against the CPU, a
   resume from the snapshot at token 256 against the uninterrupted
   forward, and ``decode_step`` from that snapshot against the prefill
   logits of the same tokens;
5. serve: full TinyLlama (22 layers, bf16, seeded random weights) behind
   the paged ``Engine``: 8 requests with a shared 256-token prefix in
   three modes (chunked contiguous pool, stop-the-world admission, a
   free-list pool small enough to preempt).  Then full mamba2-1.3b (48
   layers, bf16, seeded random weights) behind the same ``Engine``, which
   serves it through the dense runtime: the same 8 requests.  For each
   model the launch counters are zeroed just before and read just after;
   every kernel of its path must have launched.  After each, a decode
   step's breakdown: eager host wall time, device busy time in a
   ``torch.profiler`` trace, and the CUDA-graph-replayed step; after
   TinyLlama also one chunked-prefill wave (4 rows x 256 tokens over a
   384-token context) replayed from a CUDA graph, and the paged prefill
   kernel's share of it; after mamba2-1.3b one 384-token prefill
   (``Model.forward``, 48 layers) replayed from a CUDA graph, and the
   SSD scan's share of it;
6. fabric: SkyMemory prefix hits served from the port's own
   constellation, the paper's 19x5 testbed (10 LOS servers, 6 kB
   chunks), a fresh one per model.  Full TinyLlama on the paged engine
   and full mamba2-1.3b on the dense runtime each serve the same 8
   requests twice through ``Engine(kvc=...)``: the first pass writes the
   shared 256-token prefix back, the second (write-back off, launch
   counts zeroed just before and read just after) must restore all 256
   tokens of every request from the constellation, prefill only the
   suffix through the paged prefill kernel (TinyLlama) or the SSD scan
   (mamba2), and decode.  Every registered block's bytes, read back
   through ``get_block``, must equal a fresh ``kvc_fn`` on the card.
   The warm pass's TTFT, ITL and tokens/s print beside a ``kvc=None``
   engine's in the same process, with the fabric's counters and modeled
   Get flights; a TinyLlama run on a clocked fabric (``SimClock``) then
   waits out those flights;
7. cluster: scale-out serving, two full TinyLlama replicas of one model
   on one card over one clocked int8 constellation (``EngineCluster``,
   the fabric of ``benchmarks/run.py``'s cluster scenarios).  A closed
   batch of the same 8 requests twice under prefix affinity (the second
   pass must hit blocks; the paged decode, paged prefill and dense
   prefill kernels must launch), the same under the random router, and
   one engine alone beside them; the sustained stream (48 seeded
   arrivals of three tenants, deterministic pump-budget mode, admission
   capacity 600: the protected tenant sheds nothing, and a second run on
   a fresh build routes and sheds identically); the chaos arc at k=2
   (96 arrivals, kills, link cuts, a directory-stripe wipeout and a
   replica-home-pair kill over a ground tier, free-list pools: the
   protected tenant sheds nothing and the injector applies its events);
   each replica must serve a request over the phase.  Last, full
   TinyLlama and full mamba2-1.3b each on one engine with int8 payloads
   through ``submit`` / ``start`` / ``stop``: every warm request must
   restore 256 tokens, every stored block must equal a fresh
   ``kvc_fn``, and the int8 block's bytes, chunks and host Set / Get /
   decode times print beside warm and cold TTFT.  A replica thread's or
   worker's exception fails the run.

The ``kernels`` line counts each kernel's launches over the main-path
runs of phases 5-7, each counted from 0 just before it.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero and prints no result.  It imports nothing of JAX
and nothing of the ``repro`` package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12}             # f32 outside tensor cores
# kernel vs plain on the card.  f32: the repo's kernel tolerance
# (tests/test_kernels.py), tight enough to catch a key off by one; these
# cases are what hold each kernel's arithmetic.  bf16: both round the
# output to bf16 once and sum in f32 in different orders, and the plain
# path also rounds its softmax weights to bf16 before the PV product, so
# near few keys its error is a few bf16 steps of |v| -- the size of a key
# off by one.  The limits are per kernel: at rtol 1e-2, about 1.4x the
# largest atol the cases below have needed on an H100 (5.3e-3 for decode,
# 8.9e-3 for the prefills).  Each case prints its share of the limit
F32_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = {"paged_decode": dict(atol=8e-3, rtol=1e-2),
            "chunked_prefill_paged": dict(atol=1.2e-2, rtol=1e-2),
            "flash_prefill": dict(atol=1.2e-2, rtol=1e-2),
            # the plain scan computes in f32 from the bf16 inputs; the
            # kernel's tensor-core body multiplies the exact bf16 B, C and
            # x against its f32 factors (dt, the decays, the carried state)
            # split into bf16 hi + lo, ~2^-16 relative, and sums in f32.
            # Both round y to bf16 once: where the two sums straddle a
            # rounding boundary they differ by one bf16 step, at most 2^-7
            # of |y|
            "ssd_chunk_scan": dict(atol=1e-2, rtol=1e-2)}
# the SSD scan's final state is f32 in every dtype: the reference's limit
# for it (tests/test_kernels.py), which one bf16 rounding of the f32
# factors (~4e-3) would miss and their hi/lo split (~2^-16) meets
SSD_STATE_TOL = dict(atol=1e-4, rtol=1e-3)
# model logits, card vs CPU at f32 (TF32 off): cuBLAS and the CPU BLAS sum
# each matmul in a different order, and the kernels' online softmax
# differs from the plain softmax in the last bits; 2 layers at d 2048
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)
TIMING_ITERS = 20


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def warm_up(device, ms: float = 200.0) -> None:
    """Keep the card busy for ``ms`` so that it reaches its working clocks
    before anything is timed (an idle card times its first launches slow)."""
    a = torch.randn(4096, 4096, device=device, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while (time.perf_counter() - t0) * 1e3 < ms:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize(device)


class Timer:
    """Median device time of ``fn`` with a cold L2.

    ``fn`` is captured once in a CUDA graph and replayed ``iters`` times,
    each replay after a 128 MB buffer (more than the 50 MB L2) is
    rewritten.  The replays are enqueued back to back and read after one
    synchronise, so the events time the device's work, not the host's
    launch overhead (a plain version launches a dozen kernels)."""

    def __init__(self, device):
        self.device = device
        self.flush = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                 device=device)
        warm_up(device)

    def ms(self, fn, iters: int = TIMING_ITERS) -> float:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(smi)
    log(f"[device] {name}; torch {torch.__version__}; CUDA "
        f"{torch.version.cuda}; capability {cap}; count "
        f"{torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"need compute capability (9, 0), got {cap}")
    return name, smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    for name, out in logs.items():
        for line in out.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line or "error" in line):
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(logs)} libraries in {dt:.2f} s -> {_build.BUILD_DIR}")
    # loaded here, on the main thread, before any engine's write-back
    # worker can launch a kernel
    for name in _build.SIGNATURES:
        _build.load(name)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _check(name: str, kernel: str, got: torch.Tensor, want: torch.Tensor,
           tol: dict | None = None) -> tuple[float, float]:
    """(max abs err, largest err / limit) of ``got`` against ``want``."""
    torch.cuda.synchronize()
    if tol is None:
        tol = F32_TOL if got.dtype == torch.float32 else BF16_TOL[kernel]
    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    worst = (err / lim).max().item()
    if not torch.isfinite(got.float()).all() or worst > 1.0:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version, max abs err "
            f"{err.max().item():.3e}, {worst:.2f} x the limit")
    return err.max().item(), worst


def decode_case(gen, dtype, device, *, b, pages_per_seq, lengths, tables,
                h=32, hkv=4, d=64, page=128):
    n = b * pages_per_seq + (1 if tables else 0)
    q = torch.randn(b, h, d, generator=gen, device=device).to(dtype)
    kp = torch.randn(n, page, hkv, d, generator=gen, device=device).to(dtype)
    vp = torch.randn(n, page, hkv, d, generator=gen, device=device).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    if tables:
        perm = torch.randperm(n - 1, generator=gen, device=device) + 1
        bt = perm[: b * pages_per_seq].reshape(b, pages_per_seq).to(torch.int32)
        args = (q, kp, vp, lens, bt)
    else:
        shape = (b, pages_per_seq, page, hkv, d)
        args = (q, kp.reshape(shape), vp.reshape(shape), lens, None)
    valid = int(sum(lengths))
    io = nbytes(q, lens) * 2 + (nbytes(args[4]) if tables else 0)
    kv = 2 * valid * hkv * d * q.element_size()
    flops = 4 * h * d * valid
    return args, io + kv, flops


def body_of(name: str, args) -> str:
    """The body a kernel case runs: the prefills choose by dtype and head
    dims (``prefill_body``), the SSD scan by dtype (``ssd_body``); the
    decode kernel has one body, on f32 FMAs."""
    from repro_torch.kernels.chunked_prefill import prefill_body
    from repro_torch.kernels.ssd_scan import ssd_body

    if name in ("flash_prefill", "chunked_prefill_paged"):
        q, k, v = args[:3]
        return prefill_body(q.dtype, q.shape[-1], v.shape[-1])
    if name == "ssd_chunk_scan":
        return ssd_body(args[0].dtype)
    return "fma"


def run_decode(args):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode

    q, k, v, lens, bt = args
    return (lambda: paged_decode(q, k, v, lens, bt),
            lambda: ref.paged_attention_ref(q, k, v, lens, block_tables=bt))


def prefill_paged_case(gen, dtype, device, *, offs, valid, c, pages_per_seq,
                       h=32, hkv=4, d=64, page=128):
    r = len(offs)
    n = r * pages_per_seq + 1
    q = torch.randn(r, c, h, d, generator=gen, device=device).to(dtype)
    kp = torch.randn(n, page, hkv, d, generator=gen, device=device).to(dtype)
    vp = torch.randn(n, page, hkv, d, generator=gen, device=device).to(dtype)
    perm = torch.randperm(n - 1, generator=gen, device=device) + 1
    bt = perm[: r * pages_per_seq].reshape(r, pages_per_seq).to(torch.int32)
    offs_t = torch.tensor(offs, dtype=torch.int32, device=device)
    lens = offs_t + torch.tensor(valid, dtype=torch.int32, device=device)
    # keys each query row sees (padded rows included: the kernel computes
    # them and the scheduler ignores their outputs)
    seen = sum(min(o + v_, o + i + 1) for o, v_ in zip(offs, valid)
               for i in range(c))
    kv_tokens = sum(o + v_ for o, v_ in zip(offs, valid))
    n_bytes = (2 * nbytes(q) + nbytes(bt, offs_t, lens)
               + 2 * kv_tokens * hkv * d * q.element_size())
    return (q, kp, vp, lens, bt, offs_t), n_bytes, 4 * h * d * seen


def run_prefill_paged(args):
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill import chunked_prefill_paged

    return (lambda: chunked_prefill_paged(*args),
            lambda: ref.chunked_prefill_paged_ref(*args))


def flash_case(gen, dtype, device, *, b, sq, skv, off, window=None,
               causal=True, h=32, hkv=4, d=64, dv=64):
    q = torch.randn(b, sq, h, d, generator=gen, device=device).to(dtype)
    k = torch.randn(b, skv, hkv, d, generator=gen, device=device).to(dtype)
    v = torch.randn(b, skv, hkv, dv, generator=gen, device=device).to(dtype)
    seen = 0
    for i in range(sq):
        p = off + i
        lo = max(0, p - window + 1) if window else 0
        hi = min(skv, p + 1) if causal else skv
        seen += max(0, hi - lo)
    n_bytes = nbytes(q, k, v) + b * sq * h * dv * q.element_size()
    kw = dict(causal=causal, q_offset=off, sliding_window=window)
    return (q, k, v, kw), n_bytes, 2 * b * h * (d + dv) * seen


def run_flash(args):
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill import flash_prefill

    q, k, v, kw = args
    return (lambda: flash_prefill(q, k, v, **kw),
            lambda: ref.attention_ref(q, k, v, **kw))


def sdpa_flash(args):
    """``scaled_dot_product_attention`` on a dense prefill's inputs, where
    it computes the same function (no offset, no window, Dq == Dv); else
    None.  A yardstick only: the port never calls it."""
    q, k, v, kw = args
    if kw["q_offset"] or kw["sliding_window"] or q.shape[-1] != v.shape[-1]:
        return None
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, is_causal=kw["causal"],
                        enable_gqa=True).transpose(1, 2)


def sdpa_decode(args):
    """``scaled_dot_product_attention`` over the contiguous pool viewed as
    ``[B, P*page, Hkv, D]`` with a boolean length mask built outside the
    timed call: the same function for lengths > 0.  A block-table pool
    has no such view (the gather is a second call), so that layout gets
    None.  A yardstick only: the port never calls it."""
    q, k, v, lens, bt = args
    if bt is not None or not bool((lens > 0).all()):
        return None
    b, p, page, hkv, d = k.shape
    kt, vt = (x.reshape(b, p * page, hkv, d).transpose(1, 2) for x in (k, v))
    mask = (torch.arange(p * page, device=q.device)[None]
            < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q[:, :, None], kt, vt, attn_mask=mask,
                        enable_gqa=True)[:, :, 0]


def ssd_case(gen, dtype, device, *, b, l, chunk, h=64, p=64, g=1, n=128,
             with_init=False):
    """Inputs of one SSD scan (mamba2-1.3b's widths by default) with the
    reference kernel test's step and decay ranges; the bytes it must move
    and the operations this run's data needs: C.B^T once per group and
    chunk and the intra-chunk product per head, over the causal triangle
    only; the off-diagonal term for chunks whose incoming state is not
    zero; the state update for every token."""
    x = torch.randn(b, l, h, p, generator=gen, device=device).to(dtype)
    dt = torch.rand(b, l, h, generator=gen, device=device) * 0.19 + 0.01
    a = -(torch.rand(h, generator=gen, device=device) * 1.5 + 0.5)
    bm = torch.randn(b, l, g, n, generator=gen, device=device).to(dtype)
    cm = torch.randn(b, l, g, n, generator=gen, device=device).to(dtype)
    init = (torch.randn(b, h, p, n, generator=gen, device=device)
            if with_init else None)
    nc = l // chunk
    tri = chunk * (chunk + 1) // 2
    warm_chunks = nc if with_init else nc - 1
    flops = (2 * b * nc * tri * (g * n + h * p)
             + 2 * b * h * p * n * (warm_chunks * chunk + l))
    n_bytes = (nbytes(x, dt, a, bm, cm) + (nbytes(init) if with_init else 0)
               + nbytes(x) + b * h * p * n * 4)
    return (x, dt, a, bm, cm, init, chunk), n_bytes, flops


def run_ssd(args):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan

    x, dt, a, bm, cm, init, chunk = args
    return (lambda: ssd_chunk_scan(x, dt, a, bm, cm, chunk_size=chunk,
                                   initial_state=init),
            lambda: ref.ssd_scan_ref(x, dt, a, bm, cm, chunk_size=chunk,
                                     initial_state=init))


def kernel_cases(device) -> list:
    """Every kernel case: (kernel, label, dtype, main path?, make, runner);
    ``make(generator, dtype)`` draws the case's inputs when called, so
    cases made in list order from one seed get the same inputs."""
    rng = np.random.default_rng(0)
    main_lens = [int(x) for x in rng.integers(256, 448, 4)]
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases += [
            ("paged_decode", f"{tag} contiguous B4 P8", dtype, True,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=8,
                                       lengths=main_lens, tables=False),
             run_decode),
            ("paged_decode", f"{tag} block-table B8 P8", dtype, False,
             lambda g, dt: decode_case(
                 g, dt, device, b=8, pages_per_seq=8,
                 lengths=[int(x) for x in rng.integers(1, 1025, 8)],
                 tables=True),
             run_decode),
            ("paged_decode", f"{tag} edge lengths 0/1/129/1024", dtype,
             False,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=8,
                                       lengths=[0, 1, 129, 1024],
                                       tables=True),
             run_decode),
            # around a 64-token split's edge, and one 16-split sequence
            ("paged_decode", f"{tag} split edges 63/64/65/1024", dtype,
             False,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=8,
                                       lengths=[63, 64, 65, 1024],
                                       tables=True),
             run_decode),
            ("paged_decode", f"{tag} rep 1 H32 Hkv32 contiguous B4 P8",
             dtype, False,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=8,
                                       lengths=main_lens, tables=False,
                                       hkv=32),
             run_decode),
            ("paged_decode", f"{tag} rep 16 H32 Hkv2 contiguous B4 P8",
             dtype, False,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=8,
                                       lengths=main_lens, tables=False,
                                       hkv=2),
             run_decode),
            ("chunked_prefill_paged", f"{tag} wave R4 C256", dtype, True,
             lambda g, dt: prefill_paged_case(
                 g, dt, device, offs=[0, 256, 128, 0],
                 valid=[256, 104, 256, 200], c=256, pages_per_seq=8),
             run_prefill_paged),
            ("chunked_prefill_paged", f"{tag} mixed-step R1 C32", dtype,
             False,
             lambda g, dt: prefill_paged_case(
                 g, dt, device, offs=[256], valid=[19], c=32,
                 pages_per_seq=8),
             run_prefill_paged),
            ("chunked_prefill_paged", f"{tag} edge offsets 5/131, len 0",
             dtype, False,
             lambda g, dt: prefill_paged_case(
                 g, dt, device, offs=[5, 131, 0], valid=[100, 64, 0],
                 c=128, pages_per_seq=4),
             run_prefill_paged),
            ("chunked_prefill_paged", f"{tag} C256 at offset 5", dtype,
             False,
             lambda g, dt: prefill_paged_case(
                 g, dt, device, offs=[5], valid=[256], c=256,
                 pages_per_seq=3),
             run_prefill_paged),
            # stop-the-world admission: one forward per wave of max_batch
            # misses, rows padded to the 512-token bucket
            ("flash_prefill", f"{tag} causal B4 S512", dtype, True,
             lambda g, dt: flash_case(g, dt, device, b=4, sq=512, skv=512,
                                      off=0),
             run_flash),
            ("flash_prefill", f"{tag} causal B1 S512", dtype, False,
             lambda g, dt: flash_case(g, dt, device, b=1, sq=512, skv=512,
                                      off=0),
             run_flash),
            ("flash_prefill", f"{tag} prefix q_offset 256", dtype, False,
             lambda g, dt: flash_case(g, dt, device, b=1, sq=128, skv=384,
                                      off=256),
             run_flash),
            ("flash_prefill", f"{tag} window 96 q_offset 200 B2", dtype,
             False,
             lambda g, dt: flash_case(g, dt, device, b=2, sq=100, skv=300,
                                      off=200, window=96),
             run_flash),
            ("flash_prefill", f"{tag} non-causal Dq 96 Dv 64", dtype, False,
             lambda g, dt: flash_case(g, dt, device, b=1, sq=70, skv=90,
                                      off=0, causal=False, d=96, dv=64),
             run_flash),
            # a ragged query tile and key tile on the diagonal
            ("flash_prefill", f"{tag} causal B1 Sq100 Skv100", dtype, False,
             lambda g, dt: flash_case(g, dt, device, b=1, sq=100, skv=100,
                                      off=0),
             run_flash),
            ("flash_prefill", f"{tag} causal B1 S256 D128", dtype, False,
             lambda g, dt: flash_case(g, dt, device, b=1, sq=256, skv=256,
                                      off=0, d=128, dv=128),
             run_flash),
            # mamba2-1.3b prefills one request at a time: a 347-369 token
            # prompt pads to 3 chunks of 128 (no initial state when cold,
            # a snapshot's state on a SkyMemory hit)
            ("ssd_chunk_scan", f"{tag} B1 L384 H64 P64 G1 N128 Q128", dtype,
             True,
             lambda g, dt: ssd_case(g, dt, device, b=1, l=384, chunk=128),
             run_ssd),
            ("ssd_chunk_scan", f"{tag} B1 L384 Q128, initial state", dtype,
             False,
             lambda g, dt: ssd_case(g, dt, device, b=1, l=384, chunk=128,
                                    with_init=True),
             run_ssd),
            ("ssd_chunk_scan", f"{tag} B4 L384 Q128, initial state", dtype,
             False,
             lambda g, dt: ssd_case(g, dt, device, b=4, l=384, chunk=128,
                                    with_init=True),
             run_ssd),
            ("ssd_chunk_scan", f"{tag} ragged single chunk L37 Q37", dtype,
             False,
             lambda g, dt: ssd_case(g, dt, device, b=1, l=37, chunk=37),
             run_ssd),
            ("ssd_chunk_scan", f"{tag} chunk 1, L3, initial state", dtype,
             False,
             lambda g, dt: ssd_case(g, dt, device, b=1, l=3, chunk=1,
                                    with_init=True),
             run_ssd),
            ("ssd_chunk_scan", f"{tag} G2 B2 L256 Q64, initial state",
             dtype, False,
             lambda g, dt: ssd_case(g, dt, device, b=2, l=256, chunk=64,
                                    g=2, with_init=True),
             run_ssd),
            # the CPU tests' narrow widths: P below 32 leaves state rows and
            # x columns of a block empty; N below 128 zero-fills the state
            # columns; P12 N20 takes the element-by-element copies
            ("ssd_chunk_scan", f"{tag} P8 N16 Q32 G2 H4 B2 L128, initial "
             f"state", dtype, False,
             lambda g, dt: ssd_case(g, dt, device, b=2, l=128, chunk=32, h=4,
                                    p=8, g=2, n=16, with_init=True),
             run_ssd),
            ("ssd_chunk_scan", f"{tag} P16 N32 Q64 H8 L64", dtype, False,
             lambda g, dt: ssd_case(g, dt, device, b=1, l=64, chunk=64, h=8,
                                    p=16, n=32),
             run_ssd),
            ("ssd_chunk_scan", f"{tag} P12 N20 Q40 G2 H4 L120, initial "
             f"state", dtype, False,
             lambda g, dt: ssd_case(g, dt, device, b=1, l=120, chunk=40, h=4,
                                    p=12, g=2, n=20, with_init=True),
             run_ssd),
        ]
    return cases


YARDSTICKS = {"paged_decode": sdpa_decode, "flash_prefill": sdpa_flash}


def phase_kernels(device, timer: Timer) -> dict:
    """Every kernel against its plain version; returns the main-path
    (bf16) record of each kernel."""
    gen = torch.Generator(device=device).manual_seed(0)
    records = {}
    for name, label, dtype, main, make, runner in kernel_cases(device):
        args, n_bytes, flops = make(gen, dtype)
        kern, plain = runner(args)
        want = plain()
        got = kern()
        if isinstance(want, tuple):
            # the SSD scan: y, then its f32 final state at its own limit
            err, worst = _check(f"{name} [{label}] y", name, got[0], want[0])
            s_err, s_worst = _check(f"{name} [{label}] final state", name,
                                    got[1], want[1], tol=SSD_STATE_TOL)
            log(f"[kernel] {name} [{label}]: final state max_abs_err "
                f"{s_err:.3e} ({s_worst:.2f} x limit)")
            err, worst = max(err, s_err), max(worst, s_worst)
        else:
            err, worst = _check(f"{name} [{label}]", name, got, want)
        ms = timer.ms(kern)
        plain_ms = timer.ms(plain)
        bms, by = bound_ms(n_bytes, flops, dtype)
        lib = YARDSTICKS.get(name, lambda a: None)(args)
        lib_ms = None
        if lib is not None:
            # the yardstick must compute the same function to be one; a
            # library may round differently (TF32 inside an f32 call), so
            # it is held at the bf16 limit, far below a wrong mask's error
            _check(f"{name} [{label}] yardstick", name, lib(), want,
                   tol=BF16_TOL[name])
            lib_ms = timer.ms(lib)
        body = body_of(name, args)
        log(f"[kernel] {name} [{label}] body {body}: max_abs_err {err:.3e} "
            f"({worst:.2f} x limit)  ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
            f"bound_ms {bms:.5f} ({by})  "
            f"library_ms {'null' if lib_ms is None else f'{lib_ms:.4f}'}")
        if main and dtype == torch.bfloat16:
            records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by,
                                 library_ms=lib_ms, shape=label, body=body)
    log("[kernel] library_ms is null for the block-table decode cases and "
        "for chunked_prefill_paged: no single PyTorch call computes "
        "attention through block tables with per-row lengths and offsets "
        "(the gather would be a second call); and for ssd_chunk_scan: no "
        "PyTorch call computes the SSD chunked scan")
    return records


# ---------------------------------------------------------------------------
# phase 4: the model on the card against the CPU
# ---------------------------------------------------------------------------

def _close(name: str, got: torch.Tensor, want: torch.Tensor,
           pair: str = "card vs CPU") -> float:
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs()
    lim = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * want.abs()
    if not torch.isfinite(got).all() or bool((err > lim).any()):
        raise AssertionError(f"{name}: {pair} max abs err "
                             f"{err.max().item():.3e}")
    log(f"[model] {name}: {pair} max abs err {err.max().item():.3e}")
    return err.max().item()


def phase_model(cfg, device, *, seed=0, prompt_len=200, page=128,
                max_seq_len=512) -> None:
    from repro_torch.models.model import Model

    gpu = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, prompt_len)))
    lg_g, _ = gpu.forward(toks.to(device))
    lg_c, _ = cpu.forward(toks)
    _close("forward", lg_g, lg_c)

    for contiguous in (True, False):
        mode = "contiguous" if contiguous else "free-list"
        runs = ((gpu, device), (cpu, torch.device("cpu")))
        pools = []
        for m, _ in runs:
            cache = m.init_paged_cache(
                num_slots=2, page_size=page, max_seq_len=max_seq_len,
                num_pages=None if contiguous
                else 1 + 2 * (max_seq_len // page))
            cache.ensure_capacity(0, prompt_len + 4)
            cache.ensure_capacity(1, prompt_len + 4)
            pools.append(cache)
        bt = torch.from_numpy(pools[1].block_tables.copy())
        valid = [prompt_len, prompt_len - 70]
        buf = torch.zeros(2, 256, dtype=torch.int32)
        for i, n in enumerate(valid):
            buf[i, :n] = toks[i, :n].to(torch.int32)
        offs = torch.zeros(2, dtype=torch.int32)
        nv = torch.tensor(valid, dtype=torch.int32)
        out = [m.prefill_chunk_paged(p.k_pool, p.v_pool, buf.to(dev),
                                     bt.to(dev), offs.to(dev), nv.to(dev))
               for (m, dev), p in zip(runs, pools)]
        _close(f"prefill_chunk_paged ({mode})", out[0], out[1])
        # three decode steps, both devices fed the CPU's greedy tokens
        nxt = torch.argmax(out[1], dim=-1).to(torch.int32)
        lens = nv.clone()
        for step in range(3):
            out = [m.decode_step_paged(
                       p.k_pool, p.v_pool, nxt[:, None].to(dev),
                       None if contiguous else bt.to(dev), lens.to(dev),
                       contiguous=contiguous)[:, 0]
                   for (m, dev), p in zip(runs, pools)]
            _close(f"decode_step_paged {step} ({mode})", out[0], out[1])
            nxt = torch.argmax(out[1], dim=-1).to(torch.int32)
            lens = lens + 1


def phase_ssm_model(cfg, device, *, seed=0, length=384, split=256,
                    steps=8) -> None:
    """mamba2 on the card against the CPU, a resume from a snapshot
    against the uninterrupted forward, and the decode recurrence against
    the chunked scan (the reference's
    ``test_ssd_scan_equals_sequential_recurrence``, through the model)."""
    from repro_torch.models.model import Model

    gpu = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, length)))
    lg_g, st_g = gpu.forward(toks.to(device), collect_state=True)
    lg_c, st_c = cpu.forward(toks, collect_state=True)
    _close("mamba2 forward", lg_g, lg_c)
    _close("mamba2 forward final state", st_g["ssm"]["state"],
           st_c["ssm"]["state"])

    _, snap = gpu.forward(toks[:, :split].to(device), collect_state=True)
    lg_r, st_r = gpu.forward(toks[:, split:].to(device), q_offset=split,
                             prefix_state=snap, collect_state=True)
    same = "on the card"
    _close(f"mamba2 resume from the snapshot at {split} vs uninterrupted",
           lg_r, lg_g[:, split:], same)
    _close("mamba2 resumed final state vs uninterrupted",
           st_r["ssm"]["state"], st_g["ssm"]["state"], same)

    cache = gpu.init_cache(2)
    cache["ssm"]["conv"].copy_(snap["ssm"]["conv"])
    cache["ssm"]["state"].copy_(snap["ssm"]["state"])
    for i in range(steps):
        lg = gpu.decode_step(cache, toks[:, split + i: split + i + 1]
                             .to(device))
        _close(f"mamba2 decode_step {i} vs prefill logits", lg[:, 0],
               lg_g[:, split + i], same)


# ---------------------------------------------------------------------------
# phase 5: serve full TinyLlama, then full mamba2-1.3b
# ---------------------------------------------------------------------------

PREFIX = ("SkyMemory caches transformer KV blocks on a LEO constellation; "
          "each 128-token block is striped across satellites in chunks, "
          "and a prefix hit restores the block into the engine's pages. ")


def make_requests(n: int = 8, max_new: int = 32):
    from repro_torch.serving import Request, SamplingParams

    prefix = (PREFIX * 3)[:255]          # + BOS = a 256-token prefix
    sp = SamplingParams(max_new_tokens=max_new)
    reqs = []
    for i in range(n):
        suffix = f" Question {i}: which satellite holds chunk {7 * i + 3} " \
                 f"of block {i}, and how many hops away is it? " + "ok " * (2 + i)
        reqs.append(Request(prompt=prefix + suffix, sampling=sp))
    return reqs


KERNELS = ("paged_decode", "chunked_prefill_paged", "flash_prefill",
           "ssd_chunk_scan")


def kernel_fns():
    from repro_torch.kernels.chunked_prefill import (
        chunked_prefill_paged,
        flash_prefill,
    )
    from repro_torch.kernels.paged_attention import paged_decode
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan

    return {"paged_decode": paged_decode,
            "chunked_prefill_paged": chunked_prefill_paged,
            "flash_prefill": flash_prefill,
            "ssd_chunk_scan": ssd_chunk_scan}


def zero_launches() -> dict:
    fns = kernel_fns()
    for f in fns.values():
        f.launches = 0
    return fns


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_mode(model, label: str, *, device, n_requests, max_new, **kw):
    from repro_torch.serving import Engine

    eng = Engine(model, device=device, **kw)
    row, res = run_pass(eng, label, n_requests=n_requests, max_new=max_new)
    return row, [r.token_ids for r in res], eng


def run_pass(eng, label: str, *, n_requests, max_new, tag="serve",
             stream=False):
    """Serve ``make_requests(n_requests, max_new)`` once on ``eng`` with
    fresh stats; check every stream; return the row and the results.
    ``stream`` drives the streaming front door instead of ``generate``:
    every request is submitted, then the worker thread starts and
    ``stop(drain=True)`` waits for it to finish them."""
    from repro_torch.serving import EngineStats

    fns = kernel_fns()
    before = {k: f.launches for k, f in fns.items()}
    eng.stats = EngineStats()
    reqs = make_requests(n_requests, max_new)
    sync(eng.device)
    t0 = time.perf_counter()
    if stream:
        futs = [eng.submit(r) for r in reqs]
        eng.start()
        eng.stop(drain=True)
        res = [f.result(timeout=0) for f in futs]
    else:
        res = eng.generate(reqs)
    sync(eng.device)
    wall = time.perf_counter() - t0
    s = eng.stats
    if len(res) != len(reqs):
        raise AssertionError(f"{label}: {len(res)} of {len(reqs)} finished")
    for r in res:
        if not (len(r.token_ids) == max_new or r.finish_reason == "eos"):
            raise AssertionError(f"{label}: request {r.request_id} stopped "
                                 f"at {len(r.token_ids)} tokens "
                                 f"({r.finish_reason})")
        if not all(0 <= t < eng.cfg.vocab_size for t in r.token_ids):
            raise AssertionError(f"{label}: token id out of range")
    pct = s.latency_percentiles()
    launches = {k: f.launches - before[k] for k, f in fns.items()}
    row = dict(mode=label, requests=len(res), wall_s=wall,
               decoded_tokens=s.decoded_tokens,
               tokens_per_s=s.decoded_tokens / wall,
               decode_steps=s.decode_steps,
               decode_step_tokens_per_s=s.decoded_tokens / s.decode_time_s,
               ttft_p50_s=pct["ttft_s"]["p50"], itl_p50_s=pct["itl_s"]["p50"],
               prefill_chunks=s.prefill_chunks, preemptions=s.preemptions,
               restores=s.restores, prompt_tokens=res[0].prompt_tokens,
               cached_tokens=s.cached_tokens,
               prefilled_tokens=s.prefilled_tokens,
               l2_wait_s=s.l2_wait_s, l2_fetch_waits=s.l2_fetch_waits,
               ttft_s=[r.ttft_s for r in res],
               # the first wave (as many requests as slots) waits on no
               # other request's decode: its TTFT is its own admission
               ttft_wave1_p50_s=statistics.median(
                   r.ttft_s for r in res[:eng.max_batch]),
               launches=launches)
    log(f"[{tag}] {json.dumps(row)}")
    return row, res


def _busy_ms(prof) -> float | None:
    """Union of the device intervals (kernels, copies, sets) in a
    ``torch.profiler`` trace, in ms; None if the trace holds none."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _top_kernels(prof, iters: int, k: int = 6) -> list:
    """The ``k`` device activities with the most time in a trace, as
    ``[name, ms per step, launches per step]``."""
    tot, cnt = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot[e.name] = tot.get(e.name, 0.0) + (e.time_range.end
                                                 - e.time_range.start)
            cnt[e.name] = cnt.get(e.name, 0) + 1
    top = sorted(tot, key=tot.get, reverse=True)[:k]
    return [[n[:80], tot[n] / 1e3 / iters, cnt[n] / iters] for n in top]


def graph_replay_ms(fn, what: str, *, iters: int = 20,
                    groups: int = 5) -> float:
    """Device ms of ``fn`` captured once in a CUDA graph: the median of
    ``groups`` groups of ``iters`` replays back to back (warm L2, no host
    launch gaps), after ``iters`` untimed replays; ``fn`` has run outside
    capture before.  Its output must be finite."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(iters):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{what} replayed from a graph: non-finite")
    return statistics.median(times)


def time_step(step, device, *, iters=20, repeats=5) -> dict:
    """Where one decode step's time goes: the eager step's host wall time
    (``repeats`` runs of ``iters`` steps: the host clock is noisy), the
    device's busy time in a CUPTI trace (``torch.profiler``) of ``iters``
    eager steps and the idle share it leaves, and the same step replayed
    from a CUDA graph (its device time without host launch gaps)."""
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream(device).wait_stream(side)
    eager = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) / iters * 1e3)
    eager_ms = statistics.median(eager)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / iters * 1e3
    busy = _busy_ms(prof)
    busy_ms = None if busy is None else busy / iters

    graph_ms = graph_replay_ms(step, "decode step", iters=iters)
    if busy_ms is None:
        log("[step] the profiler trace holds no device events: device busy "
            "time and idle share not measured")
    return dict(eager_step_ms=eager_ms, eager_step_ms_runs=eager,
                traced_step_ms=traced_ms, traced_device_busy_ms=busy_ms,
                # idle share of the traced steps, and of the untraced
                # median step if the device works as long there (the
                # tracer slows the host, not the device)
                traced_idle_share=(None if busy_ms is None
                                   else 1.0 - busy_ms / traced_ms),
                eager_idle_share=(None if busy_ms is None
                                  else 1.0 - busy_ms / eager_ms),
                graph_step_ms=graph_ms,
                top_device_kernels=_top_kernels(prof, iters))


def step_breakdown(model, device, *, batch=4, length=384, max_seq_len=1024,
                   page=128) -> dict:
    """TinyLlama's paged decode step at the serving shape (``time_step``),
    and the attention kernel's share of the graph-replayed step (22
    launches per step).  Runs after the main path's launch counts were
    read."""
    from repro_torch.kernels.paged_attention import paged_decode

    cache = model.init_paged_cache(num_slots=batch, page_size=page,
                                   max_seq_len=max_seq_len)
    gen = torch.Generator(device=device).manual_seed(1)
    cache.k_pool.normal_(generator=gen)
    cache.v_pool.normal_(generator=gen)
    toks = torch.randint(3, model.cfg.vocab_size, (batch, 1), device=device,
                         generator=gen, dtype=torch.int32)
    lens = torch.full((batch,), length, dtype=torch.int32, device=device)
    row = dict(batch=batch, length=length, **time_step(
        lambda: model.decode_step_paged(cache.k_pool, cache.v_pool, toks,
                                        None, lens, contiguous=True),
        device))
    shape = (batch, max_seq_len // page, page, model.cfg.num_kv_heads,
             model.cfg.head_dim)
    q = torch.randn(batch, model.cfg.num_heads, model.cfg.head_dim,
                    device=device, generator=gen).to(cache.k_pool.dtype)
    k, v = cache.k_pool[0].reshape(shape), cache.v_pool[0].reshape(shape)
    attn_ms = Timer(device).ms(lambda: paged_decode(q, k, v, lens + 1))
    row.update(paged_decode_ms=attn_ms,
               attention_share_of_graph_step=model.cfg.num_layers * attn_ms
               / row["graph_step_ms"])
    log(f"[step] {json.dumps(row)}")
    return row


def prefill_wave(model, device, *, rows=4, chunk=256, context=384,
                 max_seq_len=1024, page=128):
    """One chunked-prefill wave of the full model over the contiguous
    pool: ``rows`` rows of ``chunk`` tokens, each ending a
    ``context``-token prefix.  Returns the wave (``prefill_chunk_paged``)
    and the paged prefill kernel's call at the wave's shape, both ready
    to time."""
    from repro_torch.kernels.chunked_prefill import chunked_prefill_paged

    cfg = model.cfg
    cache = model.init_paged_cache(num_slots=rows, page_size=page,
                                   max_seq_len=max_seq_len)
    for slot in range(rows):
        cache.ensure_capacity(slot, context)
    gen = torch.Generator(device=device).manual_seed(2)
    cache.k_pool.normal_(generator=gen)
    cache.v_pool.normal_(generator=gen)
    bt = torch.from_numpy(cache.block_tables.copy()).to(device)
    toks = torch.randint(3, cfg.vocab_size, (rows, chunk), device=device,
                         generator=gen, dtype=torch.int32)
    offs = torch.full((rows,), context - chunk, dtype=torch.int32,
                      device=device)
    n_valid = torch.full((rows,), chunk, dtype=torch.int32, device=device)

    q = torch.randn(rows, chunk, cfg.num_heads, cfg.head_dim, device=device,
                    generator=gen).to(cache.k_pool.dtype)

    def wave():
        return model.prefill_chunk_paged(cache.k_pool, cache.v_pool, toks,
                                         bt, offs, n_valid)

    def attention():
        return chunked_prefill_paged(q, cache.k_pool[0], cache.v_pool[0],
                                     offs + n_valid, bt, offs)

    for _ in range(2):
        wave()
    return wave, attention


def wave_breakdown(model, device, *, rows=4, **kw) -> dict:
    """``prefill_wave`` replayed from a CUDA graph, and the paged prefill
    kernel's share of it: one launch per layer, timed alone at the wave's
    shape with a cold L2.  Runs after the main path's launch counts were
    read."""
    from repro_torch.kernels.chunked_prefill import prefill_body
    from repro_torch.models.layers import torch_dtype

    cfg = model.cfg
    wave, attention = prefill_wave(model, device, rows=rows, **kw)
    wave_ms = graph_replay_ms(wave, "chunked-prefill wave")
    k3_ms = Timer(device).ms(attention)
    row = dict(rows=rows, **kw,
               body=prefill_body(torch_dtype(cfg.dtype), cfg.head_dim,
                                 cfg.head_dim),
               graph_wave_ms=wave_ms, chunked_prefill_paged_ms=k3_ms,
               chunked_prefill_paged_share_of_graph_wave=(
                   cfg.num_layers * k3_ms / wave_ms))
    log(f"[wave] {json.dumps(row)}")
    return row


def ssm_step_breakdown(model, device, *, batch=4) -> dict:
    """mamba2's dense decode step at the serving batch (``time_step``)
    over a cache of random states.  The step runs no hand-written kernel:
    the single-token recurrence is plain PyTorch, as in the reference.
    Runs after the main path's launch counts were read."""
    gen = torch.Generator(device=device).manual_seed(1)
    cache = model.init_cache(batch)
    cache["ssm"]["conv"].normal_(generator=gen)
    cache["ssm"]["state"].normal_(generator=gen)
    toks = torch.randint(3, model.cfg.vocab_size, (batch, 1), device=device,
                         generator=gen, dtype=torch.int32)
    row = dict(model=model.cfg.name, batch=batch,
               **time_step(lambda: model.decode_step(cache, toks), device))
    log(f"[step] {json.dumps(row)}")
    return row


def ssm_prefill(model, device, *, length=384):
    """One mamba2 request's prefill: ``Model.forward`` over ``length``
    tokens with the state collected, as ``DenseRuntime._prefill_one``
    calls it, and the SSD scan's call at the prefill's shape (the kernel
    case's inputs).  Returns both, ready to time, and the scan's chunk."""
    from repro_torch.models.layers import torch_dtype

    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(3)
    toks = torch.randint(3, cfg.vocab_size, (1, length), device=device,
                         generator=gen, dtype=torch.int32)

    def prefill():
        return model.forward(toks, collect_state=True)[0]

    chunk = min(cfg.ssm_chunk, length)
    args, _, _ = ssd_case(gen, torch_dtype(cfg.dtype), device, b=1,
                          l=-(-length // chunk) * chunk, chunk=chunk,
                          h=cfg.ssm_heads, p=cfg.ssm_head_dim,
                          g=cfg.ssm_groups, n=cfg.ssm_state)
    prefill()
    return prefill, run_ssd(args)[0], chunk


def ssm_prefill_breakdown(model, device, *, length=384) -> dict:
    """``ssm_prefill``: its eager host wall time, the forward replayed
    from a CUDA graph, and the SSD scan's share of the replay (one launch
    per layer, timed alone at the prefill's shape with a cold L2).  Runs
    after the main path's launch counts were read."""
    from repro_torch.kernels.ssd_scan import ssd_body
    from repro_torch.models.layers import torch_dtype

    cfg = model.cfg
    prefill, scan, chunk = ssm_prefill(model, device, length=length)
    eager = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) * 1e3)
    graph_ms = graph_replay_ms(prefill, "mamba2 prefill", iters=5)
    scan_ms = Timer(device).ms(scan)
    row = dict(model=cfg.name, tokens=length, chunk=chunk,
               body=ssd_body(torch_dtype(cfg.dtype)),
               eager_prefill_ms=statistics.median(eager),
               eager_prefill_ms_runs=eager, graph_prefill_ms=graph_ms,
               ssd_chunk_scan_ms=scan_ms,
               ssd_chunk_scan_share_of_graph_prefill=(
                   cfg.num_layers * scan_ms / graph_ms))
    log(f"[prefill] {json.dumps(row)}")
    return row


def phase_serve(cfg, device, *, seed=0, n_requests=8, max_new=32,
                max_seq_len=1024, max_batch=4, free_list_pages=10,
                block_size=128) -> dict:
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    model = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.dtype}, init {time.perf_counter() - t0:.1f} s")
    common = dict(device=device, n_requests=n_requests, max_new=max_new,
                  max_seq_len=max_seq_len, max_batch=max_batch,
                  block_size=block_size)
    # warm-up (library loads, allocator, cuBLAS handles); not counted
    serve_mode(model, "warm-up", **{**common, "n_requests": 2})

    fns = zero_launches()
    rows, streams = [], {}
    for label, kw in (("chunked-contiguous", {}),
                      ("stop-the-world", {"chunk_tokens": 0}),
                      ("free-list-preempt", {"num_pages": free_list_pages})):
        row, toks, eng = serve_mode(model, label, **common, **kw)
        rows.append(row)
        streams[label] = toks
    counts = {k: f.launches for k, f in fns.items()}
    log(f"[serve] launches over the three modes: {counts}")

    if rows[2]["preemptions"] <= 0:
        raise AssertionError("free-list mode did not preempt")
    _require_launched(counts, ("paged_decode", "chunked_prefill_paged",
                               "flash_prefill"))
    from repro_torch.kernels.chunked_prefill import prefill_body
    from repro_torch.models.layers import torch_dtype

    body = prefill_body(torch_dtype(cfg.dtype), cfg.head_dim, cfg.head_dim)
    log(f"[serve] {cfg.name}'s prefills ran the {body} body "
        f"({cfg.dtype}, head_dim {cfg.head_dim})")
    base = streams["chunked-contiguous"]
    for label, toks in streams.items():
        same = sum(a == b for a, b in zip(base, toks))
        log(f"[serve] {label}: {same}/{len(base)} token streams equal to "
            "chunked-contiguous (bf16: batch composition may round "
            "differently)")
    step_breakdown(model, device, max_seq_len=max_seq_len, page=block_size,
                   batch=max_batch)
    wave_breakdown(model, device, rows=max_batch, chunk=256, context=384,
                   max_seq_len=max_seq_len, page=block_size)
    return counts, model


def _require_launched(counts: dict, path: tuple) -> None:
    missing = [k for k in path if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")


def phase_ssm_serve(cfg, device, *, seed=0, n_requests=8, max_new=32,
                    max_seq_len=1024, max_batch=4) -> dict:
    """Full mamba2-1.3b behind ``Engine``, which serves it through the
    dense runtime: each request prefills alone (one SSD scan per layer),
    then the batch decodes over the stacked state cache."""
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    model = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.dtype}, init {time.perf_counter() - t0:.1f} s")
    common = dict(device=device, n_requests=n_requests, max_new=max_new,
                  max_seq_len=max_seq_len, max_batch=max_batch)
    serve_mode(model, f"{cfg.name} warm-up", **{**common, "n_requests": 2})

    fns = zero_launches()
    serve_mode(model, f"{cfg.name} dense runtime", **common)
    counts = {k: f.launches for k, f in fns.items()}
    log(f"[serve] {cfg.name} launches: {counts} ({cfg.num_layers} "
        f"ssd_chunk_scan per prefill, {n_requests} prefills)")
    _require_launched(counts, ("ssd_chunk_scan",))
    ssm_step_breakdown(model, device, batch=max_batch)
    ssm_prefill_breakdown(model, device)
    return counts, model


# ---------------------------------------------------------------------------
# phase 6: prefix hits served from the port's constellation
# ---------------------------------------------------------------------------

def paper_kvc(*, clocked: bool = False):
    """The paper's §5 fabric, as ``benchmarks/run.py`` builds it: the 19x5
    constellation at 550 km, a 5x5 LOS window, 10 servers placed
    rotation+hop, 6 kB chunks.  ``clocked`` puts the transport on a
    ``SimClock``, so the engine waits out each Get's modeled flight."""
    from repro_torch.core import (
        ConstellationKVC,
        ConstellationSpec,
        IslTransport,
        LosWindow,
        Sat,
        SimClock,
        Strategy,
    )

    spec = ConstellationSpec(5, 19, 550.0)
    transport = IslTransport(spec, clock=SimClock()) if clocked else None
    return ConstellationKVC(spec, LosWindow(Sat(2, 9), 5, 5),
                            Strategy.ROTATION_HOP, num_servers=10,
                            chunk_bytes=6 * 1024, transport=transport)


def fill_and_hit(model, label: str, kvc, *, n_requests, max_new, **kw):
    """Serve the requests twice on ``Engine(model, kvc=kvc)``: pass 1
    writes back (``kvc_fn``'s forward on the adapter's worker thread for
    the paged engine, while the main thread decodes), pass 2 (write-back
    off, fresh fabric counters) is the warm pass.  Returns its row, its
    results, the engine, and the launch counts zeroed just before pass 2
    and read just after.  The forward that computes the write-back
    payloads must have launched the dense prefill (attention) or the
    SSD scan in pass 1."""
    from repro_torch.core import CacheStats, TransportStats
    from repro_torch.serving import Engine

    eng = Engine(model, kvc=kvc, **kw)
    fns = zero_launches()
    run_pass(eng, f"{label} pass 1 (write-back)", n_requests=n_requests,
             max_new=max_new, tag="fabric")
    if eng.paged:
        eng.kv.drain_write_back()        # every block registered
    counts = {k: f.launches for k, f in fns.items()}
    log(f"[fabric] {label} pass-1 launches (write-back included): {counts}")
    _require_launched(counts, ("flash_prefill",) if eng.paged
                      else ("ssd_chunk_scan",))
    eng.write_back = False
    kvc.stats, kvc.transport.stats = CacheStats(), TransportStats()
    fns = zero_launches()
    row, res = run_pass(eng, f"{label} pass 2 (warm)", n_requests=n_requests,
                        max_new=max_new, tag="fabric")
    counts = {k: f.launches for k, f in fns.items()}
    return row, res, eng, counts


def fabric_report(label: str, kvc) -> dict:
    """The warm pass's fabric counters: hits, messages, bytes, and the
    modeled Get flight (the transport's latency model, not a time
    measured on the card)."""
    cs, ts = kvc.stats, kvc.transport.stats
    pct = ts.latency_percentiles()
    row = dict(model=label, block_hits=cs.block_hits,
               block_misses=cs.block_misses, lookup_probes=cs.lookup_probes,
               messages=ts.messages, bytes_moved=ts.bytes_moved,
               bytes_raw=ts.bytes_raw, get_ops=ts.ops,
               modeled_get_flight_p50_s=pct["p50"],
               modeled_get_flight_max_s=ts.max_latency_s)
    log(f"[fabric] {json.dumps(row)}")
    return row


def _f32(a) -> torch.Tensor:
    """A decoded payload array (a bf16 tensor or a numpy array) in f32."""
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.from_numpy(np.asarray(a, np.float32))


def check_fabric_bytes(label: str, eng, kvc, *, n_requests, max_new) -> None:
    """Every block the manager registered, read back through
    ``get_block``, equals a fresh ``kvc_fn`` on the card for the same
    tokens: block 0 from scratch, block i resumed from block i-1's bytes
    as the write-back did.  Also times one Set and one Get of the block
    on a scratch fabric (host time; the flight is only modeled), and one
    decode of its payload to arrays (the dequantize, under a quantized
    codec)."""
    from repro_torch.core import (
        chain_hashes,
        decode_payload_arrays,
        num_chunks,
    )

    bs = eng.block_size
    registered = set(eng.manager._hash_to_chain)
    tokens = {}
    for r in make_requests(n_requests, max_new):
        toks = eng.tokenizer.encode(r.prompt)
        for i, h in enumerate(chain_hashes(toks, bs)):
            tokens.setdefault(h, (i, toks[:(i + 1) * bs]))
    if not registered or not registered <= set(tokens):
        raise AssertionError(f"{label}: registered blocks {len(registered)} "
                             "are not blocks of the requests")
    checked, past = 0, {}
    for h, (i, toks) in sorted(tokens.items(), key=lambda kv: kv[1][0]):
        if h not in registered:
            continue
        got = kvc.get_block(h)
        prev = None if i == 0 else past[tuple(toks[:i * bs])]
        want = eng.adapter.kvc_fn(toks, prev, i * bs)
        sync(eng.device)
        if got != want:
            diff = [float((_f32(a) - _f32(b)).abs().max())
                    for a, b in zip(decode_payload_arrays(got),
                                    decode_payload_arrays(want))]
            raise AssertionError(
                f"{label}: block {i} bytes differ from a fresh kvc_fn "
                f"({len(got)} vs {len(want)} bytes, max abs diff {diff})")
        past[tuple(toks)] = got
        checked += 1
        scratch = paper_kvc()
        t0 = time.perf_counter()
        scratch.set_block(h, got)
        t_set = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = scratch.get_block(h)
        t_get = time.perf_counter() - t0
        if back != got:
            raise AssertionError(f"{label}: scratch Set/Get changed block {i}")
        t0 = time.perf_counter()
        decode_payload_arrays(got)
        t_decode = time.perf_counter() - t0
        row = dict(model=label, block=i, tokens=len(toks),
                   payload_bytes=len(got),
                   chunks=num_chunks(len(got), kvc.chunk_bytes),
                   host_set_ms=t_set * 1e3, host_get_ms=t_get * 1e3,
                   host_decode_ms=t_decode * 1e3)
        log(f"[fabric] {json.dumps(row)}")
    log(f"[fabric] {label}: {checked} registered blocks equal a fresh "
        "kvc_fn on the card")


def resume_drift(model, eng, kvc, *, n_requests, max_new) -> dict:
    """A prefill resumed from the fabric's snapshot against the full
    prefill, both in bf16, for every request: the last position's logits
    and the final conv and SSM states must be bitwise equal (the scan
    runs every prefill at the configured chunk, so the suffix's chunks
    are the full prefill's last ones).  Both are also measured against
    the full prefill of an f32 copy of the same weights; greedy
    agreement with it is counted, not asserted (random weights leave
    near-tied logits)."""
    from repro_torch.core import chain_hashes
    from repro_torch.models.model import Model

    f32 = Model(model.cfg.replace(dtype="float32"), device=model.device)
    f32.load_state_dict(model.state_dict())
    bs = eng.block_size
    err = {k: [] for k in ("full", "resumed", "resumed_vs_full",
                           "state_full", "state_resumed")}
    agree = dict(full=0, resumed=0, both=0)
    bitwise = dict(logits=0, conv=0, state=0)   # resumed == full
    for r in make_requests(n_requests, max_new):
        toks = eng.tokenizer.encode(r.prompt)
        n = (len(toks) - 1) // bs * bs        # the engine's lookup
        h = chain_hashes(toks, bs)[n // bs - 1]
        prefix = eng.adapter.payload_to_state(kvc.get_block(h))
        t = torch.as_tensor(toks, dtype=torch.int32, device=model.device)[None]
        with torch.no_grad():
            lg, st = model.forward(t, collect_state=True)
            lr, sr = model.forward(t[:, n:], q_offset=n, prefix_state=prefix,
                                   collect_state=True)
            lw, sw = f32.forward(t, collect_state=True)
        full, resumed, want = lg[0, -1].float(), lr[0, -1].float(), lw[0, -1]
        for k, a, b in (("full", full, want), ("resumed", resumed, want),
                        ("resumed_vs_full", resumed, full),
                        ("state_full", st["ssm"]["state"],
                         sw["ssm"]["state"]),
                        ("state_resumed", sr["ssm"]["state"],
                         sw["ssm"]["state"])):
            err[k].append(float((a.float() - b.float()).abs().max()))
        bitwise["logits"] += bool(torch.equal(lr[0, -1], lg[0, -1]))
        for k in ("conv", "state"):
            bitwise[k] += bool(torch.equal(sr["ssm"][k], st["ssm"][k]))
        top = int(want.argmax())
        agree["full"] += int(full.argmax()) == top
        agree["resumed"] += int(resumed.argmax()) == top
        agree["both"] += int(full.argmax()) == int(resumed.argmax())
    del f32
    row = dict(model=model.cfg.name, requests=n_requests,
               f32_logit_max_abs=float(want.abs().max()),
               f32_state_max_abs=float(sw["ssm"]["state"].abs().max()),
               **{f"{k}_max_abs_err": max(v) for k, v in err.items()},
               argmax_equal=agree, bitwise_equal_resumed_vs_full=bitwise)
    log(f"[fabric] resume drift (bf16 vs an f32 copy) {json.dumps(row)}")
    unequal = {k: v for k, v in bitwise.items() if v != n_requests}
    if unequal:
        raise AssertionError(f"{model.cfg.name}: a resumed prefill is not "
                             f"bitwise the full one ({unequal} of "
                             f"{n_requests} equal)")
    return row


def warm_vs_cold(name: str, warm: dict, cold: dict, **extra) -> dict:
    out = dict(model=name, **extra)
    for k in ("ttft_p50_s", "ttft_wave1_p50_s", "itl_p50_s",
              "tokens_per_s"):
        out[f"{k}_cold"], out[f"{k}_warm"] = cold[k], warm[k]
    out.update(l2_wait_s=warm["l2_wait_s"],
               l2_fetch_waits=warm["l2_fetch_waits"])
    return out


def _require_warm(label: str, row: dict, res, cold: dict, counts: dict,
                  path: tuple, prefix: int) -> None:
    short = [r.cached_tokens for r in res if r.cached_tokens != prefix]
    if short:
        raise AssertionError(f"{label}: warm requests restored {short} "
                             f"tokens, not {prefix}")
    if not row["prefilled_tokens"] < cold["prefilled_tokens"]:
        raise AssertionError(f"{label}: warm pass prefilled "
                             f"{row['prefilled_tokens']} tokens, the "
                             f"kvc=None engine {cold['prefilled_tokens']}")
    _require_launched(counts, path)


def phase_fabric(tiny, mamba, device, *, n_requests=8, max_new=32,
                 block_size=128, max_seq_len=1024, max_batch=4,
                 prefix=256) -> dict:
    """Full TinyLlama and full mamba2-1.3b served from the port's
    constellation; returns each model's warm-pass launch counts."""
    from repro_torch.serving import Engine

    common = dict(n_requests=n_requests, max_new=max_new)
    kw = dict(block_size=block_size, max_seq_len=max_seq_len,
              max_batch=max_batch, device=device)
    out = {}
    for model, path in ((tiny, ("chunked_prefill_paged", "paged_decode")),
                        (mamba, ("ssd_chunk_scan",))):
        name = model.cfg.name
        cold_eng = Engine(model, **kw)
        cold, cold_res = run_pass(cold_eng, f"{name} kvc=None",
                                  tag="fabric", **common)
        _, again = run_pass(cold_eng, f"{name} kvc=None again",
                            tag="fabric", **common)
        del cold_eng
        kvc = paper_kvc()
        row, res, eng, counts = fill_and_hit(model, name, kvc, **common,
                                             **kw)
        log(f"[fabric] {name} warm-pass launches: {counts}")
        report = fabric_report(name, kvc)
        if report["block_hits"] <= 0:
            raise AssertionError(f"{name}: the warm pass hit no block")
        _require_warm(name, row, res, cold, counts, path, prefix)
        same = sum(a.token_ids == b.token_ids for a, b in zip(res, cold_res))
        cold_same = sum(a.token_ids == b.token_ids
                        for a, b in zip(again, cold_res))
        first_diff = [next((i for i, (x, y) in enumerate(
            zip(a.token_ids, b.token_ids)) if x != y), None)
            for a, b in zip(res, cold_res)]
        log(f"[fabric] {name}: {same}/{len(res)} warm greedy streams equal "
            f"the kvc=None streams (first differing token {first_diff}); "
            f"{cold_same}/{len(res)} of a second kvc=None pass do")
        log(f"[fabric] {json.dumps(warm_vs_cold(name, row, cold))}")
        check_fabric_bytes(name, eng, kvc, **common)
        if not eng.paged:
            resume_drift(model, eng, kvc, **common)
        out[name] = counts
        if eng.paged:
            # the same warm pass on a clocked fabric: the engine waits
            # out (or hides behind decode) each Get's modeled flight
            row, res, eng, counts = fill_and_hit(
                model, f"{name} clocked", paper_kvc(clocked=True), **common,
                **kw)
            _require_warm(f"{name} clocked", row, res, cold, counts, path,
                          prefix)
            row = warm_vs_cold(name, row, cold, clocked=True)
            log(f"[fabric] {json.dumps(row)}")
        del eng
    return out


# ---------------------------------------------------------------------------
# phase 7: scale-out serving -- two replicas on one card, one constellation
# ---------------------------------------------------------------------------

SUSTAINED_FILLER = ("SkyMemory serves an open request stream from orbit: "
                    "arrivals route at arrival time, loads release per "
                    "request, and overload sheds the lowest priority first. ")


def cluster_kvc(*, chaos: bool = False):
    """The fabric of ``benchmarks/run.py``'s two cluster scenarios: a
    15x15 constellation at 550 km, a 9x9 LOS window at (7, 7), 10 servers
    placed rotation+hop, 6 kB chunks, a transport on a ``SimClock`` at 5x
    with 0.2 ms per chunk.  ``chaos`` adds the chaos scenario's pieces
    at k=2: two data and two directory copies, a 5 ms probe timeout and
    a write-through ground tier."""
    from repro_torch.core import (
        ConstellationKVC,
        ConstellationSpec,
        GroundStationTier,
        IslTransport,
        LosWindow,
        Sat,
        SimClock,
        Strategy,
    )

    spec = ConstellationSpec(15, 15, 550.0)
    kw = {}
    tkw = {}
    if chaos:
        kw = dict(replication=2, dir_replication=2,
                  ground=GroundStationTier(spec, processing_time_s=1e-3),
                  ground_write="all")
        tkw = dict(probe_timeout_s=5e-3)
    return ConstellationKVC(
        spec, LosWindow(Sat(7, 7), 9, 9), Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=6 * 1024,
        transport=IslTransport(spec, clock=SimClock(rate=5.0),
                               chunk_processing_time_s=2e-4, **tkw), **kw)


def drain_write_backs(cluster) -> None:
    """Wait until every write-back the replicas queued has landed (the
    shared ``kvc_fn`` forward included)."""
    for eng in cluster.engines:
        eng.kv.drain_write_back()


def build_cluster(model, device, *, num_replicas=2, policy="prefix_affinity",
                  chaos=False, block_size=128, **kw):
    """``num_replicas`` replicas of ``model`` over one fresh
    ``cluster_kvc`` (anchored by ``spread_anchors``, so one replica sits
    where replica 0 of two does), int8 payloads, rotation every 2
    virtual seconds, each replica warmed by one short request, its
    write-back drained, stats reset (the scenarios' ``build``)."""
    from repro_torch.serving import EngineCluster, Request, SamplingParams

    cluster = EngineCluster(
        model, cluster_kvc(chaos=chaos), num_replicas=num_replicas,
        policy=policy, router_seed=0, block_size=block_size,
        max_seq_len=512, max_batch=4, rotate_every_s=2.0,
        payload_codec="int8", device=device, **kw)
    for i, eng in enumerate(cluster.engines):
        eng.generate([Request(prompt=f"[warm {i}] " + SUSTAINED_FILLER,
                              sampling=SamplingParams(max_new_tokens=2))])
    drain_write_backs(cluster)
    cluster.reset_stats()
    return cluster


def counted(run) -> tuple:
    """``run()`` as one main-path run: every launch count is zeroed just
    before it and read just after.  Returns its value and the counts."""
    fns = zero_launches()
    out = run()
    return out, {k: f.launches for k, f in fns.items()}


def add_counts(total: dict, counts: dict) -> None:
    for k in KERNELS:
        total[k] += counts[k]


def cluster_pass(cluster, label: str, *, n_requests, max_new) -> tuple:
    """One closed batch through ``cluster.serve`` (replica threads) with
    fresh serving and fabric counters (the router keeps its affinity
    memory); every request must finish with in-range tokens.  The row's
    ``launches`` are counted from 0 over the batch and the write-backs
    it queued."""
    from repro_torch.core import CacheStats, TransportStats
    from repro_torch.serving import EngineStats

    reqs = make_requests(n_requests, max_new)
    for eng in cluster.engines:
        eng.stats = EngineStats()
    for view in cluster.views:
        view.stats, view.transport.stats = CacheStats(), TransportStats()
    dev = cluster.engines[0].device
    sync(dev)
    fns = zero_launches()
    t0 = time.perf_counter()
    res = cluster.serve(reqs, parallel=True)
    sync(dev)
    wall = time.perf_counter() - t0
    drain_write_backs(cluster)
    sync(dev)
    launches = {k: f.launches for k, f in fns.items()}
    vocab = cluster.engines[0].cfg.vocab_size
    for r in res:
        if r is None or not (len(r.token_ids) == max_new
                             or r.finish_reason == "eos"):
            raise AssertionError(f"{label}: a request did not finish")
        if not all(0 <= t < vocab for t in r.token_ids):
            raise AssertionError(f"{label}: token id out of range")
    m = cluster.merged_stats()
    pct = m.latency_percentiles()
    fab = cluster.fabric_stats()
    per_replica = [s["requests"] for s in cluster.replica_stats()]
    row = dict(mode=label, requests=len(res), wall_s=wall,
               decoded_tokens=m.decoded_tokens,
               tokens_per_s=m.decoded_tokens / wall,
               ttft_p50_s=pct["ttft_s"]["p50"], itl_p50_s=pct["itl_s"]["p50"],
               cached_tokens=m.cached_tokens,
               prefilled_tokens=m.prefilled_tokens,
               requests_per_replica=per_replica,
               routes=[d.replica for d in cluster.decisions],
               block_hits=fab["block_hits"],
               block_misses=fab["block_misses"],
               bytes_encoded=fab["bytes_encoded"], bytes_raw=fab["bytes_raw"],
               l2_wait_s=fab["l2_wait_s"], rotations=fab["rotations"],
               launches=launches)
    log(f"[cluster] {json.dumps(row)}")
    return row, res


def _fingerprint(report) -> tuple:
    """(route decisions, shed set, token streams) of a stream report."""
    routes = [r.decision.replica if r.decision else None
              for r in report.records]
    shed = [i for i, r in enumerate(report.records) if r.shed]
    toks = [tuple(r.result.token_ids) if r.result else None
            for r in report.records]
    return routes, shed, toks


def _probe_rate(cluster, requests, overload: float, rate_rps: float):
    """The scenarios' calibration: submit ``requests``, count the
    ``_pump_all`` rounds that drain them, and size the pump budget per
    virtual second so arrivals outpace service by ``overload``."""
    for r in requests:
        cluster.submit(r)
    rounds = 0
    t0 = time.perf_counter()
    while cluster._pump_all():
        rounds += 1
    wall = time.perf_counter() - t0
    drain_write_backs(cluster)
    rounds = max(rounds, 1)
    per_round = len(requests) / rounds
    return rate_rps / (per_round * overload), wall / rounds, rounds


def _stream_row(label: str, report, **extra) -> dict:
    s = report.slo
    row = dict(run=label, offered=s["offered"], shed=s["shed"],
               completed=s["completed"], attained=s["attained"],
               attainment=s["attainment"], elapsed_s=report.elapsed_s,
               goodput_tokens_per_s=s["goodput_tokens_per_s"],
               tokens_per_s=s["tokens_per_s"], itl_tail_s=s["itl_tail_s"],
               rotations=report.rotations,
               per_tenant={k: {kk: v[kk] for kk in (
                   "offered", "shed", "completed", "attainment")}
                   for k, v in s["per_tenant"].items()}, **extra)
    log(f"[cluster] {json.dumps(row)}")
    return row


def peak_admission(capacity_tokens: int):
    """``AdmissionController(capacity_tokens, protect_priority=1)`` that
    also keeps the highest router load it was asked to admit at, and
    counts the protected arrivals it let in at or above capacity (each
    one the protection kept from being shed)."""
    import dataclasses

    from repro_torch.serving import AdmissionController

    @dataclasses.dataclass
    class PeakAdmission(AdmissionController):
        peak_load_tokens: int = dataclasses.field(default=0, init=False)
        protected_over_capacity: int = dataclasses.field(default=0,
                                                         init=False)

        def admit(self, priority: int, load_tokens: int) -> bool:
            self.peak_load_tokens = max(self.peak_load_tokens, load_tokens)
            if (priority >= self.protect_priority
                    and load_tokens >= self.capacity_tokens):
                self.protected_over_capacity += 1
            return super().admit(priority, load_tokens)

    return PeakAdmission(capacity_tokens=capacity_tokens, protect_priority=1)


def _require_protected(label: str, report) -> None:
    pro = report.slo["per_tenant"]["pro"]
    if pro["shed"] or pro["completed"] != pro["offered"]:
        raise AssertionError(f"{label}: the protected tenant lost requests "
                             f"({pro})")


def sustained_stream(model, device) -> tuple:
    """``benchmarks/run.py``'s ``sustained_load`` at its full sizes: 48
    seeded arrivals of three tenants, deterministic pump-budget mode,
    admission capacity 600 with ``pro`` protected; run twice on fresh
    builds.  Returns each replica's request count and the launches of
    the two ``serve_stream`` runs, each counted from 0."""
    from repro_torch.serving import (
        SLO,
        Request,
        SamplingParams,
        TenantSpec,
        TrafficGenerator,
    )

    mnt = (8, 24, 12)
    tenants = [
        TenantSpec(name="pro", rate_rps=0.25, process="poisson", priority=1,
                   max_new_tokens=mnt[0], prompt_chars=(48, 96)),
        TenantSpec(name="burst", rate_rps=0.5, process="bursty",
                   burst_size=4, burst_spread_s=0.05, prefix_reuse_p=0.6,
                   num_documents=3, max_new_tokens=mnt[1],
                   prompt_chars=(48, 96)),
        TenantSpec(name="diurnal", rate_rps=0.25, process="diurnal",
                   diurnal_period_s=8.0, max_new_tokens=mnt[2],
                   prompt_chars=(48, 96)),
    ]
    arrivals = TrafficGenerator(tenants, seed=0).take(48)
    probe = build_cluster(model, device)
    pump, step_wall, rounds = _probe_rate(
        probe, [Request(prompt=f"[probe {i}] " + SUSTAINED_FILLER,
                        sampling=SamplingParams(max_new_tokens=mnt[i % 3]))
                for i in range(8)],
        1.2, sum(t.rate_rps for t in tenants))
    del probe
    slos = {t.name: SLO(ttft_s=max(1.0, 8.0 * step_wall)) for t in tenants}
    log(f"[cluster] sustained: probe {rounds} rounds, {step_wall:.4f} s per "
        f"round, pump budget {pump:.4f} rounds per virtual s, TTFT SLO "
        f"{slos['pro'].ttft_s:.3f} s")
    runs, served = [], [0, 0]
    total = dict.fromkeys(KERNELS, 0)
    for i in range(2):
        cluster = build_cluster(model, device)
        admission = peak_admission(600)
        report, counts = counted(lambda: cluster.serve_stream(
            arrivals, parallel=False, slos=slos, admission=admission,
            pump_steps_per_s=pump))
        add_counts(total, counts)
        _require_protected(f"sustained run {i}", report)
        for r in report.records:
            if r.decision is not None:
                served[r.decision.replica] += 1
        _stream_row(f"sustained run {i}", report,
                    capacity_tokens=admission.capacity_tokens,
                    peak_load_tokens=admission.peak_load_tokens,
                    protected_over_capacity=admission.protected_over_capacity,
                    fabric_block_hits=cluster.fabric_stats()["block_hits"],
                    launches=counts)
        runs.append(_fingerprint(report))
        del cluster
    (routes_a, shed_a, toks_a), (routes_b, shed_b, toks_b) = runs
    if routes_a != routes_b or shed_a != shed_b:
        raise AssertionError("sustained: two runs on fresh builds routed or "
                             "shed differently")
    same = sum(a == b for a, b in zip(toks_a, toks_b) if a is not None)
    log(f"[cluster] sustained: routes and shed set equal over two runs "
        f"({len(shed_a)} shed); {same}/{sum(t is not None for t in toks_a)} "
        "token streams equal (not asserted: the card's decode need not be "
        "bitwise reproducible)")
    return served, total


def chaos_stream(model, device) -> tuple:
    """``benchmarks/run.py``'s ``chaos_sustained_load`` with k=2: 96
    arrivals of ``standard_tenants(4, 4.0)`` at seed 11, a fault arc of
    two survivable kills, two link cuts, a directory-stripe wipeout and
    a replica-home-pair kill over a write-through ground tier, 64-token
    blocks, free-list pools of 25 pages.  Returns each replica's request
    count and the launches of the ``serve_stream`` run, counted from 0."""
    import dataclasses

    from repro_torch.core import FaultPlan
    from repro_torch.serving import (
        Request,
        TrafficGenerator,
        standard_tenants,
    )

    kw = dict(chaos=True, block_size=64, num_pages=25)
    tenants = standard_tenants(4, 4.0, max_new_tokens=4,
                               prompt_chars=(48, 96), prefix_reuse_p=0.5)
    tenants[0] = dataclasses.replace(tenants[0], prefix_reuse_p=0.9,
                                     num_documents=2, doc_chars=320)
    arrivals = TrafficGenerator(tenants, seed=11).take(96)
    window_s = arrivals[-1].t_s / 8 * (1.0 + 1e-9)
    probe = build_cluster(model, device, **kw)
    pump, _, rounds = _probe_rate(
        probe, [Request(prompt=a.request.prompt, sampling=a.request.sampling,
                        priority=a.request.priority, tenant=a.request.tenant)
                for a in arrivals[:8]],
        1.2, sum(t.rate_rps for t in tenants))
    del probe
    cluster = build_cluster(model, device, **kw)
    plan = FaultPlan.chaos_arc(
        cluster.kvc, seed=29, churn_start_s=4.0 * window_s,
        churn_window_s=window_s, heal_s=6.0 * window_s, n_sat_kills=2,
        n_link_cuts=2, dir_stripe_wipeout=True, ground_pair_server=4)
    admission = peak_admission(3900)
    report, counts = counted(lambda: cluster.serve_stream(
        arrivals, parallel=False, admission=admission,
        pump_steps_per_s=pump, faults=plan, slo_window_s=window_s))
    _require_protected("chaos", report)
    applied = sum(report.faults[k] for k in (
        "sat_kills", "sat_heals", "link_kills", "link_heals"))
    if applied <= 0:
        raise AssertionError("chaos: the injector applied no event")
    served = [0, 0]
    for r in report.records:
        if r.decision is not None:
            served[r.decision.replica] += 1
    _stream_row("chaos k=2", report, probe_rounds=rounds,
                pump_steps_per_s=pump,
                capacity_tokens=admission.capacity_tokens,
                peak_load_tokens=admission.peak_load_tokens,
                protected_over_capacity=admission.protected_over_capacity,
                launches=counts, faults=report.faults,
                phases={k: {kk: v[kk] for kk in ("offered", "shed",
                                                 "attained_tokens")}
                        for k, v in report.slo["phases"].items()},
                ground_fall_throughs=report.faults["ground_hits"],
                fabric_ground_hits=cluster.fabric_stats()["ground_hits"])
    return served, counts


def int8_snapshots(model, device, *, n_requests=8, max_new=32,
                   prefix=256) -> dict:
    """One engine alone on the paper's 19x5 fabric with int8 payloads,
    driven through ``submit`` / ``start`` / ``stop(drain=True)``: a pass
    that writes back, then a warm pass in which every request must
    restore the 256-token prefix, beside a ``kvc=None`` engine's cold
    pass through the same front door.  Prints the int8 block's bytes
    and chunks, host Set / Get / decode ms, and warm against cold TTFT.
    Returns the launches of the three passes, each counted from 0 (the
    write-back's ``kvc_fn`` forwards included)."""
    from repro_torch.core import CacheStats, TransportStats
    from repro_torch.serving import Engine

    name = model.cfg.name
    kw = dict(block_size=128, max_seq_len=1024, max_batch=4, device=device)
    common = dict(n_requests=n_requests, max_new=max_new)
    total = dict.fromkeys(KERNELS, 0)
    (cold, cold_res), counts = counted(lambda: run_pass(
        Engine(model, **kw), f"{name} kvc=None", tag="cluster", stream=True,
        **common))
    add_counts(total, counts)
    kvc = paper_kvc()
    eng = Engine(model, kvc=kvc, payload_codec="int8", **kw)

    def write_back():
        run_pass(eng, f"{name} int8 write-back", tag="cluster", stream=True,
                 **common)
        if eng.paged:
            eng.kv.drain_write_back()
        sync(eng.device)

    _, counts = counted(write_back)
    add_counts(total, counts)
    eng.write_back = False
    kvc.stats, kvc.transport.stats = CacheStats(), TransportStats()
    (warm, res), counts = counted(lambda: run_pass(
        eng, f"{name} int8 warm", tag="cluster", stream=True, **common))
    add_counts(total, counts)
    path = (("chunked_prefill_paged", "paged_decode") if eng.paged
            else ("ssd_chunk_scan",))
    _require_warm(f"{name} int8", warm, res, cold, counts, path, prefix)
    same = sum(a.token_ids == b.token_ids for a, b in zip(res, cold_res))
    row = warm_vs_cold(name, warm, cold, codec="int8",
                       streams_equal_to_cold=same,
                       block_hits=kvc.stats.block_hits,
                       bytes_moved=kvc.transport.stats.bytes_moved)
    log(f"[cluster] {json.dumps(row)}")
    check_fabric_bytes(f"{name} int8", eng, kvc, **common)
    return total


def phase_cluster(tiny, mamba, device, *, n_requests=8, max_new=32) -> dict:
    """Two full TinyLlama replicas on one card over one clocked int8
    constellation: a closed batch (prefix affinity twice, then one pass
    under the random router and one on a single replica), the sustained
    stream, the chaos arc; then int8 snapshots on one engine per model
    through the streaming worker.  Returns the launch counts summed over
    the phase's main-path runs, each counted from 0; the warm-ups, the
    pump-rate probes and the byte checks are left out."""
    t_phase = time.perf_counter()
    common = dict(n_requests=n_requests, max_new=max_new)
    total = dict.fromkeys(KERNELS, 0)
    served = [0, 0]
    t0 = time.perf_counter()
    cluster = build_cluster(tiny, device)
    rows, closed = [], dict.fromkeys(KERNELS, 0)
    for p in (1, 2):
        row, _ = cluster_pass(cluster, f"prefix_affinity pass {p}", **common)
        rows.append(row)
        add_counts(closed, row["launches"])
        served = [a + b for a, b in zip(served, row["requests_per_replica"])]
    del cluster
    if rows[1]["block_hits"] <= 0:
        raise AssertionError("cluster: the second pass hit no block")
    _require_launched(closed, ("paged_decode", "chunked_prefill_paged",
                               "flash_prefill"))
    log(f"[cluster] closed batch launches: {closed}")
    # affinity pass 1 beside the same first pass on a fresh build under
    # the random router, and on one replica at replica 0's anchor (the
    # same fabric hop costs): each starts on an empty fabric
    for label, kw in (("random pass 1", dict(policy="random")),
                      ("one replica pass 1", dict(num_replicas=1))):
        cluster = build_cluster(tiny, device, **kw)
        row, _ = cluster_pass(cluster, label, **common)
        rows.append(row)
        add_counts(closed, row["launches"])
        if cluster.num_replicas == 2:
            served = [a + b
                      for a, b in zip(served, row["requests_per_replica"])]
        del cluster
    add_counts(total, closed)
    for row in rows:
        log(f"[cluster] closed batch {row['mode']}: "
            f"{row['tokens_per_s']:.2f} tokens/s, l2_wait_s "
            f"{row['l2_wait_s']:.3f}, requests per replica "
            f"{row['requests_per_replica']}")
    log(f"[phase] cluster closed batch {time.perf_counter() - t0:.1f} s")
    for label, run in (("sustained", sustained_stream),
                       ("chaos", chaos_stream)):
        t0 = time.perf_counter()
        per_replica, counts = run(tiny, device)
        add_counts(total, counts)
        served = [a + b for a, b in zip(served, per_replica)]
        log(f"[phase] cluster {label} {time.perf_counter() - t0:.1f} s")
    if min(served) <= 0:
        raise AssertionError(f"cluster: a replica served no request over the "
                             f"phase ({served})")
    log(f"[cluster] requests per replica over the phase: {served}")
    t0 = time.perf_counter()
    for model in (tiny, mamba):
        add_counts(total, int8_snapshots(model, device, **common))
    log(f"[phase] cluster int8 snapshots {time.perf_counter() - t0:.1f} s")
    _require_launched(total, KERNELS)
    log(f"[cluster] main-path launches: {total}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    name, smi = phase_device()

    t0 = time.perf_counter()
    phase_build()
    log(f"[phase] build {time.perf_counter() - t0:.1f} s")

    from repro_torch.configs import get_config

    device = torch.device("cuda", 0)
    timer = Timer(device)
    t0 = time.perf_counter()
    records = phase_kernels(device, timer)
    log(f"[phase] kernels {time.perf_counter() - t0:.1f} s")

    tiny = get_config("skymemory-tinyllama")
    mamba = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    phase_model(tiny.replace(num_layers=2, dtype="float32"), device)
    phase_ssm_model(mamba.replace(num_layers=2, dtype="float32"), device)
    log(f"[phase] model {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    counts, tiny_model = phase_serve(tiny, device)
    log(f"[phase] serve {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ssm_counts, mamba_model = phase_ssm_serve(mamba, device)
    counts["ssd_chunk_scan"] = ssm_counts["ssd_chunk_scan"]
    log(f"[phase] serve {mamba.name} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fabric_counts = phase_fabric(tiny_model, mamba_model, device)
    log(f"[phase] fabric {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cluster_counts = phase_cluster(tiny_model, mamba_model, device)
    log(f"[phase] cluster {time.perf_counter() - t0:.1f} s")
    # launches over every phase's main-path runs, each counted from 0
    for phase in (*fabric_counts.values(), cluster_counts):
        for k in KERNELS:
            counts[k] += phase[k]

    meta = {
        "paged_decode": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                         "src/repro/kernels/paged_attention.py:24,66"),
        "chunked_prefill_paged": (
            "src/repro_torch/kernels/csrc/chunked_prefill.cu",
            "src/repro/kernels/chunked_prefill.py:142"),
        "flash_prefill": ("src/repro_torch/kernels/csrc/chunked_prefill.cu",
                          "src/repro/kernels/chunked_prefill.py:28"),
        "ssd_chunk_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                           "src/repro/kernels/ssd_scan.py:24"),
    }
    kernels = []
    for k in KERNELS:
        r = records[k]
        kernels.append({
            "name": k, "route": "cuda", "source": meta[k][0],
            "replaces": meta[k][1], "launches": counts[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "body": r["body"]})
    log(f"[phase] total {time.perf_counter() - t_all:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
