#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SkyMemory on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, compute capability (9, 0);
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes (TinyLlama, bf16 and f32) and at edge cases,
   with its time, the plain version's time, its bound and, for the dense
   prefill and the contiguous decode pool,
   ``scaled_dot_product_attention``'s time as a yardstick only;
4. model: TinyLlama's widths at 2 layers, f32, seeded: ``forward``,
   ``prefill_chunk_paged`` and ``decode_step_paged`` logits on the card
   against the same on the CPU;
5. serve: full TinyLlama (22 layers, bf16, seeded random weights) behind
   the paged ``Engine``: 8 requests with a shared 256-token prefix in
   three modes (chunked contiguous pool, stop-the-world admission, a
   free-list pool small enough to preempt).  Launch counters are zeroed
   just before and read just after; every kernel must have launched.
   Then a decode step's breakdown: eager host wall time, device busy
   time in a ``torch.profiler`` trace, and the CUDA-graph-replayed step.

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
            "flash_prefill": dict(atol=1.2e-2, rtol=1e-2)}
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
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(logs)} libraries in {dt:.2f} s -> {_build.BUILD_DIR}")


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


def phase_kernels(device, timer: Timer) -> dict:
    """Every kernel against its plain version; returns the main-path
    (bf16) record of each kernel."""
    gen = torch.Generator(device=device).manual_seed(0)
    records = {}
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
        ]
    yardsticks = {"paged_decode": sdpa_decode, "flash_prefill": sdpa_flash}
    for name, label, dtype, main, make, runner in cases:
        args, n_bytes, flops = make(gen, dtype)
        kern, plain = runner(args)
        want = plain()
        err, worst = _check(f"{name} [{label}]", name, kern(), want)
        ms = timer.ms(kern)
        plain_ms = timer.ms(plain)
        bms, by = bound_ms(n_bytes, flops, dtype)
        lib = yardsticks.get(name, lambda a: None)(args)
        lib_ms = None
        if lib is not None:
            # the yardstick must compute the same function to be one; a
            # library may round differently (TF32 inside an f32 call), so
            # it is held at the bf16 limit, far below a wrong mask's error
            _check(f"{name} [{label}] yardstick", name, lib(), want,
                   tol=BF16_TOL[name])
            lib_ms = timer.ms(lib)
        log(f"[kernel] {name} [{label}]: max_abs_err {err:.3e} "
            f"({worst:.2f} x limit)  ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
            f"bound_ms {bms:.5f} ({by})  "
            f"library_ms {'null' if lib_ms is None else f'{lib_ms:.4f}'}")
        if main and dtype == torch.bfloat16:
            records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by,
                                 library_ms=lib_ms, shape=label)
    log("[kernel] library_ms is null for the block-table decode cases and "
        "for chunked_prefill_paged: no single PyTorch call computes "
        "attention through block tables with per-row lengths and offsets "
        "(the gather would be a second call)")
    return records


# ---------------------------------------------------------------------------
# phase 4: the model on the card against the CPU
# ---------------------------------------------------------------------------

def _close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs()
    lim = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * want.abs()
    if not torch.isfinite(got).all() or bool((err > lim).any()):
        raise AssertionError(f"{name}: card vs CPU max abs err "
                             f"{err.max().item():.3e}")
    log(f"[model] {name}: card vs CPU max abs err {err.max().item():.3e}")
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


# ---------------------------------------------------------------------------
# phase 5: serve full TinyLlama
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


KERNELS = ("paged_decode", "chunked_prefill_paged", "flash_prefill")


def kernel_fns():
    from repro_torch.kernels.chunked_prefill import (
        chunked_prefill_paged,
        flash_prefill,
    )
    from repro_torch.kernels.paged_attention import paged_decode

    return {"paged_decode": paged_decode,
            "chunked_prefill_paged": chunked_prefill_paged,
            "flash_prefill": flash_prefill}


def serve_mode(model, label: str, *, device, n_requests, max_new, **kw):
    from repro_torch.serving import Engine

    fns = kernel_fns()
    before = {k: f.launches for k, f in fns.items()}
    eng = Engine(model, device=device, **kw)
    reqs = make_requests(n_requests, max_new)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.stats
    if len(res) != len(reqs):
        raise AssertionError(f"{label}: {len(res)} of {len(reqs)} finished")
    for r in res:
        if not (len(r.token_ids) == max_new or r.finish_reason == "eos"):
            raise AssertionError(f"{label}: request {r.request_id} stopped "
                                 f"at {len(r.token_ids)} tokens "
                                 f"({r.finish_reason})")
        if not all(0 <= t < model.cfg.vocab_size for t in r.token_ids):
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
               launches=launches)
    log(f"[serve] {json.dumps(row)}")
    return row, [r.token_ids for r in res], eng


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


def step_breakdown(model, device, *, batch=4, length=384, max_seq_len=1024,
                   page=128, iters=20, repeats=5) -> dict:
    """Where a decode step's time goes at the serving shape: the eager
    step's host wall time (``repeats`` runs of ``iters`` steps: the host
    clock is noisy), the device's busy time in a CUPTI trace
    (``torch.profiler``) of ``iters`` eager steps and the idle share it
    leaves, the same step replayed from a CUDA graph (its device time
    without host launch gaps), and the attention kernel's share (22
    launches per step).  Runs after the main path's launch counts were
    read."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.paged_attention import paged_decode

    cache = model.init_paged_cache(num_slots=batch, page_size=page,
                                   max_seq_len=max_seq_len)
    gen = torch.Generator(device=device).manual_seed(1)
    cache.k_pool.normal_(generator=gen)
    cache.v_pool.normal_(generator=gen)
    toks = torch.randint(3, model.cfg.vocab_size, (batch, 1), device=device,
                         generator=gen, dtype=torch.int32)
    lens = torch.full((batch,), length, dtype=torch.int32, device=device)

    def step():
        return model.decode_step_paged(cache.k_pool, cache.v_pool, toks,
                                       None, lens, contiguous=True)

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

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        graph.replay()
    b.record()
    b.synchronize()
    graph_ms = a.elapsed_time(b) / iters
    if not torch.isfinite(out.float()).all():
        raise AssertionError("decode step replayed from a graph: non-finite")

    shape = (batch, max_seq_len // page, page, model.cfg.num_kv_heads,
             model.cfg.head_dim)
    q = torch.randn(batch, model.cfg.num_heads, model.cfg.head_dim,
                    device=device, generator=gen).to(cache.k_pool.dtype)
    k, v = cache.k_pool[0].reshape(shape), cache.v_pool[0].reshape(shape)
    attn_ms = Timer(device).ms(lambda: paged_decode(q, k, v, lens + 1))
    row = dict(batch=batch, length=length, eager_step_ms=eager_ms,
               eager_step_ms_runs=eager,
               traced_step_ms=traced_ms, traced_device_busy_ms=busy_ms,
               # idle share of the traced steps, and of the untraced median
               # step if the device works as long there (the tracer slows
               # the host, not the device)
               traced_idle_share=(None if busy_ms is None
                                  else 1.0 - busy_ms / traced_ms),
               eager_idle_share=(None if busy_ms is None
                                 else 1.0 - busy_ms / eager_ms),
               graph_step_ms=graph_ms, paged_decode_ms=attn_ms,
               attention_share_of_graph_step=model.cfg.num_layers * attn_ms
               / graph_ms)
    if busy_ms is None:
        log("[step] the profiler trace holds no device events: device busy "
            "time and idle share not measured")
    log(f"[step] {json.dumps(row)}")
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

    fns = kernel_fns()
    for f in fns.values():
        f.launches = 0
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
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    base = streams["chunked-contiguous"]
    for label, toks in streams.items():
        same = sum(a == b for a, b in zip(base, toks))
        log(f"[serve] {label}: {same}/{len(base)} token streams equal to "
            "chunked-contiguous (bf16: batch composition may round "
            "differently)")
    step_breakdown(model, device, max_seq_len=max_seq_len, page=block_size,
                   batch=max_batch)
    return counts


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
    t0 = time.perf_counter()
    phase_model(tiny.replace(num_layers=2, dtype="float32"), device)
    log(f"[phase] model {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    counts = phase_serve(tiny, device)
    log(f"[phase] serve {time.perf_counter() - t0:.1f} s")

    meta = {
        "paged_decode": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                         "src/repro/kernels/paged_attention.py:24,66"),
        "chunked_prefill_paged": (
            "src/repro_torch/kernels/csrc/chunked_prefill.cu",
            "src/repro/kernels/chunked_prefill.py:142"),
        "flash_prefill": ("src/repro_torch/kernels/csrc/chunked_prefill.cu",
                          "src/repro/kernels/chunked_prefill.py:28"),
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
            "shape": r["shape"]})
    log(f"[phase] total {time.perf_counter() - t_all:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
