#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SkyMemory on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, compute capability (9, 0);
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card
   (for a bf16 case, the plain version evaluated in f32 on the same
   inputs; the bf16 plain version's own distance from it prints beside),
   at the main paths' shapes (TinyLlama's attention, mamba2-1.3b's SSD
   scan; bf16 and f32) and at edge cases, each on inputs drawn from a
   generator seeded by its name and label, with its time, the plain
   version's time, its bound and, for the dense prefill and the
   contiguous decode pool, ``scaled_dot_product_attention``'s time as a
   yardstick only.  Each case's line names the body it ran: the
   prefills run bf16 with head dim 64, 128, 160 or 192 on tensor cores
   (``tensor-core``), the SSD scan runs bf16 on tensor cores, and
   everything else runs on f32 FMAs (``fma``).  Five bf16 cases hold
   the other paged families' head shapes: the dense and paged prefills
   at stablelm-12b's H32 / Hkv8 / D 160 and nemotron-4-340b's H96 /
   Hkv8 / D 192 (each must run ``tensor-core``), and the decode kernel
   at D 160; nemotron's dense prefill on three more draws.
   zamba2-1.2b's shapes, at rep 1 (H = Hkv = 32), bf16 and f32: the
   decode over a 1024-token dense cache (8 pages), over a full 384-slot
   ring (3 pages), and over one page of 200 (a ring) and of 1000 tokens
   (caches whose length 128 does not divide), the cold prefill (S 369)
   and a warm suffix (Sq 113 over Skv 369 at q_offset 256; the bf16
   prefills must run ``tensor-core``), and the SSD scan at state 64.
   deepseek-v3's MLA prefill (H = Hkv = 128, Dq 192, Dv 128): bf16 at
   the longest cold prompt (S 369) and its warm suffix (Sq 113 over Skv
   369 at q_offset 256), each on ``prefill_tc<192, 128>`` (must run
   ``tensor-core``), the cold one also timed on the FMA body it ran
   before that instance existed; f32 on a short S.  The library call
   of an MLA case names the device kernels it ran.  seamless-m4t's
   shapes (H = Hkv = 16, D 64), bf16 and f32: the encoder's non-causal
   prefill at B4 x S512 and B4 x S500, cross-attention (non-causal,
   offset 0) of Sq 32 over Skv 500 and Sq 37 over Skv 512 (the bf16
   prefills must run ``tensor-core``), and the cross decode with every
   length the source length, over 4 pages of 128 and one page of 500.
   Then the dense prefill's training pair (``phase_backward``): the
   forward with its LSE (against ``torch.logsumexp`` of the plain f32
   scores) and ``flash_prefill_bwd`` (dq, dk, dv against
   ``attention_bwd_ref`` in f32 on the same inputs, twice, bitwise equal)
   at TinyLlama's training shape (B4 x S2048, H32, Hkv4, D64, causal) and
   at a ragged tail, an offset, a window, seamless's non-causal encoder
   and cross shapes, stablelm's D 160 and deepseek's MLA Dq 192 / Dv 128,
   bf16 (the tensor-core body) and f32, each with its time, the plain
   backward's, its bound, and forward + backward against
   ``scaled_dot_product_attention``'s; SDPA's forward alone and its
   backward alone (the yardstick of one direction), the port's forward
   with its LSE alone, its plain version and its bound; at the main case
   the backward's split into its launches from one CUPTI trace; the
   tensor-core body's tiling as the library reports it against
   ``tc_plan``, and the wgmma, mbarrier and TMA instructions of each of
   its kernels in the built library (``cuobjdump -sass``).  Then the SSD
   scan's backward (``phase_ssd_backward``): ``ssd_chunk_scan_bwd`` (dx,
   ddt, da, dB, dC, d_initial_state) against ``ssd_scan_bwd_ref`` in f32
   on the same inputs, twice, bitwise equal, at mamba2-1.3b's training
   shape (B4 L2048 H64 P64 G1 N128, chunk 128), with an initial state and
   a final-state cotangent, G2, one ragged chunk of 37, chunk 1, P12 N20
   Q40 G2 H4, zamba2's N 64 and a tail of dt = 0 rows (the padding),
   bf16 (the tensor-core body, wgmma) and f32 (3xTF32 mma.sync), each
   with its time beside the card's name and power limit, the plain
   backward's and its bound in bytes and in operations; at the main
   case of each body its split into launches (one CUPTI trace); the
   library's plan (shared memory, cluster size) against the host's, each
   kernel's ptxas registers, spills (none allowed) and dynamic shared
   memory, and its wgmma, mbarrier and TMA instruction counts;
4. model: TinyLlama's widths at 2 layers, f32, seeded: ``forward``,
   ``prefill_chunk_paged`` and ``decode_step_paged`` logits on the card
   against the same on the CPU.  Then mamba2-1.3b's widths at 2 layers,
   f32: ``forward`` logits and state on the card against the CPU, a
   resume from the snapshot at token 256 against the uninterrupted
   forward, and ``decode_step`` from that snapshot against the prefill
   logits of the same tokens.  Then stablelm-12b and
   granite-moe-3b-a800m at full width, 2 layers, f32, the same three
   checks on 120-token prompts; for granite every MoE layer's top-k
   routes are compared token by token first (``RouteCheck``: a route
   may differ only where the CPU's k-th and (k+1)-th probabilities are
   within 1e-5, and the logits are held on the rows whose routes agreed
   in every layer).  Last zamba2-1.2b's widths at 7 layers (one
   attention period of 6 SSD layers, the shared block, a 1-layer tail),
   f32: mamba2's three checks, with the shared block's K/V held beside
   the state and the decode steps over the dense K/V cache.  Then that
   zamba2 and a 2-layer TinyLlama with ``sliding_window=200``: a
   180-token prompt and 40 decode steps past the 200-slot ring's wrap,
   card against CPU.  Then TinyLlama's paged checks and its ring again
   over an int8 K/V pool (``kvc_dtype="int8"``): the logits at the same
   limits, and the int8 pools or rings after the steps within one
   quantization step card against CPU (the differing elements counted).
   Last deepseek-v3's MLA at full width, 2 layers (one dense, one MoE
   with its routed experts cut to 16, top-8 kept, at a capacity factor
   of 2 so that no expert drops a token), f32:
   ``forward`` logits (routes checked first, ``RouteCheck``) and the
   collected latents against the CPU, a resume from the latent prefix
   at token 256 against the uninterrupted forward, and 8 ``decode_step``s
   against the CPU.  Last seamless-m4t-large-v2 at full width, 2
   encoder and 2 decoder layers, f32, 256 frames and a 40-token target:
   the encoder output, ``forward`` logits with the self and cross K/V,
   and 8 ``decode_step``s against the CPU.  Last training at full width,
   f32 (``[train]`` lines): TinyLlama and mamba2-1.3b at 2 layers,
   zamba2-1.2b at 7 (one attention period, the shared block and the
   tail): ``train_loss`` and every gradient on ``SyntheticLM`` batches
   card against CPU, the same under ``remat="full"``, then 3 AdamW steps
   and the parameters after them; each backward kernel launches once per
   attention call or SSD layer and step (``train_launches``);
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
   kernel's share of it.  Then (``[int8]`` lines) the same weights over
   an int8 K/V page pool in the same three modes, counted from 0: K1
   (contiguous), K2 (block tables), K3 and K4 must launch, the
   free-list pool must preempt and restore every victim's int8 pages
   bitwise from the host tier with nothing replayed, the streams equal
   to the bf16 pool's are counted; its decode step prints beside the
   bf16 pool's, with the dequantize's and the quantize's shares of the
   traced device time; after mamba2-1.3b one 384-token prefill
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
   waits out those flights.  TinyLlama over an int8 K/V page pool runs
   the same cold and warm passes and checks, its hits quantized into
   the pool by ``write_pages``;
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
   worker's exception fails the run;
8. families: the other paged families at full width, bf16, seeded
   random weights, one model at a time, on the same 8 requests.  Full
   granite-moe-3b-a800m (32 layers, 40 experts top-8): stop-the-world
   admission (``eng.chunked`` is False), cold; twice through
   ``Engine(kvc=...)`` on the paper's 19x5 fabric, the second pass
   restoring 256 tokens for every request (paged prefill and paged
   decode launched); then a free-list pool small enough to preempt
   (block-table decode), with nothing replayed and every greedy stream
   equal to the cold engine's; then one decode step's breakdown.  Full
   stablelm-12b (40 layers, head_dim 160): chunked and stop-the-world
   admission, each prefill on the tensor-core body at D 160, then one
   decode step's breakdown;
9. hybrid (``[hybrid]`` lines): full zamba2-1.2b (38 SSD layers, the
   shared attention block after every 6th, bf16, seeded random weights)
   behind ``Engine``, which serves it through the dense runtime, on the
   same 8 requests: cold; twice through ``Engine(kvc=...)`` on the
   paper's 19x5 fabric (the second pass must restore 256 tokens of
   every request, every stored block must equal a fresh ``kvc_fn``, the
   warm streams must equal the cold ones, and a resumed prefill must be
   bitwise the full one); a ring pass with ``sliding_window=384`` and 40
   new tokens, so that every sequence decodes past the ring's wrap
   (each stream must equal the cold one up to the first token from a
   position at or past 384); then one decode step's breakdown (the
   paged-decode kernel's share) and one 384-token prefill replayed from
   a CUDA graph (the SSD scan's and the dense prefill's shares).  The
   SSD scan, the dense prefill and the paged decode must launch;
10. mla (``[mla]`` lines): deepseek-v3-671b at its published widths,
    cut to 4 layers (its 3 dense layers and one MoE layer of 256 experts
    top-8 and one shared; bf16, seeded random weights; the
    multi-token-prediction head is training-only: ``mtp_depth`` 0) behind
    ``Engine``, which serves MLA through the dense runtime, on the same 8
    requests: cold; twice through ``Engine(kvc=...)`` on the paper's 19x5
    fabric (the warm pass must restore 256 tokens of every request, every
    stored block must equal a fresh ``kvc_fn``, the warm prefill's last
    logits must lie within the bf16 limit of a prefill over latents
    computed on the card, and of the cold prefill's where the last token
    keeps the same experts; the warm streams equal to the cold ones are
    counted); then one decode step's breakdown against the bytes of the
    weights it reads, and one 384-token prefill replayed from a CUDA
    graph with the dense prefill's share.  The dense prefill must launch
    on the tensor-core body in both passes;
11. seamless (``[seamless]`` lines): full seamless-m4t-large-v2 (24
    encoder and 24 decoder layers, bf16, seeded random weights, 1.63 B
    parameters; no engine serves the family, as in the reference): 4
    utterances of 500 seeded frames and 32-token prompts through
    ``forward(frames=, collect_state=True)``, then 32 greedy
    ``decode_step``s over ``init_cache(4, 64, src_len=500)``.  The dense
    prefill must launch 72 times in the forward (24 encoder, 24 self, 24
    cross), the paged decode 48 times per step, nothing else; every
    step's logits are held to a teacher-forced ``forward`` at the bf16
    limit, the greedy tokens to its argmax except at near-ties (counted).
    Then the encoder alone replayed from a CUDA graph with the dense
    prefill's share, a decode step's breakdown against the bytes it
    reads with the paged decode's share, and the peak memory;
12. train (``[train]`` lines, ``TRAIN_RUNS``): full TinyLlama (22
    layers), then full mamba2-1.3b (48 SSD layers), each with bf16
    parameters, f32 AdamW moments and seeded random weights, trained 30
    steps through ``train()`` on ``SyntheticLM(vocab of the model, seq
    2048, batch 4, seed 0)`` (the batches drawn before the run and timed
    apart): the dense prefill and its backward must launch 22 times per
    step (TinyLlama), the SSD scan and its backward 48 (mamba2), nothing
    else, and ``ce`` must fall; step 0's gradients bitwise equal over two
    runs; a checkpoint round trip bitwise, with equal logits (TinyLlama's
    with its AdamW moments, mamba2-1.3b's of the parameters alone,
    ``CHECKPOINT_RUNS``); the median
    step, tokens/s, model FLOPs and their share of 989 TFLOP/s, K4's and
    K5's forward and backward shares of a traced step, and the peak
    memory with and without ``remat="full"``.  Then full zamba2-1.2b
    trains 10 steps: the SSD scan and its backward 38 times per step,
    the dense prefill and its backward 6, ``ce`` must fall, the median
    step printed.

13. what a user runs (``[launch]``, ``[sim]``, ``[torus]`` and
    ``[example]`` lines): ``repro_torch.launch.serve.main`` at its
    defaults (the card, the 19x5 fabric) for full TinyLlama (bf16) and
    full mamba2-1.3b, 3 rounds of 16 new tokens each: round 0 restores
    nothing, every later round whole 128-token blocks, and the fabric
    hits blocks; each round's wall time, TTFT and cached tokens print,
    and how many later rounds' tokens equal round 0's.  Then TinyLlama
    with ``--no-cache``: no round restores a token.  The ported
    simulator's Fig-16 sweep and Figs 1-2 grid on the host against the
    paper's claims (rotation+hop lowest everywhere, 80-95% less latency
    from 9 to 81 servers at 550 km, latency growing with altitude and
    falling with satellites a plane).  A one-rank NCCL process group over
    a ``FileStore``: one layer's paged K pool of TinyLlama laid out by
    ``kvc_sharding`` on a 1x1 mesh and shifted by ``migrate_shards``,
    which must give the pool back (the ring of one position).  Last
    ``examples/torch_serve_skymemory.py --full --requests 8 --max-new
    16`` in this process (two full TinyLlama replicas over one
    constellation), which must hit blocks; where the run has used so
    much of its time that the full width would not end by 1100 s, at the
    example's reduced default width, named on its line.
14. sharded training (``[mesh]`` lines): a ``(1, 1)`` ``("data",
    "model")`` ``DeviceMesh`` over the one-rank NCCL group phase 13
    started (kept open, so NCCL's set-up is paid once).  Full TinyLlama
    and full mamba2-1.3b (bf16 parameters, f32 moments, seeded weights,
    phase 12's ``SyntheticLM`` B4 x S2048 batches) each take
    ``MESH_STEPS`` AdamW steps through ``train()`` without rules, then
    from the same weights through ``train(..., rules=make_rules(...))``
    with ``zero1``: parameters, moments and batch are ``DTensor``s and
    the kernels run inside the layers' ``local_map``.  Every step's
    loss prints both ways; losses and every parameter after the last
    step must be bitwise equal or, where not, within the bf16 limit
    (``MESH_PARAM_TOL``) with the first place they part named (forward,
    gradients or update); the sharded run must launch the
    dense prefill and its backward 22 times a step (TinyLlama), the SSD
    scan and its backward 48 (mamba2), nothing else; the step ms of both
    print.  Then ``repro_torch.launch.train.main`` with ``--mesh --arch
    skymemory-tinyllama --tiny --steps 5`` and without ``--mesh``: the
    loss lines must be equal.
15. the sharded serve step (``[serve_mesh]`` lines), in the same group on
    a ``(1, 1)`` mesh, seeded weights and caches drawn on the card: each
    of (a) full TinyLlama at ``decode_32k`` (global batch cut from 128 to
    16: 128 rows of 32,768 tokens need ~94 GB of K/V), positions
    30,000-32,700; (b) full TinyLlama at ``long_500k`` (``shape_variant``'s
    32,768-slot ring, batch 1, positions from 524,286: the steps write
    slots 32,766, 32,767, 0 and 1); (c) full mamba2-1.3b at
    ``decode_32k``'s batch 128 (a 12.9 GB f32 state, heads over
    ``model``) takes ``SERVE_MESH_STEPS`` greedy steps through
    ``make_plan(...).fn`` over a cache laid out by ``cache_specs`` and
    through the unsharded ``Model.decode_step`` on a copy: logits bitwise
    or within the bf16 limit (``SERVE_MESH_TOL``) with the first cache
    layer where they part named, tokens equal, K1 launched 22 times a
    step in (a) and (b).  (d) layer 0's K/V of (a) (B16, S32,768, H32,
    Hkv4, D64, bf16): K1 over the whole cache against K1 with its LSE
    over 2, 4 and 16 sequence stripes merged by ``merge_partials``, at
    the bf16 limit, with lengths that end inside stripes (some on K1's
    single-split exit) and leave later stripes empty; each LSE against
    the plain version's f32 LSE (``STRIPE_LSE_TOL``); K1's output bitwise
    with and without ``return_lse``; each stripe's f32 output
    (``out_dtype=torch.float32``, what the striped serve step merges)
    against the plain version in f32 at the bf16 limit and, rounded,
    bitwise the bf16 output, and the merges of f32 and of bf16 partials
    against an f32 attention over the whole cache (the first no further
    than the second).  (e) the prefill plan at
    ``prefill_32k``'s 32,768 tokens (batch cut from 32 to 1) against the
    unsharded ``forward``: last logits and collected K/V, K4 launched 22
    times.  (f) K1 at (d)'s shape with every slot valid, with and without
    its LSE, and with its LSE and f32 output, beside its byte bound,
    SDPA over the cache viewed ``[B, S, Hkv, D]`` (``enable_gqa``) and
    the plain version (CUDA-graph replay, cold L2).  (g) full TinyLlama
    over an int8 cache at ``decode_32k`` (batch cut to 4) as (a), logits
    and cache bitwise the unsharded step's.

16. the dry-run (``[dryrun]`` lines): ``repro_torch.launch.dryrun`` on
    the host, in three processes of their own started after the build (no
    device: ``CUDA_VISIBLE_DEVICES`` empty) and read here: full TinyLlama
    at ``decode_32k`` over the 16x16 production mesh of fake ranks
    (``python -m repro_torch.launch.dryrun``), full TinyLlama at
    phase 12's training shape (B4 x S2048, no remat, f32 moments) on a
    world of one (``run_one``), and the plans whose head count does not
    divide the mesh axes (``UNEVEN_CHILD``): one smoke config of each
    family (TinyLlama, granite, llava, deepseek-v3, mamba2, zamba2,
    seamless) with 3 heads or 3 SSM heads, each ``lower_plan``'s train
    step, prefill plan and serve step on a ``(2, 2)`` fake world, the
    card's torch planning ``DTensor``'s head splits.  Every record must be ``ok``; the
    predicted peak bytes, FLOPs and memory term of the training step
    print beside phase 12's measured ``max_memory_allocated``, analytic
    FLOPs (``train_flops``) and median step time, with their ratios; the
    peak's and the memory term's must lie in their stated ranges
    (``DRYRUN_PEAK_RATIO``, ``DRYRUN_MEMORY_TO_STEP``).

The ``kernels`` line counts each kernel's launches over the main-path
runs of phases 4 (training) and 5-15, each counted from 0 just before
it.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero and prints no result.  It imports nothing of JAX
and nothing of the ``repro`` package.
"""
from __future__ import annotations

import atexit
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import zlib
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
# cases are what hold each kernel's arithmetic.  bf16: the kernel is held
# against the plain version evaluated in f32 on the same bf16 inputs, its
# output rounded to bf16 once.  The plain version run in bf16, like the
# reference's oracle, rounds q.k to bf16 before the softmax (a step of
# 2^-8 |q.k|, which grows with sqrt(D)) and the softmax weights before
# the PV product: an error of its own that alone reaches the limit at
# D 192 on some draws.  Each bf16 case prints that error beside the
# kernel's.  The limits are per kernel: at rtol 1e-2, about 1.4x the
# largest atol the cases below needed on an H100 against the bf16 plain
# version (5.3e-3 for decode, 8.9e-3 for the prefills).  Each case prints
# its share of the limit
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

def phase_build() -> dict:
    """Build every library; returns nvcc's output per source."""
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
    return logs


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _ratio(kernel: str, got: torch.Tensor, want: torch.Tensor,
           tol: dict | None = None) -> tuple[float, float, float]:
    """(max abs err, largest err / limit, |want| where that ratio peaks)
    of ``got`` against ``want``."""
    torch.cuda.synchronize()
    if tol is None:
        tol = F32_TOL if got.dtype == torch.float32 else BF16_TOL[kernel]
    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    ratio = (err / lim).flatten()
    at = int(ratio.argmax())
    return (err.max().item(), ratio[at].item(),
            want.float().abs().flatten()[at].item())


def _check(name: str, kernel: str, got: torch.Tensor, want: torch.Tensor,
           tol: dict | None = None) -> tuple[float, float, float]:
    """``_ratio`` of ``got`` against ``want``; raises past the limit."""
    err, worst, at = _ratio(kernel, got, want, tol)
    if not torch.isfinite(got.float()).all() or worst > 1.0:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version, max abs err "
            f"{err:.3e}, {worst:.2f} x the limit (at |want| {at:.3e})")
    return err, worst, at


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
    """``scaled_dot_product_attention`` on a dense prefill's inputs (it
    takes a value head dim other than the query's, as MLA's prefill
    needs).  An offset or a window takes a boolean mask built outside the
    timed call.  A yardstick only: the port never calls it."""
    q, k, v, kw = args
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not (kw["q_offset"] or kw["sliding_window"]):
        return lambda: sdpa(qt, kt, vt, is_causal=kw["causal"],
                            enable_gqa=True).transpose(1, 2)
    qp = torch.arange(q.shape[1], device=q.device)[:, None] + kw["q_offset"]
    kp = torch.arange(k.shape[1], device=q.device)[None]
    mask = kp <= qp if kw["causal"] else torch.ones_like(kp <= qp)
    if kw["sliding_window"]:
        mask &= kp > qp - kw["sliding_window"]
    return lambda: sdpa(qt, kt, vt, attn_mask=mask,
                        enable_gqa=True).transpose(1, 2)


def device_kernels(fn) -> str:
    """The device kernels one call of ``fn`` launches, by time, from a
    ``torch.profiler`` trace: which backend a library call took."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return "; ".join(n for n, _, _ in _top_kernels(prof, 1, k=2)) or \
        "not traced"


def flash_fma(args):
    """The dense prefill's FMA body on a bf16 case, through the C entry
    point with ``tensor_cores`` 0 (the body bf16 MLA shapes ran before
    the ``prefill_tc<192, 128>`` instance): the "before" of a
    tensor-core case, timed beside it, never on a served path and not
    counted as a launch."""
    from repro_torch.kernels import _build

    q, k, v, kw = args
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    fn = _build.load("chunked_prefill").flash_prefill_bf16

    def run():
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None, b, sq, skv, h, hkv, d, dv, d ** -0.5, kw["q_offset"],
                  int(kw["causal"]), int(kw["sliding_window"] or 0), 0,
                  torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(code, "flash_prefill (fma body)")
        return out
    return run


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
    flops = ssd_fwd_flops(b, l, chunk, h, p, g, n, with_init)
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
    ``make(generator, dtype)`` draws the case's inputs when called, from
    a generator seeded by the case's name and label alone
    (``case_seed``), so a case draws the same inputs wherever it stands
    in the list."""
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
    # the other paged families' head shapes, bf16 on the tensor-core
    # instances D 160 (stablelm-12b) and D 192 (nemotron-4-340b), and
    # stablelm's decode at D 160
    cases += [
        ("flash_prefill", "bf16 stablelm H32 Hkv8 D160 causal B4 S512",
         torch.bfloat16, False,
         lambda g, dt: flash_case(g, dt, device, b=4, sq=512, skv=512, off=0,
                                  hkv=8, d=160, dv=160),
         run_flash),
        ("chunked_prefill_paged", "bf16 stablelm H32 Hkv8 D160 R4 C256 over "
         "384", torch.bfloat16, False,
         lambda g, dt: prefill_paged_case(
             g, dt, device, offs=[128] * 4, valid=[256] * 4, c=256,
             pages_per_seq=3, hkv=8, d=160),
         run_prefill_paged),
        ("flash_prefill", "bf16 nemotron H96 Hkv8 D192 causal B1 S512",
         torch.bfloat16, False,
         lambda g, dt: flash_case(g, dt, device, b=1, sq=512, skv=512, off=0,
                                  h=96, hkv=8, d=192, dv=192),
         run_flash),
        ("paged_decode", "bf16 stablelm H32 Hkv8 D160 contiguous B4 P4",
         torch.bfloat16, False,
         lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=4,
                                   lengths=main_lens, tables=False, hkv=8,
                                   d=160),
         run_decode),
    ]
    # nemotron's dense prefill on three more draws: the bf16 plain
    # version's own error reaches the limit at D 192 on some of them
    cases += [
        ("flash_prefill", f"bf16 nemotron H96 Hkv8 D192 causal B1 S512, "
         f"draw {i}", torch.bfloat16, False,
         lambda g, dt: flash_case(g, dt, device, b=1, sq=512, skv=512, off=0,
                                  h=96, hkv=8, d=192, dv=192),
         run_flash)
        for i in (1, 2, 3)]
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        cases += [
            # zamba2-1.2b's served shapes, all at rep 1 (H = Hkv = 32): the
            # shared block's decode over the dense 1024-token cache (8
            # pages) and over a full 384-slot ring (3 pages); its cold
            # prefill and its warm suffix over a restored 256-token prefix;
            # the scan at state 64
            ("paged_decode", f"{tag} zamba2 rep 1 dense cache B4 S1024 (8 "
             f"pages), lengths 347-401", dtype, False,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=8,
                                       lengths=[347, 362, 380, 401],
                                       tables=False, hkv=32),
             run_decode),
            ("paged_decode", f"{tag} zamba2 rep 1 full ring B4 S384 (3 pages)",
             dtype, False,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=3,
                                       lengths=[384] * 4, tables=False,
                                       hkv=32),
             run_decode),
            # caches whose length 128 does not divide: one page of S
            # (``attention._paged``), a ring of 200 and a 1000-token cache
            ("paged_decode", f"{tag} zamba2 rep 1 ring B4 S200 (one page of "
             f"200), lengths 200/200/173/64", dtype, False,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=1,
                                       lengths=[200, 200, 173, 64],
                                       tables=False, hkv=32, page=200),
             run_decode),
            ("paged_decode", f"{tag} zamba2 rep 1 dense cache B4 S1000 (one "
             f"page of 1000), lengths 347-1000", dtype, False,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=1,
                                       lengths=[347, 362, 380, 1000],
                                       tables=False, hkv=32, page=1000),
             run_decode),
            ("flash_prefill", f"{tag} zamba2 rep 1 B1 Sq113 over Skv369 "
             f"q_offset 256", dtype, False,
             lambda g, dt: flash_case(g, dt, device, b=1, sq=113, skv=369,
                                      off=256, hkv=32),
             run_flash),
            ("flash_prefill", f"{tag} zamba2 rep 1 causal B1 S369", dtype,
             False,
             lambda g, dt: flash_case(g, dt, device, b=1, sq=369, skv=369,
                                      off=0, hkv=32),
             run_flash),
            ("ssd_chunk_scan", f"{tag} zamba2 B1 L384 H64 P64 G1 N64 Q128",
             dtype, False,
             lambda g, dt: ssd_case(g, dt, device, b=1, l=384, chunk=128,
                                    n=64),
             run_ssd),
        ]
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        sm = dict(h=16, hkv=16)
        cases += [
            # seamless-m4t-large-v2 (H = Hkv = 16, D 64): the encoder's
            # non-causal self-attention over 512 and 500 frames; the
            # decoder's cross-attention, non-causal at offset 0, of a
            # 32- or 37-token target over 500 or 512 frames; the cross
            # decode over a frozen cross K/V whose every length is the
            # source length (4 pages of 128, or one page of 500)
            ("flash_prefill", f"{tag} seamless encoder H16 Hkv16 D64 "
             f"non-causal B4 S512", dtype, False,
             lambda g, dt: flash_case(g, dt, device, b=4, sq=512, skv=512,
                                      off=0, causal=False, **sm),
             run_flash),
            ("flash_prefill", f"{tag} seamless encoder H16 Hkv16 D64 "
             f"non-causal B4 S500", dtype, False,
             lambda g, dt: flash_case(g, dt, device, b=4, sq=500, skv=500,
                                      off=0, causal=False, **sm),
             run_flash),
            ("flash_prefill", f"{tag} seamless cross H16 Hkv16 D64 "
             f"non-causal B4 Sq32 over Skv500", dtype, False,
             lambda g, dt: flash_case(g, dt, device, b=4, sq=32, skv=500,
                                      off=0, causal=False, **sm),
             run_flash),
            ("flash_prefill", f"{tag} seamless cross H16 Hkv16 D64 "
             f"non-causal B4 Sq37 over Skv512", dtype, False,
             lambda g, dt: flash_case(g, dt, device, b=4, sq=37, skv=512,
                                      off=0, causal=False, **sm),
             run_flash),
            ("paged_decode", f"{tag} seamless cross decode H16 Hkv16 D64 B4 "
             f"S512 (4 pages), lengths 512", dtype, False,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=4,
                                       lengths=[512] * 4, tables=False,
                                       **sm),
             run_decode),
            ("paged_decode", f"{tag} seamless cross decode H16 Hkv16 D64 B4 "
             f"S500 (one page of 500), lengths 500", dtype, False,
             lambda g, dt: decode_case(g, dt, device, b=4, pages_per_seq=1,
                                       lengths=[500] * 4, tables=False,
                                       page=500, **sm),
             run_decode),
        ]
    cases.append(
        ("chunked_prefill_paged", "bf16 nemotron H96 Hkv8 D192 R4 C256 over "
         "384", torch.bfloat16, False,
         lambda g, dt: prefill_paged_case(
             g, dt, device, offs=[128] * 4, valid=[256] * 4, c=256,
             pages_per_seq=3, h=96, hkv=8, d=192),
         run_prefill_paged))
    # deepseek-v3's MLA prefill (H = Hkv = 128, Dq 128 + 64, Dv 128): the
    # longest cold prompt of ``make_requests`` and its warm suffix over a
    # restored 256-token prefix, on ``prefill_tc<192, 128>``; f32 on a
    # short S (the FMA body)
    mla = dict(h=128, hkv=128, d=192, dv=128)
    cases += [
        ("flash_prefill", MLA_COLD_CASE, torch.bfloat16, False,
         lambda g, dt: flash_case(g, dt, device, b=1, sq=369, skv=369, off=0,
                                  **mla),
         run_flash),
        ("flash_prefill", "bf16 deepseek MLA H128 Hkv128 Dq192 Dv128 B1 "
         "Sq113 over Skv369 q_offset 256", torch.bfloat16, False,
         lambda g, dt: flash_case(g, dt, device, b=1, sq=113, skv=369,
                                  off=256, **mla),
         run_flash),
        ("flash_prefill", "f32 deepseek MLA H128 Hkv128 Dq192 Dv128 causal "
         "B1 S96", torch.float32, False,
         lambda g, dt: flash_case(g, dt, device, b=1, sq=96, skv=96, off=0,
                                  **mla),
         run_flash),
    ]
    return cases


MLA_COLD_CASE = "bf16 deepseek MLA H128 Hkv128 Dq192 Dv128 causal B1 S369"
# these bf16 cases must run the tensor-core body of the prefills: the
# other paged families' head shapes, zamba2's rep-1 prefills,
# deepseek-v3's MLA prefills and seamless-m4t's non-causal encoder and
# cross-attention
TENSOR_CORE_CASES = ("D160", "D192", "zamba2", "deepseek MLA", "seamless")
# these bf16 cases also time the FMA body on the same inputs (the
# tensor-core instance's "before")
FMA_BEFORE_CASES = (MLA_COLD_CASE,)
YARDSTICKS = {"paged_decode": sdpa_decode, "flash_prefill": sdpa_flash}


def case_seed(name: str, label: str) -> int:
    return zlib.crc32(f"{name} [{label}]".encode())


def _as_f32(args):
    """``args`` with every bf16 tensor (top level) copied to f32."""
    return tuple(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16
                 else a for a in args)


def _exact(runner, args, dtype):
    """The plain version evaluated in f32 on the same inputs, rounded to
    the kernel's output dtype (an SSD scan's final state stays f32)."""
    out = runner(_as_f32(args))[1]()
    if isinstance(out, tuple):
        return (out[0].to(dtype), out[1])
    return out.to(dtype)


def phase_kernels(device, timer: Timer) -> dict:
    """Every kernel against its plain version; returns the main-path
    (bf16) record of each kernel."""
    records = {}
    for name, label, dtype, main, make, runner in kernel_cases(device):
        gen = torch.Generator(device=device).manual_seed(
            case_seed(name, label))
        args, n_bytes, flops = make(gen, dtype)
        kern, plain = runner(args)
        want = plain() if dtype == torch.float32 else _exact(runner, args,
                                                             dtype)
        got = kern()
        if dtype != torch.float32:
            # how far the bf16 plain version itself lies from ``want``
            p_out = plain()
            p_err, p_worst, p_at = _ratio(
                name, p_out[0] if isinstance(p_out, tuple) else p_out,
                want[0] if isinstance(want, tuple) else want)
            log(f"[kernel] {name} [{label}]: bf16 plain version vs f32 "
                f"max_abs_err {p_err:.3e} ({p_worst:.2f} x limit at |want| "
                f"{p_at:.3e})")
        if isinstance(want, tuple):
            # the SSD scan: y, then its f32 final state at its own limit
            err, worst, at = _check(f"{name} [{label}] y", name, got[0],
                                    want[0])
            s_err, s_worst, _ = _check(f"{name} [{label}] final state", name,
                                       got[1], want[1], tol=SSD_STATE_TOL)
            log(f"[kernel] {name} [{label}]: final state max_abs_err "
                f"{s_err:.3e} ({s_worst:.2f} x limit)")
            err, worst = max(err, s_err), max(worst, s_worst)
        else:
            err, worst, at = _check(f"{name} [{label}]", name, got, want)
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
            if "MLA" in label:
                log(f"[kernel] {name} [{label}]: library call ran "
                    f"{device_kernels(lib)}")
        if label in FMA_BEFORE_CASES:
            fma = flash_fma(args)
            f_err, f_worst, _ = _check(f"{name} [{label}] fma body", name,
                                       fma(), want)
            log(f"[kernel] {name} [{label}] body fma (forced, the tensor-core "
                f"instance's before): max_abs_err {f_err:.3e} ({f_worst:.2f} "
                f"x limit)  ms {timer.ms(fma):.4f}")
        body = body_of(name, args)
        if (name != "paged_decode" and dtype == torch.bfloat16
                and body != "tensor-core"
                and any(t in label for t in TENSOR_CORE_CASES)):
            raise AssertionError(f"{name} [{label}] ran body {body}")
        log(f"[kernel] {name} [{label}] body {body}: max_abs_err {err:.3e} "
            f"({worst:.2f} x limit at |want| {at:.3e})  ms {ms:.4f}  "
            f"plain_ms {plain_ms:.4f}  "
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
# phase 3, the training pair: K4's forward with its LSE and its backward
# ---------------------------------------------------------------------------

# the backward against ``attention_bwd_ref`` run in f32 on the same inputs
# (the kernel's output and LSE): f32 at the repo's gradient limit; bf16
# with the reference gradient rounded to bf16 once, at the bf16 limit of
# the repo's model tests.  The LSE is held against ``torch.logsumexp`` of
# the plain f32 scores
BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
LSE_TOL = dict(atol=1e-5, rtol=0.0)
# (label, B, Sq, Skv, H, Hkv, Dq, Dv, causal, q_offset, window); the first
# is TinyLlama's training shape, the kernels line's record
BWD_CASES = (
    ("TinyLlama training B4 S2048 H32 Hkv4 D64 causal", 4, 2048, 2048, 32, 4,
     64, 64, True, 0, None),
    ("ragged B4 S500 H32 Hkv4 D64 causal", 4, 500, 500, 32, 4, 64, 64, True,
     0, None),
    ("B1 Sq113 over Skv369 q_offset 256 H32 Hkv4 D64", 1, 113, 369, 32, 4, 64,
     64, True, 256, None),
    ("window 256 B2 S1024 H32 Hkv4 D64 causal", 2, 1024, 1024, 32, 4, 64, 64,
     True, 0, 256),
    ("seamless encoder non-causal B4 S512 H16 D64", 4, 512, 512, 16, 16, 64,
     64, False, 0, None),
    ("seamless cross non-causal B4 Sq32 over Skv500 H16 D64", 4, 32, 500, 16,
     16, 64, 64, False, 0, None),
    ("stablelm B1 S512 H32 Hkv8 D160 causal", 1, 512, 512, 32, 8, 160, 160,
     True, 0, None),
    ("deepseek MLA B1 S369 H128 Dq192 Dv128 causal", 1, 369, 369, 128, 128,
     192, 128, True, 0, None),
)


def bwd_inputs(device, dtype, name, b, sq, skv, h, hkv, dq_, dv_, causal,
               off, win):
    """q, k, v and d_out ~ N(0, 1) of a ``BWD_CASES`` entry, drawn from a
    generator seeded by the case's name (``case_seed``), and its mask
    arguments."""
    gen = torch.Generator(device=device).manual_seed(
        case_seed("flash_prefill_bwd", name))
    q = torch.randn(b, sq, h, dq_, generator=gen, device=device).to(dtype)
    k = torch.randn(b, skv, hkv, dq_, generator=gen, device=device).to(dtype)
    v = torch.randn(b, skv, hkv, dv_, generator=gen, device=device).to(dtype)
    d_out = torch.randn(b, sq, h, dv_, generator=gen, device=device).to(dtype)
    return q, k, v, d_out, dict(causal=causal, q_offset=off,
                                sliding_window=win)


def _visible_pairs(sq, skv, causal, off, window) -> int:
    """(query, key) pairs the mask leaves visible, per sequence and head."""
    seen = 0
    for i in range(sq):
        p = off + i
        lo = max(0, p - window + 1) if window else 0
        hi = min(skv, p + 1) if causal else skv
        seen += max(0, hi - lo)
    return seen


def events_ms(fn, iters: int = 10, flush=None) -> float:
    """Median device ms of ``fn`` (launched eagerly, host gaps included)
    over ``iters`` runs, each after ``flush`` is rewritten (cold L2): for
    calls that run autograd, which a CUDA graph does not capture."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _ptxas(logs: dict, pattern: str, source: str = "flash_backward") -> str:
    """The ``ptxas`` register and spill lines of the entry of ``source``
    whose mangled name holds ``pattern``."""
    lines = logs.get(source, "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and pattern in line:
            rest = [l.split("info    :")[-1].strip() for l in lines[i + 1:i + 4]
                    if "registers" in l or "spill" in l]
            return "; ".join(rest)
    return "not in this build's log (library already built)"


# SASS opcodes that show the tensor-core body on Hopper's own paths: wgmma
# (HGMMA), mbarrier waits and arrivals (SYNCS), TMA tile loads (UTMALDG)
SASS_OPS = ("HGMMA", "SYNCS", "UTMALDG")


def sass_counts(lib: Path, patterns: tuple) -> dict:
    """Per kernel whose mangled name holds one of ``patterns``, keyed by
    its instance (``bwd_dkdv_wgILi64ELi64E``), how many instructions of
    each of ``SASS_OPS`` its SASS in ``lib`` holds (``cuobjdump -sass``);
    empty where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[-1].strip()
            at = next((name.index(p) for p in patterns if p in name), None)
            cur = None
            if at is not None:   # the instance ends where its args do
                end = name.find("EE", at)
                cur = name[at:end + 1] if end >= 0 else next(
                    p for p in patterns if p in name)
                counts[cur] = dict.fromkeys(SASS_OPS, 0)
        elif cur is not None:
            for op in SASS_OPS:
                if f" {op}" in line:
                    counts[cur][op] += 1
    return counts


def launch_split(fn, iters: int = 5, flush=None) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, from one
    ``torch.profiler`` (CUPTI) trace of ``iters`` calls, longest first;
    empty when the trace holds no device events.  With ``flush`` (the
    ``Timer``'s buffer) it is rewritten before each call, so that every
    call starts with a cold L2 as the ``Timer``'s replays do; its own
    kernel is left out of the split."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    tot = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not (flush is not None and "FillFunctor" in e.name)):
            tot[e.name] = tot.get(e.name, 0.0) + (e.time_range.end
                                                 - e.time_range.start)
    return {n: t / 1e3 / iters
            for n, t in sorted(tot.items(), key=lambda x: -x[1])}


def backward_split(split: dict, *, seen: int, dq: int, dv: int,
                   delta_bytes: int) -> list:
    """``launch_split`` of one backward as [kernel, ms, rate]: the dkdv
    launch's four products (2 seen (2 Dq + 2 Dv) FLOP) and the dq launch's
    three (2 seen (2 Dq + Dv)) in TFLOP/s, the delta pass's bytes in GB/s."""
    rows = []
    for name, ms in split.items():
        short = next((k for k in ("bwd_delta", "bwd_dkdv", "bwd_dq")
                      if k in name), name[:60])
        if short == "bwd_dkdv":
            rate = f"{2 * seen * (2 * dq + 2 * dv) / ms / 1e9:.1f} TFLOP/s"
        elif short == "bwd_dq":
            rate = f"{2 * seen * (2 * dq + dv) / ms / 1e9:.1f} TFLOP/s"
        elif short == "bwd_delta":
            rate = f"{delta_bytes / ms / 1e6:.1f} GB/s"
        else:
            rate = ""
        rows.append([short, round(ms, 5), rate])
    return rows


def check_tc_plans() -> None:
    """The tensor-core body's tiling as the built library lays it out
    against ``tc_plan``, every instance: the two must agree, and each
    block's shared memory must fit the H100's 232,448 bytes."""
    from repro_torch.kernels.flash_backward import (
        SMEM_LIMIT, TENSOR_CORE_SHAPES, card_plan, tc_plan)

    for dq_, dv_ in TENSOR_CORE_SHAPES:
        got, want = card_plan(dq_, dv_), tc_plan(dq_, dv_)
        if got != want or max(got["smem_dkdv"], got["smem_dq"]) > SMEM_LIMIT:
            raise AssertionError(f"flash_prefill_bwd plan <{dq_}, {dv_}>: "
                                 f"library {got}, tc_plan {want}")
        log(f"[kernel] flash_prefill_bwd plan <{dq_}, {dv_}>: {got}")


def phase_backward(device, timer: Timer, build_logs: dict) -> dict:
    """K4's training pair on the card: ``flash_prefill(return_lse=True)``
    and ``flash_prefill_bwd`` at ``BWD_CASES``, bf16 and f32, inputs and
    ``d_out`` ~ N(0, 1) from ``case_seed``.  The LSE against
    ``torch.logsumexp`` of the plain f32 scores; dq / dk / dv against
    ``attention_bwd_ref`` in f32 on the same inputs; each case twice,
    bitwise equal.  Times: the backward (CUDA-graph replays, cold L2), the
    plain backward, the bound of the five products and the bytes, and the
    forward + backward against ``scaled_dot_product_attention``'s forward
    + backward (eager, cold L2; SDPA is a yardstick the port never
    calls); SDPA's forward alone and backward alone (``autograd.grad`` on
    a retained graph), eager, cold L2; the port's forward with its LSE
    alone against its plain version and its bound; at the main case the
    backward's split into its launches (one CUPTI trace).  Returns the
    main case's bf16 record."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.chunked_prefill import flash_prefill
    from repro_torch.kernels.flash_backward import bwd_body, flash_prefill_bwd
    from repro_torch.kernels.ops import FlashAttention

    check_tc_plans()
    sass = sass_counts(_build.library_path("flash_backward"),
                       ("bwd_dkdv_wg", "bwd_dq_wg"))
    if not sass:
        log("[kernel] flash_prefill_bwd sass: not measured (no cuobjdump)")
    for inst, ops in sass.items():
        log(f"[kernel] flash_prefill_bwd sass {inst}: {ops}")
        if not all(ops.values()):
            raise AssertionError(f"flash_prefill_bwd: {inst} lacks one of "
                                 f"{SASS_OPS}: {ops}")
    # ptxas says "Potential Performance Loss" where it serialises wgmma
    for line in build_logs.get("flash_backward", "").splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            log(f"[build] flash_backward: {line.strip()}")

    record = None
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for (label, b, sq, skv, h, hkv, dq_, dv_, causal, off,
             win) in BWD_CASES:
            name = f"{tag} {label}"
            q, k, v, d_out, kw = bwd_inputs(device, dtype, name, b, sq, skv,
                                            h, hkv, dq_, dv_, causal, off,
                                            win)
            out, lse = flash_prefill(q, k, v, return_lse=True, **kw)
            # the LSE against the plain scores, one head group at a time
            kr = torch.repeat_interleave(k.float(), h // hkv, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * dq_ ** -0.5
            qp = torch.arange(sq, device=device)[:, None] + off
            kp = torch.arange(skv, device=device)[None]
            mask = kp <= qp if causal else torch.ones_like(kp <= qp)
            if win:
                mask &= kp > qp - win
            want_lse = torch.logsumexp(s.masked_fill(~mask, -torch.inf), -1)
            del s, kr
            lse_err = (lse - want_lse).abs().max().item()
            if not bool(torch.isfinite(lse).all()) or lse_err > LSE_TOL["atol"]:
                raise AssertionError(f"flash_prefill_bwd [{name}]: forward "
                                     f"LSE max abs err {lse_err:.3e}")

            def bwd():
                return flash_prefill_bwd(q, k, v, out, lse, d_out, **kw)

            def plain():
                return ref.attention_bwd_ref(q, k, v, out, lse, d_out, **kw)

            got, again = bwd(), bwd()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"flash_prefill_bwd [{name}]: two runs "
                                     "differ")
            want = ref.attention_bwd_ref(q.float(), k.float(), v.float(),
                                         out.float(), lse, d_out.float(),
                                         **kw)
            tol = BWD_TOL[dtype]
            errs, worst = [], 0.0
            for n, g, w in zip(("dq", "dk", "dv"), got, want):
                err, ratio, _ = _check(f"flash_prefill_bwd [{name}] {n}",
                                       "flash_prefill_bwd", g, w.to(dtype),
                                       tol)
                errs.append(err)
                worst = max(worst, ratio)
            del want
            ms = timer.ms(bwd)
            plain_ms = timer.ms(plain)
            seen = b * h * _visible_pairs(sq, skv, causal, off, win)
            flops = 2 * seen * (3 * dq_ + 2 * dv_)
            n_bytes = nbytes(q, k, v, out, d_out, lse) + nbytes(q, k, v)
            bms, by = bound_ms(n_bytes, flops, dtype)

            # forward + backward: the port's through its autograd function,
            # SDPA's through its own (GQA, a boolean mask for an offset or
            # a window, built outside the timed call)
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

            def port_fb():
                o = FlashAttention.apply(*leaves, causal, off, win, None)
                return torch.autograd.grad(o, leaves, d_out)

            sdpa = torch.nn.functional.scaled_dot_product_attention
            lt = [t.transpose(1, 2) for t in leaves]
            amask = None if not (off or win) else mask

            def sdpa_fb():
                o = sdpa(*lt, attn_mask=amask,
                         is_causal=causal and amask is None,
                         enable_gqa=True)
                return torch.autograd.grad(o, leaves, d_out.transpose(1, 2))

            fb_ms = events_ms(port_fb, flush=timer.flush)
            sdpa_ms = events_ms(sdpa_fb, flush=timer.flush)
            # one direction at a time: SDPA's forward alone (as training
            # runs it, keeping its LSE) and its backward alone on a
            # retained graph; the port's forward with its LSE alone
            def sdpa_f():
                return sdpa(*lt, attn_mask=amask,
                            is_causal=causal and amask is None,
                            enable_gqa=True)

            o_s, g_s = sdpa_f(), d_out.transpose(1, 2)

            def sdpa_b():
                return torch.autograd.grad(o_s, leaves, g_s,
                                           retain_graph=True)

            sdpa_f_ms = events_ms(sdpa_f, flush=timer.flush)
            sdpa_b_ms = events_ms(sdpa_b, flush=timer.flush)
            del o_s
            fwd_ms = timer.ms(lambda: flash_prefill(q, k, v, return_lse=True,
                                                    **kw))
            fwd_plain_ms = timer.ms(
                lambda: ref.attention_fwd_lse_ref(q, k, v, **kw))
            fwd_flops = 2 * seen * (dq_ + dv_)
            fbms, fby = bound_ms(nbytes(q, k, v, out, lse), fwd_flops, dtype)
            body = bwd_body(dtype, dq_, dv_)
            if dtype == torch.bfloat16 and body != "tensor-core":
                raise AssertionError(f"flash_prefill_bwd [{name}] ran body "
                                     f"{body}")
            inst = (f"bwd_dkdv_wgILi{dq_}ELi{dv_}E" if body == "tensor-core"
                    else "bwd_dkdv_fmaI" + ("f" if dtype == torch.float32
                                            else "13__nv_bfloat16"))
            log(f"[kernel] flash_prefill_bwd [{name}] body {body}: LSE max "
                f"abs err {lse_err:.3e}; dq/dk/dv max_abs_err "
                f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} ({worst:.2f} x "
                f"limit {tol}); bitwise repeatable; ms {ms:.4f}  plain_ms "
                f"{plain_ms:.4f}  bound_ms {bms:.5f} ({by}; {flops / 1e9:.2f} "
                f"GFLOP, {n_bytes / 1e6:.1f} MB)  forward+backward ms "
                f"{fb_ms:.4f}  library_ms (SDPA forward+backward) "
                f"{sdpa_ms:.4f}; SDPA forward alone {sdpa_f_ms:.4f}, "
                f"backward alone {sdpa_b_ms:.4f}")
            log(f"[kernel] flash_prefill_bwd [{name}] forward with its LSE: "
                f"ms {fwd_ms:.4f}  plain_ms {fwd_plain_ms:.4f}  bound_ms "
                f"{fbms:.5f} ({fby}; {fwd_flops / 1e9:.2f} GFLOP)")
            log(f"[kernel] flash_prefill_bwd [{name}] ptxas: dkdv "
                f"{_ptxas(build_logs, inst)}; dq "
                f"{_ptxas(build_logs, inst.replace('dkdv', 'dq'))}")
            if record is None:
                split = backward_split(
                    launch_split(bwd), seen=seen, dq=dq_, dv=dv_,
                    delta_bytes=nbytes(out, d_out) + b * h * sq * 4)
                log(f"[kernel] flash_prefill_bwd [{name}] launches, one "
                    f"CUPTI trace (kernel, ms, rate): "
                    f"{json.dumps(split) if split else 'no device events'}")
                record = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                              bound_ms=bms, bound_by=by,
                              library_ms=sdpa_b_ms,
                              forward_backward_ms=fb_ms,
                              library_forward_backward_ms=sdpa_ms,
                              shape=name, body=body)
            del out, lse, got, again, leaves, lt
            torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# phase 3, K5's backward: the gradient of the SSD chunked scan
# ---------------------------------------------------------------------------

# ``ssd_chunk_scan_bwd`` against ``ssd_scan_bwd_ref`` run in f32 on the same
# inputs.  Each output is held element by element to atol x (its largest
# magnitude) + rtol x |want|: the gradients sum long chains of terms that
# cancel (dseg's reverse cumulative sum, da over every position), so an
# element near 0 carries the absolute error of its terms, which scales
# with the tensor, not with the element.  f32: the repo's gradient rtol
# (tests/test_torch_ssd_grad.py), summation order only.  bf16: dx, dB and
# dC are rounded to bf16 once (one step is 2^-8 of |want|, and where the
# two sums straddle a rounding boundary they part by a step, 2^-7); the
# f32 outputs (ddt, da, d_initial_state) carry the hi/lo split of the f32
# factors, ~2^-16 of each product
SSD_BWD_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-3),
               torch.bfloat16: dict(atol=1e-2, rtol=2e-2)}
SSD_BWD_F32_OUT_TOL = dict(atol=1e-4, rtol=1e-3)
SSD_BWD_NAMES = ("dx", "ddt", "da", "dB", "dC", "d_initial_state")
# (label, B, L, chunk, H, P, G, N, initial state?, d_final?, dt = 0 rows at
# the end); the first is mamba2-1.3b's training shape, the kernels line's
# record
SSD_BWD_CASES = (
    ("mamba2-1.3b training B4 L2048 H64 P64 G1 N128 Q128", 4, 2048, 128, 64,
     64, 1, 128, False, False, 0),
    ("B2 L512 Q128, initial state and d_final", 2, 512, 128, 64, 64, 1, 128,
     True, True, 0),
    ("G2 B2 L256 Q64", 2, 256, 64, 64, 64, 2, 128, False, False, 0),
    ("ragged single chunk L37 Q37", 1, 37, 37, 64, 64, 1, 128, False, False,
     0),
    ("chunk 1, L3, initial state and d_final", 1, 3, 1, 64, 64, 1, 128, True,
     True, 0),
    ("P12 N20 Q40 G2 H4 B1 L120, initial state and d_final", 1, 120, 40, 4,
     12, 2, 20, True, True, 0),
    ("zamba2-1.2b training N64 B4 L2048 Q128", 4, 2048, 128, 64, 64, 1, 64,
     False, False, 0),
    ("padding: last 91 of B1 L384 rows dt = 0", 1, 384, 128, 64, 64, 1, 128,
     False, False, 91),
)


def ssd_bwd_inputs(device, dtype, name, b, l, chunk, h, p, g, n, with_init,
                   with_dfin, pad):
    """x, dt, a, B, C (``ssd_case``'s ranges), the initial state, dy ~ N(0,
    1) and d_final of an ``SSD_BWD_CASES`` entry, from a generator seeded
    by the case's name; dt (and x) 0 on the last ``pad`` rows, as a
    prefill pads to a chunk multiple."""
    gen = torch.Generator(device=device).manual_seed(
        case_seed("ssd_chunk_scan_bwd", name))
    (x, dt, a, bm, cm, init, _), _, _ = ssd_case(
        gen, dtype, device, b=b, l=l, chunk=chunk, h=h, p=p, g=g, n=n,
        with_init=with_init)
    dy = torch.randn(b, l, h, p, generator=gen, device=device).to(dtype)
    dfin = (torch.randn(b, h, p, n, generator=gen, device=device)
            if with_dfin else None)
    if pad:
        dt[:, l - pad:] = 0.0
        x[:, l - pad:] = 0.0
    return x, dt, a, bm, cm, init, dy, dfin


def ssd_bwd_flops(b, l, chunk, h, p, g, n, with_init, with_dfin) -> int:
    """The least products this run's data needs: per chunk and group C.B^T
    once, and dG.B and dG^T.C once with dG summed over the group's heads;
    per head dy.u^T and M^T.dy over the causal triangle; per head and
    chunk the state terms B.dS^T, u.dS and dy.S_c where the state or
    cotangent there is not zero, the cotangent update for every chunk (the
    last gives d_initial_state) and the state update for every chunk but
    the last."""
    nc = l // chunk
    tri = chunk * (chunk + 1) // 2
    warm_s = nc if with_init else nc - 1
    warm_ds = nc if with_dfin else nc - 1
    state = 2 * chunk * n * p
    return (b * nc * (3 * 2 * tri * n * g + h * 2 * tri * 2 * p)
            + b * h * state * (warm_s + 2 * warm_ds + nc + nc - 1))


# the kernels of csrc/ssd_backward.cu, in launch order per body



def _spills(line: str) -> int:
    """Spill bytes (stores + loads) in a ``_ptxas`` line; -1 if absent."""
    import re
    got = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
    return sum(int(v) for v in got) if got else -1


def check_ssd_bwd_plan(build_logs: dict) -> None:
    """The built library's plan against ``ssd_backward``'s host-side
    mirror (the tensor-core chunk CTAs' shared memory at every N, the
    cluster size from H / G), each kernel's registers, shared memory and
    spills (0 spills, at most 232,448 bytes), and the SASS counts that
    show wgmma (HGMMA), mbarriers (SYNCS) and TMA (UTMALDG)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_backward as sb

    for n in (20, 64, 128):
        for rep in (64, 32, 2):
            plan = sb.card_plan(128, n, rep)
            ar = sb.arrangement(rep, n)
            if (plan["chunk_tc"] != sb.chunk_smem(n)
                    or plan["pass_tc"] != sb.pass_smem(n)
                    or plan["cluster_dbc"] != ar["dbc"][0]
                    or plan["cluster_dx"] != ar["dx"][0]
                    or max(plan.values()) > sb.SMEM_LIMIT):
                raise AssertionError(f"ssd_chunk_scan_bwd plan N {n} H/G "
                                     f"{rep}: library {plan}, host "
                                     f"{sb.chunk_smem(n)} / {ar}")
    plan = sb.card_plan(128, 128, 64)
    log(f"[kernel] ssd_chunk_scan_bwd plan at chunk 128, N 128, H/G 64 "
        f"(dynamic shared memory in bytes, cluster sizes): {plan}")
    dyn = {"ssd_bwd_pass_wgILi1": plan["pass_tc"],
           "ssd_bwd_pass_wgILi2": plan["pass_tc"],
           "ssd_bwd_pass_fma": plan["pass_f32"],
           "ssd_bwd_dbc_tc": plan["chunk_tc"], "ssd_bwd_dx_tcILi1": plan[
               "chunk_tc"], "ssd_bwd_dx_tcILi2": plan["chunk_tc"],
           "ssd_bwd_dbc_f32": plan["dbc_f32"],
           "ssd_bwd_dx_f32": plan["dx_f32"], "ssd_bwd_decays": 0}
    sass = sass_counts(_build.library_path("ssd_backward"),
                       tuple(dyn))
    for inst, smem in dyn.items():
        line = _ptxas(build_logs, inst, "ssd_backward")
        ops = next((v for k, v in sass.items() if k.startswith(inst)), {})
        log(f"[kernel] ssd_chunk_scan_bwd ptxas {inst}: {line}; dynamic "
            f"shared memory {smem:,} B; SASS {ops}")
        if _spills(line) > 0:
            raise AssertionError(f"ssd_chunk_scan_bwd: {inst} spills: "
                                 f"{line}")


def ssd_bwd_split(split: dict, flops: float, n_bytes: float) -> list:
    """``launch_split`` of one backward as [kernel, ms, share of the
    call's bound products and bytes per ms]."""
    rows = []
    for name, ms in split.items():
        short = next((k for k in ("ssd_bwd_decays", "ssd_bwd_pass",
                                  "ssd_bwd_dbc", "ssd_bwd_dx")
                      if k in name), name[:60])
        rows.append([short, round(ms, 5),
                     f"{flops / ms / 1e9:.1f} TFLOP/s, "
                     f"{n_bytes / ms / 1e6:.1f} GB/s of the call's bound"])
    return rows


def phase_ssd_backward(device, timer: Timer, build_logs: dict,
                       card: str) -> dict:
    """K5's backward on the card: ``ssd_chunk_scan_bwd`` at
    ``SSD_BWD_CASES``, bf16 and f32, against ``ssd_scan_bwd_ref`` in f32 on
    the same inputs (``SSD_BWD_TOL``), each case twice, bitwise equal;
    its time (CUDA-graph replays, cold L2) beside ``card`` (the card's
    name and power limit), the plain backward's, its bound in bytes and
    in operations, and at the main case of each body its split into
    launches (one CUPTI trace with L2 warm, one with it flushed before
    each call as the replays do); each kernel's ptxas registers, shared
    memory, spills and SASS counts (``check_ssd_bwd_plan``).  Returns the
    main case's bf16 record."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_backward import bwd_body, ssd_chunk_scan_bwd

    check_ssd_bwd_plan(build_logs)
    record = None
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for ci, (label, b, l, chunk, h, p, g, n, with_init, with_dfin,
                 pad) in enumerate(SSD_BWD_CASES):
            name = f"{tag} {label}"
            x, dt, a, bm, cm, init, dy, dfin = ssd_bwd_inputs(
                device, dtype, name, b, l, chunk, h, p, g, n, with_init,
                with_dfin, pad)

            def bwd():
                return ssd_chunk_scan_bwd(x, dt, a, bm, cm, dy,
                                          chunk_size=chunk,
                                          initial_state=init, d_final=dfin)

            def plain():
                return ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, init, dy, dfin,
                                            chunk)

            got, again = bwd(), bwd()
            torch.cuda.synchronize()
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"ssd_chunk_scan_bwd [{name}]: two runs "
                                     "differ")
            want = ref.ssd_scan_bwd_ref(x.float(), dt, a, bm.float(),
                                        cm.float(), init, dy.float(), dfin,
                                        chunk)
            errs, rel, worst = [], [], 0.0
            for nm, u, w in zip(SSD_BWD_NAMES, got, want):
                tol = (SSD_BWD_F32_OUT_TOL
                       if dtype != torch.float32 and u.dtype == torch.float32
                       else SSD_BWD_TOL[dtype])
                w = w.to(u.dtype).float()
                scale = max(w.abs().max().item(), 1e-30)
                err = (u.float() - w).abs()
                ratio = (err / (tol["atol"] * scale
                                + tol["rtol"] * w.abs())).max().item()
                if not bool(torch.isfinite(u.float()).all()) or ratio > 1.0:
                    raise AssertionError(
                        f"ssd_chunk_scan_bwd [{name}] {nm}: kernel disagrees "
                        f"with its plain version, max abs err "
                        f"{err.max().item():.3e} at scale {scale:.3e}, "
                        f"{ratio:.2f} x the limit {tol}")
                errs.append(err.max().item())
                rel.append(err.max().item() / scale)
                worst = max(worst, ratio)
            del want, again
            ms = timer.ms(bwd)
            plain_ms = timer.ms(plain)
            flops = ssd_bwd_flops(b, l, chunk, h, p, g, n, with_init,
                                  with_dfin)
            n_bytes = (nbytes(x, dt, a, bm, cm, dy) + nbytes(*got)
                       + (nbytes(init) if with_init else 0)
                       + (nbytes(dfin) if with_dfin else 0))
            bms, by = bound_ms(n_bytes, flops, dtype)
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            body = bwd_body(dtype)
            log(f"[kernel] ssd_chunk_scan_bwd [{name}] body {body}: "
                f"max abs err / scale "
                + "/".join(f"{e:.2e}" for e in rel)
                + f" ({'/'.join(SSD_BWD_NAMES)}; {worst:.2f} x limit); "
                f"bitwise repeatable; ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
                f"bound_ms {bms:.5f} ({by}; bytes {n_bytes / 1e6:.1f} MB "
                f"{t_bytes:.5f} ms, operations {flops / 1e9:.2f} GFLOP "
                f"{t_ops:.5f} ms)  library_ms null  on {card}")
            if ci == 0:
                for temp, flush in (("warm", None), ("cold", timer.flush)):
                    split = launch_split(bwd, flush=flush)
                    log(f"[kernel] ssd_chunk_scan_bwd [{name}] launches, one "
                        f"CUPTI trace, L2 {temp} (kernel, ms, rate) on "
                        f"{card}: "
                        + (json.dumps(ssd_bwd_split(split, flops, n_bytes))
                           if split else "no device events"))
            if record is None:
                record = dict(max_abs_err=max(errs), ms=ms,
                              plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                              library_ms=None, shape=name, body=body)
            del got
            torch.cuda.empty_cache()
    log("[kernel] ssd_chunk_scan_bwd: library_ms is null, no PyTorch call "
        "computes the SSD scan's gradient; max abs err is per output over "
        "its largest magnitude")
    return record


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


class RouteCheck:
    """The MoE rule of the card-vs-CPU check.  Capacity routing may pick
    another expert on the card than on the CPU where an expert's
    probability ties the k-th within rounding.  Forward hooks on every
    MoE layer of both models record each call's routes; ``rows`` compares
    the top-k sets token by token, counts and prints the tokens whose
    choice differs, and fails on any such flip where the CPU's gap
    between the k-th and (k+1)-th probability is ``GAP`` or more.  A
    flip changes the expert buffers of its whole group (capacity) and,
    through attention, every later position, so after one no row of the
    phase is held to the logit limit any more; the logits are held, at
    ``MODEL_TOL``, on the rows whose routes agreed in every layer so
    far."""

    GAP = 1e-5

    def __init__(self, card, cpu):
        from repro_torch.models.moe import moe_route

        self.calls = {"card": [], "cpu": []}
        self.tainted = False
        self.flips = 0

        def hook(tag):
            def record(mod, inputs, _):
                *_, probs, _, top_i = moe_route(mod, inputs[0], mod.cfg)
                self.calls[tag].append((probs.cpu(), top_i.cpu()))
            return record

        for tag, m in (("card", card), ("cpu", cpu)):
            for blk in m.blocks:
                if blk.is_moe:
                    blk.moe.register_forward_hook(hook(tag))

    def rows(self, name: str, batch: int) -> list:
        flips = 0
        for (_, ti_card), (p_cpu, ti_cpu) in zip(self.calls["card"],
                                                 self.calls["cpu"]):
            k = ti_cpu.shape[-1]
            differ = (ti_card.sort(-1).values
                      != ti_cpu.sort(-1).values).any(-1)
            top = p_cpu.sort(-1, descending=True).values
            gap = top[..., k - 1] - top[..., k]
            bad = differ & (gap >= self.GAP)
            if bool(bad.any()):
                raise AssertionError(
                    f"{name}: {int(bad.sum())} tokens route to other experts "
                    f"on the card though the CPU's k-th probability leads by "
                    f"{gap[bad].min().item():.2e} or more")
            flips += int(differ.sum())
        self.calls = {"card": [], "cpu": []}
        self.flips += flips
        self.tainted = self.tainted or flips > 0
        log(f"[model] {name}: {flips} tokens route to other experts on "
            f"the card than on the CPU (allowed only where the CPU's k-th "
            f"and (k+1)-th probabilities are within {self.GAP})")
        return [] if self.tainted else list(range(batch))


def _close_rows(name: str, got, want, routes) -> None:
    """``_close`` on the rows ``routes`` still holds (all of them for a
    model without experts)."""
    if routes is None:
        _close(name, got, want)
        return
    rows = routes.rows(name, got.shape[0])
    if not rows:
        log(f"[model] {name}: not compared (a route flipped earlier)")
        return
    _close(name, got[rows], want[rows])


def with_int8_pool(model):
    """``model``'s weights, shared and not copied, under its config with
    ``kvc_dtype="int8"``: every K/V page pool or cache built for it is
    quantized in steps of 1/32 (``models.cache.quant_kvc``)."""
    from repro_torch.models.model import Model

    m8 = Model(model.cfg.replace(kvc_dtype="int8"), device=model.device)
    m8.load_state_dict(model.state_dict(), assign=True)
    return m8


def _int8_within_step(name: str, got: torch.Tensor,
                      want: torch.Tensor) -> int:
    """Two int8 K/V pools or caches (card, CPU) after the same steps:
    every element within one quantization step (an f32 projection may
    round a tie the other way); prints and returns how many differ."""
    if got.dtype != torch.int8 or want.dtype != torch.int8:
        raise AssertionError(f"{name}: not int8 ({got.dtype}, {want.dtype})")
    d = (got.cpu().to(torch.int16) - want.to(torch.int16)).abs()
    n, worst = int((d > 0).sum()), int(d.max())
    log(f"[model] {name}: {n} of {d.numel()} int8 elements differ card vs "
        f"CPU, by at most {worst} step")
    if worst > 1:
        raise AssertionError(f"{name}: an int8 element differs by {worst} "
                             "quantization steps card vs CPU")
    return n


def phase_model(cfg, device, *, seed=0, prompt_len=200, page=128,
                max_seq_len=512) -> None:
    from repro_torch.models.model import Model

    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"head_dim {cfg.head_dim}, {cfg.dtype}, K/V pool "
        f"{cfg.kvc_dtype or cfg.dtype}")
    gpu = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    routes = RouteCheck(gpu, cpu) if cfg.num_experts else None
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, prompt_len)))
    lg_g, _ = gpu.forward(toks.to(device))
    lg_c, _ = cpu.forward(toks)
    _close_rows("forward", lg_g, lg_c, routes)

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
        _close_rows(f"prefill_chunk_paged ({mode})", out[0], out[1], routes)
        # three decode steps, both devices fed the CPU's greedy tokens
        nxt = torch.argmax(out[1], dim=-1).to(torch.int32)
        lens = nv.clone()
        for step in range(3):
            out = [m.decode_step_paged(
                       p.k_pool, p.v_pool, nxt[:, None].to(dev),
                       None if contiguous else bt.to(dev), lens.to(dev),
                       contiguous=contiguous)[:, 0]
                   for (m, dev), p in zip(runs, pools)]
            _close_rows(f"decode_step_paged {step} ({mode})", out[0],
                        out[1], routes)
            nxt = torch.argmax(out[1], dim=-1).to(torch.int32)
            lens = lens + 1
        if cfg.kvc_dtype == "int8":
            for part in ("k_pool", "v_pool"):
                _int8_within_step(f"int8 {part} after the prefill and three "
                                  f"decode steps ({mode})",
                                  getattr(pools[0], part),
                                  getattr(pools[1], part))


def phase_ssm_model(cfg, device, *, seed=0, length=384, split=256,
                    steps=8) -> None:
    """An SSM or hybrid model on the card against the CPU (logits, the
    final SSM state and, for the hybrid, the shared block's K/V), a
    resume from a snapshot against the uninterrupted forward, and the
    decode recurrence from that snapshot against the chunked scan (the
    reference's ``test_ssd_scan_equals_sequential_recurrence``, through
    the model; the hybrid's shared block decodes over the dense cache)."""
    from repro_torch.models.model import Model

    name = cfg.name
    log(f"[model] {name}: {cfg.num_layers} layers, d {cfg.d_model}, state "
        f"{cfg.ssm_state}, attention period {cfg.attn_layer_period}, "
        f"{cfg.dtype}")
    gpu = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, length)))
    lg_g, st_g = gpu.forward(toks.to(device), collect_state=True)
    lg_c, st_c = cpu.forward(toks, collect_state=True)
    _close(f"{name} forward", lg_g, lg_c)
    _close(f"{name} forward final state", st_g["ssm"]["state"],
           st_c["ssm"]["state"])
    if "kv" in st_c:
        for k in ("k", "v"):
            _close(f"{name} forward shared-attention {k}", st_g["kv"][k],
                   st_c["kv"][k])

    _, snap = gpu.forward(toks[:, :split].to(device), collect_state=True)
    lg_r, st_r = gpu.forward(toks[:, split:].to(device), q_offset=split,
                             prefix_state=snap, collect_state=True)
    same = "on the card"
    _close(f"{name} resume from the snapshot at {split} vs uninterrupted",
           lg_r, lg_g[:, split:], same)
    _close(f"{name} resumed final state vs uninterrupted",
           st_r["ssm"]["state"], st_g["ssm"]["state"], same)

    cache = gpu.init_cache(2, length)
    cache["ssm"]["conv"].copy_(snap["ssm"]["conv"])
    cache["ssm"]["state"].copy_(snap["ssm"]["state"])
    if "kv" in snap:
        for k in ("k", "v"):
            cache["kv"][k][:, :, :split] = snap["kv"][k]
    pos = torch.full((2,), split, dtype=torch.int32, device=device)
    for i in range(steps):
        lg = gpu.decode_step(cache, toks[:, split + i: split + i + 1]
                             .to(device), pos + i)
        _close(f"{name} decode_step {i} vs prefill logits", lg[:, 0],
               lg_g[:, split + i], same)


def phase_mla_model(cfg, device, *, seed=0, length=300, split=256,
                    steps=8) -> None:
    """An MLA model on the card against the CPU: ``forward`` logits and
    the collected latents, a resume from the latent prefix at ``split``
    against the uninterrupted forward on the card, and ``steps``
    ``decode_step``s over the latent cache from that prefix, both devices
    fed the CPU's greedy tokens.  Every MoE layer's routes are compared
    first (``RouteCheck``); the latents of every layer depend on the
    layers before its MoE alone, and are held in any case."""
    from repro_torch.models.model import Model

    name = cfg.name
    log(f"[model] {name}: {cfg.num_layers} layers ({cfg.first_k_dense} "
        f"dense), d {cfg.d_model}, {cfg.num_heads} heads, MLA ranks "
        f"{cfg.q_lora_rank}/{cfg.kv_lora_rank}, head dims "
        f"{cfg.qk_nope_head_dim}+{cfg.qk_rope_head_dim}/{cfg.v_head_dim}, "
        f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok} (cut from "
        f"256 so that the CPU's f32 copy stays near 13 GB), capacity factor "
        f"{cfg.capacity_factor}, {cfg.dtype}")
    gpu = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    routes = RouteCheck(gpu, cpu)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, length)))
    lg_g, st_g = gpu.forward(toks.to(device), collect_state=True)
    lg_c, st_c = cpu.forward(toks, collect_state=True)
    _close_rows(f"{name} forward", lg_g, lg_c, routes)
    for k in ("ckv", "kr"):
        _close(f"{name} forward latents {k}", st_g["mla"][k], st_c["mla"][k])

    same = "on the card"
    _, pre = gpu.forward(toks[:, :split].to(device), collect_state=True)
    lg_r, st_r = gpu.forward(toks[:, split:].to(device), q_offset=split,
                             prefix_state=pre, collect_state=True)
    routes.calls = {"card": [], "cpu": []}
    _close(f"{name} resume from the latents at {split} vs uninterrupted",
           lg_r, lg_g[:, split:], same)
    for k in ("ckv", "kr"):
        _close(f"{name} resumed latents {k} vs uninterrupted", st_r["mla"][k],
               st_g["mla"][k], same)

    runs = []
    for m, dev, st in ((gpu, device, st_g),
                       (cpu, torch.device("cpu"), st_c)):
        cache = m.init_cache(2, split + steps)
        for k in ("ckv", "kr"):
            cache["mla"][k][:, :, :split] = st["mla"][k][:, :, :split]
        runs.append((m, dev, cache))
    nxt = toks[:, split].to(torch.int32)
    pos = torch.full((2,), split, dtype=torch.int32)
    for i in range(steps):
        out = [m.decode_step(cache, nxt[:, None].to(dev), pos.to(dev))[:, 0]
               for m, dev, cache in runs]
        _close_rows(f"{name} decode_step {i} at position {split + i}",
                    out[0], out[1], routes)
        nxt = torch.argmax(out[1], dim=-1).to(torch.int32)
        pos = pos + 1
    del gpu, cpu


def phase_ring_model(cfg, device, *, seed=0, prompt_len=180, window=200,
                     steps=40) -> None:
    """A copy of ``cfg`` with ``sliding_window=window`` decoding past its
    ring's wrap, card against CPU: the prompt's ``forward`` state laid
    into a ``window``-slot ring (``init_cache``), then ``steps``
    ``decode_step``s, both devices fed the CPU's greedy tokens.  200
    slots are one page of 200 tokens to the paged-decode kernel
    (``attention._paged``), which must launch for every attention layer
    of every step on the card."""
    from repro_torch.kernels.paged_attention import paged_decode
    from repro_torch.models.cache import cache_len, n_attn_layers, quant_kvc
    from repro_torch.models.model import Model

    cfg = cfg.replace(sliding_window=window)
    name = f"{cfg.name} ring {window}" + (" int8" if cfg.kvc_dtype else "")
    seq_len = prompt_len + steps
    if cache_len(cfg, seq_len) != window or seq_len <= window:
        raise AssertionError(f"{name}: the steps never wrap a {window}-slot "
                             "ring")
    gpu = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, prompt_len)))
    runs = []
    for m, dev in ((gpu, device), (cpu, torch.device("cpu"))):
        lg, st = m.forward(toks.to(dev), collect_state=True)
        cache = m.init_cache(2, seq_len)
        for part, arrays in st.items():
            for k, t in arrays.items():
                dst = cache[part][k]
                if dst.dtype == torch.int8:      # as DenseRuntime lays it
                    t = quant_kvc(t)
                (dst[:, :, :prompt_len] if part == "kv" else dst).copy_(t)
        runs.append((m, dev, cache, lg))
    _close(f"{name} forward", runs[0][3], runs[1][3])
    nxt = torch.argmax(runs[1][3][:, -1], dim=-1).to(torch.int32)
    pos = torch.full((2,), prompt_len, dtype=torch.int32)
    worst = 0.0
    before = paged_decode.launches
    for i in range(steps):
        out = [m.decode_step(cache, nxt[:, None].to(dev), pos.to(dev))[:, 0]
               .float().cpu() for m, dev, cache, _ in runs]
        err = (out[0] - out[1]).abs()
        lim = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * out[1].abs()
        if not torch.isfinite(out[0]).all() or bool((err > lim).any()):
            raise AssertionError(f"{name}: decode_step at position "
                                 f"{prompt_len + i}, card vs CPU max abs err "
                                 f"{err.max().item():.3e}")
        worst = max(worst, err.max().item())
        nxt = torch.argmax(out[1], dim=-1).to(torch.int32)
        pos = pos + 1
    launched = paged_decode.launches - before
    if launched != steps * n_attn_layers(cfg):
        raise AssertionError(f"{name}: paged_decode launched {launched} "
                             f"times in {steps} steps")
    if cfg.kvc_dtype == "int8":
        for k in ("k", "v"):
            _int8_within_step(f"{name} {k} ring after {steps} steps",
                              runs[0][2]["kv"][k], runs[1][2]["kv"][k])
    log(f"[model] {name}: {steps} decode_steps over positions {prompt_len}-"
        f"{prompt_len + steps - 1} (the ring wraps at {window}), card vs "
        f"CPU max abs err {worst:.3e}; paged_decode launched {launched} "
        f"times over one page of {window}")


def _load_prefill(cache, state, prompt_len: int) -> None:
    """An encoder-decoder's decode cache filled from its prefill
    ``state``: the prompt's self K/V in the first ``prompt_len`` slots
    and the whole cross K/V."""
    for k in ("k", "v"):
        cache["kv"][k][:, :, :prompt_len] = state["kv"][k]
        cache["cross"][k].copy_(state["cross"][k])


def phase_encdec_model(cfg, device, *, seed=0, s_src=256, prompt_len=40,
                       steps=8) -> None:
    """An encoder-decoder on the card against the CPU: the encoder output
    of ``s_src`` seeded frames (two 128-token pages to the cross decode),
    ``forward`` logits with the collected self and cross K/V over a
    ``prompt_len``-token target, and ``steps`` ``decode_step``s from
    that prefill, both devices fed the CPU's greedy tokens.  On the card
    every step launches the paged-decode kernel twice per layer (self
    and cross) and the forward the dense prefill three times per decoder
    layer's worth (encoder, self, cross)."""
    from repro_torch.kernels.chunked_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import paged_decode
    from repro_torch.models.model import Model

    name = cfg.name
    log(f"[model] {name}: {cfg.num_encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}, {s_src} frames, {cfg.dtype}")
    gpu = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, prompt_len)))
    frames = torch.from_numpy(
        (rng.standard_normal((2, s_src, cfg.d_model)) * 0.5)
        .astype(np.float32))
    _close(f"{name} encoder output", gpu.encode(frames.to(device)),
           cpu.encode(frames))
    flash0, paged0 = flash_prefill.launches, paged_decode.launches
    runs = []
    for m, dev in ((gpu, device), (cpu, torch.device("cpu"))):
        lg, st = m.forward(toks.to(dev), frames=frames.to(dev),
                           collect_state=True)
        cache = m.init_cache(2, prompt_len + steps, src_len=s_src)
        _load_prefill(cache, st, prompt_len)
        runs.append((m, dev, cache, lg, st))
    _close(f"{name} forward", runs[0][3], runs[1][3])
    for part in ("kv", "cross"):
        for k in ("k", "v"):
            _close(f"{name} forward {part} {k}", runs[0][4][part][k],
                   runs[1][4][part][k])
    nxt = torch.argmax(runs[1][3][:, -1], dim=-1).to(torch.int32)
    pos = torch.full((2,), prompt_len, dtype=torch.int32)
    for i in range(steps):
        out = [m.decode_step(cache, nxt[:, None].to(dev), pos.to(dev))[:, 0]
               for m, dev, cache, _, _ in runs]
        _close(f"{name} decode_step {i} at position {prompt_len + i}",
               out[0], out[1])
        nxt = torch.argmax(out[1], dim=-1).to(torch.int32)
        pos = pos + 1
    flash = flash_prefill.launches - flash0
    paged = paged_decode.launches - paged0
    if (flash != cfg.num_encoder_layers + 2 * cfg.num_layers
            or paged != 2 * cfg.num_layers * steps):
        raise AssertionError(f"{name}: forward and {steps} steps launched "
                             f"flash_prefill {flash} and paged_decode "
                             f"{paged} times")
    log(f"[model] {name}: forward launched flash_prefill {flash} times, "
        f"{steps} decode_steps paged_decode {paged} times")
    del gpu, cpu


# ---------------------------------------------------------------------------
# phase 4, training: TinyLlama's widths at 2 layers, card against CPU
# ---------------------------------------------------------------------------

TRAIN_OPT = dict(lr=3e-4, warmup_steps=5, total_steps=30)


def loss_and_grads(model, batch, remat=None):
    """``train_loss`` over ``batch`` and every parameter's gradient (the
    parameters require grad; nothing is updated)."""
    for p in model.parameters():
        p.grad = None
    loss, metrics = model.train_loss(batch, remat=remat)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.detach(), metrics, grads


def train_launches(cfg, steps: int) -> dict:
    """The kernel launches of ``steps`` training steps of ``cfg``: each
    attention call runs the dense prefill (with its LSE) and its backward
    once, each SSD layer the scan and its backward once."""
    want = dict.fromkeys(KERNELS, 0)
    if cfg.arch_type in ("ssm", "hybrid"):
        attn = sum(cfg.is_attn_layer(l) for l in range(cfg.num_layers))
        want.update(ssd_chunk_scan=cfg.num_layers * steps,
                    ssd_chunk_scan_bwd=cfg.num_layers * steps,
                    flash_prefill=attn * steps,
                    flash_prefill_bwd=attn * steps)
    else:
        want.update(flash_prefill=cfg.num_layers * steps,
                    flash_prefill_bwd=cfg.num_layers * steps)
    return want


def phase_train_model(cfg, device, *, seed=0, batch=2, seq=256,
                      steps=3) -> dict:
    """Training at full width, few layers, f32, card against CPU, on
    ``SyntheticLM`` batches: ``train_loss`` (atol 1e-5) and every
    parameter's gradient (``MODEL_TOL``), then ``steps``
    ``make_train_step`` steps (AdamW, ``TRAIN_OPT``) and the parameters
    after them (``MODEL_TOL``: the most an element can part by on AdamW's
    sign-sensitive first updates, twice the summed learning rates, is
    below its atol).  The backward kernels must launch as
    ``train_launches`` says; one step's loss and gradients under
    ``remat="full"`` must equal those without it (bitwise or within
    1e-6).  Returns the launch counts of the card's steps."""
    from repro_torch.models.model import Model
    from repro_torch.training import (
        AdamWConfig,
        DataConfig,
        SyntheticLM,
        TrainConfig,
        init_opt_state,
        make_train_step,
    )
    from repro_torch.training.loop import to_device, trainable

    name = cfg.name
    gpu = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                batch_size=batch, seed=seed)).batches()
    batches = [next(it) for _ in range(steps)]
    log(f"[train] {name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"{cfg.dtype}; SyntheticLM B{batch} x S{seq}")
    trainable(gpu)
    trainable(cpu)
    lg, mg, gg = loss_and_grads(gpu, to_device(batches[0], device))
    lc, mc, gc_ = loss_and_grads(cpu, to_device(batches[0], "cpu"))
    loss_err = abs(lg.item() - lc.item())
    if not np.isfinite(lg.item()) or loss_err > 1e-5:
        raise AssertionError(f"{name}: train_loss card {lg.item():.6f} vs "
                             f"CPU {lc.item():.6f}")
    log(f"[train] {name}: train_loss card {lg.item():.6f} vs CPU "
        f"{lc.item():.6f} (abs err {loss_err:.2e}); ce {mg['ce'].item():.6f}")
    worst = 0.0
    for n in gc_:
        got, want = gg[n].float().cpu(), gc_[n]
        err = (got - want).abs()
        lim = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * want.abs()
        if not torch.isfinite(got).all() or bool((err > lim).any()):
            raise AssertionError(f"{name} grad {n}: card vs CPU max abs err "
                                 f"{err.max().item():.3e}")
        worst = max(worst, err.max().item())
    log(f"[train] {name}: all {len(gc_)} gradients card vs CPU max abs err "
        f"{worst:.3e} (MODEL_TOL {MODEL_TOL})")

    # one step's loss and gradients under full recomputation
    lr_, _, gr = loss_and_grads(gpu, to_device(batches[0], device),
                                remat="full")
    remat_err = max((gr[n] - gg[n]).abs().max().item() for n in gg)
    if abs(lr_.item() - lg.item()) > 1e-6 or remat_err > 1e-6:
        raise AssertionError(f"{name}: remat='full' loss {lr_.item()} vs "
                             f"{lg.item()}, gradients {remat_err:.3e}")
    bitwise = lr_.item() == lg.item() and remat_err == 0.0
    log(f"[train] {name}: remat='full' loss and gradients "
        f"{'bitwise equal' if bitwise else f'within {remat_err:.1e}'}")
    del gg, gc_, gr

    tcfg = TrainConfig(opt=AdamWConfig(**TRAIN_OPT))
    runs = []
    for m, dev in ((gpu, device), (cpu, torch.device("cpu"))):
        runs.append((m, dev, make_train_step(m, tcfg),
                     init_opt_state(trainable(m))))

    def card_steps():
        m, dev, step, state = runs[0]
        return [step(state, to_device(bt, dev)) for bt in batches]

    g_metrics, counts = counted(card_steps)
    m, dev, step, state = runs[1]
    c_metrics = [step(state, to_device(bt, dev)) for bt in batches]
    for i, (a, b_) in enumerate(zip(g_metrics, c_metrics)):
        log(f"[train] {name} step {i}: loss card {a['loss'].item():.6f} CPU "
            f"{b_['loss'].item():.6f}; grad_norm card "
            f"{a['grad_norm'].item():.6f} CPU {b_['grad_norm'].item():.6f}")
    worst = 0.0
    for (n, p), (_, q) in zip(gpu.named_parameters(), cpu.named_parameters()):
        got, want = p.detach().float().cpu(), q.detach()
        err = (got - want).abs()
        lim = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * want.abs()
        if not torch.isfinite(got).all() or bool((err > lim).any()):
            raise AssertionError(f"{name} after {steps} steps, {n}: card vs "
                                 f"CPU max abs err {err.max().item():.3e}")
        worst = max(worst, err.max().item())
    want = train_launches(cfg, steps)
    if counts != want:
        raise AssertionError(f"{name}: {steps} steps launched {counts}, "
                             f"want {want}")
    log(f"[train] {name}: {steps} AdamW steps, parameters card vs CPU max "
        f"abs err {worst:.3e}; launches {counts}")
    del gpu, cpu, runs
    return counts


# ---------------------------------------------------------------------------
# phase 12: train full TinyLlama, mamba2-1.3b and zamba2-1.2b
# ---------------------------------------------------------------------------

class Replay:
    """A dataset whose ``batches()`` yields ``batches`` in order: the
    ``SyntheticLM`` batches drawn before the run, so that the host's
    Python draw is timed apart from the steps."""

    def __init__(self, batches):
        self._batches = batches

    def batches(self):
        yield from self._batches


def ssd_fwd_flops(b, l, chunk, h, p, g, n, with_init=False) -> int:
    """The forward scan's products (``ssd_case``'s count): C.B^T once per
    group and chunk, the intra-chunk product per head over the causal
    triangle, the off-diagonal term where the incoming state is not
    zero, the state update for every token."""
    nc = l // chunk
    tri = chunk * (chunk + 1) // 2
    warm = nc if with_init else nc - 1
    return (2 * b * nc * tri * (g * n + h * p)
            + 2 * b * h * p * n * (warm * chunk + l))


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 per matmul weight and token
    (forward and backward; the embedding table is a gather, the
    unembedding a matmul), and the attention products: 2 in the forward
    and 5 in the backward, 2 x head_dim FLOPs per visible (query, key)
    pair and head.  An SSD layer's weights are its five input projections
    and ``out_proj`` (the depthwise convs are left out), and its scan
    counts the forward's and the backward's products on this data
    (``ssd_fwd_flops``, ``ssd_bwd_flops``); the hybrid's shared attention
    block counts once per call."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn_w = d * (h + 2 * hkv) * hd + h * hd * d
    pairs = batch * h * seq * (seq + 1) // 2
    if cfg.arch_type not in ("ssm", "hybrid"):
        per_layer = attn_w + 3 * d * cfg.d_ff
        matmul = cfg.num_layers * per_layer + d * cfg.vocab_size
        return 6 * matmul * batch * seq + cfg.num_layers * 14 * hd * pairs
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    sh, sp, q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_chunk
    calls = sum(cfg.is_attn_layer(l) for l in range(cfg.num_layers))
    per_layer = d * (2 * di + 2 * g * n + sh) + di * d
    matmul = cfg.num_layers * per_layer + calls * attn_w + d * cfg.vocab_size
    scan = (ssd_fwd_flops(batch, seq, q, sh, sp, g, n)
            + ssd_bwd_flops(batch, seq, q, sh, sp, g, n, False, False))
    return (6 * matmul * batch * seq + cfg.num_layers * scan
            + calls * 14 * hd * pairs)


# Phase 12's measured rows by model, read by phase 16.
TRAIN_ROWS: dict = {}
# Phase 12's runs: (arch, steps, full checks).  The full checks (bitwise
# step-0 gradients, a traced step, peak memory with and without remat, a
# checkpoint round trip) run for TinyLlama and mamba2-1.3b; zamba2-1.2b
# trains and is counted.
TRAIN_RUNS = (("skymemory-tinyllama", 30, True),
              ("mamba2-1.3b", 30, True),
              ("zamba2-1.2b", 10, False))
# The checkpoint round trip's models, each with whether its AdamW moments
# go too.  mamba2-1.3b's moments (~11.6 GB of the ~14.5 GB of npz, 70 s of
# I/O on a slow host) stay out: its parameters hold the SSM family's names
# through save and load, and TinyLlama's moments the moments' code.
CHECKPOINT_RUNS = {"skymemory-tinyllama": True, "mamba2-1.3b": False}


def _trace_shares(prof, traced_ms: float) -> dict:
    """Device ms of the traced step by kernel family: K4's forward
    (``prefill_*``) and backward (``bwd_*``), K5's forward (``ssd_tc``,
    the FMA body's two kernels) and backward (``ssd_bwd_*``), each with
    its share of the busy time."""
    busy = _busy_ms(prof)
    fam = dict.fromkeys(("flash_prefill", "flash_prefill_bwd",
                         "ssd_chunk_scan", "ssd_chunk_scan_bwd"), 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = (e.time_range.end - e.time_range.start) / 1e3
        if "ssd_bwd_" in e.name:
            fam["ssd_chunk_scan_bwd"] += dur
        elif any(k in e.name for k in ("ssd_tc", "ssd_scan_kernel",
                                       "ssd_cb_kernel")):
            fam["ssd_chunk_scan"] += dur
        elif "prefill_tc" in e.name or "prefill_fma" in e.name:
            fam["flash_prefill"] += dur
        elif "bwd_" in e.name:
            fam["flash_prefill_bwd"] += dur
    out = dict(traced_step_ms=traced_ms, device_busy_ms=busy,
               idle_share=None if not busy else 1 - busy / traced_ms)
    for k, v in fam.items():
        out[f"{k}_ms"] = v
        out[f"{k}_share"] = None if not busy else v / busy
    out["top_device_kernels"] = _top_kernels(prof, 1, k=8)
    return out


def phase_train(device, arch: str, *, steps=30, batch=4, seq=2048,
                full=True) -> dict:
    """Full ``arch`` (bf16 parameters, f32 AdamW moments, seeded random
    weights) trained ``steps`` AdamW steps (``TRAIN_OPT``)
    through ``train()`` on ``SyntheticLM(vocab of the model, seq 2048,
    batch 4, seed 0)``.  The launch counts are zeroed just before the run
    and read just after and must be ``train_launches``' (every forward
    goes through ``ops.FlashAttention`` and ``ops.SSDScan``), nothing
    else.  The last ``ce`` must be below the first, and every value
    finite.  Prints the median step (steps 5 on), tokens/s, model FLOPs
    and their share of 989 TFLOP/s.  With ``full``: before the run, step
    0's gradients twice from the same state must be bitwise equal; after
    it, a traced step (K4's and K5's forward and backward shares), the
    peak memory of a forward and backward with and without
    ``remat="full"``, and a checkpoint round trip that must give
    bitwise-equal parameters and moments and the same logits.  Returns
    the launch counts of the run."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.training import (
        AdamWConfig,
        DataConfig,
        SyntheticLM,
        TrainConfig,
        init_opt_state,
        load_checkpoint,
        make_train_step,
        save_checkpoint,
        train,
    )
    from repro_torch.training.loop import to_device, trainable
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config(arch)
    name = cfg.name
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    model = _build_model(cfg, device, 0, tag="train")
    params = trainable(model)
    n_params = sum(p.numel() for p in params.values())
    it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                batch_size=batch, seed=0)).batches()
    t0 = time.perf_counter()
    batches = [next(it) for _ in range(steps)]
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    log(f"[train] {name}: {n_params:,} parameters ({cfg.dtype}), AdamW "
        f"moments float32, {TRAIN_OPT}; SyntheticLM "
        f"B{batch} x S{seq}: {host_ms:.1f} host ms per batch (drawn before "
        f"the run)")

    if full:
        # step 0 twice from the same state: bitwise-equal gradients
        b0 = to_device(batches[0], device)
        _, _, g1 = loss_and_grads(model, b0)
        _, _, g2 = loss_and_grads(model, b0)
        if not all(torch.equal(g1[n], g2[n]) for n in g1):
            raise AssertionError(f"{name}: step 0's gradients differ between "
                                 "two runs")
        log(f"[train] {name}: step 0's gradients bitwise equal over two runs")
        del g1, g2, b0

    tcfg = TrainConfig(opt=AdamWConfig(**TRAIN_OPT), log_every=1)
    sync(device)
    (model, state, hist), counts = counted(
        lambda: train(model, Replay(batches), tcfg, num_steps=steps))
    sync(device)
    for h in hist:
        if not all(np.isfinite(h[k]) for k in ("ce", "aux", "loss",
                                               "grad_norm", "lr")):
            raise AssertionError(f"{name}: step {h['step']} non-finite {h}")
    log(f"[train] {name}: loss curve (ce by step) "
        + " ".join(f"{h['ce']:.4f}" for h in hist))
    if not hist[-1]["ce"] < hist[0]["ce"]:
        raise AssertionError(f"{name}: ce {hist[0]['ce']} -> "
                             f"{hist[-1]['ce']} did not fall")
    want = train_launches(cfg, steps)
    if counts != want:
        raise AssertionError(f"{name}: {steps} steps launched {counts}, "
                             f"want {want}")
    ends = [h["elapsed_s"] for h in hist]
    step_s = [b_ - a for a, b_ in zip([0.0] + ends, ends)]
    med_ms = statistics.median(step_s[5:]) * 1e3
    flops = train_flops(cfg, batch, seq)
    peak_train = (torch.cuda.max_memory_allocated(device) - held) / 1e9
    row = dict(model=name, steps=steps, batch=batch, seq=seq,
               first_ce=hist[0]["ce"], last_ce=hist[-1]["ce"],
               step_ms_median_5_on=med_ms,
               step_ms_runs=[x * 1e3 for x in step_s],
               tokens_per_s=batch * seq / (med_ms / 1e3),
               model_tflop_per_step=flops / 1e12,
               peak_share=flops / (med_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
               host_ms_per_batch=host_ms, peak_memory_gb=peak_train,
               held_at_start_gb=held / 1e9, launches=counts)
    log(f"[train] run {json.dumps(row)}")
    TRAIN_ROWS[name] = row
    if not full:
        del model, state, params
        return counts

    # one more step, traced: the kernels' shares
    step_fn = make_train_step(model, tcfg)
    bt = to_device(batches[-1], device)
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, bt)
        sync(device)
        traced_ms = (time.perf_counter() - t0) * 1e3
    trace = _trace_shares(prof, traced_ms)
    log(f"[train] {name} traced step {json.dumps(trace)}")
    if trace["device_busy_ms"] is None:
        log("[train] the profiler trace holds no device events: the "
            "kernels' shares not measured")

    # peak memory of one step's forward and backward, with and without
    # full recomputation
    peaks = {}
    for r in (None, "full"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        loss_and_grads(model, bt, remat=r)
        sync(device)
        peaks[str(r)] = (torch.cuda.max_memory_allocated(device)
                         - base) / 1e9
    log(f"[train] {name}: peak memory of a forward and backward above the "
        f"weights and moments: {json.dumps(peaks)} GB (remat None, full)")
    # checkpoint round trip
    moments = CHECKPOINT_RUNS[arch]
    ckpt = ROOT / "build" / "train_checkpoint"
    t0 = time.perf_counter()
    done = int(state["step"])          # the run's steps and the traced one
    save_checkpoint(str(ckpt), model, state if moments else None, step=done,
                    metadata={"arch": name})
    save_s = time.perf_counter() - t0
    other = _build_model(cfg, device, 1, tag="train")
    other_state = (init_opt_state(dict(other.named_parameters()))
                   if moments else None)
    t0 = time.perf_counter()
    _, other_state, meta = load_checkpoint(str(ckpt), other, other_state)
    load_s = time.perf_counter() - t0
    shutil.rmtree(ckpt)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              other.named_parameters()):
        if not torch.equal(p, q):
            raise AssertionError(f"{name}: checkpoint changed {n}")
    if moments:
        for part in ("m", "v"):
            for n in state[part]:
                if not torch.equal(state[part][n], other_state[part][n]):
                    raise AssertionError(f"{name}: checkpoint changed "
                                         f"{part} {n}")
        if int(other_state["step"]) != done:
            raise AssertionError(f"{name}: checkpoint step "
                                 f"{int(other_state['step'])}")
    if meta["step"] != done:
        raise AssertionError(f"{name}: checkpoint step {meta}")
    probe = torch.from_numpy(batches[0]["tokens"][:1, :256]).to(device)
    with torch.no_grad():
        a = model(probe)[0]
        b_ = other(probe)[0]
    if not torch.equal(a, b_):
        raise AssertionError(f"{name}: the reloaded model's logits differ, "
                             f"max {(a - b_).abs().max().item():.3e}")
    what = "parameters, moments" if moments else "parameters"
    log(f"[train] {name}: checkpoint round trip bitwise ({what}, "
        f"step {meta['step']}), reloaded logits equal; save "
        f"{save_s:.1f} s, load {load_s:.1f} s")
    del model, other, state, other_state, params
    return counts


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


# the serving kernels, and every kernel (training adds the backwards of
# the dense prefill and of the SSD scan)
SERVE_KERNELS = ("paged_decode", "chunked_prefill_paged", "flash_prefill",
                 "ssd_chunk_scan")
KERNELS = SERVE_KERNELS + ("flash_prefill_bwd", "ssd_chunk_scan_bwd")


def kernel_fns():
    from repro_torch.kernels.chunked_prefill import (
        chunked_prefill_paged,
        flash_prefill,
    )
    from repro_torch.kernels.flash_backward import flash_prefill_bwd
    from repro_torch.kernels.paged_attention import paged_decode
    from repro_torch.kernels.ssd_backward import ssd_chunk_scan_bwd
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan

    return {"paged_decode": paged_decode,
            "chunked_prefill_paged": chunked_prefill_paged,
            "flash_prefill": flash_prefill,
            "ssd_chunk_scan": ssd_chunk_scan,
            "flash_prefill_bwd": flash_prefill_bwd,
            "ssd_chunk_scan_bwd": ssd_chunk_scan_bwd}


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
               restores=s.restores, replayed_tokens=s.replayed_tokens,
               prompt_tokens=res[0].prompt_tokens,
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


# eager steps in a decode step's CUPTI trace: reading the trace back
# costs the host far more than the steps themselves, and 5 steps give the
# busy ms a step that 20 give
TRACE_STEPS = 5


def time_step(step, device, *, iters=20, repeats=5) -> dict:
    """Where one decode step's time goes: the eager step's host wall time
    (``repeats`` runs of ``iters`` steps: the host clock is noisy), the
    device's busy time in a CUPTI trace (``torch.profiler``) of
    ``TRACE_STEPS`` eager steps and the idle share it leaves, and the
    same step replayed from a CUDA graph (its device time without host
    launch gaps)."""
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
        for _ in range(TRACE_STEPS):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / TRACE_STEPS * 1e3
    busy = _busy_ms(prof)
    busy_ms = None if busy is None else busy / TRACE_STEPS

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
                top_device_kernels=_top_kernels(prof, TRACE_STEPS))


def traced_spans(step, module, names: tuple, *,
                 iters: int = TRACE_STEPS) -> dict:
    """Device ms per step of the kernels launched under each function
    ``names`` of ``module``: each is wrapped, for one ``torch.profiler``
    trace of ``iters`` steps, in a ``record_function`` range of its name,
    and the range's device time is that of the kernels launched under it.
    A trace of its own: the ranges never enter ``time_step``'s busy
    time.  None where the trace attributes no device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = {n: getattr(module, n) for n in names}

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    for n, fn in saved.items():
        setattr(module, n, ranged(n, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)
    out = {}
    for n in names:
        evs = [e for e in prof.events() if e.name == n
               and e.device_type == torch.autograd.DeviceType.CPU]
        us = sum(e.device_time_total for e in evs)
        out[f"{n}_device_ms"] = us / 1e3 / iters if us else None
        out[f"{n}_calls"] = len(evs) / iters
    return out


def paged_step(model, device, *, batch, length, max_seq_len, page):
    """A paged model's decode step over a seeded contiguous pool of
    ``batch`` slots at ``length`` tokens each: ``(step, cache, lengths,
    generator)``."""
    cfg = model.cfg
    cache = model.init_paged_cache(num_slots=batch, page_size=page,
                                   max_seq_len=max_seq_len)
    gen = torch.Generator(device=device).manual_seed(1)
    for pool in (cache.k_pool, cache.v_pool):
        if cache.dtype == torch.int8:  # within +-1, as N(0, 1) mostly is
            pool.random_(-32, 33, generator=gen)
        else:
            pool.normal_(generator=gen)
    toks = torch.randint(3, cfg.vocab_size, (batch, 1), device=device,
                         generator=gen, dtype=torch.int32)
    lens = torch.full((batch,), length, dtype=torch.int32, device=device)

    def step():
        return model.decode_step_paged(cache.k_pool, cache.v_pool, toks,
                                       None, lens, contiguous=True)

    return step, cache, lens, gen


def eager_in_turns(steps: dict, device, *, rounds=2, iters=10,
                   repeats=2) -> dict:
    """Host wall ms of eager decode steps of each entry of ``steps``,
    timed in turns (a, b, b, a per round) so that a change in the host's
    load falls on both: per name, the median of each turn's ``repeats``
    runs of ``iters`` steps."""
    names = list(steps)
    order = (names + names[::-1]) * rounds
    out = {n: [] for n in names}
    for n in names:
        for _ in range(3):
            steps[n]()
    for n in order:
        runs = []
        for _ in range(repeats):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                steps[n]()
            torch.cuda.synchronize(device)
            runs.append((time.perf_counter() - t0) / iters * 1e3)
        out[n].append(statistics.median(runs))
    return out


def step_breakdown(model, device, *, batch=4, length=384, max_seq_len=1024,
                   page=128) -> dict:
    """A paged model's decode step at the serving shape (``time_step``),
    and the attention kernel's share of the graph-replayed step (one
    launch per layer).  Over an int8 pool, also the device time of the
    dequantize before each K1 launch and of the quantize of each new
    row (``traced_spans``), their shares of the traced busy time, and
    the dequantize of every layer's two pools timed alone.  Runs after
    the main path's launch counts were read."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels.paged_attention import paged_decode
    from repro_torch.models.cache import dequant_kvc
    from repro_torch.models.layers import torch_dtype

    cfg = model.cfg
    dt = torch_dtype(cfg.dtype)
    step, cache, lens, gen = paged_step(model, device, batch=batch,
                                        length=length,
                                        max_seq_len=max_seq_len, page=page)
    int8 = cache.dtype == torch.int8
    row = dict(batch=batch, length=length, pool=str(cache.dtype),
               pool_bytes=nbytes(cache.k_pool, cache.v_pool),
               **time_step(step, device))
    shape = (batch, max_seq_len // page, page, cfg.num_kv_heads,
             cfg.head_dim)
    q = torch.randn(batch, cfg.num_heads, cfg.head_dim,
                    device=device, generator=gen).to(dt)
    k, v = cache.k_pool[0].reshape(shape), cache.v_pool[0].reshape(shape)
    if int8:
        k, v = dequant_kvc(k, dt), dequant_kvc(v, dt)
    timer = Timer(device)
    attn_ms = timer.ms(lambda: paged_decode(q, k, v, lens + 1))
    row.update(paged_decode_ms=attn_ms,
               attention_share_of_graph_step=cfg.num_layers * attn_ms
               / row["graph_step_ms"])
    if int8:
        busy = row["traced_device_busy_ms"]
        spans = traced_spans(step, attention, ("dequant_kvc", "quant_kvc"))
        alone = timer.ms(lambda: [dequant_kvc(p[l], dt)
                                  for p in (cache.k_pool, cache.v_pool)
                                  for l in range(cfg.num_layers)])
        row.update(**spans, dequant_all_layers_alone_ms=alone, **{
            f"{n}_share_of_busy": (None if busy is None
                                   or spans[f"{n}_device_ms"] is None
                                   else spans[f"{n}_device_ms"] / busy)
            for n in ("dequant_kvc", "quant_kvc")})
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


def ssm_step_breakdown(model, device, *, batch=4, length=384,
                       max_seq_len=1024) -> dict:
    """A dense-cache model's decode step (SSM, hybrid or MLA) at the
    serving batch (``time_step``) over a cache of random states, every
    row at position ``length``.  mamba2's step runs no hand-written
    kernel: the single-token recurrence is plain PyTorch, as in the
    reference, and so is deepseek-v3's absorbed MLA decode.  The
    hybrid's shared block decodes over its dense K/V cache through the
    paged-decode kernel, whose share of the graph-replayed step is
    printed (one launch per shared-block call, timed alone with a cold
    L2).  Runs after the main path's launch counts were read."""
    from repro_torch.models.attention import _paged
    from repro_torch.models.cache import n_attn_layers

    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(1)
    cache = model.init_cache(batch, max_seq_len)
    for part in cache.values():
        for t in part.values():
            t.normal_(generator=gen)
    toks = torch.randint(3, cfg.vocab_size, (batch, 1), device=device,
                         generator=gen, dtype=torch.int32)
    pos = torch.full((batch,), length, dtype=torch.int32, device=device)
    row = dict(model=cfg.name, batch=batch, length=length, **time_step(
        lambda: model.decode_step(cache, toks, pos), device))
    if "kv" in cache:
        k, v = cache["kv"]["k"][0], cache["kv"]["v"][0]
        q = torch.randn(batch, cfg.num_heads, cfg.head_dim, device=device,
                        generator=gen).to(k.dtype)
        attn_ms = Timer(device).ms(lambda: _paged(q, k, v, pos + 1))
        row.update(paged_decode_ms=attn_ms,
                   attention_share_of_graph_step=n_attn_layers(cfg) * attn_ms
                   / row["graph_step_ms"])
    log(f"[step] {json.dumps(row)}")
    return row


def ssm_prefill(model, device, *, length=384):
    """One SSM or hybrid request's prefill: ``Model.forward`` over ``length``
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


def _time_prefill(prefill, what: str) -> dict:
    """A prefill's eager host wall time (5 runs) and its device time
    replayed from a CUDA graph; ``prefill`` has run outside capture."""
    eager = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) * 1e3)
    return dict(eager_prefill_ms=statistics.median(eager),
                eager_prefill_ms_runs=eager,
                graph_prefill_ms=graph_replay_ms(prefill, what, iters=5))


def ssm_prefill_breakdown(model, device, *, length=384) -> dict:
    """``ssm_prefill``: its eager host wall time, the forward replayed
    from a CUDA graph, and the SSD scan's share of the replay (one launch
    per layer, timed alone at the prefill's shape with a cold L2); for
    the hybrid also the dense prefill's share (one launch per
    shared-block call).  Runs after the main path's launch counts were
    read."""
    from repro_torch.kernels.ssd_scan import ssd_body
    from repro_torch.models.layers import torch_dtype

    cfg = model.cfg
    prefill, scan, chunk = ssm_prefill(model, device, length=length)
    times = _time_prefill(prefill, f"{cfg.name} prefill")
    graph_ms = times["graph_prefill_ms"]
    timer = Timer(device)
    scan_ms = timer.ms(scan)
    row = dict(model=cfg.name, tokens=length, chunk=chunk,
               body=ssd_body(torch_dtype(cfg.dtype)), **times,
               ssd_chunk_scan_ms=scan_ms,
               ssd_chunk_scan_share_of_graph_prefill=(
                   cfg.num_layers * scan_ms / graph_ms))
    if cfg.arch_type == "hybrid":
        # the shared block's dense prefill, one launch per call
        from repro_torch.models.cache import n_attn_layers

        gen = torch.Generator(device=device).manual_seed(4)
        args, _, _ = flash_case(gen, torch_dtype(cfg.dtype), device, b=1,
                                sq=length, skv=length, off=0,
                                h=cfg.num_heads, hkv=cfg.num_kv_heads,
                                d=cfg.head_dim, dv=cfg.head_dim)
        k4_ms = timer.ms(run_flash(args)[0])
        row.update(flash_prefill_ms=k4_ms,
                   flash_prefill_share_of_graph_prefill=(
                       n_attn_layers(cfg) * k4_ms / graph_ms))
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
    bf16_step = step_breakdown(model, device, max_seq_len=max_seq_len,
                               page=block_size, batch=max_batch)
    wave_breakdown(model, device, rows=max_batch, chunk=256, context=384,
                   max_seq_len=max_seq_len, page=block_size)
    t1 = time.perf_counter()
    int8_counts = serve_int8_pool(model, streams, bf16_step, common=common,
                                  free_list_pages=free_list_pages)
    for k in KERNELS:
        counts[k] += int8_counts[k]
    log(f"[int8] {time.perf_counter() - t1:.1f} s")
    return counts, model


def watch_host_tier(eng, seen: dict) -> None:
    """Wrap the engine's moves through the host tier (L1): the pages of
    every entry put there (as ``export_pages`` gave them) are kept; every
    ``write_pages`` of such pages (the restore of a running victim, or
    the reseed of a prefilling one, which re-enters as a fresh admission
    and is not counted in ``restores``) is read back with
    ``export_pages`` and compared bitwise.  Counts into ``seen``:
    ``offloaded``, ``returned``, ``bitwise``, and the ``dtypes`` seen."""
    host, pool = eng.kv.host, eng.kv.pool
    put, write = host.put, pool.write_pages
    kept = {}

    def watched_put(key, entry):
        put(key, entry)
        kept[id(entry.k)] = entry
        seen["offloaded"] += 1
        seen["dtypes"].add(str(entry.k.dtype))

    def watched_write(slot, first_page, k_blocks, v_blocks):
        write(slot, first_page, k_blocks, v_blocks)
        entry = kept.pop(id(k_blocks), None)
        if entry is not None:
            k, v = pool.export_pages(slot, first_page + k_blocks.shape[1])
            seen["returned"] += 1
            seen["bitwise"] += (torch.equal(k[:, first_page:], entry.k)
                                and torch.equal(v[:, first_page:], entry.v))

    host.put, pool.write_pages = watched_put, watched_write


def serve_int8_pool(model, bf16_streams: dict, bf16_step: dict, *,
                    common: dict, free_list_pages: int) -> dict:
    """Phase 5's three modes again, the same weights over an int8 K/V
    page pool (``with_int8_pool``): the launch counts zeroed just before
    and read just after; K1 (contiguous pool), K2 (block tables, the
    free-list pool), K3 and K4 must launch; the free-list pool must
    preempt, restore every victim from the host tier with its int8 pages
    bitwise and replay nothing.  The streams equal to the bf16 pool's
    are counted, not held (quantization changes tokens).  Then the
    decode step over the int8 pool beside the bf16 pool's."""
    from repro_torch.serving import Engine

    m8 = with_int8_pool(model)
    fns = zero_launches()
    rows = {}
    tier = dict(offloaded=0, returned=0, bitwise=0, dtypes=set())
    for label, kw in (("chunked-contiguous", {}),
                      ("stop-the-world", {"chunk_tokens": 0}),
                      ("free-list-preempt", {"num_pages": free_list_pages})):
        eng = Engine(m8, **{k: v for k, v in common.items()
                            if k not in ("n_requests", "max_new")}, **kw)
        if eng.cache.k_pool.dtype != torch.int8:
            raise AssertionError(f"int8 {label}: the pool is "
                                 f"{eng.cache.k_pool.dtype}")
        if "num_pages" in kw:
            watch_host_tier(eng, tier)
        row, res = run_pass(eng, f"int8 {label}", tag="int8",
                            n_requests=common["n_requests"],
                            max_new=common["max_new"])
        rows[label] = row
        same = sum(r.token_ids == b
                   for r, b in zip(res, bf16_streams[label]))
        log(f"[int8] {label}: {same}/{len(res)} greedy streams equal to the "
            "bf16 pool's (counted, not held: quantization changes tokens)")
    counts = {k: f.launches for k, f in fns.items()}
    log(f"[int8] launches over the three modes: {counts}")
    _require_launched(counts, ("paged_decode", "chunked_prefill_paged",
                               "flash_prefill"))
    for label, kernel, what in (
            ("chunked-contiguous", "paged_decode", "K1 (contiguous pool)"),
            ("free-list-preempt", "paged_decode", "K2 (block tables)"),
            ("chunked-contiguous", "chunked_prefill_paged", "K3"),
            ("stop-the-world", "flash_prefill", "K4")):
        if rows[label]["launches"][kernel] <= 0:
            raise AssertionError(f"int8 {label}: {what} never launched")
    fl = rows["free-list-preempt"]
    if not (fl["preemptions"] > 0 and fl["replayed_tokens"] == 0
            and 0 < fl["restores"] <= fl["preemptions"]):
        raise AssertionError(f"int8 free-list: preemptions "
                             f"{fl['preemptions']}, restores "
                             f"{fl['restores']}, replayed "
                             f"{fl['replayed_tokens']}")
    if not (0 < tier["offloaded"] == tier["returned"] == tier["bitwise"]
            and tier["dtypes"] == {"torch.int8"}):
        raise AssertionError(f"int8 free-list: the host tier's pages did "
                             f"not all come back bitwise int8: {tier}")
    log(f"[int8] free-list: {fl['preemptions']} preemptions, "
        f"{fl['restores']} restores of running victims, "
        f"{tier['offloaded']} page sets offloaded as int8 and "
        f"{tier['bitwise']} written back bitwise equal to export_pages' "
        f"at the offload, {fl['replayed_tokens']} tokens replayed")
    step = step_breakdown(m8, model.device, batch=common["max_batch"],
                          max_seq_len=common["max_seq_len"],
                          page=common["block_size"])
    keys = ("pool_bytes", "eager_step_ms", "traced_device_busy_ms",
            "graph_step_ms", "paged_decode_ms")
    side = dict(model=model.cfg.name, batch=step["batch"],
                length=step["length"],
                **{f"{k}_bf16": bf16_step[k] for k in keys},
                **{f"{k}_int8": step[k] for k in keys},
                dequant_kvc_share_of_busy=step["dequant_kvc_share_of_busy"],
                quant_kvc_share_of_busy=step["quant_kvc_share_of_busy"])
    shape = dict(batch=common["max_batch"], length=384,
                 max_seq_len=common["max_seq_len"], page=common["block_size"])
    turns = eager_in_turns({"bf16": paged_step(model, model.device,
                                               **shape)[0],
                            "int8": paged_step(m8, model.device, **shape)[0]},
                           model.device)
    side.update(eager_step_ms_in_turns=turns)
    log(f"[int8] step {json.dumps(side)}")
    del m8
    return counts


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
    _require_launched(counts, ("ssd_chunk_scan",)
                      if model.cfg.arch_type in ("ssm", "hybrid")
                      else ("flash_prefill",))
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


def _first_diff(got: list, want: list) -> list:
    """Per stream pair, the index of the first token that differs (None
    where one stream is a prefix of the other)."""
    return [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            for a, b in zip(got, want)]


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
    """Full TinyLlama (over a bf16 and over an int8 K/V page pool) and
    full mamba2-1.3b served from the port's constellation; returns each
    run's warm-pass launch counts."""
    from repro_torch.serving import Engine

    common = dict(n_requests=n_requests, max_new=max_new)
    kw = dict(block_size=block_size, max_seq_len=max_seq_len,
              max_batch=max_batch, device=device)
    out = {}
    paged = ("chunked_prefill_paged", "paged_decode")
    for model, name, path in (
            (tiny, tiny.cfg.name, paged),
            (with_int8_pool(tiny), f"{tiny.cfg.name} int8 pool", paged),
            (mamba, mamba.cfg.name, ("ssd_chunk_scan",))):
        t1 = time.perf_counter()
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
        first_diff = _first_diff([r.token_ids for r in res],
                                 [r.token_ids for r in cold_res])
        log(f"[fabric] {name}: {same}/{len(res)} warm greedy streams equal "
            f"the kvc=None streams (first differing token {first_diff}); "
            f"{cold_same}/{len(res)} of a second kvc=None pass do")
        log(f"[fabric] {json.dumps(warm_vs_cold(name, row, cold))}")
        check_fabric_bytes(name, eng, kvc, **common)
        if not eng.paged:
            resume_drift(model, eng, kvc, **common)
        out[name] = counts
        if model.cfg.kvc_dtype == "int8":
            # hits quantized into the pool by write_pages; no clocked run
            if eng.cache.k_pool.dtype != torch.int8:
                raise AssertionError(f"{name}: the pool is "
                                     f"{eng.cache.k_pool.dtype}")
            log(f"[fabric] {name} {time.perf_counter() - t1:.1f} s")
            del eng
            continue
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
    _require_launched(total, SERVE_KERNELS)
    log(f"[cluster] main-path launches: {total}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 8: the other paged families at full width
# ---------------------------------------------------------------------------

def _build_model(cfg, device, seed: int, tag: str = "families"):
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    model = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(seed))
    sync(device)
    n = sum(p.numel() for p in model.parameters())
    moe = (f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok} of "
           f"width {cfg.expert_d_ff}, " if cfg.num_experts else "")
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, {moe}"
        f"{n / 1e9:.2f} B parameters ({cfg.dtype}), KV "
        f"{cfg.kv_cache_bytes_per_token()} B per token, init "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def serve_moe(cfg, device, *, seed, n_requests, max_new, prefix,
              free_list_pages, **kw) -> dict:
    """Full granite-moe-3b-a800m: stop-the-world admission (exact
    per-sequence prefill), cold; warm from the paper's fabric (every
    request restores the prefix, the suffix runs as one paged chunk);
    then a free-list pool small enough to preempt, whose pinned host-tier
    restores replay nothing and leave the cold streams unchanged; last,
    one decode step's breakdown."""
    from repro_torch.serving import Engine

    name = cfg.name
    model = _build_model(cfg, device, seed)
    common = dict(n_requests=n_requests, max_new=max_new)
    serve_mode(model, f"{name} warm-up", device=device,
               **{**common, "n_requests": 2}, **kw)
    kw = dict(kw, device=device)
    total = dict.fromkeys(KERNELS, 0)

    cold_eng = Engine(model, **kw)
    if cold_eng.chunked:
        raise AssertionError(f"{name}: a MoE engine admitted in chunks")
    (cold, cold_res), counts = counted(lambda: run_pass(
        cold_eng, f"{name} kvc=None", tag="families", **common))
    log(f"[families] {name} kvc=None launches: {counts}")
    _require_launched(counts, ("flash_prefill", "paged_decode"))
    add_counts(total, counts)
    del cold_eng

    kvc = paper_kvc()
    row, res, eng, counts = fill_and_hit(model, name, kvc, **common, **kw)
    if eng.chunked:
        raise AssertionError(f"{name}: a MoE engine admitted in chunks")
    log(f"[families] {name} warm-pass launches: {counts}")
    fabric_report(name, kvc)
    # the warm pass hits every prefix and writes nothing back (each
    # prompt's blocks past the prefix are partial), so its prefill is the
    # paged suffix chunk; the dense prefill ran in pass 1 and cold
    _require_warm(name, row, res, cold, counts,
                  ("chunked_prefill_paged", "paged_decode"), prefix)
    add_counts(total, counts)
    log(f"[families] {json.dumps(warm_vs_cold(name, row, cold))}")
    del eng

    pre_eng = Engine(model, num_pages=free_list_pages, **kw)
    (prow, pres), counts = counted(lambda: run_pass(
        pre_eng, f"{name} free-list-preempt", tag="families", **common))
    log(f"[families] {name} free-list-preempt launches: {counts}; "
        f"preemptions {prow['preemptions']}, restores {prow['restores']}, "
        f"replayed tokens {pre_eng.stats.replayed_tokens}")
    if prow["preemptions"] <= 0:
        raise AssertionError(f"{name}: the free-list pool did not preempt")
    if pre_eng.stats.replayed_tokens != 0:
        raise AssertionError(f"{name}: a MoE restore replayed "
                             f"{pre_eng.stats.replayed_tokens} tokens")
    want = [r.token_ids for r in cold_res]
    got = [r.token_ids for r in pres]
    if got != want:
        same = sum(a == b for a, b in zip(got, want))
        raise AssertionError(f"{name}: {same}/{len(want)} preempted streams "
                             "equal the unconstrained engine's")
    log(f"[families] {name}: {len(got)}/{len(want)} preempted greedy "
        "streams equal the unconstrained engine's")
    _require_launched(counts, ("flash_prefill", "paged_decode"))
    add_counts(total, counts)
    del pre_eng
    step_breakdown(model, device, max_seq_len=kw["max_seq_len"],
                   page=kw["block_size"], batch=kw["max_batch"])
    del model
    return total


def serve_wide_heads(cfg, device, *, seed, n_requests, max_new,
                     **kw) -> dict:
    """Full stablelm-12b (head_dim 160): chunked admission (the paged
    prefill at D 160) and stop-the-world admission (the dense prefill at
    D 160), both on the tensor-core body, then one decode step's
    breakdown."""
    from repro_torch.kernels.chunked_prefill import prefill_body
    from repro_torch.models.layers import torch_dtype

    name = cfg.name
    model = _build_model(cfg, device, seed)
    common = dict(n_requests=n_requests, max_new=max_new, **kw)
    serve_mode(model, f"{name} warm-up", device=device,
               **{**common, "n_requests": 2})
    total = dict.fromkeys(KERNELS, 0)
    body = prefill_body(torch_dtype(cfg.dtype), cfg.head_dim, cfg.head_dim)
    for label, extra, prefill in (
            ("chunked", {}, "chunked_prefill_paged"),
            ("stop-the-world", {"chunk_tokens": 0}, "flash_prefill")):
        _, counts = counted(lambda: serve_mode(
            model, f"{name} {label}", device=device, **common, **extra))
        log(f"[families] {name} {label} launches: {counts}; {prefill} ran "
            f"the {body} body (head_dim {cfg.head_dim}, {cfg.dtype})")
        if body != "tensor-core":
            raise AssertionError(f"{name}: {prefill} ran the {body} body")
        _require_launched(counts, (prefill, "paged_decode"))
        add_counts(total, counts)
    step_breakdown(model, device, max_seq_len=kw["max_seq_len"],
                   page=kw["block_size"], batch=kw["max_batch"])
    del model
    return total


def phase_families(device, *, n_requests=8, max_new=32, max_seq_len=1024,
                   max_batch=4, block_size=128, free_list_pages=10,
                   prefix=256) -> dict:
    """Full granite-moe-3b-a800m and full stablelm-12b (bf16, seeded
    random weights) behind the paged engine, one after the other; returns
    the launch counts of their main-path runs."""
    from repro_torch.configs import get_config

    kw = dict(block_size=block_size, max_seq_len=max_seq_len,
              max_batch=max_batch)
    total = dict.fromkeys(KERNELS, 0)
    add_counts(total, serve_moe(
        get_config("granite-moe-3b-a800m"), device, seed=0,
        n_requests=n_requests, max_new=max_new, prefix=prefix,
        free_list_pages=free_list_pages, **kw))
    torch.cuda.empty_cache()
    add_counts(total, serve_wide_heads(
        get_config("stablelm-12b"), device, seed=0, n_requests=n_requests,
        max_new=max_new, **kw))
    torch.cuda.empty_cache()
    log(f"[families] main-path launches: {total}")
    return total


# ---------------------------------------------------------------------------
# phase 9: the hybrid, zamba2-1.2b, through the dense runtime
# ---------------------------------------------------------------------------

def ring_pass(model, device, cold_res, *, window, n_requests, max_new,
              **kw) -> dict:
    """The same weights with ``sliding_window=window``: every sequence
    decodes over a ``window``-slot ring and runs past its wrap.  Each
    stream must equal the cold one up to the token that first comes from
    a position at or past ``window`` (a token ``t`` of an ``n``-token
    prompt comes from position ``n - 1 + t``).  Returns the launch
    counts of the pass."""
    from repro_torch.models.cache import cache_len
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine

    cfg = model.cfg.replace(sliding_window=window)
    ring = Model(cfg, device=device)
    ring.load_state_dict(model.state_dict())
    if cache_len(cfg, kw["max_seq_len"]) != window:
        raise AssertionError(f"{cfg.name}: no {window}-slot ring")
    eng = Engine(ring, device=device, **kw)
    (row, res), counts = counted(lambda: run_pass(
        eng, f"{cfg.name} ring {window}", tag="hybrid",
        n_requests=n_requests, max_new=max_new))
    _require_launched(counts, ("paged_decode",))
    checked = []
    for r, c in zip(res, cold_res):
        n = r.prompt_tokens
        if n + len(r.token_ids) - 2 < window:
            raise AssertionError(f"{cfg.name} ring: a {n}-token request "
                                 "never decoded past the ring's wrap")
        k = min(len(c.token_ids), window + 1 - n)
        if r.token_ids[:k] != c.token_ids[:k]:
            raise AssertionError(
                f"{cfg.name} ring: a {n}-token stream parts from the cold "
                f"one before position {window} (first differing token "
                f"{_first_diff([r.token_ids[:k]], [c.token_ids[:k]])})")
        checked.append(k)
    after = _first_diff([r.token_ids[k:] for r, k in zip(res, checked)],
                        [c.token_ids[k:] for c, k in zip(cold_res, checked)])
    log(f"[hybrid] ring {window}: {len(res)}/{len(res)} streams wrap and "
        f"equal the cold streams over their first {checked} tokens (from "
        f"positions < {window}); past the wrap the first differing token "
        f"is {after} tokens later; launches {counts}")
    del eng, ring
    return counts


def phase_hybrid(device, *, n_requests=8, max_new=32, max_seq_len=1024,
                 max_batch=4, block_size=128, prefix=256,
                 window=384) -> dict:
    """Full zamba2-1.2b (38 SSD layers, the shared attention block after
    every 6th, bf16, seeded random weights) behind ``Engine``, which
    serves it through the dense runtime: cold; twice through
    ``Engine(kvc=...)`` on the paper's 19x5 fabric (the warm pass must
    restore the 256-token prefix of every request, every stored block
    must equal a fresh ``kvc_fn``, and the warm streams must equal the
    cold ones); a ring pass (``ring_pass``); then one decode step's and
    one 384-token prefill's breakdown.  Returns the launch counts of the
    cold, warm and ring passes."""
    from repro_torch.configs import get_config
    from repro_torch.models.cache import n_attn_layers
    from repro_torch.serving import Engine

    cfg = get_config("zamba2-1.2b")
    model = _build_model(cfg, device, 0)
    name = cfg.name
    path = ("ssd_chunk_scan", "flash_prefill", "paged_decode")
    common = dict(n_requests=n_requests, max_new=max_new)
    kw = dict(block_size=block_size, max_seq_len=max_seq_len,
              max_batch=max_batch, device=device)
    log(f"[hybrid] {name}: state {cfg.ssm_state}, {n_attn_layers(cfg)} "
        f"shared-attention calls (period {cfg.attn_layer_period}), "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}")
    serve_mode(model, f"{name} warm-up", **{**common, "n_requests": 2},
               **kw)
    total = dict.fromkeys(KERNELS, 0)

    cold_eng = Engine(model, **kw)
    if cold_eng.paged:
        raise AssertionError(f"{name}: a hybrid engine took the paged path")
    (cold, cold_res), counts = counted(lambda: run_pass(
        cold_eng, f"{name} kvc=None", tag="hybrid", **common))
    log(f"[hybrid] {name} kvc=None launches: {counts}")
    _require_launched(counts, path)
    add_counts(total, counts)
    del cold_eng

    kvc = paper_kvc()
    row, res, eng, counts = fill_and_hit(model, name, kvc, **common, **kw)
    log(f"[hybrid] {name} warm-pass launches: {counts}")
    fabric_report(name, kvc)
    _require_warm(name, row, res, cold, counts, path, prefix)
    add_counts(total, counts)
    want = [r.token_ids for r in cold_res]
    got = [r.token_ids for r in res]
    if got != want:
        raise AssertionError(
            f"{name}: {sum(a == b for a, b in zip(got, want))}/{len(want)} "
            f"warm greedy streams equal the cold ones (first differing "
            f"token {_first_diff(got, want)})")
    log(f"[hybrid] {name}: {len(got)}/{len(want)} warm greedy streams equal "
        "the kvc=None streams")
    log(f"[hybrid] {json.dumps(warm_vs_cold(name, row, cold))}")
    check_fabric_bytes(name, eng, kvc, **common)
    resume_drift(model, eng, kvc, **common)
    del eng

    add_counts(total, ring_pass(model, device, cold_res, window=window,
                                n_requests=n_requests,
                                max_new=max_new + 8,
                                **{k: v for k, v in kw.items()
                                   if k != "device"}))
    _require_launched(total, path)
    ssm_step_breakdown(model, device, batch=max_batch, max_seq_len=max_seq_len)
    ssm_prefill_breakdown(model, device)
    del model
    log(f"[hybrid] main-path launches: {total}")
    return total


# ---------------------------------------------------------------------------
# phase 10: MLA, deepseek-v3-671b, through the dense runtime
# ---------------------------------------------------------------------------

# bf16 last-position logits of two prefills of the same prompt that
# differ only in how the prefix's latents were computed (in blocks of 128
# by the write-back, or in one forward) or in the GEMM shapes of the
# suffix (113 rows against 369): each op rounds its output to bf16 (a
# step of 2^-8 of its size), four layers deep, on logits of size ~1-5
BF16_LOGIT_TOL = dict(atol=5e-2, rtol=2e-2)


class LastTokenRoutes:
    """Forward hooks on every MoE layer of ``model`` that record, per
    call, the experts the call's last token keeps (its top-k choices
    that found a slot under the group's capacity)."""

    def __init__(self, model):
        from repro_torch.models.moe import moe_keep

        self.kept = []

        def record(mod, inputs, _):
            x = inputs[0]
            keep = moe_keep(mod, x, mod.cfg)                 # [G, g, E]
            last = x.shape[0] * x.shape[1] - 1
            g = keep.shape[1]
            self.kept.append(
                keep[last // g, last % g].nonzero().flatten().tolist())

        self.handles = [blk.moe.register_forward_hook(record)
                        for blk in model.blocks if blk.is_moe]

    def take(self) -> list:
        out, self.kept = self.kept, []
        return out

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _logit_ratio(got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    lim = BF16_LOGIT_TOL["atol"] + BF16_LOGIT_TOL["rtol"] * want.abs()
    return err.max().item(), (err / lim).max().item()


def mla_warm_logits(model, eng, kvc, *, n_requests, max_new) -> dict:
    """For every request, the last-position logits of three bf16
    prefills on the card: cold (``forward`` over the whole prompt), warm
    (the suffix over the latents the fabric restores, at ``q_offset``
    256, as the engine ran it) and split (the suffix over latents that a
    cold ``forward`` of the same 256 tokens computed on the card).  Warm
    and split run the suffix's MoE layer in the same group, so warm must
    lie within ``BF16_LOGIT_TOL`` of split for every request.  Warm runs
    it in another group than cold (capacity routing depends on the
    group, as in the reference), so warm is held to cold where the last
    token keeps the same experts in both and only measured where it does
    not."""
    from repro_torch.core import chain_hashes

    bs = eng.block_size
    routes = LastTokenRoutes(model)
    rows = []
    for r in make_requests(n_requests, max_new):
        toks = eng.tokenizer.encode(r.prompt)
        n = (len(toks) - 1) // bs * bs        # the engine's lookup
        h = chain_hashes(toks, bs)[n // bs - 1]
        prefix = eng.adapter.payload_to_state(kvc.get_block(h))
        t = torch.as_tensor(toks, dtype=torch.int32, device=model.device)[None]
        with torch.no_grad():
            cold = model.forward(t)[0][0, -1]
            cold_kept = routes.take()
            warm = model.forward(t[:, n:], q_offset=n,
                                 prefix_state=prefix)[0][0, -1]
            warm_kept = routes.take()
            _, pre = model.forward(t[:, :n], collect_state=True)
            routes.take()
            split = model.forward(t[:, n:], q_offset=n,
                                  prefix_state=pre)[0][0, -1]
            routes.take()
        s_err, s_ratio = _logit_ratio(warm, split)
        c_err, c_ratio = _logit_ratio(warm, cold)
        same_routes = warm_kept == cold_kept
        rows.append(dict(
            tokens=len(toks), restored=n,
            warm_vs_split_max_abs=s_err, warm_vs_split_x_limit=s_ratio,
            warm_equals_split=bool(torch.equal(warm, split)),
            warm_vs_cold_max_abs=c_err, warm_vs_cold_x_limit=c_ratio,
            last_token_kept_experts_cold=[len(k) for k in cold_kept],
            last_token_kept_experts_warm=[len(k) for k in warm_kept],
            same_routes=same_routes,
            argmax_equal=int(warm.argmax()) == int(cold.argmax())))
    routes.remove()
    log(f"[mla] warm prefill logits (bf16, limit {BF16_LOGIT_TOL}): "
        f"{json.dumps(rows)}")
    bad = [i for i, row in enumerate(rows)
           if row["warm_vs_split_x_limit"] > 1.0
           or (row["same_routes"] and row["warm_vs_cold_x_limit"] > 1.0)]
    if bad:
        raise AssertionError(f"{model.cfg.name}: the warm prefill's last "
                             f"logits leave the bf16 limit for requests "
                             f"{bad}")
    held = sum(row["same_routes"] for row in rows)
    log(f"[mla] warm last-position logits within the bf16 limit of the "
        f"split prefill's for {len(rows)}/{len(rows)} requests, and of the "
        f"cold prefill's for the {held} whose last token keeps the same "
        f"experts cold and warm; the other {len(rows) - held} differ from "
        f"it by at most "
        f"""{max([r['warm_vs_cold_max_abs'] for r in rows
                  if not r['same_routes']] + [0.0]):.3e}""")
    return dict(rows=rows, held_to_cold=held)


def mla_prefill_breakdown(model, device, *, length=384) -> dict:
    """One request's prefill (``Model.forward`` over ``length`` tokens
    with the latents collected, as ``DenseRuntime._prefill_one`` calls
    it): its eager host wall time, the forward replayed from a CUDA graph,
    and the dense prefill kernel's share of the replay (one launch per
    layer, timed alone at the prefill's shape with a cold L2).  Runs after
    the main path's launch counts were read."""
    from repro_torch.kernels.chunked_prefill import prefill_body
    from repro_torch.models.layers import torch_dtype

    cfg = model.cfg
    dt = torch_dtype(cfg.dtype)
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    gen = torch.Generator(device=device).manual_seed(3)
    toks = torch.randint(3, cfg.vocab_size, (1, length), device=device,
                         generator=gen, dtype=torch.int32)

    def prefill():
        return model.forward(toks, collect_state=True)[0]

    prefill()
    times = _time_prefill(prefill, f"{cfg.name} prefill")
    args, _, _ = flash_case(gen, dt, device, b=1, sq=length, skv=length,
                            off=0, h=cfg.num_heads, hkv=cfg.num_heads, d=dq,
                            dv=cfg.v_head_dim)
    k4_ms = Timer(device).ms(run_flash(args)[0])
    row = dict(model=cfg.name, tokens=length,
               body=prefill_body(dt, dq, cfg.v_head_dim), **times,
               flash_prefill_ms=k4_ms,
               flash_prefill_share_of_graph_prefill=(
                   cfg.num_layers * k4_ms / times["graph_prefill_ms"]))
    log(f"[prefill] {json.dumps(row)}")
    return row


def phase_mla(device, *, n_requests=8, max_new=32, max_seq_len=1024,
              max_batch=4, block_size=128, prefix=256,
              num_layers=4) -> dict:
    """deepseek-v3-671b at its published widths, cut to ``num_layers``
    layers (its 3 dense layers and one MoE layer; bf16, seeded random
    weights) behind ``Engine``, which serves MLA through the dense
    runtime: cold; twice through ``Engine(kvc=...)`` on the paper's 19x5
    fabric (the warm pass must restore the 256-token prefix of every
    request, every stored block must equal a fresh ``kvc_fn``, and the
    warm prefill's logits are held to the cold ones, ``mla_warm_logits``);
    then one decode step's breakdown, against the bytes of the weights a
    step reads, and one 384-token prefill's.  The dense prefill (on the
    tensor-core body at Dq 192 / Dv 128) must launch in both passes; the
    absorbed decode launches no kernel.  Returns the launch counts of the
    cold and warm passes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.chunked_prefill import prefill_body
    from repro_torch.models.layers import torch_dtype
    from repro_torch.serving import Engine

    full = get_config("deepseek-v3-671b")
    cfg = full.replace(num_layers=num_layers, mtp_depth=0)
    name = cfg.name
    log(f"[mla] {name}: reduced: num_layers {full.num_layers} -> "
        f"{num_layers} ({cfg.first_k_dense} dense layers and "
        f"{num_layers - cfg.first_k_dense} MoE layer of {cfg.num_experts} "
        f"experts top-{cfg.num_experts_per_tok} and "
        f"{cfg.num_shared_experts} shared), the multi-token-prediction "
        f"head not built (mtp_depth 1 -> 0: training only, serving never "
        f"reads it); every width as published")
    body = prefill_body(torch_dtype(cfg.dtype),
                        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                        cfg.v_head_dim)
    if body != "tensor-core":
        raise AssertionError(f"{name}: the MLA prefill runs the {body} body")
    model = _build_model(cfg, device, 0)
    path = ("flash_prefill",)
    common = dict(n_requests=n_requests, max_new=max_new)
    kw = dict(block_size=block_size, max_seq_len=max_seq_len,
              max_batch=max_batch, device=device)
    serve_mode(model, f"{name} warm-up", **{**common, "n_requests": 2},
               **kw)
    total = dict.fromkeys(KERNELS, 0)

    cold_eng = Engine(model, **kw)
    if cold_eng.paged:
        raise AssertionError(f"{name}: an MLA engine took the paged path")
    (cold, cold_res), counts = counted(lambda: run_pass(
        cold_eng, f"{name} kvc=None", tag="mla", **common))
    log(f"[mla] {name} kvc=None launches: {counts}; flash_prefill ran the "
        f"{body} body (Dq 192, Dv 128, {cfg.dtype})")
    _require_launched(counts, path)
    add_counts(total, counts)
    del cold_eng

    kvc = paper_kvc()
    row, res, eng, counts = fill_and_hit(model, name, kvc, **common, **kw)
    log(f"[mla] {name} warm-pass launches: {counts}; flash_prefill ran the "
        f"{body} body")
    fabric_report(name, kvc)
    _require_warm(name, row, res, cold, counts, path, prefix)
    add_counts(total, counts)
    want = [r.token_ids for r in cold_res]
    got = [r.token_ids for r in res]
    log(f"[mla] {name}: {sum(a == b for a, b in zip(got, want))}/"
        f"{len(want)} warm greedy streams equal the kvc=None streams (first "
        f"differing token {_first_diff(got, want)})")
    log(f"[mla] {json.dumps(warm_vs_cold(name, row, cold))}")
    log(f"[mla] {name}: payload {eng.adapter.payload_bytes_per_token()} B "
        f"per token ((kv_lora_rank {cfg.kv_lora_rank} + qk_rope_head_dim "
        f"{cfg.qk_rope_head_dim}) x {num_layers} layers x 2 B)")
    check_fabric_bytes(name, eng, kvc, **common)
    mla_warm_logits(model, eng, kvc, **common)
    del eng

    step = ssm_step_breakdown(model, device, batch=max_batch,
                              max_seq_len=max_seq_len)
    # a decode step reads every weight but the embedding table (B rows of
    # it) and the batch's latent cache
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    tok = model.embed.tok
    read = (weights - tok.numel() * tok.element_size()
            + max_batch * cfg.d_model * tok.element_size()
            + max_batch * max_seq_len * num_layers
            * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2)
    bound = read / HBM_BYTES_PER_S * 1e3
    log(f"[mla] decode step bound: {read / 1e9:.2f} GB read (every weight, "
        f"all {cfg.num_experts} experts: the eager MoE step multiplies "
        f"every expert's capacity buffer) -> {bound:.3f} ms at 3.35 TB/s; "
        f"graph-replayed step {step['graph_step_ms']:.3f} ms = "
        f"{step['graph_step_ms'] / bound:.2f} x the bound")
    mla_prefill_breakdown(model, device)
    del model
    log(f"[mla] main-path launches: {total}")
    return total


# ---------------------------------------------------------------------------
# phase 11: the encoder-decoder, seamless-m4t-large-v2
# ---------------------------------------------------------------------------

def phase_seamless(device, *, batch=4, s_src=500, prompt_len=32,
                   steps=32) -> dict:
    """Full seamless-m4t-large-v2 (24 encoder and 24 decoder layers,
    bf16, seeded random weights; no engine serves the family, as in the
    reference): ``batch`` utterances of ``s_src`` seeded frames (x 0.5,
    as ``tests/test_arch_smoke.py`` draws them) and ``prompt_len``-token
    target prompts through ``forward(frames=, collect_state=True)``,
    the self cache from ``init_cache(batch, prompt_len + steps,
    src_len=s_src)``, then ``steps`` greedy ``decode_step``s.  The launch
    counts are zeroed just before that run and read just after: the
    dense prefill must launch 3 times per decoder layer's worth
    (encoder, self, cross) in the forward, the paged decode twice per
    layer and step (self, cross), nothing else.  Every step's logits are
    held to a teacher-forced ``forward`` over the prompt and the
    generated tokens at ``BF16_LOGIT_TOL``; the greedy token must equal
    the forward's argmax except where the forward's top-2 margin lies
    inside that limit (a near-tie, counted).  Then the encoder alone
    replayed from a CUDA graph with the dense prefill's share, a decode
    step's breakdown (``time_step``) against the bytes it must read with
    the paged decode's share, and the peak memory.  Returns the launch
    counts of the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.chunked_prefill import prefill_body
    from repro_torch.models.attention import _paged
    from repro_torch.models.layers import torch_dtype

    cfg = get_config("seamless-m4t-large-v2")
    name = cfg.name
    dt = torch_dtype(cfg.dtype)
    L = cfg.num_layers
    # the peak is taken above what earlier phases still hold
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    model = _build_model(cfg, device, 0, tag="seamless")
    log(f"[seamless] {name}: {cfg.num_encoder_layers} encoder + {L} decoder "
        f"layers, {cfg.param_count():,} parameters (ModelConfig), every "
        f"width as published (no cut); {batch} utterances of {s_src} "
        f"frames, {prompt_len}-token prompts, {steps} greedy steps; K4 body "
        f"{prefill_body(dt, cfg.head_dim, cfg.head_dim)}")
    gen = torch.Generator(device=device).manual_seed(21)
    frames = torch.randn(batch, s_src, cfg.d_model, generator=gen,
                         device=device) * 0.5
    toks = torch.randint(3, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device, dtype=torch.int32)

    def run():
        logits, state = model.forward(toks, frames=frames,
                                      collect_state=True)
        fwd = {k: f.launches for k, f in kernel_fns().items()}
        cache = model.init_cache(batch, prompt_len + steps, src_len=s_src)
        _load_prefill(cache, state, prompt_len)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
        out, step_logits = [nxt], []
        pos = torch.full((batch,), prompt_len, dtype=torch.int32,
                         device=device)
        for _ in range(steps):
            lg = model.decode_step(cache, nxt[:, None], pos)[:, 0]
            step_logits.append(lg)
            nxt = lg.argmax(-1).to(torch.int32)
            out.append(nxt)
            pos = pos + 1
        sync(device)
        return fwd, cache, torch.stack(out, 1), torch.stack(step_logits, 1)

    t0 = time.perf_counter()
    (fwd, cache, gen_toks, step_logits), counts = counted(run)
    run_s = time.perf_counter() - t0
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_prefill=cfg.num_encoder_layers + 2 * L,
                paged_decode=2 * L * steps)
    if fwd["flash_prefill"] != want["flash_prefill"] or counts != want:
        raise AssertionError(f"{name}: launches {counts} (the forward's "
                             f"{fwd}), want {want}")
    log(f"[seamless] {name}: forward + {steps} decode steps in {run_s:.2f} s "
        f"(eager, first run); launches {counts}: flash_prefill "
        f"{fwd['flash_prefill']} per forward, paged_decode {2 * L} per step")

    # teacher-forced: one forward over the prompt and the fed tokens
    full = torch.cat([toks, gen_toks[:, :steps]], 1)
    ref = model.forward(full, frames=frames)[0][:, prompt_len:].float()
    got = step_logits.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite decode logits")
    err = (got - ref).abs()
    lim = BF16_LOGIT_TOL["atol"] + BF16_LOGIT_TOL["rtol"] * ref.abs()
    worst = (err / lim).max().item()
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    tie = margin <= (BF16_LOGIT_TOL["atol"]
                     + BF16_LOGIT_TOL["rtol"] * top2[..., 0].abs())
    differ = gen_toks[:, 1:] != ref.argmax(-1)
    log(f"[seamless] {name}: {steps} decode steps x {batch} rows vs a "
        f"teacher-forced forward: max abs err {err.max().item():.3e} "
        f"({worst:.4f} x the bf16 limit {BF16_LOGIT_TOL}; "
        f"{int((err > lim / 2).sum())} of {err.numel()} logits past half "
        f"of it); argmax differs "
        f"at {int(differ.sum())} of {differ.numel()} positions, near-ties "
        f"(top-2 margin inside the limit) {int(tie.sum())}")
    if worst > 1.0 or bool((differ & ~tie).any()):
        raise AssertionError(f"{name}: the decode steps leave the "
                             "teacher-forced forward")
    del ref, got, err, lim

    # the encoder alone, and K4's share of it
    def encode():
        return model.encode(frames)

    encode()
    enc_ms = graph_replay_ms(encode, f"{name} encoder", iters=5)
    args, n_bytes, flops = flash_case(gen, dt, device, b=batch, sq=s_src,
                                      skv=s_src, off=0, causal=False,
                                      h=cfg.num_heads, hkv=cfg.num_kv_heads,
                                      d=cfg.head_dim, dv=cfg.head_dim)
    timer = Timer(device)
    k4_ms = timer.ms(run_flash(args)[0])
    enc = list(model.encoder.parameters())
    enc_flops = (2 * sum(p.numel() for p in enc) * batch * s_src
                 + cfg.num_encoder_layers * flops)
    # its weights and the frames read once, its output written once
    enc_bytes = (nbytes(*enc, frames)
                 + batch * s_src * cfg.d_model * model.embed.tok.element_size())
    enc_bound, enc_by = bound_ms(enc_bytes, enc_flops, dt)
    row = dict(model=name, batch=batch, frames=s_src,
               graph_encoder_ms=enc_ms, encoder_bound_ms=enc_bound,
               encoder_bound_by=enc_by, flash_prefill_ms=k4_ms,
               flash_prefill_share_of_graph_encoder=(
                   cfg.num_encoder_layers * k4_ms / enc_ms))
    log(f"[seamless] encoder {json.dumps(row)}")

    # one decode step at the last position, and K1's share of it
    step_toks = gen_toks[:, -1:].contiguous()
    step_pos = torch.full((batch,), prompt_len + steps - 1, dtype=torch.int32,
                          device=device)
    step = dict(model=name, batch=batch, frames=s_src,
                length=prompt_len + steps, **time_step(
                    lambda: model.decode_step(cache, step_toks, step_pos),
                    device))
    q = torch.randn(batch, cfg.num_heads, cfg.head_dim, generator=gen,
                    device=device).to(dt)
    src_lens = torch.full((batch,), s_src, dtype=torch.int32, device=device)
    self_ms = timer.ms(lambda: _paged(q, cache["kv"]["k"][0],
                                      cache["kv"]["v"][0], step_pos + 1))
    cross_ms = timer.ms(lambda: _paged(q, cache["cross"]["k"][0],
                                       cache["cross"]["v"][0], src_lens))
    # a step reads the decoder's weights (the cross blocks included, the
    # encoder's not), B rows of the embedding table, the self and cross
    # caches
    tok = model.embed.tok
    dec = (sum(p.numel() * p.element_size() for p in model.parameters())
           - sum(p.numel() * p.element_size()
                 for p in model.encoder.parameters())
           - tok.numel() * tok.element_size())
    read = (dec + batch * cfg.d_model * tok.element_size()
            + nbytes(*cache["kv"].values(), *cache["cross"].values()))
    step.update(bytes_read=read, step_bound_ms=read / HBM_BYTES_PER_S * 1e3,
                paged_decode_self_ms=self_ms, paged_decode_cross_ms=cross_ms,
                paged_decode_share_of_graph_step=(
                    L * (self_ms + cross_ms) / step["graph_step_ms"]),
                peak_memory_gb=(torch.cuda.max_memory_allocated(device)
                                - held) / 1e9,
                held_at_start_gb=held / 1e9)
    log(f"[seamless] step {json.dumps(step)}")
    del model, cache
    return counts


# ---------------------------------------------------------------------------
# phase 13: what a user runs -- the serving launcher, the paper's
# simulator, the torus exchange and the scale-out example
# ---------------------------------------------------------------------------

# each model the launcher serves, and the kernels its path must launch
LAUNCH_PATHS = {"skymemory-tinyllama": ("paged_decode",
                                        "chunked_prefill_paged",
                                        "flash_prefill"),
                "mamba2-1.3b": ("ssd_chunk_scan",)}
# an allowance for the full-width example (3.4-4.2 s on an H100 at 700 W
# over three runs, 3.6 s in a process of its own), and the run time by
# which it must end: where the allowance does not fit, the example runs
# at its reduced default width, and its line says so
EXAMPLE_FULL_S = 15.0
EXAMPLE_BY_S = 1100.0


def launch_run(argv: list, tag: str) -> tuple:
    """``repro_torch.launch.serve.main(argv)`` on the card as one
    main-path run; prints each round.  Returns what it served and the
    launch counts."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    served, counts = counted(lambda: serve.main(argv))
    dt = time.perf_counter() - t0
    res = served.results
    for i, r in enumerate(res):
        log(f"[launch] {tag} round {i}: wall {r.wall_time_s:.4f} s, ttft "
            f"{r.ttft_s:.4f} s, cached {r.cached_tokens}/{r.prompt_tokens} "
            f"tok, {len(r.token_ids)} new")
    same = sum(r.token_ids == res[0].token_ids for r in res[1:])
    log(f"[launch] {tag}: {same}/{len(res) - 1} later rounds' tokens equal "
        f"round 0's; {dt:.1f} s with the model's init; launches {counts}")
    return served, counts


def restore_witness(served, argv: list) -> dict:
    """Where a warm launcher round serves other tokens than the cold one,
    whether the restore is at fault.  A fresh engine without the fabric
    serves the cold round again on the same model (its tokens must equal
    round 0's) and keeps the prompt's K/V in its slot 0 pages (the only
    slot one request at a time takes).  The block read back from the
    fabric must be, bitwise, page 0 of the launcher's pool after its last
    (warm) round, and must sit closer to the cold page 0, layer by layer,
    than a wrong restore would: the cold page of the next layer, or the
    cold positions shifted by one.  The prompt's positions past the block
    are compared too (the warm round prefills them as a chunk of their
    own, the cold round in one chunk with the block), and the first
    position where the two pools differ is named.  Then, at the first
    token the last round served otherwise, the two candidates' logits in
    a full forward and in one resumed from the restored block: a near tie
    there is what rounding flips."""
    from repro_torch.core import chain_hashes
    from repro_torch.launch import serve
    from repro_torch.serving import Request, SamplingParams

    eng, kvc, res = served.engine, served.kvc, served.results
    model, bs = eng.model, eng.block_size
    args = serve.parse_args(argv)
    prompt = args.prompt * 4
    toks = eng.tokenizer.encode(prompt)
    n = len(toks)
    pages = -(-(n + args.max_new) // bs)
    diffs = _first_diff([r.token_ids for r in res[1:]],
                        [res[0].token_ids] * (len(res) - 1))
    # the launcher's pool holds its last round: the prompt, and the new
    # tokens fed back before the first that differs from round 0's, hold
    # the same tokens in both pools
    j = diffs[-1]
    same = n + (len(res[0].token_ids) - 1 if j is None else j)
    payload = kvc.get_block(chain_hashes(toks, bs)[0])
    k_r, v_r = (t.cpu().float() for t in
                eng.adapter.payload_to_pages(payload, bs, bs))
    k_w, v_w = (t.float() for t in eng.cache.export_pages(0, pages))
    if not (torch.equal(k_r, k_w[:, :1]) and torch.equal(v_r, v_w[:, :1])):
        raise AssertionError("the warm pool's page 0 is not the block the "
                             "fabric holds")
    cold_eng, _ = serve.build_engine(
        model, serve.parse_args([*argv, "--no-cache"]))
    sp = SamplingParams(temperature=args.temperature,
                        max_new_tokens=args.max_new)
    cold = cold_eng.generate([Request(prompt=prompt, sampling=sp)])[0]
    if cold.token_ids != res[0].token_ids:
        raise AssertionError("a second cold engine served other tokens "
                             "than round 0")
    k_c, v_c = (t.float() for t in cold_eng.cache.export_pages(0, pages))
    del cold_eng

    def per_layer(a, b):
        return (a - b).abs().flatten(1).amax(1)

    def rounded(x, digits=5):
        return [round(float(v), digits) for v in x]

    row = {"first_diff": diffs}
    for name, got, warm, cold_pages in (("k", k_r, k_w, k_c),
                                        ("v", v_r, v_w, v_c)):
        want = cold_pages[:, :1]
        d = per_layer(got, want)
        layer = per_layer(got[:-1], want[1:])
        shift = per_layer(got[:, :, 1:], want[:, :, :-1])
        scale = want.abs().flatten(1).amax(1)
        suffix = per_layer(warm.flatten(1, 2)[:, bs:n],
                           cold_pages.flatten(1, 2)[:, bs:n])
        row[name] = dict(
            restored_max_abs_diff=rounded(d),
            layer_max_abs=rounded(scale, 3),
            rel_restored_max=float((d / scale).max()),
            rel_next_layer_min=float((layer / scale[1:]).min()),
            rel_shift_min=float((shift / scale).min()),
            suffix_max_abs_diff=rounded(suffix),
            first_differing_position=next(
                (i for i, x in enumerate(
                    (warm.flatten(1, 2)[:, :same]
                     - cold_pages.flatten(1, 2)[:, :same]).abs()
                    .amax((0, 2, 3))) if x > 0), None))
        r = row[name]
        if not 4 * r["rel_restored_max"] < min(r["rel_next_layer_min"],
                                               r["rel_shift_min"]):
            raise AssertionError(f"restored {name} is no closer to the cold "
                                 f"page than a wrong layer or offset: {r}")
        log(f"[launch] witness {name}: restored block vs the cold round's "
            f"page 0, max abs diff per layer {r['restored_max_abs_diff']} "
            f"of per-layer max |{name}| {r['layer_max_abs']}; relative: "
            f"restored <= {r['rel_restored_max']:.5f}, next layer >= "
            f"{r['rel_next_layer_min']:.3f}, shifted by one >= "
            f"{r['rel_shift_min']:.3f}; positions {bs}-{n - 1}, warm pool "
            f"vs cold, max abs diff per layer {r['suffix_max_abs_diff']}; "
            f"the first of positions 0-{same - 1} where the pools differ: "
            f"{r['first_differing_position']}")
    if j is not None:
        c, w = res[0].token_ids[j], res[-1].token_ids[j]
        ctx = torch.as_tensor(toks + res[0].token_ids[:j], dtype=torch.int32,
                              device=model.device)[None]
        with torch.no_grad():
            full = model.forward(ctx)[0][0, -1]
            resumed = model.forward(
                ctx[:, bs:], q_offset=bs,
                prefix_state=eng.adapter.payload_to_state(payload))[0][0, -1]
        for tag, lg in (("full", full.float()), ("resumed", resumed.float())):
            top = torch.topk(lg, 2)
            row[tag] = dict(
                cold_token=c, warm_token=w,
                cold_minus_warm=float(lg[c] - lg[w]),
                top2=[int(i) for i in top.indices],
                top2_gap=float(top.values[0] - top.values[1]),
                logit_max_abs=float(lg.abs().max()))
        log(f"[launch] witness at new token {j} (cold {c}, warm {w}): full "
            f"{model.cfg.dtype} forward {json.dumps(row['full'])}; resumed "
            f"from the restored block {json.dumps(row['resumed'])}")
    return row


def phase_launch() -> dict:
    """``python -m repro_torch.launch.serve`` as a user runs it on the card
    (default device, full width, bf16, 19x5 fabric): full TinyLlama and
    full mamba2-1.3b 3 rounds each, then TinyLlama with ``--no-cache``.
    Round 0 is cold, every later round restores whole 128-token blocks
    from the fabric; without the cache no round restores anything."""
    total = {k: 0 for k in KERNELS}
    for arch, path in LAUNCH_PATHS.items():
        argv = ["--arch", arch, "--repeat", "3", "--max-new", "16"]
        served, counts = launch_run(argv, arch)
        cached = [r.cached_tokens for r in served.results]
        if cached[0] != 0 or any(c <= 0 or c % 128 for c in cached[1:]):
            raise AssertionError(f"{arch}: cached tokens per round {cached}")
        st = served.kvc.stats
        log(f"[launch] {arch}: fabric hits {st.block_hits}, sets "
            f"{st.blocks_set}, messages {served.kvc.transport.stats.messages}")
        if st.block_hits <= 0:
            raise AssertionError(f"{arch}: no block hit")
        _require_launched(counts, path)
        if served.engine.paged:
            restore_witness(served, argv)
        add_counts(total, counts)
        del served
        gc.collect()
        torch.cuda.empty_cache()
    served, counts = launch_run(
        ["--repeat", "3", "--max-new", "16", "--no-cache"],
        "skymemory-tinyllama --no-cache")
    if served.kvc is not None or any(r.cached_tokens
                                     for r in served.results):
        raise AssertionError("--no-cache restored tokens")
    _require_launched(counts, ("paged_decode", "chunked_prefill_paged"))
    add_counts(total, counts)
    del served
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_sim() -> None:
    """The ported simulator on the host against the paper's claims, as
    ``tests/test_simulator.py`` holds the reference's: rotation+hop lowest
    at every altitude and server count of the Fig-16 sweep, ~90% less
    latency from 9 to 81 servers, latency growing with altitude; Figs 1-2's
    one-hop latency falling with M and growing with h, and ~50+
    satellites a plane reaching the SSD-HDD band."""
    from repro_torch.core.simulator import (
        MEMORY_HIERARCHY_S,
        intra_plane_latency_s,
        isl_latency_grid,
        memory_tier_for_latency,
        required_sats_per_plane_for,
        sweep,
    )

    t0 = time.perf_counter()
    rows = sweep()
    grid = isl_latency_grid()
    dt = time.perf_counter() - t0
    by = {}
    for r in rows:
        by.setdefault((r.num_servers, r.altitude_km), {})[r.strategy] = (
            r.worst_latency_s)
    losses = [k for k, v in by.items()
              if v["rotation_hop"] > min(v["rotation"], v["hop"])]
    if len(rows) != 48 or losses:
        raise AssertionError(f"rotation+hop not lowest at {losses}")
    alts = sorted({h for _, h in by})
    cut = {h: 1.0 - by[(81, h)]["rotation_hop"] / by[(9, h)]["rotation_hop"]
           for h in alts}
    if not 0.80 <= cut[550.0] <= 0.95:
        raise AssertionError(f"9 -> 81 servers cut {cut[550.0]:.3f}")
    rh81 = [by[(81, h)]["rotation_hop"] for h in alts]
    if rh81 != sorted(rh81) or len(set(rh81)) != len(rh81):
        raise AssertionError(f"latency does not grow with altitude: {rh81}")
    lat = {(m, h): v for m, h, v in grid}
    ms, hs = sorted({m for m, _ in lat}), sorted({h for _, h in lat})
    if not all(lat[(a, h)] > lat[(b, h)] for h in hs
               for a, b in zip(ms, ms[1:])) or not all(
            lat[(m, a)] < lat[(m, b)] for m in ms for a, b in zip(hs, hs[1:])):
        raise AssertionError("Figs 1-2: latency not monotone in M and h")
    m = required_sats_per_plane_for(2e-3, altitude_km=550.0)
    if not (40 <= m <= 110
            and intra_plane_latency_s(m, 550.0) <= MEMORY_HIERARCHY_S["HDD"][0]):
        raise AssertionError(f"{m} sats a plane for 2 ms")
    log(f"[sim] Fig 16: rotation+hop lowest at all {len(by)} (servers, "
        f"altitude) points; 9 -> 81 servers cut its latency "
        + ", ".join(f"{c * 100:.1f}% at {h:.0f} km" for h, c in cut.items())
        + "; at 81 servers "
        + ", ".join(f"{v * 1e3:.1f} ms" for v in rh81) + " over "
        + ", ".join(f"{h:.0f}" for h in alts) + " km")
    log(f"[sim] Figs 1-2: one intra-plane hop {lat[(10, 550)] * 1e3:.2f} ms "
        f"at M 10, {lat[(100, 550)] * 1e3:.3f} ms at M 100 (550 km, "
        f"{memory_tier_for_latency(lat[(100, 550)])}); {m} satellites a "
        f"plane reach 2 ms; {len(rows)} sweep points and {len(grid)} grid "
        f"points in {dt:.3f} s on the host")


def start_world(device) -> Path:
    """A one-rank NCCL process group over a ``FileStore``, for phases 13
    to 15 (its set-up paid once); returns the store's path."""
    from datetime import timedelta

    import torch.distributed as dist

    store = ROOT / "build" / "torus_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1, device_id=device,
                            timeout=timedelta(seconds=120))
    log(f"[torus] NCCL group of one rank: {time.perf_counter() - t0:.1f} s "
        f"to start")
    return store


def close_world(store: Path) -> None:
    import torch.distributed as dist

    dist.destroy_process_group()
    store.unlink(missing_ok=True)


def phase_torus(device) -> None:
    """The torus exchange on the card, in the one-rank NCCL group of
    ``start_world``: a 1x1 (data, model) mesh, one layer's paged K pool of
    full TinyLlama (64 blocks of 128 tokens, 4 KV heads of 64, bf16) laid
    out by ``kvc_sharding`` and shifted by ``migrate_shards``: the ring of
    one position is the identity."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core.tpu_cache import (
        device_grid_for_mesh,
        kvc_sharding,
        migrate_shards,
    )

    t0 = time.perf_counter()
    mesh = init_device_mesh("cuda", (1, 1),
                            mesh_dim_names=("data", "model"))
    placements = kvc_sharding(mesh)
    pool = torch.randn(64, 128, 4, 64, device=device,
                       generator=torch.Generator(device=device)
                       .manual_seed(0)).to(torch.bfloat16)
    x = distribute_tensor(pool, mesh, placements)
    for shift in (1, -1):
        sync(device)
        t1 = time.perf_counter()
        y = migrate_shards(x, mesh, axis="data", shift=shift)
        sync(device)
        ms = (time.perf_counter() - t1) * 1e3
        if (not torch.equal(y.full_tensor(), pool)
                or y.to_local().data_ptr() == x.to_local().data_ptr()):
            raise AssertionError(f"shift {shift}: not the identity")
        log(f"[torus] migrate_shards shift {shift}: the identity, "
            f"{ms:.3f} ms on the host clock")
    log(f"[torus] backend {dist.get_backend()} (NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}), world size "
        f"{dist.get_world_size()}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
        f"{device_grid_for_mesh(mesh)}, placements {placements}, local "
        f"shard {tuple(x.to_local().shape)} of {tuple(pool.shape)}")
    log(f"[torus] {time.perf_counter() - t0:.1f} s")


def phase_example(t_all: float) -> dict:
    """``examples/torch_serve_skymemory.py --full --requests 8 --max-new
    16`` in this process: two full TinyLlama replicas over one clocked
    19x5 constellation.  Returns its launch counts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_serve_skymemory", ROOT / "examples" / "torch_serve_skymemory.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--requests", "8", "--max-new", "16"]
    left = EXAMPLE_BY_S - (time.perf_counter() - t_all)
    width = "full width (--full)"
    if left >= EXAMPLE_FULL_S:
        argv.insert(0, "--full")
    else:
        width = (f"CUT to its reduced default width: {left:.0f} s left "
                 f"before {EXAMPLE_BY_S:.0f} s, the full run's allowance "
                 f"{EXAMPLE_FULL_S:.0f} s")
    t0 = time.perf_counter()
    fabric, counts = counted(lambda: example.main(argv))
    log(f"[example] torch_serve_skymemory.py {' '.join(argv)}: {width}; "
        f"block hits {fabric['block_hits']}, sets {fabric['blocks_set']}, "
        f"prefix hit rate {fabric['prefix_hit_rate']:.3f}; "
        f"{time.perf_counter() - t0:.1f} s; launches {counts}")
    if fabric["block_hits"] <= 0:
        raise AssertionError("the example hit no block")
    _require_launched(counts, LAUNCH_PATHS["skymemory-tinyllama"])
    return counts


# ---------------------------------------------------------------------------
# phase 14: sharded training on a (1, 1) mesh, and the launcher's --mesh
# ---------------------------------------------------------------------------

MESH_STEPS = 3
MESH_RUNS = ("skymemory-tinyllama", "mamba2-1.3b")
# two bf16 steps of a weight, and twice the learning rates' sum: AdamW's
# first updates of a near-zero gradient part two correct runs by up to
# the learning rate a step
MESH_PARAM_TOL = dict(rtol=2 ** -7)


def _mesh_run(cfg, device, batches, rules, tcfg) -> tuple:
    """``MESH_STEPS`` steps of full ``cfg`` from seed 0's weights through
    ``train()`` (with ``rules``: sharded); returns the history, the final
    whole parameters (on the card, compared there) and the launch
    counts."""
    from repro_torch.training import train

    model = _build_model(cfg, device, 0, tag="mesh")
    sync(device)
    (model, state, hist), counts = counted(
        lambda: train(model, Replay(batches), tcfg, num_steps=MESH_STEPS,
                      rules=rules))
    sync(device)
    from repro_torch.distributed.sharding import whole

    params = {n: whole(p).detach() for n, p in model.named_parameters()}
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return hist, params, counts


def _first_difference(cfg, device, batch, rules) -> str:
    """Where a sharded step first leaves the unsharded one: the loss of
    one forward, else the gradients (the layers named), else the AdamW
    update."""
    from repro_torch.distributed.sharding import use_rules, whole
    from repro_torch.training import TrainConfig
    from repro_torch.training.loop import make_train_step, shard_batch

    got = {}
    for tag, r in (("plain", None), ("mesh", rules)):
        model = _build_model(cfg, device, 0, tag="mesh")
        make_train_step(model, TrainConfig(), r)   # distributes, grads on
        with use_rules(r):
            loss, _ = model.train_loss(shard_batch(batch, r))
            loss.backward()
        got[tag] = (whole(loss).detach().cpu(),
                    {n: whole(p.grad).detach().cpu()
                     for n, p in model.named_parameters()})
        del model
        torch.cuda.empty_cache()
    if not torch.equal(got["plain"][0], got["mesh"][0]):
        return "the forward (step 0's loss)"
    bad = [n for n in got["plain"][1]
           if not torch.equal(got["plain"][1][n], got["mesh"][1][n])]
    if bad:
        return f"the backward: gradients of {bad[:6]} ({len(bad)} tensors)"
    return "the AdamW update (equal step-0 gradients)"


def phase_mesh(device) -> dict:
    """Phase 14 (see the module's docstring).  Returns the sharded runs'
    and the launcher's launch counts."""
    import contextlib
    import io
    import re

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_rules
    from repro_torch.training import (
        AdamWConfig,
        DataConfig,
        SyntheticLM,
        TrainConfig,
    )
    from repro_torch.training.optimizer import lr_at

    mesh = init_device_mesh(device.type, (1, 1),
                            mesh_dim_names=("data", "model"))
    total = dict.fromkeys(KERNELS, 0)
    opt = AdamWConfig(**TRAIN_OPT)
    lr_sum = sum(float(lr_at(opt, s)) for s in range(1, MESH_STEPS + 1))
    for arch in MESH_RUNS:
        t_model = time.perf_counter()
        cfg = get_config(arch)
        rules = make_rules(mesh, cfg, InputShape("train", 2048, 4, "train"))
        it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=2048,
                                    batch_size=4, seed=0)).batches()
        batches = [next(it) for _ in range(MESH_STEPS)]
        runs = {}
        for tag, r, zero1 in (("unsharded", None, False),
                              ("sharded", rules, True)):
            tcfg = TrainConfig(opt=opt, log_every=1, zero1=zero1)
            runs[tag] = _mesh_run(cfg, device, batches, r, tcfg)
        (h0, p0, _), (h1, p1, counts) = runs["unsharded"], runs["sharded"]
        want = train_launches(cfg, MESH_STEPS)
        if counts != want:
            raise AssertionError(f"{cfg.name}: the sharded run launched "
                                 f"{counts}, want {want}")
        add_counts(total, counts)
        loss0 = [h["loss"] for h in h0]
        loss1 = [h["loss"] for h in h1]
        differ = [n for n in p0 if not torch.equal(p0[n], p1[n])]
        bitwise = loss0 == loss1 and not differ
        worst, where = 0.0, None
        for n in differ:
            d = (p1[n].float() - p0[n].float()).abs()
            lim = MESH_PARAM_TOL["rtol"] * p0[n].float().abs() + 2 * lr_sum
            x = (d / lim).max().item()
            if x > worst:
                worst, where = x, n

        def step_ms(hist):
            ends = [h["elapsed_s"] for h in hist]
            return [(b - a) * 1e3 for a, b in zip([0.0] + ends, ends)]

        ms0, ms1 = step_ms(h0), step_ms(h1)
        row = dict(model=cfg.name, mesh=[1, 1], zero1=True,
                   steps=MESH_STEPS, batch=4, seq=2048,
                   loss_unsharded=loss0, loss_sharded=loss1,
                   bitwise_equal=bitwise,
                   max_param_diff_over_bf16_limit=worst,
                   step_ms_unsharded=ms0, step_ms_sharded=ms1,
                   step_ms_unsharded_1_on=statistics.mean(ms0[1:]),
                   step_ms_sharded_1_on=statistics.mean(ms1[1:]),
                   launches=counts)
        log(f"[mesh] run {json.dumps(row)}")
        if not bitwise:
            op = _first_difference(cfg, device,
                                   {k: torch.from_numpy(np.asarray(v)).to(
                                       device) for k, v in batches[0].items()},
                                   rules)
            log(f"[mesh] {cfg.name}: the sharded run is not bitwise the "
                f"unsharded one: largest parameter difference "
                f"{worst:.3f} x the bf16 limit (at {where}); it first "
                f"differs in {op}")
            if worst > 1.0 or not np.allclose(loss0, loss1, rtol=2 ** -7):
                raise AssertionError(f"{cfg.name}: sharded and unsharded "
                                     f"runs part beyond the bf16 limit")
        else:
            log(f"[mesh] {cfg.name}: {MESH_STEPS} sharded steps bitwise "
                f"the unsharded ones (losses and every parameter); "
                f"launches {counts}; {time.perf_counter() - t_model:.1f} s "
                f"with the builds and batches")
        del runs, p0, p1
        torch.cuda.empty_cache()

    t_launch = time.perf_counter()
    argv = ["--arch", "skymemory-tinyllama", "--tiny", "--steps", "5",
            "--device", device.type]
    lines = {}
    for extra in ([], ["--mesh"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, counts = counted(lambda: launch_train.main(argv + extra))
        add_counts(total, counts)
        lines[bool(extra)] = [re.sub(r" \(\d+s\)$", "", ln)
                              for ln in buf.getvalue().splitlines()
                              if ln.startswith("step ")]
    if not lines[False] or lines[True] != lines[False]:
        raise AssertionError(f"launch.train --mesh printed {lines[True]}, "
                             f"without it {lines[False]}")
    log(f"[mesh] launch.train {' '.join(argv)} --mesh: its {len(lines[True])} "
        f"loss lines equal those without --mesh (world size "
        f"{dist.get_world_size()}, group kept): {lines[True][-1]}; both "
        f"runs {time.perf_counter() - t_launch:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 15: the sharded serve step on a (1, 1) mesh, and K1 over stripes
# ---------------------------------------------------------------------------

SERVE_MESH_STEPS = 4
# the bf16 limit of the model checks (phase 11's teacher-forced logits)
SERVE_MESH_TOL = BF16_LOGIT_TOL
# K1's LSE against the plain version's f32 logsumexp of the same bf16
# inputs: both sum exact products of bf16 values in f32, in other orders,
# over up to 32,768 scores of magnitude ~1 (an LSE near 11, whose f32
# step is ~1e-6)
STRIPE_LSE_TOL = dict(atol=1e-4, rtol=0.0)
STRIPE_COUNTS = (2, 4, 16)
# (d)'s lengths over 32,768 slots: full rows, rows ending inside a stripe
# of 2, 4 or 16 (a stripe of 1-64 tokens takes K1's single-split exit),
# and short rows that leave every later stripe empty (-inf)
STRIPE_LENGTHS = (32768, 30000, 16384 + 30, 16384, 8192 + 5, 2048 + 1, 2047,
                  100, 64, 63, 1, 20000, 24576 + 64, 31000, 12345, 32700)


def _fill_cache(cache: dict, gen) -> None:
    """Every leaf of ``cache`` drawn from ``gen`` in place (N(0, 1), the
    SSM state scaled to 0.1, int8 K/V as integers within +-40): a cache
    as a long prefill would leave it, without the prefill."""
    for part, leaves in cache.items():
        for t in leaves.values():
            if t.dtype == torch.int8:
                t.random_(-40, 41, generator=gen)
                continue
            t.normal_(generator=gen)
            if part == "ssm":
                t.mul_(0.1)


def _first_parting(c0: dict, c1: dict) -> str | None:
    """The first (part, leaf, layer) where two caches differ, or None."""
    from repro_torch.distributed.sharding import local

    for part, leaves in c0.items():
        for name, t in leaves.items():
            other = local(c1[part][name])
            for l in range(t.shape[0]):
                if not torch.equal(t[l], other[l]):
                    return f"{part}/{name} layer {l}"
    return None


def _serve_pair(cfg, shape, mesh, device, *, pos0, seed) -> tuple:
    """``SERVE_MESH_STEPS`` greedy steps through ``make_plan(...).fn`` on
    ``mesh`` and through the unsharded ``Model.decode_step``, from one
    seeded model and cache.  Returns the row printed, the sharded run's
    launch counts and the unsharded cache after the steps."""
    from repro_torch.distributed.sharding import distribute_cache, whole
    from repro_torch.launch.mesh import make_rules
    from repro_torch.launch.specs import make_plan
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    rules = make_rules(mesh, cfg, shape)
    plan = make_plan(cfg, shape, rules, device=device)
    plan.model.init(torch.Generator(device=device).manual_seed(seed))
    plain = Model(plan.cfg, device=device)
    plain.load_state_dict(plan.model.state_dict())
    b, n = shape.global_batch, shape.seq_len
    cache0 = plain.init_cache(b, n)
    _fill_cache(cache0, torch.Generator(device=device).manual_seed(seed + 1))
    cache1 = distribute_cache(
        {p: {k: t.clone() for k, t in leaves.items()}
         for p, leaves in cache0.items()}, rules, batch=b)
    tok0 = torch.randint(0, cfg.vocab_size, (b, 1), dtype=torch.int32,
                         device=device, generator=torch.Generator(
                             device=device).manual_seed(seed + 2))
    pos0 = pos0.to(device)
    sync(device)
    t_set = time.perf_counter() - t0

    def steps(fn):
        tok, pos, logits, toks, ms = tok0, pos0, [], [], []
        for _ in range(SERVE_MESH_STEPS):
            t = time.perf_counter()
            lg = whole(fn(tok, pos))
            sync(device)
            ms.append((time.perf_counter() - t) * 1e3)
            logits.append(lg)
            tok = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
            toks.append(tok)
            pos = pos + 1
        return logits, torch.cat(toks, 1), ms

    l0, t0_, ms0 = steps(lambda tok, pos: plain.decode_step(cache0, tok, pos))
    (l1, t1, ms1), counts = counted(
        lambda: steps(lambda tok, pos: plan.fn(cache1, tok, pos)[0]))
    bitwise = all(torch.equal(a, c) for a, c in zip(l0, l1))
    parting = _first_parting(cache0, cache1)
    worst = max(_ratio("serve", c, a, SERVE_MESH_TOL)[1]
                for a, c in zip(l0, l1))
    row = dict(model=cfg.name, shape=shape.name, batch=b,
               cache_slots=(cache0["kv"]["k"].shape[2] if "kv" in cache0
                            else None),
               window=plan.cfg.sliding_window,
               positions=[int(pos0.min()), int(pos0.max())],
        steps=SERVE_MESH_STEPS, logits_bitwise=bitwise,
        cache_first_parting=parting, worst_over_bf16_limit=worst,
        tokens_equal=torch.equal(t0_, t1), step_ms_unsharded=ms0,
        step_ms_sharded=ms1, setup_s=t_set,
        cache_gb=sum(t.numel() * t.element_size() for leaves in
                     cache0.values() for t in leaves.values()) / 1e9,
        launches=counts)
    if not row["tokens_equal"] or worst > 1.0:
        raise AssertionError(f"[serve_mesh] {cfg.name} {shape.name}: the "
                             f"sharded serve step parts from the unsharded "
                             f"one: {row}")
    return row, counts, cache0


def _stripe_check(k, v, device, smi) -> dict:
    """(d): K1 over one layer's whole cache against K1 with its LSE over
    2, 4 and 16 sequence stripes merged by ``merge_partials``; each LSE
    against the plain version's f32 LSE.  Each stripe also runs K1 with
    its f32 output (what a striped serve step merges), held to the plain
    version in f32 and, rounded, bitwise to the bf16 output; the merge of
    the f32 partials and of the bf16 ones, each rounded to bf16 once,
    against an f32 attention over the whole cache: the first may not be
    the further.  Returns the merged rows."""
    from repro_torch.distributed.decode import merge_partials
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode

    b, n, hkv, d = k.shape
    gen = torch.Generator(device=device).manual_seed(1515)
    q = torch.randn(b, 32, d, generator=gen, device=device).to(k.dtype)
    lens = torch.tensor(STRIPE_LENGTHS, dtype=torch.int32, device=device)

    def pages(t):
        return t.reshape(b, t.shape[1] // 128, 128, hkv, d)

    whole_out, whole_lse = paged_decode(q, pages(k), pages(v), lens,
                                        return_lse=True)
    plain_whole = paged_decode(q, pages(k), pages(v), lens)
    if not torch.equal(whole_out, plain_whole):
        raise AssertionError("[serve_mesh] K1's output differs with "
                             "return_lse")
    truth = ref.paged_attention_ref(q.float(), pages(k).float(),
                                    pages(v).float(), lens)
    rows = {}
    worst_lse = worst_f32 = 0.0
    for count in STRIPE_COUNTS:
        length = n // count
        outs, outs32, lses = [], [], []
        for r in range(count):
            ks = k[:, r * length:(r + 1) * length].contiguous()
            vs = v[:, r * length:(r + 1) * length].contiguous()
            lr = torch.clamp(lens - r * length, 0, length).to(torch.int32)
            o, lse = paged_decode(q, pages(ks), pages(vs), lr,
                                  return_lse=True)
            o32, lse32 = paged_decode(q, pages(ks), pages(vs), lr,
                                      return_lse=True,
                                      out_dtype=torch.float32)
            plain32, want = ref.paged_attention_ref(
                q.float(), pages(ks).float(), pages(vs).float(), lr,
                return_lse=True)
            if o32.dtype != torch.float32 or not (
                    torch.equal(o32.to(o.dtype), o)
                    and torch.equal(lse32, lse)):
                raise AssertionError(f"[serve_mesh] {count} stripes, stripe "
                                     f"{r}: K1's f32 output does not round "
                                     f"to its bf16 output, or its LSE "
                                     f"differs")
            worst_f32 = max(worst_f32, _check(
                f"[serve_mesh] {count} stripes, stripe {r}, f32 output",
                "paged_decode", o32, plain32, BF16_TOL["paged_decode"])[1])
            if not torch.equal(torch.isinf(lse), torch.isinf(want)):
                raise AssertionError(f"[serve_mesh] {count} stripes, stripe "
                                     f"{r}: -inf where the plain LSE has "
                                     f"none, or the other way")
            fin = torch.isfinite(want)
            worst_lse = max(worst_lse, _ratio(
                "lse", lse[fin], want[fin], STRIPE_LSE_TOL)[1])
            outs.append(o)
            outs32.append(o32)
            lses.append(lse)
            del ks, vs
        merged = merge_partials(outs, lses)
        err, worst, _ = _check(f"[serve_mesh] {count} stripes merged",
                               "paged_decode", merged, whole_out)
        merged32 = merge_partials(outs32, lses, k.dtype)
        err32, worst32, _ = _check(
            f"[serve_mesh] {count} stripes merged from f32 partials",
            "paged_decode", merged32, whole_out)
        vs_f32 = float((merged.float() - truth).abs().max())
        vs_f32_new = float((merged32.float() - truth).abs().max())
        rows[count] = dict(max_abs_err=err, over_limit=worst,
                           f32_partials_max_abs_err=err32,
                           f32_partials_over_limit=worst32,
                           vs_f32_whole_bf16_partials=vs_f32,
                           vs_f32_whole_f32_partials=vs_f32_new)
        if vs_f32_new > vs_f32:
            raise AssertionError(f"[serve_mesh] {count} stripes: the merge "
                                 f"of f32 partials is {vs_f32_new:.3e} from "
                                 f"an f32 attention, further than the merge "
                                 f"of bf16 partials ({vs_f32:.3e})")
    if worst_lse > 1.0:
        raise AssertionError(f"[serve_mesh] K1's LSE {worst_lse:.2f} x its "
                             f"limit {STRIPE_LSE_TOL}")
    _, want = ref.paged_attention_ref(q.float(), pages(k).float(),
                                      pages(v).float(), lens,
                                      return_lse=True)
    fin = torch.isfinite(want)
    worst_lse = max(worst_lse, _ratio("lse", whole_lse[fin], want[fin],
                                      STRIPE_LSE_TOL)[1])
    log(f"[serve_mesh] (d) K1 over B{b} S{n} H32 Hkv{hkv} D{d} bf16, lengths "
        f"1-{n} (empty stripes included): merged stripes vs the whole "
        f"{json.dumps(rows)} (limit {BF16_TOL['paged_decode']}); LSE "
        f"{worst_lse:.3f} x its limit {STRIPE_LSE_TOL} against the plain "
        f"f32 LSE; f32 output {worst_f32:.3f} x the limit against the plain "
        f"version in f32, and rounded bitwise the bf16 output; output "
        f"bitwise with and without return_lse; {smi}")
    return rows


def _long_decode_timing(k, v, device, timer, smi) -> dict:
    """(f): K1 at (d)'s shape with every slot valid, with and without its
    LSE, against its byte bound, SDPA over the cache viewed [B, S, Hkv,
    D] (``enable_gqa``) and the plain version; CUDA-graph replay, cold
    L2."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode

    b, n, hkv, d = k.shape
    gen = torch.Generator(device=device).manual_seed(1516)
    q = torch.randn(b, 32, d, generator=gen, device=device).to(k.dtype)
    lens = torch.full((b,), n, dtype=torch.int32, device=device)
    kp = k.reshape(b, n // 128, 128, hkv, d)
    vp = v.reshape(b, n // 128, 128, hkv, d)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(q[:, :, None], kt, vt, enable_gqa=True)[:, :, 0]
    _check("[serve_mesh] (f) SDPA yardstick", "paged_decode", lib,
           paged_decode(q, kp, vp, lens))
    n_bytes = nbytes(k, v, q, lens) + nbytes(q)
    bms, by = bound_ms(n_bytes, 4 * 32 * d * b * n, k.dtype)
    row = dict(shape=f"B{b} S{n} H32 Hkv{hkv} D{d} bf16, every slot valid",
               ms=timer.ms(lambda: paged_decode(q, kp, vp, lens)),
               ms_with_lse=timer.ms(lambda: paged_decode(
                   q, kp, vp, lens, return_lse=True)),
               ms_with_lse_out_f32=timer.ms(lambda: paged_decode(
                   q, kp, vp, lens, return_lse=True,
                   out_dtype=torch.float32)),
               bound_ms=bms, bound_by=by, bound_bytes=n_bytes,
               library_ms=timer.ms(lambda: sdpa(q[:, :, None], kt, vt,
                                                enable_gqa=True)),
               plain_ms=timer.ms(lambda: ref.paged_attention_ref(
                   q, kp, vp, lens)))
    log(f"[serve_mesh] (f) K1 timing {json.dumps(row)} (library: SDPA; "
        f"{smi})")
    return row


def phase_serve_mesh(device, timer, smi) -> dict:
    """Phase 15 (see the module's docstring).  Returns the sharded runs'
    launch counts."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
    from repro_torch.distributed.sharding import whole
    from repro_torch.launch.mesh import make_rules
    from repro_torch.launch.specs import make_plan
    from repro_torch.models.model import Model

    mesh = init_device_mesh(device.type, (1, 1),
                            mesh_dim_names=("data", "model"))
    total = dict.fromkeys(KERNELS, 0)
    tiny = get_config("skymemory-tinyllama")

    # (a) decode_32k, the global batch cut from 128 to 16 (one card)
    t = time.perf_counter()
    shape = InputShape("decode_32k", 32_768, 16, "decode")
    pos0 = torch.linspace(30_000, 32_700, 16).to(torch.int32)
    row, counts, cache0 = _serve_pair(tiny, shape, mesh, device, pos0=pos0,
                                      seed=150)
    add_counts(total, counts)
    log(f"[serve_mesh] (a) {json.dumps(row)}; {time.perf_counter() - t:.1f} "
        f"s")
    k, v = cache0["kv"]["k"][0], cache0["kv"]["v"][0]
    # (d) and (f) on layer 0's K/V
    t = time.perf_counter()
    _stripe_check(k, v, device, smi)
    _long_decode_timing(k, v, device, timer, smi)
    log(f"[serve_mesh] (d), (f) {time.perf_counter() - t:.1f} s")
    del cache0, k, v
    gc.collect()
    torch.cuda.empty_cache()

    # (b) long_500k: a 32,768-slot ring past its wrap, batch 1
    t = time.perf_counter()
    shape = INPUT_SHAPES["long_500k"]
    row, counts = _serve_pair(tiny, shape, mesh, device,
                              pos0=torch.tensor([524_286], dtype=torch.int32),
                              seed=151)[:2]
    add_counts(total, counts)
    slots = [(524_286 + i) % 32_768 for i in range(SERVE_MESH_STEPS)]
    log(f"[serve_mesh] (b) {json.dumps(row)}; slots written {slots}; "
        f"{time.perf_counter() - t:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # (c) mamba2-1.3b at decode_32k's full batch: the f32 state's heads
    # over model
    t = time.perf_counter()
    row, counts = _serve_pair(get_config("mamba2-1.3b"),
                              INPUT_SHAPES["decode_32k"], mesh, device,
                              pos0=torch.full((128,), 30_000,
                                              dtype=torch.int32),
                              seed=152)[:2]
    add_counts(total, counts)
    log(f"[serve_mesh] (c) {json.dumps(row)}; {time.perf_counter() - t:.1f} "
        f"s")
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the prefill plan: prefill_32k's 32,768 tokens, batch cut to 1
    t = time.perf_counter()
    shape = InputShape("prefill_32k", 32_768, 1, "prefill")
    plan = make_plan(tiny, shape, make_rules(mesh, tiny, shape),
                     device=device)
    plan.model.init(torch.Generator(device=device).manual_seed(153))
    plain = Model(plan.cfg, device=device)
    plain.load_state_dict(plan.model.state_dict())
    tokens = torch.randint(0, tiny.vocab_size, (1, 32_768), dtype=torch.int32,
                           device=device, generator=torch.Generator(
                               device=device).manual_seed(154))
    with torch.no_grad():
        lg0, st0 = plain.forward(tokens, collect_state=True)
    last0 = lg0[:, -1:].clone()
    del lg0
    (last1, st1), counts = counted(lambda: plan.fn({"tokens": tokens}))
    add_counts(total, counts)
    last1 = whole(last1)
    kv1 = {n: whole(x) for n, x in st1["kv"].items()}
    parts = {"last_logits": _ratio("serve", last1, last0,
                                   SERVE_MESH_TOL)[1]}
    for n, x in kv1.items():
        parts[n] = _ratio("serve", x, st0["kv"][n], SERVE_MESH_TOL)[1]
    bitwise = torch.equal(last1, last0) and all(
        torch.equal(kv1[n], st0["kv"][n]) for n in kv1)
    row = dict(model=tiny.name, shape=shape.name, batch=1, tokens=32_768,
               bitwise=bitwise, worst_over_bf16_limit=parts,
               launches=counts)
    if max(parts.values()) > 1.0:
        raise AssertionError(f"[serve_mesh] (e) the prefill plan parts from "
                             f"the unsharded forward: {row}")
    if counts["flash_prefill"] != tiny.num_layers:
        raise AssertionError(f"[serve_mesh] (e) launches {counts}")
    log(f"[serve_mesh] (e) {json.dumps(row)}; {time.perf_counter() - t:.1f} "
        f"s")
    del plan, plain, st0, st1, kv1
    gc.collect()
    torch.cuda.empty_cache()

    # (g) full TinyLlama over an int8 cache at decode_32k, batch cut to 4:
    # the case of tests/test_torch_mesh_serve.py's int8 cache; one stripe,
    # so bitwise the unsharded step
    t = time.perf_counter()
    shape = InputShape("decode_32k", 32_768, 4, "decode")
    row, counts, cache0 = _serve_pair(
        tiny.replace(kvc_dtype="int8"), shape, mesh, device,
        pos0=torch.linspace(30_000, 32_700, 4).to(torch.int32), seed=155)
    add_counts(total, counts)
    if cache0["kv"]["k"].dtype != torch.int8 or not (
            row["logits_bitwise"] and row["cache_first_parting"] is None):
        raise AssertionError(f"[serve_mesh] (g) the int8 serve step is not "
                             f"bitwise the unsharded one: {row}")
    log(f"[serve_mesh] (g) int8 cache {json.dumps(row)}; "
        f"{time.perf_counter() - t:.1f} s")
    del cache0
    gc.collect()
    torch.cuda.empty_cache()
    want = 3 * tiny.num_layers * SERVE_MESH_STEPS
    if total["paged_decode"] != want:
        raise AssertionError(f"[serve_mesh] K1 launched "
                             f"{total['paged_decode']} times, want {want}")
    log(f"[serve_mesh] launches over (a)-(c), (e) and (g): {total}")
    return total


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 16: the dry-run, counted on the host beside the card's run.
# ---------------------------------------------------------------------------

DRYRUN_CHILD = """
import json, sys
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch.dryrun import run_one
from repro_torch.models.config import InputShape
rec = run_one("skymemory-tinyllama", InputShape("train_b4_s2048", 2048, 4,
              "train"), mesh=MeshShape(("data", "model"), (1, 1)),
              remat=None)
with open(sys.argv[1], "w") as f:
    json.dump(rec, f)
"""


# Phase 16's counts of plans whose head count does not divide the mesh
# axes: 3 heads (1 K/V head) or 3 SSM heads on a (2, 2) fake world, the
# train step, the prefill plan and the serve step of one smoke config of
# each family (tests/test_torch_mesh_uneven.py counts the same here).
# A count that raises is recorded with its error.
UNEVEN_CHILD = """
import json, sys, time
from repro_torch.configs import InputShape, get_config, smoke_config
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_rules
heads3 = {"num_heads": 3, "num_kv_heads": 1}
ssm3 = {"d_model": 48, "ssm_head_dim": 32}
models = {"skymemory-tinyllama": heads3, "deepseek-v3-671b": heads3,
          "mamba2-1.3b": ssm3, "granite-moe-3b-a800m": heads3,
          "llava-next-34b": heads3, "zamba2-1.2b": {**heads3, **ssm3},
          "seamless-m4t-large-v2": heads3}
recs = []
with S.fake_world(MeshShape(("data", "model"), (2, 2))) as world:
    for arch, kw in models.items():
        cfg = smoke_config(get_config(arch)).replace(**kw)
        for kind in ("train", "prefill", "decode"):
            t0 = time.perf_counter()
            shape = InputShape("s32_b4", 32, 4, kind)
            try:
                c = S.lower_plan(S.make_plan(
                    cfg, shape, make_rules(world, cfg, shape), remat=None,
                    device="meta"))
                rec = {"status": "ok", "flops": c.cost_analysis()["flops"],
                       "collectives": c.collectives}
            except Exception as e:
                rec = {"status": f"error: {type(e).__name__}: {e}"[:600]}
            recs.append({"arch": arch, "kind": kind, "mesh": "2x2",
                         "seconds": round(time.perf_counter() - t0, 2), **rec})
with open(sys.argv[1], "w") as f:
    json.dump({"records": recs}, f)
"""


def start_dryrun() -> dict:
    """Start phase 16's three counts, each a host process of its own (the
    fake world is the default process group, and this process opens a
    real one in phase 13): TinyLlama's serve step at ``decode_32k`` over
    the 16x16 mesh through the command line, its training step at phase
    12's shape on a world of one through ``run_one``, and the uneven-head
    plans (``UNEVEN_CHILD``).  They see no device and use two threads
    each.  Stopped at exit if still running."""
    out = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
    runs = {
        "decode_32k": ([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "skymemory-tinyllama", "--shape",
                        "decode_32k", "--out", str(out)],
                       out / "skymemory-tinyllama__decode_32k__16x16.json"),
        "train": ([sys.executable, "-c", DRYRUN_CHILD,
                   str(out / "train.json")], out / "train.json"),
        "uneven": ([sys.executable, "-c", UNEVEN_CHILD,
                    str(out / "uneven.json")], out / "uneven.json"),
    }
    procs = {}
    for name, (cmd, path) in runs.items():
        logf = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=logf,
                                        stderr=subprocess.STDOUT),
                       path, out / f"{name}.log", logf)

    def stop():
        for p, _, _, logf in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()

    atexit.register(stop)
    return {"t0": time.perf_counter(), "procs": procs, "stop": stop}


# Phase 16's ranges for the training step's count against phase 12's run
# of the same step.  The predicted peak over the measured
# ``max_memory_allocated``: at least 1, since the count keeps the plain
# attention's f32 [S, S] scores, which K4 never writes; at most 1.6, the
# top of the range predicted before the first reading (1.2564).  The
# memory term over the measured median step time: the unfused bytes of
# the plain arithmetic over the HBM rate overcount the step (2.24 at the
# first reading); at least 1, at most 4, which admits a step 1.6x faster.
DRYRUN_PEAK_RATIO = (1.0, 1.6)
DRYRUN_MEMORY_TO_STEP = (1.0, 4.0)


def phase_dryrun(started: dict, smi: str) -> None:
    """Read phase 16's counts: each process must exit 0 and write ``ok``
    records.  Prints each record's roofline terms on the H100's
    constants, one line for each uneven-head plan, then the training
    step's predicted peak bytes, FLOPs and
    memory term beside phase 12's measured peak (``max_memory_allocated``
    less what was held before), analytic FLOPs (``train_flops``) and
    median step time, with their ratios; fails when the peak's or the
    memory term's ratio leaves ``DRYRUN_PEAK_RATIO`` or
    ``DRYRUN_MEMORY_TO_STEP``."""
    from repro_torch.configs import get_config

    recs = {}
    try:
        for name, (p, path, log_path, _) in started["procs"].items():
            rc = p.wait(timeout=300)
            if rc != 0:
                tail = log_path.read_text()[-2000:]
                raise AssertionError(f"[dryrun] {name} exited {rc}: {tail}")
            recs[name] = rec = json.loads(path.read_text())
            if name == "uneven":
                for r in rec["records"]:
                    log(f"[dryrun] uneven heads: {r['arch']} {r['kind']} at "
                        f"{r['mesh']}, 3 heads: {r['status']} in "
                        f"{r['seconds']} s, FLOPs {r.get('flops')}, link "
                        f"bytes {json.dumps(r.get('collectives'))} (torch "
                        f"{torch.__version__})")
                bad = [r for r in rec["records"] if r["status"] != "ok"]
                if len(rec["records"]) != 21 or bad:
                    raise AssertionError(f"[dryrun] uneven heads: {bad}")
                continue
            if rec["status"] != "ok":
                raise AssertionError(f"[dryrun] {name}: {rec['status']}")
            log(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']} "
                f"{rec['step']}: compute {rec['compute_s'] * 1e3:.3f} ms, "
                f"memory {rec['memory_s'] * 1e3:.3f} ms, collective "
                f"{rec['collective_s'] * 1e3:.3f} ms, dominant "
                f"{rec['dominant']}, useful {rec['useful_flops_ratio']:.3f}, "
                f"peak {rec['peak_memory_bytes'] / 1e9:.3f} GB/device "
                f"(counted in {rec['full_compile_s']} s, probes "
                f"{rec['probe_compile_s']} s; link bytes by collective "
                f"{json.dumps(rec['collectives'])}, torch "
                f"{torch.__version__}); predictions on the H100's roofline "
                f"terms")
    finally:
        started["stop"]()
    waited = time.perf_counter() - started["t0"]
    cfg = get_config("skymemory-tinyllama")
    row = TRAIN_ROWS[cfg.name]
    train = recs["train"]
    measured_peak = row["peak_memory_gb"] * 1e9
    analytic = train_flops(cfg, row["batch"], row["seq"])
    peak_ratio = train["peak_memory_bytes"] / measured_peak
    step_ms = row["step_ms_median_5_on"]
    memory_ratio = train["memory_s"] * 1e3 / step_ms
    log(f"[dryrun] {cfg.name} train B{row['batch']} x S{row['seq']} on a "
        f"world of one: predicted peak {train['peak_memory_bytes']:.6e} B "
        f"vs phase 12's max_memory_allocated {measured_peak:.6e} B (ratio "
        f"{peak_ratio:.4f}, range {DRYRUN_PEAK_RATIO}); memory term "
        f"{train['memory_s'] * 1e3:.3f} ms vs phase 12's median step "
        f"{step_ms:.3f} ms (ratio {memory_ratio:.4f}, range "
        f"{DRYRUN_MEMORY_TO_STEP}: the unfused count of the plain "
        f"arithmetic overcounts the step); counted FLOPs "
        f"{train['flops_per_device']:.6e} vs phase 12's analytic "
        f"{analytic:.6e} (ratio {train['flops_per_device'] / analytic:.4f}); "
        f"both read {waited:.1f} s after they started; {smi}")
    for what, ratio, (lo, hi) in (("peak", peak_ratio, DRYRUN_PEAK_RATIO),
                                  ("memory term", memory_ratio,
                                   DRYRUN_MEMORY_TO_STEP)):
        if not lo <= ratio <= hi:
            raise AssertionError(f"[dryrun] {cfg.name}: the predicted {what} "
                                 f"over the measured is {ratio:.4f}, outside "
                                 f"[{lo}, {hi}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    name, smi = phase_device()

    t0 = time.perf_counter()
    build_logs = phase_build()
    log(f"[phase] build {time.perf_counter() - t0:.1f} s")
    dryrun = start_dryrun()

    from repro_torch.configs import get_config

    device = torch.device("cuda", 0)
    timer = Timer(device)
    t0 = time.perf_counter()
    records = phase_kernels(device, timer)
    log(f"[phase] kernels {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records["flash_prefill_bwd"] = phase_backward(device, timer, build_logs)
    torch.cuda.empty_cache()
    log(f"[phase] kernels, backward {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records["ssd_chunk_scan_bwd"] = phase_ssd_backward(device, timer,
                                                       build_logs, smi)
    torch.cuda.empty_cache()
    log(f"[phase] kernels, SSD backward {time.perf_counter() - t0:.1f} s")

    tiny = get_config("skymemory-tinyllama")
    mamba = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    phase_model(tiny.replace(num_layers=2, dtype="float32"), device)
    phase_ssm_model(mamba.replace(num_layers=2, dtype="float32"), device)
    # zamba2's widths at one attention period: 6 SSD layers, the shared
    # block, a 1-layer tail
    phase_ssm_model(get_config("zamba2-1.2b").replace(num_layers=7,
                                                      dtype="float32"),
                    device)
    # the windowed decode past the ring's wrap: the hybrid's shared block
    # and a GQA model, each over a 200-slot ring
    phase_ring_model(get_config("zamba2-1.2b").replace(num_layers=7,
                                                       dtype="float32"),
                     device)
    phase_ring_model(tiny.replace(num_layers=2, dtype="float32"), device)
    # the int8 K/V pool at full width: the paged prefill and decode
    # (contiguous and free-list) and the dense ring's decode, card
    # against CPU, pools within one quantization step
    t1 = time.perf_counter()
    phase_model(tiny.replace(num_layers=2, dtype="float32",
                             kvc_dtype="int8"), device)
    phase_ring_model(tiny.replace(num_layers=2, dtype="float32",
                                  kvc_dtype="int8"), device)
    log(f"[model] int8 K/V cases {time.perf_counter() - t1:.1f} s")
    # the other paged families at full width: head_dim 160 with LayerNorm
    # and partial rotary, and 40 experts top-8 (routes checked per layer)
    for fam in ("stablelm-12b", "granite-moe-3b-a800m"):
        phase_model(get_config(fam).replace(num_layers=2, dtype="float32"),
                    device, prompt_len=120)
    # deepseek-v3's MLA at full width, one dense and one MoE layer, its
    # routed experts cut to 16 (top-8 kept) for the CPU's f32 copy, at a
    # capacity factor of 2 (= experts / top-k: no expert drops a token,
    # so the resume routes each token as the uninterrupted forward does)
    phase_mla_model(get_config("deepseek-v3-671b").replace(
        num_layers=2, first_k_dense=1, num_experts=16, capacity_factor=2.0,
        mtp_depth=0, dtype="float32"), device)
    # seamless-m4t at full width, 2 encoder and 2 decoder layers
    phase_encdec_model(get_config("seamless-m4t-large-v2").replace(
        num_layers=2, num_encoder_layers=2, dtype="float32"), device)
    # training at full width, card against CPU: TinyLlama and mamba2-1.3b
    # at 2 layers, zamba2-1.2b at one attention period (6 SSD layers, the
    # shared block, a 1-layer tail): the backwards' first main-path runs
    train_model_counts = [
        phase_train_model(c.replace(num_layers=layers, dtype="float32"),
                          device)
        for c, layers in ((tiny, 2), (mamba, 2),
                          (get_config("zamba2-1.2b"), 7))]
    torch.cuda.empty_cache()
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
    del tiny_model, mamba_model           # room for the next two models
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    family_counts = phase_families(device)
    log(f"[phase] families {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hybrid_counts = phase_hybrid(device)
    log(f"[phase] hybrid {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mla_counts = phase_mla(device)
    log(f"[phase] mla {time.perf_counter() - t0:.1f} s")
    gc.collect()               # earlier phases' models held in cycles
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    seamless_counts = phase_seamless(device)
    log(f"[phase] seamless {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    train_counts = []
    for arch, steps, full in TRAIN_RUNS:
        t0 = time.perf_counter()
        train_counts.append(phase_train(device, arch, steps=steps,
                                        full=full))
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase] train {arch} {time.perf_counter() - t0:.1f} s")
    t_user = t0 = time.perf_counter()
    launch_counts = phase_launch()
    log(f"[phase] launch {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_sim()
    log(f"[phase] sim {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    store = start_world(device)
    try:
        phase_torus(device)
        log(f"[phase] torus {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        example_counts = phase_example(t_all)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase] example {time.perf_counter() - t0:.1f} s")
        log(f"[phase] launch, sim, torus and example "
            f"{time.perf_counter() - t_user:.1f} s")
        t0 = time.perf_counter()
        mesh_counts = phase_mesh(device)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase] mesh {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        serve_mesh_counts = phase_serve_mesh(device, timer, smi)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase] serve_mesh {time.perf_counter() - t0:.1f} s")
    finally:
        close_world(store)
    t0 = time.perf_counter()
    phase_dryrun(dryrun, smi)
    log(f"[phase] dryrun {time.perf_counter() - t0:.1f} s")
    # launches over every phase's main-path runs, each counted from 0
    for phase in (*fabric_counts.values(), cluster_counts, family_counts,
                  hybrid_counts, mla_counts, seamless_counts,
                  *train_model_counts, *train_counts, launch_counts,
                  example_counts, mesh_counts, serve_mesh_counts):
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
        "flash_prefill_bwd": (
            "src/repro_torch/kernels/csrc/flash_backward.cu",
            "the gradient of src/repro/kernels/chunked_prefill.py:28 (no "
            "backward kernel in the reference)"),
        "ssd_chunk_scan_bwd": (
            "src/repro_torch/kernels/csrc/ssd_backward.cu",
            "the gradient of src/repro/kernels/ssd_scan.py:24 (no backward "
            "kernel in the reference)"),
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
            "shape": r["shape"], "body": r["body"],
            **({"forward_backward_ms": r["forward_backward_ms"],
                "library": "scaled_dot_product_attention's backward alone",
                "library_forward_backward_ms":
                    r["library_forward_backward_ms"]}
               if "forward_backward_ms" in r else {})})
    log(f"[phase] total {time.perf_counter() - t_all:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
