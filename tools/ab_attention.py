#!/usr/bin/env python3
"""Time the port's kernels (attention and the SSD scan) and the layers
they feed, for one or more checkouts of this repository, in turns, on one
NVIDIA card.

    python3 tools/ab_attention.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (it holds ``src/repro_torch``); pass
the same root twice to see the spread, e.g. ``old new new old``.  Every
root runs in a process of its own, in the order given, and prints one
``[ab] {json}`` line:

* the bf16 main-path cases of ``chip_smoke.py`` (``kernel_cases``, the
  same inputs): ``paged_decode`` over the contiguous pool (B4 P8) and
  over block tables (B8 P8), ``chunked_prefill_paged`` on an R4 x C256
  wave, ``flash_prefill`` causal B4 x S512, each timed by its ``Timer``
  (CUDA-graph replays, L2 flushed before each), with
  ``scaled_dot_product_attention``'s time where it computes the same
  function; ``ssd_chunk_scan`` at mamba2-1.3b's prefill shape (B1 L384
  H64 P64 G1 N128, chunk 128); and the bf16 backward of the dense
  prefill at TinyLlama's training shape (``BWD_CASES``' first, B4 x
  S2048, H32 Hkv4 D64, causal): ``flash_prefill_bwd`` alone (``Timer``),
  the forward + backward through ``ops.FlashAttention`` (eager, cold
  L2), and the backward's split into its launches (one CUPTI trace);
* full TinyLlama (22 layers, bf16, seeded random weights): the paged
  decode step at batch 4 over 384 cached tokens (``step_breakdown``) and
  one chunked-prefill wave (``prefill_wave``: 4 rows x 256 tokens over a
  384-token context) replayed from a CUDA graph, and
  ``chunked_prefill_paged`` alone at the wave's shape.  A tree whose wave
  cannot be captured in a graph (it reads the device from the host)
  reports ``graph_wave_ms`` null, with the reason;
* full mamba2-1.3b (48 layers, bf16, seeded random weights): one
  384-token prefill (``ssm_prefill``: ``Model.forward`` with the state
  collected) replayed from a CUDA graph, and ``ssd_chunk_scan`` alone at
  its shape.

The kernels build from each root's own sources into that root's
``build/``; the cases and the timing come from the ``chip_smoke.py``
beside this script, so every root runs the same measurements.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


AB_CASES = ("bf16 contiguous B4 P8", "bf16 block-table B8 P8",
            "bf16 wave R4 C256", "bf16 causal B4 S512",
            "bf16 B1 L384 H64 P64 G1 N128 Q128",
            "bf16 TinyLlama training B4 S2048 H32 Hkv4 D64 causal")


def one(root: Path) -> dict:
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    sys.path.insert(0, str(root / "src"))   # ahead of chip_smoke's own
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import Model

    if not torch.cuda.is_available():
        raise SystemExit("ab_attention: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build_all()
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    row = {"root": str(root), "package": repro_torch.__file__}
    bwd_cases = [c for c in cs.BWD_CASES if f"bf16 {c[0]}" in AB_CASES]
    left = set(AB_CASES) - {f"bf16 {c[0]}" for c in bwd_cases}
    for name, label, dtype, _, make, runner in cs.kernel_cases(dev):
        args, _, _ = make(gen, dtype)     # every case, to keep the inputs
        if label not in left:
            continue
        left.discard(label)
        kern, plain = runner(args)
        got, want = kern(), plain()
        if isinstance(want, tuple):     # the SSD scan: y and final state
            cs._check(f"{name} [{label}] y", name, got[0], want[0])
            cs._check(f"{name} [{label}] final state", name, got[1],
                      want[1], tol=cs.SSD_STATE_TOL)
        else:
            cs._check(f"{name} [{label}]", name, got, want)
        r = row[f"{name} [{label}]"] = {"ms": timer.ms(kern)}
        lib = cs.YARDSTICKS.get(name, lambda a: None)(args)
        if lib is not None:
            r["sdpa_ms"] = timer.ms(lib)
        if not left:
            break

    from repro_torch.kernels.chunked_prefill import flash_prefill
    from repro_torch.kernels.flash_backward import flash_prefill_bwd
    from repro_torch.kernels.ops import FlashAttention
    for label, b, sq, skv, h, hkv, dq_, dv_, causal, off, win in bwd_cases:
        name = f"bf16 {label}"
        q, k, v, d_out, kw = cs.bwd_inputs(dev, torch.bfloat16, name, b, sq,
                                           skv, h, hkv, dq_, dv_, causal,
                                           off, win)
        out, lse = flash_prefill(q, k, v, return_lse=True, **kw)

        def bwd():
            return flash_prefill_bwd(q, k, v, out, lse, d_out, **kw)

        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def port_fb():
            o = FlashAttention.apply(*leaves, causal, off, win, None)
            return torch.autograd.grad(o, leaves, d_out)

        seen = b * h * cs._visible_pairs(sq, skv, causal, off, win)
        row[f"flash_prefill_bwd [{name}]"] = {
            "ms": timer.ms(bwd),
            "forward_backward_ms": cs.events_ms(port_fb, flush=timer.flush),
            "launches": cs.backward_split(
                cs.launch_split(bwd), seen=seen, dq=dq_, dv=dv_,
                delta_bytes=cs.nbytes(out, d_out) + b * h * sq * 4)}
        del q, k, v, d_out, out, lse, leaves
        torch.cuda.empty_cache()

    cfg = get_config("skymemory-tinyllama")
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    step = cs.step_breakdown(model, dev)
    row["graph_decode_step_ms"] = step["graph_step_ms"]
    row["step_paged_decode_ms"] = step["paged_decode_ms"]
    wave, attention = cs.prefill_wave(model, dev)
    row["wave_chunked_prefill_paged_ms"] = timer.ms(attention)
    try:
        row["graph_wave_ms"] = cs.graph_replay_ms(wave, "prefill wave")
    except RuntimeError as e:      # a host read inside the captured wave
        row["graph_wave_ms"] = None
        row["graph_wave_error"] = str(e).splitlines()[0]

    del model, wave, attention
    torch.cuda.empty_cache()
    mamba = Model(get_config("mamba2-1.3b"), device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    prefill, scan, _ = cs.ssm_prefill(mamba, dev)
    row["prefill_ssd_chunk_scan_ms"] = timer.ms(scan)
    row["graph_mamba2_prefill_ms"] = cs.graph_replay_ms(
        prefill, "mamba2 prefill", iters=5)
    return row


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print("[ab] " + json.dumps(one(Path(argv[2]).resolve())), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for root in argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
