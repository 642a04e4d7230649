#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 15 (the sharded serve step) for one or
more checkouts of this repository, in turns, on one NVIDIA card.

    python3 tools/ab_serve_mesh.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (it holds ``src/repro_torch``); pass
the same root twice to see the spread, e.g. ``old new new old``.  Every
root runs in a process of its own, in the order given: it builds its
kernels into its own ``build/``, opens a one-rank NCCL group and runs
``phase_serve_mesh`` of the ``chip_smoke.py`` beside this script, which
prints its ``[serve_mesh]`` lines: per-step host ms of the sharded and
the unsharded serve steps, their checks, and K1 at 32,768 tokens.  A
line ``[ab] ROOT`` comes before each root's output.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def one(root: Path) -> None:
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    sys.path.insert(0, str(root / "src"))   # ahead of chip_smoke's own
    import repro_torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("ab_serve_mesh: no CUDA device is available")
    print(f"[ab] repro_torch from {Path(repro_torch.__file__).parent}",
          flush=True)
    dev = torch.device("cuda", 0)
    _, smi = cs.phase_device()
    _build.build_all()
    store = cs.start_world(dev)
    try:
        cs.phase_serve_mesh(dev, cs.Timer(dev), smi)
    finally:
        cs.close_world(store)


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        one(Path(argv[2]).resolve())
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv[1:]:
        print(f"[ab] {root}", flush=True)
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
