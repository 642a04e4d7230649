"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``.  Asking for CUDA where there is none raises: the port never
drops to the CPU on its own.  Callers that want the CPU (the tests) pass
``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
