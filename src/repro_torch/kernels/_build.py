"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/repro_torch_kernels/<name>-<hash>.so`` at the
root of the checkout, for ``sm_90a`` (Hopper).  The hash covers the
sources of the whole ``csrc`` directory and the compiler flags, so an
edited source rebuilds and an unchanged one loads the library already
built.  Nothing is compiled when this module is imported: the first call
of a kernel wrapper builds (or loads) its library; ``build_all`` builds
every source at once, one ``nvcc`` process each, all started together.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.  ``count`` adds one
to a wrapper's ``launches``.  ``refuse_grad`` keeps a wrapper from
silently detaching an autograd graph: a ``ctypes`` call is outside
autograd, so a wrapper without a backward raises where a graph would
pass through it.

The serving engine calls the wrappers from two threads (the decode loop
and the adapter's write-back worker), so the first build of a library
and the launch counts are taken under locks.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOAD_LOCK = threading.Lock()    # one nvcc per source, even from two threads
_COUNT_LOCK = threading.Lock()

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signature of every entry point: (argtypes), restype is c_int
SIGNATURES: dict[str, dict[str, tuple]] = {
    "paged_attention": {
        f"paged_decode_{t}": (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F,
                              P)
        for t in ("f32", "bf16")
    },
    "chunked_prefill": {
        **{f"chunked_prefill_paged_{t}":
           (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, P)
           for t in ("f32", "bf16")},
        **{f"flash_prefill_{t}":
           (P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, I, I, P)
           for t in ("f32", "bf16")},
    },
    "flash_backward": {
        **{f"flash_prefill_bwd_{t}": (P, P, P, P, P, P, P, P, P, P, I, I, I,
                                      I, I, I, I, F, I, I, I, I, P)
           for t in ("f32", "bf16")},
        "flash_prefill_bwd_plan": (I, I, P),
    },
    "ssd_scan": {
        "ssd_scan_f32": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P),
        "ssd_scan_bf16": (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, final)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one build; move the library into place; return the
    compiler's output (register and shared-memory use per kernel)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)     # atomic: concurrent builders never see half
    return log


def build_all() -> dict[str, str]:
    """Build every kernel source in parallel; returns nvcc's output per
    source (empty for a library that was already built)."""
    with _LOAD_LOCK:
        started = {name: _start(name) for name in SIGNATURES}
        return {name: _finish(name, st) for name, st in started.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOAD_LOCK:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad is enabled and one of
    ``tensors`` requires it: the kernel has no backward, and its output
    would come out detached.  Called before any device check, so that
    the refusal holds on every device."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the kernel has no backward; call it under "
            "torch.no_grad() or on tensors that do not require grad")


def count(wrapper) -> None:
    """Add one to ``wrapper.launches``: call it where the wrapper has
    launched its kernel, and nowhere else."""
    with _COUNT_LOCK:
        wrapper.launches += 1
