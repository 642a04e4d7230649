"""What a traced run records: the benchmark's own spans around calls into
the port's layers, the arguments of each attention-kernel launch, and a
``torch.profiler`` trace of the device over part of the window.

Spans wrap the port's methods from outside (the instance attributes are
replaced for the run): the scheduler's round (``service``) and the
executor's device programs (``step``, ``chunk_wave``, ``prefill_dense``,
``prefill_exact``, ``prefill_chunk_eager``).  Each span is timed on the
host clock; the launches put that clock on the trace's (``read_trace``),
so the trace can say what the host was doing in each idle gap of the
device.

Kernel launches: ``kernels.ops.paged_attention`` (K1/K2),
``chunked_prefill_paged`` (K3) and ``flash_attention`` (K4) are wrapped
so that each call's sizes are kept while the profiler runs: the lengths
and offsets the kernel reads are copied on the device (a small copy per
launch, and only then).  Launches pass a gate that the profiler's start
and stop also take, with the device synchronised, so the calls recorded
are exactly those the trace holds; the kernels of each family run on one
stream in launch order, so the n-th recorded call is the n-th such
kernel of the trace.

``busy_union`` is ``chip_smoke.py::_busy_ms``'s arithmetic: the union of
the device's intervals (kernels, copies, sets).
"""
from __future__ import annotations

import bisect
import sys
import threading
import time
from dataclasses import dataclass, field

import torch

# the executor's calls that get a span
EXECUTOR_SPANS = ("step", "chunk_wave", "prefill_dense", "prefill_exact",
                  "prefill_chunk_eager")
# kernel families: the ops entry point, and a word of its kernels' names
KERNELS = {"k1": ("paged_attention", "paged_decode"),
           "k3": ("chunked_prefill_paged", "prefill_"),
           "k4": ("flash_attention", "prefill_")}


@dataclass
class Launch:
    kind: str                   # k1 | k3 | k4
    meta: dict                  # shapes and device copies of lengths
    host_t: float               # host clock when it was launched


@dataclass
class Recorder:
    """Spans and launches of one run; ``profiling`` while the trace runs."""

    spans: list = field(default_factory=list)       # (name, t0, t1)
    launches: list = field(default_factory=list)
    profiling: bool = False
    gate: threading.Lock = field(default_factory=threading.Lock)
    prof: object = None
    trace_t: tuple = (0.0, 0.0)
    _saved: list = field(default_factory=list)

    # -- spans -----------------------------------------------------------
    def _span(self, name: str, fn):
        rec = self.spans

        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            rec.append((name, t0, time.perf_counter()))
            return out
        return call

    def _patch(self, obj, attr: str, new) -> None:
        self._saved.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, new)

    def instrument(self, engine) -> None:
        """Wrap the engine's layers and the attention kernels."""
        from repro_torch.kernels import ops

        self._patch(engine.scheduler, "service",
                    self._span("service", engine.scheduler.service))
        for n in EXECUTOR_SPANS:
            self._patch(engine.executor, n,
                        self._span(n, getattr(engine.executor, n)))
        for kind, (entry, _) in KERNELS.items():
            self._patch(ops, entry, self._launcher(kind, getattr(ops,
                                                                 entry)))

    def restore(self) -> None:
        for obj, attr, old in reversed(self._saved):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
        self._saved.clear()

    # -- kernel launches -------------------------------------------------
    def _launcher(self, kind: str, fn):
        def call(q, k, v, *a, **kw):
            with self.gate:
                if self.profiling:
                    self.launches.append(Launch(
                        kind, _meta(kind, q, k, v, a, kw),
                        time.perf_counter()))
                return fn(q, k, v, *a, **kw)
        return call

    # -- the profiler ----------------------------------------------------
    def arm_trace(self) -> None:
        """Start the profiler in its warm-up phase (its tracer set up, no
        event kept), in set-up: starting it costs seconds."""
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU]
        self.prof = profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1))
        self.prof.start()

    def start_trace(self) -> None:
        with self.gate:
            _sync()
            self.prof.step()
            self.profiling = True
            self.trace_t = (time.perf_counter(), 0.0)

    def stop_trace(self) -> None:
        with self.gate:
            self.profiling = False
            _sync()
            self.trace_t = (self.trace_t[0], time.perf_counter())
            self.prof.stop()


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _meta(kind, q, k, v, a, kw) -> dict:
    """What a launch's roofline needs, with device copies of the lengths
    (``clone`` keeps them as the kernel read them)."""
    if kind == "k1":
        lengths = a[0]
        return dict(q=tuple(q.shape), kv=tuple(k.shape), dv=v.shape[-1],
                    itemsize=q.element_size(), lengths=lengths.clone())
    if kind == "k3":
        lengths, _, offsets = a[0], a[1], a[2]
        return dict(q=tuple(q.shape), kv=tuple(k.shape), dv=v.shape[-1],
                    itemsize=q.element_size(), lengths=lengths.clone(),
                    offsets=offsets.clone())
    return dict(q=tuple(q.shape), kv=tuple(k.shape), dv=v.shape[-1],
                itemsize=q.element_size(), causal=kw.get("causal", True),
                q_offset=int(kw.get("q_offset", 0)),
                window=kw.get("sliding_window"))


@dataclass
class Trace:
    """The device's side of the traced part of the window (seconds)."""

    window_s: float
    busy_s: float
    ops: dict                   # kernel name -> total seconds
    gaps: dict                  # host span label -> idle seconds
    kernel_s: dict              # k1 | k3 | k4 -> its kernels' seconds


def busy_union(spans: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _device_events(prof) -> list[tuple[float, float, str]]:
    """``(start_us, end_us, name)`` of every device event of the trace,
    from the profiler's raw events (building ``prof.events()`` costs
    far more)."""
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
                 e.name()) for e in raw if e.device_type() == DeviceType.CUDA]
    except AttributeError:
        return [(e.time_range.start, e.time_range.end, e.name)
                for e in prof.events() if e.device_type == DeviceType.CUDA]


def read_trace(rec: Recorder) -> Trace | None:
    """The trace's device intervals; each attention family's kernel
    seconds; each idle gap of the device labelled by the benchmark span
    the host was in, the host clock put on the trace's by the launches (a
    kernel starts a few microseconds after its launch at the soonest: the
    least difference is the offset, taken from the families whose
    launches and kernels pair one to one).  None when the trace holds no
    device event."""
    dev = sorted(_device_events(rec.prof))
    if not dev:
        return None
    ops: dict[str, float] = {}
    for a, b, n in dev:
        ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
    busy = busy_union([(a, b) for a, b, _ in dev]) / 1e6
    offsets, kernel_s = [], {}
    for kind, (_, word) in KERNELS.items():
        found = [(a, b) for a, b, n in dev if word in n and _family(kind, n)]
        mine = [x for x in rec.launches if x.kind == kind]
        if found:
            kernel_s[kind] = sum(b - a for a, b in found) / 1e6
        if len(mine) != len(found):
            # a launch at the trace's edge: the totals stand, the pairing
            # does not
            print(f"[trace] {kind}: {len(mine)} launches recorded, "
                  f"{len(found)} in the trace", file=sys.stderr)
            continue
        offsets += [a - x.host_t * 1e6 for x, (a, _) in zip(mine, found)]
    gaps: dict[str, float] = {}
    if offsets:
        off = min(offsets)
        host = sorted((a * 1e6 + off, b * 1e6 + off, n)
                      for n, a, b in rec.spans)
        starts = [h[0] for h in host]
        end = dev[0][1]
        for a, b, _ in dev[1:]:
            if a > end:
                lab = _label(host, end, a, starts)
                gaps[lab] = gaps.get(lab, 0.0) + (a - end) / 1e6
            end = max(end, b)
    window_s = rec.trace_t[1] - rec.trace_t[0]
    return Trace(window_s, busy, ops, gaps, kernel_s)


def _family(kind: str, name: str) -> bool:
    """K3 and K4 are instances of one template: the paged one has
    ``PAGED`` true in its name."""
    if kind == "k1":
        return True
    paged = "true>" in name.replace(" ", "")
    return paged if kind == "k3" else not paged


def _label(host, a: float, b: float, starts=None) -> str:
    """The innermost span that covers the middle of the gap ``(a, b)``.
    Spans nest (a step inside a scheduler round), so the covering ones
    start shortly before the middle: look back a few from it."""
    mid = 0.5 * (a + b)
    j = bisect.bisect_right(starts, mid)
    best = None
    for s, e, n in host[max(0, j - 16): j]:
        if e >= mid and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return "host, outside any span" if best is None else best[2]
