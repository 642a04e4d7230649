"""Arithmetic the metric readers share: the benchmark's spans inside the
window, and a kernel family's share of its roofline."""
from __future__ import annotations

from skybench import peaks
from skybench.trace import EXECUTOR_SPANS


def spans(run, names=EXECUTOR_SPANS) -> list[tuple[str, float, float]]:
    """The benchmark's spans of ``names`` that lie inside the window."""
    if run.rec is None:
        return []
    return [(n, a, b) for n, a, b in run.rec.spans
            if n in names and run.w0 <= a and b <= run.w1]


def roofline_share(run, kind: str, count) -> float | None:
    """Percent: the least time the launches of ``kind`` recorded in the
    trace's window could take (the larger of their bytes over the memory
    bandwidth and their FLOPs over the bf16 peak, ``count(meta) -> (bytes,
    flops)`` per launch) over the device time its kernels took in the
    trace.  None when none was traced."""
    if run.trace is None or not run.trace.kernel_s.get(kind):
        return None
    bound = sum(peaks.bound_s(*count(x.meta)) for x in run.rec.launches
                if x.kind == kind)
    return 100.0 * bound / run.trace.kernel_s[kind]
