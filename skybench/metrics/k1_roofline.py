"""k1_roofline (%, device trace): K1/K2, ``paged_decode``
(kernels/csrc/paged_attention.cu), against its roofline.

Per launch, from the lengths it was given (``B`` rows of ``L_b`` valid
tokens, ``H`` query heads over ``Hkv`` K/V heads of widths ``D`` and
``Dv``, elements of ``s`` bytes): it reads each valid key and value once,
q once, and writes out once,
    bytes = (sum_b L_b * Hkv * (D + Dv) + B * H * (D + Dv)) * s,
and multiplies each query head by each valid key and value,
    flops = 2 * H * (D + Dv) * sum_b L_b.
Its bound is the larger of bytes at 3.35 TB/s and FLOPs at 989 TFLOP/s
(a decode is bound by the bytes); the share is the launches' bounds over
their device time in the trace.  (The count of ``chip_smoke.py``'s
paged-decode cases, taken at each launch's own lengths.)"""
from skybench import readings

UNIT, LAYER = "%", "kernels (kernels/csrc)"


def count(m: dict) -> tuple[float, float]:
    b, h, d = m["q"]
    hkv, dv = m["kv"][-2], m["dv"]
    tokens = float(m["lengths"].sum().item())
    n_bytes = (tokens * hkv * (d + dv) + b * h * (d + dv)) * m["itemsize"]
    return n_bytes, 2.0 * h * (d + dv) * tokens


def read(run):
    return readings.roofline_share(run, "k1", count)
