"""k4_roofline (%, device trace): K4, ``flash_prefill``
(kernels/csrc/chunked_prefill.cu, dense), against its roofline.

Per launch, ``B`` rows of ``Sq`` queries at offset ``q0`` over ``Skv``
keys; causal query ``i`` sees ``min(q0 + i + 1, Skv)`` keys (all
``Skv`` when not causal):
    flops = 2 * B * H * (D + Dv) * pairs
    bytes = B * (Sq * H * (D + Dv) + Skv * Hkv * (D + Dv)) * s
The share is the bounds over the device time."""
from skybench import readings

UNIT, LAYER = "%", "kernels (kernels/csrc)"


def count(m: dict) -> tuple[float, float]:
    b, sq, h, d = m["q"]
    skv, hkv, dv = m["kv"][1], m["kv"][2], m["dv"]
    q0 = m["q_offset"]
    if m["causal"]:
        pairs = sum(min(q0 + i + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    n_bytes = b * (sq * h + skv * hkv) * (d + dv) * m["itemsize"]
    return n_bytes, 2.0 * b * h * (d + dv) * pairs


def read(run):
    return readings.roofline_share(run, "k4", count)
