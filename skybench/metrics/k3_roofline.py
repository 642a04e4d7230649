"""k3_roofline (%, device trace): K3, ``chunked_prefill_paged``
(kernels/csrc/chunked_prefill.cu, paged), against its roofline.

Per launch, row ``r`` of the chunk holds ``n_r = L_r - o_r`` real query
tokens at offset ``o_r`` over ``L_r`` valid pool tokens (padding rows of
the chunk buffer are not counted):
    pairs = sum_r (n_r * o_r + n_r * (n_r + 1) / 2)   (causal)
    flops = 2 * H * (D + Dv) * pairs
    bytes = sum_r (L_r * Hkv * (D + Dv) + n_r * H * (D + Dv)) * s
(each valid key and value read once, each real query row read and its
output written once).  The share is the bounds over the device time."""
from skybench import readings

UNIT, LAYER = "%", "kernels (kernels/csrc)"


def count(m: dict) -> tuple[float, float]:
    _, _, h, d = m["q"]
    hkv, dv = m["kv"][-2], m["dv"]
    lengths = m["lengths"].tolist()
    offsets = m["offsets"].tolist()
    pairs = n_bytes = 0.0
    for length, off in zip(lengths, offsets):
        n = length - off
        pairs += n * off + n * (n + 1) / 2
        n_bytes += (length * hkv + n * h) * (d + dv)
    return n_bytes * m["itemsize"], 2.0 * h * (d + dv) * pairs


def read(run):
    return readings.roofline_share(run, "k3", count)
