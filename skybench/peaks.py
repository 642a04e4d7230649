"""The H100's published peaks (NVIDIA's data sheet, SXM part, dense
rates, at the full 700 W power limit)."""

BF16_FLOPS = 989e12          # bf16 tensor-core FLOP/s
HBM_BYTES = 3.35e12          # HBM3 bytes/s


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of bytes over the
    memory bandwidth and FLOPs over the bf16 peak."""
    return max(n_bytes / HBM_BYTES, flops / BF16_FLOPS)
