"""Roofline terms of a counted step, priced on an H100: the port's
``repro/launch/roofline.py``.

compute term    = FLOPs per device / 989 TFLOP/s (bf16, dense)
memory term     = bytes accessed per device / 3.35 TB/s (HBM3)
collective term = link bytes per device / the group's link rate

The constants are NVIDIA's data sheet for the H100 SXM at its 700 W
limit.  A collective whose ranks all lie on one 8-card host rides NVLink
(450 GB/s each way per card); one whose group crosses hosts rides the
cluster's network, assumed to be one 400 Gb/s NIC per card (50 GB/s each
way) -- a property of the cluster, not of the card.  On the production
meshes every group crosses hosts: a 16-rank ``model`` axis spans two.

The counts are per device, as the reference's ``cost_analysis`` is per
partition: ``launch.specs.lower_plan`` counts rank 0's local shapes.  The
reference reads its collectives from the compiled HLO's text; the port
reads them from ``CommDebugMode`` (``collectives_from``) and turns each
result into link traffic with the reference's ring multipliers
(``collective_traffic``).
"""
from __future__ import annotations

from dataclasses import InitVar, asdict, dataclass, field

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s each way per card, within a host
NIC_BW = 50e9                # bytes/s each way per card, across hosts
                             # (assumed: one 400 Gb/s NIC per card)
HOST_CARDS = 8               # cards one NVLink domain holds

_CHIPS = {"16x16": 256, "2x16x16": 512}

# torch's collectives (``DTensor``'s functional ones and the c10d ops the
# port calls) -> the reference's HLO names
_OP_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def collective_traffic(op: str, result_bytes: float,
                       group_size: int) -> float:
    """Per-device link bytes of one collective (ring estimates): ``op`` is
    the reference's HLO name, ``result_bytes`` the per-device result."""
    n = group_size
    frac = (n - 1) / n if n > 1 else 0.0
    if op == "all-gather":
        return result_bytes * frac
    if op == "all-reduce":
        return 2.0 * result_bytes * frac
    if op == "reduce-scatter":
        return result_bytes * (n - 1)
    if op == "all-to-all":
        return result_bytes * frac
    return float(result_bytes)        # collective-permute


def within_host(ranks) -> bool:
    """Whether a group's ranks all lie on one host of ``HOST_CARDS``."""
    return len({r // HOST_CARDS for r in ranks}) <= 1


def op_name(schema_name: str) -> str | None:
    """The reference's name of a torch collective (``"c10d::allreduce_"``
    -> ``"all-reduce"``; ``None`` where the op is no collective)."""
    return _OP_NAMES.get(schema_name.rsplit("::", 1)[-1])


def collectives_from(comm_mode) -> tuple[dict[str, float], float]:
    """``({type: link bytes}, NVLink bytes)`` of the collectives a
    ``CommDebugMode`` recorded: each record ``(type, result_bytes,
    ranks)``, on rank 0's local shapes (``launch.specs.CommRecorder``).
    The second value is the part of the total whose groups lie within
    one host."""
    out: dict[str, float] = {}
    nvlink = 0.0
    for op, result_bytes, ranks in comm_mode.records:
        traffic = collective_traffic(op, result_bytes, len(ranks))
        out[op] = out.get(op, 0.0) + traffic
        if within_host(ranks):
            nvlink += traffic
    return out, nvlink


def _chips(mesh: str) -> int:
    """Cards of a mesh name: the reference's map, else the product of
    the name's factors (``"1x1"``), else 256 as the reference."""
    if mesh in _CHIPS:
        return _CHIPS[mesh]
    try:
        n = 1
        for f in mesh.split("x"):
            n *= int(f)
        return n
    except ValueError:
        return 256


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    step: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collectives: dict = field(default_factory=dict)
    peak_memory_bytes: float = 0.0
    argument_bytes: float = 0.0
    model_flops: float = 0.0
    nvlink_bytes: InitVar[float] = 0.0    # of collective_bytes, in a host

    def __post_init__(self, nvlink_bytes: float) -> None:
        self._nvlink_bytes = float(nvlink_bytes)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        cross = self.collective_bytes - self._nvlink_bytes
        return self._nvlink_bytes / NVLINK_BW + cross / NIC_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global counted FLOPs -- remat/redundancy waste
        probe."""
        total = self.flops_per_device * _chips(self.mesh)
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            dominant=self.dominant,
            useful_flops_ratio=self.useful_flops_ratio,
        )
        return d


def streaming_attn_correction(cfg, shape, remat: str | None) -> float:
    """Global FLOPs that the reference's HLO undercounts for the 32k+
    prefill shapes: its streaming jnp attention's kv-block ``lax.scan``
    body is cost-counted once, and this restores the missing (nb-1)/nb
    of the attention matmul work.  Kept as the reference computes it,
    for parity alone: no code of the port calls it.  The port counts
    every block of its streaming attention (``ops.flash_attention`` on
    the CPU), so ``launch.dryrun`` adds none of it."""
    from repro_torch.kernels.ref import (
        STREAMING_BLOCK_K,
        STREAMING_KV_THRESHOLD,
    )
    from repro_torch.models import cache as cache_lib

    if shape.kind not in ("train", "prefill") or cfg.is_attention_free:
        return 0.0
    s = shape.seq_len // 2 if cfg.is_encoder_decoder else shape.seq_len
    if s < STREAMING_KV_THRESHOLD:
        return 0.0
    nb = -(-s // STREAMING_BLOCK_K)
    hd = cfg.head_dim
    if cfg.use_mla:
        hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    per_layer = 4.0 * shape.global_batch * cfg.num_heads * hd * float(s) ** 2
    n_attn = cache_lib.n_attn_layers(cfg)
    if cfg.is_encoder_decoder:
        # encoder self + decoder self + cross, all at s = seq/2
        n_attn = cfg.num_encoder_layers + 2 * cfg.num_layers
    fwd = per_layer * n_attn
    if shape.kind == "train":
        factor = {"full": 4.0, "dots": 3.0, "dots_no_batch": 3.0}.get(
            remat or "none", 3.0)
    else:
        factor = 1.0
    return fwd * factor * (nb - 1) / nb


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill), 2·N_active·new_tokens (decode)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per sequence
