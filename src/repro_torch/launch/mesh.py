"""The production meshes and the axis rules for one model and input
shape: the port's ``repro/launch/mesh.py``."""
from __future__ import annotations

from repro_torch.distributed.sharding import AxisRules, MeshShape, mesh_sizes
from repro_torch.models.config import InputShape, ModelConfig


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The 16x16 single-pod mesh ``("data", "model")``, or 2x16x16
    ``("pod", "data", "model")`` across pods, as a ``MeshShape``: the
    port builds no 256- or 512-rank mesh, and specs and plans need only
    the axis names and sizes."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_rules(
    mesh,
    cfg: ModelConfig,
    shape: InputShape,
    *,
    fsdp: bool | None = None,
    seq_shard: bool | None = None,
    shard_kv_heads: bool = True,
    seq_parallel_acts: bool = False,
    attn_tp: bool | None = None,
) -> AxisRules:
    """Per-(arch, shape) axis rules over ``mesh`` (a ``DeviceMesh`` or a
    ``MeshShape``), with the reference's levers and defaults.

    * train/prefill: batch over (pod, data), TP over model, FSDP params.
    * decode: batch over (pod, data); batch-1 long-context shards the KV
      cache *sequence* over data instead -- the SkyMemory chunk striping
      (``seq_shard`` None: when the batch is below the data axes' size).
      Decode keeps the attention weights' heads local (``attn_tp`` None:
      True except at decode).
    * ``fsdp`` None means True; ``shard_kv_heads`` False replicates the
      K/V projections; ``seq_parallel_acts`` shards the residual stream's
      activations over (data, model).
    """
    sizes = mesh_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dsize = 1
    for a in data_axes:
        dsize *= sizes[a]
    if seq_shard is None:
        seq_shard = shape.is_decode and shape.global_batch < dsize
    if fsdp is None:
        fsdp = True
    if attn_tp is None:
        attn_tp = not shape.is_decode
    return AxisRules(
        mesh=mesh,
        data_axes=data_axes,
        model_axis="model",
        shard_kv_heads=shard_kv_heads,
        seq_shard_cache=seq_shard,
        fsdp=fsdp,
        attn_tp=attn_tp,
        seq_parallel_acts=seq_parallel_acts,
    )
