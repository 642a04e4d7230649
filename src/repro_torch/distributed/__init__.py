"""Sharded execution over a ``torch.distributed`` device mesh: the
reference's axis rules as ``DTensor`` layouts."""
from repro_torch.distributed.sharding import (
    AxisRules,
    MeshShape,
    active_rules,
    batch_spec,
    cache_shardings,
    cache_specs,
    distribute_cache,
    distribute_model,
    maybe_shard,
    param_shardings,
    param_specs,
    use_rules,
)

__all__ = [
    "AxisRules",
    "MeshShape",
    "active_rules",
    "batch_spec",
    "cache_shardings",
    "cache_specs",
    "distribute_cache",
    "distribute_model",
    "maybe_shard",
    "param_shardings",
    "param_specs",
    "use_rules",
]
