"""Linear cost probing: the reference's per-layer split of a step's
counts, the port's ``repro/launch/probe.py``.

Every metric (flops, bytes, per-type collective traffic) is

    metric = outside + sum_t  n_t * per_layer_t

over the architecture's layer types t (dense block, moe block, mamba
block, shared-attn block, encoder block, decoder block).  The reference
needs the probes because XLA counts a ``lax.scan`` body once; the port's
layers are a Python loop and ``launch.specs.lower_plan`` counts every
one, so ``launch.dryrun`` counts the full depth directly and solves the
probes beside it: the two must agree, which checks the linear model at
every combination.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ProbeSet:
    var_names: tuple[str, ...]           # layer-type variables
    full_counts: dict[str, int]          # counts in the real config
    variants: tuple[tuple[dict, dict], ...]  # (cfg overrides, counts)


def probe_set(cfg: ModelConfig) -> ProbeSet:
    if cfg.is_encoder_decoder:
        return ProbeSet(
            ("enc", "dec"),
            {"enc": cfg.num_encoder_layers, "dec": cfg.num_layers},
            (
                ({"num_encoder_layers": 1, "num_layers": 1},
                 {"enc": 1, "dec": 1}),
                ({"num_encoder_layers": 2, "num_layers": 1},
                 {"enc": 2, "dec": 1}),
                ({"num_encoder_layers": 1, "num_layers": 2},
                 {"enc": 1, "dec": 2}),
            ),
        )
    if cfg.arch_type == "hybrid" and cfg.attn_layer_period:
        n_attn = cfg.num_layers // cfg.attn_layer_period
        return ProbeSet(
            ("mamba", "attn"),
            {"mamba": cfg.num_layers, "attn": n_attn},
            (
                ({"num_layers": 2, "attn_layer_period": 0},
                 {"mamba": 2, "attn": 0}),
                ({"num_layers": 4, "attn_layer_period": 0},
                 {"mamba": 4, "attn": 0}),
                ({"num_layers": 2, "attn_layer_period": 2},
                 {"mamba": 2, "attn": 1}),
            ),
        )
    if cfg.use_mla and cfg.first_k_dense:
        n_moe = cfg.num_layers - cfg.first_k_dense
        return ProbeSet(
            ("dense", "moe"),
            {"dense": cfg.first_k_dense, "moe": n_moe},
            (
                ({"num_layers": 2, "first_k_dense": 1},
                 {"dense": 1, "moe": 1}),
                ({"num_layers": 3, "first_k_dense": 2},
                 {"dense": 2, "moe": 1}),
                ({"num_layers": 3, "first_k_dense": 1},
                 {"dense": 1, "moe": 2}),
            ),
        )
    # homogeneous stacks (dense / vlm / moe / ssm)
    return ProbeSet(
        ("block",),
        {"block": cfg.num_layers},
        (
            ({"num_layers": 1}, {"block": 1}),
            ({"num_layers": 2}, {"block": 2}),
        ),
    )


def extract_metrics(counted) -> dict[str, float]:
    """The probe metrics of a ``launch.specs.Counted``: flops, bytes,
    collective bytes (and their part within one host), and each
    collective type's bytes."""
    cost = counted.cost_analysis()
    m = {
        "flops": float(cost.get("flops", 0.0)),
        "bytes": float(cost.get("bytes accessed", 0.0)),
        "collective_bytes": float(sum(counted.collectives.values())),
        "nvlink_bytes": float(counted.nvlink_bytes),
    }
    for k, v in counted.collectives.items():
        m[f"coll:{k}"] = float(v)
    return m


def solve_linear(
    pset: ProbeSet, measured: list[dict[str, float]]
) -> dict[str, float]:
    """Solve metric = outside + sum_t n_t x_t for the full-depth counts."""
    nvar = len(pset.var_names)
    a = np.zeros((len(measured), nvar + 1))
    a[:, 0] = 1.0
    for i, (_, counts) in enumerate(pset.variants):
        for j, name in enumerate(pset.var_names):
            a[i, j + 1] = counts.get(name, 0)
    keys = sorted({k for m in measured for k in m})
    out: dict[str, float] = {}
    for key in keys:
        y = np.array([m.get(key, 0.0) for m in measured])
        sol, *_ = np.linalg.lstsq(a, y, rcond=None)
        total = sol[0] + sum(
            sol[j + 1] * pset.full_counts[name]
            for j, name in enumerate(pset.var_names)
        )
        out[key] = max(float(total), 0.0)
    return out
