"""Reproduce the paper's simulation study (Figs 1, 2, 16) as console tables.

The port of ``examples/constellation_sim.py`` onto
``repro_torch.core.simulator``: the same tables, without JAX.

Run: PYTHONPATH=src python examples/torch_constellation_sim.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.mapping import Strategy, layout_grid  # noqa: E402
from repro_torch.core.simulator import (  # noqa: E402
    SimConfig,
    intra_plane_latency_s,
    memory_tier_for_latency,
    sweep,
)


def main() -> None:
    print("=== Figs 1-2: one-hop intra-plane ISL latency (ms) ===")
    ms = (10, 15, 30, 50, 70, 100)
    hs = (160, 550, 1000, 2000)
    print("M\\h(km) " + "".join(f"{h:>9}" for h in hs))
    for m in ms:
        row = [intra_plane_latency_s(m, h) * 1e3 for h in hs]
        tier = memory_tier_for_latency(row[1] / 1e3)
        print(f"{m:<7} " + "".join(f"{v:9.2f}" for v in row) + f"   [{tier}]")

    print("\n=== Figs 13-15: placement layouts (5x5) ===")
    for strat in Strategy:
        print(f"-- {strat.value}")
        for row in layout_grid(strat, 5):
            print("   " + " ".join(f"{v:3d}" for v in row))

    print("\n=== Fig 16: worst-case block-fetch latency (ms) ===")
    rows = sweep(servers=(9, 25, 49, 81), altitudes_km=(160., 550., 2000.),
                 base=SimConfig(chunk_processing_time_s=0.002))
    print(f"{'strategy':14} {'servers':>7} {'alt(km)':>8} {'latency':>10} "
          f"{'prop':>9} {'proc':>9}")
    for r in rows:
        print(f"{r.strategy:14} {r.num_servers:7d} {r.altitude_km:8.0f} "
              f"{r.worst_latency_s*1e3:9.1f}ms {r.worst_propagation_s*1e3:8.2f}ms "
              f"{r.worst_processing_s*1e3:8.1f}ms")

    by = {}
    for r in rows:
        by.setdefault((r.num_servers, r.altitude_km), {})[r.strategy] = (
            r.worst_latency_s)
    wins = sum(
        1 for v in by.values()
        if v["rotation_hop"] <= min(v["rotation"], v["hop"])
    )
    print(f"\nrotation+hop lowest in {wins}/{len(by)} configs "
          f"(paper: lowest across altitudes)")


if __name__ == "__main__":
    main()
