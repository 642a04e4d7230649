"""Quickstart: the SkyMemory protocol in 60 lines.

Builds a 15x15 LEO constellation, stores a prompt's KV cache as chained
128-token blocks striped in 6 kB chunks over 10 satellites (rotation+hop
placement), rotates the constellation, and retrieves the cache again.

The port of ``examples/quickstart.py`` onto ``repro_torch.core``: the
same protocol and the same output, without JAX.

Run: PYTHONPATH=src python examples/torch_quickstart.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    ConstellationKVC,
    ConstellationSpec,
    IslTransport,
    LosWindow,
    Sat,
    Strategy,
    chain_hashes,
)


def main() -> None:
    spec = ConstellationSpec(num_planes=15, sats_per_plane=15,
                             altitude_km=550.0)
    print(f"constellation: {spec.num_sats} sats, "
          f"intra-plane ISL {spec.intra_plane_distance_km():.0f} km "
          f"({spec.intra_plane_latency_s()*1e3:.1f} ms/hop)")

    window = LosWindow(Sat(7, 7), 9, 9)
    transport = IslTransport(spec, ground_hosted=True,
                             chunk_processing_time_s=0.002)
    kvc = ConstellationKVC(spec, window, Strategy.ROTATION_HOP,
                           num_servers=10, chunk_bytes=6 * 1024,
                           transport=transport)

    # A "prompt" and its (fake) per-block KVC payloads.
    tokens = list(range(512))                     # 4 blocks of 128 tokens
    hashes = chain_hashes(tokens, 128)
    for i, h in enumerate(hashes):
        payload = bytes([i]) * (64 * 1024)        # 64 kB per block
        meta = kvc.set_block(h, payload)
        print(f"set block {i}: {meta.n_chunks} chunks striped over "
              f"{kvc.num_servers} satellites")

    # Longest-prefix lookup (binary search over chained hashes).
    n = kvc.lookup_longest(hashes)
    print(f"longest cached prefix: {n} blocks "
          f"(worst-case fetch {transport.stats.op_latencies_s[-1]*1e3:.2f} ms)")

    # The constellation rotates; chunks migrate per orbital plane.
    moves = kvc.rotate(steps=5)
    print(f"rotated 5 steps: migrated {len(moves)} servers "
          f"(all within their orbital plane: "
          f"{all(m.src.plane == m.dst.plane for m in moves)})")

    payload = kvc.get_block(hashes[-1])
    print(f"block 3 after rotation: {len(payload)} bytes intact, "
          f"hits={kvc.stats.block_hits} misses={kvc.stats.block_misses}")


if __name__ == "__main__":
    main()
