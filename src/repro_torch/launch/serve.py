"""Serving launcher, the port's ``repro/launch/serve.py``: one prompt
served ``--repeat`` times through ``Engine`` with the SkyMemory prefix
cache on the paper's 19x5 constellation (10 LOS servers, 6 kB chunks).
Round 0 writes the prompt's blocks back; every later round restores them.
Random weights from ``--seed``.  It runs on the card unless ``--device
cpu`` is given; ``--tiny`` serves the same-family smoke config in f32,
without it the model runs at full size in its config's dtype.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch skymemory-tinyllama --tiny --device cpu --prompt "hello" --repeat 3

The attention-free and hybrid families (``mamba2-1.3b``, ``zamba2-1.2b``)
serve through the dense runtime: ``Engine`` dispatches on
``model.supports_paged_decode``.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.core import (
    ConstellationKVC,
    ConstellationSpec,
    LosWindow,
    Sat,
    Strategy,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serving import Engine, GenerationResult, Request, SamplingParams


@dataclass
class Served:
    """What one launch served: each round's result, the fabric (None
    with ``--no-cache``) and the engine that served them."""

    results: list[GenerationResult]
    kvc: ConstellationKVC | None
    engine: Engine


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS, default="skymemory-tinyllama")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--prompt", default="SkyMemory caches KV blocks in orbit. ")
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--strategy", default="rotation_hop",
                   choices=[s.value for s in Strategy])
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--planes", type=int, default=5)
    p.add_argument("--sats-per-plane", type=int, default=19)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def serving_config(args: argparse.Namespace) -> ModelConfig:
    """The config ``args`` ask for; the encoder-decoder and VLM families
    have no text-only serving path here."""
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = smoke_config(cfg).replace(dtype="float32")
    if cfg.is_encoder_decoder or cfg.arch_type == "vlm":
        raise SystemExit("serve launcher supports text-only archs; "
                         "see examples/ for frontends")
    return cfg


def build_engine(model: Model, args: argparse.Namespace
                 ) -> tuple[Engine, ConstellationKVC | None]:
    """The fabric ``args`` describe (none with ``--no-cache``) and an
    engine over it for ``model``, on ``args.device``."""
    kvc = None
    if not args.no_cache:
        spec = ConstellationSpec(args.planes, args.sats_per_plane, 550.0)
        kvc = ConstellationKVC(
            spec,
            LosWindow(Sat(args.planes // 2, args.sats_per_plane // 2), 5, 5),
            Strategy(args.strategy), num_servers=10, chunk_bytes=6 * 1024,
        )
    engine = Engine(model, kvc=kvc, block_size=128, max_seq_len=512,
                    device=args.device)
    return engine, kvc


def run_rounds(engine: Engine, args: argparse.Namespace
               ) -> list[GenerationResult]:
    """Serve ``args.prompt * 4`` ``args.repeat`` times, one request a
    round, printing each round as the reference's launcher does."""
    sp = SamplingParams(temperature=args.temperature,
                        max_new_tokens=args.max_new)
    out = []
    for i in range(args.repeat):
        r = engine.generate([Request(prompt=args.prompt * 4, sampling=sp)])[0]
        print(f"round {i}: cached={r.cached_tokens}/{r.prompt_tokens} tok "
              f"wall={r.wall_time_s:.2f}s out={r.text[:40]!r}")
        out.append(r)
    return out


def serve(model: Model, args: argparse.Namespace) -> Served:
    """Build the engine for ``model``, run the rounds and print the
    fabric's counters."""
    engine, kvc = build_engine(model, args)
    results = run_rounds(engine, args)
    if kvc:
        print(f"cache: hits={kvc.stats.block_hits} "
              f"sets={kvc.stats.blocks_set} "
              f"messages={kvc.transport.stats.messages}")
    return Served(results, kvc, engine)


def main(argv=None) -> Served:
    args = parse_args(argv)
    cfg = serving_config(args)
    model = Model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    return serve(model, args)


if __name__ == "__main__":
    main()
