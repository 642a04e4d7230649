"""Training launcher, the port's ``repro/launch/train.py``: random
weights from ``--seed``, the synthetic stream (or ``--data``'s corpus),
AdamW, an optional checkpoint.  It runs on the card unless ``--device
cpu`` is given, in f32 as the reference's launcher does.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch skymemory-tinyllama --steps 100 --seq 256 --batch 4 --tiny

``--mesh`` trains sharded over a ``(data, model)`` mesh of every rank of
the process group, ``(n // dm, dm)`` with ``dm = max(n // 2, 1)`` as in
the reference, under ``make_rules``' layouts.  The group comes from
``torchrun``'s environment, or is a world of one (NCCL on ``cuda``, gloo
on ``cpu``) when there is none; a group that exists already is used and
left open.  Each rank drives one device, so on ``cuda`` a world larger
than the visible devices is refused.  Only rank 0 prints and writes the
checkpoint:

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --mesh --tiny \\
      --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, InputShape, get_config, smoke_config
from repro_torch.launch.mesh import make_rules
from repro_torch.models.model import Model
from repro_torch.training import (
    AdamWConfig,
    DataConfig,
    TrainConfig,
    make_dataset,
    save_checkpoint,
    train,
)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS, default="skymemory-tinyllama")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--remat", default=None,
                   choices=[None, "full", "dots", "dots_no_batch"])
    p.add_argument("--tiny", action="store_true",
                   help="reduced same-family config (CPU-friendly)")
    p.add_argument("--data", default=None, help="optional text corpus path")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random initial weights")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--mesh", action="store_true",
                   help="train sharded over a (data, model) mesh of every "
                        "rank of the process group")
    args = p.parse_args(argv)
    if not args.mesh:
        _run(args, None)
        return
    started = _start_group(args.device)
    try:
        _run(args, _mesh(args.device))
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def _start_group(device: str) -> bool:
    """Start the process group from ``torchrun``'s environment, or as a
    world of one, unless one exists; on ``cuda`` bind this rank to its
    device first, and refuse a world larger than the visible devices.
    Returns whether a group was started."""
    import os

    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        if world > visible:
            raise SystemExit(
                f"--mesh on cuda: a world of {world} ranks but {visible} "
                "visible CUDA devices; each rank drives a device of its own "
                "(NCCL refuses two ranks on one device)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_initialized():
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if "RANK" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def _mesh(device: str):
    """The ``(n // dm, dm)`` ``("data", "model")`` mesh over the group's
    ``n`` ranks, ``dm = max(n // 2, 1)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    dm = max(n // 2, 1)
    return init_device_mesh(torch.device(device).type, (n // dm, dm),
                            mesh_dim_names=("data", "model"))


def _run(args, mesh) -> None:
    """Build, train and save; under ``mesh`` only rank 0 prints."""
    import torch.distributed as dist

    say = print if mesh is None or dist.get_rank() == 0 else _quiet

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = smoke_config(cfg)
    cfg = cfg.replace(dtype="float32")
    model = Model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    rules = None
    if mesh is not None:
        rules = make_rules(mesh, cfg, InputShape("train", args.seq,
                                                 args.batch, "train"))
    say(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
        f"steps={args.steps} device={model.device}")

    ds = make_dataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        path=args.data, d_model=cfg.d_model,
        num_image_tokens=cfg.num_image_tokens,
        is_encoder_decoder=cfg.is_encoder_decoder, arch_type=cfg.arch_type,
    ))
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps),
        remat=args.remat,
        log_every=max(args.steps // 20, 1),
    )
    model, opt, hist = train(
        model, ds, tcfg, num_steps=args.steps, rules=rules,
        log_fn=lambda s, m: say(
            f"step {s:5d} loss={m['loss']:.4f} lr={m['lr']:.2e} "
            f"gnorm={m['grad_norm']:.2f} ({m['elapsed_s']:.0f}s)"
        ),
    )
    if args.ckpt:
        save_checkpoint(args.ckpt, model, opt, step=args.steps,
                        metadata={"arch": cfg.name})
        say(f"saved {args.ckpt}")


def _quiet(*_args, **_kw) -> None:
    """The print of a rank other than 0."""


if __name__ == "__main__":
    main()
