"""Training launcher, the port's ``repro/launch/train.py``: random
weights from ``--seed``, the synthetic stream (or ``--data``'s corpus),
AdamW, an optional checkpoint.  It runs on the card unless ``--device
cpu`` is given, in f32 as the reference's launcher does.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch skymemory-tinyllama --steps 100 --seq 256 --batch 4 --tiny

The reference's ``--mesh`` waits for the port's tools.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
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
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = smoke_config(cfg)
    cfg = cfg.replace(dtype="float32")
    model = Model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(args.seed))
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
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
        model, ds, tcfg, num_steps=args.steps,
        log_fn=lambda s, m: print(
            f"step {s:5d} loss={m['loss']:.4f} lr={m['lr']:.2e} "
            f"gnorm={m['grad_norm']:.2f} ({m['elapsed_s']:.0f}s)"
        ),
    )
    if args.ckpt:
        save_checkpoint(args.ckpt, model, opt, step=args.steps,
                        metadata={"arch": cfg.name})
        print(f"saved {args.ckpt}")


if __name__ == "__main__":
    main()
