"""Train a ~100M llama-family model for a few hundred steps on synthetic LM
data, checkpointing at the end.

The port of ``examples/train_small.py`` onto ``repro_torch.training``:
random initial weights from seed 0, on the card unless ``--device
cpu`` is given, without JAX.

Defaults to a 115M config (12L, d=768) at seq 512; use --tiny for a
smoke-scale run (~1 minute on CPU).

Run: PYTHONPATH=src python examples/torch_train_small.py [--steps N] [--tiny]
     [--device cpu] [--out DIR]
"""
import argparse
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    DataConfig,
    TrainConfig,
    make_dataset,
    save_checkpoint,
    train,
)


def main(argv=None) -> list[dict]:
    """Train, write the checkpoint, and return the logged history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=str(ROOT / "build" / "train_small_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    base = get_config("skymemory-tinyllama")
    if args.tiny:
        cfg = base.replace(num_layers=2, d_model=256, num_heads=4,
                           num_kv_heads=2, head_dim=64, d_ff=512,
                           vocab_size=2048, dtype="float32")
        args.steps = min(args.steps, 60)
        args.seq = 128
    else:
        # ~115M params: 12L x d768
        cfg = base.replace(num_layers=12, d_model=768, num_heads=12,
                           num_kv_heads=4, head_dim=64, d_ff=2048,
                           vocab_size=32000, dtype="float32")
    model = Model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"training {cfg.param_count()/1e6:.0f}M params "
          f"for {args.steps} steps (seq={args.seq}, batch={args.batch}, "
          f"device={model.device})")

    ds = make_dataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                 batch_size=args.batch))
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=6e-4, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps),
        remat=None,
        log_every=max(args.steps // 15, 1),
    )
    model, opt, hist = train(
        model, ds, tcfg, num_steps=args.steps,
        log_fn=lambda s, m: print(
            f"  step {s:4d}  loss={m['loss']:.4f} ce={m['ce']:.4f} "
            f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f} "
            f"({m['elapsed_s']:.0f}s)"
        ),
    )
    assert all(math.isfinite(h["loss"]) for h in hist), "loss is not finite"
    assert hist[-1]["ce"] < hist[0]["ce"], "loss should decrease"
    save_checkpoint(args.out, model, opt, step=args.steps,
                    metadata={"arch": cfg.name})
    print(f"checkpoint written to {args.out}")
    return hist


if __name__ == "__main__":
    main()
