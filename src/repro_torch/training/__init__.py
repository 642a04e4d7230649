"""Training for the port: the optimizer, the data pipeline, checkpoints
and the loop, as ``repro.training`` has them."""
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import (
    DataConfig,
    SyntheticLM,
    TextFileLM,
    make_dataset,
)
from repro_torch.training.loop import TrainConfig, make_train_step, train
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_at,
)

__all__ = [
    "load_checkpoint",
    "save_checkpoint",
    "DataConfig",
    "SyntheticLM",
    "TextFileLM",
    "make_dataset",
    "TrainConfig",
    "make_train_step",
    "train",
    "AdamWConfig",
    "adamw_update",
    "global_norm",
    "init_opt_state",
    "lr_at",
]
