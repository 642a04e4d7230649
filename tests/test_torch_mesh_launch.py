"""``python -m repro_torch.launch.train --mesh`` on four CPU ranks
(``torch.distributed.run``, gloo) against the same command without
``--mesh``: the printed lines (the elapsed seconds removed) are equal,
the sharded run's checkpoint equals the unsharded one's and reads into
the reference, and on the card's path a world larger than the visible
CUDA devices is refused.

The checkpoints are compared as ``test_torch_mesh_train.py`` compares
parameters: atol 2e-5 / rtol 2e-4 but for AdamW's near-zero-gradient
elements, each within twice the sum of the learning rates.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config, smoke_config
from repro.models.model import Model as JaxModel
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch.launch import train as launch_train
from repro_torch.training.optimizer import AdamWConfig, lr_at

ROOT = Path(__file__).resolve().parents[1]
STEPS = 5
ARGS = ["--tiny", "--device", "cpu", "--steps", str(STEPS), "--seq", "32",
        "--batch", "4"]
TIMEOUT_S = 300


def _lines(out: str) -> list[str]:
    """The launcher's lines, each step's elapsed seconds removed."""
    keep = [ln for ln in out.splitlines()
            if ln.startswith(("arch=", "step ", "saved "))]
    return [re.sub(r" \(\d+s\)$", "", ln) for ln in keep]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The sharded launcher's stdout and checkpoint, and the unsharded
    launcher's."""
    tmp = tmp_path_factory.mktemp("mesh_launch")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    sharded = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", "--mesh",
         *ARGS, "--ckpt", str(tmp / "mesh")],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert sharded.returncode == 0, sharded.stderr[-4000:]
    plain = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, "--ckpt",
         str(tmp / "plain")],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert plain.returncode == 0, plain.stderr[-4000:]
    return sharded.stdout, plain.stdout, tmp


def test_mesh_prints_the_unsharded_lines_once(launched):
    sharded, plain, tmp = launched
    got, want = _lines(sharded), _lines(plain)
    assert len(want) == 2 + STEPS                   # arch, steps, saved
    assert got == [ln.replace(str(tmp / "plain"), str(tmp / "mesh"))
                   for ln in want]


def test_mesh_checkpoint_equals_the_unsharded_and_reads_into_the_reference(
        launched):
    _, _, tmp = launched
    lr_sum = sum(float(lr_at(AdamWConfig(lr=3e-4, warmup_steps=5,
                                         total_steps=STEPS), s))
                 for s in range(1, STEPS + 1))
    for name in ("params.npz", "opt_state.npz"):
        with np.load(tmp / "mesh" / name) as a, \
                np.load(tmp / "plain" / name) as b:
            assert sorted(a) == sorted(b)
            for k in a:
                got, want = a[k], b[k]
                assert got.shape == want.shape and got.dtype == want.dtype
                diff = np.abs(got.astype(np.float64) - want)
                off = diff > 2e-5 + 2e-4 * np.abs(want)
                assert off.sum() <= 1e-3 * off.size + 2, (k, int(off.sum()))
                if name == "params.npz":
                    assert (diff <= 2 * lr_sum).all(), k
    assert json.loads((tmp / "mesh" / "meta.json").read_text()) == {
        "step": STEPS, "arch": "skymemory-tinyllama"}
    cfg = smoke_config(get_config("skymemory-tinyllama")).replace(
        dtype="float32")
    template = JaxModel(cfg).init(jax.random.PRNGKey(0))
    params, opt, _ = jckpt.load_checkpoint(str(tmp / "mesh"), template,
                                           jopt.init_opt_state(template))
    assert int(opt["step"]) == STEPS
    with np.load(tmp / "mesh" / "params.npz") as a:
        np.testing.assert_array_equal(np.asarray(params["embed"]["tok"]),
                                      a["embed/tok"])


def test_mesh_on_cuda_refuses_more_ranks_than_devices(monkeypatch):
    """Each rank drives a CUDA device of its own: a world larger than the
    visible devices stops before any group or model is made."""
    import torch

    monkeypatch.setenv("WORLD_SIZE", str(torch.cuda.device_count() + 1))
    with pytest.raises(SystemExit, match="visible CUDA devices"):
        launch_train.main(["--mesh", "--tiny", "--steps", "1"])
