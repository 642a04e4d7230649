"""The port's serving launcher (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``), and the two model-running examples
the port adds.

The reference's ``main`` seeds its model with ``PRNGKey(0)``; the same
weights, converted with ``params_from_numpy``, go through the port's
``serve``.  Both must print the same lines, with only the ``wall=``
field (host time) removed: the same cached and prompt token counts, the
same output text, and the same fabric hits, sets and messages.  The
launcher's prompt is ``prompt * 4`` after a BOS token, an odd count, so
the reference's SSM full-hit replay (``ROADMAP.md`` section 3) never
applies to it.
"""
import contextlib
import io
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.launch import serve as jserve
from repro.models.model import Model as JaxModel
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
WALL = re.compile(r" wall=\S+")


def _printed(fn, *args) -> tuple[list[str], object]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return [WALL.sub("", line) for line in buf.getvalue().splitlines()], out


@pytest.mark.parametrize("arch,extra", [
    ("skymemory-tinyllama", []),
    ("skymemory-tinyllama", ["--no-cache"]),
    ("skymemory-tinyllama", ["--strategy", "hop", "--planes", "7",
                             "--sats-per-plane", "9"]),
    ("mamba2-1.3b", []),
    ("zamba2-1.2b", []),
], ids=["tinyllama", "tinyllama-no-cache", "tinyllama-hop-7x9", "mamba2",
        "zamba2"])
def test_launcher_prints_the_reference_lines(arch, extra):
    argv = ["--arch", arch, "--tiny", "--repeat", "2", "--max-new", "4",
            *extra]
    want, _ = _printed(jserve.main, argv)
    args = tserve.parse_args([*argv, "--device", "cpu"])
    params = JaxModel(smoke_config(get_config(arch)).replace(
        dtype="float32")).init(jax.random.PRNGKey(0))
    model = params_from_numpy(tserve.serving_config(args),
                              jax.tree.map(np.asarray, params), device="cpu")
    got, served = _printed(tserve.serve, model, args)
    assert got == want
    res = served.results
    assert len(res) == 2 and res[0].cached_tokens == 0
    # the warm round restores the prompt's one full block (or nothing
    # without the fabric) and serves the cold round's tokens
    cache = "--no-cache" not in extra
    assert res[1].cached_tokens == (128 if cache else 0)
    assert res[1].token_ids == res[0].token_ids
    assert (served.kvc is not None) == cache
    if cache:
        assert served.kvc.stats.block_hits > 0
        assert served.kvc.stats.blocks_set == 1


def test_main_serves_seeded_weights_on_the_cpu():
    """``main`` builds the model from ``--seed``: the same seed serves the
    same tokens, another seed other ones."""
    argv = ["--tiny", "--repeat", "2", "--max-new", "4", "--device", "cpu"]
    runs = [_printed(tserve.main, [*argv, "--seed", str(s)])[1]
            for s in (0, 0, 1)]
    toks = [[r.token_ids for r in s.results] for s in runs]
    assert toks[0] == toks[1] != toks[2]
    assert toks[0][0] == toks[0][1]
    assert all(s.kvc.stats.block_hits > 0 for s in runs)


def test_main_without_device_raises_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--tiny", "--repeat", "1", "--max-new", "1"])


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-34b"])
def test_encoder_decoder_and_vlm_are_refused(arch):
    with pytest.raises(SystemExit, match="text-only"):
        jserve.main(["--arch", arch, "--tiny"])
    with pytest.raises(SystemExit, match="text-only"):
        tserve.main(["--arch", arch, "--tiny", "--device", "cpu"])


def _example(script: str, *argv: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *argv], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_serve_example_hits_the_shared_constellation():
    out = _example("torch_serve_skymemory.py", "--device", "cpu",
                   "--requests", "4", "--max-new", "4")
    hits = re.search(r"shared constellation: .* block_hits=(\d+) ", out)
    assert hits and int(hits.group(1)) > 0, out
    assert "cluster: 2 replicas" in out
    assert re.search(r"merged: 4 requests, 16 tokens", out), out


@pytest.mark.parametrize("argv,lines", [
    (["--stream", "--outages", "1", "--payload-codec", "int8"],
     [r"streaming: \d+ arrivals over 3\.0 virtual s from 3 tenant",
      r"fault plan: chaos arc \(seed 5\) -- 1 satellite kill",
      r"goodput: [\d.]+ SLO-attained tok/s .* shed \d+ of \d+ offered",
      r"tenant +pro: offered=\d+",
      r"fault arc: kills=[1-9]\d* heals=[1-9]",
      r"payload codec: int8 \| encoded [\d.]+MB of [\d.]+MB raw"]),
    (["--degrade-links", "3", "--ground-stations", "1", "--requests", "4",
      "--max-new", "4"],
     [r"ground segment: 1 station\(s\) under the LOS window",
      r"link degradation: [1-9]\d* ISLs severed",
      r"merged: 4 requests, 16 tokens",
      r"shared constellation: .* block_hits=[1-9]",
      r"graceful degradation: link_cuts=[1-9]\d* \| detoured_ops=\d+",
      r"ground tier holds \d+ blocks"]),
], ids=["stream-outage-int8", "degraded-links-ground"])
def test_serve_example_options_print_their_reports(argv, lines):
    """The example's stream, chaos arc, quantized payloads, severed links
    and ground segment at its reduced width: each exits 0 and prints its
    report lines."""
    out = _example("torch_serve_skymemory.py", "--device", "cpu", *argv)
    for line in lines:
        assert re.search(line, out), (line, out)


def test_train_example_takes_three_steps(tmp_path):
    """The example asserts, as the reference's does, that the loss fell:
    at the tiny width that holds past the 5 warmup steps, so the run
    takes 20 (the first three among them)."""
    out = _example("torch_train_small.py", "--tiny", "--device", "cpu",
                   "--steps", "20", "--out", str(tmp_path / "ckpt"))
    losses = [float(x) for x in re.findall(r"step +\d+ +loss=(\S+)", out)]
    assert len(losses) == 20 and all(math.isfinite(x) for x in losses), out
    assert losses[-1] < losses[0], out
    assert (tmp_path / "ckpt" / "params.npz").exists()
