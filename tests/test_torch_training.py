"""The port's training package against ``repro.training``: the schedule,
AdamW and the global norm, the data streams, checkpoints read both ways,
the parameter tree both ways, whole ``train`` runs, the launcher, and the
two reference faults the port does not copy (ROADMAP section 3).

Weights are the reference's ``Model.init(PRNGKey(seed))`` carried to
the port by ``params_from_numpy``; everything runs at f32 on the CPU.
Tolerances: the schedule rtol 1e-6 (f32 rounding of the cosine); one
AdamW step atol 1e-6 / rtol 1e-5 (f32 elementwise arithmetic, the same
operations); a 10-step run's metrics rtol 1e-4, and its final parameters
atol 1e-4 / rtol 1e-3, the gradients' limit of
``test_torch_train_loss.py`` carried through ten updates, on all but
1e-4 of each leaf's elements.  Those few are AdamW's own conditioning:
its first update of an element is ``g / (|g| + eps)``, so where a
gradient is as small as its rounding (an embedding row a batch barely
touches) two correct runs part by up to the learning rate per step.
Each such element must stay within twice the sum of the learning rates,
and each leaf within 1e-3 of the reference in relative norm.  Batches,
checkpoints and trees are compared bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, smoke_config
from repro.models.model import Model as JaxModel
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import named_from_numpy, params_from_numpy
from repro_torch.convert import params_to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import data as tdata
from repro_torch.training import loop as tloop
from repro_torch.training import optimizer as topt

torch.set_num_threads(2)
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
RUN_TOL = dict(atol=1e-4, rtol=1e-3)


def _pair(arch: str, seed: int = 0, dtype: str = "float32", **kw):
    cfg = smoke_config(get_config(arch)).replace(dtype=dtype, **kw)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tcfg = tsmoke(tget(arch)).replace(dtype=dtype, **kw)
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return jm, params, tm


def _words(a) -> np.ndarray:
    """An array's bits: bf16 (ml_dtypes or raw words) as uint16."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind != "f":
        return a.view(np.uint16)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _assert_same_tree(got: dict, want: dict, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for key in want:
        if isinstance(want[key], dict):
            _assert_same_tree(got[key], want[key], f"{path}/{key}")
        else:
            g, w = _words(got[key]), _words(want[key])
            assert g.shape == w.shape, f"{path}/{key}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{key}")


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    for cfg in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
                dict(lr=3e-4, warmup_steps=5, total_steps=30,
                     min_lr_ratio=0.2)):
        jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
        for s in range(0, 121):
            np.testing.assert_allclose(float(topt.lr_at(tc, s)),
                                       float(jopt.lr_at(jc, s)), rtol=1e-6,
                                       atol=0, err_msg=str(s))


# a named tree with every kind of leaf: matrices (decayed), a bias, a norm
# scale and an SSM scalar vector (not decayed), an embedding-like matrix
_SHAPES = {"layer.w": (6, 5), "layer.bias": (5,), "layer.norm.scale": (5,),
           "ssd.a_log": (3,), "ssd.wx": (4, 3, 2), "embed.tok": (7, 4)}


def _named_tree(rng):
    t = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in _SHAPES.items()}

    def nest(flat):
        tree = {}
        for n, a in flat.items():
            node = tree
            *head, leaf = n.split(".")
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(a)
        return tree
    return t, nest


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(moment_dtype):
    """Three AdamW steps on a named tree: the global norm, the clip (the
    gradients are large), decay by leaf name and rank, and the moments
    kept in ``moment_dtype``, against ``repro.training.optimizer``."""
    rng = np.random.default_rng(0)
    flat, nest = _named_tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0,
               weight_decay=0.1, moment_dtype=moment_dtype)
    jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    jp = nest(flat)
    js = jopt.init_opt_state(jp, moment_dtype)
    tp = {n: torch.from_numpy(a.copy()) for n, a in flat.items()}
    ts = topt.init_opt_state(tp, moment_dtype)
    for step in range(3):
        g = {n: (rng.standard_normal(s) * 3.0).astype(np.float32)
             for n, s in _SHAPES.items()}
        jp, js, jm = jopt.adamw_update(jc, jp, nest(g), js)
        _, ts, tm = topt.adamw_update(
            tc, tp, {n: torch.from_numpy(a) for n, a in g.items()}, ts)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(topt.global_norm(
            torch.from_numpy(a) for a in g.values())),
            float(jopt.global_norm(nest(g))), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert float(jm["grad_norm"]) > 1.0          # the clip bites
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for n in _SHAPES:
            want = jp
            for k in n.split("."):
                want = want[k]
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(want),
                                       err_msg=f"{step} {n}", **STEP_TOL)
            assert ts["m"][n].dtype == topt.torch_dtype(moment_dtype)


def test_decay_follows_name_and_per_layer_rank():
    assert topt.decays("blocks.0.attn.wq", torch.zeros(4, 4))
    assert topt.decays("embed.tok", torch.zeros(4, 4))
    assert not topt.decays("blocks.0.norm1.scale", torch.zeros(4))
    assert not topt.decays("blocks.0.ssd.a_log", torch.zeros(4, 4))
    # a 1-D bias of one layer is not a matrix, whatever its name
    assert not topt.decays("blocks.0.ssd.conv_x_b", torch.zeros(4))


# ---------------------------------------------------------------------------
# the reference faults the port does not copy
# ---------------------------------------------------------------------------

def test_reference_decays_stacked_conv_biases_the_port_does_not():
    """The reference decides decay by the rank of its stacked leaf, so an
    SSD conv bias, ``[L, di]`` when stacked, is decayed (against its own
    docstring); the port judges the per-layer rank and leaves it."""
    bias = np.ones((2, 4), np.float32)            # two layers, di 4
    cfg = dict(lr=0.1, warmup_steps=0, total_steps=10, weight_decay=0.5)
    jp = {"blocks": {"ssd": {"conv_x_b": jnp.asarray(bias)}}}
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jp2, _, _ = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp, zeros,
                                  jopt.init_opt_state(jp))
    assert float(jp2["blocks"]["ssd"]["conv_x_b"][0, 0]) < 1.0
    tp = {f"blocks.{l}.ssd.conv_x_b": torch.from_numpy(bias[l].copy())
          for l in range(2)}
    topt.adamw_update(topt.AdamWConfig(**cfg), tp,
                      {n: torch.zeros(4) for n in tp},
                      topt.init_opt_state(tp))
    assert all(torch.equal(p, torch.ones(4)) for p in tp.values())


def test_reference_train_ignores_moment_dtype_the_port_keeps_it():
    cfg = smoke_config(get_config("skymemory-tinyllama")).replace(
        dtype="float32", num_layers=1)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=2,
               moment_dtype="bfloat16")
    dcfg = dict(vocab_size=cfg.vocab_size, seq_len=8, batch_size=1)
    _, jstate, _ = jloop.train(
        JaxModel(cfg), jdata.make_dataset(jdata.DataConfig(**dcfg)),
        jloop.TrainConfig(opt=jopt.AdamWConfig(**opt)), num_steps=1)
    assert jstate["m"]["final_norm"]["scale"].dtype == jnp.float32
    tm = params_from_numpy(
        tsmoke(tget("skymemory-tinyllama")).replace(dtype="float32",
                                                    num_layers=1),
        jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(0))),
        device="cpu")
    _, tstate, _ = tloop.train(
        tm, tdata.make_dataset(tdata.DataConfig(**dcfg)),
        tloop.TrainConfig(opt=topt.AdamWConfig(**opt)), num_steps=1)
    assert tstate["m"]["final_norm.scale"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["skymemory-tinyllama", "llava-next-34b",
                                  "seamless-m4t-large-v2"])
def test_synthetic_batches_are_byte_identical(arch):
    cfg = smoke_config(get_config(arch))
    kw = dict(vocab_size=cfg.vocab_size, seq_len=48, batch_size=3, seed=7,
              d_model=cfg.d_model, num_image_tokens=cfg.num_image_tokens,
              is_encoder_decoder=cfg.is_encoder_decoder,
              arch_type=cfg.arch_type)
    j_it = jdata.make_dataset(jdata.DataConfig(**kw)).batches()
    t_it = tdata.make_dataset(tdata.DataConfig(**kw)).batches()
    for _ in range(3):
        jb, tb = next(j_it), next(t_it)
        assert set(jb) == set(tb)
        assert ("image_embeds" in tb) == (arch == "llava-next-34b")
        assert ("frames" in tb) == (arch == "seamless-m4t-large-v2")
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].tobytes() \
                == tb[k].tobytes(), k


def test_textfile_batches_are_byte_identical(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_text("the quick brown fox jumps over the lazy dog; " * 40
                 + "naïve café ✓ " * 9, encoding="utf-8")
    kw = dict(vocab_size=300, seq_len=64, batch_size=2, path=str(p), seed=3)
    j_it = jdata.make_dataset(jdata.DataConfig(**kw)).batches()
    t_it = tdata.make_dataset(tdata.DataConfig(**kw)).batches()
    assert isinstance(tdata.make_dataset(tdata.DataConfig(**kw)),
                      tdata.TextFileLM)
    for _ in range(3):
        jb, tb = next(j_it), next(t_it)
        assert jb["tokens"].tobytes() == tb["tokens"].tobytes()


# ---------------------------------------------------------------------------
# the parameter tree and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """Every family at its own dtype (bf16 for most: compared as raw
    words), the MTP head, the dense stack, the encoder and the cross
    blocks included."""
    cfg = smoke_config(get_config(arch))
    tree = jax.tree.map(np.asarray,
                        JaxModel(cfg).init(jax.random.PRNGKey(2)))
    tm = params_from_numpy(tsmoke(tget(arch)), tree, device="cpu")
    _assert_same_tree(params_to_numpy(tm), tree)


def _trained_pair(arch="skymemory-tinyllama", steps=2):
    """A port model and its optimizer state after ``steps`` steps."""
    _, params, tm = _pair(arch)
    dcfg = tdata.DataConfig(vocab_size=tm.cfg.vocab_size, seq_len=16,
                            batch_size=2)
    tm, state, _ = tloop.train(
        tm, tdata.make_dataset(dcfg),
        tloop.TrainConfig(opt=topt.AdamWConfig(warmup_steps=1,
                                               total_steps=4)),
        num_steps=steps)
    return params, tm, state


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    params, tm, state = _trained_pair("deepseek-v3-671b")
    tckpt.save_checkpoint(str(tmp_path), tm, state, step=2,
                          metadata={"arch": tm.cfg.name})
    jstate_t = jopt.init_opt_state(params)
    p2, o2, meta = jckpt.load_checkpoint(str(tmp_path), params, jstate_t)
    assert meta == {"step": 2, "arch": tm.cfg.name}
    _assert_same_tree(jax.tree.map(np.asarray, p2), params_to_numpy(tm))
    assert int(o2["step"]) == 2
    for part in ("m", "v"):
        want = named_from_numpy(tm, jax.tree.map(np.asarray, o2[part]))
        for n, t in state[part].items():
            np.testing.assert_array_equal(t.numpy(), want[n], err_msg=n)


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    jm, params, tm = _pair("seamless-m4t-large-v2", seed=4)
    rng = np.random.default_rng(0)
    jstate = jopt.init_opt_state(params)
    jstate = {"m": jax.tree.map(lambda a: jnp.asarray(
                  rng.standard_normal(a.shape).astype(np.float32)),
                  jstate["m"]),
              "v": jax.tree.map(lambda a: jnp.asarray(
                  rng.random(a.shape).astype(np.float32)), jstate["v"]),
              "step": jnp.asarray(5, jnp.int32)}
    jckpt.save_checkpoint(str(tmp_path), params, jstate, step=5)
    fresh = tsmoke(tget("seamless-m4t-large-v2")).replace(dtype="float32")
    from repro_torch.models.model import Model
    other = Model(fresh, device="cpu").init(torch.Generator().manual_seed(1))
    state = topt.init_opt_state(dict(other.named_parameters()))
    other, state, meta = tckpt.load_checkpoint(str(tmp_path), other, state)
    assert meta["step"] == 5 and int(state["step"]) == 5
    _assert_same_tree(params_to_numpy(other), jax.tree.map(np.asarray,
                                                           params))
    want = named_from_numpy(other, jax.tree.map(np.asarray, jstate["m"]))
    for n, t in state["m"].items():
        np.testing.assert_array_equal(t.numpy(), want[n], err_msg=n)


def test_checkpoint_rank_that_does_not_write_drops_each_gathered_tensor(
        tmp_path, monkeypatch):
    """Saving gathers tensor by tensor: a rank that does not write drops
    each whole tensor before it gathers the next, and writes nothing."""
    import weakref

    _, _, tm = _pair("skymemory-tinyllama")
    state = topt.init_opt_state(dict(tm.named_parameters()))
    alive, calls = [], []

    def gather(t):
        held = [r for r in alive if r() is not None]
        assert not held, f"{len(held)} gathered tensors still held"
        full = t.detach().clone()
        alive.append(weakref.ref(full))
        calls.append(1)
        return full

    monkeypatch.setattr(tckpt, "whole", gather)
    monkeypatch.setattr(tckpt, "_writer", lambda: False)
    tckpt.save_checkpoint(str(tmp_path), tm, state, step=1)
    assert len(calls) == 3 * len(list(tm.parameters()))
    assert not any(tmp_path.iterdir())


def test_bf16_checkpoint_round_trip_is_bitwise(tmp_path):
    """A bf16 model and bf16 moments go out as raw words and come back
    bit for bit (no ``ml_dtypes`` needed)."""
    _, _, tm = _pair("granite-moe-3b-a800m", dtype="bfloat16")
    state = topt.init_opt_state(dict(tm.named_parameters()), "bfloat16")
    for t in state["m"].values():
        t.normal_(generator=torch.Generator().manual_seed(3))
    tckpt.save_checkpoint(str(tmp_path), tm, state, step=1)
    with np.load(tmp_path / "params.npz") as f:
        assert f["blocks/moe/wi_gate"].dtype == np.uint16
    other = params_from_numpy(tm.cfg, params_to_numpy(tm), device="cpu")
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    state2 = topt.init_opt_state(dict(other.named_parameters()), "bfloat16")
    tckpt.load_checkpoint(str(tmp_path), other, state2)
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b), n
    for n in state["m"]:
        assert torch.equal(state["m"][n], state2["m"][n]), n


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [
    ("skymemory-tinyllama", {}),
    ("granite-moe-3b-a800m", {}),
    # the reference decays mamba2's stacked conv biases and the port does
    # not (ROADMAP section 3): without decay the two runs agree
    ("mamba2-1.3b", {"weight_decay": 0.0}),
])
def test_ten_train_steps_match_reference(arch, kw):
    """``train`` for 10 steps from the same weights on the same batches:
    the history (every 3rd step and the last) and the final parameters
    equal the reference's run."""
    jm, params, tm = _pair(arch)
    dcfg = dict(vocab_size=tm.cfg.vocab_size, seq_len=32, batch_size=2,
                seed=1)
    opt = dict(lr=3e-3, warmup_steps=3, total_steps=10, **kw)
    jp, _, jh = jloop.train(
        jm, jdata.make_dataset(jdata.DataConfig(**dcfg)),
        jloop.TrainConfig(opt=jopt.AdamWConfig(**opt), log_every=3),
        num_steps=10, seed=0)
    tm, _, th = tloop.train(
        tm, tdata.make_dataset(tdata.DataConfig(**dcfg)),
        tloop.TrainConfig(opt=topt.AdamWConfig(**opt), log_every=3),
        num_steps=10)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [0, 3, 6, 9]
    for a, b in zip(th, jh):
        assert set(a) == set(b)
        for k in ("ce", "aux", "loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{a['step']} {k}")
    assert th[-1]["ce"] < th[0]["ce"]
    lr_sum = sum(float(jopt.lr_at(jopt.AdamWConfig(**opt), s))
                 for s in range(1, 11))
    want = jax.tree.map(np.asarray, jp)
    got = params_to_numpy(tm)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[p.key]
        diff = np.abs(g - w)
        off = diff > RUN_TOL["atol"] + RUN_TOL["rtol"] * np.abs(w)
        assert off.sum() <= 1e-4 * off.size, (path, int(off.sum()))
        assert (diff <= 2 * lr_sum).all(), (path, float(diff.max()))
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w), path


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    ck = tmp_path / "ck"
    launch_train.main(["--tiny", "--steps", "3", "--seq", "16", "--batch",
                       "2", "--device", "cpu", "--ckpt", str(ck)])
    out = capsys.readouterr().out
    assert "device=cpu" in out and out.count("loss=") == 3
    assert json.loads((ck / "meta.json").read_text()) == {
        "step": 3, "arch": "skymemory-tinyllama"}
    # the launcher's checkpoint reads into the reference
    cfg = smoke_config(get_config("skymemory-tinyllama")).replace(
        dtype="float32")
    template = JaxModel(cfg).init(jax.random.PRNGKey(0))
    _, opt, _ = jckpt.load_checkpoint(str(ck), template,
                                      jopt.init_opt_state(template))
    assert int(opt["step"]) == 3


def test_launcher_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--tiny", "--steps", "1"])
