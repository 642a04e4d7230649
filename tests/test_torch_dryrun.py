"""The port's dry-run (``repro_torch.launch.specs.lower_plan``,
``launch.dryrun``, ``launch.roofline_report``).

Each fake world (``specs.fake_world``: the default process group) is
started and destroyed in a process of its own; this process opens none.

* A bf16 product sharded over 16x16 fake ranks is counted at rank 0's
  share, 1/256 of the global FLOPs (``FlopCounterMode`` around the
  ``DTensor`` op counts the whole product), with its collectives.
* Smoke TinyLlama's train and serve plans on a ``(1, 1)`` mesh count
  exactly the analytic products of the port's plain arithmetic, at or
  below the reference's ``lower_plan(...).compile().cost_analysis()``,
  and a streaming-length prefill counts every key block, with no
  correction.
* Argument bytes per device equal those derived from the reference's
  specs, for the 11 configs.
* ``run_one``'s record keys are the reference's less ``gqa_grouped``;
  the command line's ``--tag`` and ``--resume``; the report's table.
"""
import ast
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, get_config
from repro.configs import shape_variant as j_shape_variant
from repro.distributed import sharding as J
from repro.launch import roofline as JR
from repro.launch import specs as JS
from repro.launch.mesh import make_rules as j_make_rules
from repro.models.config import INPUT_SHAPES
from repro.models.config import InputShape as JShape
from repro.models.model import Model as JaxModel
from repro_torch.configs import INPUT_SHAPES as T_INPUT_SHAPES
from repro_torch.configs import get_config as tget
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.mesh import make_rules as t_make_rules

ROOT = Path(__file__).resolve().parents[1]


def _child(code: str, *args: str, timeout: int = 240) -> dict:
    """Run ``code`` in a fresh interpreter (one fake world each); its last
    line of output is a JSON object."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code), *args],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


PRODUCT = """
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import specs as S
from repro_torch.launch.roofline import collectives_from

with S.fake_world(MeshShape(("data", "model"), (16, 16))) as mesh:
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    with S._metadata_unfaked(), fm:
        a = distribute_tensor(torch.empty(256, 4096, dtype=torch.bfloat16),
                              mesh, [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(torch.empty(4096, 8192, dtype=torch.bfloat16),
                              mesh, [Replicate(), Shard(1)], src_data_rank=None)
        c = distribute_tensor(torch.empty(256, 4096, dtype=torch.bfloat16),
                              mesh, [Replicate(), Shard(0)], src_data_rank=None)
        counter, comm = S._counter_mode(fm), S._comm_recorder()
        with comm, counter:
            y = a @ b
            y.redistribute(mesh, [Replicate(), Replicate()])
            c.redistribute(mesh, [Replicate(), Shard(1)])
        with FlopCounterMode(display=False) as global_count:
            a @ b
        with S._counter_mode(fm) as product:
            a @ b
    colls, nvlink = collectives_from(comm)
    print(json.dumps({"flops": counter.flops, "bytes": counter.bytes,
                      "product_bytes": product.bytes,
                      "global": global_count.get_total_flops(),
                      "local": list(y.to_local().shape), "colls": colls,
                      "nvlink": nvlink,
                      "records": [[r[0], r[1], len(r[2])]
                                  for r in comm.records]}))
"""


def test_sharded_product_counts_one_devices_share():
    """[256, 4096] @ [4096, 8192] in bf16, the rows over ``data`` and the
    columns over ``model``: rank 0 multiplies [16, 4096] @ [4096, 512],
    1/256 of the product's FLOPs, where ``FlopCounterMode`` counts all of
    it, and the product's bytes are those of the two shards and the
    [16, 512] result.  Gathering the result whole over both axes is two all-gathers
    across hosts, of the [16, 8192] and the [256, 8192] result.  Moving
    a [256, 4096] tensor's split over ``model`` from rows to columns is
    the card's all-to-all of rank 0's [256, 256] result (a CPU mesh of
    ``DTensor``'s own would gather the whole tensor instead)."""
    got = _child(PRODUCT)
    whole = 2 * 256 * 4096 * 8192
    print(f"per-device {got['flops']:.6e} global {got['global']:.6e} ratio "
          f"{got['global'] / got['flops']:.1f}")
    assert got["global"] == whole
    assert got["flops"] * 256 == whole
    assert got["local"] == [16, 512]
    # the product alone reads rank 0's two shards and writes its result
    assert got["product_bytes"] == (16 * 4096 + 4096 * 512 + 16 * 512) * 2
    assert got["bytes"] > got["product_bytes"]
    assert sorted(got["records"]) == [["all-gather", 16 * 8192 * 2, 16],
                                      ["all-gather", 256 * 8192 * 2, 16],
                                      ["all-to-all", 256 * 256 * 2, 16]]
    assert got["colls"]["all-gather"] == pytest.approx(
        (16 + 256) * 8192 * 2 * 15 / 16)
    assert got["colls"]["all-to-all"] == pytest.approx(256 * 256 * 2 * 15 / 16)
    assert got["nvlink"] == 0.0


SMOKE = """
import json, os, sys, tempfile
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.profiler import ProfilerActivity, profile
from torch.profiler._memory_profiler import Action
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from repro_torch.configs import InputShape, get_config, smoke_config
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_rules

cfg = smoke_config(get_config("skymemory-tinyllama"))
shapes = json.loads(sys.argv[1])
out = {}
with S.fake_world(MeshShape(("data", "model"), (1, 1))) as mesh:
    for name, seq, batch, kind in shapes:
        shape = InputShape(name, seq, batch, kind)
        plan = S.make_plan(cfg, shape, make_rules(mesh, cfg, shape),
                           remat=None, device="meta")
        c = S.lower_plan(plan)
        m = c.memory_analysis()
        out[name] = {"flops": c.cost_analysis()["flops"],
                     "bytes": c.cost_analysis()["bytes accessed"],
                     "colls": c.collectives,
                     "args": m.argument_size_in_bytes,
                     "want_args": S.argument_bytes(plan),
                     "peak": m.temp_size_in_bytes + m.argument_size_in_bytes
                             + m.output_size_in_bytes - m.alias_size_in_bytes}


def local(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)
            and t.device.type == "cpu" and not isinstance(t, FakeTensor)]


class Bytes(TorchDispatchMode):
    # operand and result bytes of every op on real local tensors
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        res = func(*args, **(kwargs or {}))
        outs = local(res)
        if (outs and not func.is_view
                and func._overloadpacket.__name__ not in S._NO_BYTES):
            Bytes.n += sum(t.numel() * t.element_size()
                           for t in local((args, kwargs)) + outs)
        return res


def real(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, t.shape, dtype=t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)
    if isinstance(t, dict):
        return {k: real(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(real(v) for v in t)
    return t


# The same steps run for real on a world of one: the bytes under the
# same rule, and the peak rise of the CPU allocator's live bytes (oneDNN
# off: its packing buffers are no tensor of the step).
torch.manual_seed(0)
torch.backends.mkldnn.enabled = False
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(tempfile.mkdtemp(), "store"), 1), rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
for name, seq, batch, kind in shapes:
    if kind == "prefill":
        continue
    shape = InputShape(name, seq, batch, kind)
    plan = S.make_plan(cfg, shape, make_rules(mesh, cfg, shape), remat=None,
                       device="cpu")
    with torch.no_grad():
        for p in plan.model.parameters():
            p.normal_(0.0, 0.02)
    S.distribute_model(plan.model, plan.rules)
    args = plan.lay_out(real(plan.args))
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True,
                 record_shapes=True, with_stack=True) as prof:
        plan.fn(*args)
    live = rise = 0
    for _, action, _, size in prof._memory_profile().timeline:
        live += {Action.CREATE: size, Action.DESTROY: -size}.get(action, 0)
        rise = max(rise, live)
    args = plan.lay_out(real(plan.args))
    Bytes.n = 0
    with Bytes():
        plan.fn(*args)
    out[name].update(real_rise=rise, real_bytes=Bytes.n)
dist.destroy_process_group()
print(json.dumps(out))
"""
SMOKE_SHAPES = (("train", 64, 2, "train"), ("serve", 128, 2, "decode"),
                ("prefill", 10240, 1, "prefill"))


def _analytic(cfg, name, seq, batch) -> float:
    """The products of the port's plain arithmetic: every weight matmul
    (2 FLOPs per weight and token; x3 with the backward), and per layer
    the attention's two [S, S] products of 2 * B * H * S * S_kv * hd
    FLOPs each in the forward (the plain versions score every key, the
    masked ones too), five in the backward (the scores recomputed, dV,
    dP, dQ, dK).  Decode scores one query against the whole cache."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    w = cfg.num_layers * (d * (h + 2 * hkv) * hd + h * hd * d
                          + 3 * d * cfg.d_ff) + d * cfg.vocab_size
    if name == "serve":
        return 2.0 * batch * w + cfg.num_layers * 2 * (2 * batch * h * seq * hd)
    tokens = batch * seq
    product = 2 * batch * h * seq * seq * hd
    if name == "train":
        return 6.0 * tokens * w + cfg.num_layers * 7 * product
    return 2.0 * tokens * w + cfg.num_layers * 2 * product


def _reference_cost(cfg, shape: JShape) -> dict:
    """The reference's XLA count of the same plan on a ``(1, 1)`` mesh:
    FLOPs, bytes accessed and the peak from ``memory_analysis()``."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    rules = j_make_rules(mesh, cfg, shape)
    with mesh:
        plan = JS.make_plan(cfg, shape, rules, remat=None, unroll=True)
        compiled = JS.lower_plan(plan).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    m = compiled.memory_analysis()
    return {"flops": float(cost["flops"]),
            "bytes": float(cost["bytes accessed"]),
            "peak": m.temp_size_in_bytes + m.argument_size_in_bytes
                    + m.output_size_in_bytes - m.alias_size_in_bytes}


@pytest.fixture(scope="module")
def smoke_counts() -> dict:
    return _child(SMOKE, json.dumps(SMOKE_SHAPES))


def test_smoke_tinyllama_plans_count_the_analytic_products(smoke_counts):
    """Smoke TinyLlama on a ``(1, 1)`` mesh: the train and serve steps'
    FLOPs are exactly the analytic product count and at most the
    reference's XLA count of the same plan (which adds elementwise ops);
    a 10,240-token prefill streams its attention over five key blocks of
    2048 (``ops.flash_attention`` on the CPU from 8192 keys on) and every
    block is counted: the count is the analytic one with the whole
    [S, S] attention, so the reference's ``streaming_attn_correction``
    (the blocks its scan counts once) is not needed.  No collective on a
    world of one (the gradient norm's all-reduce over one rank moves
    nothing), and the argument bytes are ``argument_bytes``'."""
    from repro.configs import smoke_config as j_smoke
    from repro_torch.configs import smoke_config

    got = smoke_counts
    tcfg = smoke_config(tget("skymemory-tinyllama"))
    jcfg = j_smoke(get_config("skymemory-tinyllama"))
    for name, seq, batch, kind in SMOKE_SHAPES:
        g = got[name]
        assert g["flops"] == _analytic(tcfg, name, seq, batch), name
        assert not any(g["colls"].values())
        assert g["args"] == g["want_args"]
        assert g["peak"] >= g["args"] > 0
        assert g["bytes"] > 0
        if kind == "prefill":
            nb = seq // 2048
            scan_once = (g["flops"]
                         - JR.streaming_attn_correction(
                             jcfg, JShape(name, seq, batch, kind), None))
            assert scan_once == _analytic(tcfg, name, seq, batch) - (
                tcfg.num_layers * 2 * (2 * batch * tcfg.num_heads * seq * seq
                                       * tcfg.head_dim) * (nb - 1) / nb)
            continue
        want = _reference_cost(jcfg, JShape(name, seq, batch, kind))["flops"]
        print(f"{name}: port {g['flops']:.6e} reference (XLA) {want:.6e} "
              f"ratio {g['flops'] / want:.4f}")
        assert g["flops"] <= want


@pytest.mark.parametrize("name", ["train", "serve"])
def test_smoke_tinyllama_bytes_and_peak_equal_a_real_run(smoke_counts, name):
    """The train and serve steps of the same plans run for real on a
    world of one (gloo, real CPU tensors): the counted bytes equal the
    real run's operand and result bytes under the same rule, so the fake
    tensors, ``DTensor``'s metadata work and the ``meta`` model add and
    drop nothing; the counted peak's rise over the arguments equals the
    rise of the CPU allocator's live bytes in the real run (the
    profiler's memory timeline, which ``MemTracker`` does not use)
    within 0.1% (a few scalars: 1,012 B of 7.3 MB for the train step).

    The reference's XLA counts print beside them and bound nothing: its
    CPU backend widens every bf16 operand to f32 (whole weights and
    cache, ``convert`` ops), so its decode step accesses 3.4x the port's
    bytes while its train step accesses 0.44x (XLA fuses; the port
    counts every op)."""
    from repro.configs import smoke_config as j_smoke

    g = smoke_counts[name]
    seq, batch, kind = next(s[1:] for s in SMOKE_SHAPES if s[0] == name)
    ref = _reference_cost(j_smoke(get_config("skymemory-tinyllama")),
                          JShape(name, seq, batch, kind))
    rise = g["peak"] - g["args"]
    print(f"{name}: bytes {g['bytes']:.6e} (real run {g['real_bytes']:.6e}, "
          f"XLA {ref['bytes']:.6e}, ratio {g['bytes'] / ref['bytes']:.4f}); "
          f"peak {g['peak']} rise {rise} (real run {g['real_rise']}; XLA "
          f"peak {ref['peak']}, ratio {g['peak'] / ref['peak']:.4f})")
    assert g["bytes"] == g["real_bytes"] > 0
    assert g["real_rise"] > 0
    assert abs(rise - g["real_rise"]) <= 1e-3 * g["real_rise"]


def _local_bytes(shape, spec, dtype, sizes) -> int:
    n = 1
    for dim, axes in zip(shape, tuple(spec) + (None,) * len(shape)):
        if axes is not None:
            for a in (axes,) if isinstance(axes, str) else axes:
                dim = -(-dim // sizes[a])
        n *= dim
    return n * jax.numpy.dtype(dtype).itemsize


def _reference_argument_bytes(arch: str, shape: str, multi_pod: bool) -> int:
    """Rank 0's bytes of the reference plan's arguments from its specs:
    parameters, then AdamW's f32 moments, step and batch (train) or the
    cache and tokens (decode; the reference's ``pos`` is a scalar)."""
    tm = make_production_mesh(multi_pod=multi_pod)
    jm = AbstractMesh(tm.sizes, tm.axis_names)
    sizes = dict(zip(tm.axis_names, tm.sizes))
    s = INPUT_SHAPES[shape]
    cfg = j_shape_variant(get_config(arch), s)
    rules = j_make_rules(jm, get_config(arch), s)
    model = JaxModel(cfg)
    pshapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    pspecs = J.param_specs(pshapes, rules)
    leaves = jax.tree.leaves(pshapes)
    specs = jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    total = sum(_local_bytes(l.shape, sp, l.dtype, sizes)
                for l, sp in zip(leaves, specs))
    dsize = rules.axis_size(rules.data_axes)
    b = s.global_batch
    if s.kind == "train":
        total += 2 * sum(_local_bytes(l.shape, sp, "float32", sizes)
                         for l, sp in zip(leaves, specs)) + 4
        for v in JS.input_specs(cfg, s).values():
            total += _local_bytes(v.shape, (rules.data,), v.dtype, sizes)
        return total
    src_len = s.seq_len // 2 if cfg.is_encoder_decoder else None
    cache = model.init_cache(b, s.seq_len, specs_only=True, src_len=src_len)
    cspecs = J.cache_specs(cache, rules, batch=b)
    cl = jax.tree.leaves(cache)
    cs = jax.tree.leaves(cspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    total += sum(_local_bytes(l.shape, sp, l.dtype, sizes)
                 for l, sp in zip(cl, cs))
    tok = (rules.data,) if b >= dsize else ()
    return total + _local_bytes((b, 1), tok, "int32", sizes) + 4


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_the_reference_specs(arch):
    """``argument_bytes`` of the train_4k and decode_32k plans at 16x16
    (and long_500k at 2x16x16) equals the bytes rank 0 holds under the
    reference's specs; the port's ``pos`` is [B] int32 where the
    reference's is a scalar."""
    for shape, mp in (("train_4k", False), ("decode_32k", False),
                      ("long_500k", True)):
        if (arch, shape) == ("seamless-m4t-large-v2", "long_500k"):
            continue
        tm = make_production_mesh(multi_pod=mp)
        s = T_INPUT_SHAPES[shape]
        plan = TS.make_plan(tget(arch), s, t_make_rules(tm, tget(arch), s),
                            device="meta")
        want = _reference_argument_bytes(arch, shape, mp)
        if s.kind == "decode":
            want += 4 * s.global_batch - 4
        assert TS.argument_bytes(plan) == want, shape


RUN_ONE = """
import json
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch.dryrun import run_one
from repro_torch.models.config import InputShape

rec = run_one("skymemory-tinyllama", InputShape("d", 512, 4, "decode"),
              mesh=MeshShape(("data", "model"), (2, 2)), verbose=False)
print(json.dumps(rec))
"""


def _reference_record_keys() -> set:
    """The keys of the reference's ``run_one`` record: its ``Roofline``'s
    ``to_dict`` and the keywords of ``rec.update`` in its source (the
    module is not imported: it sets ``XLA_FLAGS`` for 512 devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_one")
    update = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                  and getattr(n.func, "attr", "") == "update")
    roof = JR.Roofline("a", "s", "m", "step", 0.0, 0.0, 0.0)
    return set(roof.to_dict()) | {k.arg for k in update.keywords}


def test_run_one_record_keys_are_the_references():
    """Full-width TinyLlama, one decode step over a 512-token cache on a
    2x2 mesh of fake ranks: an ``ok`` record with the reference's keys
    less ``gqa_grouped``, collectives within one host priced on NVLink,
    and its probe solution equal to the full-depth count."""
    rec = _child(RUN_ONE)
    want = _reference_record_keys()
    assert "gqa_grouped" in want
    assert set(rec) == want - {"gqa_grouped"}
    assert rec["status"] == "ok", rec["status"]
    assert rec["mesh"] == "2x2" and rec["step"] == "serve_step"
    assert rec["collective_bytes"] > 0
    assert rec["collective_s"] == pytest.approx(
        rec["collective_bytes"] / 450e9)
    assert rec["compute_s"] == pytest.approx(rec["flops_per_device"] / 989e12)
    assert rec["memory_s"] == pytest.approx(rec["bytes_per_device"] / 3.35e12)
    assert rec["peak_memory_bytes"] >= rec["argument_bytes"] > 0


CLI = """
import json, sys
from pathlib import Path
from repro_torch.configs import smoke_config
import repro_torch.launch.dryrun as d

full = d.get_config
d.get_config = lambda arch: smoke_config(full(arch))
out = Path(sys.argv[1])
base = ["--arch", "skymemory-tinyllama", "--shape", "decode_32k",
        "--out", str(out)]
rcs = [d.main(base + ["--tag", "t"])]
tagged = out / "skymemory-tinyllama__decode_32k__16x16__t.json"
rec = json.loads(tagged.read_text())
tagged.write_text(json.dumps({**rec, "marker": 1}))
rcs.append(d.main(base + ["--tag", "t", "--resume"]))
rcs.append(d.main(base))
print(json.dumps({"rcs": rcs, "first": rec}))
"""


def test_command_line_tag_resume_and_report(tmp_path):
    """``--tag`` names the result file and the record, ``--resume`` skips
    a combination whose file exists (the file keeps a marker written
    after the first run), and the report renders the untagged record as
    a table row (smoke TinyLlama at decode_32k on the 16x16 mesh of fake
    ranks, one fake world at a time in one process)."""
    from repro_torch.launch import roofline_report as R

    got = _child(CLI, str(tmp_path))
    assert got["rcs"] == [0, 0, 0]
    assert got["first"]["tag"] == "t" and got["first"]["status"] == "ok"
    tagged = tmp_path / "skymemory-tinyllama__decode_32k__16x16__t.json"
    assert json.loads(tagged.read_text())["marker"] == 1
    rows = R.load(str(tmp_path))
    assert len(rows) == 2
    table = R.table(rows, "16x16")
    lines = [l for l in table.splitlines() if l.startswith("| skymemory")]
    assert len(lines) == 1 and "| decode_32k | serve_step |" in lines[0]
    assert R.failures(rows) == []
    assert "### Roofline — mesh 16x16 (256 H100s)" in R.experiments_tables(
        str(tmp_path))
    assert all(math.isfinite(r["compute_s"]) for r in rows)


def test_a_missing_patch_target_raises_and_restores(monkeypatch):
    """``_metadata_unfaked`` raises where this torch lacks a target it
    patches, rather than counting another plan, and puts back what it
    had patched before the missing one."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    before = ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"]
    monkeypatch.setattr(TS, "_UNFAKED", TS._UNFAKED + (
        ("torch.distributed.tensor._sharding_prop", "NoSuchClass", "f"),))
    with pytest.raises(RuntimeError, match="NoSuchClass"):
        with TS._metadata_unfaked():
            pass
    after = ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"]
    assert after is before


def test_report_shows_a_probe_mismatch_counted_and_marked(tmp_path):
    """A record whose probe solution parts from its full-depth count
    keeps that count: the report's tables show it, marked, its peak
    counts against 80 GB, and it is listed with the failures beside a
    combination that did not count; a ``1x1`` mesh's heading names one
    card."""
    from repro_torch.launch import roofline_report as R
    from repro_torch.launch.dryrun import PROBE_MISMATCH
    from repro_torch.launch.roofline import Roofline

    def record(arch, mesh, status, peak):
        rec = Roofline(arch, "train_4k", mesh, "train_step", 1e12, 1e12,
                       1e9, {}, peak, 1e9, 1e14).to_dict()
        return {**rec, "status": status}

    recs = {"a__train_4k__16x16": record("a", "16x16", "ok", 1e9),
            "b__train_4k__16x16": record(
                "b", "16x16", f"{PROBE_MISMATCH}: bytes: ...", 9e10),
            "c__train_4k__16x16": {"arch": "c", "shape": "train_4k",
                                   "mesh": "16x16",
                                   "status": "error: RuntimeError: x"},
            "d__train_4k__1x1": record("d", "1x1", "ok", 1e9)}
    for name, rec in recs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    rows = R.load(str(tmp_path))
    table = R.table(rows, "16x16")
    assert "| a | train_4k | train_step |" in table
    assert "| b | train_4k | train_step * |" in table
    assert "| c |" not in table and R.FOOTNOTE in table
    assert [f.split(":")[0] for f in R.failures(rows)] == [
        "b x train_4k x 16x16", "c x train_4k x 16x16"]
    assert R.over_memory(rows) == ["b x train_4k x 16x16: 90.0 GB"]
    assert R.table(rows, "1x1").startswith("### Roofline — mesh 1x1 (1 H100s)")
    assert "| b | train_4k * |" in R.experiments_tables(str(tmp_path))
