"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and no ``examples/torch_*.py`` imports JAX or anything
of ``repro``, and the default
device of the entry points (``"cuda"``) raises where there is no card
instead of running on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _modules() -> list[str]:
    mods = []
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "examples").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statements(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_no_jax_or_repro():
    mods = _modules()
    examples = sorted(str(f) for f in (ROOT / "examples").glob("torch_*.py"))
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({examples!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "repro_torch.serving.engine" in mods
    assert "repro_torch.kernels._build" in mods
    assert "repro_torch.core.protocol" in mods
    assert [Path(e).name for e in examples] == [
        "torch_constellation_sim.py", "torch_quickstart.py",
        "torch_serve_skymemory.py", "torch_train_small.py"]
    for m in ("core.faults", "serving.cluster", "serving.router",
              "serving.slo", "serving.traffic", "serving.worker",
              "models.moe", "models.mla", "configs.deepseek_v3_671b",
              "configs.granite_moe_3b_a800m",
              "configs.stablelm_12b", "configs.nemotron_4_340b",
              "configs.llava_next_34b", "configs.internlm2_1_8b",
              "configs.yi_9b", "kernels.flash_backward",
              "kernels.ssd_backward", "training",
              "training.optimizer", "training.data", "training.checkpoint",
              "training.loop", "launch.train", "launch.serve",
              "core.simulator", "core.tpu_cache", "launch.specs",
              "launch.mesh", "distributed.decode", "distributed.sharding",
              "launch.roofline", "launch.probe", "launch.dryrun",
              "launch.roofline_report"):
        assert f"repro_torch.{m}" in mods


@pytest.mark.parametrize("package,names", [
    ("repro_torch.distributed",
     ("cache_specs", "cache_shardings", "distribute_cache", "param_specs",
      "distribute_model", "maybe_shard")),
    ("repro_torch.launch.specs", ("StepPlan", "input_specs", "make_plan",
                                  "lower_plan", "fake_world", "Counted",
                                  "argument_bytes")),
    ("repro_torch.launch.roofline",
     ("Roofline", "model_flops", "streaming_attn_correction",
      "collective_traffic", "collectives_from", "PEAK_FLOPS", "HBM_BW",
      "NVLINK_BW", "NIC_BW")),
    ("repro_torch.launch.probe",
     ("ProbeSet", "probe_set", "extract_metrics", "solve_linear")),
    ("repro_torch.launch.dryrun", ("run_one", "main", "SKIPS")),
    ("repro_torch.launch.roofline_report",
     ("load", "table", "failures", "remark", "experiments_tables")),
    ("repro_torch.launch.mesh", ("make_production_mesh", "make_rules")),
    ("repro_torch.serving",
     ("EngineCluster", "StreamWorker", "PrefixAffinityRouter", "SLOTracker",
      "AdmissionController", "TrafficGenerator", "standard_tenants",
      "spread_anchors")),
    ("repro_torch.core",
     ("FaultPlan", "FaultInjector", "plan_survivable_kills", "PayloadCodec",
      "encode_arrays", "make_delta_payload", "sweep", "SimConfig",
      "MEMORY_HIERARCHY_S", "TorusGrid", "LinkModel", "gather_cost_s",
      "migrate_shards")),
])
def test_package_exports_load_no_jax_or_repro(package, names):
    """The scale-out names come through the packages' own ``__init__``
    and bring no JAX, ``ml_dtypes`` or ``repro`` with them."""
    code = (
        "import importlib, sys\n"
        f"pkg = importlib.import_module({package!r})\n"
        f"missing = [n for n in {names!r} if not hasattr(pkg, n)]\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_fabric_imports_no_torch():
    """The SkyMemory fabric (``repro_torch.core``, its fault model and
    codecs included) is numpy and plain Python: importing it loads no
    torch, no JAX and nothing of ``repro``."""
    code = (
        "import sys\n"
        "import repro_torch.core, repro_torch.core.eviction\n"
        "import repro_torch.core.faults, repro_torch.core.simulator\n"
        "import repro_torch.core.tpu_cache\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN + ('torch',)!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import ConstellationKVC, ConstellationSpec, LosWindow, Sat
    from repro_torch.device import resolve_device
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine

    def kvc():
        return ConstellationKVC(ConstellationSpec(5, 19, 550.0),
                                LosWindow(Sat(2, 9), 5, 5), num_servers=10)

    cfg = smoke_config(get_config("skymemory-tinyllama"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cpu_model = Model(cfg.replace(dtype="float32"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cpu_model, block_size=16, max_seq_len=64, max_batch=1)
    # a constellation does not change the rule
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cpu_model, kvc=kvc(), block_size=16, max_seq_len=64,
               max_batch=1)
    eng = Engine(cpu_model, block_size=16, max_seq_len=64, max_batch=1,
                 device="cpu")
    assert eng.cache.k_pool.device.type == "cpu"
    eng = Engine(cpu_model, kvc=kvc(), block_size=16, max_seq_len=64,
                 max_batch=1, device="cpu")
    assert eng.kv.manager is eng.manager is not None
    # nor does scale-out: every replica is an engine on the same device
    from repro_torch.serving import EngineCluster
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCluster(cpu_model, kvc(), num_replicas=2, block_size=16,
                      max_seq_len=64, max_batch=1)
    cluster = EngineCluster(cpu_model, kvc(), num_replicas=2, block_size=16,
                            max_seq_len=64, max_batch=1, device="cpu")
    assert all(e.device.type == "cpu" for e in cluster.engines)
    # the SSM family, served by the dense runtime, follows the same rule
    ssm = smoke_config(get_config("mamba2-1.3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(ssm)
    cpu_ssm = Model(ssm.replace(dtype="float32"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cpu_ssm, block_size=16, max_seq_len=64, max_batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cpu_ssm, kvc=kvc(), block_size=16, max_seq_len=64,
               max_batch=1)
    eng = Engine(cpu_ssm, block_size=16, max_seq_len=64, max_batch=1,
                 device="cpu")
    assert not eng.paged and eng.cache is None
    assert eng._dense.device.type == "cpu"


def test_make_plan_default_device_raises_without_cuda():
    """A plan builds its model on the card unless asked otherwise; on
    ``meta`` it needs no device at all."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh, make_rules
    from repro_torch.launch.specs import make_plan

    cfg, shape = get_config("skymemory-tinyllama"), INPUT_SHAPES["decode_32k"]
    rules = make_rules(make_production_mesh(), cfg, shape)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_plan(cfg, shape, rules)
    plan = make_plan(cfg, shape, rules, device="meta")
    assert next(plan.model.parameters()).device.type == "meta"


def test_other_families_raise_not_implemented():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.model import Model

    cfg = smoke_config(get_config("skymemory-tinyllama"))
    # the encoder-decoder family is ported now: it builds on the CPU, and
    # its default device raises without a card
    encdec = Model(smoke_config(get_config("seamless-m4t-large-v2")),
                   device="cpu")
    assert len(encdec.encoder) == len(encdec.cross) == 2
    assert not encdec.supports_paged_decode
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(smoke_config(get_config("seamless-m4t-large-v2")))
    # MLA is served now: it builds on the CPU, and its default device
    # raises without a card
    mla = smoke_config(get_config("deepseek-v3-671b"))
    assert not Model(mla, device="cpu").supports_paged_decode
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(mla)
    # the MoE, VLM and hybrid families, and a sliding window, are served now
    for name in ("granite-moe-3b-a800m", "llava-next-34b", "zamba2-1.2b"):
        Model(smoke_config(get_config(name)).replace(dtype="float32"),
              device="cpu")
    windowed = Model(cfg.replace(sliding_window=64), device="cpu")
    assert not windowed.supports_paged_decode
    hybrid = Model(smoke_config(get_config("zamba2-1.2b")), device="cpu")
    assert hybrid.shared_attn is not None and not hybrid.supports_paged_decode
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(smoke_config(get_config("zamba2-1.2b")))
