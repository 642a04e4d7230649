"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of ``repro``, and the default
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
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
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
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
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


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine

    cfg = smoke_config(get_config("skymemory-tinyllama"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cpu_model = Model(cfg.replace(dtype="float32"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cpu_model, block_size=16, max_seq_len=64, max_batch=1)
    eng = Engine(cpu_model, block_size=16, max_seq_len=64, max_batch=1,
                 device="cpu")
    assert eng.cache.k_pool.device.type == "cpu"


def test_other_families_raise_not_implemented():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.model import Model

    cfg = smoke_config(get_config("skymemory-tinyllama"))
    for kw in ({"arch_type": "moe", "num_experts": 4},
               {"use_mla": True}, {"arch_type": "ssm"},
               {"sliding_window": 64}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(cfg.replace(**kw), device="cpu")
