"""The harness is driven by data: a new configuration, traffic mix, cell
or metric is new files and new entries, found by name; and nothing of
the benchmark imports JAX or the JAX package."""
import ast
import json
import shutil
import subprocess
import sys

from skybench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_a_new_cell_is_found_by_name_with_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "skybench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "skybench").rglob("*")
              if p.is_file()}
    bench = spec.benchmark()
    here = root / "skybench"
    cfg = json.loads((here / "configs" / "stablelm-12b.json").read_text())
    (here / "configs" / "new-model.json").write_text(
        json.dumps(dict(cfg, name="new-model", num_hidden_layers=8)))
    mix = json.loads((here / "traffic" / "rag-batch.json").read_text())
    (here / "traffic" / "chat-batch.json").write_text(json.dumps(
        dict(mix, documents=16, document_tokens=256,
             question_tokens=[64, 512])))
    (here / "cells" / "new-model.chat-batch.json").write_text(json.dumps(
        {"clients": 12, "slots": 8, "max_seq_len": 2048,
         "chunk_tokens": 256, "block_size": 128,
         "limits": {"logit_gap": 1.0}}))
    (here / "metrics" / "queue_wait_ms.py").write_text(
        "UNIT, LAYER = 'ms', 'scheduler'\n\ndef read(run):\n    return 1.5\n")
    bench["configs"].append(dict(bench["configs"][0], name="new-model",
                                 file="skybench/configs/new-model.json"))
    bench["workloads"].append({"name": "new-model.chat-batch",
                               "config": "new-model",
                               "traffic": "chat-batch", "chips": 1,
                               "why": "a new cell"})
    bench["per_layer"].append({"name": "queue_wait_ms", "unit": "ms",
                               "better": "lower",
                               "source": "program_span",
                               "layer": "scheduler",
                               "moves": "output_tokens_per_s",
                               "workloads": ["new-model.chat-batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("new-model.chat-batch", root=root)
    assert cell.config["num_hidden_layers"] == 8
    assert cell.traffic["documents"] == 16 and cell.deploy["clients"] == 12
    assert [m["name"] for m in cell.per_layer] == ["queue_wait_ms"]
    assert spec.reader("queue_wait_ms", root=root).read(None) == 1.5
    # a split metric's reader is its base name's file
    assert spec.reader("step_ms.batch", root=root).UNIT == "ms"
    # and the generator reads the new mix with no new code
    from skybench.traffic import Mix
    reqs = Mix(cell.traffic, 5).requests(64, "window")
    assert len({r.doc for r in reqs}) == 16
    assert reqs == Mix(cell.traffic, 5).requests(64, "window")
    # no file that was there changed
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_every_metric_has_a_reader_that_agrees_with_benchmark_json():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = spec.reader(m["name"])
        assert mod.UNIT == m["unit"], m["name"]
        if m in bench["per_layer"]:
            assert mod.LAYER == m["layer"], m["name"]
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in spec.HERE.rglob("*.py"):
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_a_process_of_the_harness_loads_neither():
    code = ("import sys; sys.path[:0] = ['.', 'src'];"
            "import skybench.harness, skybench.check, skybench.trace;"
            "import repro_torch.serving, repro_torch.models.model;"
            "from skybench.harness import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_command_refuses_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "skybench/run.py", "--workload",
         "stablelm-12b.rag-batch", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
