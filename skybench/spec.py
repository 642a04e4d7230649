"""Finding a cell's parts by name.

``BENCHMARK.json`` lists the cells and metrics; each part lives in a file
of its own under this folder, named after the part, so that a new
configuration, traffic mix, cell or metric is a new file and a new entry,
never an edit:

* ``configs/<config>.json``: the model's sizes as run, its source, what
  was reduced, assumed and departed from;
* ``traffic/<traffic>.json``: one request mix and arrival process, the
  parameters ``skybench.traffic`` generates requests from;
* ``cells/<workload>.json``: the deployment of one cell (clients,
  slots, page pool, chunk budget) and its correctness limits;
* ``metrics/<metric>.py``: one metric's reader.  A split metric
  ``<base>.<suffix>`` (``step_ms.batch``) takes ``metrics/<base>.py``
  when it has no file of its own.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its parts loaded."""

    name: str
    config: dict
    traffic: dict
    deploy: dict
    chips: int
    end_to_end: list
    per_layer: list


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell named ``workload`` with its configuration, traffic mix,
    deployment and the metrics it reports."""
    bench = bench if bench is not None else benchmark(root)
    here = root / "skybench"
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{sorted(entries)}")
    w = entries[workload]
    return Cell(
        name=workload,
        config=load_json(here / "configs" / f"{w['config']}.json"),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        deploy=load_json(here / "cells" / f"{workload}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def reader(metric: str, root: Path = ROOT):
    """The module that reads ``metric``: ``metrics/<metric>.py``, else,
    for a split name, ``metrics/<base>.py``."""
    here = root / "skybench" / "metrics"
    path = here / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = here / f"{metric.split('.', 1)[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} under "
                                f"{here}")
    spec = importlib.util.spec_from_file_location(
        f"skybench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
