"""Render the dry-run records as roofline tables: the port's
``benchmarks/roofline_report.py``.

Run after ``python -m repro_torch.launch.dryrun --all``:
  PYTHONPATH=src python -m repro_torch.launch.roofline_report [--mesh 16x16]

The times are predictions on the H100's roofline terms
(``launch.roofline``), not measurements.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT, PROBE_MISMATCH
from repro_torch.launch.roofline import _chips

RESULTS = DEFAULT_OUT
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
HBM_BYTES = 80e9             # an H100 SXM's device memory


def load(results_dir: str = RESULTS) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        parts = os.path.basename(path)[:-5].split("__")
        rec.setdefault("tag", parts[3] if len(parts) > 3 else "")
        rows.append(rec)
    return rows


def _ms(x) -> str:
    return f"{x*1e3:10.2f}"


def counted(r: dict) -> bool:
    """A record with its full-depth count: ``ok``, or one whose
    reference probe model parts from that count (``PROBE_MISMATCH``)."""
    status = r.get("status", "")
    return status == "ok" or status.startswith(PROBE_MISMATCH)


def _mark(r: dict) -> str:
    return "" if r.get("status") == "ok" else " *"


FOOTNOTE = ("\\* the reference's per-layer probe model parts from the "
            "full-depth count, which is shown (see the failures)")


def _selected(rows: list[dict], mesh: str) -> list[dict]:
    sel = [r for r in rows if r.get("mesh") == mesh
           and counted(r) and not r.get("tag")]
    sel.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])))
    return sel


def table(rows: list[dict], mesh: str) -> str:
    out = [
        f"### Roofline — mesh {mesh} ({_chips(mesh)} H100s)",
        "",
        "| arch | shape | step | compute(ms) | memory(ms) | coll(ms) | "
        "dominant | useful | peak GiB/dev |",
        "|---|---|---|---:|---:|---:|---|---:|---:|",
    ]
    for r in _selected(rows, mesh):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['step']}{_mark(r)} |"
            f"{_ms(r['compute_s'])} |{_ms(r['memory_s'])} |"
            f"{_ms(r['collective_s'])} | {r['dominant']} |"
            f" {r['useful_flops_ratio']:.2f} |"
            f" {r['peak_memory_bytes']/2**30:.1f} |"
        )
    if any(_mark(r) for r in _selected(rows, mesh)):
        out += ["", FOOTNOTE]
    return "\n".join(out)


def failures(rows: list[dict]) -> list[str]:
    return [
        f"{r['arch']} x {r['shape']} x {r['mesh']}: "
        + r["status"].splitlines()[0][:300]
        for r in rows if r.get("status") != "ok"
    ]


def over_memory(rows: list[dict]) -> list[str]:
    """The combinations whose predicted peak exceeds one card's 80 GB."""
    return [
        f"{r['arch']} x {r['shape']} x {r['mesh']}: "
        f"{r['peak_memory_bytes']/1e9:.1f} GB"
        for r in rows if counted(r) and not r.get("tag")
        and r["peak_memory_bytes"] > HBM_BYTES
    ]


def remark(r: dict) -> str:
    """One sentence: what would move the dominant term down."""
    dom, step = r["dominant"], r["step"]
    if step == "train_step":
        if dom == "collective":
            return ("reduce the per-block activation all-reduces over model "
                    "to bf16 reduce-scatter + all-gather (sequence "
                    "parallelism) and overlap the FSDP weight gathers with "
                    "compute")
        if dom == "memory":
            return ("cut unfused HBM traffic: the plain attention's score "
                    "tensors go away under K4 and its backward, fuse "
                    "norm/residual, microbatch the resident activations")
        return "raise per-card arithmetic intensity (larger microbatch)"
    if step == "prefill_step":
        if dom == "collective":
            return ("drop FSDP weight gathers for serving (resident TP "
                    "weights) and keep activations sequence-sharded")
        return ("K4 (the dense prefill kernel) keeps the scores on chip "
                "instead of the plain version's round trips to HBM")
    # serve_step
    if dom == "collective":
        return ("serve with resident (non-FSDP) weights; only K1's partials "
                "over the striped cache remain to gather inside local_map")
    return ("int8 KV cache (the paper's 8-bit trade-off) halves K1's cache "
            "reads; replay the step from a CUDA graph")


def experiments_tables(results_dir: str = RESULTS) -> str:
    rows = load(results_dir)
    out = []
    for mesh in ("16x16", "2x16x16"):
        out.append(f"### Roofline — mesh {mesh} ({_chips(mesh)} H100s)\n")
        out.append("| arch | shape | compute(ms) | memory(ms) | coll(ms) | "
                   "dominant | useful | peak GiB/dev | to move the dominant "
                   "term down |")
        out.append("|---|---|---:|---:|---:|---|---:|---:|---|")
        sel = _selected(rows, mesh)
        for r in sel:
            out.append(
                f"| {r['arch']} | {r['shape']}{_mark(r)} |"
                f"{_ms(r['compute_s'])} |"
                f"{_ms(r['memory_s'])} |{_ms(r['collective_s'])} | "
                f"{r['dominant']} | {r['useful_flops_ratio']:.2f} | "
                f"{r['peak_memory_bytes']/2**30:.1f} | {remark(r)} |")
        if any(_mark(r) for r in sel):
            out += ["", FOOTNOTE]
        out.append("")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dir", default=RESULTS)
    args = ap.parse_args(argv)
    rows = load(args.dir)
    meshes = [args.mesh] if args.mesh else ["16x16", "2x16x16"]
    for mesh in meshes:
        print(table(rows, mesh))
        print()
    over = over_memory(rows)
    if over:
        print("### Predicted peak above 80 GB")
        for o in over:
            print(" -", o)
        print()
    bad = failures(rows)
    if bad:
        print("### Failures")
        for b in bad:
            print(" -", b)
    print(f"({len(rows)} results loaded)")


if __name__ == "__main__":
    main()
