"""Dry-run of every (arch x shape x mesh) combination: the port's
``repro/launch/dryrun.py``.

Proves the distribution config is coherent without hardware and prices
each step on the H100's roofline terms: ``launch.specs.make_plan`` builds
the step over the production mesh's ``DeviceMesh`` on a world of 256 or
512 fake ranks (``specs.fake_world``), ``specs.lower_plan`` runs it once
on fake tensors and counts rank 0's FLOPs, bytes, collectives and peak
memory, and ``launch.roofline`` turns the counts into compute, memory and
link times.  A host tool: it runs nothing on a device and allocates no
tensor's storage, as the reference forces 512 host devices.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all            # every combo, both meshes
  python -m repro_torch.launch.dryrun --all --resume   # skip combos already done

The full depth is counted directly (the port's layer loop is Python), and
the reference's per-layer probes are solved beside it
(``launch.probe``): a combination whose two counts part by more than
1e-6 relative is recorded as an error (``PROBE_MISMATCH``) that keeps
its full-depth count, which ``roofline_report`` shows, marked.  The
record has the reference's keys except ``gqa_grouped``, an environment
switch of the reference (``REPRO_GQA_GROUPED``) that the port has no
counterpart of.

Skips (as the reference): seamless-m4t-large-v2 x long_500k
(encoder-decoder with no windowed encoder variant).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh, make_rules
from repro_torch.launch.specs import fake_world, lower_plan, make_plan
from repro_torch.models.config import INPUT_SHAPES, InputShape

SKIPS: set[tuple[str, str]] = {
    ("seamless-m4t-large-v2", "long_500k"),
}
DEFAULT_OUT = "build/dryrun"
PROBE_RTOL = 1e-6
# The status of a record whose probe solution parts from its full-depth
# count; the record keeps that count (``roofline_report`` shows it).
PROBE_MISMATCH = "error: probe solution differs from the full-depth count"


def _probe_mismatch(full: dict, solved: dict) -> list[str]:
    """The metrics whose full-depth count and probe solution part by more
    than ``PROBE_RTOL`` relative (or one unit: the solve rounds)."""
    return [f"{k}: full {full.get(k, 0.0):.9e} probes {solved.get(k, 0.0):.9e}"
            for k in sorted(set(full) | set(solved))
            if not math.isclose(full.get(k, 0.0), solved.get(k, 0.0),
                                rel_tol=PROBE_RTOL, abs_tol=1.0)]


def run_one(
    arch: str,
    shape_name: str | InputShape,
    *,
    multi_pod: bool = False,
    mesh=None,
    remat: str | None = "full",
    fsdp: bool | None = None,
    seq_shard: bool | None = None,
    shard_kv_heads: bool = True,
    seq_parallel_acts: bool = False,
    grad_accum: int = 1,
    moe_group_size: int = 0,
    capacity_factor: float = 0.0,
    kvc_int8: bool = False,
    attn_tp: bool | None = None,
    bf16_moments: bool = False,
    verbose: bool = True,
) -> dict:
    """Count one (arch x shape x mesh) combination; returns its record.

    ``mesh`` (a ``MeshShape``) replaces the production mesh of
    ``multi_pod``, and ``shape_name`` may be an ``InputShape`` of its own
    (``chip_smoke.py`` counts a training step on a world of one).  Must
    run where no process group is live (``specs.fake_world``)."""
    from repro_torch.launch.probe import (
        extract_metrics,
        probe_set,
        solve_linear,
    )
    from repro_torch.launch.roofline import Roofline, model_flops

    cfg = get_config(arch)
    if moe_group_size:
        cfg = cfg.replace(moe_group_size=moe_group_size)
    if capacity_factor:
        cfg = cfg.replace(capacity_factor=capacity_factor)
    if kvc_int8:
        cfg = cfg.replace(kvc_dtype="int8")
    shape = (shape_name if isinstance(shape_name, InputShape)
             else INPUT_SHAPES[shape_name])
    mesh_shape = mesh or make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(n) for n in mesh_shape.sizes)
    opt = None
    if bf16_moments:
        from repro_torch.training.optimizer import AdamWConfig
        opt = AdamWConfig(moment_dtype="bfloat16")
    t0 = time.perf_counter()
    with fake_world(mesh_shape) as dmesh:
        rules = make_rules(dmesh, cfg, shape, fsdp=fsdp, seq_shard=seq_shard,
                           shard_kv_heads=shard_kv_heads,
                           seq_parallel_acts=seq_parallel_acts,
                           attn_tp=attn_tp)

        def count(c):
            plan = make_plan(c, shape, rules, remat=remat, unroll=False,
                             grad_accum=grad_accum, opt=opt, device="meta")
            return plan, lower_plan(plan)

        # 1) the full depth: every layer counted
        plan, counted = count(cfg)
        mem = counted.memory_analysis()
        full = extract_metrics(counted)
        t_full = time.perf_counter() - t0
        if verbose:
            print(f"[{arch} x {shape.name} x {mesh_name}] {plan.name}")
            print(f"  memory_analysis: {mem}")

        # 2) the per-layer probes, solved for the full depth
        pset = probe_set(cfg)
        measured = [extract_metrics(count(cfg.replace(**overrides))[1])
                    for overrides, _counts in pset.variants]
        solved = solve_linear(pset, measured)
        t_probe = time.perf_counter() - t0 - t_full
        if verbose:
            print(f"  cost (full): flops={full['flops']:.3e} "
                  f"bytes={full['bytes']:.3e} "
                  f"coll={full['collective_bytes']:.3e}")
            print(f"  cost (probed): flops={solved['flops']:.3e} "
                  f"bytes={solved['bytes']:.3e} "
                  f"coll={solved['collective_bytes']:.3e}")
    mismatch = _probe_mismatch(full, solved)

    roof = Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, step=plan.name,
        flops_per_device=full["flops"],
        bytes_per_device=full["bytes"],
        collective_bytes=full["collective_bytes"],
        collectives=dict(counted.collectives),
        peak_memory_bytes=float(
            mem.temp_size_in_bytes + mem.argument_size_in_bytes
            + mem.output_size_in_bytes - mem.alias_size_in_bytes),
        argument_bytes=float(mem.argument_size_in_bytes),
        model_flops=model_flops(plan.cfg, shape),
        nvlink_bytes=full["nvlink_bytes"],
    )
    rec = roof.to_dict()
    rec.update(
        full_compile_s=round(t_full, 1),
        probe_compile_s=round(t_probe, 1),
        remat=remat,
        fsdp=rules.fsdp,
        seq_shard=rules.seq_shard_cache,
        shard_kv_heads=rules.shard_kv_heads,
        seq_parallel_acts=rules.seq_parallel_acts,
        grad_accum=grad_accum,
        moe_group_size=moe_group_size or cfg.moe_group_size,
        kvc_int8=kvc_int8,
        attn_tp=rules.attn_tp,
        status=("ok" if not mismatch else
                f"{PROBE_MISMATCH}: " + "; ".join(mismatch)),
    )
    if verbose:
        print(f"  roofline: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"dominant={roof.dominant} "
              f"useful={roof.useful_flops_ratio:.2f}")
        print(f"  peak {roof.peak_memory_bytes/2**30:.2f} GiB/device "
              f"(full {t_full:.0f}s probes {t_probe:.0f}s) {rec['status']}")
    return rec


def _result_path(out_dir, arch, shape, mesh_name):
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS)
    p.add_argument("--shape", choices=list(INPUT_SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip combos whose result JSON already exists")
    p.add_argument("--remat", default="full",
                   choices=["none", "dots", "dots_no_batch", "full"])
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--seq-shard", action="store_true", default=None)
    p.add_argument("--no-shard-kv", action="store_true")
    p.add_argument("--seq-parallel", action="store_true")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--moe-group-size", type=int, default=0)
    p.add_argument("--capacity-factor", type=float, default=0.0)
    p.add_argument("--kvc-int8", action="store_true")
    p.add_argument("--attn-tp", action="store_true", default=None)
    p.add_argument("--bf16-moments", action="store_true")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--tag", default="", help="suffix for result files")
    args = p.parse_args(argv)

    remat = None if args.remat == "none" else args.remat
    os.makedirs(args.out, exist_ok=True)

    combos: list[tuple[str, str, bool]] = []
    if args.all:
        arch_list = [args.arch] if args.arch else ARCH_IDS
        if "skymemory-tinyllama" in arch_list and not args.arch:
            arch_list = [a for a in arch_list if a != "skymemory-tinyllama"]
        for arch in arch_list:
            for shape in INPUT_SHAPES:
                if (arch, shape) in SKIPS:
                    continue
                combos.append((arch, shape, False))
                combos.append((arch, shape, True))
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape, args.multi_pod)]

    failures = 0
    for arch, shape, mp in combos:
        mesh_name = ("2x16x16" if mp else "16x16") + (
            f"__{args.tag}" if args.tag else "")
        path = _result_path(args.out, arch, shape, mesh_name)
        if args.resume and os.path.exists(path):
            continue
        try:
            rec = run_one(
                arch, shape, multi_pod=mp, remat=remat,
                fsdp=False if args.no_fsdp else None,
                seq_shard=args.seq_shard,
                shard_kv_heads=not args.no_shard_kv,
                seq_parallel_acts=args.seq_parallel,
                grad_accum=args.grad_accum,
                moe_group_size=args.moe_group_size,
                capacity_factor=args.capacity_factor,
                kvc_int8=args.kvc_int8,
                attn_tp=args.attn_tp,
                bf16_moments=args.bf16_moments,
            )
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "status": f"error: {type(e).__name__}: {e}"}
        if rec["status"] != "ok":
            failures += 1
        rec["tag"] = args.tag
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
