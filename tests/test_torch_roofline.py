"""The port's roofline and probe arithmetic (``repro_torch.launch.
roofline``, ``launch.probe``) and the five-lever ``launch.mesh.make_rules``
against the reference's, from sizes alone: no process group, no tensor.

``model_flops`` and ``streaming_attn_correction`` for the 11 configs x 4
shapes x every remat value; ``collective_traffic`` against the
reference's ``parse_collectives`` on the five lines of ``test_launch``'s
HLO sample; the ``Roofline`` terms on the H100's constants; ``probe_set``
and ``solve_linear``; and ``make_rules`` field by field over the lever
combinations at both production meshes.
"""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, get_config
from repro.launch import probe as JP
from repro.launch import roofline as JR
from repro.launch.mesh import make_rules as j_make_rules
from repro.models.config import INPUT_SHAPES
from repro_torch.configs import INPUT_SHAPES as T_INPUT_SHAPES
from repro_torch.configs import get_config as tget
from repro_torch.launch import probe as TP
from repro_torch.launch import roofline as TR
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.mesh import make_rules as t_make_rules

ROOT = Path(__file__).resolve().parents[1]
REMATS = (None, "none", "dots", "dots_no_batch", "full")
HLO_SAMPLE = """
  %ag = bf16[8,1024,128]{2,1,0} all-gather(%x), replica_groups=[16,16]<=[256], dimensions={1}
  %ar = f32[256,1024]{1,0} all-reduce(%y), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %rs = f32[64,64]{1,0} reduce-scatter(%z), replica_groups=[8,2]<=[16], dimensions={0}
  %cp = bf16[2,2]{1,0} collective-permute(%w), source_target_pairs={{0,1},{1,0}}
  %a2a = s32[16,16]{1,0} all-to-all(%v), replica_groups=[4,4]<=[16], dimensions={0}
"""


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_streaming_correction_equal_the_reference(arch):
    jcfg, tcfg = get_config(arch), tget(arch)
    for name in INPUT_SHAPES:
        js, ts = INPUT_SHAPES[name], T_INPUT_SHAPES[name]
        assert TR.model_flops(tcfg, ts) == JR.model_flops(jcfg, js), name
        for remat in REMATS:
            assert (TR.streaming_attn_correction(tcfg, ts, remat)
                    == JR.streaming_attn_correction(jcfg, js, remat)), (
                name, remat)


@pytest.mark.parametrize("line", [l for l in HLO_SAMPLE.splitlines()
                                  if l.strip()],
                         ids=lambda l: l.split()[0])
def test_collective_traffic_equals_parse_collectives(line):
    """Each HLO line's result shape and group size fed to the port's
    ``collective_traffic`` gives the reference's per-device traffic."""
    want = JR.parse_collectives(line)
    (op, traffic), = want.items()
    m = JR._COLL_RE.search(line)
    dtype, dims, _ = m.groups()
    got = TR.collective_traffic(op, JR._shape_bytes(dtype, dims),
                                JR._group_size(line))
    assert got == pytest.approx(traffic, rel=1e-12)
    assert TR.op_name({"all-gather": "_c10d_functional::all_gather_into_tensor",
                       "all-reduce": "c10d::allreduce_",
                       "reduce-scatter": "_c10d_functional::"
                                         "reduce_scatter_tensor",
                       "all-to-all": "_c10d_functional::all_to_all_single",
                       "collective-permute": "c10d::broadcast_"}[op]) == op


def test_roofline_terms_on_the_h100_constants():
    """989 TFLOP/s, 3.35 TB/s, NVLink 450 GB/s within a host and 50 GB/s
    across hosts; the dominant term, the useful ratio (the reference's
    mesh-to-chip map) and the record's keys as the reference's."""
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.NVLINK_BW, TR.NIC_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    kw = dict(arch="a", shape="train_4k", mesh="16x16", step="train_step",
              flops_per_device=2 * 989e12, bytes_per_device=3.35e12,
              collective_bytes=500e9, collectives={"all-gather": 500e9},
              peak_memory_bytes=1.0, argument_bytes=1.0,
              model_flops=256 * 989e12)
    r = TR.Roofline(**kw, nvlink_bytes=450e9)
    assert r.compute_s == pytest.approx(2.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0 + 50e9 / 50e9)
    assert r.dominant == "compute"
    assert r.useful_flops_ratio == pytest.approx(0.5)
    cross = TR.Roofline(**kw)
    assert cross.collective_s == pytest.approx(10.0)
    assert cross.dominant == "collective"
    assert TR.Roofline(**{**kw, "mesh": "2x16x16"}).useful_flops_ratio == (
        pytest.approx(0.25))
    assert TR.Roofline(**{**kw, "mesh": "1x1"}).useful_flops_ratio == (
        pytest.approx(128.0))
    jr = JR.Roofline(**kw)
    assert set(r.to_dict()) == set(jr.to_dict())
    assert TR.within_host(range(8)) and not TR.within_host(range(4, 12))
    assert not TR.within_host(range(16))


def test_no_tpu_constant_in_the_port():
    """None of the reference's TPU constants (197 TFLOP/s, 819 GB/s, 50
    GB/s ICI links) is carried into the port's launch tools."""
    pat = re.compile(r"197e12|819e9|\bLINK_BW\b|\bICI\b|v5e")
    for path in sorted((ROOT / "src" / "repro_torch" / "launch").glob("*.py")):
        assert not pat.search(path.read_text()), path.name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_set_equals_the_reference(arch):
    jp, tp = JP.probe_set(get_config(arch)), TP.probe_set(tget(arch))
    assert (tp.var_names, tp.full_counts, tp.variants) == (
        jp.var_names, jp.full_counts, jp.variants)


def test_solve_linear_equals_the_reference():
    rng = np.random.default_rng(0)
    for arch in ("yi-9b", "zamba2-1.2b", "deepseek-v3-671b",
                 "seamless-m4t-large-v2"):
        jp, tp = JP.probe_set(get_config(arch)), TP.probe_set(tget(arch))
        measured = [{"flops": float(rng.integers(1, 10**12)),
                     "bytes": float(rng.integers(1, 10**10)),
                     "coll:all-gather": float(rng.integers(0, 10**8))}
                    for _ in jp.variants]
        assert TP.solve_linear(tp, measured) == JP.solve_linear(jp, measured)


LEVERS = list(itertools.product((None, False, True), (None, False, True),
                                (True, False), (False, True),
                                (None, False, True)))
RULE_FIELDS = ("data_axes", "model_axis", "shard_kv_heads",
               "seq_shard_cache", "fsdp", "attn_tp", "seq_parallel_acts")


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("multi_pod", (False, True), ids=("16x16", "2x16x16"))
def test_make_rules_levers_equal_the_reference(shape, multi_pod):
    """Every combination of ``fsdp``, ``seq_shard``, ``shard_kv_heads``,
    ``seq_parallel_acts`` and ``attn_tp`` gives the reference's rules,
    field by field (the reference over an ``AbstractMesh`` of the same
    names and sizes)."""
    tm = make_production_mesh(multi_pod=multi_pod)
    jm = AbstractMesh(tm.sizes, tm.axis_names)
    cfg, tcfg = get_config("yi-9b"), tget("yi-9b")
    for fsdp, seq_shard, kv, sp, attn_tp in LEVERS:
        kw = dict(fsdp=fsdp, seq_shard=seq_shard, shard_kv_heads=kv,
                  seq_parallel_acts=sp, attn_tp=attn_tp)
        want = j_make_rules(jm, cfg, INPUT_SHAPES[shape], **kw)
        got = t_make_rules(tm, tcfg, T_INPUT_SHAPES[shape], **kw)
        for f in RULE_FIELDS:
            assert getattr(got, f) == getattr(want, f), (f, kw)
    assert t_make_rules(tm, tcfg, T_INPUT_SHAPES[shape]) == t_make_rules(
        tm, tcfg, T_INPUT_SHAPES[shape], fsdp=None, seq_shard=None,
        shard_kv_heads=True, seq_parallel_acts=False, attn_tp=None)
