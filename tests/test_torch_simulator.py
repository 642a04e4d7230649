"""The port's latency simulator (``repro_torch.core.simulator``) against
the reference's (``repro.core.simulator``): the same sweep, grids, tier
classifier and Table 1, every float bitwise equal.  And the two host
examples the port adds, ``examples/torch_constellation_sim.py`` and
``examples/torch_quickstart.py``, print exactly what the reference's
``constellation_sim.py`` and ``quickstart.py`` print."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.simulator as J
import repro_torch.core.simulator as T
from repro.core.mapping import Strategy as JStrategy
from repro_torch.core.mapping import Strategy as TStrategy

ROOT = Path(__file__).resolve().parents[1]

STRATEGIES = ("rotation", "hop", "rotation_hop")
SERVERS = (9, 25, 49, 81)
ALTITUDES = (160.0, 550.0, 1000.0, 2000.0)
# the default sweep's points, in its own order (strategy x servers x altitude)
POINTS = [(s, n, h) for s in STRATEGIES for n in SERVERS for h in ALTITUDES]


@pytest.fixture(scope="module")
def sweeps():
    return J.sweep(), T.sweep()


def _fields(r) -> dict:
    return dataclasses.asdict(r)


@pytest.mark.parametrize("i", range(len(POINTS)),
                         ids=[f"{s}-{n}-{h:.0f}" for s, n, h in POINTS])
def test_default_sweep_point_is_bitwise_the_reference(sweeps, i):
    want, got = sweeps
    assert len(got) == len(want) == len(POINTS)
    s, n, h = POINTS[i]
    assert (got[i].strategy, got[i].num_servers, got[i].altitude_km) == (
        s, n, h)
    assert _fields(got[i]) == _fields(want[i])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_slow_servers_at_49_are_bitwise_the_reference(strategy):
    """A non-default ``SimConfig``: ten times the per-chunk processing
    time, 49 servers."""
    jcfg = J.SimConfig(chunk_processing_time_s=0.02, num_servers=49)
    tcfg = T.SimConfig(chunk_processing_time_s=0.02, num_servers=49)
    want = J.worst_case_latency(JStrategy(strategy), jcfg)
    got = T.worst_case_latency(TStrategy(strategy), tcfg)
    assert _fields(got) == _fields(want)
    assert _fields(tcfg) == _fields(jcfg)


def test_isl_latency_grid_is_bitwise_the_reference():
    got, want = T.isl_latency_grid(), J.isl_latency_grid()
    assert len(got) == 7 * 5
    assert got == want


@pytest.mark.parametrize("m,h", [(15, 550.0), (19, 550.0), (100, 160.0),
                                 (2, 2000.0)])
def test_intra_plane_latency_is_bitwise_the_reference(m, h):
    assert T.intra_plane_latency_s(m, h) == J.intra_plane_latency_s(m, h)


def test_memory_tier_for_latency_matches_the_reference():
    lats = np.logspace(-9, -1, 40)
    got = [T.memory_tier_for_latency(float(x)) for x in lats]
    want = [J.memory_tier_for_latency(float(x)) for x in lats]
    assert got == want
    # the classifier reaches named tiers and the gaps between them
    assert any(t.startswith("between ") for t in got)
    assert len(set(got)) > 5


@pytest.mark.parametrize("latency_s,altitude_km", [
    (2e-3, 550.0), (4e-3, 160.0), (1e-3, 2000.0), (200e-6, 550.0),
    (20e-6, 1000.0), (50e-3, 550.0)])
def test_required_sats_per_plane_matches_the_reference(latency_s,
                                                       altitude_km):
    got = T.required_sats_per_plane_for(latency_s, altitude_km)
    assert got == J.required_sats_per_plane_for(latency_s, altitude_km)
    assert T.intra_plane_latency_s(got, altitude_km) <= latency_s


def test_unreachable_latency_raises_as_the_reference():
    with pytest.raises(ValueError, match="unreachable"):
        J.required_sats_per_plane_for(1e-6, 550.0)
    with pytest.raises(ValueError, match="unreachable"):
        T.required_sats_per_plane_for(1e-6, 550.0)


def test_memory_hierarchy_is_the_reference_table():
    assert list(T.MEMORY_HIERARCHY_S.items()) == list(
        J.MEMORY_HIERARCHY_S.items())


def test_core_exports_the_simulator():
    import repro_torch.core as core

    for name in ("MEMORY_HIERARCHY_S", "SimConfig", "SimResult",
                 "intra_plane_latency_s", "isl_latency_grid", "sweep",
                 "worst_case_latency"):
        assert getattr(core, name) is getattr(T, name)


def _stdout(script: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("reference,port", [
    ("constellation_sim.py", "torch_constellation_sim.py"),
    ("quickstart.py", "torch_quickstart.py")])
def test_host_example_prints_what_the_reference_prints(reference, port):
    want = _stdout(reference)
    assert want.count("\n") > 5
    assert _stdout(port) == want
