"""The control on the card: the reference with its projections in fp8
(the precision below the configurations' bf16), put in the port's place,
is not correct where the port is.  Each cell runs at its own size (its
full model, its deployment and its limits) in a short window, on three
seeds: the port comes out correct, and the control, judged by the
harness with the same limits, does not.  (``python skybench/run.py
--workload <cell> --control --seed a,b,c --seconds 15`` reads the same
in one process; PERF.md gives the readings.)"""
import pytest

from skybench import harness, spec


@pytest.mark.chip
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_control_fails_where_the_port_passes(card, workload):
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        out = harness.run_cell(workload, seed, 6.0, False, device=card,
                               control=True)
        assert out["correct"], out["compared"]
        assert out["control"]["correct"] is False, out["control"]
