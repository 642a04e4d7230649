"""``correct`` comes out false when the timed path is broken underneath.

Each case drives a whole run of a shrunk cell on the CPU through the
harness (its look for a card skipped), with one fault planted in the
port for the run: a token altered where it is produced; a decode step
that leaves its state (the K/V pool) unchanged; half of the batch left
out (every other row).  The same run without a fault is correct.  (The
exchange between chips is a fault no cell can have: every cell runs on
one chip.)"""
import contextlib
import dataclasses

import pytest
import torch

from skybench import harness, spec
from skybench.tests.tiny import tiny_cell


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _altered_token(old):
    def f(self, *a, **kw):
        return (old(self, *a, **kw) + 1) % self.cfg.vocab_size
    return f


def _half_batch(old):
    """Every other row of the step left out: it gets its input token back
    in place of a decoded one (the scheduler fills the lowest slots, so
    leaving out the upper half could miss every active row)."""
    def f(self, block_tables, lengths, tokens, *a, **kw):
        out = old(self, block_tables, lengths, tokens, *a, **kw)
        skip = torch.arange(out.shape[0], device=out.device) % 2 == 1
        return torch.where(skip, tokens.to(out.dtype), out)
    return f


def _state_unchanged(old):
    def f(p, x, cfg, *, k_pool, v_pool, **kw):
        return old(p, x, cfg, k_pool=k_pool.clone(), v_pool=v_pool.clone(),
                   **kw)
    return f


def _faults():
    from repro_torch.models import model
    from repro_torch.serving.executor import PagedExecutor

    return {
        "token_altered": (PagedExecutor, "_decode_sample", _altered_token),
        "half_batch": (PagedExecutor, "_decode_sample", _half_batch),
        "state_unchanged": (model, "attention_decode_paged",
                            _state_unchanged),
    }


def _run(workload, seed=2**31 + 29):
    torch.set_num_threads(2)
    return harness.run_cell(workload, seed, 2.5, False, device="cpu",
                            cell=tiny_cell(workload), log=lambda *a, **k: 0)


CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 5


def test_the_harness_refuses_arrivals_it_does_not_drive():
    cell = tiny_cell(CELLS[0])
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  arrivals="poisson"))
    with pytest.raises(ValueError, match="closed loop"):
        harness.run_cell(cell.name, 1, 1.0, False, device="cpu", cell=cell)


def test_a_number_is_judged_by_its_limit_and_a_missing_one_fails():
    """The rule that decides ``correct`` for the port and for the
    control alike."""
    limits = {"mean_gap": 0.002}
    assert harness._within(harness._judged({"mean_gap": 0.001}, limits))
    assert not harness._within(harness._judged({"mean_gap": 0.0069},
                                                limits))
    assert not harness._within(harness._judged({}, limits))


@pytest.mark.parametrize("fault", ["token_altered", "half_batch",
                                   "state_unchanged"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(fault, workload):
    obj, name, make = _faults()[fault]
    with _patched(obj, name, make):
        out = _run(workload)
    assert not out["correct"], out["compared"]
    # failed by the reference's judgement, not by a request that broke
    assert any(v["value"] > v["limit"] for n, v in out["compared"].items()
               if n.endswith("_gap")), out["compared"]


def test_the_port_is_freed_before_the_reference_runs(monkeypatch):
    """The reference runs once the port's model and engine are gone, so
    that it neither shares the device with them nor keeps two cells'
    worth of state alive across runs of one process."""
    import weakref

    from skybench import check

    refs, alive = [], []
    build, gaps = harness.build, check.served_gaps

    def build_and_watch(*a, **kw):
        model, engine = build(*a, **kw)
        refs.extend([weakref.ref(model), weakref.ref(engine)])
        return model, engine

    def gaps_and_look(*a, **kw):
        alive.append([r() is not None for r in refs])
        return gaps(*a, **kw)

    monkeypatch.setattr(harness, "build", build_and_watch)
    monkeypatch.setattr(check, "served_gaps", gaps_and_look)
    out = _run(CELLS[0])
    assert out["correct"] and alive == [[False, False]], alive

