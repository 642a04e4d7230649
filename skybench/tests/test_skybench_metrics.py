"""The metric arithmetic: a rate is taken over the whole window, so a
stall inside the window moves it; a scheduler count takes only what the
decode steps carried; a reader with nothing to read returns nothing."""
from types import SimpleNamespace

import pytest

from skybench import harness, spec


def _done(submit, ttft, gaps, prompt=1100, cached=0):
    res = SimpleNamespace(ttft_s=ttft, itl_samples_s=list(gaps),
                          prompt_tokens=prompt, cached_tokens=cached,
                          token_ids=[5] * (len(gaps) + 1))
    return harness.Done(req=None, submit=submit, result=res)


def _run(window, w0=0.0, w1=10.0, stats0=None, stats1=None):
    cell = spec.cell(spec.benchmark()["workloads"][0]["name"])
    return harness.Run(cell, 0, w0, w1, 1.0, window, stats0 or {},
                       stats1 or {})


def _read(name, run):
    return spec.reader(name).read(run)


def test_output_rate_is_over_the_whole_window():
    # one request emitting a token every 0.1 s through [0, 10]: 10 tok/s
    full = _done(0.0, 0.0, [0.1] * 100)
    assert _read("output_tokens_per_s", _run([full])) == pytest.approx(
        10.1, abs=0.11)
    # the same stream, stalled for the window's second half
    half = _done(0.0, 0.0, [0.1] * 50 + [5.0] + [0.1] * 49)
    assert _read("output_tokens_per_s", _run([half])) == pytest.approx(
        5.1, abs=0.11)
    # tokens before the window opened or after it closed do not count
    early = _done(-5.0, 0.0, [0.1] * 40)
    assert _read("output_tokens_per_s", _run([early])) == 0.0


def test_decode_rows_leave_out_the_first_tokens_of_prefills():
    # 100 steps of 128 rows, and 40 first tokens sampled after prefills
    s0 = {"decoded_tokens": 1000, "first_tokens": 10, "decode_steps": 50}
    s1 = {"decoded_tokens": 1000 + 12800 + 40, "first_tokens": 50,
          "decode_steps": 150}
    run = _run([], stats0=s0, stats1=s1)
    assert _read("decode_rows_mean.batch", run) == pytest.approx(128.0)
    assert _read("decode_rows_mean.batch",
                 _run([], stats0=s0, stats1=s0)) is None


def test_an_untraced_run_reads_nothing_from_a_trace():
    # an untraced run has no spans, launches or trace: those readers
    # return nothing (never 0 for a share of a roofline or a peak)
    window = [_done(0.0, 0.1, [0.05]), _done(1.0, 0.1, [0.05])]
    for name in ("k1_roofline.batch", "k3_roofline.batch",
                 "k4_roofline.batch", "mfu.batch", "device_idle.batch",
                 "step_ms.batch"):
        assert _read(name, _run(window)) is None


def test_roofline_share_is_bound_over_the_traced_kernel_time():
    import torch

    from skybench import peaks
    from skybench.trace import Launch, Recorder, Trace

    meta = dict(q=(4, 32, 160), kv=(64, 128, 8, 160), dv=160, itemsize=2,
                lengths=torch.tensor([1000, 1100, 1200, 900]))
    n_bytes = ((4200 * 8 + 4 * 32) * 320) * 2
    rec = Recorder(launches=[Launch("k1", meta, 0.0)] * 10)
    bound = 10 * n_bytes / peaks.HBM_BYTES
    run = _run([])
    run.rec = rec
    run.trace = Trace(10.0, 1.0, {}, {}, {"k1": 4 * bound})
    assert _read("k1_roofline.batch", run) == pytest.approx(25.0)
    # a family with no kernel in the trace reads nothing
    assert _read("k3_roofline.batch", run) is None
