"""One run of one cell: set up the port, open the window, drive the
engine through its streaming front door, close the window, judge what it
served against the plain reference, print one result line.

Set-up (``setup_s``, from the start of the process to the opening of the
window): the CUDA kernels are built or loaded, the seed's weights are
drawn on the card into the port's ``Model``, the ``Engine`` is made, and
the closed loop ramps up: ``clients`` callers each send their next
request when the reply comes, and the window opens once every slot has
had a first token, so every path the window takes has run.  The output
tokens emitted in the window are counted.

After the window the queue is shed, every request on the machine is
waited for (ninety seconds past the close at most), the engine is
stopped, the peak memory is read, the port's state is freed and the
reference judges a sample.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass

from skybench import check, modelcfg, spec, weights
from skybench.trace import Recorder, read_trace
from skybench.traffic import Mix

GRACE_S = 90.0           # how long past the close a request is waited for
TRACE_S = 10.0           # the profiler's part of a traced window, at most
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Done:
    """One request of a window: when it was sent, and its result."""

    req: object
    submit: float
    fut: object = None
    result: object = None
    error: str | None = None

    @property
    def first_token_t(self) -> float:
        return self.submit + self.result.ttft_s

    def token_times(self) -> list[float]:
        t = self.first_token_t
        out = [t]
        for g in self.result.itl_samples_s:
            t += g
            out.append(t)
        return out


@dataclass
class Run:
    """What a metric's reader reads."""

    cell: spec.Cell
    seed: int
    w0: float
    w1: float
    setup_s: float
    window: list                 # Done of the requests the window judges
    stats0: dict
    stats1: dict
    rec: Recorder | None = None
    trace: object = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def finished(self) -> list:
        return [d for d in self.window if d.result is not None]


def _stats(engine) -> dict:
    """The scheduler's counters: tokens sampled (by decode steps and as
    first tokens after a prefill), first tokens, and decode steps."""
    st = engine.stats
    return {"decoded_tokens": st.decoded_tokens,
            "first_tokens": st.ttft_s.n_seen,
            "decode_steps": st.decode_steps}


def _request(r):
    from repro_torch.serving import Request, SamplingParams

    return Request(prompt=r.text, sampling=SamplingParams(
        temperature=0.0, max_new_tokens=r.max_new_tokens))


def build(cell: spec.Cell, seed: int, device: str):
    """The port's model with the seed's weights, and its engine."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine

    c = cell.config
    if device == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
        for name in ("paged_attention", "chunked_prefill"):
            _build.load(name)     # on this thread, before any engine thread
    d = cell.deploy
    model = Model(modelcfg.port_config(c), device=device)
    weights.load(model, c, seed)
    engine = Engine(model, block_size=d["block_size"],
                    max_seq_len=d["max_seq_len"], max_batch=d["slots"],
                    chunk_tokens=d["chunk_tokens"], device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return model, engine


def _sleep_until(t: float) -> None:
    dt = t - time.perf_counter()
    if dt > 0:
        time.sleep(dt)


def closed_window(engine, mix: Mix, clients: int, slots: int,
                  seconds: float, rec: Recorder | None):
    """``clients`` callers, each sending its next request from the mix when
    its reply comes.  The window opens once ``slots`` requests have had
    their first token."""
    import threading

    from repro_torch.serving import EngineStats

    pool = iter(mix.requests(max(4096, 64 * clients), "window"))
    lock = threading.Lock()
    sent: list[Done] = []
    closing = [False]

    def send():
        with lock:
            if closing[0]:
                return
            r = next(pool)
            d = Done(r, time.perf_counter())
            d.fut = engine.submit(_request(r))
            sent.append(d)
        d.fut.add_done_callback(lambda _f: send())

    engine.stats = EngineStats()
    engine.start()
    for _ in range(clients):
        send()
    deadline = time.perf_counter() + 600.0
    while engine.stats.ttft_s.n_seen < slots:
        if time.perf_counter() > deadline:
            raise RuntimeError("the closed loop never filled every slot")
        time.sleep(0.01)
    w0 = time.perf_counter()
    stats0 = _stats(engine)
    if rec is not None:
        _sleep_until(w0 + 0.25 * seconds)
        rec.start_trace()
        _sleep_until(w0 + min(0.25 * seconds + TRACE_S, 0.9 * seconds))
        rec.stop_trace()
    w1 = w0 + seconds
    _sleep_until(w1)
    stats1 = _stats(engine)
    with lock:
        closing[0] = True
    engine.stop(drain=False)
    _collect(sent, time.perf_counter() + GRACE_S)
    window = [d for d in sent if d.error != "cancelled"]
    return w0, w1, window, stats0, stats1


def _collect(done: list, deadline: float) -> None:
    """Each request's result or error.  The future is dropped: its
    callback holds the loop's sender and so the engine, which has to be
    freed before the reference runs."""
    for d in done:
        try:
            d.result = d.fut.result(timeout=max(0.0,
                                                deadline - time.perf_counter()))
        except CancelledError:
            d.error = "cancelled"
        except FutureTimeout:
            d.error = "never came"
        except Exception as e:            # the request failed in the port
            d.error = repr(e)
        d.fut = None


def forbidden_modules() -> list[str]:
    """Top-level module names of the JAX stack or the JAX package that this
    process has loaded (compared whole: ``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: float | None = None,
             cell: spec.Cell | None = None, control: bool = False,
             log=print) -> dict:
    """One run of ``workload``; returns the result line's object (and, with
    ``control``, the control's reading, judged by the same limits, under
    ``"control"``)."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    cell = cell or spec.cell(workload)
    c, traffic, d = cell.config, cell.traffic, cell.deploy
    if traffic["arrivals"] != "closed":
        raise ValueError(f"{traffic['arrivals']!r} arrivals: the harness "
                         "drives a closed loop only")
    mix = Mix(traffic, seed)
    phase = _Phases(t_process, log)
    model, engine = build(cell, seed, device)
    phase("build")
    rec = Recorder() if trace else None
    if rec is not None:
        rec.instrument(engine)
        rec.arm_trace()
    w0, w1, window, s0, s1 = closed_window(
        engine, mix, d["clients"], d["slots"], seconds, rec)
    phase("window and drain")
    run = Run(cell, seed, w0, w1, w0 - t_process, window, s0, s1, rec)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if rec is not None:
        run.trace = read_trace(rec)
        rec.restore()
        rec.prof = None
    phase("trace read")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = sum(dd.error is not None for dd in window)
    picked = check.sample([dd for dd in window if dd.error is None], seed)
    del model, engine
    if rec is not None:
        rec.launches.clear()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    got = check.served_gaps(c, seed, picked, device) if picked else None
    numbers = got["numbers"] if got else {}
    compared = _judged(numbers, d["limits"])
    compared["requests_failed"] = {"value": failed, "limit": 0}
    compared["prompts_off"] = {"value": got["prompts_off"] if got else 1,
                               "limit": 0}
    out = {"correct": _within(compared), "attempted": len(window),
           "failed": failed, "metrics": metrics,
           "device": _device(device, cell.chips, peak, run.trace)}
    if run.trace is not None:
        out["breakdown"] = _breakdown(run.trace)
    phase("reference")
    log(f"[check] {len(picked)} requests, "
        f"{got['served_tokens'] if got else 0} served tokens, reference "
        f"{time.perf_counter() - t_ref:.1f} s, gaps {numbers}",
        file=sys.stderr)
    if control and got:
        low = check.control_gaps(c, seed, got, device)
        judged = _judged(low, d["limits"])
        out["control"] = {"numbers": low, "compared": judged,
                          "correct": _within(judged)}
        log(f"[check] control gaps {low}, correct {_within(judged)}",
            file=sys.stderr)
    out["compared"] = compared
    return out


def _judged(numbers: dict, limits: dict) -> dict:
    """Each number a cell's limits name, beside its limit (a number that
    was not read counts as over it)."""
    return {name: {"value": numbers.get(name, float("inf")), "limit": limit}
            for name, limit in limits.items()}


def _within(compared: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in compared.values())


class _Phases:
    """Logs, on standard error, the seconds each phase of a run took."""

    def __init__(self, t0: float, log):
        self.t, self.log = t0, log

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.log(f"[phase] {name} {now - self.t:.1f} s", file=sys.stderr)
        self.t = now


def _device(device: str, chips: int, peak: int, tr) -> dict:
    import torch

    if device == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": chips, "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if tr is not None:
        out["busy_s"] = tr.busy_s
        out["window_s"] = tr.window_s
    return out


def _breakdown(tr) -> dict:
    top = sorted(tr.ops.items(), key=lambda kv: kv[1], reverse=True)[:10]
    gaps = sorted(tr.gaps.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


def main(argv: list[str], t_process: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the fp8 control; --seed may list seeds")
    a = ap.parse_args(argv)
    import torch

    chips = spec.cell(a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"need {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    seeds = [int(s) for s in a.seed.split(",")]
    if len(seeds) > 1 and not a.control:
        ap.error("several seeds are for --control")
    for seed in seeds:
        out = run_cell(a.workload, seed, a.seconds, bool(a.trace),
                       t_process=t_process, control=a.control)
        t_process = None
        bad = forbidden_modules()
        if bad:
            print(f"the process loaded {bad}: the benchmark and the port "
                  "must not load JAX or the JAX package", file=sys.stderr)
            return 4
        for name, v in out.get("control", {}).get("compared", {}).items():
            print(f"control {name} {v['value']!r} limit {v['limit']!r}",
                  file=sys.stderr)
        for name, v in out["compared"].items():
            print(f"compared {name} {v['value']!r} limit {v['limit']!r}",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(out), flush=True)
    return 0
