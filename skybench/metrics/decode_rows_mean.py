"""decode_rows_mean (rows, program counters): rows a decode step carried
over the window, the tokens the decode steps sampled over the steps
(serving/scheduler.py).  ``EngineStats.decoded_tokens`` also counts the
first token sampled after each prefill, which no decode step carried:
those (one a first token, ``EngineStats.ttft_s``) are taken out.
Layer: the scheduler."""
UNIT, LAYER = "rows", "scheduler (serving/scheduler.py)"


def read(run):
    def delta(name):
        return run.stats1[name] - run.stats0[name]

    steps = delta("decode_steps")
    if not steps:
        return None
    return (delta("decoded_tokens") - delta("first_tokens")) / steps
