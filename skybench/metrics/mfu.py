"""mfu (%, spans and the configuration): the whole step's share of the
H100's bf16 peak.  The model FLOPs of every token emitted in the window
(its prefill for a first token: the uncached prompt tokens at their
offset; one decode token at its context otherwise), counted from the
configuration (projections, routed experts and router, unembedding, and
attention over the visible causal pairs), over the wall time the
executor's device programs took in the window, times 989 TFLOP/s."""
from skybench import readings

UNIT, LAYER = "%", "executor and model (serving/executor.py, models/model.py)"


def read(run):
    from skybench import modelcfg, peaks

    calls = readings.spans(run)
    busy = sum(b - a for _, a, b in calls)
    if not busy:
        return None
    c = run.config
    flops = 0.0
    for d in run.finished:
        r = d.result
        for j, t in enumerate(d.token_times()):
            if not run.w0 <= t <= run.w1:
                continue
            if j == 0:
                n = r.prompt_tokens - r.cached_tokens
                flops += modelcfg.token_flops(
                    c, n, modelcfg.causal_pairs(r.cached_tokens, n))
            else:
                flops += modelcfg.token_flops(c, 1, r.prompt_tokens + j)
    return 100.0 * flops / (busy * peaks.BF16_FLOPS)
