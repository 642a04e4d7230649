"""output_tokens_per_s (tokens/s, host clock): every output token emitted
inside the window, over the window's seconds.  A token's time is its
request's first token (sent + time to first token) plus its gaps."""
UNIT, LAYER = "tokens/s", None


def read(run):
    n = sum(run.w0 <= t <= run.w1 for d in run.finished
            for t in d.token_times())
    return n / (run.w1 - run.w0)
