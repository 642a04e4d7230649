"""step_ms (ms, the benchmark's spans): mean wall time of one call of the
executor's device programs in the window (``PagedExecutor.step``,
``chunk_wave``, ``prefill_dense``, ``prefill_exact``,
``prefill_chunk_eager``).  Layer: executor and model
(serving/executor.py, models/model.py)."""
from skybench import readings

UNIT, LAYER = "ms", "executor and model (serving/executor.py, models/model.py)"


def read(run):
    calls = readings.spans(run)
    if not calls:
        return None
    return 1e3 * sum(b - a for _, a, b in calls) / len(calls)
