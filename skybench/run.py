"""One run of one cell of the port's benchmark.

    python skybench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

prints, as the last line of standard output, one JSON object: whether
what the timed path served was correct, the requests attempted and
failed, the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``, with ``breakdown``), and the device; the numbers
the check compared, each beside its limit, come last there and as the
last lines of standard error.  It exits non-zero, printing no result,
without the CUDA devices the cell asks for, without the port's sources
beside it, or when JAX or the JAX package got loaded.

``--control`` also reads the fp8 control and judges it by the cell's
limits (``--seed`` may then list several seeds, run one after another
in this process).
"""
import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from skybench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
