"""setup_s (s, host clock): from the start of the process to the opening
of the window -- kernel build or load, weights, engine, and the closed
loop's ramp (every slot filled once)."""
UNIT, LAYER = "s", None


def read(run):
    return run.setup_s
