"""device_idle (%, device trace): the share of the traced part of the
window in which no kernel, copy or set ran on the card (the union of the
trace's device intervals).  Layer: the device (H100)."""
UNIT, LAYER = "%", "device (H100)"


def read(run):
    tr = run.trace
    if tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
