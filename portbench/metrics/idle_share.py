"""Idle share of the device over the traced window: 1 - busy / window,
busy the union of the device's kernel and copy intervals."""


def read(trace, metric, cell):
    if trace.busy_s <= 0.0 or trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
