"""device_idle_share: the share of the traced window in which no kernel,
copy or set ran on the device: 1 - (union of their intervals) / window."""


def read(run):
    t = run.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
