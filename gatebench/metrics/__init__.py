"""One reader a metric: ``<metric>.py`` defines ``read(run)``, which returns
the value, a (value, note) pair, or None where it finds nothing to read."""

import statistics


def call_wall_percentile_ms(run, percent: int):
    """The ``percent``-th percentile of every call's wall in the window (host
    clock from the call to its synchronize), in milliseconds."""
    walls = [c.wall_s for c in run.calls]
    if len(walls) < 2:
        return None
    return 1e3 * statistics.quantiles(walls, n=100, method="inclusive")[percent - 1]
