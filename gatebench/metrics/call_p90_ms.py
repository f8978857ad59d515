"""call_p90_ms: the 90th percentile of every call's wall in the window; the
tail of a cell whose window holds too few calls for a 95th percentile with
ten calls beyond it."""

from gatebench.metrics import call_wall_percentile_ms


def read(run):
    return call_wall_percentile_ms(run, 90)
