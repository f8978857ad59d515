"""call_p95_ms.floors2: the 95th percentile of the traced run's call walls.
In the two-floor cells a call takes 0.7-1.1 s, so a window holds too few
calls for the tail to stand as an end-to-end metric."""

from gatebench.metrics import call_wall_percentile_ms


def read(run):
    return call_wall_percentile_ms(run, 95)
