"""ransac_ms: device milliseconds a call inside the program's ``epipolar.ransac`` range
(essential RANSAC and pose): the busy time of the device inside the range's device
annotations over the traced window, divided by the calls completed."""

RANGE = "epipolar.ransac"


def read(run):
    busy = run.trace.range_s.get(RANGE)
    if busy is None or not run.calls:
        return None
    return 1e3 * busy / len(run.calls)
