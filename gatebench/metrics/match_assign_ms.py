"""match_assign_ms: device milliseconds a call inside the program's ``lightglue.assign``
range (LightGlue's head from the final projection to the scores: the similarity
product, the dual softmax and the matchability products): the busy time of the
device inside the range's device annotations over the traced window, divided by the
calls completed."""

RANGE = "lightglue.assign"


def read(run):
    busy = run.trace.range_s.get(RANGE)
    if busy is None or not run.calls:
        return None
    return 1e3 * busy / len(run.calls)
