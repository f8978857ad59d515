"""match_attn_ms: device milliseconds a call inside the program's ``lightglue.attention``
range (LightGlue's self- and cross-attention, the plain float32-logit route and the
flash kernel K2 alike): the busy time of the device inside the range's device
annotations over the traced window, divided by the calls completed."""

RANGE = "lightglue.attention"


def read(run):
    busy = run.trace.range_s.get(RANGE)
    if busy is None or not run.calls:
        return None
    return 1e3 * busy / len(run.calls)
