"""detect_nms_topk_ms: device milliseconds a call inside the program's
``superpoint.nms_topk`` range (SuperPoint's non-maximum suppression and its top-K of
the scores): the busy time of the device inside the range's device annotations over
the traced window, divided by the calls completed."""

RANGE = "superpoint.nms_topk"


def read(run):
    busy = run.trace.range_s.get(RANGE)
    if busy is None or not run.calls:
        return None
    return 1e3 * busy / len(run.calls)
