"""pairs_per_s: candidate pairs (the pairs retrieval proposes, before the
floor gate) of every call completed in the window, over the window's
seconds on the host clock. The window runs calls back to back, one
caller waiting on each, and closes when the first call to end past
``--seconds`` has synchronised; its length is measured, not assumed."""


def read(run):
    if run.window_s <= 0 or not run.calls:
        return None
    return sum(c.total for c in run.calls) / run.window_s
