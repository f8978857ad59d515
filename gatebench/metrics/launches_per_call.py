"""launches_per_call: device kernels a call, counted from the traced window
(copies and sets not counted)."""


def read(run):
    if not run.calls or not run.trace.kernels:
        return None
    return run.trace.kernels / len(run.calls)
