"""gate_mfu: the models' operations of every call in the traced window
(``gatebench.flops``: detector and encoder per frame, LightGlue per
verified pair at its frames' valid keypoints) over the window's seconds
at the H100's dense bf16 peak (989 TFLOP/s)."""

from gatebench import flops


def read(run):
    if run.trace.window_s <= 0 or not run.calls:
        return None
    per_frame = flops.frame_flops(run.cfg)
    ops = sum(c.frames * per_frame + flops.pairs_flops(c.pair_keypoints, run.cfg) for c in run.calls)
    return 100.0 * ops / (run.trace.window_s * flops.PEAK_BF16_FLOPS)
