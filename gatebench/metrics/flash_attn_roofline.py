"""flash_attn_roofline: the flash attention kernel (K2, ``csrc/attention.cu``)
against its bound. Work: LightGlue's self- and cross-attention of every
verified pair in every layer, each row over its valid keys (q, k, v read
once, the output written once, bf16). Time: the device time of the
kernel's launches in the traced window. The share is of the larger of
the operations bound and the bytes bound (``gatebench.flops.bound_s``)."""

import re

from gatebench import flops

KERNEL = re.compile(r"attention_\w*kernel<[^()]*\bfalse>")


def read(run):
    secs = sum(s for name, s in run.trace.kernel_s.items() if KERNEL.search(name))
    if secs <= 0:
        return None
    depth = int(run.cfg["matcher"]["depth"])
    ops = nbytes = 0.0
    for c in run.calls:
        for a, b in c.pair_keypoints:
            o, n = flops.lightglue_attention(a, b)
            ops += depth * o
            nbytes += depth * n
    bound, by = flops.bound_s(ops, nbytes)
    return 100.0 * bound / secs, f"bound by {by}: {bound:.6f} s against {secs:.6f} s of launches"
