"""dense_attn_roofline: the dense attention kernel (K4, ``csrc/attention.cu``)
against its bound. Work: every encoded frame's attention in every ViT
block at the configuration's token count (q, k, v read once, the output
written once, bf16). Time: the device time of the kernel's launches in
the traced window. The share is of the larger of the operations bound
and the bytes bound (``gatebench.flops.bound_s``)."""

import re

from gatebench import flops

KERNEL = re.compile(r"attention_\w*kernel<[^()]*\btrue>")


def read(run):
    secs = sum(s for name, s in run.trace.kernel_s.items() if KERNEL.search(name))
    v = run.cfg["vpr"]
    if secs <= 0 or v["method"] != "cricavpr":
        return None
    h, w = v["input_size"]
    tokens = (h // 14) * (w // 14) + 1
    ops, nbytes = flops.vit_attention(tokens)
    layers = int(v["depth"]) * sum(c.frames for c in run.calls)
    bound, by = flops.bound_s(ops * layers, nbytes * layers)
    return 100.0 * bound / secs, f"bound by {by}: {bound:.6f} s against {secs:.6f} s of launches"
