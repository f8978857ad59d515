"""dense_attn_roofline: the dense attention kernel (K4, ``csrc/attention.cu``)
against its bound. Work: every encoded frame's attention in every block
that its encoder runs, at the token count and width that the encoder's
reference module gives (``attention_shape``; q, k, v read once, the
output written once, bf16). Time: the device time of the kernel's
launches in the traced window. The share is of the larger of the
operations bound and the bytes bound (``gatebench.flops.bound_s``). An
encoder whose module has no ``attention_shape`` runs no ViT, and the
metric is not read."""

import re

from gatebench import flops, reference

KERNEL = re.compile(r"attention_\w*kernel<[^()]*\btrue>")


def read(run):
    secs = sum(s for name, s in run.trace.kernel_s.items() if KERNEL.search(name))
    v = run.cfg["vpr"]
    shape = getattr(reference.encoder(v["method"]), "attention_shape", None)
    if secs <= 0 or shape is None:
        return None
    tokens, dim, blocks = shape(v)
    ops, nbytes = flops.vit_attention(tokens, dim)
    layers = blocks * sum(c.frames for c in run.calls)
    bound, by = flops.bound_s(ops * layers, nbytes * layers)
    return 100.0 * bound / secs, f"bound by {by}: {bound:.6f} s against {secs:.6f} s of launches"
