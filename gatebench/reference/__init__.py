"""Plain PyTorch float32 references of the gate's networks and stages.

Frozen copies written from the published descriptions and the gate's
stated semantics; nothing here imports the program. ``check.py`` holds
the program's outputs to them.

An encoder is the module ``gatebench/reference/<vpr.method>.py``. It
defines ``encode(params, images_u8, vpr_cfg, prec)`` and
``frame_flops(vpr_cfg)`` (its operations for one frame); for a
configuration whose weights are drawn from a seed,
``seeded_params(vpr_cfg, generator)``; and, where it runs a ViT on the
dense attention kernel, ``attention_shape(vpr_cfg)`` (tokens, width and
blocks of one frame's attention, which ``dense_attn_roofline`` reads).
Each takes the configuration's ``vpr`` section.
"""

from __future__ import annotations

import importlib

ENCODER_FUNCTIONS = ("encode", "frame_flops")


def encoder(method: str):
    """The reference module of encoder ``method``; ValueError where it is
    missing or lacks one of ``ENCODER_FUNCTIONS``."""
    name = f"gatebench.reference.{method}"
    try:
        mod = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no reference module gatebench/reference/{method}.py") from e
    missing = [f for f in ENCODER_FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"gatebench/reference/{method}.py defines no {', '.join(missing)}")
    return mod
