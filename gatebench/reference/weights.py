"""Checkpoint npz files into nested dicts of float32 tensors, and the
encoder files drawn from a seed.

The shipped checkpoints hold flax parameter trees flattened to
``<group>:<slash/path>`` keys in float16. The reference reads them here,
in their own layout, with no code of the program. A configuration whose
``vpr.weights`` is ``{"seed": n}`` gets a file in the same layout, drawn
by its encoder module's ``seeded_params`` and written once (``seeded_npz``);
the program and the reference then both read that file.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Dict, Tuple

import numpy as np
import torch


def load_group(path: str, group: str, device) -> Dict:
    """The ``group`` tree of a checkpoint as nested dicts of float32 tensors
    on ``device`` (a top-level ``params`` collection unwrapped)."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            name, flat = key.split(":", 1)
            if name != group:
                continue
            parts = flat.split("/")
            if parts[0] == "params":
                parts = parts[1:]
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = torch.as_tensor(z[key].astype(np.float32), device=device)
    if not tree:
        raise KeyError(f"{path} holds no '{group}' group")
    return tree


def layer(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a subtree stacked along a leading depth axis."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def draw_normal(spec: Dict[str, Tuple[tuple, float, float]],
                generator: torch.Generator) -> Dict[str, np.ndarray]:
    """``{key: (shape, mean, std)}`` -> ``{key: float16 array}`` of
    mean + std * N(0, 1), drawn in float32 on the CPU, one draw a key in
    sorted key order."""
    out = {}
    for key in sorted(spec):
        shape, mean, std = spec[key]
        x = torch.randn(tuple(shape), generator=generator).mul_(float(std)).add_(float(mean))
        out[key] = x.to(torch.float16).numpy()
    return out


def write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``arrays`` as an npz at ``path``, written to ``<path>.tmp`` and
    renamed, so a killed run leaves no half file at ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def seeded_npz(directory: str, name: str, vpr_cfg: dict, module) -> str:
    """The path of configuration ``name``'s encoder file drawn from
    ``vpr_cfg["weights"]["seed"]`` by ``module.seeded_params``, written
    first where it is missing. The file is
    ``<directory>/<name>-<digest>.npz``, the digest over the ``vpr``
    section and the sources of ``module`` and of this file, so a change to
    any of them writes a new file; writing one deletes the configuration's
    older files."""
    h = hashlib.sha256(json.dumps(vpr_cfg, sort_keys=True).encode())
    for src in (module.__file__, __file__):
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(directory, f"{name}-{h.hexdigest()[:16]}.npz")
    if os.path.exists(path):
        return path
    os.makedirs(directory, exist_ok=True)
    gen = torch.Generator().manual_seed(int(vpr_cfg["weights"]["seed"]))
    write_npz(path, module.seeded_params(vpr_cfg, gen))
    older = re.compile(re.escape(name) + r"-[0-9a-f]{16}\.npz")
    for old in os.listdir(directory):
        if older.fullmatch(old) and os.path.join(directory, old) != path:
            os.remove(os.path.join(directory, old))
    return path
