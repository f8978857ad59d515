"""Checkpoint npz files into nested dicts of float32 tensors.

The shipped checkpoints hold flax parameter trees flattened to
``<group>:<slash/path>`` keys in float16. The reference reads them here,
in their own layout, with no code of the program.
"""

from __future__ import annotations

from typing import Dict

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
