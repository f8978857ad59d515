"""Read the shipped flax-layout ``checkpoints/*.npz`` into PyTorch state dicts.

The checkpoints hold nested parameter trees flattened to '/'-joined keys
under a ``<name>:`` prefix (for example ``matcher:in_proj/kernel``), stored
as float16 and restored as float32. :func:`from_jax_params` maps a flax
tree onto the port's module names:

* Dense kernels ``(in, out)`` become Linear weights ``(out, in)``;
* Conv kernels HWIO become OIHW;
* LayerNorm ``scale`` becomes ``weight``; frozen batch-norm ``mean`` and
  ``var`` become ``running_mean`` and ``running_var``;
* a subtree stacked along a leading depth axis by ``nn.scan`` (LightGlue's
  ``blocks``) is split into one entry per layer: ``blocks.0...``,
  ``blocks.1...``;
* every other leaf keeps its name and layout. For the ViT that covers
  ``block{i}/attn/qkv`` (a Dense, so (in, 3 dim) -> (3 dim, in)),
  ``patch_embed`` (a Conv, HWIO -> OIHW), ``pos_embed``, ``cls_token``,
  ``register_tokens`` and the LayerScale ``ls1``/``ls2`` ``gamma``; its
  blocks are named ``block0`` ... rather than scanned, so no split applies;
* the SALAD head (``head/{feat,score,token}_{hidden,proj}``) is Dense
  layers, transposed as above, and its scalar ``dustbin`` keeps its name;
* AnyLoc's ``vlad/centers`` group is the (K, D) vocabulary, kept as is.

:func:`carry_jax_vpr` puts a flax-initialised encoder's parameters (numpy
leaves) into the port's encoder of the same architecture, :func:`carry_jax_vit`
a bare ViT's (the fine-tuning trainer's encoder),
:func:`carry_jax_matcher` a matcher's (LightGlue, SuperGlue, LoFTR in
either architecture) and :func:`carry_jax_yolo` a YOLOv8's. LoFTR's
``loftr:`` tree names its layers as the port's modules do (``backbone/c1a``,
``self0_0/q``, ``cross3_1/ffn2``...; in the official architecture
``coarse/coarse_self0/q_proj``, ``fine/down_proj``...), so it maps with the
rules above and no scan split; :func:`to_jax_params` and
:func:`save_params_npz` write a state dict back in that layout, restacking
a scanned subtree. ``to_jax_params(module.state_dict())`` is also the
template that ``models/convert.py``'s converters fill from an official
torch checkpoint.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if hasattr(tree, "items"):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_params_npz(path: str) -> Dict[str, Any]:
    """Load a checkpoint npz -> {name: param tree}, floats as float32."""
    with np.load(path) as z:
        groups: Dict[str, Dict[str, np.ndarray]] = {}
        for key in z.files:
            name, flat_key = key.split(":", 1)
            v = z[key]
            if np.issubdtype(v.dtype, np.floating):
                v = v.astype(np.float32)
            groups.setdefault(name, {})[flat_key] = v
    return {name: unflatten_params(flat) for name, flat in groups.items()}


def shipped_checkpoint(*names: str) -> Optional[str]:
    """First existing ``checkpoints/<name>`` at the repository root, or None."""
    for name in names:
        p = os.path.join(REPO_ROOT, "checkpoints", name)
        if os.path.exists(p):
            return p
    return None


def default_matcher_checkpoint() -> Optional[str]:
    """The shipped LightGlue checkpoint trained on the trained SuperPoint
    (``lightglue_homog_sp.npz``), else the random-filter one."""
    return shipped_checkpoint("lightglue_homog_sp.npz", "lightglue_homog.npz")


def default_fullres_matcher_checkpoint() -> Optional[str]:
    """The LightGlue checkpoint trained at 540x720 with 1024 keypoints
    (``lightglue_homog_sp_fullres.npz``) for the fullres protocol, else the
    half-res default."""
    return shipped_checkpoint("lightglue_homog_sp_fullres.npz") or default_matcher_checkpoint()


def default_parallax_matcher_checkpoint() -> Optional[str]:
    """The LightGlue checkpoint trained on layered parallax pairs
    (``lightglue_parallax_sp.npz``, the v2 quality scene's two-view
    distribution), else the homography-trained default."""
    return shipped_checkpoint("lightglue_parallax_sp.npz") or default_matcher_checkpoint()


def default_loftr_checkpoint() -> Optional[str]:
    """The shipped homography-trained LoFTR: ``loftr_homog_v3.npz`` (trained
    at 272x360), else ``loftr_homog_v2.npz`` (256x320), else
    ``loftr_homog.npz`` (128x160)."""
    return shipped_checkpoint("loftr_homog_v3.npz", "loftr_homog_v2.npz", "loftr_homog.npz")


def default_superglue_checkpoint() -> Optional[str]:
    """The shipped homography-trained SuperGlue (``superglue_homog.npz``)."""
    return shipped_checkpoint("superglue_homog.npz")


def default_parallax_superglue_checkpoint() -> Optional[str]:
    """The SuperGlue trained on layered parallax pairs
    (``superglue_parallax.npz``), else the homography-trained one."""
    return shipped_checkpoint("superglue_parallax.npz") or default_superglue_checkpoint()


def default_parallax_loftr_checkpoint() -> Optional[str]:
    """The LoFTR trained on layered parallax pairs (``loftr_parallax.npz``),
    else the homography-trained default."""
    return shipped_checkpoint("loftr_parallax.npz") or default_loftr_checkpoint()


def default_mixvpr_checkpoint() -> Optional[str]:
    return shipped_checkpoint("vpr_mixvpr.npz")


def default_crica_checkpoint() -> Optional[str]:
    """The in-env-trained CricaVPR ViT-B/14 (``vpr_crica.npz``)."""
    return shipped_checkpoint("vpr_crica.npz")


def carry_jax_vpr(vpr, params: Any, centers: Optional[np.ndarray] = None):
    """Load a flax parameter tree (SALAD, AnyLoc, CricaVPR or MixVPR, numpy
    leaves) into the port's encoder ``vpr``; ``centers`` is AnyLoc's
    vocabulary. Returns ``vpr``."""
    state = from_jax_params(params)
    if centers is None:
        vpr.load_state(state)
    else:
        vpr.load_state(state, centers=centers)
    return vpr


def carry_jax_matcher(matcher, params: Any, superpoint: Any = None):
    """Load a flax parameter tree (numpy leaves) into a port matcher of the
    same architecture: LightGlue's or SuperGlue's ``matcher`` tree (the
    scanned ``blocks`` split per layer, SuperGlue's ``dustbin`` kept) with,
    when given, the ``superpoint`` tree, or LoFTR's ``loftr`` tree, of the
    in-env or the official architecture. Returns ``matcher``."""
    if hasattr(matcher, "sp"):
        if superpoint is not None:
            matcher.sp.load_state(from_jax_params(superpoint))
        matcher.net.load_state_dict(from_jax_params(params), strict=True)
    else:
        matcher.net.load_state_dict(from_jax_params(params, scan_prefixes=()), strict=True)
    matcher.net.to(matcher.device)
    return matcher


def carry_jax_vit(vit, params: Any):
    """Load the JAX package's ViT parameter tree (a flax ``ViT``'s
    ``{"params": ...}``, numpy leaves) into the port's ``ViT`` of the same
    configuration, or into a module that holds it as ``.vit`` (the
    trainer's :class:`~mlis_tpu_torch.train.trainer.GeMEncoder`). Returns
    the module it was given."""
    target = getattr(vit, "vit", vit)
    state = from_jax_params(params, scan_prefixes=())
    target.load_state_dict({k: v.to(next(target.parameters()).device) for k, v in state.items()},
                           strict=True)
    return vit


def carry_jax_yolo(detector, params: Any):
    """Load the JAX package's YOLOv8 parameter tree (numpy leaves) into a
    port ``YOLODetector`` of the same configuration. Returns ``detector``."""
    detector.net.load_state_dict(from_jax_params(params, scan_prefixes=()), strict=True)
    detector.net.to(detector.device)
    return detector


def to_jax_params(state: Dict[str, torch.Tensor],
                  scan_prefixes: Iterable[str] = ()) -> Dict[str, Any]:
    """A torch state dict -> flax tree (numpy leaves): the inverse of
    :func:`from_jax_params` for Dense, Conv, LayerNorm and batch-norm
    leaves. Subtrees named in ``scan_prefixes`` (LightGlue's ``blocks``)
    are restacked along a leading depth axis, ``blocks.{i}.x`` -> layer
    ``i`` of ``blocks/x``."""
    inv = {v: k for k, v in _RENAME.items()}
    scan = tuple(scan_prefixes)
    flat: Dict[str, np.ndarray] = {}
    layers: Dict[str, Dict[int, np.ndarray]] = {}
    for key, t in state.items():
        parts = key.split(".")
        v = t.detach().cpu().numpy()
        leaf = parts[-1]
        if leaf == "weight" and v.ndim == 2:
            leaf, v = "kernel", v.T
        elif leaf == "weight" and v.ndim == 4:
            leaf, v = "kernel", v.transpose(2, 3, 1, 0)
        else:
            leaf = inv.get(leaf, leaf)
        if parts[0] in scan:
            name = "/".join([parts[0], *parts[2:-1], leaf])
            layers.setdefault(name, {})[int(parts[1])] = v
        else:
            flat["/".join([*parts[:-1], leaf])] = np.ascontiguousarray(v)
    for name, by_layer in layers.items():
        flat[name] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return unflatten_params(flat)


def save_params_npz(path: str, dtype=np.float16, **trees: Any) -> None:
    """Named flax trees into one npz under ``<name>:<slash/path>`` keys,
    floats stored as ``dtype`` (the checkpoints' own format)."""
    flat: Dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        for k, v in flatten_params(tree).items():
            if np.issubdtype(v.dtype, np.floating):
                v = v.astype(dtype)
            flat[f"{name}:{k}"] = v
    np.savez_compressed(path, **flat)


def matcher_arch_from_npz(path: str) -> Dict[str, int]:
    """Matcher structure (depth, dim, descriptor_dim, num_heads) read from
    the checkpoint's own shapes."""
    with np.load(path) as z:
        in_proj = z["matcher:in_proj/kernel"]
        depth = int(z["matcher:blocks/self/q/kernel"].shape[0])
        head_dim = 2 * int(z["matcher:posenc/Wr"].shape[1])
    descriptor_dim, dim = int(in_proj.shape[0]), int(in_proj.shape[1])
    return {
        "descriptor_dim": descriptor_dim,
        "dim": dim,
        "depth": depth,
        "num_heads": dim // head_dim,
    }


def _convert_leaf(name: str, v: np.ndarray) -> tuple:
    if name == "kernel":
        if v.ndim == 2:  # Dense (in, out) -> Linear (out, in)
            return "weight", np.ascontiguousarray(v.T)
        if v.ndim == 4:  # Conv HWIO -> OIHW
            return "weight", np.ascontiguousarray(v.transpose(3, 2, 0, 1))
        raise ValueError(f"kernel of rank {v.ndim} has no torch layout")
    return _RENAME.get(name, name), v


def from_jax_params(
    tree: Any, scan_prefixes: Iterable[str] = ("blocks",)
) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves) -> flat torch state dict.

    A top-level ``params`` collection is unwrapped. Subtrees named in
    ``scan_prefixes`` carry a leading depth axis and are split per layer."""
    if hasattr(tree, "keys") and set(tree.keys()) == {"params"}:
        tree = tree["params"]
    scan = tuple(scan_prefixes)
    out: Dict[str, torch.Tensor] = {}
    for key, v in flatten_params(tree).items():
        parts = key.split("/")
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            v = v.astype(np.float32)
        if parts[0] in scan:
            for layer in range(v.shape[0]):
                leaf, arr = _convert_leaf(parts[-1], v[layer])
                name = ".".join([parts[0], str(layer), *parts[1:-1], leaf])
                out[name] = torch.from_numpy(np.ascontiguousarray(arr))
        else:
            leaf, arr = _convert_leaf(parts[-1], v)
            out[".".join([*parts[:-1], leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_npz(path: str, scan_prefixes: Iterable[str] = ("blocks",)) -> Dict[str, Dict[str, torch.Tensor]]:
    """Checkpoint npz -> {name: torch state dict} (float32)."""
    return {
        name: from_jax_params(tree, scan_prefixes)
        for name, tree in load_params_npz(path).items()
    }
