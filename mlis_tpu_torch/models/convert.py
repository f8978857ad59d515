"""Official torch checkpoints -> flax-layout parameter trees (numpy).

The port's own copy of ``mlis_tpu/models/convert.py``: the same converters
give the same trees, bit for bit. They take an official state dict (torch
tensors or numpy arrays, as ``torch.load(..., map_location="cpu")`` or
``np.load`` give them) and a template tree, and return the flax-layout tree
with the template's shapes and dtypes. The port's loaders build the
template from a module with :func:`mlis_tpu_torch.weights.to_jax_params`
and load the result through :func:`mlis_tpu_torch.weights.from_jax_params`,
so every ``load_torch_state_dict`` is one path and the trees it sees are
those the JAX package sees (torchvision ResNet-50, facebookresearch
DINOv2, magicleap SuperPoint, cvg/LightGlue, zju3dv/kornia LoFTR).

Layout conventions converted:
  torch Conv2d weight (O, I, kh, kw)  -> flax (kh, kw, I, O)
  torch Linear weight (O, I)          -> flax kernel (I, O)
  BatchNorm running_mean/var          -> FrozenBatchNorm mean/var params
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _conv(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)


def _linear(w) -> np.ndarray:
    return _np(w).T


def _bn(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {
        "scale": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
        "mean": _np(sd[f"{prefix}.running_mean"]),
        "var": _np(sd[f"{prefix}.running_var"]),
    }


def convert_resnet_torch(
    state_dict: Mapping[str, Any], template: Dict[str, Any]
) -> Dict[str, Any]:
    """torchvision-style ResNet state_dict -> models/resnet.ResNet params.

    Handles arbitrary stage crops: converts exactly the layers present in
    `template` (the flax-layout tree of the module to load).
    """
    sd = state_dict
    out: Dict[str, Any] = {}
    out["stem_conv"] = {"kernel": _conv(sd["conv1.weight"])}
    out["stem_bn"] = _bn(sd, "bn1")

    for name, sub in template.items():
        if not name.startswith("layer"):
            continue
        stage_block = name[len("layer") :]  # e.g. "1_0"
        stage, block = stage_block.split("_")
        tp = f"layer{stage}.{block}"
        entry = {
            "conv1": {"kernel": _conv(sd[f"{tp}.conv1.weight"])},
            "bn1": _bn(sd, f"{tp}.bn1"),
            "conv2": {"kernel": _conv(sd[f"{tp}.conv2.weight"])},
            "bn2": _bn(sd, f"{tp}.bn2"),
            "conv3": {"kernel": _conv(sd[f"{tp}.conv3.weight"])},
            "bn3": _bn(sd, f"{tp}.bn3"),
        }
        if f"{tp}.downsample.0.weight" in sd:
            entry["downsample_conv"] = {
                "kernel": _conv(sd[f"{tp}.downsample.0.weight"])
            }
            entry["downsample_bn"] = _bn(sd, f"{tp}.downsample.1")
        out[name] = entry

    return _match_dtypes(out, template)


def convert_dinov2_torch(
    state_dict: Mapping[str, Any], template: Dict[str, Any]
) -> Dict[str, Any]:
    """facebookresearch/dinov2 ViT state_dict -> models/vit.ViT params."""
    sd = state_dict
    out: Dict[str, Any] = {}
    out["patch_embed"] = {
        "kernel": _conv(sd["patch_embed.proj.weight"]),
        "bias": _np(sd["patch_embed.proj.bias"]),
    }
    out["cls_token"] = _np(sd["cls_token"])
    out["pos_embed"] = _np(sd["pos_embed"])
    if "register_tokens" in sd and "register_tokens" in template:
        out["register_tokens"] = _np(sd["register_tokens"])

    depth = sum(1 for k in template if k.startswith("block"))
    for i in range(depth):
        tp = f"blocks.{i}"
        out[f"block{i}"] = {
            "norm1": {
                "scale": _np(sd[f"{tp}.norm1.weight"]),
                "bias": _np(sd[f"{tp}.norm1.bias"]),
            },
            "attn": {
                "qkv": {
                    "kernel": _linear(sd[f"{tp}.attn.qkv.weight"]),
                    "bias": _np(sd[f"{tp}.attn.qkv.bias"]),
                },
                "proj": {
                    "kernel": _linear(sd[f"{tp}.attn.proj.weight"]),
                    "bias": _np(sd[f"{tp}.attn.proj.bias"]),
                },
            },
            "ls1": {"gamma": _np(sd[f"{tp}.ls1.gamma"])},
            "norm2": {
                "scale": _np(sd[f"{tp}.norm2.weight"]),
                "bias": _np(sd[f"{tp}.norm2.bias"]),
            },
            "mlp": {
                "fc1": {
                    "kernel": _linear(sd[f"{tp}.mlp.fc1.weight"]),
                    "bias": _np(sd[f"{tp}.mlp.fc1.bias"]),
                },
                "fc2": {
                    "kernel": _linear(sd[f"{tp}.mlp.fc2.weight"]),
                    "bias": _np(sd[f"{tp}.mlp.fc2.bias"]),
                },
            },
            "ls2": {"gamma": _np(sd[f"{tp}.ls2.gamma"])},
        }
    out["norm"] = {
        "scale": _np(sd["norm.weight"]),
        "bias": _np(sd["norm.bias"]),
    }
    return _match_dtypes(out, template)


def convert_superpoint_torch(
    state_dict: Mapping[str, Any], template: Dict[str, Any]
) -> Dict[str, Any]:
    """magicleap SuperPointNet state_dict -> models/superpoint params.

    Name mapping: conv{1..4}{a,b} -> conv{1..4}_{0,1}; convPa/convPb ->
    det_conv/det_out; convDa/convDb -> desc_conv/desc_out.
    """
    sd = state_dict

    def conv_entry(name):
        return {
            "kernel": _conv(sd[f"{name}.weight"]),
            "bias": _np(sd[f"{name}.bias"]),
        }

    out: Dict[str, Any] = {}
    for i in (1, 2, 3, 4):
        out[f"conv{i}_0"] = conv_entry(f"conv{i}a")
        out[f"conv{i}_1"] = conv_entry(f"conv{i}b")
    out["det_conv"] = conv_entry("convPa")
    out["det_out"] = conv_entry("convPb")
    out["desc_conv"] = conv_entry("convDa")
    out["desc_out"] = conv_entry("convDb")
    return _match_dtypes(out, template)


def convert_lightglue_torch(
    state_dict: Mapping[str, Any], template: Dict[str, Any]
) -> Dict[str, Any]:
    """cvg/LightGlue (superpoint variant) state_dict -> models/lightglue
    MatcherNet params.

    Mapping notes:
      * transformers.{i}.self_attn.Wqkv splits into our q/k/v thirds;
      * the official CrossBlock shares one to_qk projection for both query
        and key — our separate q/k Dense layers both receive it;
      * per-depth tensors stack along axis 0 (our nn.scan layout);
      * the LAST layer's log_assignment head maps to our final_proj /
        matchability (we run fixed depth; earlier exit heads are unused).
    """
    sd = state_dict
    depth = int(template["blocks"]["self"]["q"]["kernel"].shape[0])

    def lin(name):
        return {"kernel": _linear(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}

    def stack(entries):
        out = {}
        for key in entries[0]:
            if isinstance(entries[0][key], dict):
                out[key] = stack([e[key] for e in entries])
            else:
                out[key] = np.stack(
                    [np.asarray(e[key]) for e in entries], axis=0
                )
        return out

    self_layers, cross_layers = [], []
    for i in range(depth):
        tp = f"transformers.{i}"
        Wqkv = _linear(sd[f"{tp}.self_attn.Wqkv.weight"])  # (d, 3d)
        bqkv = _np(sd[f"{tp}.self_attn.Wqkv.bias"])
        d = Wqkv.shape[0]
        q_k = Wqkv[:, :d]
        k_k = Wqkv[:, d : 2 * d]
        v_k = Wqkv[:, 2 * d :]

        def ffn(prefix):
            return {
                "ffn1": lin(f"{prefix}.ffn.0"),
                "ffn_norm": {
                    "scale": _np(sd[f"{prefix}.ffn.1.weight"]),
                    "bias": _np(sd[f"{prefix}.ffn.1.bias"]),
                },
                "ffn2": lin(f"{prefix}.ffn.3"),
            }

        self_layers.append(
            {
                "q": {"kernel": q_k, "bias": bqkv[:d]},
                "k": {"kernel": k_k, "bias": bqkv[d : 2 * d]},
                "v": {"kernel": v_k, "bias": bqkv[2 * d :]},
                "proj": lin(f"{tp}.self_attn.out_proj"),
                **ffn(f"{tp}.self_attn"),
            }
        )
        qk = lin(f"{tp}.cross_attn.to_qk")
        cross_layers.append(
            {
                "q": qk,
                "k": {k: v.copy() for k, v in qk.items()},
                "v": lin(f"{tp}.cross_attn.to_v"),
                "proj": lin(f"{tp}.cross_attn.to_out"),
                **ffn(f"{tp}.cross_attn"),
            }
        )

    last = depth - 1
    out: Dict[str, Any] = {
        "in_proj": lin("input_proj"),
        "posenc": {"Wr": _linear(sd["posenc.Wr.weight"])},
        "blocks": {"self": stack(self_layers), "cross": stack(cross_layers)},
        "final_proj": lin(f"log_assignment.{last}.final_proj"),
        "matchability": lin(f"log_assignment.{last}.matchability"),
    }
    return _match_dtypes(out, template)


def convert_loftr_torch(
    state_dict: Mapping[str, Any], template: Dict[str, Any]
) -> Dict[str, Any]:
    """Official zju3dv/kornia LoFTR checkpoint -> OfficialLoFTRMatcher params.

    Accepts the raw lightning checkpoint layout (keys under 'state_dict'
    with a 'matcher.' prefix) or a flat module state dict. Mapping:
      backbone.layer{s}.{b}.*          -> coarse/backbone/layer{s}_{b}
      backbone.layerN_outconv2.{0,1,3} -> ..._outconv2_0 / _bn / _1
      loftr_coarse.layers.{2i,2i+1}    -> coarse_self{i} / coarse_cross{i}
      fine_preprocess.down_proj etc.   -> fine/down_proj, fine/merge_feat
      loftr_fine.layers.{0,1}          -> fine/fine_self0 / fine_cross0
    The fine_matching stage has no parameters (spatial expectation only).
    """
    if "state_dict" in state_dict and not any("." in k for k in state_dict):
        state_dict = state_dict["state_dict"]
    sd = {}
    for k, v in state_dict.items():
        sd[k[len("matcher.") :] if k.startswith("matcher.") else k] = v

    def enc_layer(tp: str) -> Dict[str, Any]:
        return {
            "q_proj": {"kernel": _linear(sd[f"{tp}.q_proj.weight"])},
            "k_proj": {"kernel": _linear(sd[f"{tp}.k_proj.weight"])},
            "v_proj": {"kernel": _linear(sd[f"{tp}.v_proj.weight"])},
            "merge": {"kernel": _linear(sd[f"{tp}.merge.weight"])},
            "norm1": {
                "scale": _np(sd[f"{tp}.norm1.weight"]),
                "bias": _np(sd[f"{tp}.norm1.bias"]),
            },
            "mlp0": {"kernel": _linear(sd[f"{tp}.mlp.0.weight"])},
            "mlp2": {"kernel": _linear(sd[f"{tp}.mlp.2.weight"])},
            "norm2": {
                "scale": _np(sd[f"{tp}.norm2.weight"]),
                "bias": _np(sd[f"{tp}.norm2.bias"]),
            },
        }

    bb: Dict[str, Any] = {
        "conv1": {"kernel": _conv(sd["backbone.conv1.weight"])},
        "bn1": _bn(sd, "backbone.bn1"),
    }
    for s in (1, 2, 3):
        for b in (0, 1):
            tp = f"backbone.layer{s}.{b}"
            entry = {
                "conv1": {"kernel": _conv(sd[f"{tp}.conv1.weight"])},
                "bn1": _bn(sd, f"{tp}.bn1"),
                "conv2": {"kernel": _conv(sd[f"{tp}.conv2.weight"])},
                "bn2": _bn(sd, f"{tp}.bn2"),
            }
            if f"{tp}.downsample.0.weight" in sd:
                entry["downsample_conv"] = {
                    "kernel": _conv(sd[f"{tp}.downsample.0.weight"])
                }
                entry["downsample_bn"] = _bn(sd, f"{tp}.downsample.1")
            bb[f"layer{s}_{b}"] = entry
    bb["layer3_outconv"] = {"kernel": _conv(sd["backbone.layer3_outconv.weight"])}
    for n in (1, 2):
        bb[f"layer{n}_outconv"] = {
            "kernel": _conv(sd[f"backbone.layer{n}_outconv.weight"])
        }
        bb[f"layer{n}_outconv2_0"] = {
            "kernel": _conv(sd[f"backbone.layer{n}_outconv2.0.weight"])
        }
        bb[f"layer{n}_outconv2_bn"] = _bn(sd, f"backbone.layer{n}_outconv2.1")
        bb[f"layer{n}_outconv2_1"] = {
            "kernel": _conv(sd[f"backbone.layer{n}_outconv2.3.weight"])
        }

    coarse: Dict[str, Any] = {"backbone": bb}
    depth = sum(1 for k in template["coarse"] if k.startswith("coarse_self"))
    for i in range(depth):
        coarse[f"coarse_self{i}"] = enc_layer(f"loftr_coarse.layers.{2 * i}")
        coarse[f"coarse_cross{i}"] = enc_layer(f"loftr_coarse.layers.{2 * i + 1}")

    def lin_b(name):
        return {
            "kernel": _linear(sd[f"{name}.weight"]),
            "bias": _np(sd[f"{name}.bias"]),
        }

    fine: Dict[str, Any] = {
        "down_proj": lin_b("fine_preprocess.down_proj"),
        "merge_feat": lin_b("fine_preprocess.merge_feat"),
        "fine_self0": enc_layer("loftr_fine.layers.0"),
        "fine_cross0": enc_layer("loftr_fine.layers.1"),
    }
    return _match_dtypes({"coarse": coarse, "fine": fine}, template)


def _match_dtypes(new: Any, template: Any) -> Any:
    """Cast converted arrays to the template's dtypes and assert shapes."""
    if isinstance(template, Mapping):
        out = {}
        for k, tv in template.items():
            if k not in new:
                raise KeyError(f"converted params missing {k!r}")
            out[k] = _match_dtypes(new[k], tv)
        return out
    arr = np.asarray(new)
    t = np.asarray(template)
    if arr.shape != t.shape:
        raise ValueError(f"shape mismatch: got {arr.shape}, expected {t.shape}")
    return arr.astype(t.dtype)
