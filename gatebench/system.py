"""The system under test: ``mlis_tpu_torch``'s gate built from a configuration.

This is the only module of the benchmark that imports the program. It
builds ``FullGatePipeline`` from a configuration file's settings and
records, per call, what the program's detect and encode stages handed on
(references to the tensors, no copy and no device work), for the
correctness check and the work counts.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def checkpoint(path: str) -> str:
    full = os.path.join(REPO_ROOT, path)
    if not os.path.exists(full):
        raise FileNotFoundError(f"checkpoint {path} is not in the checkout")
    return full


def build(cfg: dict, device):
    """``FullGatePipeline`` of the configuration, weights loaded."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue
    from mlis_tpu_torch.models.superpoint import SuperPointConfig

    det, vpr, mt, g = cfg["detector"], cfg["vpr"], cfg["matcher"], cfg["gate"]
    matcher = LightGlue.from_checkpoint(
        checkpoint(mt["checkpoint"]),
        sp_cfg=SuperPointConfig(max_keypoints=int(det["max_keypoints"]),
                                dtype=DTYPES[det["dtype"]]),
        dtype=DTYPES[mt["dtype"]], device=device)
    kw: Dict = dict(checkpoint=checkpoint(vpr["checkpoint"]),
                    descriptor_dim=int(vpr["descriptor_dim"]),
                    input_size=tuple(vpr["input_size"]))
    if vpr["method"] == "mixvpr":
        from mlis_tpu_torch.models.resnet import ResNetConfig

        kw["backbone_cfg"] = ResNetConfig(crop_stage=int(vpr["crop_stage"]),
                                          dtype=DTYPES[vpr["dtype"]])
    elif vpr["method"] == "cricavpr":
        from mlis_tpu_torch.models.vit import ViTConfig

        kw["vit_cfg"] = ViTConfig.dinov2_vitb14(dtype=DTYPES[vpr["dtype"]])
    spr = SemanticPlaceRecognition(vpr["method"], similarity_threshold=float(g["similarity_threshold"]),
                                   min_time_gap=float(g["min_time_gap"]), device=device, **kw)
    verifier = GeometricVerifier(matcher=matcher, min_inliers=int(g["min_inliers"]),
                                 min_inlier_ratio=float(g["min_inlier_ratio"]),
                                 ransac_threshold=float(g["ransac_threshold_px"]))
    return FullGatePipeline(
        vpr=spr, verifier=verifier, top_k=int(g["top_k"]),
        similarity_threshold=float(g["similarity_threshold"]),
        min_time_gap=float(g["min_time_gap"]), verify_batch=int(g["verify_batch"]),
        strict_floor=bool(g["strict_floor"]), match_top_k=det["match_top_k"],
        matcher_weights=None, num_hypotheses=int(g["num_hypotheses"]), device=device)


class Recorder:
    """Keeps what the detect, encode and match stages of each call returned.

    Of the calls :meth:`take` is told to keep whole (the correctness
    sample) it keeps the keypoints, the descriptors and each verify
    batch's matches; of every call the keypoint mask, which the work counts
    read after the window."""

    def __init__(self, pipe):
        self.pipe = pipe
        self._detect = pipe._detect_all
        self._encode = pipe.spr.vpr.encode_batch_device
        self._match = pipe.verifier.matcher.match_keypoints
        self.kp = None
        self.db: List[torch.Tensor] = []
        self.matches: List = []
        pipe._detect_all = self.detect_all
        pipe.spr.vpr.encode_batch_device = self.encode_batch_device
        pipe.verifier.matcher.match_keypoints = self.match_keypoints

    def detect_all(self, *a, **kw):
        self.kp = self._detect(*a, **kw)
        return self.kp

    def encode_batch_device(self, *a, **kw):
        out = self._encode(*a, **kw)
        self.db.append(out)
        return out

    def match_keypoints(self, *a, **kw):
        out = self._match(*a, **kw)
        self.matches.append((out.idx0, out.valid))
        return out

    def take(self, full: bool) -> Optional[dict]:
        """This call's record, then a clean slate for the next call."""
        kp, db, matches = self.kp, self.db, self.matches
        self.kp, self.db, self.matches = None, [], []
        if kp is None:
            return None
        rec = {"mask": kp.mask}
        if full:
            # joined after the window
            rec.update(kp=(kp.coords, kp.descriptors, kp.mask), db=db, matches=matches)
        return rec
