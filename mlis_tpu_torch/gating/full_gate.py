"""Full semantic gate: VPR retrieval -> floor gate -> geometric verification.

Counterpart of the standard two-phase path of
``mlis_tpu/gating/full_gate.py`` (``FullGatePipeline.process`` with
``survivor_budget=None`` and ``monolithic=False``). Stage order:

1. keypoints detected once per keyframe (SuperPoint, optionally pruned to
   the top ``match_top_k`` by score) and VPR descriptors (CricaVPR by
   default, or MixVPR);
2. cosine top-k retrieval with the temporal mask, unique (lo, hi) pairs
   above the similarity threshold, the strict floor gate and survivor
   compaction in ascending (lo, hi) order -- all on the device
   (:func:`_gate_compact`);
3. LightGlue (or SuperGlue) matching + essential RANSAC + cheirality pose
   on the survivors' pre-detected keypoints, in batches of
   ``verify_batch`` pairs. A matcher without ``make_fused_match_verify``
   (LoFTR, ORB) instead gets the survivors' grayscale pairs (the keyframes
   converted once) through ``GeometricVerifier.verify_pairs_batch`` with
   ``batch_size=verify_batch``; no keypoints are detected up front.

The fused-budget, mega and pipelined-mega variants of the JAX package are
not ported yet. Each stage runs inside a ``torch.profiler`` range
(``gate.detect``, ``gate.encode``, ``gate.retrieval``, ``lightglue.match``
with ``superglue.sinkhorn`` inside it for SuperGlue, ``loftr.match``,
``orb.match``, ``epipolar.ransac``) so that a profile attributes device time
to stages.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mlis_tpu_torch.gating.gate import gate_mask
from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
from mlis_tpu_torch.gating.verification import GeometricVerifier, MatchResult, pack_rows
from mlis_tpu_torch.models.superpoint import Keypoints
from mlis_tpu_torch.ops.image import to_grayscale
from mlis_tpu_torch.ops.knn import cosine_topk


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gate_compact(
    db: torch.Tensor,  # (n, D) descriptors
    times: torch.Tensor,  # (n,)
    floors: torch.Tensor,  # (n,) int
    *,
    k: int,
    threshold: float,
    min_time_gap: float,
    strict: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]:
    """Retrieval -> unique-pair dedup -> floor gate -> survivor compaction.

    Each above-threshold candidate is packed as the int64 key lo * n + hi;
    sorting the keys and keeping first occurrences is ``np.unique`` over
    (lo, hi) rows, so survivors come out in ascending (lo, hi) order.
    Returns (qi (S,), mi (S,), (total_unique_pairs, rejected_by_floor))."""
    n = db.shape[0]
    scores, idx = cosine_topk(db, db, times, times, k=k, min_time_gap=min_time_gap)
    q = torch.arange(n, device=db.device)[:, None].expand(n, k)
    idx = idx.to(torch.int64)
    valid = torch.isfinite(scores) & (scores >= threshold)
    lo, hi = torch.minimum(q, idx), torch.maximum(q, idx)
    sentinel = n * n
    skeys = torch.sort(torch.where(valid, lo * n + hi, torch.full_like(lo, sentinel)).reshape(-1))[0]
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    uniq = first & (skeys < sentinel)
    lo_s = torch.div(skeys, n, rounding_mode="floor").clamp(max=n - 1)
    hi_s = skeys % n
    accept = uniq & gate_mask(floors, lo_s, hi_s, strict)
    total, rejected = (int(v) for v in torch.stack([uniq.sum(), (uniq & ~accept).sum()]).tolist())
    return lo_s[accept], hi_s[accept], (total, rejected)


@dataclass
class FullGateResult:
    total_pairs: int = 0
    cross_floor_rejected: int = 0
    verified: int = 0
    geometrically_valid: int = 0
    results: List[MatchResult] = field(default_factory=list)
    elapsed_s: float = 0.0
    vpr_s: float = 0.0
    retrieval_s: float = 0.0
    verify_s: float = 0.0

    @property
    def pairs_per_sec(self) -> float:
        return self.total_pairs / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def summary(self) -> Dict:
        return {
            "total_pairs": self.total_pairs,
            "cross_floor_rejected": self.cross_floor_rejected,
            "rejection_rate": self.cross_floor_rejected / self.total_pairs
            if self.total_pairs
            else 0.0,
            "verified": self.verified,
            "geometrically_valid": self.geometrically_valid,
            "pairs_per_sec": self.pairs_per_sec,
            "stage_seconds": {
                "vpr": self.vpr_s,
                "retrieval": self.retrieval_s,
                "verification": self.verify_s,
            },
        }


class FullGatePipeline:
    """End-to-end keyframe gating with stage timing."""

    @classmethod
    def from_config(cls, cfg, device="cuda") -> "FullGatePipeline":
        """Build from a :class:`mlis_tpu_torch.config.PipelineConfig`."""
        from mlis_tpu_torch.models.superpoint import SuperPointConfig

        verifier = GeometricVerifier(
            matcher_type=cfg.verification.matcher,
            min_inliers=cfg.verification.min_inliers,
            min_inlier_ratio=cfg.verification.min_inlier_ratio,
            ransac_threshold=cfg.verification.ransac_threshold_px,
            sp_cfg=SuperPointConfig(max_keypoints=cfg.verification.max_keypoints),
            device=device,
        )
        return cls(
            vpr_method=cfg.vpr.method,
            verifier=verifier,
            top_k=cfg.vpr.top_k,
            similarity_threshold=cfg.vpr.similarity_threshold,
            min_time_gap=cfg.vpr.min_time_gap_s,
            strict_floor=cfg.gating.gate.strict_mode,
            device=device,
        )

    def __init__(
        self,
        vpr: Optional[SemanticPlaceRecognition] = None,
        verifier: Optional[GeometricVerifier] = None,
        vpr_method: str = "cricavpr",
        matcher_type: str = "lightglue",
        top_k: int = 10,
        similarity_threshold: float = 0.5,
        min_time_gap: float = 10.0,
        verify_batch: int = 64,
        strict_floor: bool = True,
        detect_scale: float = 1.0,
        match_top_k: Optional[int] = None,
        matcher_weights: Optional[str] = "auto",
        num_hypotheses: int = 512,
        ransac_subset: int = 0,
        device="cuda",
        **model_kwargs,
    ):
        """matcher_weights: "auto" loads the shipped LightGlue checkpoint
        when its shapes fit the matcher (a tiny test matcher keeps its own
        weights); a path must load; None loads nothing."""
        self.device = torch.device(device)
        self.detect_scale = detect_scale
        self.num_hypotheses = int(num_hypotheses)
        self.ransac_subset = int(ransac_subset)
        self.match_top_k = match_top_k
        self.spr = vpr or SemanticPlaceRecognition(
            vpr_method=vpr_method,
            similarity_threshold=similarity_threshold,
            min_time_gap=min_time_gap,
            device=device,
            **model_kwargs,
        )
        self.verifier = verifier or GeometricVerifier(matcher_type=matcher_type, device=device)
        self.matcher_weights_loaded = None
        if matcher_weights is not None:
            import os

            from mlis_tpu_torch.weights import default_matcher_checkpoint

            auto = matcher_weights == "auto"
            path = default_matcher_checkpoint() if auto else matcher_weights
            if path and os.path.exists(path) and hasattr(self.verifier.matcher, "load_weights"):
                try:
                    self.verifier.matcher.load_weights(path)
                    self.matcher_weights_loaded = path
                except (KeyError, ValueError, RuntimeError):
                    if not auto:
                        raise
        self.top_k = top_k
        self.similarity_threshold = similarity_threshold
        self.min_time_gap = min_time_gap
        self.verify_batch = verify_batch
        self.strict_floor = strict_floor
        self._fused_cache: Dict = {}

    def process(
        self,
        images,  # (N, H, W, 3) colour or (N, H, W) mono8 keyframes: array or tensor
        timestamps: np.ndarray,
        floor_labels: np.ndarray,
        K: np.ndarray,
        encode_batch_size: int = 64,
        verify: bool = True,
        upload_chunk: int = 32,
        survivor_budget: Optional[int] = None,
        monolithic: bool = False,
        ransac_uniforms: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> FullGateResult:
        """upload_chunk, survivor_budget, monolithic: accepted in the JAX
        package's positions so that its callers (bench.py's reps, the
        ``fullgate`` CLI) run unchanged, and they change nothing. There
        they select budgeted, fused or one-dispatch variants whose result
        never depends on the budget (an overflow reruns the exact path);
        this method always runs the exact two-phase path.

        ransac_uniforms: optional (n_survivors, num_hypotheses, 8) draws
        for RANSAC, one block per survivor in compaction order; without
        them the draws come from ``generator`` on the device.

        ``images`` may be a tensor already on the device (as bench.py passes
        device arrays), which then is not copied."""
        n = len(images)
        res = FullGateResult()
        dev = self.device
        t_start = time.perf_counter()

        # 1) keypoints once per keyframe + VPR descriptors, device-resident
        if not isinstance(images, torch.Tensor):
            images = np.ascontiguousarray(images)
        imgs = torch.as_tensor(images, device=dev)
        fused_ok = verify and hasattr(self.verifier.matcher, "make_fused_match_verify")
        with record_function("gate.detect"):
            kp_all = self._detect_all(imgs) if fused_ok else None
        encode_dev = getattr(self.spr.vpr, "encode_batch_device", None)
        if encode_dev is not None:
            with record_function("gate.encode"):
                db = torch.cat([
                    encode_dev(imgs[s : s + encode_batch_size])
                    for s in range(0, n, encode_batch_size)
                ])
            times = torch.as_tensor(np.asarray(timestamps, np.float32), device=dev)
        else:
            for s in range(0, n, encode_batch_size):
                e = min(s + encode_batch_size, n)
                self.spr.add_images_batch(images[s:e], timestamps[s:e], floor_labels[s:e])
            db = torch.as_tensor(self.spr.vpr.build_descriptor_matrix(), device=dev)
            times = torch.as_tensor(self.spr.vpr.timestamps().astype(np.float32), device=dev)
        _sync(dev)
        res.vpr_s = time.perf_counter() - t_start

        # 2-3) retrieval, dedup, floor gate, compaction
        t0 = time.perf_counter()
        floors = torch.as_tensor(np.asarray(floor_labels).astype(np.int64), device=dev)
        with record_function("gate.retrieval"):
            qi, mi, (total, rejected) = _gate_compact(
                db, times, floors,
                k=min(self.top_k, n),
                threshold=float(self.similarity_threshold),
                min_time_gap=float(self.min_time_gap),
                strict=bool(self.strict_floor),
            )
        res.total_pairs, res.cross_floor_rejected = total, rejected
        res.retrieval_s = time.perf_counter() - t0
        if total == 0:
            res.elapsed_s = time.perf_counter() - t_start
            return res

        # 4) match + RANSAC + pose over the survivors: fused over the
        # detected keypoints, or pair batches of grayscale images
        if verify and qi.numel():
            t0 = time.perf_counter()
            hw = (int(imgs.shape[1]), int(imgs.shape[2]))
            if fused_ok:
                res.results = self._verify_survivors(kp_all, qi, mi, K, hw, ransac_uniforms,
                                                     generator)
            else:
                res.results = self._verify_gray_pairs(imgs, qi, mi, K, ransac_uniforms, generator)
            res.verify_s = time.perf_counter() - t0
            res.verified = len(res.results)
            res.geometrically_valid = sum(1 for r in res.results if r.is_valid)
        res.elapsed_s = time.perf_counter() - t_start
        return res

    def _detect_all(self, images: torch.Tensor, detect_batch: int = 128) -> Keypoints:
        """Keypoints for every keyframe, coordinates in input pixels."""
        H, W = int(images.shape[1]), int(images.shape[2])
        scale = self.detect_scale
        h8 = (int(H * scale) // 8) * 8
        w8 = (int(W * scale) // 8) * 8
        gray = to_grayscale(images, size=(h8, w8))
        sxy = torch.tensor([W / w8, H / h8], dtype=torch.float32, device=images.device)
        sp = self.verifier.matcher.sp
        top_m = self.match_top_k
        kps = []
        for s in range(0, images.shape[0], detect_batch):
            kp = sp.detect(gray[s : s + detect_batch])
            kp = kp._replace(coords=kp.coords * sxy)
            if top_m and top_m < kp.coords.shape[1]:
                kp = kp.map(lambda x: x[:, :top_m])
            kps.append(kp)
        return Keypoints(*(torch.cat(parts) for parts in zip(*kps)))

    def _verify_gray_pairs(self, imgs, qi, mi, K, uniforms, generator) -> List[MatchResult]:
        """Survivors as grayscale pairs through ``verify_pairs_batch`` in
        chunks of ``verify_batch`` (LoFTR, ORB)."""
        S = qi.numel()
        if uniforms is not None and tuple(uniforms.shape) != (S, self.num_hypotheses, 8):
            raise ValueError(
                f"ransac_uniforms must be {(S, self.num_hypotheses, 8)}, got {tuple(uniforms.shape)}"
            )
        gray = to_grayscale(imgs)
        pairs = torch.stack([qi, mi], 1).cpu().numpy()
        return self.verifier.verify_pairs_batch(
            gray[qi], gray[mi], K, indices=[(int(a), int(b)) for a, b in pairs],
            batch_size=self.verify_batch, uniforms=uniforms, generator=generator)

    def _get_fused(self, hw, K):
        key = (hw, float(np.asarray(K)[0, 0]), self.num_hypotheses, self.ransac_subset)
        if key not in self._fused_cache:
            self._fused_cache[key] = self.verifier.matcher.make_fused_match_verify(
                hw, K, self.verifier.ransac_threshold,
                num_hypotheses=self.num_hypotheses, ransac_subset=self.ransac_subset,
            )
        return self._fused_cache[key]

    def _verify_survivors(self, kp_all, qi, mi, K, hw, uniforms, generator) -> List[MatchResult]:
        fused = self._get_fused(hw, K)
        S, B = qi.numel(), self.verify_batch
        if uniforms is not None and tuple(uniforms.shape) != (S, self.num_hypotheses, 8):
            raise ValueError(
                f"ransac_uniforms must be {(S, self.num_hypotheses, 8)}, got {tuple(uniforms.shape)}"
            )
        rows = []
        for s in range(0, S, B):
            u = uniforms[s : s + B].to(self.device) if uniforms is not None else None
            rows.append(pack_rows(fused(kp_all, qi[s : s + B], mi[s : s + B],
                                        uniforms=u, generator=generator)))
        flat = torch.cat(rows).cpu().numpy()  # one fetch
        pairs = torch.stack([qi, mi], 1).cpu().numpy()
        return self.verifier.results_from_rows(pairs, flat)
