"""Geometric verification: match -> RANSAC -> pose -> validity.

Counterpart of ``mlis_tpu/gating/verification.py``:

* fewer than 5 matches -> an invalid result with zeroed fields;
* valid iff inliers >= 20 and inlier ratio >= 0.25 (and, when
  ``min_confident_matches`` > 0 and the matcher reports the count, at least
  that many matches with score >= 0.5); confidence = min(1, ratio *
  inliers / min_inliers);
* ``verify`` checks one pair of uint8 images through the matcher's
  ``detect_and_match``; ``verify_pairs_batch`` checks a batch of grayscale
  pairs: fused match + RANSAC for LightGlue and SuperGlue, pair by pair
  through ``verify`` for a classical matcher (ORB), and one padded
  ``match_batch`` plus batched RANSAC for a dense matcher (LoFTR);
* ``SemanticGeometricVerifier`` skips cross-floor pairs before any model
  work.

RANSAC's draws: the JAX package keys ``verify`` with ``PRNGKey(seed)`` for
every pair and a chunk ``s`` of ``verify_pairs_batch`` with
``PRNGKey(seed + s)``. Torch cannot reproduce those streams, so the port
draws from ``torch.Generator().manual_seed(seed)`` (and ``seed + s``) on
the matcher's device, and every entry point takes the draws themselves as
``uniforms`` (tests feed the JAX package's).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mlis_tpu_torch.ops.epipolar import essential_ransac, essential_ransac_batch, recover_pose

NUM_HYPOTHESES = 512


@dataclass
class MatchResult:
    query_idx: int
    match_idx: int
    num_keypoints_query: int
    num_keypoints_match: int
    num_matches: int
    num_inliers: int
    inlier_ratio: float
    relative_pose: Optional[np.ndarray]
    essential_matrix: Optional[np.ndarray]
    confidence: float
    is_valid: bool
    num_confident_matches: int = -1


def _invalid_result(query_idx: int, match_idx: int) -> MatchResult:
    return MatchResult(query_idx, match_idx, 0, 0, 0, 0, 0.0, None, None, 0.0, False)


def _draws(n_pairs: Optional[int], seed: int, device, num_hypotheses: int = NUM_HYPOTHESES):
    """RANSAC's uniforms from ``torch.Generator(device).manual_seed(seed)``:
    (num_hypotheses, 8), or (n_pairs, num_hypotheses, 8)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shape = (num_hypotheses, 8) if n_pairs is None else (n_pairs, num_hypotheses, 8)
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


class BaseFeatureMatcher:
    """Matcher interface and the shared single-pair geometric checks.
    Subclasses set ``device`` and implement ``detect_and_match``."""

    device = torch.device("cpu")

    def detect_and_match(self, image1, image2):
        raise NotImplementedError

    def verify_geometric_consistency(
        self,
        kpts1,
        kpts2,
        K: Optional[np.ndarray] = None,
        ransac_threshold: float = 3.0,
        num_hypotheses: int = NUM_HYPOTHESES,
        seed: int = 0,
        uniforms: Optional[torch.Tensor] = None,  # (num_hypotheses, 8)
    ) -> Tuple[np.ndarray, Optional[np.ndarray], float]:
        """Essential RANSAC on one pair's matches. Without K a unit-focal
        camera scaled by the largest coordinate stands in. Returns (inlier
        mask, E, inlier ratio)."""
        if len(kpts1) < 5:
            return np.array([]), None, 0.0
        k1 = torch.as_tensor(kpts1, device=self.device).to(torch.float32)
        k2 = torch.as_tensor(kpts2, device=self.device).to(torch.float32)
        if K is None:
            scale = max(float(k1.abs().max()), 1.0)
            K = np.array([[scale, 0, 0], [0, scale, 0], [0, 0, 1]], dtype=np.float64)
        if uniforms is None:
            uniforms = _draws(None, seed, self.device, num_hypotheses)
        with record_function("epipolar.ransac"):
            res = essential_ransac(
                k1, k2, torch.ones(k1.shape[0], dtype=torch.bool, device=self.device),
                torch.as_tensor(np.array(K, np.float32), device=self.device),
                num_hypotheses=num_hypotheses, threshold_px=ransac_threshold,
                uniforms=uniforms.to(self.device),
            )
        return res.inlier_mask.cpu().numpy(), res.E.cpu().numpy(), float(res.inlier_ratio)

    def estimate_relative_pose(self, kpts1, kpts2, K: np.ndarray, inlier_mask: np.ndarray,
                               E: np.ndarray) -> Optional[np.ndarray]:
        """Cheirality-voted (R, t) as a 4x4 float64 transform, or None."""
        if E is None or int(np.sum(inlier_mask)) < 5:
            return None
        dev = self.device
        with record_function("epipolar.ransac"):
            T, good, _ = recover_pose(
                torch.as_tensor(np.array(E, np.float32), device=dev),
                torch.as_tensor(kpts1, device=dev).to(torch.float32),
                torch.as_tensor(kpts2, device=dev).to(torch.float32),
                torch.as_tensor(np.asarray(inlier_mask, bool), device=dev),
                torch.as_tensor(np.array(K, np.float32), device=dev),
            )
        if int(good) < 1:
            return None
        return T.cpu().numpy().astype(np.float64)


def _pad_pairs_pow2(images0: torch.Tensor, images1: torch.Tensor):
    """Pad a (P, ...) pair batch to the next power of two (at least 8) by
    repeating the first pair; results past P are discarded by the caller."""
    P = int(images0.shape[0])
    Ppad = 1 << max(3, (P - 1).bit_length())
    if Ppad == P:
        return images0, images1
    reps = [x[:1].expand(Ppad - P, *x.shape[1:]) for x in (images0, images1)]
    return torch.cat([images0, reps[0]]), torch.cat([images1, reps[1]])


def _build_matcher(matcher_type: str, **kwargs):
    m = matcher_type.lower()
    if m == "lightglue":
        from mlis_tpu_torch.models.lightglue import LightGlue

        return LightGlue(**kwargs)
    if m == "superglue":
        from mlis_tpu_torch.models.lightglue import SuperGlue

        return SuperGlue(**kwargs)
    if m == "loftr":
        from mlis_tpu_torch.models.loftr import LoFTR

        return LoFTR(**kwargs)
    if m == "orb":
        from mlis_tpu_torch.models.orb import ORBMatcher

        return ORBMatcher(**kwargs)
    raise ValueError(f"Unknown matcher: {matcher_type}")


class GeometricVerifier:
    def __init__(
        self,
        matcher_type: str = "lightglue",
        min_inliers: int = 20,
        min_inlier_ratio: float = 0.25,
        ransac_threshold: float = 3.0,
        matcher=None,
        min_confident_matches: int = 0,
        **matcher_kwargs,
    ):
        self.min_inliers = min_inliers
        self.min_inlier_ratio = min_inlier_ratio
        self.min_confident_matches = min_confident_matches
        self.ransac_threshold = ransac_threshold
        self.matcher = matcher if matcher is not None else _build_matcher(matcher_type, **matcher_kwargs)

    def _result_from_counts(self, query_idx, match_idx, n1, n2, n_matches, num_inliers,
                            inlier_ratio, pose, E, n_confident: int = -1) -> MatchResult:
        is_valid = num_inliers >= self.min_inliers and inlier_ratio >= self.min_inlier_ratio
        if self.min_confident_matches > 0 and n_confident >= 0:
            is_valid = is_valid and n_confident >= self.min_confident_matches
        confidence = min(1.0, inlier_ratio * (num_inliers / self.min_inliers))
        return MatchResult(query_idx, match_idx, n1, n2, n_matches, num_inliers, inlier_ratio,
                           pose, E, confidence, is_valid, n_confident)

    def results_from_rows(self, pairs: np.ndarray, rows: np.ndarray) -> List[MatchResult]:
        """MatchResults from packed per-pair rows ``[n_kp0, n_kp1, n_match,
        n_inl, ratio, E (9), T (16), n_confident]`` (see :func:`pack_rows`)."""
        out = []
        for (q, m), r in zip(pairs, rows):
            q, m = int(q), int(m)
            if r[2] < 5:
                out.append(_invalid_result(q, m))
                continue
            out.append(self._result_from_counts(
                q, m, int(r[0]), int(r[1]), int(r[2]), int(r[3]), float(r[4]),
                r[14:30].reshape(4, 4), r[5:14].reshape(3, 3), int(r[30]),
            ))
        return out

    def verify(self, image1, image2, K: Optional[np.ndarray] = None, query_idx: int = 0,
               match_idx: int = 0, seed: int = 0,
               uniforms: Optional[torch.Tensor] = None) -> MatchResult:
        """One pair of images (uint8, colour or mono) through the matcher's
        ``detect_and_match``, RANSAC with draws from ``seed`` (or
        ``uniforms`` (512, 8)) and, with K, the pose. ``num_keypoints_*`` are
        the detector's totals, ``num_matches`` the matched pairs."""
        kpts1, kpts2, conf = self.matcher.detect_and_match(image1, image2)
        if len(kpts1) < 5:
            return _invalid_result(query_idx, match_idx)
        n_kp1, n_kp2 = getattr(self.matcher, "last_detector_counts", (len(kpts1), len(kpts2)))
        mask, E, ratio = self.matcher.verify_geometric_consistency(
            kpts1, kpts2, K, self.ransac_threshold, seed=seed, uniforms=uniforms)
        num_inliers = int(mask.sum()) if len(mask) else 0
        pose = None
        if K is not None and E is not None and num_inliers >= 5:
            pose = self.matcher.estimate_relative_pose(kpts1, kpts2, K, mask, E)
        # only matchers whose confidences are match probabilities report the
        # confident count (ORB's Hamming similarity does not: -1, exempt)
        n_conf = (int((torch.as_tensor(conf) >= 0.5).sum())
                  if getattr(self.matcher, "confidence_is_calibrated", False) else -1)
        return self._result_from_counts(query_idx, match_idx, n_kp1, n_kp2, len(kpts1),
                                        num_inliers, float(ratio), pose, E, n_conf)

    def verify_batch(self, image_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                     K: Optional[np.ndarray] = None,
                     indices: Optional[Sequence[Tuple[int, int]]] = None) -> List[MatchResult]:
        out = []
        for i, (im1, im2) in enumerate(image_pairs):
            q, m = indices[i] if indices is not None else (i, i)
            out.append(self.verify(im1, im2, K, q, m))
        return out

    def verify_pairs_batch(
        self,
        images0,  # (P, H, W, 1) grayscale float in [0, 1]
        images1,
        K: np.ndarray,
        indices: Optional[Sequence[Tuple[int, int]]] = None,
        seed: int = 0,
        batch_size: Optional[int] = None,
        uniforms: Optional[torch.Tensor] = None,  # (P, H_hyp, 8)
        generator: Optional[torch.Generator] = None,
    ) -> List[MatchResult]:
        """A batch of pairs, in chunks of ``batch_size``: detect both sides,
        match, RANSAC and pose (LightGlue, SuperGlue); pair by pair through
        :meth:`verify` (a matcher without ``match_batch``, ORB); or one
        ``match_batch`` padded to a power of two and batched RANSAC (a
        ``dense_matcher``, LoFTR). Chunk ``s`` draws from ``generator`` or,
        without one, from ``seed + s``; ``uniforms`` replaces the draws."""
        matcher = self.matcher
        dev = matcher.device
        im0 = torch.as_tensor(images0, device=dev).to(torch.float32)
        im1 = torch.as_tensor(images1, device=dev).to(torch.float32)
        P = int(im0.shape[0])
        pairs = np.asarray(indices if indices is not None else [(p, p) for p in range(P)])
        pairs = pairs.reshape(-1, 2)
        if not hasattr(matcher, "make_fused_match_verify") and not hasattr(matcher, "match_batch"):
            # classical matcher (ORB): one pair at a time through verify, each
            # pair with verify's own draws (seed 0), as in the JAX package
            return [self.verify(im0[p], im1[p], K, int(pairs[p, 0]), int(pairs[p, 1]),
                                uniforms=uniforms[p] if uniforms is not None else None)
                    for p in range(P)]
        dense = getattr(matcher, "dense_matcher", False)
        if not dense:
            hw = (int(im0.shape[1]), int(im0.shape[2]))
            fused = matcher.make_fused_match_verify(hw, K, self.ransac_threshold)
        step = batch_size or max(P, 1)
        rows = []
        for s in range(0, P, step):
            b = min(step, P - s)
            u = uniforms[s : s + b].to(dev) if uniforms is not None else None
            if u is None and generator is None:
                u = _draws(b, seed + s, dev)
            if dense:
                rows.append(self._dense_rows(im0[s : s + b], im1[s : s + b], K, u, generator))
            else:
                kp = matcher.sp.detect(torch.cat([im0[s : s + b], im1[s : s + b]]))
                qi = torch.arange(b, device=dev)
                rows.append(pack_rows(fused(kp, qi, qi + b, uniforms=u, generator=generator)))
        flat = torch.cat(rows).cpu().numpy() if rows else np.zeros((0, 31), np.float32)
        return self.results_from_rows(pairs, flat)

    def _dense_rows(self, im0, im1, K, uniforms, generator) -> torch.Tensor:
        """Packed rows for a chunk of pairs through a dense matcher: padded
        to a power of two, matched, essential RANSAC over the matched
        points; "detected" keypoints are the matched points."""
        matcher = self.matcher
        P = int(im0.shape[0])
        p0, p1 = _pad_pairs_pow2(im0, im1)
        Ppad = int(p0.shape[0])
        if uniforms is not None and Ppad > P:  # the padding pairs' results are discarded
            uniforms = torch.cat([uniforms, uniforms[:1].expand(Ppad - P, *uniforms.shape[1:])])
        dm = matcher.match_batch(p0, p1)
        with record_function("epipolar.ransac"):
            res, T, _good = essential_ransac_batch(
                dm.kpts0, dm.kpts1, dm.valid,
                torch.as_tensor(np.array(K, np.float32), device=matcher.device),
                threshold_px=self.ransac_threshold, uniforms=uniforms, generator=generator)
        n_match = dm.valid.sum(1)
        if getattr(matcher, "confidence_is_calibrated", False):
            n_conf = (dm.valid & (dm.scores >= 0.5)).sum(1)
        else:
            n_conf = torch.full_like(n_match, -1)
        out = (n_match, n_match, n_match, res.num_inliers, res.inlier_ratio, res.E, T, n_conf)
        return pack_rows(tuple(x[:P] for x in out))


def pack_rows(out) -> torch.Tensor:
    """Pack one batch's fused outputs into (B, 31) float32 rows:
    [n_kp0, n_kp1, n_match, n_inl, ratio, E (9), T (16), n_confident]."""
    n_kp0, n_kp1, n_match, n_inl, ratios, Es, Ts, n_conf = out
    B = n_kp0.shape[0]
    cols = [x.to(torch.float32)[:, None] for x in (n_kp0, n_kp1, n_match, n_inl, ratios)]
    return torch.cat(
        cols + [Es.reshape(B, 9).float(), Ts.reshape(B, 16).float(), n_conf.float()[:, None]], 1
    )


class SemanticGeometricVerifier(GeometricVerifier):
    """Floor gate before any geometric work."""

    def __init__(self, matcher_type: str = "lightglue", min_inliers: int = 20,
                 min_inlier_ratio: float = 0.25, enable_floor_gating: bool = True, **kwargs):
        super().__init__(matcher_type, min_inliers, min_inlier_ratio, **kwargs)
        self.enable_floor_gating = enable_floor_gating
        self.stats = {"verified": 0, "skipped_floor_mismatch": 0, "valid": 0, "invalid": 0}

    def verify_with_semantics(self, image1, image2, floor1: int, floor2: int,
                              K: Optional[np.ndarray] = None, query_idx: int = 0,
                              match_idx: int = 0,
                              uniforms: Optional[torch.Tensor] = None) -> MatchResult:
        """One pair of uint8 images through :meth:`verify`; cross-floor pairs
        are skipped before any model work."""
        if self.enable_floor_gating and floor1 != floor2:
            self.stats["skipped_floor_mismatch"] += 1
            return _invalid_result(query_idx, match_idx)
        result = self.verify(image1, image2, K, query_idx, match_idx, uniforms=uniforms)
        self.stats["verified"] += 1
        self.stats["valid" if result.is_valid else "invalid"] += 1
        return result

    def get_statistics(self) -> Dict:
        total = self.stats["verified"] + self.stats["skipped_floor_mismatch"]
        return {
            **self.stats,
            "total_candidates": total,
            "skip_rate": self.stats["skipped_floor_mismatch"] / total if total else 0,
            "valid_rate": self.stats["valid"] / self.stats["verified"] if self.stats["verified"] else 0,
        }
