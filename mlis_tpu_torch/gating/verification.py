"""Geometric verification: match -> RANSAC -> pose -> validity.

Counterpart of ``mlis_tpu/gating/verification.py`` for the LightGlue path:

* fewer than 5 matches -> an invalid result with zeroed fields;
* valid iff inliers >= 20 and inlier ratio >= 0.25 (and, when
  ``min_confident_matches`` > 0, at least that many matches with score
  >= 0.5); confidence = min(1, ratio * inliers / min_inliers);
* ``SemanticGeometricVerifier`` skips cross-floor pairs before any model
  work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


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


def _build_matcher(matcher_type: str, **kwargs):
    if matcher_type.lower() == "lightglue":
        from mlis_tpu_torch.models.lightglue import LightGlue

        return LightGlue(**kwargs)
    raise ValueError(f"matcher {matcher_type!r} is not ported to mlis_tpu_torch yet")


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

    def verify_pairs_batch(
        self,
        images0,  # (P, H, W, 1) grayscale float in [0, 1]
        images1,
        K: np.ndarray,
        indices: Optional[Sequence[Tuple[int, int]]] = None,
        batch_size: Optional[int] = None,
        uniforms: Optional[torch.Tensor] = None,  # (P, H_hyp, 8)
        generator: Optional[torch.Generator] = None,
    ) -> List[MatchResult]:
        """Detect both sides, match, RANSAC and pose for a batch of pairs."""
        matcher = self.matcher
        dev = matcher.device
        im0 = torch.as_tensor(np.asarray(images0, np.float32), device=dev)
        im1 = torch.as_tensor(np.asarray(images1, np.float32), device=dev)
        P = im0.shape[0]
        hw = (int(im0.shape[1]), int(im0.shape[2]))
        fused = matcher.make_fused_match_verify(hw, K, self.ransac_threshold)
        step = batch_size or max(P, 1)
        rows = []
        for s in range(0, P, step):
            kp = matcher.sp.detect(torch.cat([im0[s : s + step], im1[s : s + step]]))
            b = min(step, P - s)
            qi = torch.arange(b, device=dev)
            u = uniforms[s : s + b] if uniforms is not None else None
            rows.append(pack_rows(fused(kp, qi, qi + b, uniforms=u, generator=generator)))
        pairs = indices if indices is not None else [(p, p) for p in range(P)]
        flat = torch.cat(rows).cpu().numpy() if rows else np.zeros((0, 31), np.float32)
        return self.results_from_rows(np.asarray(pairs).reshape(-1, 2), flat)


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
                              K: np.ndarray, query_idx: int = 0, match_idx: int = 0,
                              uniforms: Optional[torch.Tensor] = None) -> MatchResult:
        """One pair (H, W, 1) grayscale images; cross-floor pairs are skipped."""
        if self.enable_floor_gating and floor1 != floor2:
            self.stats["skipped_floor_mismatch"] += 1
            return _invalid_result(query_idx, match_idx)
        result = self.verify_pairs_batch(
            np.asarray(image1)[None], np.asarray(image2)[None], K,
            indices=[(query_idx, match_idx)], uniforms=uniforms,
        )[0]
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
