"""Semantic loop-closure gate: floor-consistency filtering on tensors.

Counterpart of ``mlis_tpu/gating/gate.py``: the vectorised mask, the
stateful gate with its statistics and per-candidate API, the ORB-SLAM3
patch and the factor-graph constraint emitters. Strict mode rejects any
candidate whose endpoints carry different floor labels; loose mode
rejects only a floor difference above 1. The statistics are total /
accepted / rejected_cross_floor / acceptance_rate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


@dataclass
class LoopClosureCandidate:
    """One gated loop-closure candidate."""

    query_idx: int
    match_idx: int
    similarity_score: float
    query_floor: int
    match_floor: int
    is_valid: bool = True
    rejection_reason: str = ""


def gate_mask(
    floor_labels: torch.Tensor,  # (N,) int
    query_idx: torch.Tensor,  # (M,) int
    match_idx: torch.Tensor,  # (M,) int
    strict: bool = True,
) -> torch.Tensor:
    """(M,) bool: True where the candidate passes the floor gate."""
    diff = (floor_labels[query_idx] - floor_labels[match_idx]).abs()
    return diff == 0 if strict else diff <= 1


class SemanticLoopClosureGate:
    """Stateful gate that accumulates statistics across batches."""

    def __init__(self, floor_labels, strict_mode: bool = True, device="cuda"):
        self.floor_labels = np.asarray(floor_labels)
        self.strict_mode = strict_mode
        self.device = torch.device(device)
        self._labels_t = torch.as_tensor(self.floor_labels.astype(np.int64), device=self.device)
        self.stats: Dict[str, float] = {
            "total_candidates": 0,
            "accepted": 0,
            "rejected_cross_floor": 0,
            "rejected_other": 0,
        }

    def gate_batch(self, query_idx, match_idx) -> np.ndarray:
        """Gate a batch of candidates; updates the statistics; returns the mask."""
        q = torch.as_tensor(np.asarray(query_idx, np.int64), device=self.device)
        m = torch.as_tensor(np.asarray(match_idx, np.int64), device=self.device)
        mask = gate_mask(self._labels_t, q, m, self.strict_mode).cpu().numpy()
        n, acc = int(mask.shape[0]), int(mask.sum())
        self.stats["total_candidates"] += n
        self.stats["accepted"] += acc
        self.stats["rejected_cross_floor"] += n - acc
        return mask

    def _reason(self, qf: int, mf: int) -> str:
        return f"Cross-floor: {qf} vs {mf}" if self.strict_mode else f"Floor diff > 1: {qf} vs {mf}"

    def gate_candidate(
        self, query_idx: int, match_idx: int, similarity_score: float = 0.0
    ) -> LoopClosureCandidate:
        """Gate one candidate on the host; updates the statistics."""
        qf = int(self.floor_labels[query_idx])
        mf = int(self.floor_labels[match_idx])
        diff = abs(qf - mf)
        rejected = diff > 0 if self.strict_mode else diff > 1
        c = LoopClosureCandidate(query_idx, match_idx, similarity_score, qf, mf)
        self.stats["total_candidates"] += 1
        if rejected:
            c.is_valid = False
            c.rejection_reason = self._reason(qf, mf)
            self.stats["rejected_cross_floor"] += 1
        else:
            self.stats["accepted"] += 1
        return c

    def gate_candidates(
        self, candidates: Sequence[Tuple[int, int, float]]
    ) -> Tuple[List[LoopClosureCandidate], List[LoopClosureCandidate]]:
        """(valid, rejected) candidates; the mask comes from one
        :meth:`gate_batch` on the gate's device."""
        if len(candidates) == 0:
            return [], []
        arr = np.asarray([(q, m) for q, m, _ in candidates], dtype=np.int64)
        mask = self.gate_batch(arr[:, 0], arr[:, 1])
        valid, rejected = [], []
        for (q, m, s), ok in zip(candidates, mask):
            qf = int(self.floor_labels[q])
            mf = int(self.floor_labels[m])
            c = LoopClosureCandidate(int(q), int(m), float(s), qf, mf, bool(ok))
            if ok:
                valid.append(c)
            else:
                c.rejection_reason = self._reason(qf, mf)
                rejected.append(c)
        return valid, rejected

    def get_stats(self) -> Dict:
        total = self.stats["total_candidates"]
        if total > 0:
            self.stats["acceptance_rate"] = self.stats["accepted"] / total
            self.stats["rejection_rate"] = 1 - self.stats["acceptance_rate"]
        return self.stats

    def print_summary(self) -> None:
        stats = self.get_stats()
        print("\n" + "=" * 50)
        print("LOOP CLOSURE GATING SUMMARY")
        print("=" * 50)
        print(f"Total candidates:      {stats['total_candidates']}")
        print(f"Accepted:              {stats['accepted']}")
        print(f"Rejected (cross-floor): {stats['rejected_cross_floor']}")
        if total := stats["total_candidates"]:
            print(f"Acceptance rate:       {stats['accepted'] / total:.1%}")
            print(f"Perceptual aliasing prevented: {stats['rejected_cross_floor']}")
        print("=" * 50)


def generate_orbslam3_patch(function_name: str = "CheckFloorConsistency") -> str:
    """The C++ floor-consistency hook for ORB-SLAM3's LoopClosing.cc: a
    strict keyframe floor check before ComputeSim3."""
    return f"""\
// Floor-consistency gate for ORB-SLAM3 loop closing.
// Insert into src/LoopClosing.cc; call after DBoW2 candidate retrieval and
// before ComputeSim3(). KeyFrames must carry an mnFloorLabel member filled
// from the IMU floor detector during tracking.

bool LoopClosing::{function_name}(KeyFrame* pQuery, KeyFrame* pCandidate)
{{
    const int queryFloor = pQuery->mnFloorLabel;
    const int matchFloor = pCandidate->mnFloorLabel;
    if (queryFloor != matchFloor) {{
        // strict mode: any floor difference is perceptual aliasing
        return false;
    }}
    return true;
}}

// In DetectLoop(), filter the DBoW2 candidates:
//   vector<KeyFrame*> vpValid;
//   for (KeyFrame* pKF : vpCandidateKFs)
//       if ({function_name}(mpCurrentKF, pKF)) vpValid.push_back(pKF);
//   // continue geometric verification with vpValid only
"""


class ContextualPriorFactor:
    """Factor-graph constraints from floor labels: the per-pose z-prior
    arrays at once, and one dict per factor."""

    def __init__(self, floor_labels):
        self.floor_labels = np.asarray(floor_labels)

    def floor_priors(self, floor_height: float = 3.0, sigma_z: float = 0.5):
        """(expected_z (N,), sigma_z (N,)) arrays for all poses at once."""
        expected_z = self.floor_labels.astype(np.float64) * floor_height
        return expected_z, np.full_like(expected_z, sigma_z)

    def create_floor_constraint(self, pose_idx: int, floor_height: float = 3.0) -> Dict:
        floor = int(self.floor_labels[pose_idx])
        return {
            "type": "floor_prior",
            "pose_idx": pose_idx,
            "floor": floor,
            "expected_z": floor * floor_height,
            "noise_model": "diagonal",
            "sigma_z": 0.5,
        }

    def create_elevator_transition_factor(
        self, pose_before: int, pose_after: int, direction: str, floor_height: float = 3.0
    ) -> Dict:
        return {
            "type": "elevator_transition",
            "pose_before": pose_before,
            "pose_after": pose_after,
            "expected_dz": floor_height if direction == "up" else -floor_height,
            "noise_model": "diagonal",
            "sigma_dz": 0.3,
        }
