"""Semantic loop-closure gate: floor-consistency filtering on tensors.

Counterpart of ``mlis_tpu/gating/gate.py`` (the vectorised mask, the
batch gate with its statistics, and the floor z-priors; the per-candidate
reporting API is not ported). Strict mode rejects any candidate whose
endpoints carry different floor labels; loose mode rejects only a floor
difference above 1. The statistics are total / accepted /
rejected_cross_floor / acceptance_rate.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


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

    def get_stats(self) -> Dict:
        total = self.stats["total_candidates"]
        if total > 0:
            self.stats["acceptance_rate"] = self.stats["accepted"] / total
            self.stats["rejection_rate"] = 1 - self.stats["acceptance_rate"]
        return self.stats


class ContextualPriorFactor:
    """Per-pose floor z-priors for a factor graph."""

    def __init__(self, floor_labels):
        self.floor_labels = np.asarray(floor_labels)

    def floor_priors(self, floor_height: float = 3.0, sigma_z: float = 0.5):
        """(expected_z (N,), sigma_z (N,)) arrays for all poses at once."""
        expected_z = self.floor_labels.astype(np.float64) * floor_height
        return expected_z, np.full_like(expected_z, sigma_z)
