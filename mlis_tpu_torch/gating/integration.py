"""Candidate sweep + floor gate analysis, as the ``gate`` CLI drives it.

Counterpart of ``SemanticIntegration.analyze`` in
``mlis_tpu/gating/integration.py``: the exact all-pairs sweep with its floor
split, the statistics loaded into a strict gate, and optional example
cross-floor pairs. Loading trajectories is not part of this module; the
caller passes the combined positions and floor labels.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from mlis_tpu_torch.gating.gate import SemanticLoopClosureGate
from mlis_tpu_torch.ops.pairwise import candidate_counts, candidate_pairs_host


@dataclass
class LoopClosureAnalysis:
    """Candidate statistics after floor gating."""

    total_candidates: int = 0
    same_floor_candidates: int = 0
    cross_floor_candidates: int = 0
    elapsed_s: float = 0.0
    example_cross_floor_pairs: List[Tuple[int, int, int, int]] = field(default_factory=list)

    @property
    def cross_floor_rate(self) -> float:
        return (
            self.cross_floor_candidates / self.total_candidates
            if self.total_candidates
            else 0.0
        )


def analyze(
    positions: np.ndarray,  # (N, 3) float64
    floor_labels: np.ndarray,  # (N,)
    distance_threshold: float = 2.0,
    min_time_gap: int = 100,
    with_examples: bool = False,
    device="cuda",
) -> Tuple[LoopClosureAnalysis, SemanticLoopClosureGate]:
    """Run the candidate sweep and the floor gate; counts are float64-exact."""
    t0 = time.perf_counter()
    total, same, cross = candidate_counts(
        positions, floor_labels, radius=distance_threshold, min_gap=min_time_gap,
        device=device,
    )
    analysis = LoopClosureAnalysis(total, same, cross, time.perf_counter() - t0)

    gate = SemanticLoopClosureGate(floor_labels, strict_mode=True, device=device)
    gate.stats["total_candidates"] = total
    gate.stats["accepted"] = same
    gate.stats["rejected_cross_floor"] = cross

    if with_examples:
        fl = np.asarray(floor_labels)
        qi, mi, _ = candidate_pairs_host(
            positions[:4096], fl[:4096], radius=distance_threshold, min_gap=min_time_gap
        )
        for q, m in zip(qi, mi):
            if fl[q] != fl[m]:
                analysis.example_cross_floor_pairs.append(
                    (int(q), int(m), int(fl[q]), int(fl[m]))
                )
            if len(analysis.example_cross_floor_pairs) >= 5:
                break
    return analysis, gate
