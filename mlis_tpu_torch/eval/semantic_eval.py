"""Loop-closure decision metrics, host only.

Counterpart of ``LoopClosureMetrics`` in ``mlis_tpu/eval/semantic_eval.py``
(the rest of that module, floor-detection and dynamic-filtering metrics
and the report parsers, is not ported yet). Every ratio returns 0 on an
empty denominator, except gating effectiveness, which is 1 when there
were no cross-floor candidates to reject.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LoopClosureMetrics:
    total_candidates: int = 0
    true_positives: int = 0
    false_positives: int = 0
    false_negatives: int = 0
    same_floor_candidates: int = 0
    cross_floor_candidates: int = 0
    cross_floor_rejected: int = 0

    @property
    def precision(self) -> float:
        d = self.true_positives + self.false_positives
        return self.true_positives / d if d else 0.0

    @property
    def recall(self) -> float:
        d = self.true_positives + self.false_negatives
        return self.true_positives / d if d else 0.0

    @property
    def f1_score(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0

    @property
    def cross_floor_rate(self) -> float:
        return self.cross_floor_candidates / self.total_candidates if self.total_candidates else 0.0

    @property
    def gating_effectiveness(self) -> float:
        if self.cross_floor_candidates == 0:
            return 1.0
        return self.cross_floor_rejected / self.cross_floor_candidates
