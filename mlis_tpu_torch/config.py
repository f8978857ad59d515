"""Pipeline configuration, as far as ``FullGatePipeline.from_config`` reads it.

The fields it reads, with the names and defaults of ``mlis_tpu/config.py``,
so that one configuration dict means the same thing to both packages;
``from_dict`` ignores the fields this package does not read.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class GateConfig:
    strict_mode: bool = True  # strict: reject any floor diff; loose: diff > 1


@dataclass
class GatingConfig:
    gate: GateConfig = field(default_factory=GateConfig)


@dataclass
class VPRConfig:
    method: str = "cricavpr"  # cricavpr | mixvpr are ported
    top_k: int = 10
    similarity_threshold: float = 0.5
    min_time_gap_s: float = 10.0


@dataclass
class VerificationConfig:
    matcher: str = "lightglue"
    max_keypoints: int = 2048
    ransac_threshold_px: float = 3.0
    min_inliers: int = 20
    min_inlier_ratio: float = 0.25


@dataclass
class PipelineConfig:
    gating: GatingConfig = field(default_factory=GatingConfig)
    vpr: VPRConfig = field(default_factory=VPRConfig)
    verification: VerificationConfig = field(default_factory=VerificationConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
        """Build from a (possibly larger) ``mlis_tpu`` config dict."""

        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                hints = typing.get_type_hints(tp)
                return tp(**{
                    f.name: build(hints[f.name], val[f.name])
                    for f in dataclasses.fields(tp)
                    if f.name in val
                })
            return val

        return build(cls, d)
