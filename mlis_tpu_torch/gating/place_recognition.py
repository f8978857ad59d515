"""Visual place recognition database and floor-gated retrieval settings.

Counterpart of ``mlis_tpu/gating/place_recognition.py`` as far as the full
gate needs it: a descriptor database filled through any encoder with
``encode_batch(images) -> (B, D)``, the ``PlaceMatch`` record the rerank
returns, and ``SemanticPlaceRecognition``, which builds a ported encoder:
MixVPR (its default, as in the JAX package) or CricaVPR (the default of
``FullGatePipeline``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np


@dataclass
class PlaceMatch:
    """A retrieval match."""

    query_idx: int
    match_idx: int
    similarity: float
    query_timestamp: Optional[float] = None
    match_timestamp: Optional[float] = None
    is_valid: bool = True


@dataclass
class PlaceDescriptor:
    timestamp: float
    descriptor: np.ndarray
    image_path: Optional[str] = None
    floor_label: Optional[int] = None


class BasePlaceRecognition:
    """Descriptor database; the encoder is any object with ``encode_batch``."""

    def __init__(self, descriptor_dim: int = 4096, encoder=None):
        self.descriptor_dim = descriptor_dim
        self.encoder = encoder
        self.descriptors: List[PlaceDescriptor] = []

    def extract_descriptors(self, images) -> np.ndarray:
        if self.encoder is None:
            raise NotImplementedError("no encoder attached")
        return np.asarray(self.encoder.encode_batch(images))

    def add_images_batch(
        self,
        images,
        timestamps: Sequence[float],
        floor_labels: Optional[Sequence[int]] = None,
        image_paths: Optional[Sequence[str]] = None,
    ) -> List[PlaceDescriptor]:
        out = []
        for i, d in enumerate(self.extract_descriptors(images)):
            pd = PlaceDescriptor(
                float(timestamps[i]),
                np.asarray(d),
                None if image_paths is None else image_paths[i],
                None if floor_labels is None else int(floor_labels[i]),
            )
            self.descriptors.append(pd)
            out.append(pd)
        return out

    def build_descriptor_matrix(self) -> np.ndarray:
        if not self.descriptors:
            return np.array([])
        return np.vstack([d.descriptor for d in self.descriptors]).astype(np.float32)

    def timestamps(self) -> np.ndarray:
        return np.asarray([d.timestamp for d in self.descriptors])


class SemanticPlaceRecognition:
    """Floor-gated VPR settings plus the encoder/database they use."""

    def __init__(
        self,
        vpr_method: Union[str, BasePlaceRecognition] = "mixvpr",
        similarity_threshold: float = 0.5,
        min_time_gap: float = 10.0,
        device="cuda",
        **encoder_kwargs,
    ):
        self.similarity_threshold = similarity_threshold
        self.min_time_gap = min_time_gap
        if isinstance(vpr_method, BasePlaceRecognition):
            self.vpr = vpr_method
        else:
            self.vpr = _build_vpr(vpr_method.lower(), device=device, **encoder_kwargs)

    def add_images_batch(self, images, timestamps, floor_labels, image_paths=None):
        return self.vpr.add_images_batch(images, timestamps, floor_labels, image_paths)


def _build_vpr(method: str, device="cuda", **kwargs) -> BasePlaceRecognition:
    if method == "mixvpr":
        from mlis_tpu_torch.models.mixvpr import MixVPR

        return MixVPR(device=device, **kwargs)
    if method == "cricavpr":
        from mlis_tpu_torch.models.cricavpr import CricaVPR

        return CricaVPR(device=device, **kwargs)
    raise ValueError(
        f"VPR method {method!r} is not ported to mlis_tpu_torch yet (available: mixvpr, cricavpr)"
    )
