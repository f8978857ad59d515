"""Visual place recognition database and floor-gated retrieval.

Counterpart of ``mlis_tpu/gating/place_recognition.py``:

* ``BasePlaceRecognition``: a descriptor database filled through any
  encoder with ``encode_batch(images) -> (B, D)``, cosine top-k queries
  with the temporal mask, the pairwise similarity matrix, and npz
  persistence under the reference's keys (``descriptors``, ``timestamps``,
  ``floors``, ``paths``; an unknown floor is stored as -10^9), so each
  package reads the other's files;
* ``SemanticPlaceRecognition``: ``find_loop_closures`` (every frame
  against the database, the CricaVPR patch-correlation rerank mixed in
  with a stable re-sort, the similarity threshold and the per-match floor
  validity flag) and ``get_statistics``;
* ``_build_vpr`` for the four encoders of the reference's menu (MixVPR,
  SALAD, AnyLoc, CricaVPR) and ``process_image_sequence``.

Retrieval runs on ``device`` (the encoder's, for an encoder database);
descriptors are kept on the host as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mlis_tpu_torch.ops.knn import cosine_topk, pairwise_similarity

NO_FLOOR = -(10**9)  # the floor label stored for "unknown"


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

    def __init__(self, descriptor_dim: int = 4096, encoder=None, device="cuda"):
        self.descriptor_dim = descriptor_dim
        self.encoder = encoder
        self.device = torch.device(device)
        self.descriptors: List[PlaceDescriptor] = []
        self._matrix_cache: Optional[np.ndarray] = None

    # -- extraction -------------------------------------------------------------
    def extract_descriptor(self, image: np.ndarray) -> np.ndarray:
        return self.extract_descriptors(np.asarray(image)[None])[0]

    def extract_descriptors(self, images) -> np.ndarray:
        if self.encoder is None:
            raise NotImplementedError("no encoder attached")
        return np.asarray(self.encoder.encode_batch(images))

    # -- database -----------------------------------------------------------------
    def add_image(self, image: np.ndarray, timestamp: float, floor_label: Optional[int] = None,
                  image_path: Optional[str] = None) -> PlaceDescriptor:
        return self.add_descriptor(self.extract_descriptor(image), timestamp, floor_label,
                                   image_path)

    def add_images_batch(
        self,
        images,
        timestamps: Sequence[float],
        floor_labels: Optional[Sequence[int]] = None,
        image_paths: Optional[Sequence[str]] = None,
    ) -> List[PlaceDescriptor]:
        return [
            self.add_descriptor(d, float(timestamps[i]),
                                None if floor_labels is None else int(floor_labels[i]),
                                None if image_paths is None else image_paths[i])
            for i, d in enumerate(self.extract_descriptors(images))
        ]

    def add_descriptor(self, descriptor: np.ndarray, timestamp: float,
                       floor_label: Optional[int] = None,
                       image_path: Optional[str] = None) -> PlaceDescriptor:
        pd = PlaceDescriptor(timestamp, np.asarray(descriptor), image_path, floor_label)
        self.descriptors.append(pd)
        self._matrix_cache = None
        return pd

    def build_descriptor_matrix(self) -> np.ndarray:
        if not self.descriptors:
            return np.array([])
        if self._matrix_cache is None or len(self._matrix_cache) != len(self.descriptors):
            self._matrix_cache = np.vstack([d.descriptor for d in self.descriptors]).astype(
                np.float32)
        return self._matrix_cache

    def timestamps(self) -> np.ndarray:
        return np.asarray([d.timestamp for d in self.descriptors])

    def floor_labels(self) -> np.ndarray:
        return np.asarray([NO_FLOOR if d.floor_label is None else d.floor_label
                           for d in self.descriptors])

    # -- retrieval ------------------------------------------------------------------
    def _on_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    def query(self, image: np.ndarray, timestamp: Optional[float] = None, k: int = 5,
              min_time_gap: float = 10.0) -> List[PlaceMatch]:
        """The database's top ``k`` matches for one image, temporal
        neighbours of ``timestamp`` masked when it is given."""
        if not self.descriptors:
            return []
        q = self.extract_descriptor(image)[None].astype(np.float32)
        timed = timestamp is not None
        scores, idx = cosine_topk(
            self._on_device(q), self._on_device(self.build_descriptor_matrix()),
            self._on_device(np.asarray([timestamp], np.float32)) if timed else None,
            self._on_device(self.timestamps().astype(np.float32)) if timed else None,
            k=min(k, len(self.descriptors)), min_time_gap=min_time_gap)
        matches = []
        for s, j in zip(scores[0].cpu().numpy(), idx[0].cpu().numpy()):
            if np.isfinite(s):
                matches.append(PlaceMatch(len(self.descriptors), int(j), float(s), timestamp,
                                          self.descriptors[int(j)].timestamp))
        return matches

    def compute_all_pairwise_similarities(self) -> np.ndarray:
        m = self.build_descriptor_matrix()
        if len(m) == 0:
            return np.array([])
        return pairwise_similarity(self._on_device(m)).cpu().numpy()

    # -- persistence --------------------------------------------------------------
    def save_database(self, path) -> None:
        """The database (descriptors, timestamps, floors, paths) as one npz."""
        m = self.build_descriptor_matrix()
        np.savez_compressed(
            Path(path),
            descriptors=m if len(m) else np.zeros((0, self.descriptor_dim)),
            timestamps=self.timestamps(),
            floors=self.floor_labels(),
            paths=np.asarray([d.image_path or "" for d in self.descriptors], dtype=object),
        )

    def load_database(self, path) -> int:
        """Replace the database with a saved one; returns its size."""
        data = np.load(path, allow_pickle=True)
        self.descriptors = []
        self._matrix_cache = None
        floors, paths = data["floors"], data["paths"]
        for i, (d, t) in enumerate(zip(data["descriptors"], data["timestamps"])):
            self.add_descriptor(d, float(t), None if floors[i] <= NO_FLOOR else int(floors[i]),
                                str(paths[i]) or None)
        return len(self.descriptors)


class SemanticPlaceRecognition:
    """Floor-gated VPR: the encoder database plus the retrieval settings."""

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

    def add_image(self, image: np.ndarray, timestamp: float, floor_label: int,
                  image_path: Optional[str] = None) -> PlaceDescriptor:
        return self.vpr.add_image(image, timestamp, floor_label, image_path)

    def add_images_batch(self, images, timestamps, floor_labels, image_paths=None):
        return self.vpr.add_images_batch(images, timestamps, floor_labels, image_paths)

    def find_loop_closures(self, enable_floor_gating: bool = True, k: int = 10,
                           rerank: bool = True) -> List[PlaceMatch]:
        """Every frame against the database, best first per query. With an
        encoder that reranks (CricaVPR, its patch cache filled for every
        entry), each query's candidates are re-scored as (1 - w) cosine + w
        patch correlation and stably re-sorted before the threshold."""
        vpr = self.vpr
        n = len(vpr.descriptors)
        if n < 2:
            return []
        db = vpr._on_device(vpr.build_descriptor_matrix())
        times = vpr._on_device(vpr.timestamps().astype(np.float32))
        scores, idx = cosine_topk(db, db, times, times, k=min(k, n),
                                  min_time_gap=self.min_time_gap)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        floors = vpr.floor_labels()
        ts = vpr.timestamps()
        # a database filled by add_descriptor has no patch features to correlate
        if (rerank and hasattr(vpr, "rerank_scores_all") and getattr(vpr, "use_reranking", False)
                and len(getattr(vpr, "patch_cache", ())) >= n):
            cc = vpr.rerank_scores_all(np.arange(n, dtype=np.int32), np.clip(idx, 0, n - 1))
            w = vpr.rerank_weight
            mixed = np.where(np.isfinite(scores), (1 - w) * scores + w * cc, -np.inf)
            order = np.argsort(-mixed, axis=1, kind="stable")
            scores = np.take_along_axis(mixed, order, axis=1)
            idx = np.take_along_axis(idx, order, axis=1)

        # row-major nonzero keeps each query's matches best first
        qi, kk = np.nonzero(np.isfinite(scores) & (scores >= self.similarity_threshold))
        mj = idx[qi, kk]
        sim = scores[qi, kk]
        valid = np.ones(len(qi), dtype=bool)
        if enable_floor_gating:
            qf, mf = floors[qi], floors[mj]
            valid = np.where((qf > NO_FLOOR) & (mf > NO_FLOOR), qf == mf, True)
        return [PlaceMatch(int(qi[p]), int(mj[p]), float(sim[p]), float(ts[qi[p]]),
                           float(ts[mj[p]]), bool(valid[p])) for p in range(len(qi))]

    def get_statistics(self, matches: List[PlaceMatch]) -> Dict:
        if not matches:
            return {"total_matches": 0, "valid_matches": 0, "rejected_matches": 0,
                    "rejection_rate": 0.0}
        valid = sum(1 for m in matches if m.is_valid)
        rejected = len(matches) - valid
        return {
            "total_matches": len(matches),
            "valid_matches": valid,
            "rejected_matches": rejected,
            "rejection_rate": rejected / len(matches),
            "mean_similarity": float(np.mean([m.similarity for m in matches])),
            "mean_valid_similarity": float(np.mean([m.similarity for m in matches
                                                    if m.is_valid])) if valid else 0.0,
        }


def _build_vpr(method: str, device="cuda", **kwargs) -> BasePlaceRecognition:
    if method == "mixvpr":
        from mlis_tpu_torch.models.mixvpr import MixVPR

        return MixVPR(device=device, **kwargs)
    if method == "salad":
        from mlis_tpu_torch.models.salad import SALAD

        return SALAD(device=device, **kwargs)
    if method == "anyloc":
        from mlis_tpu_torch.models.anyloc import AnyLoc

        return AnyLoc(device=device, **kwargs)
    if method == "cricavpr":
        from mlis_tpu_torch.models.cricavpr import CricaVPR

        return CricaVPR(device=device, **kwargs)
    raise ValueError(f"Unknown VPR method: {method}. Available: mixvpr, salad, anyloc, cricavpr")


def process_image_sequence(
    images: Union[np.ndarray, Sequence[np.ndarray]],
    timestamps: np.ndarray,
    floor_labels: np.ndarray,
    vpr_method: str = "mixvpr",
    batch_size: int = 32,
    device="cuda",
    **encoder_kwargs,
) -> Tuple[SemanticPlaceRecognition, List[PlaceMatch]]:
    """Encode a sequence in batches, then find its floor-gated loop closures."""
    spr = SemanticPlaceRecognition(vpr_method=vpr_method, device=device, **encoder_kwargs)
    n = min(len(images), len(timestamps), len(floor_labels))
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        batch = np.stack([np.asarray(images[i]) for i in range(s, e)])
        spr.add_images_batch(batch, timestamps[s:e], floor_labels[s:e])
    return spr, spr.find_loop_closures(enable_floor_gating=True)
