"""PyTorch/CUDA port of mlis_tpu for an NVIDIA H100.

The package mirrors ``mlis_tpu``'s layout (``core/``, ``ops/``,
``models/``, ``gating/``, ``eval/``, ``opt/``, ``parallel/``, ``train/``,
``runtime/``, ``utils/``, ``viz/``) and imports neither JAX nor anything
of ``mlis_tpu``. Plain tensor code is PyTorch; each kernel that
``mlis_tpu`` wrote in Pallas is a hand-written CUDA kernel under
``csrc/``, built on first use by :mod:`mlis_tpu_torch._build`. Entry
points take a ``device`` argument that defaults to ``"cuda"``; on CPU
tensors each kernel wrapper runs its plain PyTorch version.

The public API is ``mlis_tpu``'s: the two configs, and the classes below,
imported on first attribute access so that ``import mlis_tpu_torch`` stays
light.
"""

__version__ = "0.1.0"

from mlis_tpu_torch.config import GatingConfig, PipelineConfig  # noqa: F401

_LAZY = {
    # floor detection
    "IMUFloorDetector": "mlis_tpu_torch.gating.floor_detector",
    "ElevatorEvent": "mlis_tpu_torch.gating.floor_detector",
    "LiDARFloorTracker": "mlis_tpu_torch.gating.lidar_floor_tracker",
    "FloorEstimate": "mlis_tpu_torch.gating.lidar_floor_tracker",
    "MultiModalFloorDetector": "mlis_tpu_torch.gating.fusion",
    # gate
    "SemanticLoopClosureGate": "mlis_tpu_torch.gating.gate",
    "LoopClosureCandidate": "mlis_tpu_torch.gating.gate",
    "ContextualPriorFactor": "mlis_tpu_torch.gating.gate",
    # pipeline + integrations
    "SemanticGatingPipeline": "mlis_tpu_torch.gating.pipeline",
    "StreamingGate": "mlis_tpu_torch.gating.streaming",
    "StreamingMatches": "mlis_tpu_torch.gating.streaming",
    "ORBSlam3SemanticIntegration": "mlis_tpu_torch.gating.integration",
    "DroidSlamSemanticIntegration": "mlis_tpu_torch.gating.integration",
    "LegoLoamSemanticIntegration": "mlis_tpu_torch.gating.integration",
    # VPR
    "BasePlaceRecognition": "mlis_tpu_torch.gating.place_recognition",
    "PlaceMatch": "mlis_tpu_torch.gating.place_recognition",
    "PlaceDescriptor": "mlis_tpu_torch.gating.place_recognition",
    "SemanticPlaceRecognition": "mlis_tpu_torch.gating.place_recognition",
    "MixVPR": "mlis_tpu_torch.models.mixvpr",
    "SALAD": "mlis_tpu_torch.models.salad",
    "AnyLoc": "mlis_tpu_torch.models.anyloc",
    "CricaVPR": "mlis_tpu_torch.models.cricavpr",
    # geometric verification
    "BaseFeatureMatcher": "mlis_tpu_torch.gating.verification",
    "MatchResult": "mlis_tpu_torch.gating.verification",
    "LightGlue": "mlis_tpu_torch.models.lightglue",
    "SuperGlue": "mlis_tpu_torch.models.lightglue",
    "LoFTR": "mlis_tpu_torch.models.loftr",
    "GeometricVerifier": "mlis_tpu_torch.gating.verification",
    "SemanticGeometricVerifier": "mlis_tpu_torch.gating.verification",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'mlis_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
