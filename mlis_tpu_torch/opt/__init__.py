"""Factor-graph optimisation on the device (pose graphs)."""

from mlis_tpu_torch.opt.pose_graph import (  # noqa: F401
    PoseGraphFactors,
    build_factors,
    optimize_pose_graph,
)
