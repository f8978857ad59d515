from mlis_tpu_torch.eval.alignment import (  # noqa: F401
    umeyama,
    kabsch_sim3_legacy,
    apply_sim3,
    align_se3,
    align_sim3,
)
from mlis_tpu_torch.eval.association import associate_by_time, normalize_timestamps  # noqa: F401
from mlis_tpu_torch.eval.metrics import (  # noqa: F401
    compute_ate,
    compute_rpe,
    compute_rotation_error,
    compute_segment_metrics,
    compute_error_at_distances,
    analyze_problem_regions,
    analyze_tracking_quality,
    compute_trajectory_smoothness,
    is_valid_trajectory,
)
from mlis_tpu_torch.eval.comprehensive import (  # noqa: F401
    evaluate_algorithm_floor,
    run_full_evaluation,
)
