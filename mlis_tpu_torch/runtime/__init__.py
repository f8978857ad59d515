"""Native host runtime: the C++ IO decodes behind ctypes, numpy fallbacks."""

from mlis_tpu_torch.runtime.native import (  # noqa: F401
    decode_pointcloud,
    native_available,
    parse_imu_batch,
    parse_odometry_batch,
    parse_tum_native,
)
