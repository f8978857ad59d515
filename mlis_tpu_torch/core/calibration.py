"""Kalibr calibration parsing + per-SLAM-system config emission.

Counterpart of ``mlis_tpu/core/calibration.py``, kept as the port's own
copy over the port's ``ops/geometry``: Kalibr camera-chain YAML in,
configs out for ORB-SLAM3 (OpenCV-YAML), VINS-Fusion (YAML) and Basalt
(JSON), plus LeGO-LOAM sensor params, ``calibration_info`` and the
``sample_kalibr_yaml`` template. Each writer gives the JAX package's text
character for character.

Against the upstream converter, as in the JAX package:
  * Basalt T_imu_cam rotation is converted to a real quaternion;
  * Basalt's second camera carries the chained right-camera transform, not
    a copy of the first;
  * VINS body_T_cam1 is chained through the camera chain instead of being
    duplicated from cam0.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from mlis_tpu_torch.ops.geometry import matrix_to_quat, se3_inverse


@dataclass
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    distortion_model: str = "radtan"
    distortion_coeffs: List[float] = field(default_factory=list)

    @classmethod
    def from_kalibr(cls, cam: dict) -> "CameraIntrinsics":
        fx, fy, cx, cy = cam["intrinsics"]
        w, h = cam["resolution"]
        return cls(
            fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h,
            distortion_model=cam.get("distortion_model", "radtan"),
            distortion_coeffs=list(cam.get("distortion_coeffs", [0, 0, 0, 0])),
        )

    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]]
        )

    def dist4(self) -> List[float]:
        d = list(self.distortion_coeffs) + [0.0] * 4
        return d[:4]


@dataclass
class CameraExtrinsics:
    """T_cn_cnm1: transform from the previous camera in the Kalibr chain."""

    T: np.ndarray

    @classmethod
    def from_kalibr(cls, cam: dict) -> "CameraExtrinsics":
        return cls(T=np.asarray(cam["T_cn_cnm1"], dtype=np.float64))

    @classmethod
    def identity(cls) -> "CameraExtrinsics":
        return cls(T=np.eye(4))

    @property
    def rotation(self) -> np.ndarray:
        return self.T[:3, :3]

    @property
    def translation(self) -> np.ndarray:
        return self.T[:3, 3]

    def inverse(self) -> "CameraExtrinsics":
        return CameraExtrinsics(T=se3_inverse(self.T))


@dataclass
class IMUParams:
    gyro_noise_density: float
    gyro_random_walk: float
    accel_noise_density: float
    accel_random_walk: float
    rate_hz: float = 200.0

    @classmethod
    def from_kalibr(cls, imu: dict) -> "IMUParams":
        return cls(
            gyro_noise_density=imu.get("gyroscope_noise_density", 1e-4),
            gyro_random_walk=imu.get("gyroscope_random_walk", 1e-5),
            accel_noise_density=imu.get("accelerometer_noise_density", 1e-3),
            accel_random_walk=imu.get("accelerometer_random_walk", 1e-4),
            rate_hz=imu.get("update_rate", 200.0),
        )


CameraSet = Dict[str, Tuple[CameraIntrinsics, CameraExtrinsics]]


def _load_yaml(path) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def load_kalibr_cameras(yaml_path) -> CameraSet:
    """Kalibr multi-camera YAML -> {camN: (intrinsics, chain extrinsics)}."""
    data = _load_yaml(yaml_path)
    out: CameraSet = {}
    for key in sorted(k for k in data if k.startswith("cam")):
        cam = data[key]
        intr = CameraIntrinsics.from_kalibr(cam)
        extr = (
            CameraExtrinsics.from_kalibr(cam)
            if "T_cn_cnm1" in cam
            else CameraExtrinsics.identity()
        )
        out[key] = (intr, extr)
    return out


def load_camera_imu_calib(yaml_path) -> np.ndarray:
    """Kalibr camchain-imu YAML -> 4x4 T_cam_imu of cam0."""
    data = _load_yaml(yaml_path)
    return np.asarray(data["cam0"]["T_cam_imu"], dtype=np.float64)


def load_imu_params(yaml_path) -> IMUParams:
    data = _load_yaml(yaml_path)
    return IMUParams.from_kalibr(data.get("imu0", data))


def camera_to_cam0_transform(cameras: CameraSet, cam: str) -> np.ndarray:
    """T_cam_cam0 by composing the Kalibr chain up to `cam`.

    Kalibr's T_cn_cnm1 maps points in camera n-1 to camera n; missing chain
    entries are skipped (the ISEC chain indexes cameras sparsely).
    """
    idx = int(cam.replace("cam", ""))
    T = np.eye(4)
    for i in range(1, idx + 1):
        name = f"cam{i}"
        if name in cameras:
            T = cameras[name][1].T @ T
    return T


def stereo_transform(cameras: CameraSet, left: str, right: str) -> np.ndarray:
    """T_right_left between two chain cameras."""
    T_l = camera_to_cam0_transform(cameras, left)
    T_r = camera_to_cam0_transform(cameras, right)
    return T_r @ se3_inverse(T_l)


def compute_stereo_baseline(cameras: CameraSet, left: str, right: str) -> float:
    return float(np.linalg.norm(stereo_transform(cameras, left, right)[:3, 3]))


# -- emitters -----------------------------------------------------------------


def _write(text: str, output_path) -> str:
    if output_path:
        p = Path(output_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return text


def convert_to_orbslam3(
    cameras: CameraSet,
    left_cam: str = "cam1",
    right_cam: str = "cam3",
    output_path=None,
    fps: float = 20.0,
    n_features: int = 1500,
    enable_loop_closing: bool = False,
) -> str:
    """ORB-SLAM3 stereo OpenCV-YAML. Loop closing disabled by default (the
    benchmark measures raw odometry, reference behavior)."""
    li, _ = cameras[left_cam]
    ri, _ = cameras[right_cam]
    baseline = compute_stereo_baseline(cameras, left_cam, right_cam)
    ld, rd = li.dist4(), ri.dist4()

    lines = ["%YAML:1.0", ""]
    for tag, intr, dist in (("Camera1", li, ld), ("Camera2", ri, rd)):
        lines += [
            f'{tag}.type: "PinHole"',
            f"{tag}.fx: {intr.fx}",
            f"{tag}.fy: {intr.fy}",
            f"{tag}.cx: {intr.cx}",
            f"{tag}.cy: {intr.cy}",
            f"{tag}.k1: {dist[0]}",
            f"{tag}.k2: {dist[1]}",
            f"{tag}.p1: {dist[2]}",
            f"{tag}.p2: {dist[3]}",
            "",
        ]
    lines += [
        f"Camera.width: {li.width}",
        f"Camera.height: {li.height}",
        f"Camera.fps: {fps:g}",
        "Camera.RGB: 1",
        "",
        "Stereo.ThDepth: 40.0",
        f"Stereo.b: {baseline:.6f}",
        "",
        f"ORBextractor.nFeatures: {n_features}",
        "ORBextractor.scaleFactor: 1.2",
        "ORBextractor.nLevels: 8",
        "ORBextractor.iniThFAST: 20",
        "ORBextractor.minThFAST: 7",
        "",
        "Viewer.KeyFrameSize: 0.05",
        "Viewer.KeyFrameLineWidth: 1.0",
        "Viewer.GraphLineWidth: 0.9",
        "Viewer.PointSize: 2.0",
        "Viewer.CameraSize: 0.08",
        "Viewer.CameraLineWidth: 3.0",
        "Viewer.ViewpointX: 0.0",
        "Viewer.ViewpointY: -0.7",
        "Viewer.ViewpointZ: -1.8",
        "Viewer.ViewpointF: 500.0",
        "",
        f"LoopClosing.Enabled: {1 if enable_loop_closing else 0}",
        "",
    ]
    return _write("\n".join(lines), output_path)


def _opencv_matrix_yaml(name: str, T: np.ndarray) -> List[str]:
    flat = ", ".join(f"{v:.9f}" for v in np.asarray(T).ravel())
    return [
        f"{name}: !!opencv-matrix",
        "    rows: 4",
        "    cols: 4",
        "    dt: d",
        f"    data: [{flat}]",
        "",
    ]


def convert_to_vins_fusion(
    cameras: CameraSet,
    T_cam_imu: np.ndarray,
    imu_params: IMUParams,
    left_cam: str = "cam1",
    right_cam: str = "cam3",
    output_path=None,
    enable_loop_closure: bool = False,
) -> str:
    """VINS-Fusion stereo+IMU YAML with properly chained body_T_cam1."""
    li, _ = cameras[left_cam]
    ri, _ = cameras[right_cam]
    ld = li.dist4()

    # body(=imu) -> cameras: T_body_cam = inv(T_cam_imu) for cam0, then
    # chain the stereo transform for the right camera (fixes reference :443)
    T_body_cam0 = se3_inverse(np.asarray(T_cam_imu))
    T_right_left = stereo_transform(cameras, left_cam, right_cam)
    T_body_cam1 = T_body_cam0 @ se3_inverse(T_right_left)

    lines = [
        "%YAML:1.0",
        "",
        "imu: 1",
        "num_of_cam: 2",
        "",
        'imu_topic: "/vectornav/imu"',
        f'image0_topic: "/camera_array/{left_cam}/image_raw"',
        f'image1_topic: "/camera_array/{right_cam}/image_raw"',
        'output_path: "/results/vins_fusion"',
        "",
        "model_type: PINHOLE",
        "camera_name: camera",
        f"image_width: {li.width}",
        f"image_height: {li.height}",
        "",
        "distortion_parameters:",
        f"    k1: {ld[0]}",
        f"    k2: {ld[1]}",
        f"    p1: {ld[2]}",
        f"    p2: {ld[3]}",
        "projection_parameters:",
        f"    fx: {li.fx}",
        f"    fy: {li.fy}",
        f"    cx: {li.cx}",
        f"    cy: {li.cy}",
        "",
        "estimate_extrinsic: 0",
        "",
    ]
    lines += _opencv_matrix_yaml("body_T_cam0", T_body_cam0)
    lines += _opencv_matrix_yaml("body_T_cam1", T_body_cam1)
    lines += [
        f"acc_n: {imu_params.accel_noise_density}",
        f"gyr_n: {imu_params.gyro_noise_density}",
        f"acc_w: {imu_params.accel_random_walk}",
        f"gyr_w: {imu_params.gyro_random_walk}",
        "g_norm: 9.81007",
        "",
        "max_cnt: 150",
        "min_dist: 25",
        "freq: 10",
        "F_threshold: 1.0",
        "show_track: 0",
        "flow_back: 1",
        "",
        "max_solver_time: 0.04",
        "max_num_iterations: 8",
        "keyframe_parallax: 10.0",
        "",
        f"loop_closure: {1 if enable_loop_closure else 0}",
        "",
    ]
    return _write("\n".join(lines), output_path)


def convert_to_basalt(
    cameras: CameraSet,
    T_cam_imu: np.ndarray,
    imu_params: IMUParams,
    left_cam: str = "cam1",
    right_cam: str = "cam3",
    output_path=None,
) -> str:
    """Basalt JSON calibration with real quaternions and a chained second
    camera (fixes reference :536-541)."""

    def pose_entry(T: np.ndarray) -> dict:
        q = matrix_to_quat(T[:3, :3])
        return {
            "px": float(T[0, 3]),
            "py": float(T[1, 3]),
            "pz": float(T[2, 3]),
            "qx": float(q[0]),
            "qy": float(q[1]),
            "qz": float(q[2]),
            "qw": float(q[3]),
        }

    def intr_entry(intr: CameraIntrinsics) -> dict:
        return {
            "camera_type": "pinhole",
            "intrinsics": {
                "fx": intr.fx,
                "fy": intr.fy,
                "cx": intr.cx,
                "cy": intr.cy,
            },
            "resolution": [intr.width, intr.height],
        }

    li, _ = cameras[left_cam]
    ri, _ = cameras[right_cam]
    T_imu_cam0 = se3_inverse(np.asarray(T_cam_imu))
    T_right_left = stereo_transform(cameras, left_cam, right_cam)
    T_imu_cam1 = T_imu_cam0 @ se3_inverse(T_right_left)

    config = {
        "value0": {
            "T_imu_cam": [pose_entry(T_imu_cam0), pose_entry(T_imu_cam1)],
            "intrinsics": [intr_entry(li), intr_entry(ri)],
            "resolution": [[li.width, li.height], [ri.width, ri.height]],
            "imu_update_rate": imu_params.rate_hz,
            "gyro_noise_std": imu_params.gyro_noise_density,
            "accel_noise_std": imu_params.accel_noise_density,
            "gyro_bias_std": imu_params.gyro_random_walk,
            "accel_bias_std": imu_params.accel_random_walk,
        }
    }
    return _write(json.dumps(config, indent=2), output_path)


def convert_to_lego_loam(
    n_scan: int = 128,
    horizon_scan: int = 1024,
    ang_res_x: float = 0.3516,
    ang_res_y: float = 0.3543,
    ang_bottom: float = 22.5,
    ground_scan_ind: int = 30,
    lidar_topic: str = "/ouster/points",
    output_path=None,
) -> str:
    """LeGO-LOAM Ouster OS-128 sensor params (the values the reference
    sed-patches into utility.h, docker/Dockerfile.lego-loam:22-52)."""
    lines = [
        "# LeGO-LOAM sensor configuration (Ouster OS-128)",
        f'pointCloudTopic: "{lidar_topic}"',
        f"N_SCAN: {n_scan}",
        f"Horizon_SCAN: {horizon_scan}",
        f"ang_res_x: {ang_res_x}",
        f"ang_res_y: {ang_res_y}",
        f"ang_bottom: {ang_bottom}",
        f"groundScanInd: {ground_scan_ind}",
        "",
    ]
    return _write("\n".join(lines), output_path)


def calibration_info(cameras: CameraSet) -> str:
    """Human-readable inspection of a Kalibr camera set: per-camera
    intrinsics/distortion and all pairwise stereo baselines (the
    reference converter's `info` subcommand, calib_converter.py:720-814)."""
    lines = [f"Found {len(cameras)} cameras:"]
    for name, (intr, _) in cameras.items():
        lines += [
            f"",
            f"  {name}:",
            f"    Resolution: {intr.width}x{intr.height}",
            f"    Intrinsics: fx={intr.fx:.2f}, fy={intr.fy:.2f}, "
            f"cx={intr.cx:.2f}, cy={intr.cy:.2f}",
            f"    Distortion ({intr.distortion_model}): "
            f"{intr.distortion_coeffs}",
        ]
    names = sorted(cameras)
    if len(names) >= 2:
        lines += ["", "Stereo baselines:"]
        for i, c1 in enumerate(names):
            for c2 in names[i + 1:]:
                try:
                    b = compute_stereo_baseline(cameras, c1, c2)
                    lines.append(f"  {c1}-{c2}: {b:.4f}m")
                except Exception:
                    pass
    return "\n".join(lines)


def sample_kalibr_yaml(output_path=None) -> str:
    """A minimal NUFR-shaped Kalibr stereo chain, usable as a template for
    every converter in this module (`sample` subcommand parity)."""
    text = "\n".join(
        [
            "# Sample Kalibr camera-chain calibration (stereo pair)",
            "cam0:",
            "  camera_model: pinhole",
            "  intrinsics: [610.0, 610.5, 640.0, 400.0]",
            "  distortion_model: radtan",
            "  distortion_coeffs: [-0.02, 0.01, 0.0, 0.0]",
            "  resolution: [1280, 800]",
            "  rostopic: /camera_array/cam0/image_raw",
            "cam1:",
            "  camera_model: pinhole",
            "  intrinsics: [612.0, 612.4, 638.0, 402.0]",
            "  distortion_model: radtan",
            "  distortion_coeffs: [-0.021, 0.011, 0.0, 0.0]",
            "  resolution: [1280, 800]",
            "  rostopic: /camera_array/cam1/image_raw",
            "  T_cn_cnm1:",
            "  - [1.0, 0.0, 0.0, -0.164]",
            "  - [0.0, 1.0, 0.0, 0.0]",
            "  - [0.0, 0.0, 1.0, 0.0]",
            "  - [0.0, 0.0, 0.0, 1.0]",
            "",
        ]
    )
    return _write(text, output_path)
