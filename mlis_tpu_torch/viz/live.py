"""Live-visualization layout generation (Foxglove Studio).

Counterpart of ``mlis_tpu/viz/live.py``, kept as the port's own copy:
Studio layouts for watching a SLAM run live (LiDAR point cloud +
trajectory for LeGO-LOAM, stereo feeds + position plots for ORB-SLAM3)
generated over the NUFR-M3F topic map, plus a semantic-gating monitor
layout (floor label + gate decision streams).

Layouts are plain dicts in Foxglove's layout schema; `save_layout` writes
the importable JSON.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

# NUFR-M3F topic map (SURVEY §L1; bag_utils.py:55-65)
TOPICS = {
    "lidar": "/ouster/points",
    "imu": "/vectornav/imu",
    "cam_left": "/camera_array/cam1/image_raw",
    "cam_right": "/camera_array/cam3/image_raw",
}
ODOM_TOPICS = {
    "lego_loam": "/aft_mapped_to_init",
    "orb_slam3": "/orb_slam3/odometry",
    "droid_slam": "/droid_slam/odometry",
}


def _3d_panel(
    follow_frame: str,
    topics: Dict[str, Dict],
    distance: float = 50.0,
) -> Dict:
    return {
        "id": "3D",
        "title": "3D View",
        "config": {
            "followTf": follow_frame,
            "scene": {"enableStats": False, "backgroundColor": "#10121a"},
            "cameraState": {
                "perspective": True,
                "distance": distance,
                "phi": 55,
                "thetaOffset": 40,
                "fovy": 45,
                "near": 0.5,
                "far": 5000,
            },
            "topics": topics,
        },
    }


def _plot_panel(title: str, paths: List[str]) -> Dict:
    return {
        "id": f"Plot.{title}",
        "title": title,
        "config": {
            "paths": [
                {"value": p, "enabled": True, "timestampMethod": "receiveTime"}
                for p in paths
            ],
            "showLegend": True,
            "xAxisVal": "timestamp",
        },
    }


def _image_panel(topic: str, title: str) -> Dict:
    return {
        "id": f"Image.{title}",
        "title": title,
        "config": {"cameraTopic": topic, "synchronize": True},
    }


def _layout(first, second=None, direction="row", ratio=0.6) -> Dict:
    node = {"direction": direction, "first": first}
    if second is not None:
        node["second"] = second
        node["splitPercentage"] = int(ratio * 100)
    return node


def _tabs(*panels: Dict) -> Dict:
    return {"activeTabId": panels[0]["id"], "tabs": list(panels)}


def lego_loam_layout() -> Dict:
    """LiDAR SLAM monitor: OS-128 cloud (intensity turbo colormap) +
    growing trajectory, with robot-height / floor plots alongside."""
    odom = ODOM_TOPICS["lego_loam"]
    three_d = _3d_panel(
        "base_link",
        {
            TOPICS["lidar"]: {
                "visible": True,
                "pointSize": 2,
                "colorMode": "colormap",
                "colorField": "intensity",
                "colorMap": "turbo",
            },
            odom: {"visible": True, "type": "trajectory", "lineWidth": 2},
        },
    )
    plots = _tabs(
        _plot_panel("Height", [f"{odom}.pose.pose.position.z"]),
        _plot_panel(
            "Position",
            [f"{odom}.pose.pose.position.{a}" for a in "xyz"],
        ),
    )
    return _wrap(_layout(_tabs(three_d), plots, "row", 0.65))


def orb_slam3_layout() -> Dict:
    """Stereo visual SLAM monitor: cam1/cam3 feeds + trajectory plots."""
    odom = ODOM_TOPICS["orb_slam3"]
    cams = _layout(
        _tabs(_image_panel(TOPICS["cam_left"], "cam1 (left)")),
        _tabs(_image_panel(TOPICS["cam_right"], "cam3 (right)")),
        "column",
        0.5,
    )
    plots = _tabs(
        _plot_panel(
            "Position",
            [f"{odom}.pose.pose.position.{a}" for a in "xyz"],
        ),
        _plot_panel("IMU z-accel", [f"{TOPICS['imu']}.linear_acceleration.z"]),
    )
    return _wrap(_layout(cams, plots, "row", 0.55))


def gating_monitor_layout(algorithm: str = "lego_loam") -> Dict:
    """Semantic-gate monitor (new in this framework): current floor
    label, elevator detection signal, and gate accept/reject streams next
    to the 3D view — what an operator needs to watch the gate live."""
    odom = ODOM_TOPICS.get(algorithm, ODOM_TOPICS["lego_loam"])
    three_d = _3d_panel(
        "base_link",
        {odom: {"visible": True, "type": "trajectory", "lineWidth": 2}},
        distance=80.0,
    )
    gate_plots = _tabs(
        _plot_panel("Floor label", ["/mlis/floor_label.data"]),
        _plot_panel(
            "Elevator signal",
            [f"{TOPICS['imu']}.linear_acceleration.z"],
        ),
        _plot_panel(
            "Gate decisions",
            ["/mlis/gate/accepted.data", "/mlis/gate/rejected_cross_floor.data"],
        ),
    )
    return _wrap(_layout(_tabs(three_d), gate_plots, "row", 0.6))


def _wrap(layout_node: Dict) -> Dict:
    return {
        "configById": {},
        "globalVariables": {},
        "userNodes": {},
        "linkedGlobalVariables": [],
        "playbackConfig": {"speed": 1},
        "layout": layout_node,
    }


LAYOUTS = {
    "lego_loam": lego_loam_layout,
    "orb_slam3": orb_slam3_layout,
    "gating_monitor": gating_monitor_layout,
}


def save_layout(name: str, path: str, algorithm: Optional[str] = None) -> Dict:
    """Generate layout `name` and write importable Foxglove JSON."""
    if name not in LAYOUTS:
        raise ValueError(f"unknown layout {name!r}; have {sorted(LAYOUTS)}")
    fn = LAYOUTS[name]
    layout = fn(algorithm) if name == "gating_monitor" and algorithm else fn()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(layout, indent=2))
    return layout
