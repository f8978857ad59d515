"""IMU elevator-event floor detection on tensors.

Counterpart of ``mlis_tpu/gating/floor_detector.py``:
  * median-detrend the z acceleration, mean-filter (window 50) the
    detrended z and the horizontal energy ax^2 + ay^2;
  * elevator mask = |az_smooth| > 0.5 AND horiz_var < 1.0;
  * contiguous mask runs that END inside the stream and last >= 2 s are
    events (a run still active at the last sample is not one: falling edge
    only);
  * direction = sign of the trapezoidal integral of az_smooth over the run;
  * floor labels walk the events from start_floor; poses whose time falls
    inside an event's [start, end) window get label 0 ("in the elevator").

The signal path runs on the caller's device in float32 relative time, and
event extraction returns fixed-size padded tensors, which the detector
brings to the host in one copy per call. The median of an even-length
stream averages the two middle samples, as ``jnp.median`` does
(``torch.median`` would return the lower one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from mlis_tpu_torch.ops.filters import cumtrapz, uniform_filter1d


@dataclass
class ElevatorEvent:
    """One detected elevator ride."""

    start_time: float
    end_time: float
    duration: float
    direction: str  # 'up' or 'down'
    start_idx: int
    end_idx: int
    floor_change: int  # +1 up, -1 down


def median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor; for even N, (lower + upper middle) * 0.5."""
    s = torch.sort(x).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def detect_elevator_events_padded(
    timestamps: torch.Tensor,  # (N,) float32 relative time
    accel_x: torch.Tensor,
    accel_y: torch.Tensor,
    accel_z: torch.Tensor,
    z_accel_threshold: float = 0.5,
    min_duration: float = 2.0,
    window_size: int = 50,
    horizontal_var_threshold: float = 1.0,
    max_events: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Event extraction with fixed shapes, on the inputs' device.

    Returns (n_events, start_idx (max_events,), end_idx, z_integral) where
    entries beyond n_events are padding (-1 indices, 0 integral)."""
    az_det = accel_z - median_midpoint(accel_z)
    az_smooth = uniform_filter1d(az_det, window_size)
    horiz_var = uniform_filter1d(accel_x**2 + accel_y**2, window_size)
    mask = (az_smooth.abs() > z_accel_threshold) & (horiz_var < horizontal_var_threshold)

    # rising edge at i: mask[i] & ~mask[i-1] (mask[-1] is False); falling
    # edge at i: ~mask[i] & mask[i-1], the event's exclusive end
    prev = torch.cat([mask.new_zeros(1), mask[:-1]])
    rising = mask & ~prev
    falling = ~mask & prev

    n = mask.shape[0]
    idx = torch.arange(n, device=mask.device)

    def take_k(edge):  # the first max_events edge indices, padded with n
        return torch.sort(torch.where(edge, idx, n)).values[:max_events]

    starts = take_k(rising)
    ends = take_k(falling)
    # a trailing active run has a start and no falling edge: its end is n
    valid = (starts < n) & (ends < n)

    starts_c = starts.clamp(0, n - 1)
    ends_c = ends.clamp(0, n - 1)
    duration = timestamps[ends_c] - timestamps[starts_c]
    valid = valid & (duration >= min_duration)

    # integral of az_smooth over [start, end) = cumtrapz[end-1] - cumtrapz[start]
    ct = cumtrapz(az_smooth, timestamps)
    z_integral = ct[(ends_c - 1).clamp(0, n - 1)] - ct[starts_c]

    n_events = valid.sum(dtype=torch.int32)
    starts_out = torch.where(valid, starts, -1)
    ends_out = torch.where(valid, ends, -1)
    z_out = torch.where(valid, z_integral, 0.0)
    return n_events, starts_out, ends_out, z_out


def assign_floor_labels_vectorized(
    trajectory_times: torch.Tensor,  # (N,) float32
    event_starts_t: torch.Tensor,  # (E,) start times (padded with +inf)
    event_ends_t: torch.Tensor,  # (E,) end times (padded with +inf)
    event_changes: torch.Tensor,  # (E,) +-1 (padded with 0), float32
    start_floor: int,
) -> torch.Tensor:
    """Label each pose: start_floor + the changes of completed events;
    poses inside an event window get label 0."""
    t = trajectory_times[:, None]
    completed = t >= event_ends_t[None, :]
    in_ride = (t >= event_starts_t[None, :]) & (t < event_ends_t[None, :])
    floor = start_floor + torch.where(completed, event_changes[None, :], 0.0).sum(1)
    return torch.where(in_ride.any(1), 0.0, floor).to(torch.int32)


class IMUFloorDetector:
    """Stateful detector: events from an IMU stream, then per-pose labels."""

    def __init__(
        self,
        z_accel_threshold: float = 0.5,
        min_duration: float = 2.0,
        window_size: int = 50,
        horizontal_var_threshold: float = 1.0,
        max_events: int = 32,
        device="cuda",
    ):
        self.z_accel_threshold = z_accel_threshold
        self.min_duration = min_duration
        self.window_size = window_size
        self.horizontal_var_threshold = horizontal_var_threshold
        self.max_events = max_events
        self.device = torch.device(device)
        self.events: List[ElevatorEvent] = []
        self.floor_labels: Optional[np.ndarray] = None

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.float32)

    def detect_elevator_events(self, timestamps, accel_x, accel_y, accel_z) -> List[ElevatorEvent]:
        """Events of one stream. The accelerations may be arrays or tensors
        (tensors stay where they are if on the detector's device); the
        timestamps are read on the host in float64."""
        ts = np.asarray(timestamps, dtype=np.float64)
        # relative float32 time on the device: absolute ROS stamps lose
        # sub-millisecond resolution in float32
        t_rel = torch.as_tensor(ts - ts[0], device=self.device).to(torch.float32)
        _, starts, ends, z_int = detect_elevator_events_padded(
            t_rel, self._f32(accel_x), self._f32(accel_y), self._f32(accel_z),
            self.z_accel_threshold, self.min_duration, self.window_size,
            self.horizontal_var_threshold, self.max_events,
        )
        # one device-to-host copy per call (the indices are exact in float64)
        table = torch.stack([starts.to(torch.float64), ends.to(torch.float64),
                             z_int.to(torch.float64)]).cpu().numpy()
        self.events = []
        for s, e, zi in zip(table[0].astype(np.int64), table[1].astype(np.int64), table[2]):
            if s < 0 or e < 0:
                continue
            direction = "up" if zi > 0 else "down"
            self.events.append(ElevatorEvent(
                start_time=float(ts[s]),
                end_time=float(ts[e]),
                duration=float(ts[e] - ts[s]),
                direction=direction,
                start_idx=int(s),
                end_idx=int(e),
                floor_change=1 if direction == "up" else -1,
            ))
        self.events.sort(key=lambda ev: ev.start_time)
        return self.events

    def assign_floor_labels(self, trajectory_times, start_floor: int = 5) -> np.ndarray:
        ts = np.asarray(trajectory_times, dtype=np.float64)
        t0 = ts[0] if len(ts) else 0.0
        E = max(len(self.events), 1)
        table = np.zeros((3, E))
        table[:2] = np.inf
        for i, ev in enumerate(self.events):
            table[:, i] = (ev.start_time - t0, ev.end_time - t0, ev.floor_change)
        ev_t = torch.as_tensor(table, device=self.device).to(torch.float32)
        labels = assign_floor_labels_vectorized(
            torch.as_tensor(ts - t0, device=self.device).to(torch.float32),
            ev_t[0], ev_t[1], ev_t[2], start_floor,
        )
        self.floor_labels = labels.cpu().numpy()
        return self.floor_labels
