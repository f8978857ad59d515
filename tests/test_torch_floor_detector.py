"""The port's IMU floor detector and its filters held against mlis_tpu on
the CPU, on the same numpy-seeded streams.

Tolerances, stated once:
  * filters: port against the JAX package within 1e-5 (float32 running
    sums in another order: a few ulp of |sum| < 64, over the window),
    against scipy (float64) within 1e-4, as tests/test_floor_detector.py
    holds the JAX package;
  * events: the same count and directions, start and end indices within
    1 sample (a float32 window mean within a few ulp of the 0.5 or 1.0
    threshold may move an edge by one sample);
  * labels: equal, except for poses within one IMU period of an event
    boundary.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.gating.floor_detector import IMUFloorDetector as JaxDetector  # noqa: E402
from mlis_tpu.gating.pipeline import make_demo_data  # noqa: E402
from mlis_tpu.ops.filters import cumtrapz as jax_cumtrapz  # noqa: E402
from mlis_tpu.ops.filters import uniform_filter1d as jax_filter  # noqa: E402

from mlis_tpu_torch.gating.floor_detector import (  # noqa: E402
    IMUFloorDetector,
    detect_elevator_events_padded,
    median_midpoint,
)
from mlis_tpu_torch.ops.filters import cumtrapz, uniform_filter1d  # noqa: E402

IMU_PERIOD = 1.0 / 200.0


@pytest.mark.parametrize("size", [1, 2, 3, 7, 50, 51])
@pytest.mark.parametrize("n", [500, 501])
def test_uniform_filter_matches_jax_and_scipy(size, n):
    from scipy.ndimage import uniform_filter1d as scipy_filter

    x = np.random.default_rng(size * 1000 + n).normal(size=n).astype(np.float32)
    got = uniform_filter1d(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_filter(jnp.asarray(x), size)), atol=1e-5)
    np.testing.assert_allclose(got, scipy_filter(x.astype(np.float64), size=size), atol=1e-4)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(uniform_filter1d(torch.from_numpy(x64), size).numpy(),
                               scipy_filter(x64, size=size), atol=1e-12)


def test_cumtrapz_matches_jax_and_numpy():
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 10, size=200)).astype(np.float32)
    y = rng.normal(size=200).astype(np.float32)
    ct = cumtrapz(torch.from_numpy(y), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(ct, np.asarray(jax_cumtrapz(jnp.asarray(y), jnp.asarray(t))),
                               atol=1e-5)
    for s, e in [(0, 200), (10, 50), (100, 101), (5, 6)]:
        want = np.trapezoid(y[s:e], t[s:e]) if e - s > 1 else 0.0
        np.testing.assert_allclose(ct[e - 1] - ct[s], want, atol=1e-4)


def test_median_of_an_even_stream_averages_the_middle_pair():
    x = np.array([9.0, 1.0, 4.0, 7.0, 2.0, 10.0], np.float32)  # middle pair 4 and 7
    got = median_midpoint(torch.from_numpy(x))
    assert float(got) == float(jnp.median(jnp.asarray(x))) == 5.5
    assert float(torch.median(torch.from_numpy(x))) == 4.0  # the lower one: not jnp's
    odd = x[:5]
    assert float(median_midpoint(torch.from_numpy(odd))) == float(jnp.median(jnp.asarray(odd)))


def _two_level_stream():
    """An even-length stream whose median is the midpoint of two levels:
    4000 samples near 9.81 (a 4 s down ride among them) and 4000 near
    10.71. Detrended by jnp.median's midpoint the levels sit at -/+0.45,
    under the 0.5 threshold, so only the ride is an event; the lower
    middle sample (torch.median) would make the high block a second one."""
    rng = np.random.default_rng(7)
    n = 8000
    t = np.arange(n) / 200.0
    az = 9.81 + rng.normal(0, 0.02, n)
    az[2000:6000] += 0.9
    az[600:1400] -= 1.5
    return t, rng.normal(0, 0.1, n), rng.normal(0, 0.1, n), az


def _trailing_active_stream():
    """One complete up ride, then a run still active at the last sample."""
    rng = np.random.default_rng(3)
    t = np.arange(0, 30, 1 / 200)
    n = len(t)
    az = np.full(n, 9.81) + rng.normal(0, 0.05, n)
    az[(t >= 5) & (t <= 9)] += 0.8
    az[t >= 20] += 0.9
    return t, rng.normal(0, 0.05, n), rng.normal(0, 0.05, n), az


def _demo_stream(offset=0.0):
    traj, imu = make_demo_data()
    return (imu[:, 0] + offset, imu[:, 1], imu[:, 2], imu[:, 3]), traj[:, 0] + offset


STREAMS = {
    "demo": lambda: _demo_stream(),
    "absolute_ros_stamps": lambda: _demo_stream(1.678e9),
    "even_two_level": lambda: (_two_level_stream(), np.linspace(0, 40, 800)),
    "trailing_active": lambda: (_trailing_active_stream(), np.linspace(0, 30, 600)),
}
N_EVENTS = {"demo": 2, "absolute_ros_stamps": 2, "even_two_level": 1, "trailing_active": 1}


@pytest.mark.parametrize("name", list(STREAMS))
def test_events_and_labels_match_jax(name):
    (t, ax, ay, az), pose_t = STREAMS[name]()
    ref = JaxDetector()
    want = ref.detect_elevator_events(t, ax, ay, az)
    port = IMUFloorDetector(device="cpu")
    got = port.detect_elevator_events(t, ax, ay, az)

    assert len(got) == len(want) == N_EVENTS[name]
    for a, b in zip(got, want):
        assert a.direction == b.direction and a.floor_change == b.floor_change
        assert abs(a.start_idx - b.start_idx) <= 1 and abs(a.end_idx - b.end_idx) <= 1
        assert a.start_time == t[a.start_idx] and a.end_time == t[a.end_idx]
        assert a.duration == a.end_time - a.start_time

    labels = port.assign_floor_labels(pose_t, start_floor=5)
    ref_labels = ref.assign_floor_labels(pose_t, start_floor=5)
    assert labels.dtype == np.int32 and labels.shape == ref_labels.shape
    bounds = np.array([x for e in got + want for x in (e.start_time, e.end_time)])
    near = np.abs(pose_t[:, None] - bounds[None, :]).min(1) <= IMU_PERIOD
    np.testing.assert_array_equal(labels[~near], ref_labels[~near])
    if name == "demo":
        assert set(np.unique(labels)) == {0, 4, 5}  # down a floor, back up, 0 inside rides


def test_padded_extraction_and_label_rules():
    """The padded table (-1 beyond n_events), label 0 inside a ride, and
    floors walked from start_floor."""
    (t, ax, ay, az), _ = _demo_stream()
    t_rel = torch.from_numpy((t - t[0]).astype(np.float32))
    n, starts, ends, z = detect_elevator_events_padded(
        t_rel, *(torch.from_numpy(a.astype(np.float32)) for a in (ax, ay, az)), max_events=4)
    assert int(n) == 2 and starts.shape == (4,)
    assert (starts[2:] == -1).all() and (ends[2:] == -1).all() and (z[2:] == 0).all()
    assert z[0] < 0 < z[1]  # down, then up
    det = IMUFloorDetector(device="cpu")
    det.detect_elevator_events(t, ax, ay, az)
    pose_t = np.array([50.0, 102.0, 150.0, 202.0, 250.0])
    np.testing.assert_array_equal(det.assign_floor_labels(pose_t, start_floor=5), [5, 0, 4, 0, 5])
    quiet = IMUFloorDetector(device="cpu")
    assert quiet.detect_elevator_events(t[:10000], ax[:10000], ay[:10000], az[:10000]) == []
    np.testing.assert_array_equal(quiet.assign_floor_labels(pose_t, start_floor=3), [3] * 5)
