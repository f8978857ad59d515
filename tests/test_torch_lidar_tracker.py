"""The port's LiDAR floor tracker and the multi-modal fusion held against
mlis_tpu on the CPU, with the JAX package's own RANSAC draws fed in
(``uniforms=``), at scans of at most 2,048 points.

Tolerances, stated once:
  * planes within 1e-5 (float32 cross products and norms rounded in
    another order);
  * inlier counts equal, except for ground points whose float64 distance
    to the winning plane lies within 1e-6 m of the threshold;
  * floors, transitions and per-pose labels equal; smoothed heights
    within 1e-5 m.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.gating import lidar_floor_tracker as J  # noqa: E402
from mlis_tpu.gating.fusion import MultiModalFloorDetector as JaxFusion  # noqa: E402

from mlis_tpu_torch.gating import lidar_floor_tracker as T  # noqa: E402
from mlis_tpu_torch.gating.fusion import MultiModalFloorDetector  # noqa: E402

THRESHOLD = 0.1


def _scan(rng, base_z, n=2048, noise=0.01, clutter=0.15):
    """A floor plane base_z below the sensor with furniture returns above it."""
    x = rng.uniform(-12, 12, n)
    y = rng.uniform(-12, 12, n)
    z = base_z + rng.normal(0, noise, n)
    k = int(clutter * n)
    z[:k] += rng.uniform(0.3, 2.0, k)
    return np.column_stack([x, y, z]).astype(np.float32)


def _jax_uniforms(key, S, H=128):
    return np.array(jax.random.uniform(key, (S, H, 3)))


def _near_threshold(points, mask, plane):
    dist = np.abs(points.astype(np.float64) @ plane[:3].astype(np.float64) + plane[3])
    return int((mask & (np.abs(dist - THRESHOLD) < 1e-6)).sum())


@pytest.mark.parametrize("noise", [0.01, 0.05])
def test_fit_plane_ransac_batch_on_jax_draws(noise):
    rng = np.random.default_rng(int(noise * 100))
    S = 6
    pts = np.stack([_scan(rng, -1.5 - 0.3 * s, noise=noise) for s in range(S)])
    mask = rng.random((S, pts.shape[1])) < 0.85
    mask[5] = False  # a scan with no ground point
    key = jax.random.PRNGKey(11)
    jp, jr = J.fit_plane_ransac_batch(jnp.asarray(pts), jnp.asarray(mask), key, 128, THRESHOLD)
    jp, jr = np.asarray(jp), np.asarray(jr)
    tp, tr = T.fit_plane_ransac_batch(torch.from_numpy(pts), torch.from_numpy(mask), None, 128,
                                      THRESHOLD, uniforms=_jax_uniforms(key, S))
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-5)
    n_valid = mask.sum(1)
    for s in range(S):
        got, want = round(float(tr[s]) * max(n_valid[s], 1)), round(float(jr[s]) * max(n_valid[s], 1))
        assert abs(got - want) <= _near_threshold(pts[s], mask[s], jp[s]), (s, got, want)
    assert tr[5] == 0 and jr[5] == 0
    np.testing.assert_allclose(T.robot_height_from_plane(tp).numpy(),
                               np.asarray(J.robot_height_from_plane(jnp.asarray(jp))), atol=1e-5)


def test_inlier_blocks_change_nothing(monkeypatch):
    """Counting in blocks of scans gives the one-block result."""
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(np.stack([_scan(rng, -1.5, n=1024) for _ in range(5)]))
    mask = torch.ones(5, 1024, dtype=torch.bool)
    u = torch.rand(5, 128, 3, generator=torch.Generator().manual_seed(0))
    whole = T.fit_plane_ransac_batch(pts, mask, uniforms=u)
    monkeypatch.setattr(T, "RANSAC_BLOCK_ELEMENTS", 2 * 128 * 1024)  # blocks of 2 scans
    blocked = T.fit_plane_ransac_batch(pts, mask, uniforms=u)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_tied_counts_go_to_the_lower_hypothesis(monkeypatch):
    """On a clean plane every non-degenerate hypothesis counts every point:
    the first such hypothesis wins, as with jnp.argmax. Hypothesis 0 draws
    one point three times (degenerate, count -1), so hypothesis 1 wins."""
    rng = np.random.default_rng(2)
    n = 512
    pts = np.column_stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                           np.full(n, -1.5) + rng.normal(0, 1e-3, n)]).astype(np.float32)[None]
    mask = np.ones((1, n), bool)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(4), (1, 8, 3)))
    u[0, 0] = 0.5
    tp, tr = T.fit_plane_ransac_batch(torch.from_numpy(pts), torch.from_numpy(mask),
                                      uniforms=torch.from_numpy(u), threshold=THRESHOLD)
    assert float(tr[0]) == 1.0
    # hypothesis 1's plane, from its own three draws
    idx = (u[0, 1] * n).astype(np.int32)
    p = pts[0, idx]
    normal = np.cross(p[1] - p[0], p[2] - p[0])
    normal = normal / np.linalg.norm(normal)
    np.testing.assert_allclose(tp[0, :3].numpy(), normal, atol=1e-5)
    np.testing.assert_allclose(float(tp[0, 3]), -normal @ p[0], atol=1e-5)
    # the JAX package picks the same hypothesis from the same draws: its
    # un-jitted body with jax.random.uniform returning them
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    jp, jr = J.fit_plane_ransac_batch.__wrapped__(
        jnp.asarray(pts), jnp.asarray(mask), jax.random.PRNGKey(0), 8, THRESHOLD)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    assert float(jr[0]) == 1.0


def test_smooth_and_label_with_invalid_scans():
    rng = np.random.default_rng(9)
    S = 120
    base = np.where(np.arange(S) < 40, 1.5, np.where(np.arange(S) < 80, 5.0, -2.0))
    z = (base + rng.normal(0, 0.05, S)).astype(np.float32)
    valid = rng.random(S) < 0.7
    valid[:3] = False  # invalid scans before the first valid one
    valid[50:58] = False  # a gap across nothing in particular
    for window in (1, 10):
        js, jf, jst = (np.asarray(a) for a in J.smooth_and_label(
            jnp.asarray(z), jnp.asarray(valid), 3.5, window))
        ts, tf, tst = (a.numpy() for a in T.smooth_and_label(
            torch.from_numpy(z), torch.from_numpy(valid), 3.5, window))
        np.testing.assert_array_equal(tf, jf)
        assert tf.dtype == np.int32
        np.testing.assert_allclose(ts, js, atol=1e-5)
        np.testing.assert_allclose(tst, jst, atol=1e-5)
    assert set(np.unique(tf)) == {-1, 0, 1}


def _bag(rng, n_scans=40, n_points=1024):
    scans = np.stack([_scan(rng, -1.5 if (i < 15 or i >= 30) else -5.0, n=n_points)
                      for i in range(n_scans)])
    rings = np.tile(np.where(np.arange(n_points) % 4 == 0, 60, 10), (n_scans, 1))
    scans[:, ::4, 2] += 3.0  # the upper rings see walls, not the floor
    return scans, np.arange(n_scans) * 0.5, rings


@pytest.mark.parametrize("rings_given", [True, False])
def test_process_scans_matches_jax(rings_given):
    rng = np.random.default_rng(1)
    scans, times, rings = _bag(rng)
    point_valid = np.ones(scans.shape[:2], bool)
    point_valid[7, 100:] = False  # a padded scan: too few ground points
    point_valid[20, 300:] = False
    ring_arg = rings if rings_given else None

    ref = J.LiDARFloorTracker(min_ground_points=150)
    want = ref.process_scans(scans, times, ring_arg, point_valid)
    # the draws process_scans made: the tracker's key split once
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    port = T.LiDARFloorTracker(min_ground_points=150, device="cpu")
    got = port.process_scans(scans, times, ring_arg, point_valid,
                             uniforms=_jax_uniforms(sub, len(scans)))
    assert [e.floor_number for e in got] == [e.floor_number for e in want]
    assert [e.num_ground_points for e in got] == [e.num_ground_points for e in want]
    np.testing.assert_allclose([e.z_height for e in got], [e.z_height for e in want], atol=1e-5)
    np.testing.assert_allclose([e.confidence for e in got], [e.confidence for e in want],
                               atol=1e-5)
    assert len(port.floor_history) == len(ref.floor_history) < len(scans)
    assert port.detect_floor_transitions() == ref.detect_floor_transitions()
    assert [t[1:] for t in port.detect_floor_transitions()] == [(0, 1), (1, 0)]  # the ground 3.5 m lower: a floor up
    pose_t = np.linspace(-1, 21, 97)
    np.testing.assert_array_equal(port.get_floor_labels(pose_t), ref.get_floor_labels(pose_t))
    assert port.current_floor == ref.current_floor
    port.reset()
    assert port.floor_history == [] and port.reference_z is None


def test_process_scans_against_process_scan():
    """The batched path against the per-scan API on the same scans, each
    with its own draws (as tests/test_lidar_tracker.py holds the JAX
    package): equal floors, heights within 0.05 m."""
    rng = np.random.default_rng(4)
    scans = [_scan(rng, -1.5 if i < 20 else -5.0, n=512) for i in range(40)]
    times = np.arange(40) * 0.5
    seq = T.LiDARFloorTracker(min_ground_points=50, device="cpu")
    for s, t in zip(scans, times):
        seq.process_scan(s, t)
    bat = T.LiDARFloorTracker(min_ground_points=50, device="cpu")
    bat.process_scans(np.stack(scans), times)
    assert [e.floor_number for e in seq.floor_history] == [e.floor_number for e in bat.floor_history]
    np.testing.assert_allclose([e.z_height for e in seq.floor_history],
                               [e.z_height for e in bat.floor_history], atol=0.05)
    assert seq.detect_floor_transitions() == bat.detect_floor_transitions()


def test_process_scan_rules_match_jax():
    """The per-scan API's own rules, which the batched path lacks: too few
    ground points returns without recording, ring selection, the first
    scan's stability 1 / (1 + 10)."""
    rng = np.random.default_rng(6)
    for tracker in (J.LiDARFloorTracker(min_ground_points=100),
                    T.LiDARFloorTracker(min_ground_points=100, device="cpu")):
        few = tracker.process_scan(_scan(rng, -1.5, n=20, clutter=0), timestamp=0.0)
        assert few.confidence == 0.0 and few.num_ground_points == 20
        assert tracker.floor_history == []
        pts = np.vstack([_scan(rng, -1.5, n=300, clutter=0), _scan(rng, 2.0, n=300, clutter=0)])
        rings = np.concatenate([np.full(300, 5), np.full(300, 80)])
        est = tracker.process_scan(pts, 1.0, rings=rings)
        assert est.num_ground_points == 300
        assert est.z_height == pytest.approx(1.5, abs=0.05)
        assert 0.05 < est.confidence <= 1.0 / 11.0 + 1e-6
        assert len(tracker.floor_history) == 1


def test_ground_mask_without_rings_matches_jax():
    rng = np.random.default_rng(8)
    pts = np.stack([_scan(rng, -1.5, n=700) for _ in range(3)])
    valid = rng.random((3, 700)) < 0.9
    want = np.asarray(jax.vmap(lambda p, v: J.extract_ground_mask(p, None, v))(
        jnp.asarray(pts), jnp.asarray(valid)))
    got = T.extract_ground_mask(torch.from_numpy(pts), None, torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    one = T.extract_ground_mask(torch.from_numpy(pts[0]), None).numpy()
    np.testing.assert_array_equal(one, np.asarray(J.extract_ground_mask(jnp.asarray(pts[0]), None)))


def test_fusion_imu_wins_and_agreement():
    rng = np.random.default_rng(0)
    t = np.arange(0, 30, 1 / 200)
    ax, ay = rng.normal(0, 0.1, len(t)), rng.normal(0, 0.1, len(t))
    az = np.full(len(t), 9.81) + rng.normal(0, 0.05, len(t))
    az[(t >= 10) & (t <= 14)] += 0.8  # one up ride
    scans = np.stack([_scan(rng, -1.5 if i < 24 else -5.0, n=512) for i in range(60)])
    scan_t = np.arange(60) * 0.5
    traj_t = np.linspace(0, 30, 300)

    ref, port = JaxFusion(floor_height=3.5), MultiModalFloorDetector(floor_height=3.5, device="cpu")
    for det in (ref, port):
        det.process_imu(t, ax, ay, az)
        assert det.agreement(traj_t, start_floor=2)["lidar_available"] is False
    ref.process_lidar_scans(scans, scan_t)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    port.lidar_tracker.process_scans(scans, scan_t, uniforms=_jax_uniforms(sub, 60))
    labels = port.fuse_estimates(traj_t, start_floor=2)
    np.testing.assert_array_equal(labels, ref.fuse_estimates(traj_t, start_floor=2))
    assert labels[0] == 2 and labels[-1] == 3
    assert port.agreement(traj_t, start_floor=2) == ref.agreement(traj_t, start_floor=2)
    assert port.agreement(traj_t, start_floor=2)["lidar_available"] is True
