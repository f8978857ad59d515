"""The port's host evaluation (mlis_tpu_torch/eval/{alignment,metrics,
semantic_eval,comprehensive,report}.py and ops/geometry.py) held against
mlis_tpu's on the CPU, on synthetic trajectories and TUM trees (the
published trajectories are not in the repository).

Tolerances: every float within 1e-12 (both are float64 numpy code), every
count, flag, key and line of text equal; the report parser reads each
package's analysis report into equal metrics. umeyama on torch tensors:
float64 within 1e-12 of the numpy path, float32 within 1e-5 of the JAX
package's xp=jnp path."""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mlis_tpu.eval.alignment as jalign  # noqa: E402
import mlis_tpu.eval.comprehensive as jcomp  # noqa: E402
import mlis_tpu.eval.metrics as jmetrics  # noqa: E402
import mlis_tpu.eval.report as jreport  # noqa: E402
import mlis_tpu.eval.semantic_eval as jsem  # noqa: E402
import mlis_tpu.gating.integration as jinteg  # noqa: E402
import mlis_tpu.ops.geometry as jgeom  # noqa: E402
import mlis_tpu_torch.eval as port_eval  # noqa: E402
import mlis_tpu_torch.eval.alignment as align  # noqa: E402
import mlis_tpu_torch.eval.comprehensive as comp  # noqa: E402
import mlis_tpu_torch.eval.metrics as metrics  # noqa: E402
import mlis_tpu_torch.eval.report as report  # noqa: E402
import mlis_tpu_torch.eval.semantic_eval as sem  # noqa: E402
import mlis_tpu_torch.gating.integration as integ  # noqa: E402
import mlis_tpu_torch.ops.geometry as geom  # noqa: E402
from mlis_tpu_torch.core.dataset import FLOOR_SEQUENCES  # noqa: E402
from mlis_tpu_torch.core.trajectory import Trajectory, save_tum  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)


def _same(a, b, path="") -> None:
    """Recursive equality: floats within 1e-12, everything else exact."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in b:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(b, (np.ndarray, float, np.floating)) and not isinstance(b, bool):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   err_msg=path, **TOL)
    else:
        assert a == b, (path, a, b)


def _walk(rng, n, t0=1.7e9, scale=1.0):
    """A smooth random walk with yaw quaternions, 20 Hz."""
    steps = rng.normal(0, 0.05, (n, 3)) + [0.12, 0.03, 0.0]
    pos = np.cumsum(steps, 0) * scale
    yaw = np.cumsum(rng.normal(0, 0.02, n))
    quat = np.column_stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)])
    return Trajectory(t0 + np.arange(n) / 20.0, pos, quat)


def test_exports_match():
    for name in ("umeyama", "kabsch_sim3_legacy", "apply_sim3", "align_se3", "align_sim3",
                 "associate_by_time", "normalize_timestamps", "compute_ate", "compute_rpe",
                 "compute_rotation_error", "compute_segment_metrics",
                 "compute_error_at_distances", "analyze_problem_regions",
                 "analyze_tracking_quality", "compute_trajectory_smoothness",
                 "is_valid_trajectory", "evaluate_algorithm_floor", "run_full_evaluation"):
        assert callable(getattr(port_eval, name)), name


def test_alignment_matches():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(200, 3)) * 4
    a = 0.7
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    tgt = 1.3 * src @ R.T + [1.0, -2.0, 0.5] + rng.normal(0, 0.01, src.shape)
    for with_scale in (True, False):
        _same(align.umeyama(src, tgt, with_scale), jalign.umeyama(src, tgt, with_scale))
    _same(align.align_se3(src, tgt), jalign.align_se3(src, tgt))
    _same(align.align_sim3(src, tgt), jalign.align_sim3(src, tgt))
    for use_scale in (True, False):
        _same(align.kabsch_sim3_legacy(src, tgt, use_scale),
              jalign.kabsch_sim3_legacy(src, tgt, use_scale))
    mirror = src * [1, 1, -1]  # a reflection: the det-sign correction
    _same(align.umeyama(mirror, tgt), jalign.umeyama(mirror, tgt))
    # torch tensors: float64 equal to the numpy path, float32 to the jnp path
    got64 = align.umeyama(torch.as_tensor(src), torch.as_tensor(tgt))
    _same([x.numpy() for x in got64], list(align.umeyama(src, tgt)))
    got32 = align.umeyama(torch.as_tensor(src, dtype=torch.float32),
                          torch.as_tensor(tgt, dtype=torch.float32))
    want32 = jalign.umeyama(jnp.asarray(src, jnp.float32), jnp.asarray(tgt, jnp.float32), xp=jnp)
    for g, w in zip(got32, want32):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    aligned, R_, t_ = align.align_se3(torch.as_tensor(src), torch.as_tensor(tgt))
    assert isinstance(aligned, torch.Tensor) and aligned.shape == (200, 3)


def test_metrics_match():
    rng = np.random.default_rng(1)
    ref = _walk(rng, 400)
    est = ref.positions + rng.normal(0, 0.1, ref.positions.shape)
    _same(metrics.compute_ate(est, ref.positions), jmetrics.compute_ate(est, ref.positions))
    for delta in (0.5, 1.0, 5.0, 1e6):
        _same(metrics.compute_rpe(est, delta), jmetrics.compute_rpe(est, delta))
    assert metrics.compute_rpe(est[:1]) is None
    q2 = ref.quaternions + rng.normal(0, 0.01, ref.quaternions.shape)
    _same(metrics.compute_rotation_error(q2, ref.quaternions),
          jmetrics.compute_rotation_error(q2, ref.quaternions))
    assert metrics.compute_rotation_error(q2[:0], q2[:0]) is None
    for k in (1, 10, 1000):
        _same(metrics.compute_segment_metrics(est, ref.positions, k),
              jmetrics.compute_segment_metrics(est, ref.positions, k))
    _same(metrics.compute_error_at_distances(est, ref.positions),
          jmetrics.compute_error_at_distances(est, ref.positions))
    for floor in ("5th_floor", "1st_floor", "2nd_floor"):
        _same(metrics.analyze_problem_regions(est, ref.positions, floor),
              jmetrics.analyze_problem_regions(est, ref.positions, floor))
    stamps = ref.timestamps.copy()
    stamps[100:] += 0.5  # one gap
    for t in (stamps, stamps * 1e9, stamps[:1]):
        _same(metrics.analyze_tracking_quality(t), jmetrics.analyze_tracking_quality(t))
    _same(metrics.compute_trajectory_smoothness(est), jmetrics.compute_trajectory_smoothness(est))
    assert metrics.compute_trajectory_smoothness(est[:2]) is None
    for expected in (1.0, 50.0, 1000.0):
        assert metrics.is_valid_trajectory(est, expected) == jmetrics.is_valid_trajectory(
            est, expected)
    _same(metrics.cumulative_distance(est), jmetrics.cumulative_distance(est))
    assert metrics.PROBLEM_REGIONS == jmetrics.PROBLEM_REGIONS


def test_geometry_matches():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(50, 4))
    _same(geom.quat_to_matrix(q), jgeom.quat_to_matrix(q))
    for R in geom.quat_to_matrix(q):
        _same(geom.matrix_to_quat(R), jgeom.matrix_to_quat(R))
    for R in (np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])):
        _same(geom.matrix_to_quat(R), jgeom.matrix_to_quat(R))  # each branch
    T = geom.se3_from_rt(geom.quat_to_matrix(q[0]), rng.normal(size=3))
    _same(T, jgeom.se3_from_rt(jgeom.quat_to_matrix(q[0]), T[:3, 3]))
    _same(geom.se3_inverse(T), jgeom.se3_inverse(T))
    _same(geom.chain(T, geom.se3_inverse(T), T), jgeom.chain(T, jgeom.se3_inverse(T), T))
    v = rng.normal(size=(5, 3))
    _same(geom.ned_to_flu(v), jgeom.ned_to_flu(v))
    _same(geom.R_NED_TO_FLU, jgeom.R_NED_TO_FLU)
    for a in (-9.8, 0.0, 9.8):
        assert geom.detect_imu_convention(a) == jgeom.detect_imu_convention(a)


def _write(root, algo, seqs, suffix=".txt"):
    (root / algo).mkdir(parents=True, exist_ok=True)
    for name, tr in seqs.items():
        save_tum(tr, root / algo / f"{name}{suffix}")


def _tree(root):
    """lego_loam (the pseudo-GT), orb_slam3 (its rigidly moved copy with
    noise, on the same clock) and droid_slam (scaled by 0.5: Sim(3)), and
    one diverged orb floor; four floors, lengths near the expected ones."""
    rng = np.random.default_rng(4)
    lego = {}
    for spec, n in zip(FLOOR_SEQUENCES, (1500, 520, 540, 1050)):
        lego[spec.name] = _walk(rng, n, scale=spec.expected_length_m / (n * 0.124))
    _write(root, "lego_loam", lego)
    a = 0.4
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    orb, droid = {}, {}
    for name, tr in lego.items():
        moved = tr.positions @ R.T + [3.0, -1.0, 0.2] + rng.normal(0, 0.05, tr.positions.shape)
        orb[name] = Trajectory(tr.timestamps, moved, tr.quaternions)
        droid[name] = Trajectory(tr.timestamps[::2], 0.5 * tr.positions[::2], tr.quaternions[::2])
    orb["2nd_floor"] = Trajectory(orb["2nd_floor"].timestamps, orb["2nd_floor"].positions * 40,
                                  orb["2nd_floor"].quaternions)  # diverged
    _write(root, "orb_slam3", orb)
    _write(root, "droid_slam", droid, "_stereo.txt")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("trajectories")
    _tree(root)
    return root


@pytest.mark.parametrize("legacy,diag", [(True, True), (False, True), (True, False)])
def test_full_evaluation_and_reports_match(tree, tmp_path, legacy, diag):
    kw = dict(algorithms=["lego_loam", "orb_slam3", "droid_slam"], legacy_alignment=legacy,
              full_diagnostics=diag, verbose=False)
    got = comp.run_full_evaluation(str(tree), output_path=str(tmp_path / "a.json"), **kw)
    want = jcomp.run_full_evaluation(str(tree), output_path=str(tmp_path / "b.json"), **kw)
    _same(got, want)
    assert not got["orb_slam3"]["2nd_floor"]["valid"] and "scale" in got["droid_slam"]["5th_floor"]
    _same(json.loads((tmp_path / "a.json").read_text()), json.loads((tmp_path / "b.json").read_text()))
    assert comp.summary_tables(got) == jcomp.summary_tables(want)
    assert report.write_table_iv_csv(got, tmp_path / "t.csv") == jreport.write_table_iv_csv(
        want, tmp_path / "u.csv")
    gating = {"orb_slam3": sem.LoopClosureMetrics(100, 25, 0, 0, 25, 75, 75)}
    md = report.benchmark_summary_md(got, gating, date="2026-01-01").splitlines()
    jmd = jreport.benchmark_summary_md(want, gating, date="2026-01-01").splitlines()
    assert md[0] == "# SLAM Benchmarking Results Summary (mlis_tpu_torch)" and "Generated by" in md[4]
    assert md[1:4] + md[5:] == jmd[1:4] + jmd[5:]
    text = report.write_benchmark_summary(got, None, tmp_path / "s.md", date="2026-01-01")
    assert (tmp_path / "s.md").read_text() == text and "Semantic gating" not in text
    short = _walk(np.random.default_rng(9), 50)
    r = comp.evaluate_algorithm_floor("orb_slam3", "5th_floor", short)
    _same(r, jcomp.evaluate_algorithm_floor("orb_slam3", "5th_floor", short))
    assert r["valid"] is False and r["status"].startswith("too short")


def test_semantic_evaluator_and_report_parser_match(tree, tmp_path):
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    for cls, out in ((integ.INTEGRATIONS, out_p), (jinteg.INTEGRATIONS, out_j)):
        for algo in ("orb_slam3", "lego_loam"):
            kw = {"device": "cpu"} if cls is integ.INTEGRATIONS else {}
            cls[algo](str(tree), str(out), **kw).run_full_analysis()
    for algo in ("orb_slam3", "lego_loam"):
        texts = [(o / f"{algo}_semantic_analysis.txt").read_text() for o in (out_p, out_j)]
        parsed = [sem.parse_gating_report(t) for t in texts]
        jparsed = [jsem.parse_gating_report(t) for t in texts]
        assert parsed[0] == parsed[1] and all(
            vars(p) == vars(j) for p, j in zip(parsed, jparsed))
        assert parsed[0].total_candidates > 0 and parsed[0].cross_floor_candidates > 0
        path = out_p / f"{algo}_semantic_analysis.txt"
        assert sem.parse_gating_report(path) == parsed[0]  # a path, not text
    assert sem.parse_gating_report("no report here") == sem.LoopClosureMetrics()

    evals = {}
    for mod, out in ((sem, out_p), (jsem, out_j)):
        ev = mod.SemanticEvaluator(results_dir=str(out))
        tum = np.loadtxt(tree / "orb_slam3" / "5th_floor.txt")
        ref = np.loadtxt(tree / "lego_loam" / "5th_floor.txt")
        ev.evaluate_algorithm("orb_slam3", tum_matrix=tum, reference_tum=ref)
        ev.evaluate_algorithm("lego_loam", tum_matrix=ref,
                              comprehensive_results={"lego_loam": {"5th_floor": {
                                  "ate_vs_lego": {"rmse": 0.5, "mean": 0.4, "max": 0.9}}}})
        ev.evaluate_algorithm("droid_slam")  # no report: zero metrics
        evals[mod] = ev
    assert evals[sem].to_json(str(tmp_path / "a" / "m.json")) == evals[jsem].to_json()
    assert evals[sem].comparison_markdown(str(tmp_path / "a" / "m.md")) == \
        evals[jsem].comparison_markdown()
    assert (tmp_path / "a" / "m.json").exists() and (tmp_path / "a" / "m.md").exists()
    assert list(evals[sem].evaluate_all(("orb_slam3",))) == list(evals[jsem].evaluate_all(
        ("orb_slam3",)))


def test_semantic_metrics_dataclasses_match():
    for args in ((0, 0, 0, 0), (10, 7, 2, 2), (10, 10, 3, 0), (10, 10, 0, 0)):
        a, b = sem.FloorDetectionMetrics(*args), jsem.FloorDetectionMetrics(*args)
        assert (a.floor_accuracy, a.elevator_precision) == (b.floor_accuracy, b.elevator_precision)
    for args in ((0,) * 7, (10, 3, 100, 25, 1.0, 0.2, 1)):
        a, b = sem.DynamicFilteringMetrics(*args), jsem.DynamicFilteringMetrics(*args)
        assert (a.dynamic_object_rate, a.feature_filter_rate) == (b.dynamic_object_rate,
                                                                   b.feature_filter_rate)
    pred, gt = np.array([1, 1, 2, 2, 5]), np.array([1, 2, 2, 2, 5])
    assert vars(sem.floor_detection_metrics(pred, gt, 2, 3)) == vars(
        jsem.floor_detection_metrics(pred, gt, 2, 3))
    tum = _walk(np.random.default_rng(6), 100).as_matrix()
    tum[50, 0] = tum[49, 0]  # a repeated stamp is skipped
    _same(sem.trajectory_velocity_metrics(tum), jsem.trajectory_velocity_metrics(tum))
    r = sem.SemanticEvaluationResult("x")
    assert r.ate_rmse is None and r.loop_closure == sem.LoopClosureMetrics()
