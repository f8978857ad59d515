"""The port's trajectory IO, dataset manifest, timestamp association, gate
API and SemanticIntegration held against mlis_tpu's on the CPU, on
synthetic TUM trees (the published trajectories are not in the
repository). Counts, labels and gate statistics are exactly equal; report
texts are equal except the sweep-time line."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import mlis_tpu.core.dataset as jax_dataset  # noqa: E402
import mlis_tpu.core.trajectory as jax_traj  # noqa: E402
import mlis_tpu.eval.association as jax_assoc  # noqa: E402
import mlis_tpu.gating.gate as jax_gate  # noqa: E402
import mlis_tpu.gating.integration as jax_integ  # noqa: E402

import mlis_tpu_torch.core.dataset as dataset  # noqa: E402
import mlis_tpu_torch.core.trajectory as traj  # noqa: E402
import mlis_tpu_torch.eval.association as assoc  # noqa: E402
import mlis_tpu_torch.gating.gate as gate  # noqa: E402
import mlis_tpu_torch.gating.integration as integ  # noqa: E402
from mlis_tpu_torch.ops.pairwise import candidate_counts_host  # noqa: E402


def _loop(rng, n, t0=0.0):
    """n poses around a 6 x 4 m loop with noise; every sequence revisits
    the same xy area at z ~ 0, as per-floor visual SLAM runs do."""
    s = np.linspace(0, 4 * np.pi, n)
    pos = np.column_stack([3 * np.cos(s), 2 * np.sin(s), 0.05 * np.sin(3 * s)])
    pos += rng.normal(0, 0.05, pos.shape)
    quat = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    return traj.Trajectory(t0 + np.arange(n) * 0.1, pos, quat)


def _write_tree(root, algo, sizes, rng, transits=False, suffix=".txt"):
    d = root / algo
    d.mkdir(parents=True, exist_ok=True)
    t0 = 1.6e9
    names = [s.name for s in (dataset.FULL_SEQUENCE_ORDER if transits else dataset.FLOOR_SEQUENCES)]
    for name, n in zip(names, sizes):
        if n:
            traj.save_tum(_loop(rng, n, t0), d / f"{name}{suffix}")
            t0 += n * 0.1 + 5.0


def test_combine_sequences_with_transits():
    rng = np.random.default_rng(0)
    seqs = [("5th_floor", 5, _loop(rng, 50)), ("transit_5_to_1", None, _loop(rng, 9)),
            ("1st_floor", 1, _loop(rng, 30)), ("transit_1_to_4", None, _loop(rng, 1)),
            ("4th_floor", 4, _loop(rng, 0))]
    jseqs = [(n, f, jax_traj.Trajectory(t.timestamps, t.positions, t.quaternions))
             for n, f, t in seqs]
    m, labels = traj.combine_sequences(seqs, dataset.TRANSIT_FLOORS)
    jm, jlabels = jax_traj.combine_sequences(jseqs, jax_dataset.TRANSIT_FLOORS)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(labels, jlabels)
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels[50:59], [5, 4, 4, 4, 3, 2, 2, 2, 1])  # half to even
    with pytest.raises(KeyError):
        traj.combine_sequences([("transit_x", None, _loop(rng, 3))])
    with pytest.raises(ValueError):
        traj.combine_sequences([])


def test_tum_io_and_trajectory_metrics(tmp_path):
    rng = np.random.default_rng(1)
    t = _loop(rng, 200, 1.7e9)
    traj.save_tum(t, tmp_path / "a.txt")
    text = (tmp_path / "a.txt").read_text()
    (tmp_path / "b.txt").write_text("# header\n\n" + text.replace(" ", ",", 3))
    for name in ("a.txt", "b.txt"):
        got = traj.load_tum(tmp_path / name)
        want = jax_traj.load_tum(tmp_path / name)
        np.testing.assert_array_equal(got.as_matrix(), want.as_matrix())
        assert len(got) == 200 and got.duration == want.duration
    jax_traj.save_tum(jax_traj.load_tum(tmp_path / "a.txt"), tmp_path / "c.txt")
    traj.save_tum(traj.load_tum(tmp_path / "a.txt"), tmp_path / "d.txt")
    assert (tmp_path / "c.txt").read_text() == (tmp_path / "d.txt").read_text()
    for f in ("trajectory_length", "endpoint_drift"):
        assert getattr(traj, f)(t.positions) == getattr(jax_traj, f)(t.positions)
        assert getattr(traj, f)(t.positions[:1]) == 0.0
    (tmp_path / "empty.txt").write_text("# nothing\n")
    with pytest.raises(ValueError):
        traj.load_tum(tmp_path / "empty.txt")


def test_dataset_manifest_and_load(tmp_path):
    for name in ("FLOOR_SEQUENCES", "TRANSIT_SEQUENCES", "TRANSIT_FLOORS", "PAPER_TABLE_IV",
                 "TRAJECTORY_FILE_PATTERNS", "CAMERA_TOPICS", "IMU_RATE_HZ", "LIDAR_RATE_HZ",
                 "FLOOR_HEIGHT_M", "IMAGE_SIZE", "STEREO_PAIR", "START_FLOOR"):
        a, b = getattr(dataset, name), getattr(jax_dataset, name)
        if name.endswith("SEQUENCES"):
            a, b = [dataclasses.astuple(s) for s in a], [dataclasses.astuple(s) for s in b]
        assert a == b, name
    rng = np.random.default_rng(2)
    _write_tree(tmp_path, "orb_slam3", [40, 0, 30, 20], rng)  # 1st floor missing
    _write_tree(tmp_path, "droid_slam", [25, 25, 25, 25], rng, suffix="_stereo.txt")
    _write_tree(tmp_path, "lego_loam", [30, 7, 20, 5, 10, 6, 15, 4], rng, transits=True)
    for algo, transits in (("orb_slam3", False), ("droid_slam", False), ("lego_loam", True),
                           ("lego_loam", False), ("basalt", False)):
        got = dataset.NUFRM3F(str(tmp_path), algo, transits).load()
        want = jax_dataset.NUFRM3F(str(tmp_path), algo, transits).load()
        assert [(n, f) for n, f, _ in got] == [(n, f) for n, f, _ in want]
        for (_, _, a), (_, _, b) in zip(got, want):
            np.testing.assert_array_equal(a.as_matrix(), b.as_matrix())
    assert [n for n, _, _ in dataset.NUFRM3F(str(tmp_path), "orb_slam3").load()] == [
        "5th_floor", "4th_floor", "2nd_floor"]


def test_association_matches_jax():
    rng = np.random.default_rng(3)
    ref_t = np.sort(rng.uniform(0, 100, 500)) + 1.7e9
    est_t = rng.uniform(-1, 101, 300) + 1.7e9
    np.testing.assert_array_equal(assoc.nearest_indices(est_t, ref_t),
                                  jax_assoc.nearest_indices(est_t, ref_t))
    for e, r in ((est_t, ref_t), (est_t * 1e9, ref_t * 1e9), (est_t, ref_t[::-1].copy()),
                 (est_t[:5], ref_t)):
        a, b = assoc.associate_by_time(e, r), jax_assoc.associate_by_time(e, r)
        if b[0] is None:
            assert a == (None, None)
        else:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(assoc.normalize_timestamps(ref_t * 1e9),
                                  jax_assoc.normalize_timestamps(ref_t * 1e9))


def _report_lines(text):
    return [line for line in text.splitlines() if "Sweep time" not in line]


def test_run_full_analysis_and_comparison(tmp_path):
    rng = np.random.default_rng(4)
    root = tmp_path / "trajectories"
    _write_tree(root, "orb_slam3", [700, 300, 350, 400], rng)
    _write_tree(root, "droid_slam", [300, 200, 0, 250], rng, suffix="_stereo.txt")
    _write_tree(root, "lego_loam", [400, 60, 250, 40, 300, 50, 200, 30], rng, transits=True)
    # lego_loam includes no transits in either package's driver: the class
    # attribute decides, and both packages' are False

    port = integ.ORBSlam3SemanticIntegration(str(root / "orb_slam3"), str(tmp_path / "p"),
                                             device="cpu")
    ref = jax_integ.ORBSlam3SemanticIntegration(str(root / "orb_slam3"), str(tmp_path / "j"))
    text, ref_text = port.run_full_analysis(), ref.run_full_analysis()
    assert _report_lines(text) == _report_lines(ref_text)
    a = port.last_analysis
    host = candidate_counts_host(port.combined[:, 1:4], port.floor_labels)
    assert (a.total_candidates, a.same_floor_candidates, a.cross_floor_candidates) == host
    assert a.cross_floor_candidates > 0 and a.same_floor_candidates > 0
    assert port.loop_gate.get_stats() == ref.loop_gate.get_stats()
    saved = (tmp_path / "p" / "orb_slam3_semantic_analysis.txt").read_text()
    assert saved == text
    port.run_full_analysis(make_figures=True, save_report=False)
    ref.run_full_analysis(make_figures=True, save_report=False)
    for fig in ("floor_segmentation", "3d_multifloor", "loop_closure_gating"):
        name = f"orb_slam3_{fig}.png"
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), fig

    ex = port.analyze(with_examples=True)
    ref_ex = ref.analyze(with_examples=True)
    assert ex.example_cross_floor_pairs == ref_ex.example_cross_floor_pairs

    got = integ.run_comparison(str(root), str(tmp_path / "p"), device="cpu")
    want = jax_integ.run_comparison(str(root), str(tmp_path / "j"))
    assert list(got) == list(want) == ["orb_slam3", "droid_slam", "lego_loam"]
    for k in got:
        assert (got[k].total_candidates, got[k].same_floor_candidates,
                got[k].cross_floor_candidates) == (want[k].total_candidates,
                                                   want[k].same_floor_candidates,
                                                   want[k].cross_floor_candidates)
    assert (tmp_path / "p" / "semantic_gating_comparison.txt").read_text() == \
        (tmp_path / "j" / "semantic_gating_comparison.txt").read_text()
    got = integ.run_comparison(str(root), str(tmp_path / "p2"), algorithms=["lego_loam"],
                               per_algo_reports=True, device="cpu")
    assert (tmp_path / "p2" / "lego_loam_semantic_analysis.txt").exists()
    got = integ.run_comparison(str(root), str(tmp_path / "p3"), algorithms=["lego_loam"],
                               make_figures=True, device="cpu")
    assert got["lego_loam"].total_candidates == want["lego_loam"].total_candidates
    assert not (tmp_path / "p3" / "lego_loam_semantic_analysis.txt").exists()
    assert (tmp_path / "p3" / "lego_loam_loop_closure_gating.png").stat().st_size > 1000
    with pytest.raises(FileNotFoundError):
        integ.LegoLoamSemanticIntegration(str(tmp_path / "none"), device="cpu").load_and_combine()
    assert set(integ.INTEGRATIONS) == set(jax_integ.INTEGRATIONS)


def test_gate_api_matches_jax(capsys):
    rng = np.random.default_rng(5)
    labels = rng.integers(1, 6, 200)
    cands = [(int(q), int(m), float(s)) for q, m, s in
             zip(rng.integers(0, 200, 60), rng.integers(0, 200, 60), rng.random(60))]
    for strict in (True, False):
        port = gate.SemanticLoopClosureGate(labels, strict, device="cpu")
        ref = jax_gate.SemanticLoopClosureGate(labels, strict)
        for q, m, s in cands[:10]:
            assert dataclasses.astuple(port.gate_candidate(q, m, s)) == \
                dataclasses.astuple(ref.gate_candidate(q, m, s))
        (pv, pr), (rv, rr) = port.gate_candidates(cands), ref.gate_candidates(cands)
        assert [dataclasses.astuple(c) for c in pv] == [dataclasses.astuple(c) for c in rv]
        assert [dataclasses.astuple(c) for c in pr] == [dataclasses.astuple(c) for c in rr]
        assert port.gate_candidates([]) == ref.gate_candidates([]) == ([], [])
        assert port.get_stats() == ref.get_stats()
        port.print_summary()
        port_out = capsys.readouterr().out
        ref.print_summary()
        assert port_out == capsys.readouterr().out
    empty = gate.SemanticLoopClosureGate(labels, device="cpu")
    empty.print_summary()
    out = capsys.readouterr().out
    jax_gate.SemanticLoopClosureGate(labels).print_summary()
    assert out == capsys.readouterr().out

    for name in ("CheckFloorConsistency", "GateByFloor"):
        assert gate.generate_orbslam3_patch(name) == jax_gate.generate_orbslam3_patch(name)
    assert gate.generate_orbslam3_patch() == jax_gate.generate_orbslam3_patch()
    pf, rf = gate.ContextualPriorFactor(labels), jax_gate.ContextualPriorFactor(labels)
    for i in (0, 17, 199):
        assert pf.create_floor_constraint(i) == rf.create_floor_constraint(i)
        assert pf.create_floor_constraint(i, 3.5) == rf.create_floor_constraint(i, 3.5)
    for direction in ("up", "down"):
        assert pf.create_elevator_transition_factor(3, 9, direction) == \
            rf.create_elevator_transition_factor(3, 9, direction)
        assert pf.create_elevator_transition_factor(3, 9, direction, 3.5) == \
            rf.create_elevator_transition_factor(3, 9, direction, 3.5)
    for a, b in zip(pf.floor_priors(3.5, 0.2), rf.floor_priors(3.5, 0.2)):
        np.testing.assert_array_equal(a, b)
