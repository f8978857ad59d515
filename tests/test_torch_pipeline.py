"""The port's SemanticGatingPipeline held against mlis_tpu's on the CPU:
the demo scenario, file IO, the gate over candidates, and the report text
(equal, character for character)."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from mlis_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from mlis_tpu.gating.pipeline import SemanticGatingPipeline as JaxPipeline  # noqa: E402
from mlis_tpu.gating.pipeline import make_demo_data as jax_demo_data  # noqa: E402
from mlis_tpu.gating.pipeline import run_demo as jax_run_demo  # noqa: E402

from mlis_tpu_torch.config import PipelineConfig  # noqa: E402
from mlis_tpu_torch.gating.pipeline import (  # noqa: E402
    SemanticGatingPipeline,
    main,
    make_demo_data,
    run_demo,
)


def _events(p):
    return [dataclasses.astuple(e) for e in p.floor_detector.events]


def test_demo_pipeline_matches_jax(tmp_path, capsys):
    ref = jax_run_demo(output_dir=str(tmp_path / "jax"))
    ref_out = capsys.readouterr().out
    port = run_demo(output_dir=str(tmp_path / "port"), device="cpu")
    out = capsys.readouterr().out
    assert out == ref_out  # events, labels, gate counts and the report
    assert _events(port) == _events(ref)
    np.testing.assert_array_equal(port.floor_labels, ref.floor_labels)
    assert port.loop_gate.get_stats() == ref.loop_gate.get_stats()
    assert (tmp_path / "port" / "semantic_gating_report.txt").read_text() == \
        (tmp_path / "jax" / "semantic_gating_report.txt").read_text()
    assert [e.direction for e in port.floor_detector.events] == ["down", "up"]


def test_demo_data_is_the_jax_packages():
    for a, b in zip(make_demo_data(3), jax_demo_data(3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("suffix", [".txt", ".csv"])
def test_pipeline_file_io_matches_jax(tmp_path, suffix):
    traj, imu = make_demo_data()
    tpath = tmp_path / "traj.txt"
    np.savetxt(tpath, traj)
    ipath = tmp_path / f"imu{suffix}"
    np.savetxt(ipath, imu, delimiter="," if suffix == ".csv" else " ")

    ref = JaxPipeline(output_dir=str(tmp_path / "jax"))
    port = SemanticGatingPipeline(output_dir=str(tmp_path / "port"), device="cpu")
    for p in (ref, port):
        p.load_trajectory(str(tpath))
        p.load_imu_data(str(ipath))
    np.testing.assert_array_equal(port.trajectory, ref.trajectory)
    np.testing.assert_array_equal(port.imu_data, ref.imu_data)
    (_, labels), (_, ref_labels) = port.detect_floors(start_floor=3), ref.detect_floors(start_floor=3)
    np.testing.assert_array_equal(labels, ref_labels)
    assert _events(port) == _events(ref)

    cands = [(100, 4500, 0.9), (500, 2500, 0.8), (1000, 1500, 0.7), (1700, 1800, 0.6)]
    (pv, pr), (rv, rr) = port.gate_candidates(cands), ref.gate_candidates(cands)
    assert [dataclasses.astuple(c) for c in pv] == [dataclasses.astuple(c) for c in rv]
    assert [dataclasses.astuple(c) for c in pr] == [dataclasses.astuple(c) for c in rr]
    assert port.generate_report() == ref.generate_report()
    # the figures: the same PNG bytes as the JAX package's
    for fig in ("visualize_results", "visualize_3d"):
        got, want = getattr(port, fig)(), getattr(ref, fig)()
        assert got.name == want.name and got.read_bytes() == want.read_bytes(), fig


def test_pipeline_errors_and_loose_gate(tmp_path):
    port = SemanticGatingPipeline(output_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError):
        port.detect_floors()
    with pytest.raises(ValueError):
        port.create_loop_closure_gate()
    port.trajectory, port.imu_data = make_demo_data()
    port.detect_floors(start_floor=5)
    gate = port.create_loop_closure_gate(strict_mode=False)
    valid, rejected = gate.gate_candidates([(100, 2500, 0.9), (100, 1500, 0.9)])
    assert len(valid) + len(rejected) == 2 and gate.get_stats()["total_candidates"] == 2


def test_main_demo(tmp_path, capsys):
    assert main(["--demo", "--output", str(tmp_path), "--device", "cpu"]) == 0
    assert "Detected 2 elevator events" in capsys.readouterr().out
    assert (tmp_path / "semantic_gating_report.txt").exists()
    assert main([]) == 1


def test_floor_and_lidar_config_fields_match_jax():
    d = JaxConfig().to_dict()
    d["gating"]["floor"]["window_size"] = 40
    d["gating"]["lidar"]["floor_height"] = 3.0
    d["gating"]["gate"]["sigma_z"] = 0.25
    cfg = PipelineConfig.from_dict(d)  # ignores the fields it does not read
    assert dataclasses.asdict(cfg.gating.floor) == d["gating"]["floor"]
    assert dataclasses.asdict(cfg.gating.lidar) == d["gating"]["lidar"]
    assert dataclasses.asdict(cfg.gating.gate) == d["gating"]["gate"]
    assert dataclasses.asdict(PipelineConfig().gating.floor) == \
        dataclasses.asdict(JaxConfig().gating.floor)
