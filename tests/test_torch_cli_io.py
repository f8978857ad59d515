"""The port's IO and tooling subcommands against mlis_tpu's CLI: ``bag``
(info / odom-tum / imu-csv / imu-plot) on a bag in tmp_path, ``stream``
(the same accepted pairs, scores within the 1e-6 that
test_torch_streaming.py pins), ``check-data`` and ``layout`` (identical
output), and ``pipeline`` writing its figures on ``--device cpu``
(``all`` and ``fullgate``: test_torch_cli_all.py). One test pins a fault
of both packages: ``bag imu-csv`` writes a header row that
``SemanticGatingPipeline.load_imu_data`` cannot read."""

import contextlib
import io
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import mlis_tpu.cli as jcli  # noqa: E402
import mlis_tpu.runtime.native as jnative  # noqa: E402
import mlis_tpu_torch.cli as cli  # noqa: E402
from mlis_tpu.gating.pipeline import SemanticGatingPipeline as JaxPipeline  # noqa: E402
from mlis_tpu_torch.core.bag import BagWriter, encode_imu, encode_odometry  # noqa: E402
from mlis_tpu_torch.gating.pipeline import SemanticGatingPipeline, make_demo_data  # noqa: E402
from mlis_tpu_torch.core.dataset import FLOOR_SEQUENCES  # noqa: E402
from mlis_tpu_torch.core.trajectory import Trajectory  # noqa: E402
from test_torch_eval_host import _walk, _write  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _jax_fallback():
    """The JAX side runs its numpy fallback (see test_torch_runtime.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_load", lambda: None)
        yield


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def demo_bag(tmp_path_factory):
    """make_demo_data's 300 s IMU stream (two elevator rides) at every
    second sample (100 Hz) and its trajectory as odometry, in one bag."""
    traj, imu = make_demo_data()
    path = tmp_path_factory.mktemp("bag") / "demo.bag"
    w = BagWriter(path)
    for row in imu[::2]:
        t = 1000.0 + row[0]
        w.write("/vectornav/imu", "sensor_msgs/Imu", t, encode_imu(t, row[1:4], row[4:7]))
    for row in traj[::10]:
        t = 1000.0 + row[0]
        w.write("/aft_mapped_to_init", "nav_msgs/Odometry", t,
                encode_odometry(t, row[1:4], row[4:8]))
    w.close()
    return path


def small_tree(root):
    """A small TUM tree: lego_loam's four floors (300, 120, 120 and 200
    poses at their expected lengths), orb_slam3 as a shifted noisy copy,
    droid_slam at half rate and half scale."""
    rng = np.random.default_rng(4)
    lego = {s.name: _walk(rng, n, scale=s.expected_length_m / (n * 0.124))
            for s, n in zip(FLOOR_SEQUENCES, (300, 120, 120, 200))}
    _write(root, "lego_loam", lego)
    _write(root, "orb_slam3", {k: Trajectory(
        t.timestamps, t.positions + [3.0, -1.0, 0.2] + rng.normal(0, 0.05, t.positions.shape),
        t.quaternions) for k, t in lego.items()})
    _write(root, "droid_slam", {k: Trajectory(t.timestamps[::2], 0.5 * t.positions[::2],
                                              t.quaternions[::2]) for k, t in lego.items()},
           "_stereo.txt")
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return small_tree(tmp_path_factory.mktemp("trajectories"))


@pytest.fixture(scope="module")
def exported(demo_bag, tmp_path_factory):
    """``bag odom-tum`` and ``bag imu-csv`` of both packages: {action:
    ((rc, stdout, path) of the port, (rc, stdout, path) of mlis_tpu)}."""
    d = tmp_path_factory.mktemp("exported")
    out = {}
    for action, name in (("odom-tum", "traj.txt"), ("imu-csv", "imu.csv")):
        out[action] = tuple((*_run(tool.main, ["bag", action, str(demo_bag), "--output",
                                               str(d / f"{who}_{name}")]), d / f"{who}_{name}")
                            for tool, who in ((cli, "p"), (jcli, "j")))
    return out


def test_bag_subcommands_match_jax(demo_bag, exported, tmp_path):
    rc, out = _run(cli.main, ["bag", "info", str(demo_bag)])
    assert (rc, out) == _run(jcli.main, ["bag", "info", str(demo_bag)])
    info = json.loads(out)
    assert info["message_counts"] == {"/vectornav/imu": 30000, "/aft_mapped_to_init": 500}
    for (rc, out, p), (jrc, jout, j) in exported.values():
        assert rc == jrc == 0 and out.replace(str(p), "") == jout.replace(str(j), "")
        assert p.read_text() == j.read_text()
    fig = tmp_path / "imu.png"
    rc, out = _run(cli.main, ["bag", "imu-plot", str(demo_bag), "--output", str(fig),
                              "--device", "cpu"])
    assert rc == 0 and out == f"2 elevator event(s); figure -> {fig}\n"
    assert fig.stat().st_size > 5000


def test_bag_imu_csv_is_refused_by_the_pipeline_in_both_packages(exported, tmp_path):
    """A fault of the JAX package that the port keeps: ``bag imu-csv``
    writes the header ``t,ax,ay,az,gx,gy,gz``, and ``load_imu_data`` reads
    CSV with ``np.loadtxt`` and no ``skiprows``, so the bag -> CSV ->
    ``pipeline --imu`` chain raises in both packages. A whitespace table
    (``np.savetxt`` without a header) goes through."""
    csv = exported["imu-csv"][0][2]
    assert csv.read_text().startswith("t,ax,ay,az,gx,gy,gz\n")
    for pipe in (SemanticGatingPipeline(str(tmp_path), device="cpu"), JaxPipeline(str(tmp_path))):
        with pytest.raises(ValueError, match="could not convert"):
            pipe.load_imu_data(str(csv))
    txt = tmp_path / "imu.txt"
    np.savetxt(txt, np.loadtxt(csv, delimiter=",", skiprows=1)[:100])
    assert SemanticGatingPipeline(str(tmp_path), device="cpu").load_imu_data(str(txt)).shape == \
        (100, 7)


def test_pipeline_subcommand_writes_figures(tmp_path):
    traj, imu = make_demo_data()
    tpath, ipath = tmp_path / "traj.txt", tmp_path / "imu.txt"
    np.savetxt(tpath, traj)
    np.savetxt(ipath, imu)
    out = tmp_path / "out"
    rc, text = _run(cli.main, ["pipeline", "--trajectory", str(tpath), "--imu", str(ipath),
                               "--output", str(out), "--start-floor", "3", "--device", "cpu"])
    assert rc == 0 and "Elevator events: 2" in text
    for name in ("pipeline_floor_segmentation.png", "pipeline_3d_multifloor.png"):
        assert (out / name).stat().st_size > 5000, name
    assert (out / "semantic_gating_report.txt").read_text() in text
    with pytest.raises(ValueError, match="run the pipeline first"):
        SemanticGatingPipeline(str(out), device="cpu").visualize_3d()


def test_stream_subcommand_matches_jax():
    argv = ["stream", "--frames", "160", "--capacity", "64", "--micro-batch", "16"]
    rc, out = _run(cli.main, [*argv, "--device", "cpu"])
    jrc, jout = _run(jcli.main, argv)
    got, want = json.loads(out), json.loads(jout)
    assert rc == jrc == 0 and got["accepted_pairs"] > 0
    assert {k: v for k, v in got.items() if k != "sample_pairs"} == \
        {k: v for k, v in want.items() if k != "sample_pairs"}
    assert [p[:2] for p in got["sample_pairs"]] == [p[:2] for p in want["sample_pairs"]]
    np.testing.assert_allclose([p[2] for p in got["sample_pairs"]],
                               [p[2] for p in want["sample_pairs"]], atol=1e-6)


def test_check_data_and_layout_match_jax(tree, demo_bag, tmp_path):
    for argv in (["check-data", "--trajectory-root", str(tree), "--bag", str(demo_bag)],
                 ["check-data", "--trajectory-root", str(tmp_path / "none"),
                  "--bag", str(tmp_path / "missing.bag")],
                 ["layout", "--list"]):
        assert _run(cli.main, argv) == _run(jcli.main, argv), argv
    rc, out = _run(cli.main, ["check-data", "--trajectory-root", str(tree)])
    assert rc == 1 and "[ok] lego_loam: 4 sequence(s), 740 poses" in out and out.endswith("FAIL\n")
    for name in ("gating_monitor", "lego_loam", "orb_slam3"):
        p, j = tmp_path / f"p_{name}.json", tmp_path / f"j_{name}.json"
        args = [name, "--algorithm", "orb_slam3"]
        assert _run(cli.main, ["layout", *args, "-o", str(p)])[0] == 0
        assert _run(jcli.main, ["layout", *args, "-o", str(j)])[0] == 0
        assert p.read_text() == j.read_text()
