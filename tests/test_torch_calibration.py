"""The port's calibration converters against the JAX package's: the Kalibr
loaders, each writer's text (ORB-SLAM3, VINS-Fusion, Basalt, LeGO-LOAM)
and ``calibration_info`` identical character for character, on the
``sample_kalibr_yaml`` template and on a three-camera chain with the
golden baselines (0.164 m / 0.328 m), and the ``calib`` CLI's
``generate`` writing the same four files."""

import contextlib
import io
import json

import numpy as np
import pytest
import yaml

pytest.importorskip("jax")

import mlis_tpu.cli as jcli  # noqa: E402
import mlis_tpu.core.calibration as jcal  # noqa: E402
import mlis_tpu_torch.cli as cli  # noqa: E402
import mlis_tpu_torch.core.calibration as cal  # noqa: E402
from mlis_tpu_torch.ops.geometry import quat_to_matrix, se3_inverse  # noqa: E402

CHAIN_T = [[1.0, 0.0, 0.0, 0.164], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0],
           [0.0, 0.0, 0.0, 1.0]]


def _cam(intr, T=None):
    c = {"camera_model": "pinhole", "distortion_model": "radtan", "intrinsics": intr,
         "distortion_coeffs": [-0.2127, 0.1828, -0.0002, 0.0011], "resolution": [720, 540]}
    return {**c, "T_cn_cnm1": T} if T else c


@pytest.fixture
def files(tmp_path):
    """The sample template (cam0-cam1), a three-camera chain (cam0, cam1,
    cam3), the camera-IMU and IMU files."""
    sample = tmp_path / "sample.yaml"
    assert cal.sample_kalibr_yaml(sample) == jcal.sample_kalibr_yaml()
    chain = tmp_path / "chain.yaml"
    chain.write_text(yaml.dump({"cam0": _cam([891.08, 891.36, 368.84, 275.06]),
                                "cam1": _cam([893.63, 893.97, 376.95, 266.57], CHAIN_T),
                                "cam3": _cam([890.41, 890.60, 370.45, 281.40], CHAIN_T)}))
    cam_imu = tmp_path / "cam_imu.yaml"
    cam_imu.write_text(yaml.dump({"cam0": {"T_cam_imu": [
        [0.0, -1.0, 0.0, 0.05], [0.0, 0.0, -1.0, -0.03], [1.0, 0.0, 0.0, 0.02],
        [0.0, 0.0, 0.0, 1.0]]}}))
    imu = tmp_path / "imu.yaml"
    imu.write_text(yaml.dump({"imu0": {
        "update_rate": 200.0, "gyroscope_noise_density": 0.0001,
        "gyroscope_random_walk": 0.00001, "accelerometer_noise_density": 0.001,
        "accelerometer_random_walk": 0.0001}}))
    return {"sample": sample, "chain": chain, "cam_imu": cam_imu, "imu": imu}


@pytest.mark.parametrize("which, left, right", [("sample", "cam0", "cam1"),
                                                ("chain", "cam1", "cam3"),
                                                ("chain", "cam0", "cam3")])
def test_writers_match_jax(files, which, left, right):
    cams, jcams = cal.load_kalibr_cameras(files[which]), jcal.load_kalibr_cameras(files[which])
    assert list(cams) == list(jcams)
    for k in cams:
        assert vars(cams[k][0]) == vars(jcams[k][0])
        np.testing.assert_array_equal(cams[k][1].T, jcams[k][1].T)
    T = cal.load_camera_imu_calib(files["cam_imu"])
    jT = jcal.load_camera_imu_calib(files["cam_imu"])
    np.testing.assert_array_equal(T, jT)
    imu, jimu = cal.load_imu_params(files["imu"]), jcal.load_imu_params(files["imu"])
    assert vars(imu) == vars(jimu)
    assert cal.convert_to_orbslam3(cams, left, right) == jcal.convert_to_orbslam3(jcams, left,
                                                                                   right)
    assert cal.convert_to_vins_fusion(cams, T, imu, left, right) == \
        jcal.convert_to_vins_fusion(jcams, jT, jimu, left, right)
    basalt = cal.convert_to_basalt(cams, T, imu, left, right)
    assert basalt == jcal.convert_to_basalt(jcams, jT, jimu, left, right)
    e = json.loads(basalt)["value0"]["T_imu_cam"][0]  # a real quaternion of inv(T_cam_imu)
    np.testing.assert_allclose(quat_to_matrix([e["qx"], e["qy"], e["qz"], e["qw"]]),
                               se3_inverse(T)[:3, :3], atol=1e-9)
    assert cal.convert_to_lego_loam() == jcal.convert_to_lego_loam()
    assert cal.calibration_info(cams) == jcal.calibration_info(jcams)


def test_golden_baselines(files):
    cams = cal.load_kalibr_cameras(files["chain"])
    assert cal.compute_stereo_baseline(cams, "cam0", "cam1") == pytest.approx(0.164, abs=1e-3)
    assert cal.compute_stereo_baseline(cams, "cam1", "cam3") == pytest.approx(0.164, abs=1e-3)
    assert cal.compute_stereo_baseline(cams, "cam0", "cam3") == pytest.approx(0.328, abs=1e-3)
    np.testing.assert_allclose(cal.stereo_transform(cams, "cam0", "cam3")[:3, 3], [0.328, 0, 0],
                               atol=1e-9)
    assert "N_SCAN: 128" in cal.convert_to_lego_loam(ground_scan_ind=31, n_scan=128)


def _quiet(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_calib_cli_matches_jax(files, tmp_path):
    common = ["--cameras", str(files["chain"]), "--cam-imu", str(files["cam_imu"]),
              "--imu", str(files["imu"])]
    for fmt in ("orbslam3", "vins", "basalt", "lego-loam", "info"):
        rc, out = _quiet(cli.main, ["calib", fmt, *common])
        assert (rc, out) == _quiet(jcli.main, ["calib", fmt, *common]), fmt
        assert rc == 0 and out
    assert _quiet(cli.main, ["calib", "sample"]) == _quiet(jcli.main, ["calib", "sample"])
    for tool, name in ((cli, "p"), (jcli, "j")):
        rc, out = _quiet(tool.main,
                         ["calib", "generate", *common, "--output", str(tmp_path / name)])
        assert rc == 0 and out == f"4 configs -> {tmp_path / name}\n"
    for f in ("orbslam3.yaml", "vins_fusion.yaml", "basalt.json", "lego_loam.yaml"):
        assert (tmp_path / "p" / f).read_text() == (tmp_path / "j" / f).read_text(), f
    assert _quiet(cli.main, ["calib", "vins", "--cameras", str(files["chain"])])[0] == 2
    assert _quiet(cli.main, ["calib", "orbslam3"])[0] == 2  # --cameras is required
