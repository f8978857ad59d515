"""PipelineConfig across the packages: the same tree of fields with the
same defaults (but the trajectory root, which the port resolves under the
working directory), and a config saved by either package loads in the
other equal field by field."""

import dataclasses

import pytest

pytest.importorskip("jax")

from mlis_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from mlis_tpu_torch.config import PipelineConfig  # noqa: E402


def _edited(d):
    d["data"]["results_root"] = "/tmp/out"
    d["gating"]["floor"]["window_size"] = 40
    d["gating"]["candidates"]["distance_threshold"] = 3.5
    d["vpr"].update(method="salad", descriptor_dim=8448, batch_size=8, dtype="float32")
    d["verification"].update(ransac_prob=0.99, ransac_hypotheses=256, matcher="loftr")
    d["mesh"]["data_parallel"] = 4
    return d


def test_fields_and_defaults_match_jax(monkeypatch):
    monkeypatch.delenv("MLIS_TRAJECTORY_ROOT", raising=False)
    ours, theirs = PipelineConfig().to_dict(), JaxConfig().to_dict()
    assert ours["data"].pop("trajectory_root") == "reference/results/trajectories"
    theirs["data"].pop("trajectory_root")
    assert ours == theirs
    monkeypatch.setenv("MLIS_TRAJECTORY_ROOT", "/data/trajectories")
    assert PipelineConfig().data.trajectory_root == JaxConfig().data.trajectory_root


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_config_loads_in_the_other_package(tmp_path, writer):
    saver, loader = (PipelineConfig, JaxConfig) if writer == "port" else (JaxConfig, PipelineConfig)
    cfg = saver.from_dict(_edited(saver().to_dict()))
    path = tmp_path / "config.json"
    cfg.save(path)
    loaded = loader.load(path)
    assert loaded.to_dict() == cfg.to_dict()
    assert dataclasses.astuple(loaded) == dataclasses.astuple(cfg)
    assert loaded.vpr.method == "salad" and loaded.verification.ransac_hypotheses == 256
    assert PipelineConfig.load(path).to_dict() == JaxConfig.load(path).to_dict()
