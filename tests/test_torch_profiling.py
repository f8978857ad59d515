"""The port's profiling and roofline utilities: the roofline's byte and
FLOP counts equal the JAX package's functions, the fractions follow from
the H100's peaks (989 TFLOP/s dense bf16, 3.35 TB/s HBM3), StageTimer runs
on the CPU, and profile_trace writes a Chrome trace."""

import json
import time

import pytest
import torch

pytest.importorskip("jax")

import mlis_tpu.utils.roofline as jrl  # noqa: E402
import mlis_tpu_torch.utils.roofline as rl  # noqa: E402
from mlis_tpu_torch.utils.profiling import StageTimer, profile_trace  # noqa: E402

COUNTS = [
    ("grayscale_bytes", (128, 270, 360, 264, 360)),
    ("superpoint_bytes", (128, 264, 360)),
    ("resnet50_stage3_bytes", (128, 320, 320)),
    ("retrieval_bytes", (128, 4096, 10)),
    ("matcher_stage_bytes", (300, 512)),
    ("matcher_stage_bytes", (17, 2048, 256, 9, 4, 256, 4)),
    ("ransac_bytes", (300, 512)),
    ("ransac_flops", (300, 512, 256)),
    ("retrieval_flops", (128, 4096)),
    ("resnet50_stage3_flops", (320, 320)),
    ("superpoint_flops", (264, 360)),
    ("matcher_flops", (512,)),
]


@pytest.mark.parametrize("name, args", COUNTS)
def test_counts_match_jax(name, args):
    assert getattr(rl, name)(*args) == getattr(jrl, name)(*args)


def test_fractions_follow_the_h100_peaks():
    assert (rl.H100_PEAK_BF16, rl.H100_HBM_BYTES_PER_S) == (989e12, 3.35e12)
    s = rl.StageRoofline("match", 0.5, 989e12 * 0.5 * 0.6, 3.35e12 * 0.5 * 0.1)
    assert s.frac_tensor == pytest.approx(0.6) and s.frac_hbm == pytest.approx(0.1)
    assert s.bound == "tensor" and s.tflops == pytest.approx(593.4)
    assert rl.StageRoofline("ransac", 1.0, 1e12, 3.35e12 * 0.4).bound == "HBM"
    assert rl.StageRoofline("idle", 1.0, 1e9, 1e9).bound == "overhead"
    assert rl.StageRoofline("none", 0.0, 1.0, 1.0).row()["frac_tensor"] == 0.0
    # the same stage against the JAX package's v5e peaks: the same rates
    ours, theirs = rl.StageRoofline("m", 0.5, 1e12, 1e9), jrl.StageRoofline("m", 0.5, 1e12, 1e9)
    assert (ours.tflops, ours.gbps) == (theirs.tflops, theirs.gbps)
    assert ours.frac_tensor * rl.H100_PEAK_BF16 == \
        pytest.approx(theirs.frac_mxu * jrl.V5E_PEAK_BF16)
    table = rl.format_table([s, rl.StageRoofline("ransac", 0.002, 1e9, 5e9)])
    assert "%TC" in table and "MXU" not in table and table.splitlines()[2].startswith("match")


def test_stage_timer_and_trace_on_cpu(tmp_path):
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with timer.stage("sleep"):
        time.sleep(0.01)
    rep = timer.report()
    assert rep["matmul"]["calls"] == 3 and rep["sleep"]["total_s"] >= 0.01
    rows = timer.summary().splitlines()[1:]  # slowest stage first
    assert [r.split()[0] for r in rows] == sorted(rep, key=lambda k: -rep[k]["total_s"])
    timer.save(str(tmp_path / "stages.json"))
    assert json.loads((tmp_path / "stages.json").read_text()) == rep
    with profile_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(32, 32).sum()
    assert log_dir == str(tmp_path / "trace")
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])
