"""The port's CLI (python -m mlis_tpu_torch) end to end on a temporary TUM
tree: `gate` and `evaluate` write the same JSON and markdown as mlis_tpu's
CLI (floats within 1e-12), `pgo` prints the demo's JSON (at a reduced
depth here: the CPU takes ~20 ms a CG step, the card runs the defaults in
chip_smoke.py phase 11), and the figure options write the JAX package's
figures."""

import contextlib
import functools
import io
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import mlis_tpu.cli as jcli  # noqa: E402
import mlis_tpu_torch.cli as cli  # noqa: E402
import mlis_tpu_torch.opt.demo as demo  # noqa: E402
from test_torch_eval_host import _same, _tree  # noqa: E402


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("trajectories")
    _tree(root)
    return root


def test_gate_cli_matches(tree, tmp_path):
    args = ["--trajectory-root", str(tree), "--algorithms", "orb_slam3", "lego_loam"]
    rc, out = _run(cli.main, ["gate", "--output", str(tmp_path / "p"), "--device", "cpu", *args])
    jrc, jout = _run(jcli.main, ["gate", "--output", str(tmp_path / "j"), *args])
    assert rc == jrc == 0
    for name in ("semantic_gating_metrics.json",):
        _same(json.loads((tmp_path / "p" / name).read_text()),
              json.loads((tmp_path / "j" / name).read_text()))
    md = (tmp_path / "p" / "semantic_gating_comparison.md").read_text()
    assert md == (tmp_path / "j" / "semantic_gating_comparison.md").read_text()
    assert md in out and "ORB-SLAM3 SEMANTIC GATING ANALYSIS" in out
    metrics = json.loads((tmp_path / "p" / "semantic_gating_metrics.json").read_text())
    report = (tmp_path / "p" / "lego_loam_semantic_analysis.txt").read_text()
    lc = metrics["lego_loam"]["loop_closure"]
    assert f"Cross-floor rate: {lc['cross_floor_rate']:.1%}" in report
    fig_args = ["gate", "--figures", "--algorithms", "lego_loam", "--trajectory-root", str(tree)]
    _run(cli.main, [*fig_args, "--output", str(tmp_path / "pf"), "--device", "cpu"])
    _run(jcli.main, [*fig_args, "--output", str(tmp_path / "jf")])
    for name in ("lego_loam_floor_segmentation.png", "lego_loam_3d_multifloor.png",
                 "lego_loam_loop_closure_gating.png", "rejection_rates.png"):
        assert (tmp_path / "pf" / name).read_bytes() == (tmp_path / "jf" / name).read_bytes(), name


@pytest.mark.parametrize("extra", [[], ["--proper-se3", "--fast"]])
def test_evaluate_cli_matches(tree, tmp_path, extra):
    args = ["--trajectory-root", str(tree), *extra]
    rc, out = _run(cli.main, ["evaluate", "--output", str(tmp_path / "p"), *args])
    jrc, jout = _run(jcli.main, ["evaluate", "--output", str(tmp_path / "j"), *args])
    assert rc == jrc == 0 and out == jout
    _same(json.loads((tmp_path / "p" / "final_evaluation.json").read_text()),
          json.loads((tmp_path / "j" / "final_evaluation.json").read_text()))


def test_pgo_cli_prints_the_demo(monkeypatch, tmp_path):
    small = functools.partial(demo.run_pgo_demo, num_iters=1, cg_iters=4)
    monkeypatch.setattr(demo, "run_pgo_demo", small)
    fig = tmp_path / "pgo.png"
    rc, out = _run(cli.main, ["pgo", "--seed", "0", "--device", "cpu", "--figure", str(fig)])
    assert rc == 0
    got = json.loads(out)
    assert got["figure"] == str(fig) and fig.stat().st_size > 5000
    assert got["n_poses"] == 218 and got["gate_correct"] and got["n_candidates"] == 23
    for v in ("odometry", "gated", "ungated", "sc", "gnc", "pcm"):
        assert np.isfinite(got[f"{v}_ate_rmse"]) and np.isfinite(got[f"{v}_cost_final"]), v
    assert {"sc_false_disabled", "gnc_true_kept", "pcm_false_removed"} <= set(got)
    seen = {}
    monkeypatch.setattr(demo, "run_pgo_demo", lambda **kw: seen.update(kw) or {"ok": 1})
    rc, out = _run(cli.main, ["pgo", "--seed", "3", "--no-priors", "--huber-delta", "2.0",
                              "--device", "cpu"])
    assert rc == 0 and json.loads(out) == {"ok": 1}
    assert seen == dict(seed=3, huber_delta=2.0, use_priors=False, return_trajectories=False,
                        device="cpu")
    assert _run(cli.main, [])[0] == 1  # no subcommand: help
