"""The port's ``all`` subcommand writing every figure and artifact on
``--device cpu`` over a small TUM tree, and ``fullgate``'s flags, defaults
and synthetic scene against mlis_tpu's CLI."""

import contextlib
import io

import numpy as np
import pytest

pytest.importorskip("jax")

import mlis_tpu.cli as jcli  # noqa: E402
import mlis_tpu_torch.cli as cli  # noqa: E402
from test_torch_cli_io import small_tree  # noqa: E402


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_all_subcommand_writes_every_artifact(tmp_path):
    tree = small_tree(tmp_path / "trajectories")
    out = tmp_path / "results"
    rc, text = _run(cli.main, ["all", "--trajectory-root", str(tree), "--output", str(out),
                               "--device", "cpu"])
    assert rc == 0 and text.endswith(f"done; results under {out}\n")
    figs = out / "figures"
    pngs = ["figure6.png", "figure7.png", "rpe_boxplot.png", "paper_comparison.png",
            "all_floors_overview.png", *(f"trajectory_2d_{f}.png" for f in
                                         ("5th_floor", "1st_floor", "4th_floor", "2nd_floor"))]
    for name in pngs:
        assert (figs / name).stat().st_size > 5000, name
    assert "<canvas" in (figs / "trajectory_3d.html").read_text()
    for algo in ("orb_slam3", "droid_slam", "lego_loam"):
        for kind in ("floor_segmentation", "3d_multifloor", "loop_closure_gating"):
            assert (out / "semantic_gating" / f"{algo}_{kind}.png").stat().st_size > 5000
        assert (out / "semantic_gating" / f"{algo}_semantic_analysis.txt").exists()
    for name in ("final_evaluation.json", "table_iv.csv", "summary_tables.txt",
                 "semantic_evaluation.json", "semantic_evaluation.md"):
        assert (out / "metrics" / name).stat().st_size > 0, name
    assert (out / "BENCHMARK_RESULTS_SUMMARY.md").exists()
    with pytest.raises(SystemExit):
        cli.main(["stream", "--unknown-flag"])


def test_fullgate_subcommand_matches_jax_wiring(monkeypatch):
    """fullgate's flags, defaults and synthetic scene (64 keyframes at
    540x720) reach FullGatePipeline as in mlis_tpu's CLI; the gate itself
    is held against the JAX package in test_torch_full_gate.py and runs on
    the card in chip_smoke.py phase 15."""
    import mlis_tpu.gating.full_gate as jfg
    import mlis_tpu_torch.gating.full_gate as fg

    seen = {}

    def stub(who):
        class Pipe:
            def __init__(self, **kw):
                seen[who] = {"init": kw}

            def process(self, images, timestamps, floors, K, **kw):
                seen[who].update(images=np.asarray(images), timestamps=timestamps,
                                 floors=floors, K=K, kw=kw)
                return type("R", (), {"summary": lambda self: {"total_pairs": 0}})()
        return Pipe

    monkeypatch.setattr(fg, "FullGatePipeline", stub("port"))
    monkeypatch.setattr(jfg, "FullGatePipeline", stub("jax"))
    argv = ["fullgate", "--vpr", "cricavpr", "--similarity-threshold", "0.4",
            "--survivor-budget", "96", "--detect-scale", "0.5", "--fx", "350"]
    assert _run(cli.main, [*argv, "--device", "cpu"]) == _run(jcli.main, argv)
    port, ref = seen["port"], seen["jax"]
    assert port["init"] == {**ref["init"], "device": "cpu"}
    assert port["images"].shape == (64, 540, 720, 3)
    for k in ("images", "timestamps", "floors", "K"):
        np.testing.assert_array_equal(port[k], ref[k])
    assert port["kw"] == ref["kw"] == {"survivor_budget": 96}
    _run(cli.main, ["fullgate", "--device", "cpu"])
    assert seen["port"]["init"] == dict(vpr_method="mixvpr", matcher_type="lightglue",
                                        similarity_threshold=0.5, detect_scale=1.0, device="cpu")
