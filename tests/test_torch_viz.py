"""The port's figures against the JAX package's (tests/test_viz.py and
tests/test_viz_tail.py mirrored): every figure function writes the same
PNG bytes from the same inputs (matplotlib's Agg output is deterministic),
segment_by_floor_height and detect_loop_closure_events give the same
numbers, the paper figures 6 and 7 over a TUM tree and the Figure-6 LC
pair are byte-identical, the interactive HTML is the same text and the
Foxglove layouts the same dicts."""

import json
from collections import namedtuple

import numpy as np
import pytest

pytest.importorskip("jax")

import mlis_tpu.viz.figures as jfig  # noqa: E402
import mlis_tpu.viz.live as jlive  # noqa: E402
import mlis_tpu.viz.paper_figures as jpaper  # noqa: E402
import mlis_tpu_torch.viz.figures as fig  # noqa: E402
import mlis_tpu_torch.viz.live as live  # noqa: E402
import mlis_tpu_torch.viz.paper_figures as paper  # noqa: E402
from test_torch_eval_host import _tree  # noqa: E402

Event = namedtuple("Event", "start_time end_time direction duration")


def _eval_results():
    return {
        "orb_slam3": {
            "5th_floor": {"endpoint_drift": 0.5, "paper_ate": 0.516,
                          "rpe_1m": {"rmse": 1.2, "mean": 1.0}},
            "2nd_floor": {"endpoint_drift": 0.3, "paper_ate": 0.310,
                          "rpe_1m": {"rmse": 0.9, "mean": 0.8}},
        },
        "droid_slam": {
            "5th_floor": {"endpoint_drift": 0.4, "paper_ate": 0.441,
                          "rpe_1m": {"rmse": 0.7, "mean": 0.6}},
            "2nd_floor": {"endpoint_drift": 0.2, "paper_ate": 0.214},
        },
    }


def _tum(rng, n=120):
    return np.column_stack([np.arange(n) * 0.5, np.cumsum(rng.normal(size=(n, 3)), axis=0),
                            np.zeros((n, 3)), np.ones(n)])


def _cases(tmp_path):
    """{function name: positional args} for every figure function; the same
    draws for both packages."""
    rng = np.random.default_rng(3)
    tum = _tum(rng)
    floors = np.repeat([1, 2, 5], 40)
    log = tmp_path / "log.json"
    log.write_text(json.dumps({"loss": [[10, 1.0], [20, 0.5], [30, 0.4]],
                               "eval": [[0, 0.0, 0.0], [20, 0.5, 0.8]]}))
    t = np.linspace(0, 60, 3000)
    az = 9.81 + rng.normal(0, 0.05, 3000)
    return dict([
        ("plot_floor_segmentation", (tum, floors)),
        ("plot_loop_closure_gating", (tum, floors, [(5, 90), (10, 30), (50, 70)])),
        ("plot_multifloor_3d", (tum, floors)),
        ("plot_trajectory_comparison", ({"a": tum[:, 1:4], "b": tum[:, 1:4] * 1.1},)),
        ("plot_error_accumulation", ({"a": np.abs(rng.normal(size=50))},)),
        ("plot_segment_heatmap", ({"a": [0.1, 0.2, 0.3], "b": [0.3, 0.2, 0.1]},)),
        ("plot_rpe_boxplot", (_eval_results(),)),
        ("plot_paper_comparison", (_eval_results(),)),
        ("plot_all_floors_overview",
         ({"5th_floor": tum, "1st_floor": tum[:60], "2nd_floor": None},)),
        ("plot_elevator_detection", (t, az, [Event(10.0, 15.0, "down", 5.0),
                                             Event(40.0, 44.0, "up", 4.0)])),
        ("plot_rejection_rates", ({"orb_slam3": 0.707, "lego_loam": 0.753},)),
        ("plot_pgo_comparison", (tum[:, 1:4], {"gated": tum[:, 1:4] + 0.1}, floors)),
        ("plot_training_curves", (log,)),
    ])


FIGURES = ["plot_floor_segmentation", "plot_loop_closure_gating", "plot_multifloor_3d",
           "plot_trajectory_comparison", "plot_error_accumulation", "plot_segment_heatmap",
           "plot_rpe_boxplot", "plot_paper_comparison", "plot_all_floors_overview",
           "plot_elevator_detection", "plot_rejection_rates", "plot_pgo_comparison",
           "plot_training_curves"]


@pytest.mark.parametrize("name", FIGURES)
def test_every_figure_matches_jax(tmp_path, name):
    args = _cases(tmp_path)[name]
    ours = getattr(fig, name)(*args, tmp_path / "p.png")
    theirs = getattr(jfig, name)(*args, tmp_path / "j.png")
    assert ours.stat().st_size > 1000
    assert ours.read_bytes() == theirs.read_bytes()
    assert sorted(FIGURES) == sorted(n for n in dir(jfig) if n.startswith("plot_"))


def test_segmentation_and_lc_events_match_jax():
    z = np.concatenate([np.zeros(10), np.full(10, 4.5), np.full(10, 18.0), np.full(5, 9.0)])
    pos = np.column_stack([np.arange(35), np.arange(35), z])
    heights = {"1st_floor": 0.0, "2nd_floor": 4.5, "5th_floor": 18.0, "4th_floor": 13.5}
    segs = fig.segment_by_floor_height(pos, heights)
    ref = jfig.segment_by_floor_height(pos, heights)
    assert list(segs) == list(ref) == ["1st_floor", "2nd_floor", "5th_floor"]
    for k in segs:
        np.testing.assert_array_equal(segs[k], ref[k])
    assert segs["1st_floor"].sum() == 10

    n = 400
    t = np.linspace(0, 4 * np.pi, n)
    base = np.column_stack([np.cos(t) * 10, np.sin(t) * 10, np.zeros(n)])
    with_lc = base.copy()
    with_lc[250:] += np.array([8.0, 0.0, 0.0])  # the second revolution snapped onto the first
    kw = dict(jump_threshold=2.0, proximity=3.0, min_index_gap=50)
    events = fig.detect_loop_closure_events(with_lc, base, **kw)
    assert events == jfig.detect_loop_closure_events(with_lc, base, **kw) and events
    assert all(abs(a - b) > 50 and np.linalg.norm(with_lc[a] - with_lc[b]) < 3.0
               for a, b in events)
    assert fig.detect_loop_closure_events(base, base) == []
    assert fig.detect_loop_closure_events(base[:-1], base) == []


def test_paper_figures_match_jax(tmp_path):
    root = tmp_path / "trajectories"
    _tree(root)
    for name in ("generate_figure6", "generate_figure7"):
        ours = getattr(paper, name)(str(root), tmp_path / f"p_{name}.png")
        theirs = getattr(jpaper, name)(str(root), tmp_path / f"j_{name}.png")
        assert ours.read_bytes() == theirs.read_bytes(), name
    assert paper.generate_figure7(str(root), tmp_path / "none.png", floor="3rd_floor") is None

    n = 300
    t = np.linspace(0, 6 * np.pi, n)
    no_lc = np.column_stack([10 * np.cos(t), 6 * np.sin(t), np.repeat([0.0, 4.5, 18.0], n // 3)])
    with_lc = no_lc.copy()
    with_lc[2 * (n // 3):, 2] = 0.3  # perceptual aliasing: the 5th floor snapped onto the 1st
    for pair in (with_lc, None):
        ours = paper.generate_figure6_lc_pair(no_lc, pair, tmp_path / "p6.png")
        theirs = jpaper.generate_figure6_lc_pair(no_lc, pair, tmp_path / "j6.png")
        assert ours.stat().st_size > 5000 and ours.read_bytes() == theirs.read_bytes()


def test_interactive_html_and_layouts_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    tum = _tum(rng, 300)
    floors = np.repeat([1, 2, 5], 100)
    links = [(5, 205), (10, 60)]
    p = fig.export_interactive_3d_html(tum, floors, tmp_path / "p.html", link_pairs=links,
                                       max_points_per_floor=40)
    html = p.read_text()
    assert html == jfig.export_interactive_3d_html(tum, floors, tmp_path / "j.html",
                                                   link_pairs=links,
                                                   max_points_per_floor=40).read_text()
    assert "<canvas" in html and '"valid": false' in html and '"valid": true' in html
    assert list(live.LAYOUTS) == list(jlive.LAYOUTS)
    for name in live.LAYOUTS:
        got = live.save_layout(name, str(tmp_path / f"{name}.json"), algorithm="orb_slam3")
        assert got == jlive.save_layout(name, str(tmp_path / f"j{name}.json"),
                                        algorithm="orb_slam3")
        assert json.loads((tmp_path / f"{name}.json").read_text()) == got
    with pytest.raises(ValueError, match="unknown layout"):
        live.save_layout("nope", str(tmp_path / "x.json"))
