"""The port's candidate sweep, floor gate and sweep analysis against
mlis_tpu. Sweep counts must be identical integers on every case of
tests/test_pairwise.py and on the published reference counts."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.config import DataConfig  # noqa: E402
from mlis_tpu.gating.gate import ContextualPriorFactor as JaxPriors  # noqa: E402
from mlis_tpu.gating.gate import SemanticLoopClosureGate as JaxGate  # noqa: E402
from mlis_tpu.gating.gate import gate_mask as jax_gate_mask  # noqa: E402
from mlis_tpu.ops import pairwise as jpw  # noqa: E402

from mlis_tpu_torch.gating.gate import (  # noqa: E402
    ContextualPriorFactor,
    SemanticLoopClosureGate,
    gate_mask,
)
from mlis_tpu_torch.gating.integration import analyze  # noqa: E402
from mlis_tpu_torch.ops import pairwise as pw  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_TRAJECTORIES = DataConfig().trajectory_root  # MLIS_TRAJECTORY_ROOT or the default
# the published counts (tests/test_parity_reference.py), pinned here too
PUBLISHED = {
    "orb_slam3": (5110618, 1498091, 3612527),
    "droid_slam": (223762, 45357, 178405),
    "lego_loam": (87044, 21477, 65567),
}


def _random_cloud(n, rng, scale=30.0):
    centers = rng.normal(size=(8, 3)) * scale
    return centers[rng.integers(0, 8, size=n)] + rng.normal(size=(n, 3))


def _boundary_cloud():
    pos = np.zeros((300, 3))
    pos[:, 0] = np.arange(300) * 10.0
    pos[250] = pos[0] + [2.0, 0, 0]
    pos[251] = pos[1] + [2.0 - 1e-9, 0, 0]
    pos[252] = pos[2] + [2.0 + 1e-9, 0, 0]
    return pos, np.ones(300, dtype=int)


@pytest.mark.parametrize("n,min_gap", [(50, 30), (60, 25), (700, 30), (900, 25), (1500, 30)])
def test_counts_identical_to_mlis_tpu(n, min_gap):
    rng = np.random.default_rng(n)
    pos = _random_cloud(n, rng)
    floors = rng.integers(1, 6, size=n)
    ref_host = jpw.candidate_counts_host(pos, floors, radius=2.0, min_gap=min_gap, tile=256)
    got = pw.candidate_counts(pos, floors, radius=2.0, min_gap=min_gap, device="cpu")
    assert got == ref_host
    assert pw.candidate_counts_host(pos, floors, 2.0, min_gap, tile=256) == ref_host
    if n <= 900:  # the Pallas kernel in interpret mode, as tests/test_pairwise.py runs it
        assert got == jpw.candidate_counts(pos, floors, radius=2.0, min_gap=min_gap)


def test_boundary_pairs_resolve_in_float64():
    pos, floors = _boundary_cloud()
    got = pw.candidate_counts(pos, floors, radius=2.0, min_gap=100, device="cpu")
    assert got == jpw.candidate_counts(pos, floors, radius=2.0, min_gap=100)
    assert got[0] == 2  # exactly-at and just-in count; just-out does not


def test_all_tiles_list_counts_the_same():
    """The full tile grid (the JAX package's _count_kernel launch) gives the
    same counts as the upper-triangle list."""
    rng = np.random.default_rng(5)
    pos = _random_cloud(1300, rng)
    floors = rng.integers(1, 6, size=1300)
    p, f, ti, tj = pw.pack_sweep_inputs(pos, floors, 40, "cpu")
    ai, aj = (torch.as_tensor(t) for t in pw.all_tiles(1300))
    assert pw.tri_count(p, f, ai, aj, 40, 4.0) == pw.tri_count(p, f, ti, tj, 40, 4.0)
    assert len(ai) == 9 and len(ti) < len(ai)


@pytest.mark.parametrize("n,min_gap", [(1, 100), (511, 100), (1025, 0), (19163, 100)])
def test_tile_list_matches_mlis_tpu(n, min_gap):
    n_i = -(-n // 512)
    ti_idx, tj_idx = np.meshgrid(np.arange(n_i), np.arange(n_i), indexing="ij")
    keep = (tj_idx + 1) * 512 - 1 >= ti_idx * 512 + min_gap
    ti, tj = pw.tile_list(n, min_gap)
    np.testing.assert_array_equal(ti, ti_idx[keep])
    np.testing.assert_array_equal(tj, tj_idx[keep])
    assert ti.dtype == tj.dtype == np.int32
    ii, jj = np.meshgrid(np.arange(min(n, 1200)), np.arange(min(n, 1200)), indexing="ij")
    if n <= 1200:
        assert pw.index_valid_pairs(n, min_gap) == int((jj - ii >= min_gap).sum())


# n at the tile edges and at DROID-SLAM's and LeGO-LOAM's published trajectory
# sizes (tests/test_parity_reference.py); min_gap from none to past n
@pytest.mark.parametrize("n", [1, 511, 512, 513, 1926, 2406])
@pytest.mark.parametrize("gap", ["0", "1", "100", "n", "n+5"])
def test_counts_identical_to_mlis_tpu_at_trajectory_sizes(n, gap):
    min_gap = {"0": 0, "1": 1, "100": 100, "n": n, "n+5": n + 5}[gap]
    rng = np.random.default_rng(n + 7 * min_gap)
    pos = _random_cloud(n, rng, scale=6.0)  # denser than a walk: many pairs within r
    floors = rng.integers(1, 6, size=n)
    want = jpw.candidate_counts_host(pos, floors, radius=2.0, min_gap=min_gap)
    got = pw.candidate_counts(pos, floors, radius=2.0, min_gap=min_gap, device="cpu")
    assert got == want
    if len(pw.tile_list(n, min_gap)[0]):  # the JAX kernel takes no empty tile list
        assert got == jpw.candidate_counts(pos, floors, radius=2.0, min_gap=min_gap)
    else:
        assert got == (0, 0, 0)


def _rect_counts(pos, floors, rect, min_gap, r2):
    """(total, same_floor) of the pairs (i, j) in one block's rectangle with
    j - i >= min_gap, d2 = dx*dx + dy*dy + dz*dz in float64."""
    i_lo, i_hi, j_lo, j_hi = (int(v) for v in rect)
    d = [pos[i_lo:i_hi, None, k] - pos[None, j_lo:j_hi, k] for k in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    ok = (np.arange(j_lo, j_hi)[None, :] - np.arange(i_lo, i_hi)[:, None] >= min_gap) & (d2 <= r2)
    return int(ok.sum()), int((ok & (floors[i_lo:i_hi, None] == floors[None, j_lo:j_hi])).sum())


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(n=st.integers(1, 1300), gap_frac=st.floats(-0.3, 1.2), sms=st.integers(1, 264),
       full=st.booleans())
def test_split_blocks_cover_each_pair_once(n, gap_frac, sms, full):
    """The kernel's cut of every listed tile into 2**sweep_split blocks: the
    blocks that run cover each index-valid pair of the listed tiles exactly
    once, and the plain counts summed over them equal tri_count_plain's."""
    min_gap = int(round(gap_frac * n))
    ti, tj = pw.all_tiles(n) if full else pw.tile_list(n, min_gap)
    log_split = pw.sweep_split(len(ti), sms)
    assert pw.MIN_AUTO_LOG_SPLIT <= log_split <= pw.MAX_AUTO_LOG_SPLIT
    assert (len(ti) << log_split) >= min(pw.BLOCKS_PER_SM * sms, len(ti) << pw.MAX_AUTO_LOG_SPLIT)
    assert log_split == pw.MIN_AUTO_LOG_SPLIT or (len(ti) << (log_split - 1)) < pw.BLOCKS_PER_SM * sms
    blocks = pw.split_blocks(ti, tj, n, min_gap, log_split)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    valid = jj - ii >= min_gap
    want = np.zeros((n, n), np.int32)
    for a, b in zip(ti, tj):
        want[a * 512:(a + 1) * 512, b * 512:(b + 1) * 512] = 1
    got = np.zeros((n, n), np.int32)
    for i_lo, i_hi, j_lo, j_hi in blocks:
        assert 0 <= i_lo < i_hi <= n and 0 <= j_lo < j_hi <= n
        got[i_lo:i_hi, j_lo:j_hi] += 1
    np.testing.assert_array_equal(got * valid, want * valid)
    # every block that runs holds a valid pair; its corner is the largest j - i
    assert all(j_hi - 1 - i_lo >= min_gap for i_lo, _, _, j_hi in blocks)

    rng = np.random.default_rng(n)
    pos = _random_cloud(n, rng, scale=4.0)
    floors = rng.integers(1, 4, size=n)
    sums = np.sum([_rect_counts(pos, floors, r, min_gap, 4.0) for r in blocks], axis=0,
                  dtype=np.int64).reshape(-1)
    sums = (int(sums[0]), int(sums[1])) if len(blocks) else (0, 0)
    p, f = torch.as_tensor(pos), torch.as_tensor(floors.astype(np.int32))
    assert sums == pw.tri_count_plain(p, f, torch.as_tensor(ti), torch.as_tensor(tj), min_gap, 4.0)


@pytest.mark.parametrize("log_split", range(9))
def test_split_blocks_at_every_cut(log_split):
    """Each cut the kernel takes (1 to 256 blocks a tile): the blocks of one
    512 x 512 tile are 2**(log_split // 2) row strips times the rest in
    column strips, and together they hold the tile's pairs."""
    n = 1024
    ti, tj = pw.all_tiles(n)
    blocks = pw.split_blocks(ti, tj, n, -n, log_split)  # every pair index-valid
    assert len(blocks) == len(ti) << log_split
    rows = 512 >> (log_split // 2)
    cols = 512 >> (log_split - log_split // 2)
    first = blocks[: 1 << log_split]
    np.testing.assert_array_equal(np.unique(first[:, 0]), np.arange(0, 512, rows))
    np.testing.assert_array_equal(np.unique(first[:, 2]), np.arange(0, 512, cols))
    assert int(((blocks[:, 1] - blocks[:, 0]) * (blocks[:, 3] - blocks[:, 2])).sum()) == n * n


def test_sweep_split_fills_the_card_at_trajectory_sizes():
    """On an H100's 132 SMs: DROID-SLAM's 1,926 poses (10 tiles), LeGO-LOAM's
    2,406 (15), the 4,000-pose cloud's upper triangle (36) and full grid
    (64) and ORB-SLAM3's 19,163 (741) each give the grid at least two blocks
    an SM; the cuts are the ones tools/sweep_ab.py timed fastest (or within
    a few percent) on an H100."""
    want = {1926: 6, 2406: 6, 4000: 5, -4000: 5, 19163: 3}
    for n, tiles in ((1926, "tri"), (2406, "tri"), (4000, "tri"), (-4000, "all"), (19163, "tri")):
        ti = pw.tile_list(abs(n), 100)[0] if tiles == "tri" else pw.all_tiles(abs(n))[0]
        log_split = pw.sweep_split(len(ti), 132)
        assert len(ti) << log_split >= 2 * 132, (n, len(ti), log_split)
        assert log_split == want[n], (n, len(ti), log_split)


def test_pairs_host_consistent_with_counts():
    rng = np.random.default_rng(0)
    pos = _random_cloud(500, rng)
    floors = rng.integers(1, 6, size=500)
    qi, mi, d = pw.candidate_pairs_host(pos, floors, radius=2.0, min_gap=40, tile=128)
    rq, rm, rd = jpw.candidate_pairs_host(pos, floors, radius=2.0, min_gap=40, tile=128)
    np.testing.assert_array_equal(qi, rq)
    np.testing.assert_array_equal(mi, rm)
    np.testing.assert_array_equal(d, rd)
    assert len(qi) == pw.candidate_counts(pos, floors, 2.0, 40, device="cpu")[0]


def test_wrapper_rejects_bad_inputs():
    pos = torch.zeros(10, 3, dtype=torch.float64)
    fl = torch.zeros(10, dtype=torch.int32)
    ti, tj = (torch.as_tensor(t) for t in pw.tile_list(10, 2))
    with pytest.raises(ValueError, match="float64"):
        pw.tri_count(pos.float(), fl, ti, tj, 2, 4.0)
    with pytest.raises(ValueError, match="int32"):
        pw.tri_count(pos, fl.long(), ti, tj, 2, 4.0)
    with pytest.raises(ValueError, match="contiguous"):
        pw.tri_count(torch.zeros(3, 10, dtype=torch.float64).T, fl, ti, tj, 2, 4.0)
    with pytest.raises(ValueError, match="no path"):
        pw.tri_count(pos.to("meta"), fl.to("meta"), ti.to("meta"), tj.to("meta"), 2, 4.0)
    assert pw.candidate_counts(np.zeros((0, 3)), np.zeros(0), device="cpu") == (0, 0, 0)


@pytest.mark.skipif(not os.path.isdir(REFERENCE_TRAJECTORIES),
                    reason="published reference trajectories not available")
@pytest.mark.parametrize("algo", sorted(PUBLISHED))
def test_published_counts(algo, tmp_path):
    from mlis_tpu.gating.integration import INTEGRATIONS

    integ = INTEGRATIONS[algo](REFERENCE_TRAJECTORIES, str(tmp_path))
    combined, floors = integ.load_and_combine()
    got = pw.candidate_counts(combined[:, 1:4], floors, device="cpu")
    assert got == PUBLISHED[algo]


def test_analyze_drives_the_sweep_and_gate():
    rng = np.random.default_rng(3)
    pos = _random_cloud(1200, rng)
    floors = rng.integers(1, 4, size=1200)
    analysis, gate = analyze(pos, floors, 2.0, 100, with_examples=True, device="cpu")
    total, same, cross = jpw.candidate_counts_host(pos, floors, 2.0, 100)
    assert (analysis.total_candidates, analysis.same_floor_candidates,
            analysis.cross_floor_candidates) == (total, same, cross)
    assert analysis.cross_floor_rate == pytest.approx(cross / total)
    stats = gate.get_stats()
    assert (stats["accepted"], stats["rejected_cross_floor"]) == (same, cross)
    assert 0 < len(analysis.example_cross_floor_pairs) <= 5
    for q, m, fq, fm in analysis.example_cross_floor_pairs:
        assert fq != fm and m - q >= 100


@pytest.mark.parametrize("strict", [True, False])
def test_gate_matches_mlis_tpu(strict):
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 4, size=50)
    q = rng.integers(0, 50, size=200)
    m = rng.integers(0, 50, size=200)
    want = np.asarray(jax_gate_mask(jnp.asarray(labels), jnp.asarray(q), jnp.asarray(m), strict))
    got = gate_mask(torch.as_tensor(labels), torch.as_tensor(q), torch.as_tensor(m), strict)
    np.testing.assert_array_equal(got.numpy(), want)

    ref, port = JaxGate(labels, strict_mode=strict), SemanticLoopClosureGate(
        labels, strict_mode=strict, device="cpu")
    for sl in (slice(0, 120), slice(120, 200)):  # statistics accumulate over batches
        np.testing.assert_array_equal(port.gate_batch(q[sl], m[sl]), ref.gate_batch(q[sl], m[sl]))
    assert port.get_stats() == ref.get_stats()
    for a, b in zip(ContextualPriorFactor(labels).floor_priors(3.5, 0.2),
                    JaxPriors(labels).floor_priors(3.5, 0.2)):
        np.testing.assert_array_equal(a, b)


def test_port_runs_without_jax_or_mlis_tpu():
    """Every module of mlis_tpu_torch imports, and the sweep, the gate paths,
    the pose-graph demo, two VPR trainer steps, one MatcherTrainer step, a
    bag round trip through the native runtime and the public API run, with
    jax, flax, optax and orbax absent and any mlis_tpu import refused."""
    code = textwrap.dedent("""
        import sys
        for banned in ("jax", "flax", "optax", "orbax"):
            sys.modules[banned] = None

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name == "mlis_tpu" or name.startswith("mlis_tpu."):
                    raise ImportError("mlis_tpu is refused in this test")
                return None

        sys.meta_path.insert(0, Refuse())
        import importlib, pkgutil
        import numpy as np
        import mlis_tpu_torch
        # every module of the package, those of later slices too (__main__
        # would run the CLI)
        names = [m.name for m in pkgutil.walk_packages(mlis_tpu_torch.__path__, "mlis_tpu_torch.")
                 if m.name != "mlis_tpu_torch.__main__"]
        for name in names:
            importlib.import_module(name)
        assert {"mlis_tpu_torch.opt.pose_graph", "mlis_tpu_torch.eval.report",
                "mlis_tpu_torch.cli", "mlis_tpu_torch.ops.geometry",
                "mlis_tpu_torch.models.convert", "mlis_tpu_torch.models.yolo",
                "mlis_tpu_torch.parallel.mesh", "mlis_tpu_torch.parallel.distributed_knn",
                "mlis_tpu_torch.parallel.sharded_gate", "mlis_tpu_torch.parallel.scaling",
                "mlis_tpu_torch.utils.flops", "mlis_tpu_torch.train.trainer",
                "mlis_tpu_torch.train.vpr_finetune_demo", "mlis_tpu_torch.train.optim",
                "mlis_tpu_torch.train.matcher_trainer", "mlis_tpu_torch.train.driver",
                "mlis_tpu_torch.train.pretrain_matcher", "mlis_tpu_torch.train.loftr_trainer",
                "mlis_tpu_torch.train.pretrain_loftr", "mlis_tpu_torch.train.superpoint_trainer",
                "mlis_tpu_torch.train.pretrain_superpoint",
                "mlis_tpu_torch.train.pretrain_vpr", "mlis_tpu_torch.runtime.native",
                "mlis_tpu_torch.core.lz4f", "mlis_tpu_torch.core.bag",
                "mlis_tpu_torch.core.calibration", "mlis_tpu_torch.config",
                "mlis_tpu_torch.utils.profiling", "mlis_tpu_torch.utils.roofline",
                "mlis_tpu_torch.viz.figures", "mlis_tpu_torch.viz.paper_figures",
                "mlis_tpu_torch.viz.live"} <= set(names), names
        import contextlib, io, os, tempfile
        from mlis_tpu_torch.core.bag import BagWriter, encode_imu, extract_imu
        with tempfile.TemporaryDirectory() as tmp:
            bag = os.path.join(tmp, "imu.bag")
            w = BagWriter(bag)
            for i in range(8):
                w.write("/vectornav/imu", "sensor_msgs/Imu", 1.0 + i,
                        encode_imu(1.0 + i, [i, 0, 9.8], [0, 0, i]))
            w.close(compression="lz4")
            t, a, g = extract_imu(bag)
            assert np.array_equal(t, 1.0 + np.arange(8)) and np.array_equal(a[:, 0], np.arange(8))
        from mlis_tpu_torch import cli
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["layout", "--list"]) == 0
        assert buf.getvalue().split() == ["gating_monitor", "lego_loam", "orb_slam3"]
        assert all(getattr(mlis_tpu_torch, n) is not None for n in mlis_tpu_torch._LAZY)
        from mlis_tpu_torch.ops.pairwise import candidate_counts, candidate_counts_host
        from mlis_tpu_torch.gating.place_recognition import _build_vpr, process_image_sequence
        rng = np.random.default_rng(0)
        pos = rng.normal(size=(700, 3)) * 3
        fl = rng.integers(1, 4, 700)
        assert candidate_counts(pos, fl, device="cpu") == candidate_counts_host(pos, fl)
        import torch
        from mlis_tpu_torch.models.vit import ViT, ViTConfig
        toks = ViT(ViTConfig.tiny_test(dtype=torch.float32))(torch.rand(1, 98, 98, 3))
        assert toks["patches"].shape == (1, 49, 64)
        from mlis_tpu_torch.eval.quality import make_quality_scene_v2
        scene = make_quality_scene_v2(n_floors=2, n_places=2, hw=(64, 96), device="cpu")
        assert scene.images.shape == (8, 64, 96) and len(scene.gt_pairs) == 4
        small = dict(vit_cfg=ViTConfig.tiny_test(), input_size=(56, 56), num_clusters=4)
        spr, matches = process_image_sequence(scene.images, scene.timestamps, scene.floors,
                                              vpr_method="anyloc", device="cpu", **small)
        salad = _build_vpr("salad", device="cpu", cluster_dim=8, token_dim=16, **small)
        assert salad.encode_batch(scene.images[:2]).shape == (2, 48)
        from mlis_tpu_torch.train.pretrain_vpr import load_encoder
        for arch in ("salad", "anyloc"):
            assert load_encoder(arch=arch, device="cpu")(scene.images[:2]).shape[0] == 2
        from mlis_tpu_torch.eval.quality import build_verifier
        from mlis_tpu_torch.models.loftr import LoFTR, LoFTRConfig
        import mlis_tpu_torch.models.orb
        for fam in ("orb", "loftr", "superglue"):
            v, w = build_verifier(fam, 64, (64, 96), device="cpu")
            assert w in ("orb_weight_free", "loftr_homog_v3.npz", "superglue_homog.npz"), w
        r = build_verifier("orb", 64, (64, 96), device="cpu")[0].verify(
            scene.images[0], scene.images[4], scene.K)
        assert r.num_confident_matches == -1
        dm = LoFTR(LoFTRConfig.tiny_test(), device="cpu").match_batch(
            torch.rand(2, 66, 96, 1), torch.rand(2, 66, 96, 1))
        assert dm.kpts0.shape == (2, 64, 2)
        import mlis_tpu_torch.core.trajectory, mlis_tpu_torch.core.dataset
        import mlis_tpu_torch.eval.association, mlis_tpu_torch.ops.filters
        import mlis_tpu_torch.gating.lidar_floor_tracker, mlis_tpu_torch.gating.fusion
        import mlis_tpu_torch.gating.pipeline, mlis_tpu_torch.gating.gate
        from mlis_tpu_torch.gating.floor_detector import IMUFloorDetector
        from mlis_tpu_torch.gating.integration import SemanticIntegration, run_comparison
        from mlis_tpu_torch.gating.streaming import StreamingGate
        traj, imu = mlis_tpu_torch.gating.pipeline.make_demo_data()
        det = IMUFloorDetector(device="cpu")
        assert len(det.detect_elevator_events(*imu[:, :4].T)) == 2
        assert set(det.assign_floor_labels(traj[:, 0])) == {0, 4, 5}
        sg = StreamingGate(capacity=32, top_k=2, device="cpu")
        out = sg.add_keyframes(rng.normal(size=(16, 8)).astype(np.float32),
                               np.arange(16) * 20.0, np.ones(16))
        assert out.match_ids.shape == (16, 2) and sg.stats["keyframes"] == 16
        from mlis_tpu_torch.opt.demo import run_pgo_demo
        pgo = run_pgo_demo(laps=2, num_iters=2, cg_iters=8, device="cpu")
        assert pgo["gate_correct"] and np.isfinite(pgo["gnc_ate_rmse"])
        official = LoFTR(LoFTRConfig.official_tiny(match_threshold=0.0), device="cpu")
        assert official.match_batch(torch.rand(2, 64, 64, 1), torch.rand(2, 64, 64, 1)).valid.any()
        from mlis_tpu_torch.models.yolo import DynamicObjectFilter, YOLOConfig, YOLODetector
        filt = DynamicObjectFilter(YOLODetector(YOLOConfig.tiny_test(), input_size=(64, 96),
                                                device="cpu"))
        assert filt.filter_batch(scene.images[:2, :, :, None].repeat(3, -1))[1].shape == (2, 64, 96)
        from mlis_tpu_torch.train.trainer import GeMEncoder, VPRTrainer
        from mlis_tpu_torch.train.vpr_finetune_demo import make_aliasing_images
        imgs, ids, _ = make_aliasing_images(n_places=2, n_views=2, hw=(32, 48), device="cpu")
        enc = GeMEncoder(ViT(ViTConfig.tiny_test(dtype=torch.float32, patch_size=8),
                             use_kernel=False))
        trainer = VPRTrainer(enc, device="cpu")  # a one-rank gloo group
        assert all(np.isfinite(trainer.train_batch(imgs, ids)) for _ in range(2))
        from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig
        from mlis_tpu_torch.models.superpoint import SuperPointConfig
        from mlis_tpu_torch.train.matcher_trainer import MatcherTrainer, draw_textures
        lg = LightGlue(SuperPointConfig.tiny_test(max_keypoints=32), MatcherConfig.tiny_test(),
                       device="cpu").init_random_(0)
        tex = draw_textures(2, 64, 96, torch.Generator().manual_seed(1), "cpu").numpy()
        loss, n_gt = MatcherTrainer(lg, (64, 96), seed=0).train_batch(tex)
        assert np.isfinite(loss) and n_gt >= 0
        assert not any(m in ("jax", "optax", "orbax", "mlis_tpu")
                       or m.startswith(("jax.", "optax.", "orbax.", "mlis_tpu."))
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
