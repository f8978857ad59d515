"""Command-line interface of the port: ``python -m mlis_tpu_torch <cmd>``.

Counterpart of ``mlis_tpu/cli.py`` with the JAX package's subcommands,
arguments and defaults, plus ``--device`` (default ``cuda``) where a
subcommand runs tensors:

  gate       per-algorithm semantic gating analysis and the comparison of
             ``SemanticEvaluator`` (JSON + markdown); ``--figures`` adds
             the per-algorithm figures and the rejection-rate bars
  evaluate   full trajectory evaluation against the LeGO-LOAM pseudo-GT
  pipeline   trajectory + IMU semantic gating pipeline (incl. ``--demo``;
             arguments pass through to ``gating/pipeline.py``)
  calib      Kalibr -> ORB-SLAM3 / VINS-Fusion / Basalt / LeGO-LOAM configs,
             plus ``info`` (cameras + baselines), ``sample`` and ``generate``
  bag        bag info / IMU CSV / odometry TUM / IMU elevator figure
  fullgate   VPR -> gate -> verify on a keyframe directory or the
             synthetic scene
  pgo        the pose-graph demo: gate -> ContextualPriorFactor factors ->
             Gauss-Newton on the device -> ATE; ``--figure`` draws it
  stream     the StreamingGate demo on a synthetic keyframe stream
  check-data dataset presence + bag readability validation
  layout     Foxglove Studio layouts for watching a run live
  all        gate + evaluate + figures in one run

The JAX package's ``bench`` (its one-line JSON benchmark) has no
counterpart here yet.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from mlis_tpu_torch.core.dataset import REFERENCE_TRAJECTORY_ROOT


def _cmd_gate(args) -> int:
    from mlis_tpu_torch.eval.semantic_eval import SemanticEvaluator
    from mlis_tpu_torch.gating.integration import INTEGRATIONS

    algos = args.algorithms or list(INTEGRATIONS)
    for algo in algos:
        integ = INTEGRATIONS[algo](args.trajectory_root, args.output, device=args.device)
        report = integ.run_full_analysis(
            distance_threshold=args.distance_threshold,
            min_time_gap=args.min_time_gap,
            make_figures=args.figures,
        )
        print(report)
    ev = SemanticEvaluator(results_dir=args.output)
    ev.evaluate_all(algos)
    ev.to_json(str(Path(args.output) / "semantic_gating_metrics.json"))
    print(ev.comparison_markdown(str(Path(args.output) / "semantic_gating_comparison.md")))
    if args.figures:
        from mlis_tpu_torch.viz.figures import plot_rejection_rates

        plot_rejection_rates(
            {a: ev.results[a].loop_closure.cross_floor_rate for a in algos},
            Path(args.output) / "rejection_rates.png",
        )
    return 0


def _cmd_evaluate(args) -> int:
    from mlis_tpu_torch.eval.comprehensive import run_full_evaluation

    run_full_evaluation(
        args.trajectory_root,
        output_path=str(Path(args.output) / "final_evaluation.json"),
        legacy_alignment=not args.proper_se3,
        full_diagnostics=not args.fast,
    )
    return 0


def _cmd_pipeline(args, extra) -> int:
    from mlis_tpu_torch.gating.pipeline import main as pipeline_main

    return pipeline_main(extra)


def _cmd_calib(args) -> int:
    from mlis_tpu_torch.core import calibration as cal

    if args.format == "sample":
        out = cal.sample_kalibr_yaml(output_path=args.output)
        if not args.output:
            print(out)
        return 0
    if not args.cameras:
        print("--cameras is required", file=sys.stderr)
        return 2
    cams = cal.load_kalibr_cameras(args.cameras)
    if args.format == "info":
        print(f"Calibration file: {args.cameras}")
        print(cal.calibration_info(cams))
        return 0
    if args.format == "generate":
        # one-shot config generation for every algorithm
        if not (args.cam_imu and args.imu):
            print("--cam-imu and --imu are required for generate", file=sys.stderr)
            return 2
        outdir = Path(args.output or "./configs")
        outdir.mkdir(parents=True, exist_ok=True)
        T = cal.load_camera_imu_calib(args.cam_imu)
        imu = cal.load_imu_params(args.imu)
        cal.convert_to_orbslam3(cams, args.left, args.right, output_path=outdir / "orbslam3.yaml")
        cal.convert_to_vins_fusion(cams, T, imu, args.left, args.right,
                                   output_path=outdir / "vins_fusion.yaml")
        cal.convert_to_basalt(cams, T, imu, args.left, args.right,
                              output_path=outdir / "basalt.json")
        cal.convert_to_lego_loam(output_path=outdir / "lego_loam.yaml")
        print(f"4 configs -> {outdir}")
        return 0
    if args.format == "orbslam3":
        out = cal.convert_to_orbslam3(cams, args.left, args.right, output_path=args.output)
    elif args.format in ("vins", "basalt"):
        if not (args.cam_imu and args.imu):
            print("--cam-imu and --imu are required for vins/basalt", file=sys.stderr)
            return 2
        T = cal.load_camera_imu_calib(args.cam_imu)
        imu = cal.load_imu_params(args.imu)
        fn = cal.convert_to_vins_fusion if args.format == "vins" else cal.convert_to_basalt
        out = fn(cams, T, imu, args.left, args.right, output_path=args.output)
    else:  # lego-loam (argparse admits no other format)
        out = cal.convert_to_lego_loam(output_path=args.output)
    if not args.output:
        print(out)
    return 0


def _cmd_bag(args) -> int:
    import numpy as np

    from mlis_tpu_torch.core.bag import BagReader, extract_imu, extract_odometry_tum

    if args.action == "info":
        print(json.dumps(BagReader(args.bag).info(), indent=2))
    elif args.action == "imu-csv":
        t, a, g = extract_imu(args.bag, args.topic or "/vectornav/imu")
        rows = np.column_stack([t, a, g])
        out = args.output or "imu.csv"
        np.savetxt(out, rows, delimiter=",", header="t,ax,ay,az,gx,gy,gz", comments="")
        print(f"wrote {len(rows)} IMU rows to {out}")
    elif args.action == "odom-tum":
        topics = [args.topic] if args.topic else ["/aft_mapped_to_init", "/integrated_to_init",
                                                   "/odom"]
        tum = extract_odometry_tum(args.bag, topics)
        out = args.output or "trajectory.txt"
        with open(out, "w") as f:
            for r in tum:
                f.write(f"{r[0]:.6f} " + " ".join(f"{v:.9f}" for v in r[1:]) + "\n")
        print(f"wrote {len(tum)} poses to {out}")
    elif args.action == "imu-plot":
        # extract the IMU, detect elevator rides, draw the annotated figure
        from mlis_tpu_torch.gating.floor_detector import IMUFloorDetector
        from mlis_tpu_torch.viz.figures import plot_elevator_detection

        t, a, _ = extract_imu(args.bag, args.topic or "/vectornav/imu")
        det = IMUFloorDetector(device=args.device)
        events = det.detect_elevator_events(t, a[:, 0], a[:, 1], a[:, 2])
        out = args.output or "imu_elevator_detection.png"
        plot_elevator_detection(t, a[:, 2], events, out)
        print(f"{len(events)} elevator event(s); figure -> {out}")
    return 0


def fullgate_scene(n: int = 64):
    """The ``fullgate`` subcommand's synthetic scene: ``n`` keyframes at
    540x720 cycling through 8 random 8x8-block textures, 30 s apart, the
    first half on floor 5 and the second on floor 2 (the JAX package's
    numpy draws)."""
    import numpy as np

    rng = np.random.default_rng(0)
    bases = [
        np.kron(rng.integers(0, 255, (68, 90, 3), dtype=np.uint8),
                np.ones((8, 8, 1), np.uint8))[:540, :720]
        for _ in range(8)
    ]
    images = np.stack([bases[i % 8] for i in range(n)])
    timestamps = np.arange(n) * 30.0
    floors = np.asarray([5] * (n // 2) + [2] * (n // 2))
    return images, timestamps, floors


def _cmd_fullgate(args) -> int:
    """The full VPR -> gate -> verify pipeline on a keyframe directory
    (PNG/JPG images named so lexicographic order == time order) or on the
    synthetic scene."""
    import numpy as np

    from mlis_tpu_torch.gating.full_gate import FullGatePipeline

    pipe = FullGatePipeline(
        vpr_method=args.vpr,
        matcher_type=args.matcher,
        similarity_threshold=args.similarity_threshold,
        detect_scale=args.detect_scale,
        device=args.device,
    )
    if args.images:
        from PIL import Image  # pillow ships with matplotlib

        files = sorted(Path(args.images).glob("*.png")) + sorted(Path(args.images).glob("*.jpg"))
        images = np.stack([np.asarray(Image.open(f))[..., :3] for f in files])
        n = len(images)
        timestamps = np.arange(n) * (1.0 / args.rate)
        floors = np.loadtxt(args.floors).astype(int) if args.floors else np.zeros(n, int)
    else:
        images, timestamps, floors = fullgate_scene()
    K = np.array([[args.fx, 0, images.shape[2] / 2], [0, args.fx, images.shape[1] / 2], [0, 0, 1]])
    res = pipe.process(images, timestamps, floors, K, survivor_budget=args.survivor_budget)
    print(json.dumps(res.summary(), indent=2))
    return 0


def _cmd_all(args) -> int:
    """Gating analysis + comparison + evaluation + figures in one run (the
    SLAM runners are upstream trajectory producers)."""
    from mlis_tpu_torch.core.dataset import NUFRM3F
    from mlis_tpu_torch.core.trajectory import combine_sequences
    from mlis_tpu_torch.eval.comprehensive import run_full_evaluation, summary_tables
    from mlis_tpu_torch.eval.report import write_benchmark_summary, write_table_iv_csv
    from mlis_tpu_torch.eval.semantic_eval import SemanticEvaluator
    from mlis_tpu_torch.gating.integration import run_comparison
    from mlis_tpu_torch.viz.figures import (
        export_interactive_3d_html,
        plot_all_floors_overview,
        plot_paper_comparison,
        plot_rpe_boxplot,
        plot_trajectory_comparison,
    )
    from mlis_tpu_torch.viz.paper_figures import generate_figure6, generate_figure7

    out = Path(args.output)
    print("[1/3] semantic gating analysis + comparison")
    results = run_comparison(
        args.trajectory_root, str(out / "semantic_gating"),
        per_algo_reports=True, make_figures=True, device=args.device,
    )
    for algo, r in results.items():
        print(
            f"  {algo}: {r.total_candidates:,} candidates, "
            f"{r.cross_floor_rate:.1%} cross-floor rejected"
        )
    print("[2/3] trajectory evaluation vs LeGO-LOAM")
    eval_results = run_full_evaluation(
        args.trajectory_root,
        output_path=str(out / "metrics" / "final_evaluation.json"),
    )
    # the published artifacts: summary markdown, Table IV CSV, summary tables
    write_table_iv_csv(eval_results, out / "metrics" / "table_iv.csv")
    (out / "metrics").mkdir(parents=True, exist_ok=True)
    (out / "metrics" / "summary_tables.txt").write_text(summary_tables(eval_results) + "\n")
    write_benchmark_summary(eval_results, results, out / "BENCHMARK_RESULTS_SUMMARY.md")

    # combined semantic comparison: gating stats + trajectory ATE
    ev = SemanticEvaluator(results_dir=str(out / "semantic_gating"))
    for algo in results:
        ev.evaluate_algorithm(algo, comprehensive_results=eval_results)
    ev.to_json(str(out / "metrics" / "semantic_evaluation.json"))
    ev.comparison_markdown(str(out / "metrics" / "semantic_evaluation.md"))

    print("[3/3] figures")
    figs = out / "figures"
    figs.mkdir(parents=True, exist_ok=True)
    generate_figure6(args.trajectory_root, figs / "figure6.png")
    generate_figure7(args.trajectory_root, figs / "figure7.png")
    plot_rpe_boxplot(eval_results, figs / "rpe_boxplot.png")
    plot_paper_comparison(eval_results, figs / "paper_comparison.png")
    # NUFRM3F.load() skips missing files, so gate the trajectory figures on
    # a manifest that is not empty
    seqs = NUFRM3F(args.trajectory_root, "lego_loam").load()
    if seqs:
        plot_all_floors_overview(
            {name: traj.as_matrix() for name, _, traj in seqs},
            figs / "all_floors_overview.png",
        )
        mat, floors = combine_sequences(seqs, {})
        export_interactive_3d_html(
            mat, floors, figs / "trajectory_3d.html",
            title="LeGO-LOAM multi-floor trajectory",
        )
    else:
        print("  (no lego_loam trajectories; overview/3D HTML skipped)")
    # per-floor multi-algorithm 2D comparisons
    by_floor: dict = {}
    for algo in results:
        for name, _, traj in NUFRM3F(args.trajectory_root, algo).load():
            by_floor.setdefault(name, {})[algo] = traj.positions[:, :2]
    for floor, trajs in by_floor.items():
        plot_trajectory_comparison(
            trajs, figs / f"trajectory_2d_{floor}.png",
            title=f"{floor.replace('_', ' ').title()} - Trajectory Comparison",
        )
    print(f"done; results under {out}")
    return 0


def _cmd_check_data(args) -> int:
    """Dataset-presence validation: per-algorithm trajectory manifests and
    optional bag topic readability."""
    from mlis_tpu_torch.core.dataset import NUFRM3F
    from mlis_tpu_torch.eval.comprehensive import ALGORITHMS

    ok = True
    for algo in ALGORITHMS:
        seqs = NUFRM3F(args.trajectory_root, algo).load()
        if not seqs:
            print(f"  [MISSING] {algo}: no trajectories under {args.trajectory_root}/{algo}")
            ok = False
            continue
        total = sum(len(t) for _, _, t in seqs)
        print(f"  [ok] {algo}: {len(seqs)} sequence(s), {total:,} poses")
    if args.bag:
        from mlis_tpu_torch.core.bag import BagReader

        try:
            info = BagReader(args.bag).info()
            print(f"  [ok] bag {args.bag}:")
            for topic, count in sorted(info["message_counts"].items()):
                print(f"        {topic}: {count:,} msgs")
        except Exception as e:  # a report line per bad bag, then FAIL
            print(f"  [BAD] bag {args.bag}: {e}")
            ok = False
    print("check-data: " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


def _cmd_layout(args) -> int:
    from mlis_tpu_torch.viz.live import LAYOUTS, save_layout

    if args.list:
        for name in sorted(LAYOUTS):
            print(name)
        return 0
    out = args.output or f"{args.name}_layout.json"
    save_layout(args.name, out, algorithm=args.algorithm)
    print(f"wrote Foxglove layout: {out}")
    return 0


def _cmd_pgo(args) -> int:
    from mlis_tpu_torch.opt.demo import run_pgo_demo

    out = run_pgo_demo(
        seed=args.seed,
        huber_delta=args.huber_delta,
        use_priors=not args.no_priors,
        return_trajectories=bool(args.figure),
        device=args.device,
    )
    if args.figure:
        from mlis_tpu_torch.viz.figures import plot_pgo_comparison

        plot_pgo_comparison(out.pop("gt_t"), out.pop("trajectories"), out.pop("floor_labels"),
                            args.figure)
        out["figure"] = args.figure
    print(json.dumps(out, indent=2))
    return 0


def stream_demo(frames: int, seed: int = 0):
    """The ``stream`` subcommand's keyframes (the JAX package's numpy
    draws): D = 128 descriptors, floors 1-5, and every 8th frame from 24 on
    revisits the frame 20 back; half of those land on another floor (the
    aliasing traps the gate must stop). Returns (desc, times, floors,
    planted same-floor revisits, planted traps)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, D = frames, 128
    desc = rng.normal(size=(n, D)).astype(np.float32)
    floors = rng.integers(1, 6, size=n).astype(np.int32)
    planted = trap = 0
    for q in range(24, n, 8):
        m = q - 20
        desc[q] = desc[m] + 0.01 * rng.normal(size=D).astype(np.float32)
        if q % 16 == 0:
            floors[q] = floors[m] % 5 + 1 if floors[m] != 5 else 2
            trap += 1
        else:
            floors[q] = floors[m]
            planted += 1
    times = np.arange(n, dtype=np.float32) * 2.0
    return desc, times, floors, planted, trap


def _cmd_stream(args) -> int:
    """Online StreamingGate demo: a synthetic keyframe stream with revisits
    and cross-floor aliasing traps through the ring-buffer serving path."""
    from mlis_tpu_torch.gating.streaming import StreamingGate

    desc, times, floors, planted, trap = stream_demo(args.frames, args.seed)
    sg = StreamingGate(capacity=args.capacity, top_k=5, similarity_threshold=0.9,
                       min_time_gap=10.0, device=args.device)
    pairs = []
    for s in range(0, len(desc), args.micro_batch):
        out = sg.add_keyframes(desc[s : s + args.micro_batch], times[s : s + args.micro_batch],
                               floors[s : s + args.micro_batch])
        pairs += out.pairs()
    print(json.dumps({
        "frames": len(desc),
        "planted_same_floor_revisits": planted,
        "planted_cross_floor_traps": trap,
        "accepted_pairs": len(pairs),
        "stats": sg.stats,
        "sample_pairs": pairs[:10],
    }, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mlis_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd")

    def device_arg(p, what="the sweeps and solves"):
        p.add_argument("--device", default="cuda", help=f"torch device of {what} (default cuda)")

    p = sub.add_parser("layout", help="generate a Foxglove Studio live-visualization layout")
    p.add_argument("name", nargs="?", default="gating_monitor")
    p.add_argument("--algorithm", default="lego_loam")
    p.add_argument("--output", "-o")
    p.add_argument("--list", action="store_true", help="list layouts")

    p = sub.add_parser("gate", help="semantic gating analysis")
    p.add_argument("--trajectory-root", default=REFERENCE_TRAJECTORY_ROOT)
    p.add_argument("--output", default="./results/semantic_gating")
    p.add_argument("--algorithms", nargs="*", default=None)
    p.add_argument("--distance-threshold", type=float, default=2.0)
    p.add_argument("--min-time-gap", type=int, default=100)
    p.add_argument("--figures", action="store_true",
                   help="also write each algorithm's three figures and the rejection-rate bars")
    device_arg(p)

    p = sub.add_parser("evaluate", help="trajectory evaluation")
    p.add_argument("--trajectory-root", default=REFERENCE_TRAJECTORY_ROOT)
    p.add_argument("--output", default="./results/metrics")
    p.add_argument("--proper-se3", action="store_true",
                   help="use true SE(3) instead of the reference's legacy scale-applying alignment")
    p.add_argument("--fast", action="store_true", help="skip RPE/segment diagnostics")

    sub.add_parser("pipeline", help="gating pipeline (args passed through; see --help)")

    p = sub.add_parser("calib", help="calibration conversion")
    p.add_argument("format", choices=["orbslam3", "vins", "basalt", "lego-loam", "info", "sample",
                                      "generate"])
    p.add_argument("--cameras", required=False)
    p.add_argument("--cam-imu")
    p.add_argument("--imu")
    p.add_argument("--left", default="cam1")
    p.add_argument("--right", default="cam3")
    p.add_argument("--output")

    p = sub.add_parser("bag", help="bag utilities")
    p.add_argument("action", choices=["info", "imu-csv", "odom-tum", "imu-plot"])
    p.add_argument("bag")
    p.add_argument("--topic")
    p.add_argument("--output")
    device_arg(p, "imu-plot's elevator detection")

    p = sub.add_parser("fullgate", help="full VPR->gate->verify pipeline")
    p.add_argument("--images", help="keyframe image directory (else synthetic)")
    p.add_argument("--floors", help="per-keyframe floor-label file")
    p.add_argument("--vpr", default="mixvpr")
    p.add_argument("--matcher", default="lightglue")
    p.add_argument("--similarity-threshold", type=float, default=0.5)
    p.add_argument("--survivor-budget", type=int, default=None,
                   help="accepted for the JAX package's callers; the port always runs the exact "
                   "two-phase path")
    p.add_argument("--detect-scale", type=float, default=1.0)
    p.add_argument("--rate", type=float, default=20.0)
    p.add_argument("--fx", type=float, default=400.0)
    device_arg(p, "the gate")

    p = sub.add_parser(
        "pgo",
        help="pose-graph optimization demo: gate -> ContextualPriorFactor factors -> "
        "Gauss-Newton on the device -> ATE (gated vs ungated vs odometry-only)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--huber-delta", type=float, default=None,
                   help="robust kernel on between-factors (default off)")
    p.add_argument("--no-priors", action="store_true",
                   help="drop the floor z-priors + elevator dz factor")
    p.add_argument("--figure", help="write a 3D GT-vs-variants comparison PNG")
    device_arg(p)

    p = sub.add_parser(
        "stream",
        help="online StreamingGate demo: ring-buffer serving path on a synthetic keyframe "
        "stream with planted revisits + aliasing traps",
    )
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--capacity", type=int, default=256)
    p.add_argument("--micro-batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    device_arg(p, "the ring buffer")

    p = sub.add_parser(
        "check-data",
        help="validate dataset presence (trajectories per algorithm, optional bag readability)",
    )
    p.add_argument("--trajectory-root", default=REFERENCE_TRAJECTORY_ROOT)
    p.add_argument("--bag", help="optionally smoke-test a bag's topics")

    p = sub.add_parser("all", help="gate + evaluate + figures in one run")
    p.add_argument("--trajectory-root", default=REFERENCE_TRAJECTORY_ROOT)
    p.add_argument("--output", default="./results")
    device_arg(p)

    args, extra = parser.parse_known_args(argv)
    if extra and args.cmd != "pipeline":
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    commands = {
        "gate": _cmd_gate, "evaluate": _cmd_evaluate, "calib": _cmd_calib, "bag": _cmd_bag,
        "fullgate": _cmd_fullgate, "all": _cmd_all, "check-data": _cmd_check_data,
        "layout": _cmd_layout, "pgo": _cmd_pgo, "stream": _cmd_stream,
    }
    if args.cmd == "pipeline":
        return _cmd_pipeline(args, extra)
    if args.cmd in commands:
        return commands[args.cmd](args)
    parser.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
