"""Command-line interface of the port: ``python -m mlis_tpu_torch <cmd>``.

Counterpart of ``mlis_tpu/cli.py`` for three subcommands, with the JAX
package's arguments and defaults plus ``--device``:

  gate       per-algorithm semantic gating analysis and the comparison of
             ``SemanticEvaluator`` (JSON + markdown)
  evaluate   full trajectory evaluation against the LeGO-LOAM pseudo-GT
  pgo        the pose-graph demo: gate -> ContextualPriorFactor factors ->
             Gauss-Newton on the device -> ATE (gated, ungated, odometry
             only, Switchable Constraints, GNC, PCM); prints one JSON object

The other subcommands of the JAX package are not ported yet (ROADMAP
Queue 1 item 10); ``--figures`` and ``--figure`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from mlis_tpu_torch.core.dataset import REFERENCE_TRAJECTORY_ROOT
from mlis_tpu_torch.gating.integration import FIGURES_NOT_PORTED, INTEGRATIONS


def _cmd_gate(args) -> int:
    from mlis_tpu_torch.eval.semantic_eval import SemanticEvaluator

    if args.figures:
        raise NotImplementedError(FIGURES_NOT_PORTED)
    algos = args.algorithms or list(INTEGRATIONS)
    for algo in algos:
        integ = INTEGRATIONS[algo](args.trajectory_root, args.output, device=args.device)
        report = integ.run_full_analysis(
            distance_threshold=args.distance_threshold,
            min_time_gap=args.min_time_gap,
        )
        print(report)
    ev = SemanticEvaluator(results_dir=args.output)
    ev.evaluate_all(algos)
    ev.to_json(str(Path(args.output) / "semantic_gating_metrics.json"))
    print(ev.comparison_markdown(str(Path(args.output) / "semantic_gating_comparison.md")))
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


def _cmd_pgo(args) -> int:
    from mlis_tpu_torch.opt.demo import run_pgo_demo

    if args.figure:
        raise NotImplementedError(FIGURES_NOT_PORTED)
    out = run_pgo_demo(
        seed=args.seed,
        huber_delta=args.huber_delta,
        use_priors=not args.no_priors,
        device=args.device,
    )
    print(json.dumps(out, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mlis_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd")

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="torch device of the sweeps and solves (default cuda)")

    p = sub.add_parser("gate", help="semantic gating analysis")
    p.add_argument("--trajectory-root", default=REFERENCE_TRAJECTORY_ROOT)
    p.add_argument("--output", default="./results/semantic_gating")
    p.add_argument("--algorithms", nargs="*", default=None)
    p.add_argument("--distance-threshold", type=float, default=2.0)
    p.add_argument("--min-time-gap", type=int, default=100)
    p.add_argument("--figures", action="store_true")
    device_arg(p)

    p = sub.add_parser("evaluate", help="trajectory evaluation")
    p.add_argument("--trajectory-root", default=REFERENCE_TRAJECTORY_ROOT)
    p.add_argument("--output", default="./results/metrics")
    p.add_argument("--proper-se3", action="store_true",
                   help="use true SE(3) instead of the reference's legacy scale-applying alignment")
    p.add_argument("--fast", action="store_true", help="skip RPE/segment diagnostics")

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
    p.add_argument("--figure", help="write a 3D GT-vs-variants comparison PNG (not ported)")
    device_arg(p)

    args = parser.parse_args(argv)
    if args.cmd == "gate":
        return _cmd_gate(args)
    if args.cmd == "evaluate":
        return _cmd_evaluate(args)
    if args.cmd == "pgo":
        return _cmd_pgo(args)
    parser.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
