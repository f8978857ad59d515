"""Readings that the limits of ``correct`` are set from, on the card.

``python3 -m gatebench.calibrate --workload <cell> --seeds 12 --control 3``
drives the cell's gate once over a pool of scenes drawn from each seed
(one call a scene, at the cell's own sizes; a run's pool is the mix's
fixed set), judges the calls a run judges, and prints one JSON
line a seed with every number compared; then, on the first ``--control``
seeds, puts the reference in the program's place at float8 on the same
calls and prints its numbers. One process holds the gate and the
reference, so set-up is paid once. The benchmark's own runs never run
this; ``gatebench/tests/test_gatebench_control.py`` keeps the control at
a size a test run holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from gatebench import run as gr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    gr.use_checkout_caches()
    import torch

    from gatebench import check
    from gatebench.traffic.scene import make_pool, scene_seed

    torch.set_grad_enabled(False)
    _cell, cfg, mix = gr.cell_files(args.workload)
    dev = torch.device("cuda")
    harness = gr.Harness(cfg, dev)
    ref = gr.reference_for(cfg, dev)
    g = cfg["gate"]
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        # each seed its own scenes here, so the readings span more than a mix's set
        pool = make_pool(dict(mix, scenes_seed=seed), tuple(cfg["keyframe_hw"]), dev)
        calls, window_s, failed = harness.window(pool, seed, 1e9, max_calls=len(pool))
        t1 = time.perf_counter()
        chosen = gr.judged_calls(calls, seed)
        run = gr.Run(args.workload, cfg, mix, calls, window_s, 0.0, failed)
        numbers = gr.judge(run, pool, seed, dev, ref)
        t2 = time.perf_counter()
        line = {"seed": seed, "kind": "program", "numbers": numbers, "failed": failed,
                "walls": [round(c.wall_s, 4) for c in calls],
                "candidates": [c.total for c in calls], "verified": [len(c.rows) for c in calls],
                "accepted": [sum(r.valid for r in c.rows) for c in calls],
                "judged": [c.index for c in chosen], "window_s": t1 - t0, "judge_s": t2 - t1}
        print(json.dumps(line), flush=True)
        if i < args.control:
            per_call, structure = [], 0
            with torch.inference_mode():
                for c in chosen:
                    sc = pool[c.scene]
                    draws = check.draws_replay(scene_seed(seed, 1, c.index), int(g["verify_batch"]),
                                               int(g["num_hypotheses"]), dev)
                    out = ref.control_outputs(sc.images, sc.timestamps, sc.floors, sc.K, draws)
                    per_call.append(ref.judge(sc.images, sc.timestamps, sc.floors, sc.K, out, draws))
                    structure += check.structure_faults(out.total, out.rejected, out.rows, sc.floors)
            numbers = check.worst(per_call, structure)
            print(json.dumps({"seed": seed, "kind": "control_fp8", "numbers": numbers,
                              "control_s": time.perf_counter() - t2}), flush=True)
        del pool, calls, run
    return 0


if __name__ == "__main__":
    sys.exit(main())
