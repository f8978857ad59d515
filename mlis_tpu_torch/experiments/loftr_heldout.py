"""The calibrated LoFTR coarse threshold on held-out seeds of the v1 GT
scene (counterpart of ``experiments/loftr_heldout.py``): the 0.05 threshold
was chosen on seeds 0-3, so seeds 4-7 give the published number a
selection / validation split.

Writes results/torch/loftr_heldout.json:

    python -m mlis_tpu_torch.experiments.loftr_heldout --seeds 4,5,6,7
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from mlis_tpu_torch.eval.quality import run_gate_quality


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="4,5,6,7")
    ap.add_argument(
        "--threshold", type=float, default=None,
        help="coarse threshold; default = build_verifier's in-env "
        "calibration (0.05, selected on seeds 0-3)",
    )
    ap.add_argument("--out", default="results/torch/loftr_heldout.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    seeds = [int(s) for s in args.seeds.split(",")]
    per_seed = []
    for seed in seeds:
        t0 = time.time()
        out = run_gate_quality("loftr", seed=seed, verify_batch=32,
                               loftr_match_threshold=args.threshold, device=args.device)
        per_seed.append({
            "seed": seed,
            "f1": round(out["f1"], 3),
            "precision": round(out["precision"], 3),
            "recall": round(out["recall"], 3),
        })
        print(
            f"[loftr-heldout] seed {seed}: f1={out['f1']:.3f} "
            f"p={out['precision']:.3f} r={out['recall']:.3f} "
            f"({time.time() - t0:.1f}s, {out['weights']})",
            file=sys.stderr, flush=True,
        )

    res = {
        "scene": "v1 GT scene (selection seeds were 0-3)",
        "threshold": args.threshold if args.threshold is not None
        else "in-env default (0.05, selected on seeds 0-3)",
        "seeds": seeds,
        "per_seed": per_seed,
        "f1_mean": round(float(np.mean([r["f1"] for r in per_seed])), 3),
        "f1_min": round(float(np.min([r["f1"] for r in per_seed])), 3),
        "precision_mean": round(float(np.mean([r["precision"] for r in per_seed])), 3),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
