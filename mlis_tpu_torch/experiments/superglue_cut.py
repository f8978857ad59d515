"""Calibrate a confident-match cut for the SuperGlue family on the v2 scene
(counterpart of ``experiments/superglue_cut.py``).

One run per seed captures per-pair (is_valid, num_confident_matches)
through ``run_gate_quality(return_pairs=True)``; the cut is a host-side
AND, so the threshold sweep is exact. Selection on seeds 0-3, validation
on the held-out 4-7. The verifier is ``build_verifier("superglue")`` as
it stands, cut of 16 included, as in the reference: a pair that fails
that cut never reaches the sweep's lower cuts.

Writes results/torch/superglue_cut.json:

    python -m mlis_tpu_torch.experiments.superglue_cut --seeds 0,1,2,3,4,5,6,7
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from mlis_tpu_torch.eval.quality import make_quality_scene_v2, run_gate_quality
from mlis_tpu_torch.weights import default_parallax_superglue_checkpoint

CUTS = (0, 2, 4, 6, 8, 10, 12, 16, 20, 24)


def _score(pairs, gt_pairs, cut):
    accepted = {
        (min(p["q"], p["m"]), max(p["q"], p["m"]))
        for p in pairs
        if p["is_valid"]
        and (p["num_confident_matches"] < 0 or p["num_confident_matches"] >= cut)
    }
    gt = {(min(a, b), max(a, b)) for a, b in gt_pairs}
    tp = len(accepted & gt)
    fp = len(accepted - gt)
    fn = len(gt - accepted)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return {"precision": round(prec, 3), "recall": round(rec, 3), "f1": round(f1, 3)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--select-seeds", default="0,1,2,3")
    ap.add_argument("--top-k", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.30)
    ap.add_argument("--out", default="results/torch/superglue_cut.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    seeds = [int(s) for s in args.seeds.split(",")]
    select = [int(s) for s in args.select_seeds.split(",")]
    holdout = [s for s in seeds if s not in select]
    w = default_parallax_superglue_checkpoint()

    per_seed = {}
    for seed in seeds:
        t0 = time.time()
        scene = make_quality_scene_v2(seed=seed, device=args.device)
        out = run_gate_quality(
            "superglue", scene=scene, encoder="trained_vpr_v2",
            top_k=args.top_k, similarity_threshold=args.threshold,
            verify_batch=256, weights_path=w, return_pairs=True, device=args.device,
        )
        per_seed[seed] = {
            "pairs": out["pairs"],
            "gt_pairs": sorted((min(a, b), max(a, b)) for a, b in scene.gt_pairs),
            "weights": out["weights"],
            "retrieval_recall": out["retrieval_recall"],
        }
        print(
            f"[sg-cut] seed {seed}: uncut f1={out['f1']:.3f} "
            f"p={out['precision']:.3f} r={out['recall']:.3f} "
            f"({time.time() - t0:.1f}s)", file=sys.stderr, flush=True,
        )
        # the raw per-pair capture after every seed: a timeout mid-sweep
        # keeps the completed seeds (the cut sweep itself is free)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out + ".partial", "w") as f:
            json.dump({str(s): d for s, d in per_seed.items()}, f)

    sweep = {}
    for cut in CUTS:
        rows = {s: _score(d["pairs"], d["gt_pairs"], cut) for s, d in per_seed.items()}
        sweep[cut] = {
            "select_f1_mean": round(float(np.mean([rows[s]["f1"] for s in select])), 3),
            "holdout_f1_mean": round(
                float(np.mean([rows[s]["f1"] for s in holdout])), 3
            ) if holdout else None,
            "per_seed": rows,
        }
        print(f"[sg-cut] cut={cut}: select={sweep[cut]['select_f1_mean']} "
              f"holdout={sweep[cut]['holdout_f1_mean']}",
              file=sys.stderr, flush=True)

    best = max(CUTS, key=lambda c: sweep[c]["select_f1_mean"])
    res = {
        "scene": "v2 (parallax/occlusion/aliasing)",
        "weights": per_seed[seeds[0]]["weights"],
        "select_seeds": select,
        "holdout_seeds": holdout,
        "cuts": {str(c): sweep[c] for c in CUTS},
        "chosen_cut": best,
        "chosen_select_f1": sweep[best]["select_f1_mean"],
        "chosen_holdout_f1": sweep[best]["holdout_f1_mean"],
        "uncut_holdout_f1": sweep[0]["holdout_f1_mean"],
    }
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "cuts"}, indent=1))
    return res


if __name__ == "__main__":
    main()
