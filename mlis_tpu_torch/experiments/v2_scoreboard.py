"""Full v2-scene decision scoreboard: every matcher family x N seeds in one
process (counterpart of ``experiments/v2_scoreboard.py``).

Writes results/torch/quality_v2_scoreboard.json (+ prints a family
summary):

    python -m mlis_tpu_torch.experiments.v2_scoreboard --seeds 0,1,2,3,4,5,6,7

The superglue family runs ``build_verifier("superglue")``'s cut of 16, as
the reference does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from mlis_tpu_torch.eval.quality import make_quality_scene_v2, run_gate_quality
from mlis_tpu_torch.weights import (
    default_parallax_loftr_checkpoint,
    default_parallax_matcher_checkpoint,
    default_parallax_superglue_checkpoint,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    ap.add_argument(
        "--families", default="trained,superglue,orb,loftr",
        help="comma list; 'trained' = LightGlue (parallax ckpt)",
    )
    ap.add_argument("--top-k", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.30)
    ap.add_argument("--out", default="results/torch/quality_v2_scoreboard.json")
    ap.add_argument(
        "--resume", action="store_true",
        help="load --out if present and skip families already recorded "
        "(each family is checkpointed to --out as soon as it finishes, so "
        "a timeout mid-sweep only loses the family in flight)",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    seeds = [int(s) for s in args.seeds.split(",")]
    families = args.families.split(",")
    fam_weights = {
        "trained": default_parallax_matcher_checkpoint(),
        "superglue": default_parallax_superglue_checkpoint(),
        "loftr": default_parallax_loftr_checkpoint(),
    }

    scenes = {}
    rows: dict = {"seeds": seeds, "families": {}}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            prior = json.load(f)
        if prior.get("seeds") == seeds:
            rows["families"].update(prior.get("families", {}))
            done = [f for f in families if f in rows["families"]]
            families = [f for f in families if f not in rows["families"]]
            print(f"[resume] skipping committed families: {done}",
                  file=sys.stderr, flush=True)
    for seed in seeds:
        t0 = time.time()
        scenes[seed] = make_quality_scene_v2(seed=seed, device=args.device)
        print(f"[scene] seed {seed} rendered in {time.time() - t0:.1f}s",
              file=sys.stderr, flush=True)

    for fam in families:
        vb = 32 if fam == "loftr" else 256
        per_seed = []
        for seed in seeds:
            t0 = time.time()
            out = run_gate_quality(
                fam, scene=scenes[seed], encoder="trained_vpr_v2",
                top_k=args.top_k, similarity_threshold=args.threshold,
                verify_batch=vb, weights_path=fam_weights.get(fam), device=args.device,
            )
            per_seed.append(
                {k: out[k] for k in ("f1", "precision", "recall", "retrieval_recall")}
                | {"seed": seed, "weights": out["weights"]}
            )
            print(
                f"[scoreboard] {fam} seed {seed}: f1={out['f1']:.3f} "
                f"p={out['precision']:.3f} r={out['recall']:.3f} "
                f"({out['weights']}) {time.time() - t0:.1f}s",
                file=sys.stderr, flush=True,
            )
        f1s = [r["f1"] for r in per_seed]
        rows["families"][fam] = {
            "f1_mean": round(float(np.mean(f1s)), 3),
            "f1_min": round(float(np.min(f1s)), 3),
            "f1_max": round(float(np.max(f1s)), 3),
            "precision_mean": round(float(np.mean([r["precision"] for r in per_seed])), 3),
            "recall_mean": round(float(np.mean([r["recall"] for r in per_seed])), 3),
            "weights": per_seed[0]["weights"],
            "per_seed": per_seed,
        }
        _write(args.out, rows)

    _write(args.out, rows)
    print(json.dumps({
        f: {k: v for k, v in d.items() if k != "per_seed"}
        for f, d in rows["families"].items()
    }, indent=1))
    return rows


def _write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


if __name__ == "__main__":
    main()
