"""Targeted intervention on the v2 scoreboard's binding stage (counterpart
of ``experiments/encoder_intervention.py``): the same gate, matcher and
protocol with the encoder swapped from the tiny parallax-trained encoder
to the trained MixVPR, so that the before/after isolates the retrieval
stage's contribution to end F1.

Writes results/torch/encoder_intervention.json:

    python -m mlis_tpu_torch.experiments.encoder_intervention --seeds 0,1,2,3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from mlis_tpu_torch.eval.quality import make_quality_scene_v2, run_gate_quality
from mlis_tpu_torch.weights import default_parallax_matcher_checkpoint


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--top-k", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.30)
    ap.add_argument("--out", default="results/torch/encoder_intervention.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    seeds = [int(s) for s in args.seeds.split(",")]
    lg = default_parallax_matcher_checkpoint()
    encoders = ("trained_vpr_v2", "mixvpr_trained")
    rows = {e: [] for e in encoders}
    for seed in seeds:
        sc = make_quality_scene_v2(seed=seed, device=args.device)
        for enc in encoders:
            t0 = time.time()
            out = run_gate_quality(
                "trained", scene=sc, encoder=enc, top_k=args.top_k,
                similarity_threshold=args.threshold, verify_batch=256,
                weights_path=lg, device=args.device,
            )
            rows[enc].append({
                "seed": seed,
                "f1": round(out["f1"], 3),
                "precision": round(out["precision"], 3),
                "recall": round(out["recall"], 3),
                "retrieval_recall": round(out["retrieval_recall"], 3),
            })
            print(
                f"[intervention] {enc} seed {seed}: f1={out['f1']:.3f} "
                f"rr={out['retrieval_recall']:.3f} "
                f"({time.time() - t0:.1f}s)",
                file=sys.stderr, flush=True,
            )

    res = {
        "matcher": lg, "top_k": args.top_k, "threshold": args.threshold,
        "seeds": seeds, "per_encoder": rows,
    }
    for enc in encoders:
        res[f"f1_mean_{enc}"] = round(float(np.mean([r["f1"] for r in rows[enc]])), 3)
        res[f"rr_mean_{enc}"] = round(
            float(np.mean([r["retrieval_recall"] for r in rows[enc]])), 3)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "per_encoder"}, indent=1))
    return res


if __name__ == "__main__":
    main()
