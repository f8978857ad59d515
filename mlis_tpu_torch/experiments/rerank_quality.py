"""CricaVPR patch-correlation rerank on the parallax-trained tiny encoder
(counterpart of ``experiments/rerank_quality.py``): retrieval recall /
aliased rate and end-decision F1 on the v2 GT scene, rerank off vs on,
across seeds.

Writes results/torch/rerank_scoreboard.json:

    python -m mlis_tpu_torch.experiments.rerank_quality --seeds 0,1,2,3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from mlis_tpu_torch.eval.quality import (
    make_quality_scene_v2,
    retrieval_metrics,
    run_gate_quality_rerank,
)
from mlis_tpu_torch.train.pretrain_vpr import load_crica_tiny_vpr
from mlis_tpu_torch.weights import default_parallax_matcher_checkpoint


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--top-k", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.30)
    ap.add_argument("--out", default="results/torch/rerank_scoreboard.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    seeds = [int(s) for s in args.seeds.split(",")]
    lg_weights = default_parallax_matcher_checkpoint()
    crica = load_crica_tiny_vpr(device=dev)
    assert crica is not None, "vpr_tiny_v2.npz missing"

    per_seed = []
    for seed in seeds:
        t0 = time.time()
        sc = make_quality_scene_v2(seed=seed, device=dev)
        row = {"seed": seed}
        for on in (False, True):
            m = retrieval_metrics(sc, crica, top_k=args.top_k, threshold=args.threshold,
                                  rerank=on, device=dev)
            e = run_gate_quality_rerank(
                sc, rerank=on, crica=crica, top_k=args.top_k,
                similarity_threshold=args.threshold,
                weights_path=lg_weights, device=dev,
            )
            tag = "on" if on else "off"
            row[f"rr_{tag}"] = round(m["retrieval_recall"], 3)
            row[f"aliased_{tag}"] = round(m["aliased_rate"], 3)
            row[f"f1_{tag}"] = round(e["f1"], 3)
            row[f"precision_{tag}"] = round(e["precision"], 3)
            row[f"recall_{tag}"] = round(e["recall"], 3)
        per_seed.append(row)
        print(
            f"[rerank] seed {seed}: rr {row['rr_off']}->{row['rr_on']} "
            f"f1 {row['f1_off']}->{row['f1_on']} "
            f"({time.time() - t0:.1f}s)",
            file=sys.stderr, flush=True,
        )

    out = {
        "backbone": "vpr_tiny_v2 (parallax-trained, held-out recall 0.64)",
        "matcher": lg_weights,
        "top_k": args.top_k,
        "threshold": args.threshold,
        "seeds": seeds,
        "per_seed": per_seed,
    }
    for k in ("rr_off", "rr_on", "f1_off", "f1_on", "aliased_off", "aliased_on"):
        out[f"{k}_mean"] = round(float(np.mean([r[k] for r in per_seed])), 3)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "per_seed"}, indent=1))
    return out


if __name__ == "__main__":
    main()
