"""Encoder retrieval rows + the no-floor-gate ablation on the v2 scene
(counterpart of ``experiments/encoder_rows.py``): retrieval recall /
aliased rate per VPR encoder, the CricaVPR-on-tiny rerank A/B and the
floor-gate-off end-decision row.

Writes results/torch/vpr_encoder_rows.json:

    python -m mlis_tpu_torch.experiments.encoder_rows --seeds 0,1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from mlis_tpu_torch.eval.quality import (
    _pixel_encoder,
    make_quality_scene_v2,
    retrieval_metrics,
    run_gate_quality,
)
from mlis_tpu_torch.train.pretrain_vpr import load_crica_tiny_vpr, load_encoder, load_mixvpr_vpr
from mlis_tpu_torch.weights import default_parallax_matcher_checkpoint


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--top-k", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.30)
    ap.add_argument("--out", default="results/torch/vpr_encoder_rows.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    seeds = [int(s) for s in args.seeds.split(",")]
    scenes = {s: make_quality_scene_v2(seed=s, device=dev) for s in seeds}
    print(f"[rows] scenes rendered: {seeds}", file=sys.stderr, flush=True)

    encs = {"pixel": _pixel_encoder}
    e_v2 = load_encoder("checkpoints/vpr_tiny_v2.npz", device=dev)
    if e_v2 is not None:
        encs["trained_vpr_v2"] = e_v2
    mv = load_mixvpr_vpr(device=dev)
    if mv is not None:
        encs["mixvpr_trained"] = mv.encode_batch_device
    for arch in ("salad", "anyloc"):
        e = load_encoder(arch=arch, device=dev)
        if e is not None:
            encs[arch] = e

    rows: dict = {"seeds": seeds, "top_k": args.top_k,
                  "threshold": args.threshold, "encoders": {}}
    for name, e in encs.items():
        rr, al = [], []
        t0 = time.time()
        for s in seeds:
            m = retrieval_metrics(scenes[s], e, top_k=args.top_k, threshold=args.threshold,
                                  device=dev)
            rr.append(m["retrieval_recall"])
            al.append(m["aliased_rate"])
        rows["encoders"][name] = {
            "retrieval_recall_mean": round(float(np.mean(rr)), 3),
            "aliased_rate_mean": round(float(np.mean(al)), 3),
            "per_seed_rr": [round(float(v), 3) for v in rr],
        }
        print(f"[rows] {name}: rr={rows['encoders'][name]} "
              f"({time.time() - t0:.1f}s)", file=sys.stderr, flush=True)

    # CricaVPR-on-tiny rerank retrieval A/B (mechanism row)
    ct = load_crica_tiny_vpr(device=dev)
    if ct is not None:
        s0 = scenes[seeds[0]]
        m_off = retrieval_metrics(s0, ct, top_k=args.top_k, threshold=args.threshold,
                                  rerank=False, device=dev)
        m_on = retrieval_metrics(s0, ct, top_k=args.top_k, threshold=args.threshold,
                                 rerank=True, device=dev)
        rows["rr_crica_tiny"] = round(m_off["retrieval_recall"], 3)
        rows["rr_crica_tiny_rerank"] = round(m_on["retrieval_recall"], 3)
        print(f"[rows] crica_tiny rerank rr {rows['rr_crica_tiny']} -> "
              f"{rows['rr_crica_tiny_rerank']}", file=sys.stderr, flush=True)

    # floor-gate-off ablation (end decisions, seed 0)
    t0 = time.time()
    ng = run_gate_quality(
        "trained", scene=scenes[seeds[0]], encoder="trained_vpr_v2",
        top_k=args.top_k, similarity_threshold=args.threshold,
        verify_batch=256, floor_gate=False,
        weights_path=default_parallax_matcher_checkpoint(), device=dev,
    )
    rows["f1_no_floor_gate"] = round(ng["f1"], 3)
    rows["precision_no_floor_gate"] = round(ng["precision"], 3)
    print(f"[rows] no-floor-gate: f1={ng['f1']:.3f} p={ng['precision']:.3f} "
          f"({time.time() - t0:.1f}s)", file=sys.stderr, flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
