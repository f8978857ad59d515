"""Decision-quality A/B for keypoint pruning at the fullres protocol
(counterpart of ``experiments/fullres_pruning_quality.py``): 540x720,
2048 keypoints detected, the top 512 or 1024 by score matched.

    python -m mlis_tpu_torch.experiments.fullres_pruning_quality [seeds...]

Prints one JSON line per (seed, match_top_k).
"""

from __future__ import annotations

import argparse
import json
import time

from mlis_tpu_torch.eval.quality import make_quality_scene, run_gate_quality

HW = (540, 720)
DETECT = 2048


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = args.seeds or [0, 1, 2]
    for seed in seeds:
        scene = make_quality_scene(n_places=8, hw=HW, seed=seed, device=args.device)
        # the established fullres protocol is 2048 -> 1024; the question is
        # whether 512 (the matcher's training budget) is decision-neutral
        for mtk in (512, 1024):
            t0 = time.time()
            r = run_gate_quality(
                "trained", scene=scene, hw=HW, max_keypoints=DETECT,
                match_top_k=mtk, seed=seed, device=args.device,
            )
            out = {
                "seed": seed,
                "match_top_k": mtk or DETECT,
                "f1": round(r["f1"], 4),
                "precision": round(r["precision"], 4),
                "recall": round(r["recall"], 4),
                "retrieval_recall": round(r.get("retrieval_recall", -1), 4),
                "wall_s": round(time.time() - t0, 1),
            }
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
