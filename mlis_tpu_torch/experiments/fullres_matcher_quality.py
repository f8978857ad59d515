"""Decision-quality A/B at the fullres protocol: the LightGlue trained at
270x360 (the shipped default) against the one trained at 540x720 with
1024 keypoints (counterpart of ``experiments/fullres_matcher_quality.py``).

    python -m mlis_tpu_torch.experiments.fullres_matcher_quality [seeds...]

Prints one JSON line per (seed, checkpoint).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from mlis_tpu_torch.eval.quality import make_quality_scene, run_gate_quality
from mlis_tpu_torch.weights import REPO_ROOT

HW = (540, 720)
DETECT = 2048
MATCH_TOP_K = 1024
_CKPTS = os.path.join(REPO_ROOT, "checkpoints")
FULLRES_CKPT = os.path.join(_CKPTS, "lightglue_homog_sp_fullres.npz")
# the half-res checkpoint pinned explicitly: at hw >= 540 rows the harness's
# default is the fullres checkpoint, which would be compared with itself
HALFRES_CKPT = os.path.join(_CKPTS, "lightglue_homog_sp.npz")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = args.seeds or [0, 1, 2]
    for seed in seeds:
        scene = make_quality_scene(n_places=8, hw=HW, seed=seed, device=args.device)
        for name, wp in (("halfres_trained", HALFRES_CKPT), ("fullres_trained", FULLRES_CKPT)):
            t0 = time.time()
            r = run_gate_quality(
                "trained", scene=scene, hw=HW, max_keypoints=DETECT,
                match_top_k=MATCH_TOP_K, seed=seed, weights_path=wp, device=args.device,
            )
            print(json.dumps({
                "seed": seed,
                "ckpt": name,
                "weights": r.get("weights", ""),
                "f1": round(r["f1"], 4),
                "precision": round(r["precision"], 4),
                "recall": round(r["recall"], 4),
                "wall_s": round(time.time() - t0, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
