"""SuperPoint pretraining driver: synthetic corners and homography
descriptors (``train/superpoint_trainer.py``).

Counterpart of ``mlis_tpu/train/pretrain_superpoint.py``, with its
arguments and defaults plus ``--device`` (default cuda). It makes the
trained front end that ``pretrain_matcher --sp-init <npz>`` freezes.
Draws come from ``torch.Generator``s seeded by ``--seed``.

Run: python -m mlis_tpu_torch.train.pretrain_superpoint --steps 4000
     python -m mlis_tpu_torch.train.pretrain_superpoint --tiny --device cpu --out /tmp/sp.npz
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=360)
    ap.add_argument("--kpts", type=int, default=512)
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--desc-weight", type=float, default=1.0)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="checkpoints/superpoint_synth.npz")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.tiny:
        args.height, args.width, args.kpts = 64, 96, 64

    from mlis_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
    from mlis_tpu_torch.train.optim import ClippedAdam, warmup_cosine_decay_schedule
    from mlis_tpu_torch.train.superpoint_trainer import SuperPointTrainer

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    log_path = out.with_name(out.stem + "_log.json")

    cfg = (SuperPointConfig.tiny_test(max_keypoints=args.kpts) if args.tiny
           else SuperPointConfig(max_keypoints=args.kpts))
    sp = SuperPoint(cfg, device=args.device).init_random_(args.seed)
    warmup = min(args.warmup, max(args.steps // 4, 1))
    schedule = warmup_cosine_decay_schedule(0.0, args.peak_lr, warmup, args.steps, end_value=1e-6)
    trainer = SuperPointTrainer(sp, (args.height, args.width), desc_weight=args.desc_weight,
                                seed=args.seed,
                                optimizer=ClippedAdam(sp.net.parameters(), schedule))

    history = {"loss": [], "eval": []}
    m0 = trainer.corner_metrics()
    print(f"step 0: {m0}", flush=True)
    history["eval"].append((0, m0))
    best = m0["corner_recall"]
    saved = False

    done = 0
    t0 = time.time()
    next_eval = args.eval_every
    while done < args.steps:
        n = min(args.chunk, args.steps - done)
        tr = trainer.train_chunk(n, batch_size=args.batch)
        done += n
        history["loss"].append((done, *(float(v) for v in tr.mean(axis=0))))
        rate = done / (time.time() - t0)
        print(f"step {done}/{args.steps}: loss={tr[-1][0]:.4f} "
              f"(det {tr[-1][1]:.4f} desc {tr[-1][2]:.4f}) {rate:.2f} steps/s", flush=True)
        if done >= next_eval or done >= args.steps:
            next_eval += args.eval_every
            m = trainer.corner_metrics()
            m["repeatability"] = trainer.repeatability()
            history["eval"].append((done, m))
            print(f"  eval@{done}: {m}", flush=True)
            if m["corner_recall"] > best or not saved:
                best = max(best, m["corner_recall"])
                trainer.save_checkpoint(str(out))
                saved = True
                print(f"  saved (corner_recall {best:.4f})", flush=True)
        log_path.write_text(json.dumps(history))

    history["best_corner_recall"] = best
    history["wall_s"] = time.time() - t0
    log_path.write_text(json.dumps(history))
    print(f"done: best corner recall {best:.4f} in {history['wall_s']:.0f}s", flush=True)
    return history


if __name__ == "__main__":
    main()
