"""Lite LoFTR pretraining driver on synthetic pairs.

Counterpart of ``mlis_tpu/train/pretrain_loftr.py``, with its arguments and
defaults plus ``--device`` (default cuda): procedural-texture homographies
(or ``--parallax`` layered SE(3) pairs) drawn on the device, LoFTR's
coarse dual-softmax and fine spatial-expectation losses
(``train/loftr_trainer.py``), a linear warm-up and cosine decay, global-
norm clipping at 1 and Adam, then ``train/driver.run_chunked_training``.
Draws come from ``torch.Generator``s seeded by ``--seed``.

Run: python -m mlis_tpu_torch.train.pretrain_loftr --steps 4000
     python -m mlis_tpu_torch.train.pretrain_loftr --tiny --device cpu --out /tmp/lf.npz
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--peak-lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--eval-every", type=int, default=200)
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--eval-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--init-from", help="warm-start from a save_weights npz")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model and small images (a CPU rehearsal of the driver)")
    ap.add_argument("--parallax", action="store_true",
                    help="train on layered-scene SE(3) pairs with occlusion-aware dense GT "
                    "instead of single homographies")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = ("checkpoints/loftr_parallax.npz" if args.parallax
                    else "checkpoints/loftr_homog.npz")
    if args.tiny:
        args.height, args.width = 64, 96
        args.eval_batch = 4

    from mlis_tpu_torch.models.loftr import LoFTR, LoFTRConfig
    from mlis_tpu_torch.train.driver import run_chunked_training
    from mlis_tpu_torch.train.loftr_trainer import LoFTRTrainer
    from mlis_tpu_torch.train.matcher_trainer import draw_textures
    from mlis_tpu_torch.train.optim import ClippedAdam, warmup_cosine_decay_schedule

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    log_path = out.with_name(out.stem + "_log.json")
    dev = torch.device(args.device)

    lf = LoFTR(LoFTRConfig.tiny_test() if args.tiny else LoFTRConfig(),
               device=dev).init_random_(args.seed)
    if args.init_from:
        lf.load_weights(args.init_from, image_hw=(args.height, args.width))
        print(f"warm-started from {args.init_from}", flush=True)
    warmup = min(args.warmup, max(args.steps // 4, 1))
    schedule = warmup_cosine_decay_schedule(0.0, args.peak_lr, warmup, args.steps,
                                            end_value=1e-6)
    trainer = LoFTRTrainer(lf, (args.height, args.width),
                           optimizer=ClippedAdam(lf.net.parameters(), schedule), seed=args.seed,
                           pair_mode="parallax" if args.parallax else "homography")
    eval_imgs = draw_textures(args.eval_batch, args.height, args.width,
                              torch.Generator(dev).manual_seed(10_000 + args.seed), dev)
    history = {"config": {k: getattr(args, k) for k in (
        "steps", "chunk", "batch", "height", "width", "peak_lr", "warmup", "seed", "parallax")}}
    return run_chunked_training(trainer, eval_imgs.cpu().numpy(), out, log_path, history,
                                steps=args.steps, chunk=args.chunk, batch=args.batch,
                                eval_every=args.eval_every, save_every=args.save_every)


if __name__ == "__main__":
    main()
