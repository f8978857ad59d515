"""LightGlue (or SuperGlue) pretraining driver on synthetic pairs.

Counterpart of ``mlis_tpu/train/pretrain_matcher.py``, with its arguments
and defaults plus ``--device`` (default cuda):

* images: procedural multi-scale block-noise textures drawn on the device
  (``synthetic_textures``), or with ``--parallax`` layered-scene SE(3)
  pairs with occlusion-aware ground truth;
* steps run in chunks of ``--chunk`` (``MatcherTrainer.train_chunk``);
* learning rate: linear warm-up and cosine decay, gradients clipped at a
  global norm of 1, Adam (optax's numerics, ``train/optim.py``);
* held-out recall and precision every ``--eval-every`` steps on fresh
  pairs; the best-recall checkpoint and periodic ``.latest`` ones go to
  ``--out`` (one npz: the matcher and its frozen SuperPoint).

Draws come from ``torch.Generator``s seeded by ``--seed``: the training
stream from seed, the held-out textures from 10,000 + seed.

Run: python -m mlis_tpu_torch.train.pretrain_matcher --steps 6000
     python -m mlis_tpu_torch.train.pretrain_matcher --tiny --device cpu --out /tmp/lg.npz
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--kpts", type=int, default=512)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=360)
    ap.add_argument("--peak-lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--eval-every", type=int, default=200)
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--eval-batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", choices=("lightglue", "superglue"), default="lightglue",
                    help="matcher head: dual-softmax LightGlue (default) or the "
                    "Sinkhorn-dustbin SuperGlue variant; its 1 - dustbin mass feeds "
                    "the same matchability term")
    ap.add_argument("--out", default=None,
                    help="checkpoint path (best held-out recall); default "
                    "checkpoints/<arch>_homog.npz (_parallax with --parallax)")
    ap.add_argument("--init-from", help="warm-start from a save_weights npz")
    ap.add_argument("--sp-init",
                    help="trained SuperPoint weights (pretrain_superpoint npz) as the frozen "
                    "front end instead of random filters")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model and small images (a CPU rehearsal of the driver)")
    ap.add_argument("--depth", type=int, default=9, help="matcher depth (default 9)")
    ap.add_argument("--dim", type=int, default=256, help="matcher width (default 256)")
    ap.add_argument("--parallax", action="store_true",
                    help="train on layered-scene SE(3) pairs with occlusion-aware GT "
                    "instead of single homographies")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.tiny:
        args.kpts, args.height, args.width = 48, 64, 96
        args.eval_batch = 4

    from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig, SuperGlue
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.train.driver import run_chunked_training
    from mlis_tpu_torch.train.matcher_trainer import MatcherTrainer, draw_textures
    from mlis_tpu_torch.train.optim import ClippedAdam, warmup_cosine_decay_schedule

    if args.out is None:
        args.out = f"checkpoints/{args.arch}_{'parallax' if args.parallax else 'homog'}.npz"
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    log_path = out.with_name(out.stem + "_log.json")
    dev = torch.device(args.device)

    cls = SuperGlue if args.arch == "superglue" else LightGlue
    if args.tiny:
        mcfg = MatcherConfig.tiny_test(
            assignment="sinkhorn" if args.arch == "superglue" else "dual_softmax")
    elif args.depth == 9 and args.dim == 256:
        mcfg = None  # the class's own factory
    else:
        mcfg = cls.matcher_cfg_factory(depth=args.depth, dim=args.dim)
    lg = cls(sp_cfg=(SuperPointConfig.tiny_test(max_keypoints=args.kpts) if args.tiny
                     else SuperPointConfig(max_keypoints=args.kpts)),
             matcher_cfg=mcfg, device=dev).init_random_(args.seed)
    if args.init_from:
        lg.load_weights(args.init_from, image_hw=(args.height, args.width))
        print(f"warm-started from {args.init_from}", flush=True)
    if args.sp_init:
        from mlis_tpu_torch.weights import load_npz

        lg.sp.load_state(load_npz(args.sp_init)["superpoint"])
        print(f"frozen SuperPoint loaded from {args.sp_init}", flush=True)
    warmup = min(args.warmup, max(args.steps // 4, 1))
    schedule = warmup_cosine_decay_schedule(0.0, args.peak_lr, warmup, args.steps,
                                            end_value=1e-6)
    trainer = MatcherTrainer(lg, (args.height, args.width),
                             optimizer=ClippedAdam(lg.net.parameters(), schedule),
                             seed=args.seed,
                             pair_mode="parallax" if args.parallax else "homography")

    # fixed held-out textures from a seed disjoint from the training stream
    eval_imgs = draw_textures(args.eval_batch, args.height, args.width,
                              torch.Generator(dev).manual_seed(10_000 + args.seed), dev)

    history = {"config": {k: getattr(args, k) for k in (
        "steps", "chunk", "batch", "kpts", "height", "width", "peak_lr", "warmup", "seed",
        "depth", "dim", "parallax")}}
    return run_chunked_training(trainer, eval_imgs.cpu().numpy(), out, log_path, history,
                                steps=args.steps, chunk=args.chunk, batch=args.batch,
                                eval_every=args.eval_every, save_every=args.save_every)


if __name__ == "__main__":
    main()
