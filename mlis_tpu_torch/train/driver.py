"""The chunked train / eval / save-best loop of the pretraining drivers.

Counterpart of ``mlis_tpu/train/driver.py``: pretrain_matcher.py
(LightGlue / SuperGlue) and pretrain_loftr.py build their model,
optimiser and trainer and hand off here: chunks of steps, a held-out
match-metric eval every ``eval_every`` steps, best-recall checkpoints
(the reported recall is always what the saved weights measured), a
``.latest`` checkpoint every ``save_every`` steps, and the JSON history
written after every chunk, so an interrupted run keeps its log.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


def run_chunked_training(
    trainer,  # exposes train_chunk / match_metrics / save_checkpoint
    eval_imgs,
    out: Path,
    log_path: Path,
    history: dict,
    steps: int,
    chunk: int,
    batch: int,
    eval_every: int,
    save_every: int,
) -> dict:
    m0 = trainer.match_metrics(eval_imgs)
    print(f"step 0: recall={m0['recall']:.4f} precision={m0['precision']:.4f} "
          f"n_gt={m0['n_gt']} n_pred={m0['n_pred']}", flush=True)
    history.setdefault("loss", [])
    history.setdefault("eval", []).append((0, m0["recall"], m0["precision"]))
    # recall of the weights in the checkpoint file (-1: none saved yet): the
    # first eval after training always saves, and the reported number is
    # what the saved weights measured, never step 0's
    saved_recall = -1.0

    done = 0
    t0 = time.time()
    next_eval = eval_every
    next_save = save_every
    while done < steps:
        n = min(chunk, steps - done)
        losses = trainer.train_chunk(n, batch_size=batch)
        done += n
        history["loss"].append((done, float(losses.mean())))
        rate = done / (time.time() - t0)
        print(f"step {done}/{steps}: loss={losses.mean():.4f} "
              f"(last {losses[-1]:.4f}) {rate:.2f} steps/s", flush=True)
        if done >= next_eval or done >= steps:
            next_eval += eval_every
            m = trainer.match_metrics(eval_imgs)
            history["eval"].append((done, m["recall"], m["precision"]))
            print(f"  eval@{done}: recall={m['recall']:.4f} "
                  f"precision={m['precision']:.4f} n_pred={m['n_pred']}", flush=True)
            if m["recall"] > saved_recall:
                saved_recall = m["recall"]
                trainer.save_checkpoint(str(out))
                print(f"  saved best checkpoint (recall {saved_recall:.4f})", flush=True)
        if done >= next_save:
            next_save += save_every
            trainer.save_checkpoint(str(out.with_suffix(".latest.npz")))
        log_path.write_text(json.dumps(history))

    history["best_recall"] = saved_recall
    history["wall_s"] = time.time() - t0
    log_path.write_text(json.dumps(history))
    print(f"done: best held-out recall {saved_recall:.4f} in {history['wall_s']:.0f}s",
          flush=True)
    return history
