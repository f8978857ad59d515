#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mlis_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                  # the check, on CUDA device 0
    python3 chip_smoke.py --device cpu --keyframes 16 --scans 600 \
        --demo-iters 2 4 --real-iters 1 4  # rehearsal of every phase on the CPU

Phases, one line each as they end:

0. device: card name and power limit, TF32 settings, stale build lock;
1. build: one nvcc call over mlis_tpu_torch/csrc/*.cu (ptxas report);
2. kernel K1 (the candidate sweep) against its plain PyTorch version on
   the card: the 19,163-pose cloud, a clustered cloud with pairs at r and
   r +- 1e-9, that cloud again through the full tile grid (the launch of
   the JAX package's full-grid kernel K6), and clouds of DROID-SLAM's
   1,926 and LeGO-LOAM's 2,406 poses; counts must be identical (to the
   float64 host sweep too, up to 5,000 poses); each case prints its tiles,
   the blocks the wrapper cuts them into, and its time beside its bound,
   which counts FP64 issue slots, beside the data sheet's FLOP figure;
2b. the attention kernels (csrc/attention.cu) against their plain
   versions on the card, bf16 inputs from a seed: the dense kernel (TPU
   kernels K4/K5) at the ViT-B/14 shape of path A, without a bias and
   with a (B, 1, S, T) and a (B, H, S, T) bias, and on the ViT's strided
   slices of a packed qkv (through multi_head_attention and alone); the
   flash kernel (K2/K3)
   at LightGlue's fullres shape of path B with kv_len 0, 1, 1500 and
   2048 among its rows, a ragged S != T case, K3's size S = T = 1280, a
   1370-token ViT sequence through multi_head_attention, and path C's
   shapes (64 images x 12 heads at SALAD's 1565 and AnyLoc's 1370 tokens
   on the slices of a packed qkv), LightGlue's verify batch at 512
   keypoints through ``masked_attention`` (2 x 256 pairs x 4 heads, a row
   with kv_len 0 averaging V) against the plain float32-logit route, and
   path D's SuperGlue verify batch
   (2 x 256 pairs x 4 heads at 2048 keypoints, each row's kv_len the
   valid keypoints of a path D keyframe under the random SuperPoint); each
   with its error and tolerance, its time, the plain version's, the
   scaled_dot_product_attention yardstick's, and its bound;
3. the main path as bench.py's default mode runs it: the sweep through
   ``gating.integration.analyze``, then ``FullGatePipeline.process`` on
   128 mono8 keyframes at 270x360 with the shipped MixVPR and LightGlue
   checkpoints, with bench.py's keywords ``survivor_budget`` = the
   previous run's survivors and ``monolithic=True``: one exact run that
   sets the budget, then a warm-up, three timed runs and one run under
   torch.profiler (device time per stage and kernel), all four down the
   one-fetch path, host keyframes uploaded once); LightGlue's attention
   launches the flash kernel, 2 x depth times a matcher call;
4. the same gate at 16 keyframes on the card and on the CPU in float32
   with TF32 off and the same RANSAC draws: identical candidate and
   survivor pairs, decisions equal except within 1 inlier or 0.01 of
   ratio of a threshold;
5. path A, the gate at its default VPR method: CricaVPR (the shipped
   ViT-B/14 at 322x322, bf16) on phase 3's keyframes, every block's
   attention on the dense kernel (12 launches per encode batch of 64),
   LightGlue's 18 attentions per verify batch on the flash kernel;
6. path B, the fullres gate with every keypoint matched: 128 keyframes
   at 540x720, SuperPoint at 2048 keypoints, the fullres LightGlue, its
   18 attentions per verify batch on the flash kernel.
7. the decision-quality harness, bench.py quality2: v2 GT scenes (4
   floors x 32 places x 2 passes, 270x360) drawn and rendered on the card
   for seeds 0, 1 and 2, ``eval.quality.run_gate_quality`` with the
   parallax-trained tiny encoder and LightGlue (top-16 at 0.30, 512
   keypoints, verify batches of 256), the no-floor-gate ablation, the
   retrieval rows of every encoder (pixel, trained_vpr_v2, trained_vpr,
   mixvpr_trained, salad, anyloc) on seed 0 and of pixel, SALAD and AnyLoc
   over the three seeds, and the CricaVPR rows (rr_cricavpr*,
   aliased_rate_*, ``run_gate_quality_rerank``'s f1_crica_rerank_off/on,
   rr_crica_tiny*); it fails on a missing checkpoint, on a gate that
   launches anything but the flash kernel (LightGlue's attention), on any
   launch in the other encoders' retrieval rows (the reference builds
   those ViTs with use_pallas=False), on CricaVPR retrieval rows that
   launch anything but the dense kernel, on a 3-seed mean F1 below 0.75 or precision below 0.9, on an
   ablation F1 not below the gated one, or on a 3-seed retrieval recall of
   SALAD or AnyLoc not above the pixel encoder's. quality2's other matcher
   rows follow in bench.py's order, seeds 0-2 and one profiled seed-0 call
   each: SuperGlue (reported as skipped when superglue_homog.npz is not in
   the copy, bench.py's own rule), ORB (weight-free, verify batches of
   256, pair by pair through ``verify``) and LoFTR (loftr_parallax.npz,
   batches of 32); the phase fails on a missing loftr_parallax.npz, any
   kernel launch in these rows but SuperGlue's flash launches, a LoFTR mean F1 below 0.75 or precision
   below 0.9, an ORB mean precision below 0.9 or F1 below 0.15. Then ORB,
   LoFTR and a random SuperGlue on four pairs of the seed-0 scene on the
   card and on the CPU (ORB keypoints equal and descriptor bits >= 99%
   equal, Hamming matching equal on the same words, LoFTR's matched cells
   >= 98% shared, SuperGlue's match counts within max(3, 5%)). Then one
   small scene drawn once and rendered on the card and on the CPU, and the
   harness on both with the same RANSAC draws, in float32 and with the
   shipped bf16 models, and the ORB and LoFTR rows, held to the renderer's
   parity rule and to the harness's band rule for each;
8. path C, the gate with the rest of the VPR menu: SALAD (476x644, 1565
   tokens, 8448-d) and AnyLoc (518x518, 1370 tokens, 49152-d), each a
   ViT-B/14 from torch.Generator(0), on phase 5's keyframes and matcher,
   every block's attention on the flash kernel (12 launches per encode
   batch of 64, and the matcher's 18 per verify batch) and none on the
   dense kernel; then unit, finite
   descriptors of the right width, and the first 4 keyframes through each
   encoder on the card and on the CPU with the same weights (cosine
   >= 0.999);
9. path D, the fullres gate with the SuperGlue head (bench.py fullres with
   MLIS_MATCH_TOP_K=0 and MLIS_MATCHER_ARCH=superglue): phase 6's
   keyframes, MixVPR and protocol, SuperPoint and SuperGlue random from
   torch.Generator(0) (superglue_homog.npz is not in the copy, and
   bench.py random-initialises without it), the keypoints' kv_len
   distribution, 18 flash launches per verify batch, the Sinkhorn head
   (20 log-space iterations over 256 x 2049 x 2049 float32) under its own
   profiler range;
10. the floor-labelling path at one NUFR-M3F traversal's size, every
   input drawn on the device from torch.Generator(0): 240,000 IMU samples
   (1,200 s at 200 Hz, make_demo_data's noise, four planted rides 5 -> 4
   -> 5 -> 4 -> 5) through ``IMUFloorDetector`` onto 19,163 pose times
   (exactly the four rides, the labels they imply, card against CPU);
   3,000 OS-128 scans (128 rings x 1024 columns, 4.7 GB on the device)
   through ``LiDARFloorTracker.process_scans`` with ring ids (every scan
   on its simulated floor outside the rides, the four transitions, 8 scans
   card against CPU on the same draws); their fusion and agreement;
   ``SemanticGatingPipeline.detect_floors``, the exact sweep with those
   labels through ``integration.analyze`` (one K1 launch, counts equal to
   the float64 host sweep), ``gate_candidates`` on 4,096 candidate pairs
   and the report; ``ORBSlam3SemanticIntegration.run_full_analysis`` and
   ``run_comparison`` over four TUM files (19,163 poses); and the
   ``StreamingGate`` at capacity, width and length 4,096 in micro-batches
   of 16 with the ``stream`` CLI's revisits and traps (each revisit
   accepted, each trap rejected, 512 frames card against CPU), then
   ``measure_compute_rate``. Each part prints its seconds, rate, peak
   memory and launches; a launch other than K1's in the sweeps fails it.
11. the pose-graph back end and host evaluation, outside inference mode
   (the solvers differentiate): (a) ``python -m mlis_tpu_torch pgo --seed
   0`` at the demo's defaults (20 Gauss-Newton steps of 256 CG iterations,
   six solves, each CG iteration replayed from a CUDA graph), held to the
   JAX package's demo contract, then the six solves at 3 x 32 on the card
   and on the CPU from the same inputs (poses within DEMO_POSE_ATOL,
   SC / GNC / PCM decisions equal outside DECISION_BAND of the cut);
   (b) ``opt.scale.run_pgo_real`` with the JAX package's defaults (12 x
   1024, three solves, every candidate) on a synthetic LeGO-LOAM-size
   traversal of 2,406 poses written as TUM files, its counts beside the
   published run's and equal to one K1 launch's, gated < odometry <
   ungated ATE, then one Gauss-Newton step of the ungated graph eager and
   from the graph on the card and on the CPU, with the device operations
   and seconds per CG step; (c) ``run_full_evaluation`` over the traversal
   and an orb_slam3 copy with a planted 0.1 m error (recovered within 2%),
   the summary tables, Table IV CSV and summary markdown, and the gate and
   evaluate CLIs (two K1 launches; the SemanticEvaluator JSON carries the
   reports' counts and rates).
12. model families and weight import, under inference mode: (a) the
   official LoFTR (``LoFTRConfig.official_full``: d_model 256, 8 heads,
   depth 4, block dims 128/196/256, fine 128, bf16) with random 0.5x
   Kaiming weights drawn from torch.Generator(0) in the kornia layout and
   loaded through ``load_torch_state_dict``, as the matcher of the fullres
   MixVPR gate on path B's keyframes (540x720, resized to 536x720; verify
   batches of 32; coarse threshold 1e-6): pairs/s, the device time of
   ``loftr.match`` (``loftr.coarse``, ``loftr.fine``) and
   ``epipolar.ransac``, peak memory, matches per pair; then float32 card
   vs CPU on 2 revisit pairs (coarse selections equal outside 1% of the
   threshold, keypoints within 5e-3 px) and a save_weights / load_weights
   round trip with identical matches; (b) YOLOv8n (random, flax's
   initialisers from torch.Generator(0)) in ``DynamicObjectFilter`` on
   the 128 fullres keyframes as BGR, batches of 64 at 544x736: images/s,
   peak memory, ``get_metrics()``; float32 card vs CPU on 4 frames (raw
   head maps within 1e-4 of their largest magnitude, NMS on the same boxes
   and the masks of planted boxes of every dynamic class and a chair
   exact); (c) official-layout dicts drawn on the card from
   torch.Generator(0): DINOv2 ViT-B/14 into CricaVPR (phase 3's 128
   keyframes, 24 dense-kernel launches, cosine >= 0.999 against the CPU
   on 4), torchvision ResNet-50 into MixVPR (the same checks, no launch),
   cvg/LightGlue + magicleap SuperPoint into LightGlue (float32 scores on
   the same keypoints within 1e-4 of the CPU's, then save_weights /
   from_checkpoint with equal weights and identical scores).
13. the parallel package and the trainer, on a one-rank mesh (``nccl`` on
   the card; the card's machine holds one H100, so the collectives are
   copies and the step measures the framework's cost): (a) bench.py's
   ``multichip`` mode on phase 3's 128 keyframes, MixVPR and LightGlue
   (1024 keypoints, top 512 matched): one exact ``process`` for the
   budget, the best of three budgeted monolithic runs, then
   ``sharded_full_gate_step(exact=False)`` at the same slot count and the
   best of three runs of its program; the directed stats equal a host
   recount, every valid slot holds an accepted same-floor pair, matches
   and inliers equal the single-card fused program on the same pairs and
   draws, the matcher's 2 x depth flash launches a fused call and no other;
   (b) the step with path A's CricaVPR as its encoder: one dense
   launch per block per encode call, 2 x depth flash launches (the
   matcher's one fused call), descriptors within
   cosine 0.999 of the batched encode; (c) ``query_sharded_topk`` and
   ``db_sharded_topk`` on 19,163 x 4,096 unit descriptors from
   torch.Generator(0), 0.05 s apart, equal to ``cosine_topk``; (d) five
   ``VPRTrainer`` steps of a float32 ViT-B/14 (plain attention) on a fixed
   batch of 32 at 224x224 (8 places x 4 views), the initial loss on 8
   images within 1e-3 of the CPU's, steps/s and peak memory, then
   ``run_demo()`` held to its contract; (e) ``estimate_gate_scaling`` at 4
   and 8 cards calibrated by (a)'s single-card rate.
14. the pretraining drivers, outside inference mode, each ``main`` at its
   own widths with its outputs in a temporary directory: (a)
   ``pretrain_matcher`` (LightGlue d9 / 256, 512 keypoints, 270x360,
   batch 8, ``--parallax`` from ``lightglue_parallax_sp.npz``, 20 steps in
   chunks of 10, evals of 16 pairs every 10): steps/s, peak memory, the
   losses, the shipped weights' step-0 recall and precision beside the
   log's best (fails below 0.5), the saved npz reloaded through
   ``LightGlue.from_checkpoint`` equal to the trainer's weights at float16
   rounding; then ``--arch superglue`` from random weights for 10 steps
   (finite losses, the weights move); (b) ``pretrain_loftr --parallax``
   at 272x360, batch 4, from ``loftr_parallax.npz``, reported likewise;
   (c) ``pretrain_superpoint`` at its defaults from random weights,
   ``corner_metrics`` and ``repeatability`` at steps 0 and 20; (d)
   ``pretrain_vpr`` for tiny (from ``vpr_tiny_v2.npz`` at 136x180, 20
   steps), SALAD and MixVPR (10), CricaVPR (ViT-B/14 at 322, batch 32, 5)
   and AnyLoc's 64-cluster fit; (e) one tiny float32 step of each trainer
   on the card and on the CPU from the same weights and draws (losses
   within 1e-4 relative, weights within 1e-4 relative and 2 lr an
   entry); every training step runs the plain attention: no kernel may
   launch in (a)-(e) but the flash kernel in the matchers' held-out
   evaluations under torch.no_grad(); (f) ``flash_mha`` and
   ``multi_head_attention`` raise on inputs that require grad and launch
   under ``torch.no_grad()``. The CPU rehearsal runs (a)-(d) with
   ``--tiny`` and without the two full backbones.
15. the IO path, under inference mode, in a temporary directory (nothing
   under results/): (a) phase 10's 240,000 IMU samples (stamps from
   1.7e9), a 12,000-message 10 Hz odometry track and 300 of its OS-128
   scans (the 30 s around the first ride; 48-byte Ouster points) written
   with ``BagWriter`` (about 1.9 GB, uncompressed chunks); ``info`` and
   the three extractions timed with the native runtime required (g++,
   built on first use into build/mlis_tpu_torch/), each stream equal to
   what was written, then the IMU detector and the LiDAR tracker on the
   card from the bag's streams and from phase 10's arrays with the same
   RANSAC draws: events, labels and planes identical; (b) ~64 MB of the
   IMU and odometry records through lz4 and bz2 chunks, read back equal;
   (c) the CLI in-process, launch counters set to 0 before each call:
   ``bag info`` / ``odom-tum`` / ``imu-plot``, the pipeline on the bag's
   TUM file and a whitespace IMU table (its two figures), ``fullgate`` on
   its synthetic scene with MixVPR and with CricaVPR (dense launches
   required), ``stream``, ``calib generate``, and ``all`` over phase 11's
   traversal plus a droid_slam copy (three K1 launches, every figure).
   Where matplotlib (or yaml) is not installed, as on the card's machine,
   each call that needs it must raise ModuleNotFoundError naming it and is
   reported as not run: the pipeline then runs main's steps before its
   figures, and ``gate`` + ``evaluate`` over the same tree stand in for
   ``all`` (the same three K1 launches);
   (d) ``utils.roofline`` over phase 3's profiled stage spans against the
   H100's peaks. Rehearse it alone on the CPU (a few minutes):
   ``python -c "import argparse, torch, chip_smoke as c; torch.inference_mode().__enter__(); c.phase_io(torch.device('cpu'), argparse.Namespace(scans=600, io_scans=100, io_fullgate_frames=32), {'spans': {}})"``.
16. the budget paths of ``FullGatePipeline.process`` and the experiment
   twins, under inference mode: (a) phase 3's pipeline and keyframes
   down the exact path, the budgeted path (``survivor_budget`` = the exact
   run's survivors), the one-fetch path (the keyframes already on the
   card, ``monolithic=True``) and the same path on host keyframes (one
   upload; ``upload_chunk`` changes nothing): each once on one set of
   RANSAC draws (counts and pairs equal to the exact path's, decisions
   within the bf16 band rule of phase 7) with the calls of the methods
   that show the path taken, then pairs/s (best of three after a
   warm-up), peak memory, one profiled run (kernel time, busy share) and
   the card's synchronisations under
   ``torch.cuda.set_sync_debug_mode("warn")``; a budget of 1 on the
   budgeted and one-fetch paths (the exact path reruns) and a threshold of
   2.0 (empty); (b) path A's CricaVPR and (c) path B through the one-fetch
   path (12 dense launches for the 128 frames in one encode call, in (b);
   2 x depth flash launches for one fused call over every slot, in both),
   each against
   its exact run; (e) every ``mlis_tpu_torch/experiments`` twin at one
   seed (loftr_heldout at 4) with its outputs in a temporary directory;
   superglue_cut is reported as not run where ``superglue_parallax.npz``
   is not in the copy.
Phases 5, 6, 8, 9 and 12a run like phase 3 (warm-up, three timed runs, one
profiled run), with every launch counter set to 0 before each run.

The last two lines of standard output are the card's name and power limit
and ``{"ok": true, "device": {...}}``; the line before them lists each
ported kernel with its launches (one run of each path that reaches it,
summed, and by path) and its times. Any failure
exits nonzero; so does a run with no CUDA device, or one from a directory
without the mlis_tpu_torch package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch

H100_FP64_FLOPS = 34e12  # H100 SXM, FP64 outside the tensor cores (NVIDIA data sheet)
# FP64 instructions per second: the data-sheet rate counts each FMA as two
# operations (132 SMs x 64 FP64 lanes x 2 x ~1.98 GHz); K1's exact arithmetic
# may not contract (-fmad=false), so each DADD, DMUL or DSETP takes a slot
H100_FP64_ISSUE = H100_FP64_FLOPS / 2
H100_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)
H100_HBM_BYTES_S = 3.35e12
RADIUS, MIN_GAP = 2.0, 100
SWEEP_POSES = 19163  # ORB-SLAM3 scale (bench.py:85-91)
DROID_POSES, LEGO_POSES = 1926, 2406  # the published trajectories (tests/test_parity_reference.py)
TIMED_REPS = 3
SMALL_KEYFRAMES = 16  # phase 4
ENCODE_BATCH = 64  # FullGatePipeline.process's default encode batch (paths A, B)
VERIFY_BATCH = 256
KERNEL_REPS = 20  # CUDA-event timing: launches per measurement, after a warm-up
PLAIN_REPS = 3
COMPARE_ROWS = 64  # bh rows the plain version checks at the flash kernel's full shape
BUDGET_S = 1000  # the whole script; the check allows 1200 s


def log(phase: str, t0: float, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[phase {phase}] {time.perf_counter() - t0:.3f}s {body}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, stdin=subprocess.DEVNULL,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- inputs ---------------------------------------------------------------------

def orbslam_scale_cloud(n: int):
    """The synthetic ORB-SLAM3-scale cloud bench.py builds without reference data."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 3)) * 30
    positions = centers[rng.integers(0, 8, n)] + rng.normal(size=(n, 3))
    floors = rng.integers(1, 6, n)
    return positions, floors


def boundary_cloud(n: int = 4000):
    """Clustered cloud plus planted pairs at exactly r and r +- 1e-9."""
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(8, 3)) * 30
    pos = centers[rng.integers(0, 8, n)] + rng.normal(size=(n, 3))
    for k, dx in enumerate((0.0, -1e-9, 1e-9, 0.0, -1e-9, 1e-9)):
        i, j = 10 * k, 10 * k + 2 * MIN_GAP
        pos[i] = (500.0 + 10 * k, 500.0, 500.0) if k < 3 else pos[i]
        pos[j] = pos[i] + (RADIUS + dx, 0.0, 0.0)
    return pos, rng.integers(1, 6, n)


def keyframes(n: int, h: int = 270, w: int = 360, cell: int = 8):
    """bench.py's headline workload: n mono8 keyframes repeating n/8 scenes
    of cell x cell blocks (bench.py:133-147; the fullres protocol uses 540x720
    and cell 16)."""
    rng = np.random.default_rng(0)
    n_scenes = max(n // 8, 1)
    bases = [
        np.kron(rng.integers(0, 255, (h // cell + 1, w // cell + 1), dtype=np.uint8),
                np.ones((cell, cell), np.uint8))[:h, :w]
        for _ in range(n_scenes)
    ]
    images = np.stack([bases[i % n_scenes] for i in range(n)])
    timestamps = np.arange(n) * 30.0
    floors = np.asarray([5] * (n // 2) + [2] * (n - n // 2))
    f = 200.0 * (w / 360.0)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    return images, timestamps, floors, K


# -- phases ---------------------------------------------------------------------

def phase_device(args) -> torch.device:
    t0 = time.perf_counter()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(2)
    dev = torch.device(args.device)
    # float32 matmuls and convolutions in full float32: retrieval relies on
    # exact float32 sums of bf16 products, and phase 4 compares with the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mlis_tpu_torch import _build

    lock = _build.BUILD_DIR / "lock"
    stale = lock.exists()
    if stale:
        lock.unlink()
    fields = {"torch": torch.__version__, "tf32_matmul": False, "tf32_cudnn": False,
              "removed_stale_lock": stale}
    if dev.type == "cuda":
        fields.update(cuda=torch.version.cuda, name=json.dumps(torch.cuda.get_device_name(0)),
                      nvidia_smi=json.dumps(gpu_name_and_power()))
    log("0 device", t0, **fields)
    return dev


def phase_build(dev) -> None:
    t0 = time.perf_counter()
    if dev.type != "cuda":
        log("1 build", t0, skipped="cpu rehearsal (no nvcc)")
        return
    from mlis_tpu_torch import _build

    info = _build.build(ptxas_verbose=True)
    _build.library()
    for kernel, report in ptxas_report(info["ptxas"]):
        print(f"  ptxas {kernel}: {report}", flush=True)
    log("1 build", t0, built=info["built"], nvcc_s=f"{info['seconds']:.3f}", lib=info["path"])


def ptxas_report(text: str):
    """(kernel, registers / spills / shared memory) per entry function of
    nvcc's -Xptxas -v output, the template arguments spelled out."""
    import re

    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            name = next((k for k in ("attention_wgmma_kernel", "attention_f32_kernel",
                                     "tri_count_kernel") if k in mangled), mangled)
            dtype = re.search(r"(bfloat16|__half)", mangled)
            dims = re.findall(r"Li(\d+)E", mangled)
            dense = re.search(r"Lb([01])E", mangled)
            if dims and name == "tri_count_kernel":
                name += f"<row strips 2^{dims[0]}>"
            elif dims:
                name += (f"<{dtype.group(1).strip('_') if dtype else 'float'}, Dh {dims[0]}, "
                         f"{'dense' if dense and dense.group(1) == '1' else 'flash'}>")
            out.append([name, ""])
        elif name and ("spill" in line or "Used" in line):
            out[-1][1] += ("; " if out[-1][1] else "") + line.split(":")[-1].strip()
    return [tuple(x) for x in out]


def graph_ms(fn, reps: int) -> float:
    """Device time of one ``fn`` call: CUDA events around one replay of a
    CUDA graph of ``reps`` calls (launches from Python cannot keep a
    kernel of a few microseconds fed)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel_ms(pos, fl, ti, tj, r2, log_split: int, reps: int = 50) -> float:
    """Mean device time of one K1 launch with 2**log_split blocks a tile
    (the raw C entry point), after a warm-up: :func:`graph_ms`."""
    import ctypes

    from mlis_tpu_torch import _build

    lib = _build.library()
    out = torch.zeros(2, dtype=torch.int64, device=pos.device)
    argv = [ctypes.c_void_p(t.data_ptr()) for t in (pos, fl, ti, tj)] + [
        ctypes.c_int(int(ti.numel())), ctypes.c_int(int(pos.shape[0])),
        ctypes.c_int(MIN_GAP), ctypes.c_double(r2), ctypes.c_int(log_split),
        ctypes.c_void_p(out.data_ptr())]

    def launch():
        stream = ctypes.c_void_p(torch.cuda.current_stream(pos.device).cuda_stream)
        _build.check(lib.mlis_tri_count(*argv, stream), "tri_count")

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    return graph_ms(launch, reps)


def phase_kernel_check(dev) -> dict:
    from mlis_tpu_torch.ops import pairwise as pw

    t0 = time.perf_counter()
    r2 = RADIUS * RADIUS
    stats = {}
    cases = [("a_orbslam_scale", *orbslam_scale_cloud(SWEEP_POSES), "tri"),
             ("b_boundary", *boundary_cloud(), "tri"),
             ("c_boundary_all_tiles", *boundary_cloud(), "all"),
             ("d_droid_scale", *orbslam_scale_cloud(DROID_POSES), "tri"),
             ("e_lego_scale", *orbslam_scale_cloud(LEGO_POSES), "tri")]
    max_err = 0
    for name, positions, floors, tiles in cases:
        pos, fl, ti, tj = pw.pack_sweep_inputs(positions, floors, MIN_GAP, dev)
        if tiles == "all":
            ti, tj = (torch.as_tensor(t, device=dev) for t in pw.all_tiles(pos.shape[0]))
        # the wrapper's cut of each tile into blocks, from the card's SM count
        log_split = (pw.sweep_split(ti.numel(), pw.sm_count(dev)) if dev.type == "cuda" else 0)
        got = pw.tri_count(pos, fl, ti, tj, MIN_GAP, r2)
        sync(dev)
        tp = time.perf_counter()
        want = pw.tri_count_plain(pos, fl, ti, tj, MIN_GAP, r2)
        sync(dev)
        plain_ms = (time.perf_counter() - tp) * 1e3
        # the numpy float64 sweep as a third opinion where it is quick
        host = (pw.candidate_counts_host(positions, floors, RADIUS, MIN_GAP)[:2]
                if pos.shape[0] <= 5000 else want)
        err = max(abs(a - b) for a, b in zip(got, want))
        max_err = max(max_err, err)
        if got != want or got != host:
            raise AssertionError(f"K1 {name}: kernel {got} plain {want} host float64 {host}")
        fields = {"case": name, "n": pos.shape[0], "tiles": int(ti.numel()),
                  "log_split": log_split, "blocks": int(ti.numel()) << log_split,
                  "blocks_that_pair": len(pw.split_blocks(ti.cpu().numpy(), tj.cpu().numpy(),
                                                          pos.shape[0], MIN_GAP, log_split)),
                  "total": got[0], "same_floor": got[1], "cross_floor": got[0] - got[1],
                  "plain_ms": f"{plain_ms:.3f}"}
        if dev.type == "cuda":
            fields["kernel_ms"] = f"{time_kernel_ms(pos, fl, ti, tj, r2, log_split):.5f}"
        # the loop bounds skip pairs with j - i < min_gap, so every case
        # (the full tile grid too) computes the index-valid pairs only
        pairs = pw.index_valid_pairs(pos.shape[0], MIN_GAP)
        # 9 FP64 instructions a pair: 3 DADD (differences), 3 DMUL, 2 DADD
        # (the sum), 1 DSETP (d^2 <= r^2)
        ops = 9 * pairs
        nbytes = pos.shape[0] * (24 + 4) + 8 * int(ti.numel()) + 16
        t_ops, t_bytes = ops / H100_FP64_ISSUE, nbytes / H100_HBM_BYTES_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        flop_bound_ms = max(ops / H100_FP64_FLOPS, t_bytes) * 1e3  # the data-sheet figure
        fields.update(pair_distances=pairs, bound_ms=f"{bound_ms:.6f}",
                      flop_bound_ms=f"{flop_bound_ms:.6f}")
        if name.startswith("a_"):
            stats = {"sweep_counts": got,
                     "ms": float(fields.get("kernel_ms", "nan")), "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes", "by_case": {}}
        stats["by_case"][name] = {"n": pos.shape[0], "tiles": int(ti.numel()),
                                  "blocks": fields["blocks"], "bound_ms": bound_ms,
                                  "plain_ms": plain_ms,
                                  "ms": float(fields.get("kernel_ms", "nan"))}
        print("  K1 " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)
    stats["max_abs_err"] = max_err
    log("2 K1 vs plain", t0, identical=True, launches_so_far=pw.tri_count.launches)
    return stats


# -- phase 2b: the attention kernels ------------------------------------------------

def events_ms(fn, reps: int) -> float:
    """Mean device time of ``fn``, CUDA events over ``reps`` calls after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(dev, fn, reps: int) -> float:
    """Mean wall time of ``fn`` ending in a synchronise (the CPU rehearsal's
    stand-in for events_ms)."""
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def attention_bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the bf16 tensor-core time of the
    operations and the HBM time of the bytes."""
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_tolerance(v: torch.Tensor, flash: bool):
    """(rtol, atol, reason) for a bf16 kernel against its plain version."""
    if not flash:
        return 2.0**-7, 1e-5, ("bf16 output of float32 arithmetic summed in another order: "
                               "one bf16 ulp (2^-7 relative)")
    return 2.0**-7, 2.0**-8 * float(v.abs().max()), (
        "p is rounded to bf16 before p v at the running max's scale in the kernel and at "
        "the row max's in the plain version: 2^-9 max|v| per output, plus one bf16 ulp")


def check_attention(name, got, want, v, flash: bool) -> dict:
    rtol, atol, reason = attention_tolerance(v, flash)
    g, w = got.float(), want.float()
    both_nan = torch.isnan(g) & torch.isnan(w)
    diff = (g - w).abs().masked_fill(both_nan, 0.0)
    err = float(diff.max())
    bad = (diff > atol + rtol * w.abs()) | (torch.isnan(g) != torch.isnan(w))
    if bool(bad.any()):
        raise AssertionError(f"attention case {name}: max_abs_err {err} exceeds rtol {rtol} "
                             f"atol {atol} at {int(bad.sum())} entries")
    return {"max_abs_err": err, "rtol": rtol, "atol": atol, "tolerance_reason": reason}


def phase_attention_check(dev) -> dict:
    """Each attention kernel against its plain version on bf16 inputs, with
    times, the SDPA yardstick and bounds; returns the kernels-line fields."""
    import torch.nn.functional as F

    from mlis_tpu_torch.ops import attention as att
    from mlis_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cuda = dev.type == "cuda"
    shrink = 1 if cuda else 64  # the CPU rehearsal cuts bh, never S, T or Dh
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def timed(fn, reps):
        return events_ms(fn, reps) if cuda else host_ms(dev, fn, 1)

    cases = []

    def record(name, kernel, fields):
        cases.append({"case": name, "kernel": kernel, **fields})
        print("  2b " + " ".join(f"{k}={v}" for k, v in cases[-1].items()), flush=True)

    # dense kernel (K4, K5) at path A's ViT-B/14 shape: 64 images x 12 heads,
    # 530 tokens (529 patches + cls), Dh 64
    B, H, S, Dh = max(64 // shrink, 1), 12, 530, 64
    q4, k4, v4 = (randn(B, S, H, Dh) for _ in range(3))

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, -1, Dh).contiguous()

    q, k, v = flat(q4), flat(k4), flat(v4)
    for label, bias in (("K4_no_bias", None), ("K5_bias_B1ST", randn(B, 1, S, S, dtype=torch.float32)),
                        ("K5_bias_BHST", randn(B, H, S, S, dtype=torch.float32))):
        before = att.fused_attention.launches
        got = att.multi_head_attention(q4, k4, v4, bias=bias)
        sync(dev)
        if att.fused_attention.launches != before + (1 if cuda else 0):
            raise AssertionError(f"{label}: multi_head_attention did not launch the dense kernel")
        bias_f = None if bias is None else bias.expand(B, H, S, S).reshape(B * H, S, S)
        want = att._reference_attention(q, k, v, bias_f).reshape(B, H, S, Dh).permute(0, 2, 1, 3)
        fields = check_attention(label, got, want, v, flash=False)
        flops = 4.0 * S * S * Dh * B * H
        nbytes = 4.0 * B * H * S * Dh * 2 + (0 if bias is None else bias.numel() * 4)
        bound_ms, bound_by = attention_bound(flops, nbytes)
        mask = None if bias is None else bias.to(bf16)
        # the kernel alone on the (B, S, H, Dh) inputs (the bias read in place)
        kernel = ((lambda: att._launch_dense(q4, k4, v4, bias)) if cuda
                  else (lambda: att.multi_head_attention(q4, k4, v4, bias=bias)))
        fields.update(
            shape=f"BH={B * H},S={S},T={S},Dh={Dh}",
            ms=timed(kernel, KERNEL_REPS),
            plain_ms=timed(lambda: att._reference_attention(q, k, v, bias_f), PLAIN_REPS),
            library_ms=timed(lambda: F.scaled_dot_product_attention(
                *(x.view(B, H, S, Dh) for x in (q, k, v)), attn_mask=mask), KERNEL_REPS),
            bound_ms=bound_ms, bound_by=bound_by)
        record(label, "dense_attention", fields)
    del q4, k4, v4, q, k, v

    # the ViT's own inputs: q, k and v as slices of one packed (B, S, 3, H,
    # Dh) qkv, row stride 3 H Dh, read in place by the kernel; timed through
    # multi_head_attention and as the kernel alone
    qkv = randn(B, S, 3, H, Dh)
    q4, k4, v4 = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = att.fused_attention.launches
    got = att.multi_head_attention(q4, k4, v4)
    sync(dev)
    if att.fused_attention.launches != before + (1 if cuda else 0):
        raise AssertionError("packed qkv: multi_head_attention did not launch the dense kernel")
    q, k, v = flat(q4), flat(k4), flat(v4)
    want = att._reference_attention(q, k, v).reshape(B, H, S, Dh).permute(0, 2, 1, 3)
    fields = check_attention("K4_packed_qkv", got, want, v, flash=False)
    bound_ms, bound_by = attention_bound(4.0 * S * S * Dh * B * H, 4.0 * B * H * S * Dh * 2)
    mha_ms = timed(lambda: att.multi_head_attention(q4, k4, v4), KERNEL_REPS)
    kernel_ms = (timed(lambda: att._launch_dense(q4, k4, v4, None), KERNEL_REPS) if cuda
                 else mha_ms)
    fields.update(
        shape=f"B={B},S={S},H={H},Dh={Dh},row_stride={q4.stride(1)}",
        ms=kernel_ms, multi_head_attention_ms=mha_ms,
        mha_over_kernel=mha_ms / kernel_ms,
        library_ms=timed(lambda: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q4, k4, v4))), KERNEL_REPS),
        bound_ms=bound_ms, bound_by=bound_by)
    record("K4_packed_qkv", "dense_attention", fields)
    del qkv, q4, k4, v4, q, k, v

    # flash kernel (K2, K3): LightGlue's fullres verify batch, 2 x 256 pairs
    # x 4 heads at 2048 keypoints; kv_len 0, 1, 1500, 2048 among the rows
    flash_cases = [
        ("K2_pathB", max(2048 // shrink, 8), 2048, 2048),
        ("K2_ragged_S_ne_T", 64, 1000, 2047),
        ("K3_size_1280", max(256 // shrink, 8), 1280, 1280),
    ]
    rng = np.random.default_rng(1)
    for label, BH, S, T in flash_cases:
        q, k, v = randn(BH, S, 64), randn(BH, T, 64), randn(BH, T, 64)
        lens = rng.integers(T // 2, T + 1, BH)
        lens[:4] = [0, 1, min(1500, T), T]
        if label == "K2_ragged_S_ne_T":
            lens = rng.integers(0, T + 1, BH)
            lens[:2] = [0, T]
        kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        before = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v, kv)
        sync(dev)
        if fa.flash_attention.launches != before + (1 if cuda else 0):
            raise AssertionError(f"{label}: flash_attention did not launch the flash kernel")
        n = min(COMPARE_ROWS, BH)
        want = fa.flash_attention_plain(q[:n], k[:n], v[:n], kv[:n])
        fields = check_attention(label, got[:n], want, v[:n], flash=True)
        if not bool((got[torch.as_tensor(lens == 0, device=dev)].float() == 0).all()):
            raise AssertionError(f"{label}: a row with kv_len = 0 is not zeros")
        keys = float(np.minimum(lens, T).sum())
        flops = 4.0 * S * Dh * keys
        nbytes = 2.0 * BH * S * Dh * 2 + 2.0 * keys * Dh * 2 + 4 * BH
        bound_ms, bound_by = attention_bound(flops, nbytes)
        add = torch.zeros(BH, 1, 1, T, device=dev, dtype=bf16).masked_fill(
            torch.arange(T, device=dev)[None, None, None, :] >= kv[:, None, None, None],
            float("-inf"))
        fields.update(
            shape=f"BH={BH},S={S},T={T},Dh=64", compared_rows=n,
            ms=timed(lambda: fa.flash_attention(q, k, v, kv), KERNEL_REPS),
            plain_ms=timed(lambda: fa.flash_attention_plain(q, k, v, kv), PLAIN_REPS),
            library_ms=timed(lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], attn_mask=add), KERNEL_REPS),
            bound_ms=bound_ms, bound_by=bound_by)
        record(label, "flash_attention", fields)
        del q, k, v, add

    # LightGlue's verify batch at 512 matched keypoints (path A: 2 x 256
    # pairs x 4 heads, Kx*Ks <= 1024^2) through masked_attention: the flash
    # kernel with V's mean in a row with no valid key, against the plain
    # float32-logit route that the card ran before
    from mlis_tpu_torch.models import lightglue as lg

    B2, L = max(512 // shrink, 4), 512
    q4, k4, v4 = (randn(B2, L, 4, 64) for _ in range(3))
    lens = rng.integers(300, L + 1, B2)
    lens[:4] = [0, 1, 300, L]
    lens[4:] = np.where(rng.random(B2 - 4) < 0.8, L, lens[4:])  # most frames fill the top 512
    kv = torch.as_tensor(lens, device=dev)
    before = fa.flash_attention.launches
    got = lg.masked_attention(q4, k4, v4, kv)
    sync(dev)
    if fa.flash_attention.launches != before + (1 if cuda else 0):
        raise AssertionError("K2_lg512: masked_attention did not launch the flash kernel")
    n = min(COMPARE_ROWS // 4 + 1, B2)
    fields = check_attention("K2_lg512", got[:n], lg.dense_masked_attention(
        q4[:n], k4[:n], v4[:n], kv[:n]), v4[:n], flash=True)
    keys = 4.0 * float(np.where(lens == 0, L, lens).sum())  # an empty row averages all L
    bound_ms, bound_by = attention_bound(4.0 * L * 64 * keys,
                                         2.0 * B2 * 4 * L * 64 * 2 + 2.0 * keys * 64 * 2)
    fields.update(
        shape=f"BH={B2 * 4},S={L},T={L},Dh=64", compared_rows=n * 4,
        kv_len=f"min {int(lens.min())} median {int(np.median(lens))} max {int(lens.max())}",
        ms=timed(lambda: lg.masked_attention(q4, k4, v4, kv), KERNEL_REPS),
        plain_ms=timed(lambda: lg.dense_masked_attention(q4, k4, v4, kv), PLAIN_REPS),
        bound_ms=bound_ms, bound_by=bound_by)
    record("K2_lg512", "flash_attention", fields)
    del q4, k4, v4, got

    # path D: the SuperGlue head's verify batch at 2048 keypoints (2 x 256
    # pairs x 4 heads), each row's kv_len the valid keypoints of its source
    # keyframe under path D's random SuperPoint
    frame_lens = path_d_keypoint_counts(dev, path_d_matcher(dev), 128 if cuda else 4)
    BH, S = max(2048 // shrink, 8), 2048
    lens = np.repeat(frame_lens[np.arange(BH // 4) % len(frame_lens)], 4)
    q, k, v = randn(BH, S, 64), randn(BH, S, 64), randn(BH, S, 64)
    kv = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, kv)
    sync(dev)
    if fa.flash_attention.launches != before + (1 if cuda else 0):
        raise AssertionError("K2_pathD: flash_attention did not launch the flash kernel")
    n = min(COMPARE_ROWS, BH)
    fields = check_attention("K2_pathD", got[:n], fa.flash_attention_plain(q[:n], k[:n], v[:n],
                                                                           kv[:n]), v[:n], flash=True)
    keys = float(lens.sum())
    bound_ms, bound_by = attention_bound(4.0 * S * 64 * keys,
                                         2.0 * BH * S * 64 * 2 + 2.0 * keys * 64 * 2 + 4 * BH)
    add = torch.zeros(BH, 1, 1, S, device=dev, dtype=bf16).masked_fill(
        torch.arange(S, device=dev)[None, None, None, :] >= kv[:, None, None, None],
        float("-inf"))
    fields.update(
        shape=f"BH={BH},S={S},T={S},Dh=64",
        kv_len=f"min {int(lens.min())} median {int(np.median(lens))} max {int(lens.max())}",
        compared_rows=n, ms=timed(lambda: fa.flash_attention(q, k, v, kv), KERNEL_REPS),
        plain_ms=timed(lambda: fa.flash_attention_plain(q, k, v, kv), PLAIN_REPS),
        library_ms=timed(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], attn_mask=add), KERNEL_REPS),
        bound_ms=bound_ms, bound_by=bound_by)
    record("K2_pathD", "flash_attention", fields)
    del q, k, v, add, got

    # a ViT sequence at 518 px (1370 tokens) through multi_head_attention:
    # its score tile exceeds 4 MiB, so it dispatches to the flash kernel
    B, H, S = max(8 // shrink, 1), 12, 1370
    q4, k4, v4 = (randn(B, S, H, 64) for _ in range(3))
    before = (fa.flash_attention.launches, att.fused_attention.launches)
    got = att.multi_head_attention(q4, k4, v4)
    sync(dev)
    if cuda and (fa.flash_attention.launches, att.fused_attention.launches) != (
            before[0] + 1, before[1]):
        raise AssertionError("a 1370-token ViT sequence did not dispatch to the flash kernel")
    flat_v = v4.permute(0, 2, 1, 3).reshape(B * H, S, 64)
    want = fa.flash_attention_plain(*(x.permute(0, 2, 1, 3).reshape(B * H, S, 64).contiguous()
                                      for x in (q4, k4, v4)))
    fields = check_attention("vit_1370", got.permute(0, 2, 1, 3).reshape(B * H, S, 64), want,
                             flat_v, flash=True)
    bound_ms, bound_by = attention_bound(4.0 * S * S * 64 * B * H, 4.0 * B * H * S * 64 * 2)
    fields.update(shape=f"BH={B * H},S={S},T={S},Dh=64",
                  multi_head_attention_ms=timed(lambda: att.multi_head_attention(q4, k4, v4),
                                                KERNEL_REPS),
                  bound_ms=bound_ms, bound_by=bound_by)
    record("vit_1370_via_multi_head_attention", "flash_attention", fields)
    del q4, k4, v4

    # path C's shapes at its encode batch of 64 images x 12 heads: SALAD
    # (476x644, 1565 tokens) and AnyLoc (518x518, 1370 tokens), q, k and v
    # the slices of one packed (B, S, 3, H, Dh) qkv as the ViT passes them
    for label, S in (("C_salad_1565", 1565), ("C_anyloc_1370", 1370)):
        B = max(ENCODE_BATCH // shrink, 1)
        qkv = randn(B, S, 3, H, 64)
        q4, k4, v4 = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        before = (fa.flash_attention.launches, att.fused_attention.launches)
        got = att.multi_head_attention(q4, k4, v4)
        sync(dev)
        if cuda and (fa.flash_attention.launches, att.fused_attention.launches) != (
                before[0] + 1, before[1]):
            raise AssertionError(f"{label}: multi_head_attention did not launch the flash kernel")
        n = min(COMPARE_ROWS // H + 1, B)  # images compared: n x 12 (b, h) rows

        def rows(x, m=n):
            return x[:m].permute(0, 2, 1, 3).reshape(m * H, S, 64).contiguous()

        fields = check_attention(label, rows(got), fa.flash_attention_plain(
            rows(q4), rows(k4), rows(v4)), rows(v4), flash=True)
        bound_ms, bound_by = attention_bound(4.0 * S * S * 64 * B * H, 4.0 * B * H * S * 64 * 2)
        mha_ms = timed(lambda: att.multi_head_attention(q4, k4, v4), KERNEL_REPS)
        fields.update(
            shape=f"B={B},S={S},H={H},Dh=64,row_stride={q4.stride(1)}", compared_rows=n * H,
            ms=(timed(lambda: fa._launch_flash(q4, k4, v4, None), KERNEL_REPS) if cuda
                else mha_ms),
            multi_head_attention_ms=mha_ms,
            plain_ms=timed(lambda: fa.flash_attention_plain(rows(q4, B), rows(k4, B), rows(v4, B)),
                           PLAIN_REPS),
            library_ms=timed(lambda: F.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in (q4, k4, v4))), KERNEL_REPS),
            bound_ms=bound_ms, bound_by=bound_by)
        record(label, "flash_attention", fields)
        del qkv, q4, k4, v4, got

    out = {}
    for kernel, main in (("dense_attention", "K4_no_bias"), ("flash_attention", "K2_pathB")):
        mine = [c for c in cases if c["kernel"] == kernel]
        m = next(c for c in mine if c["case"] == main)
        out[kernel] = {"max_abs_err": max(c["max_abs_err"] for c in mine),
                       **{f: m[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}
    log("2b attention vs plain", t0, cases=len(cases), within_tolerance=True)
    return out


def build_pipeline(dev, dtype, n_kpts: int = 1024):
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue
    from mlis_tpu_torch.models.resnet import ResNetConfig
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.weights import default_matcher_checkpoint

    matcher = LightGlue.from_checkpoint(
        default_matcher_checkpoint(), sp_cfg=SuperPointConfig(max_keypoints=n_kpts, dtype=dtype),
        dtype=dtype, device=dev)
    spr = SemanticPlaceRecognition(
        "mixvpr", similarity_threshold=0.3, min_time_gap=10.0, device=dev,
        backbone_cfg=ResNetConfig(crop_stage=3, dtype=dtype))
    return FullGatePipeline(
        vpr=spr, verifier=GeometricVerifier(matcher=matcher), similarity_threshold=0.3,
        verify_batch=256, match_top_k=512, matcher_weights=None, num_hypotheses=512,
        device=dev)


STAGES = ("gate.detect", "gate.encode", "gate.retrieval", "lightglue.match", "superglue.sinkhorn",
          "loftr.match", "loftr.coarse", "loftr.fine", "orb.match", "epipolar.ransac",
          "train.pairs", "train.forward", "train.backward", "train.update")


def profile_gate(dev, pipe, inputs, gen, best_wall: float, encode_batch_size: int = 128,
                 **kw) -> dict:
    """One more gate run, with ``process``'s keywords ``kw``, under
    torch.profiler (see :func:`profile_run`)."""
    images, timestamps, floors, K = inputs
    return profile_run(dev, lambda: pipe.process(images, timestamps, floors, K,
                                                 encode_batch_size=encode_batch_size,
                                                 generator=gen, **kw),
                       best_wall)


def profile_run(dev, run, best_wall: float) -> dict:
    """``run()`` once under torch.profiler: device time per stage range and
    per kernel, and the device's busy share of the run's wall time. Returns
    the device seconds of each stage range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(dev)
        wall = time.perf_counter() - t0
    # the raw trace events: building the profiler's FunctionEvent tree takes
    # minutes for a run of some 10^5 kernels (phase 7's ORB row)
    dev_events = [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
    kernels = [(name, us) for name, us in dev_events if name not in STAGES]
    busy_us = sum(us for _, us in kernels)
    spans = {name: sum(us for n, us in dev_events if n == name) for name in STAGES}
    by_kernel: dict = {}
    for name, us in kernels:
        by_kernel[name] = by_kernel.get(name, 0) + us
    print(f"  profile wall_s={wall:.4f} unprofiled_wall_s={best_wall:.4f} "
          f"kernel_s={busy_us / 1e6:.4f} busy_share={busy_us / 1e6 / wall:.4f} "
          f"kernels={len(kernels)}", flush=True)
    print("  profile stage device spans (s): " + " ".join(
        f"{k}={v / 1e6:.4f}" for k, v in spans.items()), flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda x: -x[1])[:15]:
        print(f"  profile kernel {us / 1e6:.4f}s {name[:110]}", flush=True)
    return {k: v / 1e6 for k, v in spans.items()}


def phase_main_path(dev, args, expected_sweep) -> dict:
    from mlis_tpu_torch.gating.integration import analyze
    from mlis_tpu_torch.ops import pairwise as pw

    t0 = time.perf_counter()
    positions, floors_sweep = orbslam_scale_cloud(SWEEP_POSES)
    images, timestamps, floors, K = keyframes(args.keyframes)
    pipe = build_pipeline(dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    log("3 setup", t0, keyframes=len(images), weights="vpr_mixvpr.npz+lightglue_homog_sp.npz")

    reset_launch_counts()  # counts from here on are the main path's
    t0 = time.perf_counter()
    analysis, _gate = analyze(positions, floors_sweep, RADIUS, MIN_GAP, device=dev)
    sync(dev)
    log("3 sweep", t0, poses=len(positions), total=analysis.total_candidates,
        same_floor=analysis.same_floor_candidates, cross_floor=analysis.cross_floor_candidates,
        cross_rate=f"{analysis.cross_floor_rate:.4f}")

    runs = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    budget = None  # bench.py's reps: the survivor count of the previous rep as the budget
    for rep in range(-1, TIMED_REPS + 1):
        pipe.spr.vpr.descriptors = []
        t0 = time.perf_counter()
        res = pipe.process(images, timestamps, floors, K, encode_batch_size=128,
                           survivor_budget=budget, monolithic=True, generator=gen)
        sync(dev)
        budget = res.verified or None
        wall = time.perf_counter() - t0
        kind = {-1: "budget probe (exact)", 0: "warmup (one-fetch)"}.get(
            rep, f"timed{rep} (one-fetch)")
        log(f"3 gate {kind}", t0, candidates=res.total_pairs,
            floor_rejected=res.cross_floor_rejected, verified=res.verified,
            accepted=res.geometrically_valid, pairs_per_s=f"{res.total_pairs / wall:.1f}",
            vpr_s=f"{res.vpr_s:.4f}", retrieval_s=f"{res.retrieval_s:.4f}",
            verify_s=f"{res.verify_s:.4f}")
        if rep > 0:
            runs.append((wall, res))
        if res.total_pairs <= 0 or res.verified != res.total_pairs - res.cross_floor_rejected:
            raise AssertionError(f"gate counts inconsistent: {res.summary()}")
        for r in res.results:
            if r.relative_pose is not None and not np.isfinite(r.relative_pose).all():
                raise AssertionError(f"non-finite pose for pair {(r.query_idx, r.match_idx)}")
    best_wall, best = min(runs, key=lambda x: x[0])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if analysis.total_candidates != expected_sweep[0] or \
            analysis.same_floor_candidates != expected_sweep[1]:
        raise AssertionError(f"sweep {analysis} disagrees with phase 2's plain version")
    spans = {}
    if dev.type == "cuda":
        pipe.spr.vpr.descriptors = []
        spans = profile_gate(dev, pipe, (images, timestamps, floors, K), gen, best_wall,
                             survivor_budget=budget, monolithic=True)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu rehearsal"
    counts = launch_counts()
    launches = counts["tri_count"]
    log("3 main path", time.perf_counter(),
        pairs_per_s=f"{best.total_pairs / best_wall:.1f}", device=json.dumps(name),
        walls=",".join(f"{w:.4f}" for w, _ in runs), peak_mem_bytes=peak,
        K1_launches=launches, launches=json.dumps(counts, separators=(",", ":")))
    if dev.type == "cuda" and launches < 1:
        raise AssertionError("the main path did not launch kernel K1")
    depth = pipe.verifier.matcher.cfg.depth
    if counts["dense_attention"] or (dev.type == "cuda" and (
            counts["flash_attention"] < 1 or counts["flash_attention"] % (2 * depth))):
        raise AssertionError(f"the bench-protocol gate's attention: {counts}; expected the flash "
                             f"kernel alone, 2 x {depth} launches a matcher call")
    # what phase 15d's roofline needs: the profiled stage spans and the shapes
    return {"launches": launches, "spans": spans, "keyframes": len(images),
            "hw": images.shape[1:3], "verified": best.verified, "wall_s": best_wall,
            "vpr_input": tuple(pipe.spr.vpr.input_size), "descriptor_dim":
            int(pipe.spr.vpr.descriptor_dim), "top_k": pipe.top_k, "max_keypoints": 1024,
            "match_top_k": pipe.match_top_k, "matcher": pipe.verifier.matcher.cfg,
            "hypotheses": pipe.num_hypotheses}


def reset_launch_counts() -> None:
    from mlis_tpu_torch.ops import attention as att
    from mlis_tpu_torch.ops import flash_attention as fa
    from mlis_tpu_torch.ops import pairwise as pw

    pw.tri_count.launches = 0
    fa.flash_attention.launches = 0
    att.fused_attention.launches = 0


def launch_counts() -> dict:
    from mlis_tpu_torch.ops import attention as att
    from mlis_tpu_torch.ops import flash_attention as fa
    from mlis_tpu_torch.ops import pairwise as pw

    return {"tri_count": pw.tri_count.launches, "flash_attention": fa.flash_attention.launches,
            "dense_attention": att.fused_attention.launches}


def matcher_launches(res, depth: int) -> int:
    """Flash-kernel launches of a gate's bf16 matcher on the card: its self-
    and cross-attention in each of ``depth`` layers, once a verify batch
    (LightGlue and SuperGlue, at every keypoint count)."""
    return 2 * depth * -(-res.verified // VERIFY_BATCH)


def drive_gate_path(phase: str, dev, pipe, inputs, expected_launches, report=None) -> dict:
    """One warm-up and TIMED_REPS timed runs of ``pipe.process`` (every
    launch counter set to 0 before each run and read after it), then one
    profiled run. ``expected_launches(result)`` gives each kernel's count
    a run must show on the card; ``report(result)``, fields of the fastest
    run for the summary line."""
    images, timestamps, floors, K = inputs
    gen = torch.Generator(device=dev).manual_seed(0)
    runs = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for rep in range(TIMED_REPS + 1):
        pipe.spr.vpr.descriptors = []
        if hasattr(pipe.spr.vpr, "patch_cache"):
            pipe.spr.vpr.patch_cache = []
        reset_launch_counts()
        t0 = time.perf_counter()
        res = pipe.process(images, timestamps, floors, K, encode_batch_size=ENCODE_BATCH,
                           generator=gen)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        want = expected_launches(res)
        log(f"{phase} gate {'warmup' if rep == 0 else f'timed{rep}'}", t0,
            candidates=res.total_pairs, floor_rejected=res.cross_floor_rejected,
            survivors=res.verified, accepted=res.geometrically_valid,
            pairs_per_s=f"{res.total_pairs / wall:.1f}", vpr_s=f"{res.vpr_s:.4f}",
            retrieval_s=f"{res.retrieval_s:.4f}", verify_s=f"{res.verify_s:.4f}",
            launches=json.dumps(counts, separators=(",", ":")))
        if res.total_pairs <= 0 or res.verified <= 0 or \
                res.verified != res.total_pairs - res.cross_floor_rejected:
            raise AssertionError(f"{phase}: gate counts inconsistent: {res.summary()}")
        for r in res.results:
            if r.relative_pose is not None and not np.isfinite(r.relative_pose).all():
                raise AssertionError(f"{phase}: non-finite pose for pair {(r.query_idx, r.match_idx)}")
        if dev.type == "cuda" and counts != want:
            raise AssertionError(f"{phase}: kernel launches {counts}, expected {want}")
        if rep:
            runs.append((wall, res, counts))
    best_wall, best, counts = min(runs, key=lambda x: x[0])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        pipe.spr.vpr.descriptors = []
        if hasattr(pipe.spr.vpr, "patch_cache"):
            pipe.spr.vpr.patch_cache = []
        profile_gate(dev, pipe, inputs, gen, best_wall, encode_batch_size=ENCODE_BATCH)
    log(f"{phase} summary", time.perf_counter(),
        pairs_per_s=f"{best.total_pairs / best_wall:.1f}",
        walls=",".join(f"{w:.4f}" for w, _, _ in runs), peak_mem_bytes=peak,
        launches_per_run=json.dumps(counts, separators=(",", ":")),
        **(report(best) if report else {}))
    return counts


def phase_path_a(dev, args) -> dict:
    """The gate at its default VPR method: CricaVPR (vpr_crica.npz, ViT-B/14
    at 322x322, bf16), the shipped half-res LightGlue at 1024 detected / 512
    matched keypoints, on phase 3's keyframes."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.weights import default_matcher_checkpoint

    t0 = time.perf_counter()
    inputs = keyframes(args.keyframes)
    matcher = LightGlue.from_checkpoint(
        default_matcher_checkpoint(), sp_cfg=SuperPointConfig(max_keypoints=1024), device=dev)
    spr = SemanticPlaceRecognition("cricavpr", similarity_threshold=0.3, min_time_gap=10.0,
                                   device=dev)
    pipe = FullGatePipeline(vpr=spr, verifier=GeometricVerifier(matcher=matcher),
                            similarity_threshold=0.3, verify_batch=VERIFY_BATCH, match_top_k=512,
                            matcher_weights=None, num_hypotheses=512, device=dev)
    n = len(inputs[0])
    log("5 setup", t0, keyframes=n, weights="vpr_crica.npz+lightglue_homog_sp.npz",
        vit="dinov2_vitb14 bf16 322x322", encode_batch=ENCODE_BATCH)

    def expected(res):
        return {"tri_count": 0, "flash_attention": matcher_launches(res, matcher.cfg.depth),
                "dense_attention": 12 * -(-n // ENCODE_BATCH)}

    return drive_gate_path("5", dev, pipe, inputs, expected)


def phase_path_b(dev, args) -> dict:
    """The fullres gate with every keypoint matched (bench.py's fullres
    protocol with MLIS_MATCH_TOP_K=0): 540x720 keyframes of 16-pixel cells,
    MixVPR, SuperPoint at 2048 keypoints, the fullres LightGlue, verify
    batches of 256."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue
    from mlis_tpu_torch.models.resnet import ResNetConfig
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.weights import default_fullres_matcher_checkpoint

    t0 = time.perf_counter()
    inputs = keyframes(args.keyframes, 540, 720, cell=16)
    ckpt = default_fullres_matcher_checkpoint()
    matcher = LightGlue.from_checkpoint(ckpt, sp_cfg=SuperPointConfig(max_keypoints=2048),
                                        device=dev)
    spr = SemanticPlaceRecognition("mixvpr", similarity_threshold=0.3, min_time_gap=10.0,
                                   device=dev,
                                   backbone_cfg=ResNetConfig(crop_stage=3, dtype=torch.bfloat16))
    pipe = FullGatePipeline(vpr=spr, verifier=GeometricVerifier(matcher=matcher),
                            similarity_threshold=0.3, verify_batch=VERIFY_BATCH, match_top_k=None,
                            matcher_weights=None, num_hypotheses=512, device=dev)
    depth = matcher.cfg.depth
    log("6 setup", t0, keyframes=len(inputs[0]), resolution="540x720", detect=2048,
        match="all", weights=f"vpr_mixvpr.npz+{ckpt.rsplit('/', 1)[-1]}", cut="none")

    def expected(res):
        return {"tri_count": 0, "dense_attention": 0,
                "flash_attention": matcher_launches(res, depth)}

    return drive_gate_path("6", dev, pipe, inputs, expected)


# path C (phase 8): the gate with the other two encoders of the VPR menu,
# each a DINOv2 ViT-B/14 from a random initialisation, as the JAX gate has it
PATH_C = {"salad": 8448, "anyloc": 64 * 768}  # descriptor widths
PATH_C_CHECK_FRAMES = 4  # keyframes encoded on the card and on the CPU


def check_descriptors(d: torch.Tensor, width: int, what: str) -> None:
    if tuple(d.shape[1:]) != (width,) or not bool(torch.isfinite(d).all()):
        raise AssertionError(f"{what}: descriptors {tuple(d.shape)}, finite "
                             f"{bool(torch.isfinite(d).all())}; expected width {width}")
    norms = torch.linalg.vector_norm(d.float(), dim=1)
    if float((norms - 1).abs().max()) > 1e-4:
        raise AssertionError(f"{what}: descriptor norms {norms.min():.6f}-{norms.max():.6f}")


def phase_path_c(dev, args) -> dict:
    """FullGatePipeline with SALAD (476x644, 1565 tokens) and with AnyLoc
    (518x518, 1370 tokens) at ViT-B/14 width, random weights from
    torch.Generator(0), on phase 3's keyframes with path A's matcher and
    protocol: every block's attention on the flash kernel (12 launches per
    encode batch of 64), none on the dense kernel. Then the first keyframes
    through each encoder on the card and on the CPU, the same weights."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.models.vit import ViTConfig
    from mlis_tpu_torch.weights import default_matcher_checkpoint

    cuda = dev.type == "cuda"
    inputs = keyframes(args.keyframes)
    n = len(inputs[0])
    matcher = LightGlue.from_checkpoint(
        default_matcher_checkpoint(), sp_cfg=SuperPointConfig(max_keypoints=1024), device=dev)
    # the CPU rehearsal cuts the ViT's width and depth; the card runs ViT-B/14
    enc_kw = {} if cuda else {"vit_cfg": ViTConfig.tiny_test()}
    counts = {}
    for method, width in PATH_C.items():
        t0 = time.perf_counter()
        spr = SemanticPlaceRecognition(method, similarity_threshold=0.3, min_time_gap=10.0,
                                       device=dev, seed=0, **enc_kw)
        vpr = spr.vpr
        pipe = FullGatePipeline(vpr=spr, verifier=GeometricVerifier(matcher=matcher),
                                similarity_threshold=0.3, verify_batch=VERIFY_BATCH,
                                match_top_k=512, matcher_weights=None, num_hypotheses=512,
                                device=dev)
        cfg = vpr.module.cfg if method == "anyloc" else vpr.module.backbone.cfg
        h, w = vpr.input_size
        tokens = (h // cfg.patch_size) * (w // cfg.patch_size) + 1
        log(f"8 {method} setup", t0, keyframes=n, weights="random (torch.Generator(0))+"
            "lightglue_homog_sp.npz", vit=f"dim {cfg.dim} depth {cfg.depth} {cfg.dtype}",
            input=f"{h}x{w}", tokens=tokens, descriptor=vpr.descriptor_dim,
            encode_batch=ENCODE_BATCH)
        if cuda and vpr.descriptor_dim != width:
            raise AssertionError(f"8 {method}: descriptor width {vpr.descriptor_dim} != {width}")

        def expected(res, depth=cfg.depth):
            return {"tri_count": 0, "dense_attention": 0,
                    "flash_attention": depth * -(-n // ENCODE_BATCH)
                    + matcher_launches(res, matcher.cfg.depth)}

        counts[method] = drive_gate_path(f"8 {method}", dev, pipe, inputs, expected)
        t0 = time.perf_counter()
        frames = inputs[0][:PATH_C_CHECK_FRAMES]
        got = vpr.encode_batch_device(inputs[0][:ENCODE_BATCH])
        check_descriptors(got, vpr.descriptor_dim, f"8 {method} on {dev.type}")
        fields = {}
        if cuda:
            cpu_vpr = SemanticPlaceRecognition(method, device="cpu", seed=0).vpr
            want = cpu_vpr.encode_batch_device(frames)
            check_descriptors(want, width, f"8 {method} on the cpu")
            cos = (got[:PATH_C_CHECK_FRAMES].cpu() * want).sum(1)
            fields = {"cpu_frames": len(frames), "cosine_min": float(cos.min()),
                      "cpu_encode_s": f"{time.perf_counter() - t0:.3f}"}
            if float(cos.min()) < 0.999:
                raise AssertionError(f"8 {method}: card vs cpu cosine {cos.tolist()} < 0.999")
            del cpu_vpr
        log(f"8 {method} descriptors", t0, width=got.shape[1], finite_unit=True, **fields)
        del pipe, spr, vpr
        if cuda:
            torch.cuda.empty_cache()
    return counts


# path D (phase 9): bench.py fullres with MLIS_MATCH_TOP_K=0 and
# MLIS_MATCHER_ARCH=superglue. superglue_homog.npz is not in the card's copy,
# so SuperPoint and the SuperGlue head are random-initialised, as bench.py
# does without the checkpoint, with flax's distributions from
# torch.Generator(0)
PATH_D_HW = (540, 720)
PATH_D_KEYPOINTS = 2048


def path_d_matcher(dev):
    from mlis_tpu_torch.models.lightglue import SuperGlue
    from mlis_tpu_torch.models.superpoint import SuperPointConfig

    return SuperGlue(sp_cfg=SuperPointConfig(max_keypoints=PATH_D_KEYPOINTS),
                     device=dev).init_random_(0)


def path_d_keypoint_counts(dev, matcher, n: int) -> np.ndarray:
    """Valid keypoints per keyframe of path D's first ``n`` keyframes."""
    from mlis_tpu_torch.ops.image import to_grayscale

    images = keyframes(n, *PATH_D_HW, cell=16)[0]
    counts = []
    for s in range(0, n, 32):
        gray = to_grayscale(torch.as_tensor(images[s : s + 32], device=dev))
        counts.append(matcher.sp.detect(gray).mask.sum(1).cpu())
    return torch.cat(counts).numpy()


def phase_path_d(dev, args) -> dict:
    """The fullres gate with the SuperGlue head: path B's 540x720 keyframes,
    MixVPR and verify batches of 256, SuperPoint at 2048 keypoints all
    matched, the random SuperGlue (depth 9, 20 Sinkhorn iterations in
    float32); its 18 attentions per verify batch on the flash kernel."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.resnet import ResNetConfig

    t0 = time.perf_counter()
    inputs = keyframes(args.keyframes, *PATH_D_HW, cell=16)
    matcher = path_d_matcher(dev)
    counts = path_d_keypoint_counts(dev, matcher, len(inputs[0]))
    spr = SemanticPlaceRecognition("mixvpr", similarity_threshold=0.3, min_time_gap=10.0,
                                   device=dev,
                                   backbone_cfg=ResNetConfig(crop_stage=3, dtype=torch.bfloat16))
    pipe = FullGatePipeline(vpr=spr, verifier=GeometricVerifier(matcher=matcher),
                            similarity_threshold=0.3, verify_batch=VERIFY_BATCH, match_top_k=None,
                            matcher_weights=None, num_hypotheses=512, device=dev)
    depth = matcher.cfg.depth
    log("9 setup", t0, keyframes=len(inputs[0]), resolution="540x720",
        detect=PATH_D_KEYPOINTS, match="all",
        weights="vpr_mixvpr.npz+random SuperPoint/SuperGlue (torch.Generator(0))",
        head=f"sinkhorn {matcher.cfg.sinkhorn_iterations} iterations, depth {depth}",
        kv_len_min=int(counts.min()), kv_len_median=float(np.median(counts)),
        kv_len_max=int(counts.max()),
        frames_below_2048=int((counts < PATH_D_KEYPOINTS).sum()))

    def expected(res):
        return {"tri_count": 0, "dense_attention": 0,
                "flash_attention": matcher_launches(res, depth)}

    return drive_gate_path("9", dev, pipe, inputs, expected)


def phase_card_vs_cpu(dev) -> None:
    t0 = time.perf_counter()
    images, timestamps, floors, K = keyframes(SMALL_KEYFRAMES)
    cpu = torch.device("cpu")
    pipes = {d: build_pipeline(d, torch.float32) for d in {dev, cpu}}
    probe = pipes[cpu].process(images, timestamps, floors, K, verify=False)
    n_surv = probe.total_pairs - probe.cross_floor_rejected
    u = torch.rand((n_surv, 512, 8), generator=torch.Generator().manual_seed(0))
    out = {}
    for d, pipe in pipes.items():
        pipe.spr.vpr.descriptors = []
        out[d] = pipe.process(images, timestamps, floors, K, ransac_uniforms=u)
    a, b = out[dev], out[cpu]
    if (a.total_pairs, a.cross_floor_rejected) != (b.total_pairs, b.cross_floor_rejected):
        raise AssertionError(f"candidates differ: {a.summary()} vs {b.summary()}")
    pa = [(r.query_idx, r.match_idx) for r in a.results]
    pb = [(r.query_idx, r.match_idx) for r in b.results]
    if pa != pb:
        raise AssertionError("survivor pairs differ between the card and the CPU")
    near = 0
    for ra, rb in zip(a.results, b.results):
        if ra.is_valid != rb.is_valid:
            close = any(abs(r.num_inliers - 20) <= 1 or abs(r.inlier_ratio - 0.25) <= 0.01
                        for r in (ra, rb))
            if not close:
                raise AssertionError(f"decision differs away from a threshold: {ra} vs {rb}")
            near += 1
    dev_inl = np.array([r.num_inliers for r in a.results])
    cpu_inl = np.array([r.num_inliers for r in b.results])
    log("4 card vs cpu", t0, keyframes=len(images), candidates=a.total_pairs,
        survivors=len(pa), accepted_card=a.geometrically_valid,
        accepted_cpu=b.geometrically_valid, decisions_differing_near_threshold=near,
        max_inlier_diff=int(np.abs(dev_inl - cpu_inl).max()) if len(pa) else 0)


# -- phase 7: the decision-quality harness ---------------------------------------------

# bench.py quality2's LightGlue row (bench.py:761-790): top-16 retrieval at
# 0.30, verify batches of 256, the parallax-trained encoder and matcher
QUALITY = dict(encoder="trained_vpr_v2", top_k=16, similarity_threshold=0.30,
               verify_batch=VERIFY_BATCH)
QUALITY_SEEDS = (0, 1, 2)
QUALITY_F1_MIN, QUALITY_PRECISION_MIN = 0.75, 0.9  # 3-seed means the phase must reach
QUALITY_SMALL = dict(n_floors=2, n_places=4, hw=(135, 180))  # the card-vs-CPU scene
# the band rule of tests/test_torch_quality.py (eval/quality.py
# decision_drift): float32 models hold the issue's bands, confident matches
# within 1 and inliers within 3 past the confident cut; the shipped bf16
# models move keypoints across the top-k cut, so confident matches within 3
# and inliers reported, not bounded
QUALITY_BANDS = {torch.float32: dict(conf_band=1, inlier_band=3, bound_inliers=True),
                 torch.bfloat16: dict(conf_band=3, inlier_band=3, bound_inliers=False)}
PIXEL_SHARE = 0.99  # renders on two devices: share of pixels within one uint8 level


def check_quality_labels(out: dict, what: str) -> None:
    """No silent fallback to the pixel encoder or the homography matcher."""
    if out["encoder"] != "trained_vpr_v2" or out["weights"] != "lightglue_parallax_sp.npz":
        raise AssertionError(f"{what}: ran encoder {out['encoder']!r} with weights "
                             f"{out['weights']!r}, not trained_vpr_v2 + lightglue_parallax_sp.npz")


def compare_scenes(a, b, what: str) -> float:
    """The renderer's parity rule: metadata exact, pixels within one level."""
    for field in ("floors", "timestamps", "K"):
        x, y = getattr(a, field), getattr(b, field)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: {field} differs")
    if a.gt_pairs != b.gt_pairs or a.aliased_pairs != b.aliased_pairs:
        raise AssertionError(f"{what}: GT or aliased pairs differ")
    if a.images.shape != b.images.shape or a.images.dtype != b.images.dtype:
        raise AssertionError(f"{what}: images {a.images.shape} vs {b.images.shape}")
    diff = np.abs(a.images.astype(np.int16) - b.images.astype(np.int16))
    share = float((diff <= 1).mean())
    if share < PIXEL_SHARE:
        raise AssertionError(f"{what}: only {share:.6f} of pixels within one level")
    return share


def compare_decisions(a: dict, b: dict, bands: dict, what: str) -> dict:
    """The harness's band rule on two runs' pairs: the drift is reported
    before any violation raises."""
    from mlis_tpu_torch.eval.quality import decision_drift

    for key in ("total_candidates", "verified"):
        if a[key] != b[key]:
            raise AssertionError(f"{what}: {key} {a[key]} vs {b[key]}")
    stats, broken = decision_drift(a["pairs"], b["pairs"], **bands)
    print(f"  {what}: " + " ".join(f"{k}={v}" for k, v in stats.items()), flush=True)
    for x, y in broken:
        print(f"  outside the band rule: {x} vs {y}", flush=True)
    if broken:
        raise AssertionError(f"{what}: {len(broken)} pairs break the band rule")
    return stats


# quality2's other matcher rows (bench.py:763-800), in bench.py's order after
# the LightGlue row; dense LoFTR verifies in batches of 32, the rest of 256
MATCHER_ROWS = (("superglue", VERIFY_BATCH), ("orb", VERIFY_BATCH), ("loftr", 32))
# 3-seed means each row must reach (the JAX package's scoreboard on other
# scenes of the distribution: LoFTR 0.868 / 0.943, ORB 0.279 / 1.000)
MATCHER_FLOORS = {"loftr": dict(f1=0.75, precision=0.9), "orb": dict(f1=0.15, precision=0.9)}
# card against CPU on the small scene: decision_drift's bands (the tier-1
# bands of tests/test_torch_quality_matchers.py)
SUPERGLUE_SCORE_ATOL = 2.0**-5
MATCHER_BANDS = {"orb": dict(conf_band=0, inlier_band=9, bound_inliers=False, confident_cut=None),
                 "loftr": dict(conf_band=0, inlier_band=3, bound_inliers=False,
                               confident_cut=None)}


def matcher_row_weights(family: str):
    """(weights path or None, skip reason or None) as bench.py quality2
    chooses them: SuperGlue only when its homography checkpoint is shipped
    (bench.py:765), then the parallax one; LoFTR from loftr_parallax.npz."""
    import os

    from mlis_tpu_torch.weights import (
        default_parallax_loftr_checkpoint,
        default_parallax_superglue_checkpoint,
        default_superglue_checkpoint,
    )

    if family == "superglue":
        if default_superglue_checkpoint() is None:
            return None, "checkpoint not in the card's copy"
        return default_parallax_superglue_checkpoint(), None
    if family == "loftr":
        path = default_parallax_loftr_checkpoint()
        if path is None or os.path.basename(path) != "loftr_parallax.npz":
            raise AssertionError("phase 7: checkpoints/loftr_parallax.npz is missing")
        return path, None
    return None, None


def phase_quality_matchers(dev, scenes) -> dict:
    """quality2's SuperGlue, ORB and LoFTR rows on phase 7's scenes, seeds
    0-2, then one profiled seed-0 call per row; no kernel launches."""
    from mlis_tpu_torch.eval import quality as tq

    cuda = dev.type == "cuda"
    rows = {}
    for fam, vb in MATCHER_ROWS:
        t0 = time.perf_counter()
        weights, skip = matcher_row_weights(fam)
        if skip:
            log(f"7 {fam} row", t0, skipped=json.dumps(skip))
            rows[f"{fam}_skipped"] = skip
            continue
        kw = dict(QUALITY, verify_batch=vb, weights_path=weights, device=dev)
        reset_launch_counts()
        runs, calls = {}, {}
        for seed in QUALITY_SEEDS:
            t0 = time.perf_counter()
            out = runs[seed] = tq.run_gate_quality(fam, scene=scenes[seed], **kw)
            calls[seed] = time.perf_counter() - t0
            log(f"7 {fam} seed {seed}", t0, weights=out["weights"], f1=out["f1"],
                precision=out["precision"], recall=out["recall"],
                candidates=out["total_candidates"], verified=out["verified"],
                accepted=out["geometrically_valid"], gate_s=f"{out['elapsed_s']:.4f}",
                harness_call_s=f"{calls[seed]:.4f}")
        counts = launch_counts()
        # SuperGlue's attention layers are LightGlue's: the flash kernel on the card
        if any(n for k, n in counts.items() if not (fam == "superglue" and k == "flash_attention")):
            raise AssertionError(f"phase 7: the {fam} row launched a kernel: {counts}")
        if cuda:
            profile_run(dev, lambda: tq.run_gate_quality(fam, scene=scenes[0], **kw), calls[0])
        f1s = [runs[s]["f1"] for s in QUALITY_SEEDS]
        precs = [runs[s]["precision"] for s in QUALITY_SEEDS]
        row = {f"f1_{fam}": round(float(np.mean(f1s)), 3),
               f"f1_{fam}_min": round(float(np.min(f1s)), 3),
               f"precision_{fam}": round(float(np.mean(precs)), 3),
               f"recall_{fam}": round(float(np.mean([runs[s]["recall"] for s in QUALITY_SEEDS])),
                                      3)}
        rows.update(row)
        log(f"7 {fam} row", t0, weights=runs[0]["weights"], mean_f1=float(np.mean(f1s)),
            mean_precision=float(np.mean(precs)), row=json.dumps(row, separators=(",", ":")),
            harness_s=",".join(f"{calls[s]:.4f}" for s in QUALITY_SEEDS),
            launches=json.dumps(counts, separators=(",", ":")))
        floor = MATCHER_FLOORS.get(fam)
        if cuda and floor and (np.mean(f1s) < floor["f1"] or
                               np.mean(precs) < floor["precision"]):
            raise AssertionError(f"phase 7: {fam} mean F1 {np.mean(f1s)} (needs {floor['f1']}), "
                                 f"mean precision {np.mean(precs)} (needs {floor['precision']})")
    return rows


def phase_matchers_card_vs_cpu(dev, scene) -> None:
    """The new matchers on a few pairs of phase 7's seed-0 scene, on the
    card and on the CPU: ORB's front end (coordinates and validity equal,
    descriptor bits at least 99% equal) and its Hamming matching on the
    same words (equal); LoFTR (loftr_parallax.npz, bf16): at least 98% of
    each pair's matched coarse cells shared; SuperGlue (random weights from
    torch.Generator(0), 512 keypoints, bf16) on the same keypoints: match
    counts within the bf16 band, max(3, 5%), and scores within 2^-5 (the
    tier-1 band of the bf16 head, tests/test_torch_superglue.py)."""
    from mlis_tpu_torch.models import orb
    from mlis_tpu_torch.models.lightglue import SuperGlue, extract_matches
    from mlis_tpu_torch.models.loftr import LoFTR, LoFTRConfig
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.ops.image import to_grayscale

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    pairs = sorted(scene.gt_pairs)[:4]
    q, m = (np.asarray([p[i] for p in pairs]) for i in (0, 1))
    gray = to_grayscale(torch.as_tensor(scene.images[np.concatenate([q, m])]))  # (8, H, W, 1)
    fields = {}
    # ORB
    out = {d: orb.orb_detect_describe(gray[..., 0].to(d)) for d in (dev, cpu)}
    (c_d, w_d, v_d), (c_c, w_c, v_c) = ([x.cpu() for x in out[d]] for d in (dev, cpu))
    if not (torch.equal(c_d, c_c) and torch.equal(v_d, v_c)):
        raise AssertionError("7 matchers: ORB keypoints differ between the card and the CPU")
    bits = (((w_d ^ w_c)[v_c][:, :, None] >> torch.arange(32)) & 1).float().mean()
    fields["orb_bits_equal"] = 1.0 - float(bits)
    if fields["orb_bits_equal"] < 0.99:
        raise AssertionError(f"7 matchers: ORB descriptor bits equal {fields['orb_bits_equal']}")
    n = len(pairs)
    for p in range(n):
        got = orb.hamming_mutual_match(w_c[p].to(dev), v_c[p].to(dev), w_c[n + p].to(dev),
                                       v_c[n + p].to(dev))
        want = orb.hamming_mutual_match(w_c[p], v_c[p], w_c[n + p], v_c[n + p])
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
            raise AssertionError("7 matchers: Hamming matching differs on the same words")
    fields["orb_keypoints"] = int(v_c.sum())
    # LoFTR
    from mlis_tpu_torch.weights import default_parallax_loftr_checkpoint

    shares = []
    res = {}
    for d in (dev, cpu):
        lf = LoFTR(LoFTRConfig(match_threshold=0.05), device=d)
        lf.load_weights(default_parallax_loftr_checkpoint())
        res[d] = [x.cpu() for x in lf.match_batch(gray[:n].to(d), gray[n:].to(d))]
    for p in range(n):
        cells = [{tuple(x) for x in res[d][0][p][res[d][3][p]].round().tolist()} for d in (dev, cpu)]
        shares.append(len(cells[0] & cells[1]) / max(len(cells[0]), len(cells[1]), 1))
    fields["loftr_cells_shared_min"] = min(shares)
    fields["loftr_matches"] = ",".join(str(int(res[d][3].sum())) for d in (dev, cpu))
    if min(shares) < 0.98:
        raise AssertionError(f"7 matchers: LoFTR matched cells shared {shares}")
    # SuperGlue, random weights at 512 keypoints: the same keypoints (detected
    # on the CPU) through the matcher on both devices
    sgs = {d: SuperGlue(sp_cfg=SuperPointConfig(max_keypoints=512), device=d).init_random_(0)
           for d in (dev, cpu)}
    kps = [sgs[cpu].sp.detect(gray[:n]), sgs[cpu].sp.detect(gray[n:])]
    scores, counts, mutual = {}, {}, {}
    for d, sg in sgs.items():
        k0, k1 = (kp.map(lambda x: x.to(d)) for kp in kps)
        sc = sg.net(k0.descriptors, k0.coords, k0.mask, k1.descriptors, k1.coords, k1.mask,
                    tuple(gray.shape[1:3]))
        scores[d] = sc.float().cpu()
        counts[d] = extract_matches(sc, k0.mask, k1.mask, sg.cfg.match_threshold).valid.sum(1).cpu()
        mutual[d] = extract_matches(sc, k0.mask, k1.mask, 0.0).valid.sum(1).cpu()
    diff = (counts[dev] - counts[cpu]).abs()
    band = torch.clamp(0.05 * counts[cpu].float(), min=3.0)
    score_err = float((scores[dev] - scores[cpu]).abs().max())
    fields.update(superglue_matches=",".join(f"{int(a)}/{int(b)}" for a, b in
                                             zip(counts[dev], counts[cpu])),
                  superglue_mutual_unthresholded=",".join(f"{int(a)}/{int(b)}" for a, b in
                                                          zip(mutual[dev], mutual[cpu])),
                  superglue_score_max_abs_err=score_err,
                  superglue_score_max=float(scores[cpu].max()))
    if bool((diff.float() > band).any()) or score_err > SUPERGLUE_SCORE_ATOL:
        raise AssertionError(f"7 matchers: SuperGlue card vs cpu: {fields}")
    log("7 matchers card vs cpu", t0, pairs=n, **fields)


def phase_quality(dev) -> dict:
    """bench.py quality2 on v2 scenes drawn on the device: the LightGlue
    row for 3 seeds, the no-floor-gate ablation, every encoder's retrieval
    row and the CricaVPR rerank rows on seed 0, and the 3-seed retrieval
    recall of SALAD, AnyLoc and the pixel encoder. Returns the launch
    counts of the CricaVPR rows (the dense kernel's)."""
    from mlis_tpu_torch.eval import quality as tq
    from mlis_tpu_torch.train.pretrain_vpr import (
        load_crica_tiny_vpr,
        load_crica_vpr,
        load_encoder,
        load_mixvpr_vpr,
    )
    from mlis_tpu_torch.weights import default_parallax_matcher_checkpoint

    t0 = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    # the CPU rehearsal cuts the scene's scale, never its shapes
    size = dict(n_floors=4, n_places=32, hw=(270, 360)) if cuda else QUALITY_SMALL
    weights = default_parallax_matcher_checkpoint()
    torch.manual_seed(0)  # RANSAC's draws come from the global generator on the device

    def scene(seed):
        tr = time.perf_counter()
        sc = tq.make_quality_scene_v2(generator=torch.Generator(device=dev).manual_seed(seed),
                                      device=dev, **size)
        return sc, time.perf_counter() - tr

    def gate(sc, **kw):
        out = tq.run_gate_quality("trained", scene=sc, weights_path=weights, device=dev,
                                  **{**QUALITY, **kw})
        check_quality_labels(out, "phase 7")
        return out

    scenes = {}
    scenes[0], render_s = scene(0)
    sc0 = scenes[0]
    if sc0.images.shape != (2 * size["n_floors"] * size["n_places"], *size["hw"]) or \
            len(sc0.gt_pairs) != size["n_floors"] * size["n_places"]:
        raise AssertionError(f"phase 7: scene of shape {sc0.images.shape}, "
                             f"{len(sc0.gt_pairs)} GT pairs")
    log("7 setup", t0, scene=f"{size['n_floors']}x{size['n_places']}x2", hw=size["hw"],
        first_render_s=f"{render_s:.4f}", weights=weights.rsplit("/", 1)[-1],
        protocol=json.dumps(QUALITY, separators=(",", ":")))
    gate(sc0)  # warm-up: cuDNN, cuBLAS and allocator set-up stay out of the timed runs

    reset_launch_counts()  # counts from here on are the harness's
    runs, calls = {}, {}
    for seed in QUALITY_SEEDS:
        t0 = time.perf_counter()
        if seed not in scenes:
            scenes[seed], render_s = scene(seed)
        tc = time.perf_counter()
        out = runs[seed] = gate(scenes[seed])
        calls[seed] = time.perf_counter() - tc
        log(f"7 seed {seed}", t0, f1=out["f1"], precision=out["precision"],
            recall=out["recall"], retrieval_recall=out["retrieval_recall"],
            candidates=out["total_candidates"], verified=out["verified"],
            accepted=out["geometrically_valid"], gate_s=f"{out['elapsed_s']:.4f}",
            pairs_per_s=f"{out['total_candidates'] / out['elapsed_s']:.1f}",
            render_s=f"{render_s:.4f}", harness_call_s=f"{calls[seed]:.4f}")
    if cuda:
        # the whole harness call (verifier and encoder set-up, the gate, the
        # retrieval-recall encode) for seed 0 under the profiler
        profile_run(dev, lambda: gate(sc0), calls[0])
    matcher_rows = phase_quality_matchers(dev, scenes)
    phase_matchers_card_vs_cpu(dev, sc0)
    t0 = time.perf_counter()
    no_gate = gate(sc0, floor_gate=False)
    log("7 no floor gate, seed 0", t0, f1=no_gate["f1"], precision=no_gate["precision"],
        recall=no_gate["recall"], candidates=no_gate["total_candidates"],
        verified=no_gate["verified"], accepted=no_gate["geometrically_valid"],
        gate_s=f"{no_gate['elapsed_s']:.4f}")
    counts = launch_counts()  # the LightGlue gates since the matcher rows: its attention alone
    if counts["tri_count"] or counts["dense_attention"] or (cuda and counts["flash_attention"] < 1):
        raise AssertionError(f"phase 7: the gates launched {counts}; expected the flash kernel alone")
    reset_launch_counts()
    t0 = time.perf_counter()
    # bench.py quality2's retrieval rows (bench.py:811-850) on seed 0; the
    # encoders the reference builds with use_pallas=False launch no kernel
    enc_loaders = {
        "trained_vpr_v2": lambda: load_encoder("checkpoints/vpr_tiny_v2.npz", device=dev),
        "trained_vpr": lambda: load_encoder(device=dev),
        "mixvpr_trained": lambda: getattr(load_mixvpr_vpr(device=dev), "encode_batch_device",
                                          None),
        "salad": lambda: load_encoder(arch="salad", device=dev),
        "anyloc": lambda: load_encoder(arch="anyloc", device=dev),
    }
    encs = {"pixel": tq._pixel_encoder, **{name: f() for name, f in enc_loaders.items()}}
    missing = [name for name, e in encs.items() if e is None]
    if missing:
        raise AssertionError(f"phase 7: no checkpoint for the {missing} rows")
    rr = {name: tq.retrieval_metrics(sc0, e, top_k=QUALITY["top_k"],
                                     threshold=QUALITY["similarity_threshold"], device=dev)
          for name, e in encs.items()}
    log("7 retrieval, seed 0", t0, **{f"{name}": json.dumps(m, separators=(",", ":"))
                                      for name, m in rr.items()})
    # the 3-seed means the phase holds SALAD and AnyLoc to, against the pixel encoder
    t0 = time.perf_counter()
    rr_seeds = {name: [rr[name]["retrieval_recall"]] + [
        tq.retrieval_metrics(scenes[seed], encs[name], top_k=QUALITY["top_k"],
                             threshold=QUALITY["similarity_threshold"],
                             device=dev)["retrieval_recall"] for seed in QUALITY_SEEDS[1:]]
        for name in ("pixel", "salad", "anyloc")}
    rr_means = {name: float(np.mean(v)) for name, v in rr_seeds.items()}
    counts = launch_counts()
    log("7 retrieval, 3 seeds", t0, **{f"rr_{name}": ",".join(f"{x:.4f}" for x in v)
                                       for name, v in rr_seeds.items()},
        means=json.dumps(rr_means, separators=(",", ":")),
        launches=json.dumps(counts, separators=(",", ":")))
    if any(counts.values()):
        raise AssertionError(f"phase 7: a plain-attention encoder launched a kernel: {counts} "
                             "(the reference builds these ViTs with use_pallas=False)")

    # the CricaVPR rows (bench.py:851-886): the ViT-B/14 at 322 px and the
    # tiny ViT under the CricaVPR class run the dense kernel, as the
    # reference's use_pallas=None does on the TPU
    reset_launch_counts()
    t0 = time.perf_counter()
    crica, crica_tiny = load_crica_vpr(device=dev), load_crica_tiny_vpr(device=dev)
    if crica is None or crica_tiny is None:
        raise AssertionError("phase 7: checkpoints/vpr_crica.npz or vpr_tiny_v2.npz is missing")
    crica_rows = {}
    for name, vpr in (("cricavpr", crica), ("crica_tiny", crica_tiny)):
        for rerank in (False, True):
            m = tq.retrieval_metrics(sc0, vpr, top_k=QUALITY["top_k"],
                                     threshold=QUALITY["similarity_threshold"], rerank=rerank,
                                     device=dev)
            tag = name + ("_rerank" if rerank else "")
            crica_rows[f"rr_{tag}"] = round(m["retrieval_recall"], 3)
            crica_rows[f"aliased_rate_{tag}"] = round(m["aliased_rate"], 3)
    crica_counts = launch_counts()
    if cuda and (crica_counts["dense_attention"] < 1 or crica_counts["flash_attention"]
                 or crica_counts["tri_count"]):
        raise AssertionError(f"phase 7: the CricaVPR retrieval rows launched {crica_counts}; "
                             "expected the dense kernel alone")
    for rerank in (False, True):
        out = tq.run_gate_quality_rerank(sc0, rerank=rerank, crica=crica,
                                         top_k=QUALITY["top_k"],
                                         similarity_threshold=QUALITY["similarity_threshold"],
                                         weights_path=weights, device=dev)
        crica_rows[f"f1_crica_rerank_{'on' if rerank else 'off'}"] = round(out["f1"], 3)
        log(f"7 crica rerank {'on' if rerank else 'off'}, seed 0", t0, f1=out["f1"],
            precision=out["precision"], recall=out["recall"],
            candidates=out["total_candidates"], floor_rejected=out["cross_floor_rejected"],
            verified=out["verified"], weights=out["weights"], encoder=out["encoder"])
    crica_counts = launch_counts()  # the rerank gates add their matcher's flash launches
    log("7 crica rows, seed 0", t0, launches=json.dumps(crica_counts, separators=(",", ":")))
    if cuda and (crica_counts["dense_attention"] < 1 or crica_counts["flash_attention"] < 1
                 or crica_counts["tri_count"]):
        raise AssertionError(f"phase 7: the CricaVPR rows launched {crica_counts}; expected the "
                             "dense kernel in the encoders and the flash kernel in the matcher")

    f1s = [runs[s]["f1"] for s in QUALITY_SEEDS]
    precs = [runs[s]["precision"] for s in QUALITY_SEEDS]
    rows = {
        "f1_trained": round(float(np.mean(f1s)), 3),
        "f1_trained_min": round(float(np.min(f1s)), 3),
        "precision_trained": round(float(np.mean(precs)), 3),
        "recall_trained": round(float(np.mean([runs[s]["recall"] for s in QUALITY_SEEDS])), 3),
        "f1_no_floor_gate": round(no_gate["f1"], 3),
        "precision_no_floor_gate": round(no_gate["precision"], 3),
        **matcher_rows,
        **{f"rr_{name}": round(m["retrieval_recall"], 3) for name, m in rr.items()},
        **crica_rows,
    }
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log("7 quality2", time.perf_counter(), rows=json.dumps(rows, separators=(",", ":")),
        mean_f1=float(np.mean(f1s)), mean_precision=float(np.mean(precs)),
        rr_3seed_means=json.dumps(rr_means, separators=(",", ":")), peak_mem_bytes=peak)
    if cuda and (np.mean(f1s) < QUALITY_F1_MIN or np.mean(precs) < QUALITY_PRECISION_MIN):
        raise AssertionError(f"phase 7: mean F1 {np.mean(f1s)} (needs {QUALITY_F1_MIN}), mean "
                             f"precision {np.mean(precs)} (needs {QUALITY_PRECISION_MIN})")
    if cuda and no_gate["f1"] >= runs[0]["f1"]:
        raise AssertionError(f"phase 7: F1 without the floor gate {no_gate['f1']} is not below "
                             f"the gated {runs[0]['f1']}")
    if cuda and min(rr_means["salad"], rr_means["anyloc"]) <= rr_means["pixel"]:
        raise AssertionError(f"phase 7: 3-seed retrieval recall {rr_means}: SALAD and AnyLoc "
                             "must stay above the pixel encoder")
    return crica_counts


def phase_quality_card_vs_cpu(dev) -> None:
    """One torch draw of a small v2 scene rendered on the card and on the
    CPU, then the harness on both with the same RANSAC draws, with float32
    and with the shipped bf16 models."""
    from mlis_tpu_torch.eval import quality as tq
    from mlis_tpu_torch.gating.full_gate import _gate_compact
    from mlis_tpu_torch.weights import default_parallax_matcher_checkpoint

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    draws = tq.draw_quality_scene_v2(seed=0, device=cpu, **QUALITY_SMALL)
    scenes = {d: tq.render_quality_scene_v2(draws.to(d), **QUALITY_SMALL) for d in {dev, cpu}}
    share = compare_scenes(scenes[dev], scenes[cpu], "phase 7 renders, card vs cpu")
    sc = scenes[cpu]
    # RANSAC's draws, one block per survivor of the gate's own retrieval
    enc, _ = tq._encoder_for(QUALITY["encoder"], cpu)
    _, _, (total, rejected) = _gate_compact(
        enc(torch.as_tensor(sc.images)), torch.as_tensor(sc.timestamps.astype(np.float32)),
        torch.as_tensor(sc.floors.astype(np.int64)), k=QUALITY["top_k"],
        threshold=QUALITY["similarity_threshold"], min_time_gap=10.0, strict=True)
    u = torch.rand((total - rejected, 512, 8), generator=torch.Generator().manual_seed(0))
    kw = dict(QUALITY, max_keypoints=128, verify_batch=64, return_pairs=True, scene=sc,
              weights_path=default_parallax_matcher_checkpoint(), ransac_uniforms=u)
    fields = {}
    for dtype, bands in QUALITY_BANDS.items():
        name = str(dtype).removeprefix("torch.")
        out = {d: tq.run_gate_quality("trained", model_dtype=dtype, device=d, **kw)
               for d in {dev, cpu}}
        for o in out.values():
            check_quality_labels(o, "phase 7 card vs cpu")
        drift = compare_decisions(out[dev], out[cpu], bands, f"phase 7 harness {name}, card vs cpu")
        fields.update({f"{name}_accepted_card": out[dev]["geometrically_valid"],
                       f"{name}_accepted_cpu": out[cpu]["geometrically_valid"],
                       **{f"{name}_{k}": v for k, v in drift.items()}})
    # quality2's ORB and LoFTR rows (bf16 LoFTR, as shipped), the same draws
    for fam, vb in MATCHER_ROWS[1:]:
        weights, _ = matcher_row_weights(fam)
        fam_kw = dict(kw, verify_batch=vb, weights_path=weights)
        out = {d: tq.run_gate_quality(fam, device=d, **fam_kw) for d in {dev, cpu}}
        drift = compare_decisions(out[dev], out[cpu], MATCHER_BANDS[fam],
                                  f"phase 7 {fam} row, card vs cpu")
        fields.update({f"{fam}_accepted_card": out[dev]["geometrically_valid"],
                       f"{fam}_accepted_cpu": out[cpu]["geometrically_valid"],
                       **{f"{fam}_{k}": v for k, v in drift.items()}})
    log("7 card vs cpu", t0, pixels_within_one_level=share,
        pixels_equal=float((scenes[dev].images == scenes[cpu].images).mean()),
        candidates=total, verified=total - rejected, **fields)


# -- phase 10: the floor-labelling path ----------------------------------------

IMU_RATE, IMU_SAMPLES = 200.0, 240_000  # 1,200 s at 200 Hz (mlis_tpu/core/dataset.py:67)
LIDAR_RATE, LIDAR_SCANS = 10.0, 3_000  # 5 minutes at 10 Hz (dataset.py:68)
OS128_RINGS, OS128_COLUMNS = 128, 1024  # LeGO-LOAM's N_SCAN x Horizon_SCAN for an OS-128
OS128_FOV_DEG = 45.0  # vertical, centred on the horizon
GROUND_RINGS = 30
FLOOR_HEIGHT_M = 3.5  # dataset.py:71
START_FLOOR = 5
# four elevator rides (start as a share of the LiDAR stream, seconds, direction):
# 5 -> 4 -> 5 -> 4 -> 5, with make_demo_data's magnitudes (down -0.8, up +0.7 m/s^2)
RIDES = ((0.20, 4.0, -1), (0.43, 5.0, +1), (0.66, 6.0, -1), (0.89, 4.5, +1))
RIDE_ACCEL = {-1: -0.8, +1: 0.7}
SENSOR_HEIGHT_M = 1.5  # above the floor it stands on
EDGE_SLACK_S = 0.5  # a detected ride edge within this of the planted one
LIDAR_SETTLE_S = 1.0  # smoothing window (10 scans) after a ride's end
LIDAR_CPU_SCANS = 8
LIDAR_COUNT_SHARE = 1e-3  # card vs CPU inlier counts, share of a scan's ground points
LIDAR_HEIGHT_ATOL = 1e-4
GATE_PAIRS = 4096
SEQUENCE_POSES = (("5th_floor", 8035), ("1st_floor", 2793), ("4th_floor", 2836),
                  ("2nd_floor", 5499))  # 19,163 poses in the ratio of the published lengths
STREAM_FRAMES = STREAM_CAPACITY = STREAM_DIM = 4096  # measure_compute_rate's defaults
STREAM_BATCH = 16
STREAM_CPU_FRAMES = 512


def ride_windows(scans: int):
    """(start s, end s, direction) of each planted ride."""
    span = scans / LIDAR_RATE
    return [(share * span, share * span + dur, d) for share, dur, d in RIDES]


def simulated_floor(t: np.ndarray, rides) -> np.ndarray:
    """Floor at time t (float64): rides done by then, linear inside a ride."""
    f = np.full(t.shape, float(START_FLOOR))
    for a, b, d in rides:
        f += d * np.clip((t - a) / (b - a), 0.0, 1.0)
    return f


def imu_stream(dev, gen, rides):
    """make_demo_data's noise model at IMU_SAMPLES, with the planted rides."""
    t = np.arange(IMU_SAMPLES) / IMU_RATE
    tt = torch.as_tensor(t, device=dev)
    ax, ay = (0.1 * torch.randn(IMU_SAMPLES, generator=gen, device=dev) for _ in range(2))
    az = 9.81 + 0.1 * torch.randn(IMU_SAMPLES, generator=gen, device=dev)
    for a, b, d in rides:
        az[(tt >= a) & (tt <= b)] += RIDE_ACCEL[d]
    gyro = 0.01 * torch.randn(IMU_SAMPLES, 3, generator=gen, device=dev)
    return t, ax, ay, az, gyro


def lidar_bag(dev, gen, scans: int, rides):
    """(points (S, P, 3) float32, ring ids (P,) int16, scan times) of an
    OS-128 (45 deg vertical field, rings in rows of 1024 columns): rings
    below GROUND_RINGS see the ground plane (5% of their returns furniture
    0.3-1.2 m above it, 2 cm noise), the others walls 8 m away. The ground
    lies SENSOR_HEIGHT_M below the sensor on the lower floor of the
    traversal and FLOOR_HEIGHT_M further on the upper one, moving linearly
    during a ride (the frame the tracker's heights are measured in)."""
    P = OS128_RINGS * OS128_COLUMNS
    times = np.arange(scans) / LIDAR_RATE
    level = simulated_floor(times, rides) - (START_FLOOR - 1)
    heights = torch.as_tensor(SENSOR_HEIGHT_M + FLOOR_HEIGHT_M * level, device=dev,
                              dtype=torch.float32)
    ring = torch.arange(OS128_RINGS, device=dev).repeat_interleave(OS128_COLUMNS)
    elev = torch.deg2rad(-OS128_FOV_DEG / 2 + OS128_FOV_DEG * ring / (OS128_RINGS - 1))
    az = 2 * torch.pi * torch.arange(OS128_COLUMNS, device=dev).repeat(OS128_RINGS) / OS128_COLUMNS
    ground = ring < GROUND_RINGS
    cos_a, sin_a, tan_e = az.cos(), az.sin(), elev.tan()
    points = torch.empty((scans, P, 3), dtype=torch.float32, device=dev)
    for s in range(0, scans, 100):
        h = heights[s : s + 100, None]
        B = h.shape[0]
        rho = torch.where(ground, h / (-tan_e).clamp(min=1e-3), torch.full_like(h, 8.0))
        z = torch.where(ground, -h, 8.0 * tan_e) + 0.02 * torch.randn(B, P, generator=gen, device=dev)
        clutter = ground & (torch.rand(B, P, generator=gen, device=dev) < 0.05)
        z = torch.where(clutter, z + 0.3 + 0.9 * torch.rand(B, P, generator=gen, device=dev), z)
        points[s : s + B, :, 0] = rho * cos_a
        points[s : s + B, :, 1] = rho * sin_a
        points[s : s + B, :, 2] = z
    return points, ring.to(torch.int16), times


def loop_positions(gen, dev, n: int, lap_poses: int = 300) -> np.ndarray:
    """An 8 x 5 m loop walked once every lap_poses poses, with 5 cm noise:
    every floor revisits the same xy area, as per-floor visual SLAM runs do."""
    s = 2 * np.pi * np.arange(n) / lap_poses
    pos = np.column_stack([8 * np.cos(s), 5 * np.sin(s), 0.1 * np.sin(3 * s)])
    return pos + 0.05 * torch.randn(n, 3, generator=gen, device=dev, dtype=torch.float64).cpu().numpy()


def part_begin(dev) -> tuple:
    """(start time, bytes allocated at the start) of a part of phase 10."""
    reset_launch_counts()
    base = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    sync(dev)
    return time.perf_counter(), base


def part_end(dev, phase: str, start: tuple, expected: dict, rate=None, **fields) -> dict:
    """Log a part: seconds to a synchronize, its rate (``rate`` = (work
    done, name)), peak memory (and above what the part started with) and
    launches; on the card any launch count other than ``expected`` fails
    the phase."""
    sync(dev)
    t0, base = start
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if rate:
        fields[rate[1]] = f"{rate[0] / seconds:.1f}"
    log(phase, t0, **fields, peak_mem_bytes=peak, peak_above_start_bytes=peak - base,
        launches=json.dumps(counts, separators=(",", ":")))
    want = {"tri_count": 0, "flash_attention": 0, "dense_attention": 0, **expected}
    if dev.type == "cuda" and counts != want:
        raise AssertionError(f"{phase}: kernel launches {counts}, expected {want}")
    return {"seconds": seconds, **counts}


def check_events(events, rides, what: str) -> None:
    if [e.floor_change for e in events] != [d for _, _, d in rides]:
        raise AssertionError(f"{what}: events {[(e.start_time, e.direction) for e in events]}, "
                             f"planted {rides}")
    for e, (a, b, _) in zip(events, rides):
        if abs(e.start_time - a) > EDGE_SLACK_S or abs(e.end_time - b) > EDGE_SLACK_S:
            raise AssertionError(f"{what}: ride {(a, b)} detected at {(e.start_time, e.end_time)}")


def compare_labels(a: np.ndarray, b: np.ndarray, pose_t, bounds, slack: float, what: str) -> int:
    """Labels equal except for poses within ``slack`` of a boundary;
    returns how many poses were excused."""
    near = np.abs(pose_t[:, None] - np.asarray(bounds)[None, :]).min(1) <= slack
    bad = np.nonzero((a != b) & ~near)[0]
    if len(bad):
        raise AssertionError(f"{what}: {len(bad)} labels differ, first at pose {bad[0]}: "
                             f"{a[bad[0]]} vs {b[bad[0]]}")
    return int(near.sum())


def phase_floor_labelling(dev, args) -> dict:
    """Phase 10: IMU -> elevator events -> labels, LiDAR -> ground planes ->
    floors, their fusion, the semantic-gating pipeline with the exact
    sweep (one K1 launch per analyze), SemanticIntegration over TUM files,
    and the StreamingGate; every input drawn on the device from
    torch.Generator(0)."""
    import tempfile

    from mlis_tpu_torch.core.trajectory import Trajectory, save_tum
    from mlis_tpu_torch.gating import integration
    from mlis_tpu_torch.gating.floor_detector import IMUFloorDetector
    from mlis_tpu_torch.gating.fusion import MultiModalFloorDetector
    from mlis_tpu_torch.gating.lidar_floor_tracker import (
        LiDARFloorTracker,
        fit_plane_ransac_batch,
    )
    from mlis_tpu_torch.gating.pipeline import SemanticGatingPipeline
    from mlis_tpu_torch.gating.streaming import StreamingGate, measure_compute_rate
    from mlis_tpu_torch.ops.pairwise import candidate_counts_host, candidate_pairs_host

    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(0)
    rides = ride_windows(args.scans)
    bounds = [x for a, b, _ in rides for x in (a, b)]
    pose_t = np.linspace(0.0, (IMU_SAMPLES - 1) / IMU_RATE, SWEEP_POSES)
    want_labels = np.where(
        np.any([(pose_t >= a) & (pose_t <= b) for a, b, _ in rides], axis=0), 0,
        np.round(simulated_floor(pose_t, rides))).astype(np.int32)
    k1 = 0

    # -- IMU: events and per-pose labels
    t, ax, ay, az, gyro = imu_stream(dev, gen, rides)
    det = IMUFloorDetector(device=dev)
    det.detect_elevator_events(t[:4000], ax[:4000], ay[:4000], az[:4000])  # warm-up
    part = part_begin(dev)
    events = det.detect_elevator_events(t, ax, ay, az)
    labels = det.assign_floor_labels(pose_t, start_floor=START_FLOOR)
    imu = part_end(dev, "10 imu", part, {}, (IMU_SAMPLES, "samples_per_s"), samples=IMU_SAMPLES,
                   poses=SWEEP_POSES, events=len(events),
                   directions=",".join(e.direction for e in events))
    check_events(events, rides, "IMU")
    excused = compare_labels(labels, want_labels, pose_t, bounds, EDGE_SLACK_S, "IMU vs planted")
    cpu_det = IMUFloorDetector(device=cpu)
    cpu_events = cpu_det.detect_elevator_events(t, ax.cpu(), ay.cpu(), az.cpu())
    if [e.direction for e in cpu_events] != [e.direction for e in events] or any(
            abs(a.start_idx - b.start_idx) > 1 or abs(a.end_idx - b.end_idx) > 1
            for a, b in zip(events, cpu_events)):
        raise AssertionError(f"IMU card vs CPU: {events} vs {cpu_events}")
    cpu_labels = cpu_det.assign_floor_labels(pose_t, start_floor=START_FLOOR)
    edges = [x for e in events + cpu_events for x in (e.start_time, e.end_time)]
    compare_labels(labels, cpu_labels, pose_t, edges, 1.0 / IMU_RATE, "IMU card vs CPU")
    print(f"  imu events {[(round(e.start_time, 3), round(e.end_time, 3), e.direction) for e in events]}"
          f" labels_vs_planted_excused={excused} cpu_index_shift="
          f"{max(abs(a.start_idx - b.start_idx) + abs(a.end_idx - b.end_idx) for a, b in zip(events, cpu_events))}",
          flush=True)

    # -- LiDAR: ground planes and floors over the bag
    points, ring, scan_t = lidar_bag(dev, gen, args.scans, rides)
    rings = ring.expand(points.shape[0], -1)
    LiDARFloorTracker(device=dev).process_scans(points[:16], scan_t[:16], rings[:16])  # warm-up
    tracker = LiDARFloorTracker(device=dev)
    part = part_begin(dev)
    ests = tracker.process_scans(points, scan_t, rings)
    lidar = part_end(dev, "10 lidar", part, {}, (args.scans, "scans_per_s"), scans=args.scans,
                     points_per_scan=points.shape[1], hypotheses=tracker.ransac_iterations,
                     threshold_m=tracker.ransac_threshold, points_bytes=points.numel() * 4)
    floors = np.array([e.floor_number for e in ests])
    sim = np.round(simulated_floor(scan_t, rides)).astype(int) - START_FLOOR
    settling = np.any([(scan_t >= a) & (scan_t <= b + LIDAR_SETTLE_S) for a, b, _ in rides], axis=0)
    wrong = np.nonzero((floors != sim) & ~settling)[0]
    if len(wrong) or len(tracker.floor_history) != args.scans:
        raise AssertionError(f"LiDAR floors: {len(wrong)} scans off the simulated floor "
                             f"(first {wrong[:5]}), {len(tracker.floor_history)} recorded")
    transitions = tracker.detect_floor_transitions()
    if [(a, b) for _, a, b in transitions] != [(0, -1), (-1, 0), (0, -1), (-1, 0)] or any(
            not (a <= tt <= b + LIDAR_SETTLE_S) for (tt, _, _), (a, b, _) in zip(transitions, rides)):
        raise AssertionError(f"LiDAR transitions {transitions}, rides {rides}")
    # 8 scans on the card and on the CPU with the same draws
    pick = torch.as_tensor(np.linspace(0, args.scans - 1, LIDAR_CPU_SCANS).astype(np.int64),
                           device=dev)
    sub, rsub = points[pick], rings[pick]
    gsub = rsub < GROUND_RINGS
    u = torch.rand((LIDAR_CPU_SCANS, tracker.ransac_iterations, 3), generator=gen, device=dev)
    fit = {d: fit_plane_ransac_batch(sub.to(d), gsub.to(d), uniforms=u.to(d)) for d in (dev, cpu)}
    n_ground = gsub.sum(1).cpu().double()
    count_diff = ((fit[dev][1].cpu().double() - fit[cpu][1].double()) * n_ground).abs()
    height = {d: torch.where(fit[d][0][:, 2] < 0, -fit[d][0][:, 3], fit[d][0][:, 3]).cpu()
              for d in fit}
    height_diff = float((height[dev] - height[cpu]).abs().max())
    floors8 = {d: [e.floor_number for e in LiDARFloorTracker(device=d).process_scans(
        sub.to(d), scan_t[pick.cpu().numpy()], rsub.to(d), uniforms=u.to(d))]
        for d in (dev, cpu)}
    if (count_diff > LIDAR_COUNT_SHARE * n_ground).any() or height_diff > LIDAR_HEIGHT_ATOL \
            or floors8[dev] != floors8[cpu]:
        raise AssertionError(f"LiDAR card vs CPU: counts {count_diff.tolist()}, heights "
                             f"{height_diff}, floors {floors8}")
    print(f"  lidar transitions {[(round(tt, 1), a, b) for tt, a, b in transitions]} "
          f"card_vs_cpu inlier_count_diff_max={int(count_diff.max())} "
          f"height_diff_max_m={height_diff:.3g} floors_equal=True", flush=True)
    del points, rings, sub

    # -- fusion of the two
    part = part_begin(dev)
    fusion = MultiModalFloorDetector(floor_height=FLOOR_HEIGHT_M, device=dev)
    fusion.imu_detector, fusion.lidar_tracker = det, tracker
    fused = fusion.fuse_estimates(pose_t, start_floor=START_FLOOR)
    agreement = fusion.agreement(pose_t, start_floor=START_FLOOR)
    fuse = part_end(dev, "10 fusion", part, {}, (len(pose_t), "poses_per_s"), poses=len(pose_t),
                    agreement=agreement["agreement"])
    if not np.array_equal(fused, labels) or not agreement["lidar_available"]:
        raise AssertionError("fusion: the IMU labels must win")

    # -- the semantic-gating pipeline: IMU labels -> exact sweep -> gate -> report
    positions = loop_positions(gen, dev, SWEEP_POSES)
    trajectory = np.column_stack([pose_t, positions, np.tile([0.0, 0, 0, 1], (SWEEP_POSES, 1))])
    imu_table = torch.stack([torch.as_tensor(t, device=dev), ax.double(), ay.double(), az.double(),
                             *gyro.double().unbind(1)], 1).cpu().numpy()
    out_dir = tempfile.mkdtemp(prefix="mlis_phase10_")
    part = part_begin(dev)
    pipe = SemanticGatingPipeline(output_dir=out_dir, device=dev)
    pipe.trajectory, pipe.imu_data = trajectory, imu_table
    p_events, p_labels = pipe.detect_floors(start_floor=START_FLOOR)
    analysis, _ = integration.analyze(positions, p_labels, RADIUS, MIN_GAP, device=dev)
    pipe.create_loop_closure_gate()
    qi, mi, dist = candidate_pairs_host(positions[:3000], p_labels[:3000], RADIUS, MIN_GAP)
    cands = list(zip(qi[:GATE_PAIRS].tolist(), mi[:GATE_PAIRS].tolist(),
                     (1.0 / (1.0 + dist[:GATE_PAIRS])).tolist()))
    valid, rejected = pipe.gate_candidates(cands)
    report = pipe.generate_report()
    gating = part_end(dev, "10 gating", part, {"tri_count": 1}, poses=SWEEP_POSES,
                      total=analysis.total_candidates, same_floor=analysis.same_floor_candidates,
                      cross_floor=analysis.cross_floor_candidates,
                      sweep_s=f"{analysis.elapsed_s:.4f}", gated=len(cands),
                      accepted=len(valid), rejected=len(rejected))
    k1 += gating["tri_count"]
    host = candidate_counts_host(positions, p_labels, RADIUS, MIN_GAP)
    same_host = int(sum(p_labels[q] == p_labels[m] for q, m, _ in cands))
    stats = pipe.loop_gate.get_stats()
    if not np.array_equal(p_labels, labels) or len(p_events) != len(RIDES):
        raise AssertionError("pipeline: detect_floors disagrees with the IMU part")
    if (analysis.total_candidates, analysis.same_floor_candidates,
            analysis.cross_floor_candidates) != host or host[2] == 0:
        raise AssertionError(f"pipeline sweep {analysis} vs float64 host {host}")
    if (stats["total_candidates"], stats["accepted"]) != (len(cands), same_host) or \
            len(cands) != GATE_PAIRS or len(rejected) == 0:
        raise AssertionError(f"pipeline gate {stats} vs host {same_host} of {len(cands)}")
    if "Elevator events: 4" not in report or not os.path.exists(
            os.path.join(out_dir, "semantic_gating_report.txt")):
        raise AssertionError("pipeline report missing")

    # -- SemanticIntegration over four floor sequences written as TUM files
    root = os.path.join(out_dir, "trajectories")
    os.makedirs(os.path.join(root, "orb_slam3"))
    t_start = 1.7e9
    for name, n in SEQUENCE_POSES:
        save_tum(Trajectory(t_start + np.arange(n) / 20.0, loop_positions(gen, dev, n),
                            np.tile([0.0, 0, 0, 1], (n, 1))),
                 os.path.join(root, "orb_slam3", f"{name}.txt"))
        t_start += n / 20.0 + 60.0
    part = part_begin(dev)
    integ = integration.ORBSlam3SemanticIntegration(root, output_dir=out_dir, device=dev)
    text = integ.run_full_analysis()
    results = integration.run_comparison(root, out_dir, algorithms=["orb_slam3"], device=dev)
    a = integ.last_analysis
    integ_part = part_end(dev, "10 integration", part, {"tri_count": 2}, poses=len(integ.combined),
                          total=a.total_candidates, same_floor=a.same_floor_candidates,
                          cross_floor=a.cross_floor_candidates,
                          cross_rate=f"{a.cross_floor_rate:.4f}", sweep_s=f"{a.elapsed_s:.4f}")
    k1 += integ_part["tri_count"]
    host = candidate_counts_host(integ.combined[:, 1:4], integ.floor_labels, RADIUS, MIN_GAP)
    r = results["orb_slam3"]
    if len(integ.combined) != SWEEP_POSES or \
            (a.total_candidates, a.same_floor_candidates, a.cross_floor_candidates) != host or \
            (r.total_candidates, r.same_floor_candidates, r.cross_floor_candidates) != host:
        raise AssertionError(f"integration counts {a} / {r} vs float64 host {host}")
    for f in ("orb_slam3_semantic_analysis.txt", "semantic_gating_comparison.txt"):
        if not os.path.exists(os.path.join(out_dir, f)):
            raise AssertionError(f"integration: {f} not written")
    if f"Total candidates detected: {host[0]}" not in text:
        raise AssertionError("integration report lacks the counts")

    # -- StreamingGate: the stream CLI's revisits and traps at D 4096
    n, D = STREAM_FRAMES, STREAM_DIM
    desc = torch.randn(n, D, generator=gen, device=dev)
    s_floors = torch.randint(1, 6, (n,), generator=gen, device=dev).to(torch.int32).cpu().numpy()
    qs = np.arange(24, n, 8)
    qt = torch.as_tensor(qs, device=dev)
    desc[qt] = desc[qt - 20] + 0.01 * torch.randn(len(qs), D, generator=gen, device=dev)
    traps = [(int(q), int(q - 20)) for q in qs if q % 16 == 0]
    revisits = [(int(q), int(q - 20)) for q in qs if q % 16]
    for q, m in traps:
        s_floors[q] = s_floors[m] % 5 + 1 if s_floors[m] != 5 else 2
    for q, m in revisits:
        s_floors[q] = s_floors[m]
    s_times = np.arange(n, dtype=np.float32) * 2.0
    kw = dict(capacity=STREAM_CAPACITY, top_k=5, similarity_threshold=0.9, min_time_gap=10.0)
    warm = StreamingGate(device=dev, **kw)
    warm.add_keyframes(desc[:STREAM_BATCH], s_times[:STREAM_BATCH], s_floors[:STREAM_BATCH])
    part = part_begin(dev)
    sg = StreamingGate(device=dev, **kw)
    outs = [sg.add_keyframes(desc[s : s + STREAM_BATCH], s_times[s : s + STREAM_BATCH],
                             s_floors[s : s + STREAM_BATCH]) for s in range(0, n, STREAM_BATCH)]
    part_end(dev, "10 streaming", part, {}, (n, "keyframes_per_s"), frames=n, dim=D,
             capacity=STREAM_CAPACITY, micro_batch=STREAM_BATCH,
             stats=json.dumps(sg.stats, separators=(",", ":")))
    pairs = {p[:2] for o in outs for p in o.pairs()}
    if pairs != set(revisits) or sg.stats["rejected_cross_floor"] < len(traps):
        raise AssertionError(f"streaming: {len(pairs)} pairs, {len(set(revisits) - pairs)} "
                             f"revisits missed, {len(pairs & set(traps))} traps accepted")
    cpu_sg = StreamingGate(device=cpu, **kw)
    desc_cpu = desc[:STREAM_CPU_FRAMES].cpu()
    for i, s in enumerate(range(0, STREAM_CPU_FRAMES, STREAM_BATCH)):
        o = cpu_sg.add_keyframes(desc_cpu[s : s + STREAM_BATCH], s_times[s : s + STREAM_BATCH],
                                 s_floors[s : s + STREAM_BATCH])
        if not np.array_equal(o.match_ids, outs[i].match_ids) or \
                o.cross_floor_rejected != outs[i].cross_floor_rejected:
            raise AssertionError(f"streaming card vs CPU: batch {i} differs")
    part = part_begin(dev)
    rate = measure_compute_rate(device=dev)
    part_end(dev, "10 streaming compute-only", part, {}, frames=STREAM_FRAMES,
             keyframes_per_s=f"{rate['keyframes_per_s']:.1f}",
             ms_per_keyframe=f"{rate['ms_per_keyframe']:.4f}", best_of=3)
    shutil.rmtree(out_dir)
    log("10 floor labelling", time.perf_counter(), K1_launches=k1, revisits=len(revisits),
        traps=len(traps), imu_s=f"{imu['seconds']:.4f}", lidar_s=f"{lidar['seconds']:.4f}",
        fusion_s=f"{fuse['seconds']:.4f}", stream_cpu_frames_equal=STREAM_CPU_FRAMES)
    return {"launches": k1}


# -- phase 11: the back end and evaluation ----------------------------------------

# run_pgo_real's LeGO-LOAM scale (mlis_tpu/opt/scale.py:1-27): 2,406 poses over
# the four floor files, split by the floors' path lengths (187 / 65 / 66 / 128 m,
# mlis_tpu/eval/comprehensive.py:49), at 10 Hz
LEGO_FLOORS = (("5th_floor", 5, 1009, 187.0), ("1st_floor", 1, 351, 65.0),
               ("4th_floor", 4, 356, 66.0), ("2nd_floor", 2, 690, 128.0))
LEGO_RATE_HZ = 10.0
# each floor walks its own corridor loop again and again from the elevator
# corner (0, 0), shifted up to 2 m: same-floor revisits on every floor,
# cross-floor aliases where the loops overlap
LEGO_LOOPS_M = ((20.0, 10.0), (10.0, 6.0), (10.0, 6.0), (16.0, 8.0))
LEGO_SHIFTS_M = ((0.0, 0.0), (1.0, 1.0), (2.0, 0.0), (0.0, 2.0))
LEGO_Z_DRIFT_M = 0.25  # the published z collapses to a drift near 0
LEGO_XY_NOISE_M = 0.05
REFERENCE_COUNTS = (87044, 21477, 65567)  # the published LeGO-LOAM run (scale.py:4-6)
ORB_SCALE = 1.3  # orb_slam3's copy: rescaled, rotated, shifted, with a planted error
ORB_ERROR_M = 0.1  # +-0.1 m on z, alternating pose by pose: rmse 0.1 m after alignment
ORB_ATE_RTOL = 0.02
DEMO_CHECK = (3, 32)  # (num_iters, cg_iters) of the demo's card-vs-CPU check
# card vs CPU after DEMO_CHECK's solves, m: the aliased closures (ungated, and
# GNC's 30 rounds over them) leave CG at 32 iterations far from converged, and
# there the JAX package and the port on one CPU already part by 0.069 / 0.125 m
DEMO_POSE_ATOL = {"odometry": 0.01, "gated": 0.01, "sc": 0.01, "pcm": 0.01,
                  "ungated": 0.25, "gnc": 0.25}
DECISION_BAND = 0.1  # a switch or weight this close to the 0.5 cut may flip with rounding
REAL_CHECK = (1, 32)  # of the LeGO-scale Gauss-Newton step's checks
REAL_STEP_RTOL = 0.01  # card vs CPU, a share of the step's largest move
GRAPH_ATOL = 1e-4  # m, the CUDA graph's step against the eager step


def lego_traversal(seed: int = 0):
    """[(sequence, floor, Trajectory)] of a synthetic LeGO-LOAM-size
    traversal: each floor walks its corridor loop (LEGO_LOOPS_M, shifted by
    LEGO_SHIFTS_M) from the elevator corner for the floor's path length;
    z drifts within +-0.25 m of 0 (the published geometry collapses the
    floors), 5 cm of xy noise, yaw along the corridor."""
    from mlis_tpu_torch.core.trajectory import Trajectory

    rng = np.random.default_rng(seed)
    out, t0 = [], 1.7e9
    for (name, floor, n, length), (W, H), shift in zip(LEGO_FLOORS, LEGO_LOOPS_M, LEGO_SHIFTS_M):
        s = np.mod(np.linspace(0, length, n), 2 * (W + H))
        side = np.searchsorted([W, W + H, 2 * W + H], s, side="right")
        u = s - np.asarray([0.0, W, W + H, 2 * W + H])[side]
        x = np.choose(side, [u, np.full_like(u, W), W - u, np.zeros_like(u)])
        y = np.choose(side, [np.zeros_like(u), u, np.full_like(u, H), H - u])
        yaw = np.asarray([0.0, 0.5, 1.0, 1.5])[side] * np.pi
        phase = 2 * np.pi * rng.uniform(1, 3) * np.linspace(0, 1, n) + rng.uniform(0, 2 * np.pi)
        pos = np.column_stack([x + shift[0], y + shift[1], LEGO_Z_DRIFT_M * np.sin(phase)])
        pos[:, :2] += rng.normal(0, LEGO_XY_NOISE_M, (n, 2))
        yaw = yaw + rng.normal(0, 0.01, n)
        quat = np.column_stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)])
        out.append((name, floor, Trajectory(t0 + np.arange(n) / LEGO_RATE_HZ, pos, quat)))
        t0 += n / LEGO_RATE_HZ + 30.0
    return out


def orb_copy(seqs, seed: int = 1):
    """orb_slam3's run of the same traversal on the same clock: each floor
    scaled by ORB_SCALE, rotated and shifted, with +-ORB_ERROR_M on z
    alternating pose by pose (zero mean, uncorrelated with the path, so no
    alignment absorbs it)."""
    from mlis_tpu_torch.core.trajectory import Trajectory

    rng = np.random.default_rng(seed)
    out = []
    for name, floor, tr in seqs:
        a = rng.uniform(0, 2 * np.pi)
        R = np.asarray([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        err = np.zeros_like(tr.positions)
        err[:, 2] = ORB_ERROR_M * (1 - 2 * (np.arange(len(tr)) % 2))
        pos = ORB_SCALE * (tr.positions + err) @ R.T + rng.uniform(-5, 5, 3)
        out.append((name, floor, Trajectory(tr.timestamps.copy(), pos, tr.quaternions.copy())))
    return out


def write_tree(root: str, algorithm: str, seqs) -> None:
    from mlis_tpu_torch.core.trajectory import save_tum

    os.makedirs(os.path.join(root, algorithm), exist_ok=True)
    for name, _, tr in seqs:
        save_tum(tr, os.path.join(root, algorithm, f"{name}.txt"))


def cg_step_profile(dev, R0, t0, factors, reps: int = 3) -> dict:
    """One CG step of a Gauss-Newton step of ``factors`` on the card, eager
    and replayed from the CUDA graph: its device operations and device time
    (torch.profiler, a step of 3 CG iterations less one of 2) and its wall
    seconds (the best of ``reps`` Gauss-Newton steps of ``hi`` CG iterations
    less the best of ``lo``, so the vjp, the capture and the SVD cancel
    out); then the graph's device time with the padded edges left on pose 0,
    as build_factors makes them (the solvers spread them over the poses)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mlis_tpu_torch.opt import pose_graph

    def step(cg: int, graph: bool):
        return pose_graph.optimize_pose_graph(R0, t0, factors, num_iters=1, cg_iters=cg,
                                              cuda_graph=graph)

    def device_step(graph: bool):
        runs = []
        for cg in (2, 3):
            step(cg, graph)
            sync(dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step(cg, graph)
                sync(dev)
            by_name: dict = {}
            for e in prof.profiler.kineto_results.events():
                if e.device_type() == DeviceType.CUDA:
                    by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns() / 1e3
                    by_name["#"] = by_name.get("#", 0) + 1
            runs.append(by_name)
        diff = {k: runs[1].get(k, 0) - runs[0].get(k, 0) for k in runs[1]}
        return int(diff.pop("#")), diff

    def wall(cg: int, graph: bool) -> float:
        best = float("inf")
        for _ in range(reps):
            sync(dev)
            t = time.perf_counter()
            step(cg, graph)
            sync(dev)
            best = min(best, time.perf_counter() - t)
        return best

    out = {}
    for graph, (lo, hi) in ((False, (4, 20)), (True, (16, 80))):
        key = "graph" if graph else "eager"
        ops, by_kernel = device_step(graph)
        out[f"{key}_ops_per_cg_step"] = ops
        out[f"{key}_device_us_per_cg_step"] = sum(by_kernel.values())
        out[f"{key}_s_per_cg_step"] = (wall(hi, graph) - wall(lo, graph)) / (hi - lo)
        if graph:
            for name, us in sorted(by_kernel.items(), key=lambda x: -x[1])[:8]:
                print(f"  cg step kernel {us:.1f}us {name[:110]}", flush=True)
    spread_inputs = pose_graph._inputs

    def pads_on_pose_0(R0, t0, f):
        R, t, g = spread_inputs(R0, t0, f)
        return R, t, g._replace(edge_i=f.edge_i, edge_j=f.edge_j)

    pose_graph._inputs = pads_on_pose_0
    try:
        out["graph_device_us_per_cg_step_pads_on_pose_0"] = sum(device_step(True)[1].values())
    finally:
        pose_graph._inputs = spread_inputs
    return out


def check_demo_contract(o: dict) -> None:
    """The JAX package's demo contract (tests/test_pose_graph.py:151-190,
    254-266; tests/test_pcm.py:84-90)."""
    g, odo, ung = o["gated_ate_rmse"], o["odometry_ate_rmse"], o["ungated_ate_rmse"]
    checks = {
        "gate_correct": o["gate_correct"],
        "gated < 0.6 odometry": g < 0.6 * odo,
        "ungated > 2 odometry": ung > 2.0 * odo,
        "ungated > 5 gated": ung > 5.0 * g,
        "pcm_false_removed == 1": o["pcm_false_removed"] == 1.0,
        "pcm_true_kept == 1": o["pcm_true_kept"] == 1.0,
        "pcm <= 1.1 gated": o["pcm_ate_rmse"] <= 1.1 * g,
    }
    for v in ("sc", "gnc"):
        checks[f"{v}_false_disabled == 1"] = o[f"{v}_false_disabled"] == 1.0
        checks[f"{v}_true_kept >= 0.9"] = o[f"{v}_true_kept"] >= 0.9
        checks[f"{v} < 1.5 gated"] = o[f"{v}_ate_rmse"] < 1.5 * g
        checks[f"{v} < 0.25 ungated"] = o[f"{v}_ate_rmse"] < 0.25 * ung
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"pgo demo contract: {failed} in {o}")


def demo_solves(prob, device, num_iters: int, cg_iters: int) -> dict:
    """The demo's six solves on ``device`` from the same host inputs:
    (translations, closure switches or GNC weights) per variant, and PCM's
    keep mask."""
    from mlis_tpu_torch.opt import demo
    from mlis_tpu_torch.opt.pose_graph import optimize_pose_graph, optimize_pose_graph_gnc

    dev = torch.device(device)
    R0 = torch.as_tensor(prob["init_R"], device=dev)
    t0 = torch.as_tensor(prob["init_t"], device=dev)
    A, n_odo = len(prob["pairs"]), len(prob["odo_edges"])
    pcm_keep = demo.demo_pcm_keep(prob, dev)
    out = {"pcm_keep": pcm_keep}
    for name, mask, robust in (("odometry", np.zeros(A, bool), False),
                               ("gated", prob["accept"], False), ("ungated", np.ones(A, bool), False),
                               ("sc", np.ones(A, bool), True), ("gnc", np.ones(A, bool), True),
                               ("pcm", pcm_keep, False)):
        f, keep = demo.demo_factors(prob, mask, robust, True, dev)
        if name == "gnc":
            _, t, _, w = optimize_pose_graph_gnc(R0, t0, f, inner_iters=2, cg_iters=cg_iters)
        else:
            _, t, _, w = optimize_pose_graph(R0, t0, f, num_iters=num_iters, cg_iters=cg_iters)
        out[name] = (t.cpu().numpy(), w.cpu().numpy()[n_odo : n_odo + len(keep)])
    return out


def phase_backend(dev, args) -> dict:
    """Phase 11: the pose-graph back end and host evaluation. (a) the pgo
    CLI at the demo's defaults against the JAX package's contract, then the
    six solves on the card and the CPU from the same inputs; (b)
    run_pgo_real at LeGO-LOAM's size on a synthetic traversal, K1's counts
    against the host pairs', launches and seconds per CG step, one
    Gauss-Newton step eager against the CUDA graph and the card against
    the CPU; (c) run_full_evaluation, the summary artifacts, and the gate
    and evaluate CLIs over the TUM files."""
    import io
    import tempfile

    from mlis_tpu_torch import cli
    from mlis_tpu_torch.eval import comprehensive, report
    from mlis_tpu_torch.ops.pairwise import candidate_counts, candidate_counts_host
    from mlis_tpu_torch.opt import demo, scale
    from mlis_tpu_torch.opt.pose_graph import optimize_pose_graph

    cpu = torch.device("cpu")
    rehearsal = dev.type != "cuda"
    k1 = 0

    # -- (a) the pgo CLI at the demo's defaults (20 x 256, six solves)
    part = part_begin(dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if rehearsal:  # the CPU takes ~25 ms a CG step: the CLI's plumbing at a reduced depth
            with patched(demo, "run_pgo_demo", num_iters=args.demo_iters[0],
                         cg_iters=args.demo_iters[1]):
                rc = cli.main(["pgo", "--seed", "0", "--device", "cpu"])
        else:
            rc = cli.main(["pgo", "--seed", "0"])
    o = json.loads(buf.getvalue())
    part_end(dev, "11a pgo cli", part, {}, rc=rc, **{k: o[k] for k in (
        "n_poses", "n_candidates", "gate_accepted", "gate_rejected", "ate_init",
        "odometry_ate_rmse", "gated_ate_rmse", "ungated_ate_rmse", "sc_ate_rmse", "gnc_ate_rmse",
        "pcm_ate_rmse", "sc_false_disabled", "sc_true_kept", "gnc_false_disabled",
        "gnc_true_kept", "pcm_false_removed", "pcm_true_kept")})
    if rc != 0:
        raise AssertionError(f"pgo CLI exited {rc}")
    if not rehearsal:
        check_demo_contract(o)
    # the six solves at DEMO_CHECK on the card and on the CPU from one set of inputs
    prob = demo.demo_problem(0, 2, cpu)
    ni, cg = DEMO_CHECK
    runs = {d: demo_solves(prob, d, ni, cg) for d in (dev, cpu)}
    worst, excused = {}, {}
    for name in ("odometry", "gated", "ungated", "sc", "gnc", "pcm"):
        (t_a, w_a), (t_b, w_b) = runs[dev][name], runs[cpu][name]
        worst[name] = float(np.abs(t_a - t_b).max())
        near = (np.abs(w_a - 0.5) < DECISION_BAND) | (np.abs(w_b - 0.5) < DECISION_BAND)
        excused[name] = int(near.sum())
        if not np.array_equal((w_a < 0.5)[~near], (w_b < 0.5)[~near]):
            raise AssertionError(f"demo {name}: card and CPU decide differently: {w_a} vs {w_b}")
    if not np.array_equal(runs[dev]["pcm_keep"], runs[cpu]["pcm_keep"]):
        raise AssertionError("demo PCM: card and CPU keep different closures")
    if not rehearsal:  # the CG step at the demo's scale: the SC graph, 256 edges
        f_sc, _ = demo.demo_factors(prob, np.ones(len(prob["pairs"]), bool), True, True, dev)
        prof = cg_step_profile(dev, torch.as_tensor(prob["init_R"], device=dev),
                               torch.as_tensor(prob["init_t"], device=dev), f_sc)
        print("  demo cg step " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                           for k, v in prof.items()), flush=True)
    print(f"  demo card_vs_cpu num_iters={ni} cg_iters={cg} max_pose_diff_m="
          + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}, separators=(",", ":"))
          + " tolerance_m=" + json.dumps(DEMO_POSE_ATOL, separators=(",", ":"))
          + f" decisions_equal=True within_{DECISION_BAND}_of_the_cut="
          + json.dumps(excused, separators=(",", ":")), flush=True)
    bad = {k: v for k, v in worst.items() if v > DEMO_POSE_ATOL[k]}
    if bad:
        raise AssertionError(f"demo card vs CPU: poses differ by {bad} m")

    # -- (b) run_pgo_real at LeGO-LOAM's size on a synthetic traversal
    root = tempfile.mkdtemp(prefix="mlis_phase11_")
    seqs = lego_traversal(0)
    write_tree(root, "lego_loam", seqs)
    part = part_begin(dev)
    real = scale.run_pgo_real(trajectory_root=root, num_iters=args.real_iters[0],
                              cg_iters=args.real_iters[1], device=dev)
    counts = (real["candidates"], real["same_floor"], real["cross_floor"])
    part_end(dev, "11b pgo real", part, {}, poses=real["n_poses"],
             counts=",".join(map(str, counts)),
             reference_counts=",".join(map(str, REFERENCE_COUNTS)),
             cross_share=f"{counts[2] / counts[0]:.4f}", reference_cross_share=f"{REFERENCE_COUNTS[2] / REFERENCE_COUNTS[0]:.4f}",
             num_iters=args.real_iters[0], cg_iters=args.real_iters[1],
             **{f"{v}_{k}": real[f"{v}_{k}"] for v in ("odometry", "gated", "ungated")
                for k in ("ate_rmse", "ate_max", "n_edges", "solve_s")},
             ate_init=real["ate_init"],
             gated_over_odometry=f"{real['gated_ate_rmse'] / real['odometry_ate_rmse']:.4f}",
             jax_slow_test_bound_gated=0.2,
             ungated_over_odometry=f"{real['ungated_ate_rmse'] / real['odometry_ate_rmse']:.4f}",
             jax_slow_test_bound_ungated=2.0)
    _, _, floors, pub = scale.load_real_scene(root)
    part = part_begin(dev)
    k1_counts = candidate_counts(pub, floors, device=dev)
    k1 += part_end(dev, "11b sweep", part, {"tri_count": 1}, counts=",".join(map(str, k1_counts)))[
        "tri_count"]
    if k1_counts != counts:
        raise AssertionError(f"K1 counts {k1_counts} vs the host pairs' {counts}")
    if not rehearsal and not (real["gated_ate_rmse"] < real["odometry_ate_rmse"]
                              < real["ungated_ate_rmse"]):
        raise AssertionError(f"pgo real: gated < odometry < ungated fails: {real}")
    # one Gauss-Newton step of the ungated graph: eager and graph on the card, the CPU
    rprob = scale.real_problem(root, device=cpu)
    f_cpu = scale.real_factors(rprob, True, True, device=cpu)
    R0 = torch.as_tensor(rprob["init_R"].astype(np.float32))
    t0 = torch.as_tensor(rprob["init_t"].astype(np.float32))
    ni, cg = REAL_CHECK
    step = {"cpu": optimize_pose_graph(R0, t0, f_cpu, num_iters=ni, cg_iters=cg)[1]}
    if not rehearsal:
        f_dev = f_cpu.to(dev)
        for graph in (False, True):
            step["graph" if graph else "eager"] = optimize_pose_graph(
                R0.to(dev), t0.to(dev), f_dev, num_iters=ni, cg_iters=cg, cuda_graph=graph)[1].cpu()
        moved = float((step["cpu"] - t0).abs().max())
        d_cpu = float((step["graph"] - step["cpu"]).abs().max())
        d_graph = float((step["graph"] - step["eager"]).abs().max())
        prof = cg_step_profile(dev, R0.to(dev), t0.to(dev), f_dev)
        print(f"  real gn step num_iters={ni} cg_iters={cg} step_max_m={moved:.6g} "
              f"card_vs_cpu_max_m={d_cpu:.3g} (tolerance {REAL_STEP_RTOL} of the step) "
              f"graph_vs_eager_max_m={d_graph:.3g} (tolerance {GRAPH_ATOL}) "
              + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in prof.items()), flush=True)
        if d_cpu > REAL_STEP_RTOL * moved or d_graph > GRAPH_ATOL:
            raise AssertionError(f"real GN step: card vs CPU {d_cpu}, graph vs eager {d_graph}")

    # -- (c) host evaluation over the TUM files, and the gate / evaluate CLIs
    write_tree(root, "orb_slam3", orb_copy(seqs))
    out_dir = os.path.join(root, "out")
    part = part_begin(dev)
    ev = comprehensive.run_full_evaluation(
        root, output_path=os.path.join(out_dir, "final_evaluation.json"),
        algorithms=["lego_loam", "orb_slam3"], verbose=False)
    ates = {f: ev["orb_slam3"][f]["ate_vs_lego"]["rmse"] for f, *_ in LEGO_FLOORS}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["gate", "--trajectory-root", root, "--output", out_dir, "--algorithms",
                       "orb_slam3", "lego_loam", "--device", dev.type])
    gate_json = json.load(open(os.path.join(out_dir, "semantic_gating_metrics.json")))
    tables = comprehensive.summary_tables(ev)
    report.write_table_iv_csv(ev, os.path.join(out_dir, "table_iv.csv"))
    report.write_benchmark_summary(
        ev, {a: gate_json_metrics(gate_json[a]) for a in gate_json},
        os.path.join(out_dir, "BENCHMARK_RESULTS_SUMMARY.md"))
    with contextlib.redirect_stdout(io.StringIO()):
        rc_eval = cli.main(["evaluate", "--trajectory-root", root, "--output",
                            os.path.join(out_dir, "cli")])
    k1 += part_end(dev, "11c evaluation", part, {"tri_count": 2}, gate_rc=rc, evaluate_rc=rc_eval,
                   ate_vs_lego=json.dumps({k: float(f"{v:.6g}") for k, v in ates.items()},
                                          separators=(",", ":")),
                   planted_m=ORB_ERROR_M, rtol=ORB_ATE_RTOL,
                   cross_floor_rates=json.dumps({a: round(gate_json[a]["loop_closure"]
                                                          ["cross_floor_rate"], 6)
                                                 for a in gate_json}, separators=(",", ":")))["tri_count"]
    if rc or rc_eval:
        raise AssertionError(f"gate CLI {rc}, evaluate CLI {rc_eval}")
    bad = {f: a for f, a in ates.items() if abs(a / ORB_ERROR_M - 1) > ORB_ATE_RTOL}
    if bad or any(not ev["orb_slam3"][f]["valid"] for f in ates):
        raise AssertionError(f"evaluation: ate_vs_lego {ates}, planted {ORB_ERROR_M} m")
    for algo in ("orb_slam3", "lego_loam"):
        text = open(os.path.join(out_dir, f"{algo}_semantic_analysis.txt")).read()
        lc = gate_json[algo]["loop_closure"]
        want = candidate_counts_host(*combined_positions(root, algo))
        if (lc["total_candidates"], lc["same_floor_candidates"], lc["cross_floor_candidates"]) \
                != want or f"Cross-floor rate: {lc['cross_floor_rate']:.1%}" not in text:
            raise AssertionError(f"gate CLI {algo}: {lc} vs host {want} and its report")
    if (gate_json["lego_loam"]["loop_closure"]["total_candidates"],
            gate_json["lego_loam"]["loop_closure"]["same_floor_candidates"]) != counts[:2]:
        raise AssertionError("gate CLI lego_loam counts differ from run_pgo_real's")
    cli_eval = json.load(open(os.path.join(out_dir, "cli", "final_evaluation.json")))
    if cli_eval["orb_slam3"]["5th_floor"]["ate_vs_lego"]["rmse"] != ates["5th_floor"]:
        raise AssertionError("evaluate CLI disagrees with run_full_evaluation")
    for f in ("table_iv.csv", "BENCHMARK_RESULTS_SUMMARY.md"):
        if not os.path.getsize(os.path.join(out_dir, f)):
            raise AssertionError(f"{f} is empty")
    if "TABLE 3: ATE vs LeGO-LOAM" not in tables:
        raise AssertionError("summary tables incomplete")
    shutil.rmtree(root)
    log("11 back end", time.perf_counter(), K1_launches=k1)
    return {"launches": k1}


def gate_json_metrics(d: dict):
    """A LoopClosureMetrics from its SemanticEvaluator JSON block."""
    from mlis_tpu_torch.eval.semantic_eval import LoopClosureMetrics

    lc = d["loop_closure"]
    return LoopClosureMetrics(**{k: lc[k] for k in LoopClosureMetrics.__dataclass_fields__})


def combined_positions(root: str, algorithm: str):
    """(positions, floor labels) of an algorithm's four floor files combined."""
    from mlis_tpu_torch.core.dataset import NUFRM3F, TRANSIT_FLOORS
    from mlis_tpu_torch.core.trajectory import combine_sequences

    mat, labels = combine_sequences(NUFRM3F(root, algorithm).load(), TRANSIT_FLOORS)
    return mat[:, 1:4], labels


@contextlib.contextmanager
def patched(module, name: str, **kw):
    """``module.name`` with keyword defaults overridden, for the duration."""
    import functools

    orig = getattr(module, name)
    setattr(module, name, functools.partial(orig, **kw))
    try:
        yield
    finally:
        setattr(module, name, orig)


# -- phase 12: model families and weight import ------------------------------------

LOFTR_VERIFY_BATCH = 32
# the coarse threshold of the random official LoFTR: 0.5x Kaiming weights
# give dual-softmax confidences far below the released model's 0.2, so the
# gate matches at a threshold where matches exist (the JAX package's
# converter tests use 1e-6)
LOFTR_THRESHOLD = 1e-6
LOFTR_WEIGHT_SCALE = 0.5  # x Kaiming, as tests/test_convert.py draws LoFTR
LOFTR_CHECK_PAIRS = 2
LOFTR_BAND = 1e-2  # a selection may differ card vs CPU within this share of the threshold
LOFTR_KPT_ATOL = 5e-3  # px, tests/test_convert.py's band
YOLO_INPUT = (544, 736)
YOLO_BATCH = 64
YOLO_CHECK_FRAMES = 4
YOLO_RAW_RTOL = 1e-4  # card vs CPU raw head maps, a share of the largest magnitude
IMPORT_CHECK_FRAMES = 4
IMPORT_COSINE = 0.999  # card (bf16 kernels) vs CPU (bf16 plain) descriptors
LIGHTGLUE_SCORE_ATOL = 1e-4  # float32 matcher scores, card vs CPU on the same keypoints


def draw_state_dict(shapes: dict, dev, scale: float = 1.0, seed: int = 0) -> dict:
    """An official-layout state dict drawn on ``dev`` from
    torch.Generator(seed): Kaiming-normal weights times ``scale``, norm
    scales and running variances in [0.5, 1.5], means, biases and
    LayerScales 0.1 N(0, 1); every value rounded to float16, so that an npz
    round trip (float16) is exact."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for k, shape in shapes.items():
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            v = torch.randn(shape, generator=gen, device=dev) * ((2.0 / fan_in) ** 0.5 * scale)
        elif k.endswith(("running_var", ".weight")):
            v = 0.5 + torch.rand(shape, generator=gen, device=dev)
        else:
            v = 0.1 * torch.randn(shape, generator=gen, device=dev)
        out[k] = v.half().float()
    return out


def _bn_shapes(prefix: str, c: int) -> dict:
    return {f"{prefix}.{k}": (c,) for k in ("weight", "bias", "running_mean", "running_var")}


def loftr_official_shapes(cfg) -> dict:
    """zju3dv / kornia LoFTR's parameter names and shapes (ResNetFPN_8_2,
    the coarse and fine LocalFeatureTransformers, FinePreprocess)."""
    d0, d1, d2 = cfg.block_dims
    s = {"backbone.conv1.weight": (cfg.initial_dim, 1, 7, 7),
         **_bn_shapes("backbone.bn1", cfg.initial_dim)}
    cin = cfg.initial_dim
    for stage, c in enumerate((d0, d1, d2), 1):
        for b in (0, 1):
            tp = f"backbone.layer{stage}.{b}"
            s[f"{tp}.conv1.weight"] = (c, cin if b == 0 else c, 3, 3)
            s[f"{tp}.conv2.weight"] = (c, c, 3, 3)
            s.update(_bn_shapes(f"{tp}.bn1", c))
            s.update(_bn_shapes(f"{tp}.bn2", c))
            if b == 0 and stage > 1:  # stride 2
                s[f"{tp}.downsample.0.weight"] = (c, cin, 1, 1)
                s.update(_bn_shapes(f"{tp}.downsample.1", c))
        cin = c
    s["backbone.layer3_outconv.weight"] = (d2, d2, 1, 1)
    for n, lo, hi in ((2, d1, d2), (1, d0, d1)):
        s[f"backbone.layer{n}_outconv.weight"] = (hi, lo, 1, 1)
        s[f"backbone.layer{n}_outconv2.0.weight"] = (hi, hi, 3, 3)
        s.update(_bn_shapes(f"backbone.layer{n}_outconv2.1", hi))
        s[f"backbone.layer{n}_outconv2.3.weight"] = (lo, hi, 3, 3)

    def encoder(prefix, d):
        e = {f"{prefix}.{p}.weight": (d, d) for p in ("q_proj", "k_proj", "v_proj", "merge")}
        e[f"{prefix}.mlp.0.weight"] = (2 * d, 2 * d)
        e[f"{prefix}.mlp.2.weight"] = (d, 2 * d)
        e.update({f"{prefix}.norm{i}.{k}": (d,) for i in (1, 2) for k in ("weight", "bias")})
        return e

    for i in range(2 * cfg.depth):
        s.update(encoder(f"loftr_coarse.layers.{i}", cfg.coarse_dim))
    s.update({"fine_preprocess.down_proj.weight": (cfg.fine_dim, cfg.coarse_dim),
              "fine_preprocess.down_proj.bias": (cfg.fine_dim,),
              "fine_preprocess.merge_feat.weight": (cfg.fine_dim, 2 * cfg.fine_dim),
              "fine_preprocess.merge_feat.bias": (cfg.fine_dim,)})
    for i in range(2):
        s.update(encoder(f"loftr_fine.layers.{i}", cfg.fine_dim))
    return s


def dinov2_shapes(cfg) -> dict:
    """facebookresearch/dinov2's ViT names and shapes (the keys
    convert_dinov2_torch reads)."""
    d, hidden = cfg.dim, int(cfg.dim * cfg.mlp_ratio)
    s = {"patch_embed.proj.weight": (d, 3, cfg.patch_size, cfg.patch_size),
         "patch_embed.proj.bias": (d,), "cls_token": (1, 1, d),
         "pos_embed": (1, cfg.pos_grid**2 + 1, d), "norm.weight": (d,), "norm.bias": (d,)}
    for i in range(cfg.depth):
        tp = f"blocks.{i}"
        s.update({f"{tp}.{n}.{k}": (d,) for n in ("norm1", "norm2") for k in ("weight", "bias")})
        for name, o, fan in (("attn.qkv", 3 * d, d), ("attn.proj", d, d), ("mlp.fc1", hidden, d),
                             ("mlp.fc2", d, hidden)):
            s[f"{tp}.{name}.weight"] = (o, fan)
            s[f"{tp}.{name}.bias"] = (o,)
        s[f"{tp}.ls1.gamma"] = (d,)
        s[f"{tp}.ls2.gamma"] = (d,)
    return s


def resnet50_shapes(stage_sizes=(3, 4, 6, 3), width: int = 64) -> dict:
    """torchvision ResNet-50's names and shapes (all four stages; MixVPR's
    converter reads the three it keeps)."""
    s = {"conv1.weight": (width, 3, 7, 7), **_bn_shapes("bn1", width)}
    cin = width
    for stage, n_blocks in enumerate(stage_sizes):
        f = width * 2**stage
        for b in range(n_blocks):
            tp = f"layer{stage + 1}.{b}"
            s.update({f"{tp}.conv1.weight": (f, cin, 1, 1), f"{tp}.conv2.weight": (f, f, 3, 3),
                      f"{tp}.conv3.weight": (4 * f, f, 1, 1)})
            for i, c in ((1, f), (2, f), (3, 4 * f)):
                s.update(_bn_shapes(f"{tp}.bn{i}", c))
            if b == 0:
                s[f"{tp}.downsample.0.weight"] = (4 * f, cin, 1, 1)
                s.update(_bn_shapes(f"{tp}.downsample.1", 4 * f))
            cin = 4 * f
    return s


def superpoint_shapes(channels=(64, 64, 128, 128), descriptor_dim: int = 256) -> dict:
    """magicleap SuperPointNet's names and shapes."""
    s, cin = {}, 1
    for i, c in enumerate(channels, 1):
        for j, suffix in enumerate("ab"):
            s[f"conv{i}{suffix}.weight"] = (c, cin if j == 0 else c, 3, 3)
            s[f"conv{i}{suffix}.bias"] = (c,)
        cin = c
    for name, shape in (("convPa", (256, cin, 3, 3)), ("convPb", (65, 256, 1, 1)),
                        ("convDa", (256, cin, 3, 3)), ("convDb", (descriptor_dim, 256, 1, 1))):
        s[f"{name}.weight"] = shape
        s[f"{name}.bias"] = (shape[0],)
    return s


def lightglue_shapes(cfg) -> dict:
    """cvg/LightGlue's (superpoint variant) names and shapes."""
    d = cfg.dim

    def lin(name, o, i):
        return {f"{name}.weight": (o, i), f"{name}.bias": (o,)}

    s = {"posenc.Wr.weight": (d // cfg.num_heads // 2, 2), **lin("input_proj", d, cfg.descriptor_dim)}
    for i in range(cfg.depth):
        tp = f"transformers.{i}"
        s.update(lin(f"{tp}.self_attn.Wqkv", 3 * d, d))
        s.update(lin(f"{tp}.self_attn.out_proj", d, d))
        for blk in ("self_attn", "cross_attn"):
            s.update(lin(f"{tp}.{blk}.ffn.0", 2 * d, 2 * d))
            s.update({f"{tp}.{blk}.ffn.1.weight": (2 * d,), f"{tp}.{blk}.ffn.1.bias": (2 * d,)})
            s.update(lin(f"{tp}.{blk}.ffn.3", d, 2 * d))
        for name in ("to_qk", "to_v", "to_out"):
            s.update(lin(f"{tp}.cross_attn.{name}", d, d))
        s.update(lin(f"log_assignment.{i}.final_proj", d, d))
        s.update(lin(f"log_assignment.{i}.matchability", 1, d))
    return s


def official_loftr(dev, dtype, sd):
    from mlis_tpu_torch.models.loftr import LoFTR, LoFTRConfig

    m = LoFTR(LoFTRConfig.official_full(dtype=dtype, match_threshold=LOFTR_THRESHOLD), device=dev)
    m.load_torch_state_dict({k: v.to(dev) for k, v in sd.items()})
    return m


def compare_loftr(a, b, what: str) -> dict:
    """Two official matchers' DenseMatches on the same pairs: the valid
    coarse selections equal but where the confidence lies within
    LOFTR_BAND of the threshold on the side that kept it, the refined
    keypoints of the shared selections within LOFTR_KPT_ATOL px."""
    k0a, k1a, sa, va = (x.cpu() for x in a)
    k0b, k1b, sb, vb = (x.cpu() for x in b)
    stats = {"matches": ",".join(f"{int(x)}/{int(y)}" for x, y in zip(va.sum(1), vb.sum(1))),
             "differing": 0, "kpt_max_abs_err": 0.0}
    for p in range(va.shape[0]):
        cells = [{tuple(k.tolist()): (k1, float(sc)) for k, k1, sc in zip(k0[p][v[p]], k1x[p][v[p]],
                                                                          s[p][v[p]])}
                 for k0, k1x, s, v in ((k0a, k1a, sa, va), (k0b, k1b, sb, vb))]
        for c in set(cells[0]) ^ set(cells[1]):
            score = float((cells[0].get(c) or cells[1].get(c))[1])
            stats["differing"] += 1
            if score > LOFTR_THRESHOLD * (1 + LOFTR_BAND):
                raise AssertionError(f"{what}: cell {c} of pair {p} selected on one side only, "
                                     f"score {score} away from the threshold; {stats}")
        for c in set(cells[0]) & set(cells[1]):
            err = float((cells[0][c][0] - cells[1][c][0]).abs().max())
            stats["kpt_max_abs_err"] = max(stats["kpt_max_abs_err"], err)
    if stats["kpt_max_abs_err"] > LOFTR_KPT_ATOL:
        raise AssertionError(f"{what}: refined keypoints differ: {stats}")
    return stats


def phase_official_loftr(dev, args) -> None:
    """12a: the official LoFTR at its released widths (d_model 256, 8 heads,
    depth 4, block dims 128/196/256, fine 128, bf16), random 0.5x Kaiming
    weights from torch.Generator(0) in the official layout through
    load_torch_state_dict, as the matcher of the fullres MixVPR gate
    (path B's 128 keyframes at 540x720, resized to 536x720; verify batches
    of 32); then float32 card vs CPU on 2 pairs and a save_weights /
    load_weights round trip on the card."""
    import tempfile

    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.loftr import LoFTR, LoFTRConfig
    from mlis_tpu_torch.ops.image import to_grayscale

    t0 = time.perf_counter()
    cuda = dev.type == "cuda"
    inputs = keyframes(args.keyframes, 540, 720, cell=16)
    cfg = LoFTRConfig.official_full()
    sd = draw_state_dict(loftr_official_shapes(cfg), dev, scale=LOFTR_WEIGHT_SCALE)
    matcher = official_loftr(dev, torch.bfloat16, sd)
    pipe = FullGatePipeline(vpr_method="mixvpr", verifier=GeometricVerifier(matcher=matcher),
                            similarity_threshold=0.3, min_time_gap=10.0,
                            verify_batch=LOFTR_VERIFY_BATCH, matcher_weights=None,
                            num_hypotheses=512, device=dev)
    log("12a setup", t0, keyframes=len(inputs[0]), resolution="540x720 -> 536x720",
        weights=f"vpr_mixvpr.npz+random official LoFTR ({len(sd)} tensors, "
                f"{sum(v.numel() for v in sd.values())} parameters, torch.Generator(0))",
        loftr=f"d_model {cfg.coarse_dim} heads {cfg.num_heads} depth {cfg.depth} "
              f"blocks {cfg.block_dims} fine {cfg.fine_dim} bf16",
        threshold=LOFTR_THRESHOLD, verify_batch=LOFTR_VERIFY_BATCH)

    def expected(res):
        return {"tri_count": 0, "flash_attention": 0, "dense_attention": 0}

    def report(res):
        n = np.array([r.num_matches for r in res.results])
        return {"matches_per_pair_min": int(n.min()), "matches_per_pair_median": float(np.median(n)),
                "matches_per_pair_max": int(n.max()), "pairs_with_matches": int((n > 0).sum())}

    drive_gate_path("12a", dev, pipe, inputs, expected, report=report)
    del pipe
    # float32 card against CPU, and the npz round trip on the card
    t0 = time.perf_counter()
    images = inputs[0]
    n = LOFTR_CHECK_PAIRS
    q = list(range(n))
    m = [i + max(len(images) // 8, 1) for i in q]  # the same scene on a revisit
    gray = to_grayscale(torch.as_tensor(images[q + m]))  # (2n, 540, 720, 1) on the host
    out = {}
    for d in {dev, torch.device("cpu")}:
        f32 = official_loftr(d, torch.float32, sd)
        out[d.type] = f32.match_batch(gray[:n].to(d), gray[n:].to(d))
        del f32
    stats = compare_loftr(out[dev.type], out["cpu"], "12a card vs cpu") if cuda else {}
    with tempfile.TemporaryDirectory(prefix="mlis_phase12_") as tmp:
        path = os.path.join(tmp, "loftr_official.npz")
        matcher.save_weights(path)
        again = LoFTR(matcher.cfg, device=dev)
        again.load_weights(path)
        size = os.path.getsize(path)
    for (k, a), b in zip(matcher.net.state_dict().items(), again.net.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"12a: {k} changed in the npz round trip")
    a, b = (x.match_batch(gray[:n].to(dev), gray[n:].to(dev)) for x in (matcher, again))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("12a: matches differ after the npz round trip")
    log("12a checks", t0, pairs=n, **stats, round_trip_npz_bytes=size,
        round_trip_matches=int(a.valid.sum()))


def phase_yolo(dev, args) -> None:
    """12b: YOLOv8n (random weights with flax's initialisers from
    torch.Generator(0)) in DynamicObjectFilter on the 128 fullres keyframes
    as BGR, batches of 64 at 544x736; then float32 card vs CPU on 4 frames
    (raw head maps, NMS on the same boxes, the masks of planted boxes)."""
    from mlis_tpu_torch.models import yolo
    from mlis_tpu_torch.ops.image import resize_nhwc

    t0 = time.perf_counter()
    cuda = dev.type == "cuda"
    gray = torch.as_tensor(keyframes(args.keyframes, 540, 720, cell=16)[0], device=dev)
    bgr = gray[..., None].expand(*gray.shape, 3).contiguous()
    det = yolo.YOLODetector(yolo.YOLOConfig.nano(), input_size=YOLO_INPUT, seed=0, device=dev)
    n_params = sum(p.numel() for p in det.net.parameters())
    log("12b setup", t0, frames=len(bgr), resolution="540x720", input=f"{YOLO_INPUT}",
        parameters=n_params, batch=YOLO_BATCH)
    walls = []
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for rep in range(TIMED_REPS + 1):
        filt = yolo.DynamicObjectFilter(det)
        reset_launch_counts()
        t0 = time.perf_counter()
        for s in range(0, len(bgr), YOLO_BATCH):
            masked, mask, d = filt.filter_batch(bgr[s : s + YOLO_BATCH])
        sync(dev)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if cuda and any(counts.values()):
            raise AssertionError(f"12b: kernel launches {counts}")
        if rep:
            walls.append(wall)
        m = filt.get_metrics()
        log(f"12b filter {'warmup' if rep == 0 else f'timed{rep}'}", t0,
            images_per_s=f"{len(bgr) / wall:.1f}", frames=m.total_frames,
            frames_with_dynamic=m.frames_with_dynamic_objects,
            masked_share=f"{m.feature_filter_rate:.4f}", detections_valid=int(d.valid.sum()))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        profile_run(dev, lambda: [yolo.DynamicObjectFilter(det).filter_batch(
            bgr[s : s + YOLO_BATCH]) for s in range(0, len(bgr), YOLO_BATCH)], min(walls))
    log("12b summary", time.perf_counter(), images_per_s=f"{len(bgr) / min(walls):.1f}",
        walls=",".join(f"{w:.4f}" for w in walls), peak_mem_bytes=peak,
        metrics=json.dumps(vars(m), separators=(",", ":")))
    if m.total_frames != len(bgr) or masked.shape != bgr[-YOLO_BATCH:].shape:
        raise AssertionError(f"12b: {m} / {tuple(masked.shape)}")
    # float32 card against CPU
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    nets = {}
    for d in {dev, cpu}:
        nets[d.type] = yolo.YOLODetector(yolo.YOLOConfig.nano(dtype=torch.float32),
                                         input_size=YOLO_INPUT, seed=0, device=d)
    frames = bgr[:YOLO_CHECK_FRAMES].cpu()
    x = resize_nhwc(frames.to(torch.float32).flip(-1) / 255.0, YOLO_INPUT)
    raw = {k: n.net(x.to(n.device)) for k, n in nets.items()}
    raw_err = max(float((a.cpu() - b).abs().max() / b.abs().max())
                  for a, b in zip(raw[dev.type], raw["cpu"]))
    if raw_err > YOLO_RAW_RTOL:
        raise AssertionError(f"12b: raw head maps card vs cpu {raw_err} > {YOLO_RAW_RTOL}")
    boxes, cls_scores = yolo.decode_predictions(raw["cpu"], nets["cpu"].cfg, YOLO_INPUT)
    best, classes = cls_scores.amax(-1), cls_scores.argmax(-1)
    cfg = nets["cpu"].cfg
    keep = {k: [t.cpu() for t in yolo.nms_fixed(boxes.to(d), best.to(d), classes.to(d),
                                                 cfg.score_threshold, cfg.iou_threshold,
                                                 cfg.max_detections)]
            for k, d in (("card", dev), ("cpu", cpu))}
    if not all(torch.equal(a, b) for a, b in zip(keep["card"], keep["cpu"])):
        raise AssertionError("12b: NMS on the same boxes differs between the card and the CPU")
    # planted boxes: every dynamic class and one static (56, chair)
    gen = torch.Generator().manual_seed(0)
    classes_p = torch.tensor(yolo.DYNAMIC_COCO_CLASSES + (56,)).repeat(YOLO_CHECK_FRAMES, 1)
    xy = torch.rand(YOLO_CHECK_FRAMES, classes_p.shape[1], 2, generator=gen) * torch.tensor([600., 440.])
    wh = 20 + torch.rand(YOLO_CHECK_FRAMES, classes_p.shape[1], 2, generator=gen) * 100
    planted = torch.cat([xy, xy + wh], -1)
    valid_p = torch.ones(classes_p.shape, dtype=torch.bool)
    masks = {k: [t.cpu() for t in yolo.mask_dynamic_objects(frames.to(d), planted.to(d),
                                                             classes_p.to(d), valid_p.to(d))]
             for k, d in (("card", dev), ("cpu", cpu))}
    if not all(torch.equal(a, b) for a, b in zip(masks["card"], masks["cpu"])):
        raise AssertionError("12b: mask_dynamic_objects differs between the card and the CPU")
    log("12b card vs cpu", t0, frames=YOLO_CHECK_FRAMES, raw_rel_err=raw_err,
        nms_kept=int(keep["cpu"][3].sum()), planted_boxes=int(valid_p.sum()),
        masked_share=f"{float(masks['cpu'][1].float().mean()):.4f}")


def phase_weight_import(dev, args) -> dict:
    """12c: official-layout state dicts drawn on the card from
    torch.Generator(0) through each loader: DINOv2 ViT-B/14 into CricaVPR
    (phase 3's 128 keyframes through the dense kernel), torchvision
    ResNet-50 into MixVPR, cvg/LightGlue and magicleap SuperPoint into
    LightGlue (then save_weights / load_weights); each against the CPU."""
    import tempfile

    from mlis_tpu_torch.models.cricavpr import CricaVPR
    from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig, extract_matches
    from mlis_tpu_torch.models.mixvpr import MixVPR
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.models.vit import ViTConfig
    from mlis_tpu_torch.ops.image import to_grayscale

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    images = keyframes(args.keyframes)[0]
    n = len(images)
    launches = {}
    # the CPU rehearsal cuts the ViT's width and depth; the card runs ViT-B/14
    vit = ViTConfig.dinov2_vitb14() if cuda else ViTConfig.tiny_test()
    encoders = (("cricavpr", 10752, dinov2_shapes(vit),
                 lambda d: CricaVPR(checkpoint=None, vit_cfg=vit, device=d)),
                ("mixvpr", 4096, resnet50_shapes(), lambda d: MixVPR(device=d)))
    for name, width, shapes, build in encoders:
        t0 = time.perf_counter()
        sd = draw_state_dict(shapes, dev)
        vpr = build(dev)
        vpr.load_torch_state_dict(sd)
        reset_launch_counts()
        sync(dev)
        t1 = time.perf_counter()
        desc = torch.cat([vpr.encode_batch_device(images[s : s + ENCODE_BATCH])
                          for s in range(0, n, ENCODE_BATCH)])
        sync(dev)
        wall = time.perf_counter() - t1
        counts = launch_counts()
        check_descriptors(desc, width, f"12c {name}")
        want = {"tri_count": 0, "flash_attention": 0,
                "dense_attention": 12 * -(-n // ENCODE_BATCH) if name == "cricavpr" else 0}
        if cuda and counts != want:
            raise AssertionError(f"12c {name}: kernel launches {counts}, expected {want}")
        launches[name] = counts["dense_attention"]
        fields = {}
        if cuda:
            ref = build(cpu)
            ref.load_torch_state_dict({k: v.cpu() for k, v in sd.items()})
            cos = (desc[:IMPORT_CHECK_FRAMES].cpu()
                   * ref.encode_batch_device(images[:IMPORT_CHECK_FRAMES])).sum(1)
            fields = {"cpu_frames": IMPORT_CHECK_FRAMES, "cosine_min": float(cos.min())}
            if float(cos.min()) < IMPORT_COSINE:
                raise AssertionError(f"12c {name}: card vs cpu cosine {cos.tolist()}")
            del ref
        log(f"12c {name}", t0, tensors=len(sd), parameters=sum(v.numel() for v in sd.values()),
            keyframes=n, encode_s=f"{wall:.4f}", keyframes_per_s=f"{n / wall:.1f}",
            launches=json.dumps(counts, separators=(",", ":")), **fields)
        del vpr
    # LightGlue and SuperPoint, float32, then the npz round trip
    t0 = time.perf_counter()
    mcfg = MatcherConfig.lightglue(dtype=torch.float32)
    sp_sd = draw_state_dict(superpoint_shapes(), dev)
    m_sd = draw_state_dict(lightglue_shapes(mcfg), dev, seed=1)

    def build_lg(d):
        lg = LightGlue(sp_cfg=SuperPointConfig(max_keypoints=512, dtype=torch.float32),
                       matcher_cfg=mcfg, device=d)
        lg.load_torch_state_dict({k: v.to(d) for k, v in m_sd.items()},
                                 {k: v.to(d) for k, v in sp_sd.items()})
        return lg

    lgs = {d.type: build_lg(d) for d in {dev, cpu}}
    gray = to_grayscale(torch.as_tensor(images[:2 * IMPORT_CHECK_FRAMES]))
    kp = [lgs["cpu"].sp.detect(gray[:IMPORT_CHECK_FRAMES]),
          lgs["cpu"].sp.detect(gray[IMPORT_CHECK_FRAMES:])]
    hw = tuple(gray.shape[1:3])
    scores = {}
    for k, lg in lgs.items():
        k0, k1 = (x.map(lambda t: t.to(lg.device)) for x in kp)
        scores[k] = lg.net(k0.descriptors, k0.coords, k0.mask, k1.descriptors, k1.coords,
                           k1.mask, hw).cpu()
    err = float((scores[dev.type] - scores["cpu"]).abs().max())
    if err > LIGHTGLUE_SCORE_ATOL:
        raise AssertionError(f"12c lightglue: scores card vs cpu {err} > {LIGHTGLUE_SCORE_ATOL}")
    lg = lgs[dev.type]
    with tempfile.TemporaryDirectory(prefix="mlis_phase12_") as tmp:
        path = os.path.join(tmp, "lightglue_official.npz")
        lg.save_weights(path)
        back = LightGlue.from_checkpoint(path, sp_cfg=lg.sp.cfg, dtype=torch.float32, device=dev)
        size = os.path.getsize(path)
    for net in ("net", "sp"):
        a, b = (getattr(x, net).state_dict() if net == "net" else x.sp.net.state_dict()
                for x in (lg, back))
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f"12c lightglue: the {net} weights changed in the npz round trip")
    # the same keypoints through both: score matrices identical
    k0, k1 = (x.map(lambda t: t.to(dev)) for x in kp)
    s1, s2 = (x.net(k0.descriptors, k0.coords, k0.mask, k1.descriptors, k1.coords, k1.mask, hw)
              for x in (lg, back))
    if not torch.equal(s1, s2):
        raise AssertionError("12c lightglue: scores differ after the npz round trip")
    mutual = extract_matches(s1, k0.mask, k1.mask, 0.0).valid.sum(1)
    log("12c lightglue", t0, matcher_tensors=len(m_sd), superpoint_tensors=len(sp_sd),
        pairs=IMPORT_CHECK_FRAMES, score_max_abs_err=err, round_trip_npz_bytes=size,
        round_trip_mutual_matches=",".join(str(int(x)) for x in mutual))
    return launches


def phase_model_families(dev, args) -> dict:
    """Phase 12: the official LoFTR gate, YOLOv8n and the weight import;
    returns the dense kernel's launches (12c's CricaVPR encode)."""
    t0 = time.perf_counter()
    phase_official_loftr(dev, args)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phase_yolo(dev, args)
    launches = phase_weight_import(dev, args)
    log("12 model families", t0, dense_launches=launches["cricavpr"])
    return {"dense_attention": launches["cricavpr"]}


# -- phase 13: the parallel package and the VPR trainer ----------------------------

TOPK_TIMES_S = 0.05  # keyframe spacing of phase 13c's descriptors
TRAIN_BATCH = (8, 4)  # places x views of phase 13d's fixed batch
TRAIN_HW = 224
TRAIN_STEPS = 5
TRAIN_CPU_IMAGES = 8
TRAIN_LOSS_RTOL = 1e-3  # card (TF32 off) vs CPU, the initial weights' loss
CRICA_COSINE = 0.999  # sharded encode vs the non-sharded one


def budget_slots(s: int) -> int:
    """``FullGatePipeline._budget_slots``: a survivor budget rounded up to
    {5, 6, 7, 8} x 2^k slots (at least 16), the slot count bench.py's
    multichip mode gives the sharded step."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline

    return FullGatePipeline._budget_slots(s)


def host_recount(desc: torch.Tensor, timestamps, floors, threshold: float = 0.3, k: int = 10):
    """The directed retrieval and floor gate of the step, on the host:
    (total, rejected, accepted) and the set of accepted (q, m) pairs."""
    from mlis_tpu_torch.ops.knn import cosine_topk

    d = desc.float().cpu()
    t = torch.as_tensor(np.asarray(timestamps, np.float32))
    scores, idx = (x.numpy() for x in cosine_topk(d, d, t, t, k=min(k, len(d)),
                                                   min_time_gap=10.0))
    valid = np.isfinite(scores) & (scores >= threshold)
    accept = valid & (floors[:, None] == floors[idx])
    pairs = {(int(q), int(idx[q, j])) for q, j in zip(*np.nonzero(accept))}
    return (int(valid.sum()), int((valid & ~accept).sum()), int(accept.sum())), pairs


def check_sharded_step(what: str, stats, verdicts, recount, pairs, floors) -> None:
    if (stats["total"], stats["rejected"], stats["accepted"]) != recount:
        raise AssertionError(f"{what}: directed stats {stats} != the host recount {recount}")
    ok = verdicts["slot_valid"]
    slots = set(zip(verdicts["qi"][ok].tolist(), verdicts["mi"][ok].tolist()))
    if not ok.any() or not slots <= pairs or \
            (floors[verdicts["qi"][ok]] != floors[verdicts["mi"][ok]]).any():
        raise AssertionError(f"{what}: a valid slot holds no accepted same-floor pair")


def phase_sharded_gate(dev, args, name_power: str) -> dict:
    """13a, 13b, 13c: bench.py's multichip mode on the port over a one-rank
    mesh (nccl on the card), CricaVPR as its encoder, the sharded top-k at
    the trajectory's size."""
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.models.superpoint import Keypoints
    from mlis_tpu_torch.ops.image import to_grayscale
    from mlis_tpu_torch.ops.knn import cosine_topk
    from mlis_tpu_torch.parallel.distributed_knn import db_sharded_topk, query_sharded_topk
    from mlis_tpu_torch.parallel.mesh import make_mesh
    from mlis_tpu_torch.parallel.sharded_gate import (
        make_sharded_gate_program,
        sharded_full_gate_step,
    )

    t0 = time.perf_counter()
    images, timestamps, floors, K = keyframes(args.keyframes)
    n, (H, W) = len(images), images.shape[1:3]
    pipe = build_pipeline(dev, torch.bfloat16)
    matcher = pipe.verifier.matcher
    mesh = make_mesh(1, 1, device_type=dev.type)
    imgs = torch.as_tensor(images, device=dev)
    t_arr = torch.as_tensor(timestamps.astype(np.float32), device=dev)
    fl_arr = torch.as_tensor(floors.astype(np.int32), device=dev)
    log("13a setup", t0, keyframes=n, mesh="1x1", backend=torch.distributed.get_backend(),
        weights="vpr_mixvpr.npz+lightglue_homog_sp.npz")

    # the single-card pipeline: one exact run gives the budget, then the
    # best of three compute-only runs with it; both sides of the comparison
    # read the keyframes already on the card, as bench.py's images_dev
    res = pipe.process(imgs, timestamps, floors, K, encode_batch_size=128)
    budget = res.verified
    best_pipe = float("inf")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(TIMED_REPS):
        pipe.spr.vpr.descriptors = []
        t1 = time.perf_counter()
        r = pipe.process(imgs, timestamps, floors, K, encode_batch_size=128,
                         survivor_budget=budget, monolithic=True)
        sync(dev)
        best_pipe = min(best_pipe, time.perf_counter() - t1)
    slots = budget_slots(budget)

    # the sharded step at the same slot count: once through the step, then
    # the best of three of its program; RANSAC draws fed to both the step
    # and the single-card fused check
    enc = pipe.spr.vpr.encode_batch_device
    gen = torch.Generator(device=dev).manual_seed(0)
    uniforms = torch.rand((slots, 512, 8), generator=gen, device=dev)
    reset_launch_counts()
    verdicts, stats = sharded_full_gate_step(
        mesh, matcher, enc, images, timestamps, floors, K, top_k=10, threshold=0.3,
        per_device_budget=slots, exact=False, match_top_k=512, uniforms=uniforms)
    prog = make_sharded_gate_program(mesh, matcher, enc, n, (H, W), K, top_k=10, threshold=0.3,
                                     min_time_gap=10.0, budget=slots, match_top_k=512)
    best_shard = float("inf")
    for _ in range(TIMED_REPS + 1):  # the first is the warm-up
        t1 = time.perf_counter()
        float(prog(imgs, t_arr, fl_arr, t_arr, fl_arr, uniforms=uniforms)[5].sum())
        best_shard = min(best_shard, time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counts = launch_counts()
    recount, pairs = host_recount(enc(imgs), timestamps, floors)
    check_sharded_step("13a", stats, verdicts, recount, pairs, floors)
    # the single-card fused program on the same pair list and draws
    h8, w8 = (H // 8) * 8, (W // 8) * 8
    kp = matcher.sp.detect(to_grayscale(imgs, size=(h8, w8)))
    kp = Keypoints(kp.coords * torch.tensor([W / w8, H / h8], device=dev),
                   *(x for x in kp[1:])).map(lambda x: x[:, :512])
    fused = matcher.make_fused_match_verify((H, W), K, 3.0)
    out = fused(kp, torch.as_tensor(verdicts["qi"], device=dev).long(),
                torch.as_tensor(verdicts["mi"], device=dev).long(), uniforms=uniforms)
    ok = verdicts["slot_valid"]
    for key, got in (("n_matches", out[2]), ("n_inliers", out[3])):
        if not np.array_equal(verdicts[key][ok], got.cpu().numpy()[ok]):
            raise AssertionError(f"13a: sharded {key} differ from the single-card fused program")
    # the matcher's attention alone: 2 x depth flash launches a fused call
    flash_per_call = 2 * matcher.cfg.depth if dev.type == "cuda" else 0
    if counts["tri_count"] or counts["dense_attention"] or \
            counts["flash_attention"] != flash_per_call * (TIMED_REPS + 2):
        raise AssertionError(f"13a: the MixVPR step launched {counts}; expected "
                             f"{flash_per_call} flash launches a call")
    overhead = best_shard / best_pipe - 1.0
    log("13a multichip", t0, gpu=json.dumps(name_power), pipeline_s=f"{best_pipe:.4f}",
        sharded_1dev_s=f"{best_shard:.4f}", overhead_pct=f"{100 * overhead:.2f}",
        verify_slots=slots, survivors=budget, stats=json.dumps(stats, separators=(",", ":")),
        valid_slots=int(ok.sum()), geometrically_valid=int((verdicts["n_inliers"][ok] >= 20).sum()),
        peak_mem_bytes=peak)
    del pipe, kp, out

    # 13b: the same step with path A's CricaVPR (vpr_crica.npz, ViT-B/14 at
    # 322x322, bf16) as the encoder: one dense-kernel launch per block per
    # encode call, descriptors as the non-sharded encode gives them
    t0 = time.perf_counter()
    crica = SemanticPlaceRecognition("cricavpr", similarity_threshold=0.3, min_time_gap=10.0,
                                     device=dev).vpr
    seen = []

    def crica_enc(x):
        crica.patch_cache = []
        d = crica.encode_batch_device(x)
        seen.append(d)
        return d

    reset_launch_counts()
    t1 = time.perf_counter()
    verdicts, stats = sharded_full_gate_step(
        mesh, matcher, crica_enc, images, timestamps, floors, K, top_k=10, threshold=0.3,
        per_device_budget=slots, exact=False, match_top_k=512)
    sync(dev)
    step_s = time.perf_counter() - t1
    counts = launch_counts()
    want = {"tri_count": 0, "flash_attention": 2 * matcher.cfg.depth if dev.type == "cuda" else 0,
            "dense_attention": crica.module.cfg.depth * len(seen) if dev.type == "cuda" else 0}
    if counts != want:
        raise AssertionError(f"13b: kernel launches {counts}, expected {want}")
    crica.patch_cache = []
    plain = torch.cat([crica.encode_batch_device(imgs[s:s + ENCODE_BATCH])
                       for s in range(0, n, ENCODE_BATCH)])
    cos = float(torch.nn.functional.cosine_similarity(seen[0].float(), plain.float()).min())
    if cos < CRICA_COSINE:
        raise AssertionError(f"13b: sharded encode cosine {cos} < {CRICA_COSINE}")
    recount, pairs = host_recount(seen[0], timestamps, floors)
    check_sharded_step("13b", stats, verdicts, recount, pairs, floors)
    crica.patch_cache = []
    log("13b cricavpr step", t0, gpu=json.dumps(name_power), step_s=f"{step_s:.4f}",
        encode_calls=len(seen), launches=json.dumps(counts, separators=(",", ":")),
        min_cosine_vs_unsharded=f"{cos:.6f}", stats=json.dumps(stats, separators=(",", ":")))
    dense = counts["dense_attention"]
    del crica, seen, plain

    # 13c: the sharded top-k at the trajectory's size (a CPU rehearsal
    # cuts the keyframes)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    n_db = SWEEP_POSES if dev.type == "cuda" else 2048
    desc = torch.nn.functional.normalize(
        torch.randn((n_db, 4096), generator=g, device=dev), dim=1)
    times = torch.arange(n_db, device=dev, dtype=torch.float32) * TOPK_TIMES_S
    want = cosine_topk(desc, desc, times, times, k=10, min_time_gap=10.0)
    fields = {}
    for label, fn in (("query_sharded", query_sharded_topk), ("db_sharded", db_sharded_topk)):
        got = fn(mesh, desc, desc, times, times, k=10, min_time_gap=10.0)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"13c: {label} top-k differs from cosine_topk")
        run = lambda: fn(mesh, desc, desc, times, times, k=10, min_time_gap=10.0)  # noqa: E731
        fields[f"{label}_ms"] = f"{events_ms(run, 3) if dev.type == 'cuda' else host_ms(dev, run, 1):.3f}"
    single = lambda: cosine_topk(desc, desc, times, times, k=10, min_time_gap=10.0)  # noqa: E731
    fields["cosine_topk_ms"] = f"{events_ms(single, 3) if dev.type == 'cuda' else host_ms(dev, single, 1):.3f}"
    log("13c sharded top-k", t0, gpu=json.dumps(name_power), keyframes=n_db, dim=4096,
        equal_to_cosine_topk=True, **fields)
    del desc, want
    return {"dense_attention": dense, "best_pipe_s": best_pipe, "slots": slots,
            "dim": matcher.cfg.dim, "depth": matcher.cfg.depth}


def train_batch(dev):
    """Phase 13d's fixed batch: 8 places x 4 views at 224 x 224 from
    torch.Generator(0), each view its place's image plus noise."""
    places, views = TRAIN_BATCH
    g = torch.Generator(device=dev).manual_seed(0)
    base = torch.rand((places, TRAIN_HW, TRAIN_HW, 3), generator=g, device=dev)
    noise = 0.1 * torch.randn((places, views, TRAIN_HW, TRAIN_HW, 3), generator=g, device=dev)
    images = (base[:, None] + noise).clamp(0, 1).reshape(places * views, TRAIN_HW, TRAIN_HW, 3)
    return images, torch.arange(places, device=dev).repeat_interleave(views)


def phase_trainer(dev, args, name_power: str) -> None:
    """13d: VPRTrainer at CricaVPR's ViT-B/14 width (float32, plain
    attention) on the one-rank mesh, then run_demo at its defaults."""
    import copy

    from mlis_tpu_torch.models.vit import ViT, ViTConfig
    from mlis_tpu_torch.train.trainer import GeMEncoder, VPRTrainer, nt_xent_loss
    from mlis_tpu_torch.train.vpr_finetune_demo import run_demo

    t0 = time.perf_counter()
    cfg = ViTConfig(dim=768, depth=args.train_depth, num_heads=12, dtype=torch.float32)
    enc = GeMEncoder(ViT(cfg, use_kernel=False).init_random_(torch.Generator().manual_seed(0)))
    images, ids = train_batch(dev)
    # the initial weights' loss on the first images, card (TF32 off) vs CPU
    first = slice(0, TRAIN_CPU_IMAGES)
    with torch.no_grad():
        cpu_loss = float(nt_xent_loss(enc(images[first].cpu()), ids[first].cpu()))
        card = copy.deepcopy(enc).to(dev)
        dev_loss = float(nt_xent_loss(card(images[first]), ids[first]))
    del card
    if not abs(dev_loss - cpu_loss) <= TRAIN_LOSS_RTOL * abs(cpu_loss):
        raise AssertionError(f"13d: initial loss {dev_loss} on the card, {cpu_loss} on the CPU")
    trainer = VPRTrainer(enc, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    host_images, host_ids = images.cpu().numpy(), ids.cpu().numpy()
    losses = [trainer.train_batch(host_images, host_ids)]  # the first step warms up
    sync(dev)
    t1 = time.perf_counter()
    losses += [trainer.train_batch(host_images, host_ids) for _ in range(TRAIN_STEPS - 1)]
    sync(dev)
    steps_per_s = (TRAIN_STEPS - 1) / (time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"13d: losses {losses} not finite and falling")
    log("13d trainer", t0, gpu=json.dumps(name_power), vit=f"dim768_depth{cfg.depth}_h12_f32",
        batch=f"{len(host_images)}x{TRAIN_HW}x{TRAIN_HW}", steps=TRAIN_STEPS,
        losses=",".join(f"{x:.5f}" for x in losses), steps_per_s=f"{steps_per_s:.3f}",
        initial_loss_card=f"{dev_loss:.6f}", initial_loss_cpu=f"{cpu_loss:.6f}",
        peak_mem_bytes=peak)
    del trainer, enc

    t0 = time.perf_counter()
    r = run_demo(device=dev)
    demo_s = time.perf_counter() - t0
    before, after = r["before"], r["after"]
    if not (r["loss_last"] < 0.5 * r["loss_first"] and after["same_floor_recall"] >= 0.9
            and after["same_floor_recall"] > before["same_floor_recall"]):
        raise AssertionError(f"13d: run_demo's contract fails: {r}")
    log("13d run_demo", t0, gpu=json.dumps(name_power), demo_s=f"{demo_s:.3f}",
        steps=r["steps"], loss_first=f"{r['loss_first']:.5f}", loss_last=f"{r['loss_last']:.5f}",
        recall_before=before["same_floor_recall"], recall_after=after["same_floor_recall"],
        cross_floor_before=before["cross_floor_false_rate"],
        cross_floor_after=after["cross_floor_false_rate"])


def phase_scaling_model(args, gate: dict, name_power: str) -> None:
    """13e: the comm model at 4 and 8 cards, its compute term calibrated by
    13a's single-card rate (bench.py's multichip mode)."""
    from mlis_tpu_torch.parallel.scaling import estimate_gate_scaling
    from mlis_tpu_torch.utils.flops import full_gate_flops

    t0 = time.perf_counter()
    n, slots = args.keyframes, gate["slots"]
    achieved = full_gate_flops(n, slots, (270, 360), 512, matcher_dim=gate["dim"],
                               matcher_depth=gate["depth"]) / gate["best_pipe_s"]
    ests = {d: estimate_gate_scaling(n_frames=n, n_dev=d, match_kpts=512, pairs_verified=slots,
                                     achieved_flops_per_s=achieved).as_dict() for d in (4, 8)}
    log("13e scaling model", t0, gpu=json.dumps(name_power),
        achieved_tflops=f"{achieved / 1e12:.3f}",
        est4=json.dumps(ests[4], separators=(",", ":")),
        est8=json.dumps(ests[8], separators=(",", ":")))


def phase_parallel(dev, args) -> dict:
    """Phase 13: the sharded gate step, the sharded top-k, the trainer and
    the comm model (see the module docstring)."""
    import torch.distributed as dist

    name_power = gpu_name_and_power() if dev.type == "cuda" else "cpu rehearsal"
    try:
        with torch.inference_mode():
            gate = phase_sharded_gate(dev, args, name_power)
        phase_trainer(dev, args, name_power)
        phase_scaling_model(args, gate, name_power)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return {"dense_attention": gate["dense_attention"]}


# -- phase 14: the pretraining drivers ------------------------------------------------

MATCHER_CKPT = "checkpoints/lightglue_parallax_sp.npz"
LOFTR_CKPT = "checkpoints/loftr_parallax.npz"
VPR_TINY_CKPT = "checkpoints/vpr_tiny_v2.npz"
MIN_SHIPPED_RECALL = 0.5  # 14a: the shipped matcher's step-0 recall on the port's draws
HELDOUT_TIE_BAND = 5e-3  # 14d: a query's top two similarities this close may swap
PARITY_LOSS_RTOL = 1e-4  # 14e: card vs CPU, one float32 step (TF32 off)
PARITY_PARAM_RTOL = 1e-4


def log_best(name: str, key: str) -> float:
    """The best held-out recall a shipped checkpoint's training log records
    (a TPU run of the JAX package on its own draws: a target, not a bound)."""
    with open(f"checkpoints/{name}_log.json") as f:
        return float(json.load(f)[key])


def _trained_module(trainer) -> torch.nn.Module:
    return trainer.matcher.net if hasattr(trainer, "matcher") else trainer.sp.net


def _state_copy(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


@contextlib.contextmanager
def recording(module, cls_name: str, on_init=None):
    """``module.cls_name`` (a trainer class, which the drivers import from
    its module when they run) replaced by a subclass that records its
    instances, the initial weights of the module it trains (and
    ``on_init(trainer)`` there), each train_chunk's steps and host seconds
    (train_chunk ends by copying its losses to the host, so the clock
    covers the device work) and the weights at each save_checkpoint."""
    orig = getattr(module, cls_name)
    rec = {"instances": [], "chunks": [], "saves": {}}

    class Recorded(orig):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec["instances"].append(self)
            rec["initial"] = _state_copy(_trained_module(self))
            if on_init is not None:
                rec["on_init"] = on_init(self)

        def train_chunk(self, steps, *a, **kw):
            t = time.perf_counter()
            out = super().train_chunk(steps, *a, **kw)
            rec["chunks"].append((steps, time.perf_counter() - t))
            return out

        def save_checkpoint(self, path):
            super().save_checkpoint(path)
            rec["saves"][path] = _state_copy(_trained_module(self))

    setattr(module, cls_name, Recorded)
    try:
        yield rec
    finally:
        setattr(module, cls_name, orig)


@contextlib.contextmanager
def timed_vpr_chunks():
    """pretrain_vpr.make_train_chunk wrapped: each chunk's steps and seconds."""
    from mlis_tpu_torch.train import pretrain_vpr as tpv

    orig = tpv.make_train_chunk
    rec = {"chunks": []}

    def make(*a, **kw):
        fn = orig(*a, **kw)

        def chunk(n, *ca, **ckw):
            t = time.perf_counter()
            out = fn(n, *ca, **ckw)
            rec["chunks"].append((n, time.perf_counter() - t))
            return out

        return chunk

    tpv.make_train_chunk = make
    try:
        yield rec
    finally:
        tpv.make_train_chunk = orig


def steps_per_s(chunks) -> float:
    """Steps per second over the chunks after the first (its steps pay the
    first-call costs), or over the one chunk there is."""
    timed = chunks[1:] or chunks
    return sum(n for n, _ in timed) / sum(t for _, t in timed)


def peak_reset(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _losses(hist) -> list:
    return [float(x[1]) for x in hist["loss"]]


def check_saved_weights(what: str, saved: dict, module: torch.nn.Module) -> None:
    """The npz's reload equals the weights the trainer saved, at float16
    rounding (the checkpoints' format)."""
    got = module.state_dict()
    if set(got) != set(saved):
        raise AssertionError(f"{what}: the reload has other tensors than the trainer")
    for k, v in saved.items():
        if not torch.equal(got[k].detach().cpu().half(), v.half()):
            raise AssertionError(f"{what}: {k} differs from the trainer's at float16 rounding")


def phase_pretrain_matchers(dev, tmp: str, name_power: str) -> None:
    """14a and 14b: pretrain_matcher (LightGlue warm-started from the shipped
    parallax checkpoint, then SuperGlue from random weights) and
    pretrain_loftr (from the shipped parallax LoFTR)."""
    from mlis_tpu_torch.models.lightglue import LightGlue
    from mlis_tpu_torch.models.loftr import LoFTR, LoFTRConfig
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.train import loftr_trainer, matcher_trainer, pretrain_loftr
    from mlis_tpu_torch.train import pretrain_matcher

    card = dev.type == "cuda"
    # the drivers' own defaults set the widths; the CPU rehearsal runs --tiny
    steps = ["--steps", "20", "--chunk", "10", "--eval-every", "10"] if card else [
        "--tiny", "--steps", "4", "--chunk", "2", "--eval-every", "2"]
    t0 = time.perf_counter()
    path = os.path.join(tmp, "lightglue_parallax.npz")
    peak_reset(dev)
    with recording(matcher_trainer, "MatcherTrainer") as rec:
        hist = pretrain_matcher.main(["--device", dev.type, "--out", path, "--parallax", *steps]
                                     + (["--init-from", MATCHER_CKPT] if card else []))
    peak = peak_bytes(dev)
    (_, r0, p0), (_, r_end, p_end) = hist["eval"][0], hist["eval"][-1]
    if not np.isfinite(_losses(hist)).all():
        raise AssertionError(f"14a: losses {hist['loss']}")
    if card and r0 < MIN_SHIPPED_RECALL:
        raise AssertionError(f"14a: the shipped matcher's step-0 recall {r0} < {MIN_SHIPPED_RECALL}")
    sp_cfg = SuperPointConfig(max_keypoints=512) if card else SuperPointConfig.tiny_test(
        max_keypoints=48)
    back = LightGlue.from_checkpoint(path, sp_cfg=sp_cfg, device=dev)
    check_saved_weights("14a", rec["saves"][path], back.net)
    rate = steps_per_s(rec["chunks"])
    if card:  # where a step's time goes: two more steps of the same trainer
        trainer = rec["instances"][0]
        profile_run(dev, lambda: trainer.train_chunk(2, batch_size=8), 2 / rate)
    log("14a pretrain_matcher", t0, gpu=json.dumps(name_power),
        config="lightglue_d9_dim256_kpts512_270x360_b8_parallax" if card else "tiny",
        steps=hist["loss"][-1][0], steps_per_s=f"{rate:.3f}", peak_mem_bytes=peak,
        losses=",".join(f"{x:.5f}" for x in _losses(hist)),
        recall0=f"{r0:.4f}", precision0=f"{p0:.4f}",
        log_best_recall=f"{log_best('lightglue_parallax_sp', 'best_recall'):.4f}",
        recall_end=f"{r_end:.4f}", precision_end=f"{p_end:.4f}",
        best_saved=f"{hist['best_recall']:.4f}", reload="equal_at_float16")

    t0 = time.perf_counter()
    path = os.path.join(tmp, "superglue_homog.npz")
    # chunks of 5: the rate is read on the second, after the first-call costs
    sg_steps = ["--steps", "10", "--chunk", "5", "--eval-every", "10"] if card else steps
    peak_reset(dev)
    with recording(matcher_trainer, "MatcherTrainer") as rec:
        hist = pretrain_matcher.main(["--device", dev.type, "--out", path, "--arch", "superglue",
                                      *sg_steps])
    peak = peak_bytes(dev)
    final = _state_copy(rec["instances"][0].matcher.net)
    moved = sum(not torch.equal(final[k], v) for k, v in rec["initial"].items())
    if not np.isfinite(_losses(hist)).all() or moved == 0:
        raise AssertionError(f"14a superglue: losses {hist['loss']}, {moved} tensors moved")
    rate = steps_per_s(rec["chunks"])
    log("14a pretrain_matcher superglue", t0, gpu=json.dumps(name_power),
        config="superglue_d9_dim256_kpts512_270x360_b8_homography_random" if card else "tiny",
        steps=hist["loss"][-1][0], steps_per_s=f"{rate:.3f}", peak_mem_bytes=peak,
        losses=",".join(f"{x:.5f}" for x in _losses(hist)),
        tensors_moved=f"{moved}/{len(final)}", recall_end=f"{hist['eval'][-1][1]:.4f}")

    t0 = time.perf_counter()
    path = os.path.join(tmp, "loftr_parallax.npz")
    lf_args = ["--height", "272", "--width", "360", "--init-from", LOFTR_CKPT, "--batch", "4"]
    peak_reset(dev)
    with recording(loftr_trainer, "LoFTRTrainer") as rec:
        hist = pretrain_loftr.main(["--device", dev.type, "--out", path, "--parallax", *steps]
                                   + (lf_args if card else []))
    peak = peak_bytes(dev)
    (_, r0, p0), (_, r_end, p_end) = hist["eval"][0], hist["eval"][-1]
    if not np.isfinite(_losses(hist)).all():
        raise AssertionError(f"14b: losses {hist['loss']}")
    back = LoFTR(LoFTRConfig() if card else LoFTRConfig.tiny_test(), device=dev)
    back.load_weights(path)
    check_saved_weights("14b", rec["saves"][path], back.net)
    rate = steps_per_s(rec["chunks"])
    if card:
        trainer = rec["instances"][0]
        profile_run(dev, lambda: trainer.train_chunk(2, batch_size=4), 2 / rate)
    log("14b pretrain_loftr", t0, gpu=json.dumps(name_power),
        config="loftr_lite_272x360_b4_parallax" if card else "tiny",
        steps=hist["loss"][-1][0], steps_per_s=f"{rate:.3f}", peak_mem_bytes=peak,
        losses=",".join(f"{x:.5f}" for x in _losses(hist)),
        recall0=f"{r0:.4f}", precision0=f"{p0:.4f}",
        log_best_recall=f"{log_best('loftr_parallax', 'best_recall'):.4f}",
        recall_end=f"{r_end:.4f}", precision_end=f"{p_end:.4f}", reload="equal_at_float16")


def phase_pretrain_superpoint(dev, tmp: str, name_power: str) -> None:
    """14c: pretrain_superpoint at its defaults from random weights."""
    from mlis_tpu_torch.train import pretrain_superpoint, superpoint_trainer

    card = dev.type == "cuda"
    t0 = time.perf_counter()
    path = os.path.join(tmp, "superpoint_synth.npz")
    steps = ["--steps", "20", "--chunk", "10", "--eval-every", "20"] if card else [
        "--tiny", "--steps", "4", "--chunk", "2", "--eval-every", "4"]
    peak_reset(dev)
    # step 0's repeatability, before any step (the driver measures it with
    # its later evals only)
    with recording(superpoint_trainer, "SuperPointTrainer",
                   on_init=lambda t: t.repeatability()) as rec:
        hist = pretrain_superpoint.main(["--device", dev.type, "--out", path, *steps])
    peak = peak_bytes(dev)
    m0, m_end = hist["eval"][0][1], hist["eval"][-1][1]
    if not np.isfinite(np.asarray([x[1:] for x in hist["loss"]])).all():
        raise AssertionError(f"14c: losses {hist['loss']}")
    rate = steps_per_s(rec["chunks"])
    log("14c pretrain_superpoint", t0, gpu=json.dumps(name_power),
        config="superpoint_270x360_b8_random" if card else "tiny",
        steps=hist["loss"][-1][0], steps_per_s=f"{rate:.3f}", peak_mem_bytes=peak,
        losses=";".join(",".join(f"{v:.4f}" for v in x[1:]) for x in hist["loss"]),
        corner_recall0=f"{m0['corner_recall']:.4f}",
        detector_precision0=f"{m0['detector_precision']:.4f}",
        repeatability0=f"{rec['on_init']:.4f}", corner_recall_end=f"{m_end['corner_recall']:.4f}",
        detector_precision_end=f"{m_end['detector_precision']:.4f}",
        repeatability_end=f"{m_end['repeatability']:.4f}",
        log_best_corner_recall=f"{log_best('superpoint_synth', 'best_corner_recall'):.4f}")


def heldout_witness(what: str, apply_on, hw, dev) -> dict:
    """``pretrain_vpr.heldout_recall`` of one encoder on the card and on the
    CPU over the same held-out draws, made once on the CPU (seed 77,000, as
    the driver's own): a fault of the held-out path on the card then shows
    as a difference, which the card's own draws could not tell from a draw
    difference. ``apply_on(device, dtype)`` is the encoder's apply function
    there. In float32 (TF32 off) each query's nearest neighbour must be the
    same on both devices, except where its top two similarities on the CPU
    lie within HELDOUT_TIE_BAND, and the recalls may differ by those swaps
    only. The drivers' own bf16 is reported beside it and not held: VLAD's
    hard assignment turns bf16 rounding into whole-cluster changes (on the
    CPU alone, bf16 against float32 moves 74 of the 6,144 patch
    assignments of the shipped vpr_anyloc.npz on these draws, and 4 of its
    64 nearest neighbours)."""
    from mlis_tpu_torch.train import pretrain_vpr as tpv

    cpu = torch.device("cpu")
    draws = tpv.draw_batch_parallax(32, 2, hw, generator=torch.Generator().manual_seed(77_000),
                                    device="cpu")
    fields = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        recall, nn1 = {}, {}
        for d in (dev, cpu):
            fn = apply_on(d, dtype)
            recall[d.type] = tpv.heldout_recall(fn, hw=hw, parallax=True, device=d,
                                                draws=draws.to(d))
            with torch.no_grad():
                imgs, _ = tpv.sample_training_batch(32, 2, hw, 0.08, 0.08, True, None, d,
                                                    draws.to(d))
                desc = fn(imgs).to(torch.float32).cpu()
            sims = desc @ desc.T
            sims.fill_diagonal_(-float("inf"))
            top2 = sims.topk(2, dim=1)
            nn1[d.type] = top2.indices[:, 0]
            if d.type == "cpu":
                margin = top2.values[:, 0] - top2.values[:, 1]
        swaps = nn1[dev.type] != nn1["cpu"]
        unexplained = int((swaps & (margin > HELDOUT_TIE_BAND)).sum())
        n_swaps = int(swaps.sum())
        if dtype == torch.float32 and (
                unexplained or abs(recall[dev.type] - recall["cpu"]) * len(swaps) > n_swaps + 1e-9):
            raise AssertionError(f"14d {what}: float32 held-out recall@1 {recall[dev.type]} on "
                                 f"{dev.type} vs {recall['cpu']} on the CPU with the same draws, "
                                 f"{n_swaps} nearest neighbours differ ({unexplained} outside "
                                 f"the tie band)")
        fields.update({f"witness_{tag}": f"{recall[dev.type]:.4f}",
                       f"witness_{tag}_cpu": f"{recall['cpu']:.4f}",
                       f"witness_{tag}_swaps": f"{n_swaps}/{len(swaps)}({unexplained}_outside)"})
    return fields


def _tiny_vpr_on(path: str, centers: bool = False):
    """apply_on(device, dtype) for heldout_witness: the tiny encoder of an
    npz computing in ``dtype`` (with AnyLoc's VLAD vocabulary when
    ``centers``)."""
    from mlis_tpu_torch.models.vit import ViT, ViTConfig
    from mlis_tpu_torch.train import pretrain_vpr as tpv
    from mlis_tpu_torch.weights import load_npz

    tree = load_npz(path)

    def apply_on(d, dtype):
        model = ViT(ViTConfig.tiny_test(patch_size=8, dtype=dtype), use_kernel=False)
        model.load_state_dict(tree["vpr"], strict=True)
        model.to(d).eval()
        if centers:
            return tpv._anyloc_apply(model, tree["vlad"]["centers"].to(d))
        return tpv._make_apply(model)

    return apply_on


def phase_pretrain_vpr(dev, tmp: str, name_power: str) -> None:
    """14d: pretrain_vpr.main for every arch."""
    from mlis_tpu_torch.train import pretrain_vpr

    card = dev.type == "cuda"
    runs = [
        ("tiny", ["--parallax", "--init-from", VPR_TINY_CKPT, "--height", "136", "--width", "180",
                  "--steps", "20", "--chunk", "10", "--eval-every", "10"]),
        # at least two chunks each: steps_per_s times those after the first
        ("salad", ["--steps", "10", "--chunk", "5", "--eval-every", "10"]),
        ("mixvpr", ["--steps", "10", "--chunk", "5", "--eval-every", "10"]),
        ("cricavpr", ["--steps", "5", "--chunk", "2", "--eval-every", "5"]),
        ("anyloc", ["--clusters", "64", "--parallax", "--height", "136", "--width", "180",
                    "--steps", "32"]),
    ]
    for arch, argv in runs:
        t0 = time.perf_counter()
        if not card:
            if arch in ("mixvpr", "cricavpr"):
                log(f"14d pretrain_vpr {arch}", t0, skipped="cpu rehearsal (full backbone)")
                continue
            argv = ["--tiny"] + (["--parallax", "--init-from", VPR_TINY_CKPT]
                                 if arch == "tiny" else [])
        path = os.path.join(tmp, f"vpr_{arch}.npz")
        peak_reset(dev)
        with timed_vpr_chunks() as rec:
            hist = pretrain_vpr.main(["--device", dev.type, "--arch", arch, "--out", path, *argv])
        peak = peak_bytes(dev)
        fields = {}
        hw = (hist["config"]["height"], hist["config"]["width"])
        if arch == "anyloc":
            fields.update(recall_at_1=f"{hist['best_recall_at_1']:.4f}",
                          log_recall_at_1=f"{log_best('vpr_anyloc', 'best_recall_at_1'):.4f}")
            # the vocabulary this run fitted, scored on both devices
            fields.update(heldout_witness(arch, _tiny_vpr_on(path, centers=True), hw, dev))
        else:
            if not np.isfinite(_losses(hist)).all():
                raise AssertionError(f"14d {arch}: losses {hist['loss']}")
            fields.update(steps=hist["loss"][-1][0],
                          steps_per_s=f"{steps_per_s(rec['chunks']):.3f}",
                          losses=",".join(f"{x:.5f}" for x in _losses(hist)),
                          recall0=f"{hist['eval'][0][1]:.4f}",
                          recall_end=f"{hist['eval'][-1][1]:.4f}")
            if arch == "tiny":
                fields["log_best_recall"] = f"{log_best('vpr_tiny_v2', 'best_recall_at_1'):.4f}"
                # the shipped weights (the run's step 0), scored on both devices
                fields.update(heldout_witness(arch, _tiny_vpr_on(VPR_TINY_CKPT), hw, dev))
        if not os.path.exists(path):
            raise AssertionError(f"14d {arch}: no checkpoint written")
        log(f"14d pretrain_vpr {arch}", t0, gpu=json.dumps(name_power), peak_mem_bytes=peak,
            **fields)


def _parity_step(what: str, make, step, dev, lr: float) -> dict:
    """One step of the trainer ``make(device)`` builds (from one seed, so the
    same initial weights on both devices), on the CPU and on the card,
    through ``step(trainer, device)``
    (the same draws on both); the losses within PARITY_LOSS_RTOL, the
    weights within PARITY_PARAM_RTOL over all of them and entry by entry
    within Adam's own bound of 2 lr."""
    cpu = make(torch.device("cpu"))
    card = make(dev)
    want = float(torch.as_tensor(step(cpu, torch.device("cpu"))).reshape(-1)[0])
    got = float(torch.as_tensor(step(card, dev)).reshape(-1)[0].cpu())
    a = torch.cat([p.detach().cpu().reshape(-1) for p in _parity_module(card).parameters()])
    b = torch.cat([p.detach().reshape(-1) for p in _parity_module(cpu).parameters()])
    rel = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    worst = float((a - b).abs().max())
    if not (abs(got - want) <= PARITY_LOSS_RTOL * abs(want) and rel <= PARITY_PARAM_RTOL
            and worst <= 2 * lr):
        raise AssertionError(f"14e {what}: loss {got} vs {want}, weights {rel:.3g} relative, "
                             f"largest entry {worst / lr:.3g} lr apart")
    return {"loss_card": f"{got:.6f}", "loss_cpu": f"{want:.6f}", "weights_rel": f"{rel:.3g}",
            "max_entry_lr": f"{worst / lr:.3g}"}


def _parity_module(x) -> torch.nn.Module:
    return x if isinstance(x, torch.nn.Module) else _trained_module(x)


def phase_pretrain_parity(dev, name_power: str) -> None:
    """14e: one step of each trainer at its tiny config, float32, card vs CPU."""
    from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig
    from mlis_tpu_torch.models.loftr import LoFTR, LoFTRConfig
    from mlis_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
    from mlis_tpu_torch.models.vit import ViT, ViTConfig
    from mlis_tpu_torch.train import pretrain_vpr as tpv
    from mlis_tpu_torch.train.loftr_trainer import LoFTRTrainer
    from mlis_tpu_torch.train.matcher_trainer import MatcherTrainer, draw_layered_pair
    from mlis_tpu_torch.train.optim import ClippedAdam
    from mlis_tpu_torch.train.superpoint_trainer import SuperPointTrainer, draw_superpoint_step

    f32 = torch.float32
    hw = (64, 96)
    g = torch.Generator().manual_seed(0)
    pair_draws = draw_layered_pair(2, *hw, generator=g, device="cpu")
    sp_draws = draw_superpoint_step(2, *hw, g, "cpu")
    vpr_hw = (96, 128)
    vpr_draws = tpv.draw_batch_parallax(6, 3, vpr_hw, generator=g, device="cpu")
    lr = 1e-4

    def matcher(device):
        lg = LightGlue(SuperPointConfig.tiny_test(max_keypoints=48, dtype=f32),
                       MatcherConfig.tiny_test(dtype=f32), device=device).init_random_(0)
        return MatcherTrainer(lg, hw, learning_rate=lr, pair_mode="parallax")

    def loftr(device):
        lf = LoFTR(LoFTRConfig.tiny_test(dtype=f32), device=device).init_random_(0)
        return LoFTRTrainer(lf, hw, learning_rate=lr, pair_mode="parallax")

    def superpoint(device):
        sp = SuperPoint(SuperPointConfig.tiny_test(dtype=f32), device=device).init_random_(0)
        return SuperPointTrainer(sp, hw, learning_rate=lr)

    def vpr(device):
        vit = ViT(ViTConfig.tiny_test(patch_size=8, dtype=f32), use_kernel=False)
        vit = vit.init_random_(torch.Generator().manual_seed(0)).to(device)
        opt = ClippedAdam(vit.parameters(), lr, weight_decay=1e-4)
        vit.chunk = tpv.make_train_chunk(tpv._make_apply(vit), opt, 6, 3, vpr_hw, 0.08, 0.08,
                                         parallax=True, device=device)
        return vit

    cases = [
        ("MatcherTrainer", matcher, lambda t, d: t.step(None, pair_draws.to(d))[0]),
        ("LoFTRTrainer", loftr, lambda t, d: t.step(None, pair_draws.to(d))[0]),
        ("SuperPointTrainer", superpoint, lambda t, d: t.step(sp_draws.to(d))[0]),
        ("pretrain_vpr", vpr, lambda t, d: t.chunk(1, None, draws=[vpr_draws.to(d)])),
    ]
    for what, make, step in cases:
        t0 = time.perf_counter()
        fields = _parity_step(what, make, step, dev, lr)
        log(f"14e parity {what}", t0, gpu=json.dumps(name_power), **fields)


def phase_autograd_refusal(dev, name_power: str) -> None:
    """14f: the kernel wrappers refuse inputs that require grad on the card,
    and launch under torch.no_grad()."""
    from mlis_tpu_torch.ops import attention as att
    from mlis_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    if dev.type != "cuda":
        log("14f autograd refusal", t0, skipped="cpu rehearsal (the CPU runs the plain versions)")
        return
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 256, 4, 64), generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    for x in (q, k, v):
        x.requires_grad_(True)
    for name, fn in (("flash_mha", fa.flash_mha), ("multi_head_attention", att.multi_head_attention)):
        try:
            fn(q, k, v)
        except RuntimeError as e:
            if "forward-only" not in str(e):
                raise
        else:
            raise AssertionError(f"14f: {name} on inputs that require grad did not raise")
    before = launch_counts()
    with torch.no_grad():
        fa.flash_mha(q, k, v)
        att.multi_head_attention(q, k, v)
    sync(dev)
    after = launch_counts()
    if (after["flash_attention"] - before["flash_attention"],
            after["dense_attention"] - before["dense_attention"]) != (1, 1):
        raise AssertionError(f"14f: launches {before} -> {after} under no_grad")
    log("14f autograd refusal", t0, gpu=json.dumps(name_power), refused="flash_mha,multi_head_attention",
        no_grad_launches="flash_attention+1,dense_attention+1")


def phase_pretrain(dev, args) -> None:
    """Phase 14, outside inference mode: the four pretraining drivers at
    their own widths (a few steps each), one tiny step of each trainer card
    against CPU, then the autograd refusal of the kernel wrappers. Every
    training step runs the plain attention: no kernel launches in 14a-14e
    but the flash kernel in the matchers' held-out evaluations, which run
    the bf16 matcher under torch.no_grad() as the gate does."""
    import tempfile

    name_power = gpu_name_and_power() if dev.type == "cuda" else "cpu rehearsal"
    t0 = time.perf_counter()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        phase_pretrain_matchers(dev, tmp, name_power)
        evals = launch_counts()
        reset_launch_counts()
        phase_pretrain_superpoint(dev, tmp, name_power)
        phase_pretrain_vpr(dev, tmp, name_power)
    phase_pretrain_parity(dev, name_power)
    counts = launch_counts()
    if any(counts.values()) or evals["tri_count"] or evals["dense_attention"]:
        raise AssertionError(f"phase 14a-14e launched a kernel: {counts}, matchers {evals}")
    counts = {k: n + evals[k] for k, n in counts.items()}
    phase_autograd_refusal(dev, name_power)
    log("14 pretraining", t0, gpu=json.dumps(name_power), launches_14a_14e=json.dumps(
        counts, separators=(",", ":")))


# -- phase 15: the IO path, the rest of the CLI, and the H100 roofline -------------

ROS_EPOCH = 1.7e9  # absolute ROS stamps (and a step coarse enough that k/200 s survives sec/nsec)
IO_SCANS = 300  # of the traversal's 12,000 scans: 30 s of phase 10's bag around its first ride
ODOM_RATE, ODOM_MESSAGES = 10.0, 12_000  # /aft_mapped_to_init over phase 10's 1,200 s
CODEC_IMU = 150_000  # 15b: the first 150,000 IMU records and every odometry record, ~64 MB
OUSTER_STEP, OUSTER_RING_OFF = 48, 26  # OS-128 PointCloud2: x/y/z float32 at 0/4/8, uint16 ring
OUSTER_FIELDS = (("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1), ("ring", OUSTER_RING_OFF, 4, 1))
IO_TOPICS = {"imu": "/vectornav/imu", "odom": "/aft_mapped_to_init", "lidar": "/ouster/points"}
IO_GATES = ("fullgate_mixvpr", "fullgate_cricavpr")  # 15c's calls that reach attention kernels


def ouster_blob(xyz: np.ndarray, ring: np.ndarray) -> bytes:
    """One scan in the Ouster PointCloud2 layout (48-byte points)."""
    buf = np.zeros((len(xyz), OUSTER_STEP), np.uint8)
    buf[:, :12] = np.ascontiguousarray(xyz, np.float32).view(np.uint8)
    buf[:, OUSTER_RING_OFF:OUSTER_RING_OFF + 2] = ring.astype(np.uint16)[:, None].view(np.uint8)
    return buf.tobytes()


def io_traversal(dev, args):
    """Phase 10's inputs (the same torch.Generator(0) draws in the same
    order): the 240,000 IMU samples with the four rides and the OS-128
    scans, cut to args.io_scans scans around the first ride, plus a 10 Hz
    odometry track on the loop with the floors' heights. Stamps are
    absolute (ROS_EPOCH + t)."""
    from mlis_tpu_torch.gating.lidar_floor_tracker import LiDARFloorTracker

    gen = torch.Generator(device=dev).manual_seed(0)
    rides = ride_windows(args.scans)
    t, ax, ay, az, gyro = imu_stream(dev, gen, rides)
    points, ring, scan_t = lidar_bag(dev, gen, args.scans, rides)
    n_io = args.io_scans
    first = int(rides[0][0] * LIDAR_RATE)
    s0 = min(max(first - n_io // 2, 0), args.scans - n_io)
    points = points[s0 : s0 + n_io].clone()

    odo_t = np.arange(ODOM_MESSAGES) / ODOM_RATE
    odo_pos = loop_positions(gen, dev, ODOM_MESSAGES)
    odo_pos[:, 2] += FLOOR_HEIGHT_M * (simulated_floor(odo_t, rides) - START_FLOOR)
    iters = LiDARFloorTracker(device=dev).ransac_iterations
    u = torch.rand((n_io, iters, 3), generator=gen, device=dev)
    return {
        "rides": rides, "imu_t": ROS_EPOCH + t, "accel": torch.stack([ax, ay, az], 1).double(),
        "gyro": gyro.double(), "points": points, "ring": ring, "scan_t": ROS_EPOCH + scan_t[
            s0 : s0 + n_io], "odo_t": ROS_EPOCH + odo_t, "odo_pos": odo_pos, "uniforms": u,
        "first_scan": s0,
    }


def write_io_bag(path: str, tr: dict, imu_n=None, with_points: bool = True,
                 compression: str = "none") -> dict:
    """The traversal as a ROS bag: IMU at 200 Hz, odometry at 10 Hz, and
    (with_points) the OS-128 scans in the Ouster layout."""
    from mlis_tpu_torch.core.bag import (
        BagWriter,
        PointField,
        encode_imu,
        encode_odometry,
        encode_pointcloud2,
    )

    w = BagWriter(path)
    accel, gyro = tr["accel"].cpu().numpy(), tr["gyro"].cpu().numpy()
    n_imu = len(tr["imu_t"]) if imu_n is None else imu_n
    for i in range(n_imu):
        t = tr["imu_t"][i]
        w.write(IO_TOPICS["imu"], "sensor_msgs/Imu", t, encode_imu(t, accel[i], gyro[i]))
    quat = [0.0, 0.0, 0.0, 1.0]
    for t, p in zip(tr["odo_t"], tr["odo_pos"]):
        w.write(IO_TOPICS["odom"], "nav_msgs/Odometry", t, encode_odometry(t, p, quat))
    n_pts = 0
    if with_points:
        fields = [PointField(*f) for f in OUSTER_FIELDS]
        ring = tr["ring"].cpu().numpy()
        for t, xyz in zip(tr["scan_t"], tr["points"].cpu().numpy()):
            w.write(IO_TOPICS["lidar"], "sensor_msgs/PointCloud2", t,
                    encode_pointcloud2(t, ouster_blob(xyz, ring), OUSTER_STEP, fields))
            n_pts += 1
    w.close(compression=compression)
    return {"imu": n_imu, "odom": len(tr["odo_t"]), "lidar": n_pts}


def phase_io_bag(dev, args, tmp: str, name_power: str) -> dict:
    """15a: write the traversal's bag, time info and the three extractions
    (native runtime required), then label the extracted streams on the card
    and hold them equal to phase 10's arrays fed directly."""
    from mlis_tpu_torch.core.bag import (
        BagReader,
        extract_imu,
        extract_odometry_tum,
        extract_pointclouds,
    )
    from mlis_tpu_torch.gating.floor_detector import IMUFloorDetector
    from mlis_tpu_torch.gating.lidar_floor_tracker import LiDARFloorTracker
    from mlis_tpu_torch.runtime.native import native_available

    t0 = time.perf_counter()
    if not native_available():
        raise AssertionError("15a: the native runtime did not build (g++ -O3 -shared)")
    tr = io_traversal(dev, args)
    n_io = len(tr["scan_t"])
    path = os.path.join(tmp, "traversal.bag")
    free = shutil.disk_usage(tmp).free
    tw = time.perf_counter()
    written = write_io_bag(path, tr)
    size = os.path.getsize(path)
    log("15a bag written", t0, path_fs_free_bytes=free, bag_bytes=size,
        write_s=f"{time.perf_counter() - tw:.3f}", messages=json.dumps(written),
        reduced=json.dumps(f"{n_io} of the traversal's 12,000 OS-128 scans (scans "
                           f"{tr['first_scan']}-{tr['first_scan'] + n_io - 1} of phase 10's "
                           f"bag, around its first ride)"), gpu=json.dumps(name_power))

    rates = {}

    def timed(name, fn, messages):
        t1 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t1
        rates[name] = dt
        print(f"  15a {name} s={dt:.4f} MB_per_s={size / dt / 1e6:.1f} "
              f"messages_per_s={messages / dt:.1f} messages={messages}", flush=True)
        return out

    info = timed("info", lambda: BagReader(path).info(), sum(written.values()))
    imu = timed("extract_imu", lambda: extract_imu(path), written["imu"])
    tum = timed("extract_odometry_tum", lambda: extract_odometry_tum(path, [IO_TOPICS["odom"]]),
                written["odom"])
    scans = timed("extract_pointclouds", lambda: list(extract_pointclouds(path)), written["lidar"])
    if info["message_counts"] != {IO_TOPICS[k]: v for k, v in written.items()}:
        raise AssertionError(f"15a info: {info['message_counts']} vs written {written}")
    accel, gyro = tr["accel"].cpu().numpy(), tr["gyro"].cpu().numpy()
    if not (np.array_equal(imu[0], tr["imu_t"]) and np.array_equal(imu[1], accel)
            and np.array_equal(imu[2], gyro)):
        raise AssertionError("15a: the bag's IMU stream differs from phase 10's arrays")
    if not (np.array_equal(tum[:, 0], tr["odo_t"]) and np.array_equal(tum[:, 1:4], tr["odo_pos"])):
        raise AssertionError("15a: the bag's odometry differs from the written track")
    pts = np.stack([xyz for _, xyz, _ in scans])
    rings = np.stack([r for _, _, r in scans])
    if not (np.array_equal(pts, tr["points"].cpu().numpy()) and
            (rings == tr["ring"].cpu().numpy()[None]).all()):
        raise AssertionError("15a: the bag's point clouds differ from phase 10's scans")

    # labels from the bag against phase 10's arrays fed directly, on the card
    def label(t, a, points, ring_ids, stamps):
        sync(dev)
        t1 = time.perf_counter()
        det = IMUFloorDetector(device=dev)
        events = det.detect_elevator_events(t, a[:, 0], a[:, 1], a[:, 2])
        labels = det.assign_floor_labels(tr["odo_t"], start_floor=START_FLOOR)
        ests = LiDARFloorTracker(device=dev).process_scans(points, stamps, ring_ids,
                                                           uniforms=tr["uniforms"])
        sync(dev)
        return events, labels, ests, time.perf_counter() - t1

    reset_launch_counts()
    direct = label(tr["imu_t"], tr["accel"].float(), tr["points"],
                   tr["ring"].expand(n_io, -1), tr["scan_t"])
    from_bag = label(imu[0], torch.as_tensor(imu[1], device=dev).float(),
                     torch.as_tensor(pts, device=dev), torch.as_tensor(rings, device=dev),
                     np.asarray([s for s, _, _ in scans]))
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"15a labelling launched a kernel: {counts}")
    ev = lambda e: [(x.start_idx, x.end_idx, x.direction, x.start_time, x.end_time) for x in e]
    fe = lambda e: [(x.timestamp, x.z_height, x.floor_number, x.confidence, x.num_ground_points)
                    for x in e]
    if ev(direct[0]) != ev(from_bag[0]) or not np.array_equal(direct[1], from_bag[1]) or \
            fe(direct[2]) != fe(from_bag[2]):
        raise AssertionError("15a: labels from the bag differ from phase 10's arrays")
    check_events(direct[0], [(a + ROS_EPOCH, b + ROS_EPOCH, r) for a, b, r in tr["rides"]],
                 "15a IMU")
    floors = [e.floor_number for e in from_bag[2]]
    if len(set(floors)) != 2:
        raise AssertionError(f"15a: the 30 s of scans should hold one ride, floors {set(floors)}")
    io_s = rates["extract_imu"] + rates["extract_odometry_tum"] + rates["extract_pointclouds"]
    span_imu = tr["imu_t"][-1] - tr["imu_t"][0]
    log("15a bag io", t0, bag_bytes=size, io_s=f"{io_s:.4f}", labelling_s=f"{from_bag[3]:.4f}",
        labelling_direct_s=f"{direct[3]:.4f}", recording_s_imu_odom=f"{span_imu:.1f}",
        recording_s_scans=f"{n_io / LIDAR_RATE:.1f}",
        io_share_of_recording=f"{io_s / span_imu:.5f}", events=len(from_bag[0]),
        labels_equal=True, planes_equal=True, native_available=True)
    return {"path": path, "tum": tum, "imu": imu, "traversal": tr, "bytes": size,
            "seconds": rates}


def phase_io_codecs(tmp: str, tr: dict) -> None:
    """15b: ~64 MB of IMU and odometry records through lz4 and bz2 chunks."""
    from mlis_tpu_torch.core import lz4f
    from mlis_tpu_torch.core.bag import BagReader

    t0 = time.perf_counter()
    plain = os.path.join(tmp, "codec_none.bag")
    write_io_bag(plain, tr, imu_n=CODEC_IMU, with_points=False)
    want = [(m.topic, m.timestamp, m.data) for m in BagReader(plain).read_messages()]
    raw = os.path.getsize(plain)
    for comp in ("lz4", "bz2"):
        p = os.path.join(tmp, f"codec_{comp}.bag")
        t1 = time.perf_counter()
        write_io_bag(p, tr, imu_n=CODEC_IMU, with_points=False, compression=comp)
        wt = time.perf_counter() - t1
        t1 = time.perf_counter()
        got = [(m.topic, m.timestamp, m.data) for m in BagReader(p).read_messages()]
        rt = time.perf_counter() - t1
        if got != want:
            raise AssertionError(f"15b {comp}: messages differ after the round trip")
        print(f"  15b {comp} raw_bytes={raw} bag_bytes={os.path.getsize(p)} write_s={wt:.4f} "
              f"read_s={rt:.4f} read_MB_per_s={raw / rt / 1e6:.1f} messages={len(got)}", flush=True)
        os.remove(p)
    os.remove(plain)
    log("15b codecs", t0, lz4_block_codec=("liblz4" if lz4f._LIB is not None
                                           else "pure-Python decoder, stored blocks"),
        messages_equal=True)


def run_cli(main, argv) -> tuple:
    """(exit code, stdout, seconds) of an in-process CLI call."""
    buf = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t1


def phase_io_cli(dev, args, tmp: str, bag: dict) -> dict:
    """15c: the CLI entry points in-process on the card: bag info /
    odom-tum / imu-plot on 15a's bag, the pipeline on its TUM file and a
    whitespace IMU table, fullgate with MixVPR and with CricaVPR, stream,
    calib generate, and all over phase 11's traversal (every launch counter
    set to 0 before each call and read after it)."""
    import importlib.util

    from mlis_tpu_torch import cli
    from mlis_tpu_torch.core.calibration import sample_kalibr_yaml
    from mlis_tpu_torch.gating.pipeline import SemanticGatingPipeline
    from mlis_tpu_torch.gating.pipeline import main as pipeline_main

    t0 = time.perf_counter()
    d = dev.type
    launches = {}
    # host libraries the figures (matplotlib) and the Kalibr loaders (yaml)
    # need; the card's machine may lack them and nothing may be installed
    absent = {m for m in ("matplotlib", "yaml") if importlib.util.find_spec(m) is None}
    print(f"  15c not installed on this machine: {sorted(absent) or 'none'}", flush=True)

    def refused(name, module, fn):
        """Without ``module`` a subcommand must raise ModuleNotFoundError
        naming it (and is reported as not run), never pass silently."""
        try:
            fn()
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
            print(f"  15c {name}: not run on this machine ({module} is not installed)",
                  flush=True)
            return
        raise AssertionError(f"15c {name} ran without {module}")

    def call(name, main, argv, expect=None):
        reset_launch_counts()
        rc, out, sec = run_cli(main, argv)
        sync(dev)
        counts = launch_counts()
        launches[name] = counts
        print(f"  15c {name} rc={rc} s={sec:.4f} launches="
              f"{json.dumps(counts, separators=(',', ':'))}", flush=True)
        if rc != 0:
            raise AssertionError(f"15c {name}: exit code {rc}\n{out[-2000:]}")
        want = {"tri_count": 0, "flash_attention": 0, "dense_attention": 0, **(expect or {})}
        if d == "cuda" and any(counts[k] != v for k, v in want.items() if v is not None):
            raise AssertionError(f"15c {name}: launches {counts}, expected {want}")
        return out, counts

    def nonempty(*paths):
        for p in paths:
            if not os.path.exists(p) or os.path.getsize(p) == 0:
                raise AssertionError(f"15c: {p} missing or empty")

    out, _ = call("bag info", cli.main, ["bag", "info", bag["path"]])
    if json.loads(out)["message_counts"][IO_TOPICS["lidar"]] != args.io_scans:
        raise AssertionError("15c bag info: wrong scan count")
    tum = os.path.join(tmp, "trajectory.txt")
    call("bag odom-tum", cli.main, ["bag", "odom-tum", bag["path"], "--output", tum])
    fig = os.path.join(tmp, "imu_elevator_detection.png")
    imu_plot = ["bag", "imu-plot", bag["path"], "--output", fig, "--device", d]
    if "matplotlib" in absent:
        refused("bag imu-plot", "matplotlib", lambda: run_cli(cli.main, imu_plot))
    else:
        out, _ = call("bag imu-plot", cli.main, imu_plot)
        nonempty(fig)
        if not out.startswith(f"{len(RIDES)} elevator event(s)"):
            raise AssertionError(f"15c bag imu-plot: {out}")

    # the pipeline on the bag's TUM file and a whitespace IMU table (a CSV
    # from bag imu-csv carries a header that load_imu_data refuses)
    imu_txt = os.path.join(tmp, "imu.txt")
    t, a, g = bag["imu"]
    np.savetxt(imu_txt, np.column_stack([t, a, g]))
    pipe_out = os.path.join(tmp, "pipeline")
    pipe_argv = ["--trajectory", tum, "--imu", imu_txt, "--output", pipe_out, "--device", d]
    if "matplotlib" in absent:
        # main's steps up to its figures, through the same API calls
        reset_launch_counts()
        t1 = time.perf_counter()
        pipe = SemanticGatingPipeline(output_dir=pipe_out, device=d)
        pipe.load_trajectory(tum)
        pipe.load_imu_data(imu_txt)
        pipe.detect_floors()
        out = pipe.generate_report()
        sync(dev)
        launches["pipeline"] = launch_counts()
        print(f"  15c pipeline (main's steps before its figures) s={time.perf_counter() - t1:.4f} "
              f"launches={json.dumps(launches['pipeline'], separators=(',', ':'))}", flush=True)
        refused("pipeline", "matplotlib", lambda: run_cli(pipeline_main, pipe_argv))
    else:
        out, _ = call("pipeline", pipeline_main, pipe_argv)
        nonempty(os.path.join(pipe_out, "pipeline_floor_segmentation.png"),
                 os.path.join(pipe_out, "pipeline_3d_multifloor.png"))
    if f"Elevator events: {len(RIDES)}" not in out or f"Trajectory poses: {ODOM_MESSAGES}" not in out:
        raise AssertionError(f"15c pipeline report: {out[-600:]}")

    gates = {}
    for vpr, expect in (("mixvpr", {"flash_attention": None}),
                        ("cricavpr", {"flash_attention": None, "dense_attention": None})):
        with patched(cli, "fullgate_scene", n=args.io_fullgate_frames):
            out, counts = call(f"fullgate {vpr}", cli.main,
                               ["fullgate", "--vpr", vpr, "--device", d], expect)
        summ = json.loads(out)
        gates[vpr] = {**counts, "pairs_per_sec": summ["pairs_per_sec"],
                      "total_pairs": summ["total_pairs"], "verified": summ["verified"],
                      "geometrically_valid": summ["geometrically_valid"]}
        print(f"  15c fullgate {vpr} " + " ".join(f"{k}={v}" for k, v in gates[vpr].items()),
              flush=True)
        if summ["total_pairs"] <= 0 or summ["verified"] <= 0:
            raise AssertionError(f"15c fullgate {vpr}: {summ}")
    if d == "cuda" and gates["cricavpr"]["dense_attention"] < 1:
        raise AssertionError("15c fullgate --vpr cricavpr did not launch the dense kernel")

    out, _ = call("stream", cli.main, ["stream", "--device", d])
    st = json.loads(out)
    if st["accepted_pairs"] < st["planted_same_floor_revisits"] // 2 or \
            st["stats"]["rejected_cross_floor"] < 1:
        raise AssertionError(f"15c stream: {st}")
    cams, cam_imu, imu_y = (os.path.join(tmp, f) for f in ("cams.yaml", "cam_imu.yaml",
                                                             "imu.yaml"))
    sample_kalibr_yaml(cams)
    with open(cam_imu, "w") as f:
        f.write("cam0:\n  T_cam_imu:\n  - [0.0, -1.0, 0.0, 0.05]\n  - [0.0, 0.0, -1.0, -0.03]\n"
                "  - [1.0, 0.0, 0.0, 0.02]\n  - [0.0, 0.0, 0.0, 1.0]\n")
    with open(imu_y, "w") as f:
        f.write("imu0:\n  update_rate: 200.0\n")
    cfg_dir = os.path.join(tmp, "configs")
    generate = ["calib", "generate", "--cameras", cams, "--cam-imu", cam_imu, "--imu", imu_y,
                "--left", "cam0", "--right", "cam1", "--output", cfg_dir]
    if "yaml" in absent:
        sample = os.path.join(cfg_dir, "sample.yaml")  # the one format that reads no YAML
        call("calib sample", cli.main, ["calib", "sample", "--output", sample])
        nonempty(sample)
        refused("calib generate", "yaml", lambda: run_cli(cli.main, generate))
    else:
        call("calib generate", cli.main, generate)
        nonempty(*(os.path.join(cfg_dir, f) for f in ("orbslam3.yaml", "vins_fusion.yaml",
                                                      "basalt.json", "lego_loam.yaml")))

    # all: phase 11's LeGO-LOAM-size traversal, its orb_slam3 copy and a
    # droid_slam copy at half rate and half scale
    from mlis_tpu_torch.core.trajectory import Trajectory

    root = os.path.join(tmp, "trajectories")
    seqs = lego_traversal()
    write_tree(root, "lego_loam", seqs)
    write_tree(root, "orb_slam3", orb_copy(seqs))
    write_tree(root, "droid_slam", [(n, f, Trajectory(tr.timestamps[::2], 0.5 * tr.positions[::2],
                                                       tr.quaternions[::2])) for n, f, tr in seqs])
    out_all = os.path.join(tmp, "all")
    all_argv = ["all", "--trajectory-root", root, "--output", out_all, "--device", d]
    if "matplotlib" in absent:
        # all's gating and evaluation without its figures: the gate and
        # evaluate subcommands over the same tree (three K1 launches)
        call("gate", cli.main, ["gate", "--trajectory-root", root, "--output", out_all,
                                "--device", d], {"tri_count": 3})
        call("evaluate", cli.main, ["evaluate", "--trajectory-root", root, "--output", out_all])
        refused("all (the subcommand)", "matplotlib", lambda: run_cli(cli.main, all_argv))
        nonempty(os.path.join(out_all, "semantic_gating_metrics.json"),
                 os.path.join(out_all, "final_evaluation.json"))
    else:
        call("all", cli.main, all_argv, {"tri_count": 3})
        check_all_outputs(out_all)
    via = "gate" if "matplotlib" in absent else "all"
    total = {k: sum(c[k] for c in launches.values()) for k in launches[via]}
    log("15c cli", t0, launches=json.dumps(total, separators=(",", ":")),
        pipeline_K1=launches["pipeline"]["tri_count"], **{f"{via}_K1": launches[via]["tri_count"]},
        not_installed=",".join(sorted(absent)) or "none")
    return {"launches": launches, "fullgate": gates, "k1_via": via}


def check_all_outputs(out_all: str) -> None:
    """Every figure and artifact of the ``all`` subcommand, not empty."""
    figs = os.path.join(out_all, "figures")
    names = ["figure6.png", "figure7.png", "rpe_boxplot.png", "paper_comparison.png",
             "all_floors_overview.png", "trajectory_3d.html",
             *(f"trajectory_2d_{n}.png" for n, *_ in LEGO_FLOORS)]
    paths = [os.path.join(figs, f) for f in names]
    paths += [os.path.join(out_all, "semantic_gating", f"{a}_{k}.png")
              for a in ("orb_slam3", "droid_slam", "lego_loam")
              for k in ("floor_segmentation", "3d_multifloor", "loop_closure_gating")]
    paths += [os.path.join(out_all, "metrics", "table_iv.csv"),
              os.path.join(out_all, "BENCHMARK_RESULTS_SUMMARY.md")]
    for p in paths:
        if not os.path.exists(p) or os.path.getsize(p) == 0:
            raise AssertionError(f"15c all: {p} missing or empty")


def phase_roofline(main_path: dict, name_power: str) -> None:
    """15d: utils.roofline over phase 3's profiled stage spans (device
    seconds of each stage range at the bench protocol)."""
    from mlis_tpu_torch.utils import roofline as rl

    spans = main_path["spans"]
    if not spans:
        print("  15d roofline: no profiled spans (phase 3 profiles on the card only)", flush=True)
        return
    n, (H, W) = main_path["keyframes"], main_path["hw"]
    h8, w8 = (H // 8) * 8, (W // 8) * 8
    in_h, in_w = main_path["vpr_input"]
    D, k, M = main_path["descriptor_dim"], main_path["top_k"], max(main_path["verified"], 1)
    K = main_path["match_top_k"] or main_path["max_keypoints"]
    cfg, hyp = main_path["matcher"], main_path["hypotheses"]
    stages = [
        # gate.detect runs the grayscale resize and SuperPoint
        rl.StageRoofline("detect", spans["gate.detect"],
                         n * h8 * w8 * 10.0 + n * rl.superpoint_flops(h8, w8),
                         rl.grayscale_bytes(n, H, W, h8, w8)
                         + rl.superpoint_bytes(n, h8, w8, max_keypoints=main_path["max_keypoints"])),
        rl.StageRoofline("encode", spans["gate.encode"], n * rl.resnet50_stage3_flops(in_h, in_w),
                         rl.resnet50_stage3_bytes(n, in_h, in_w)
                         + n * (H * W + in_h * in_w * 3 * 4.0)),
        rl.StageRoofline("retrieve", spans["gate.retrieval"], rl.retrieval_flops(n, D),
                         rl.retrieval_bytes(n, D, k)),
        rl.StageRoofline("match", spans["lightglue.match"],
                         M * rl.matcher_flops(K, cfg.dim, cfg.depth),
                         rl.matcher_stage_bytes(M, K, cfg.dim, cfg.depth, cfg.num_heads)),
        rl.StageRoofline("ransac", spans["epipolar.ransac"], rl.ransac_flops(M, K, hyp),
                         rl.ransac_bytes(M, K, hyp)),
    ]
    print(f"  15d roofline (phase 3: {n} keyframes at {H}x{W}, MixVPR {in_h}x{in_w} D={D}, "
          f"{M} verified pairs x {K} keypoints, {hyp} hypotheses; gpu {name_power}; peaks "
          f"{rl.H100_PEAK_BF16:.4g} FLOP/s bf16, {rl.H100_HBM_BYTES_PER_S:.4g} B/s)", flush=True)
    for line in rl.format_table(stages).splitlines():
        print("  15d " + line, flush=True)
    for st in stages:
        bound_s = max(st.flops / rl.H100_PEAK_BF16, st.bytes / rl.H100_HBM_BYTES_PER_S)
        print(f"  15d {st.name} device_s={st.seconds:.6f} bound_s={bound_s:.6f} "
              f"flops={st.flops:.6g} bytes={st.bytes:.6g} "
              + " ".join(f"{k}={v}" for k, v in st.row().items()), flush=True)
    log("15d roofline", time.perf_counter(), stages=len(stages),
        stage_device_s=f"{sum(st.seconds for st in stages):.4f}",
        gate_wall_s=f"{main_path['wall_s']:.4f}")


def phase_io(dev, args, main_path: dict) -> dict:
    """Phase 15, under inference mode, in a temporary directory: the bag
    (15a), the codecs (15b), the CLI entry points (15c), the roofline (15d)."""
    import tempfile

    name_power = gpu_name_and_power() if dev.type == "cuda" else "cpu rehearsal"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mlis_phase15_") as tmp:
        bag = phase_io_bag(dev, args, tmp, name_power)
        phase_io_codecs(tmp, bag["traversal"])
        del bag["traversal"]
        out = phase_io_cli(dev, args, tmp, bag)
    phase_roofline(main_path, name_power)
    log("15 io", t0, gpu=json.dumps(name_power))
    return out


# -- phase 16: the budget paths of FullGatePipeline.process, the experiment twins ----

UPLOAD_CHUNK = 32  # bench.py's keyword, passed to show that it changes nothing
# one_fetch_host: the one-fetch path on host keyframes, uploaded once
GATE_PATHS = ("exact", "budgeted", "one_fetch", "one_fetch_host")
# the methods whose calls show which path process took; ``_fetch`` is the
# one packed fetch of the results (the matcher and RANSAC still synchronise
# inside a fused call: 16a prints every path's synchronisations)
PATH_METHODS = ("_verify_survivors", "_verify_compacted", "_verify_slots",
                "_detect_encode_once", "_fetch")
# 16a's decisions across paths on the same draws: the shipped bf16 models'
# band of phase 7 (QUALITY_BANDS); the gate's verifier applies no confident cut
GATE_PATH_BANDS = dict(conf_band=3, inlier_band=3, bound_inliers=False, confident_cut=None)
# 16e: each twin at one seed (loftr_heldout at its held-out seed 4)
TWIN_RUNS = (("v2_scoreboard", ["--seeds", "0"]), ("encoder_rows", ["--seeds", "0"]),
             ("encoder_intervention", ["--seeds", "0"]), ("rerank_quality", ["--seeds", "0"]),
             ("superglue_cut", ["--seeds", "0", "--select-seeds", "0"]),
             ("loftr_heldout", ["--seeds", "4"]), ("fullres_matcher_quality", ["0"]),
             ("fullres_pruning_quality", ["0"]))


@contextlib.contextmanager
def counting_calls(pipe):
    """Count calls of ``pipe``'s PATH_METHODS while the block runs."""
    calls = dict.fromkeys(PATH_METHODS, 0)
    for name in PATH_METHODS:
        def wrapped(*a, _orig=getattr(pipe, name), _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        setattr(pipe, name, wrapped)
    try:
        yield calls
    finally:
        for name in PATH_METHODS:
            delattr(pipe, name)


def expected_calls(path: str, overflow: bool = False) -> dict:
    want = dict.fromkeys(PATH_METHODS, 0)
    want["_verify_survivors"] = int(path == "exact" or overflow)
    if path != "exact":
        want["_fetch"] = 1
        want["_verify_compacted" if path == "budgeted" else "_verify_slots"] = 1
    if path.startswith("one_fetch"):
        want["_detect_encode_once"] = 1
    return want


def run_gate_path(pipe, path: str, inputs, images_dev, budget, **kw):
    """``pipe.process`` as each path takes it: host keyframes for the exact,
    budgeted and one_fetch_host paths, the frames already on the card for
    the one-fetch path; bench.py's keywords."""
    images, timestamps, floors, K = inputs
    pipe.spr.vpr.descriptors = []
    if hasattr(pipe.spr.vpr, "patch_cache"):
        pipe.spr.vpr.patch_cache = []
    if path == "exact":
        return pipe.process(images, timestamps, floors, K, encode_batch_size=128, **kw)
    return pipe.process(images_dev if path == "one_fetch" else images, timestamps, floors, K,
                        encode_batch_size=128, survivor_budget=budget,
                        monolithic=path != "budgeted", upload_chunk=UPLOAD_CHUNK, **kw)


def gate_pairs(res) -> dict:
    """A FullGateResult in the harness's ``pairs`` form, for decision_drift."""
    return {"total_candidates": res.total_pairs, "verified": res.verified, "pairs": [
        {"q": r.query_idx, "m": r.match_idx, "is_valid": r.is_valid,
         "num_inliers": r.num_inliers, "inlier_ratio": r.inlier_ratio,
         "num_confident_matches": r.num_confident_matches} for r in res.results]}


def check_same_gate(what: str, res, ref) -> None:
    got = (res.total_pairs, res.cross_floor_rejected, res.verified)
    want = (ref.total_pairs, ref.cross_floor_rejected, ref.verified)
    if got != want:
        raise AssertionError(f"{what}: (total, rejected, verified) {got} != the exact path's {want}")
    if [(r.query_idx, r.match_idx) for r in res.results] != \
            [(r.query_idx, r.match_idx) for r in ref.results]:
        raise AssertionError(f"{what}: verified pairs differ from the exact path's")


def count_syncs(dev, run) -> tuple:
    """Host synchronisations of the card during ``run()``, as
    torch.cuda.set_sync_debug_mode("warn") reports them: (the count, the
    count by the source line of the port that asked)."""
    import warnings
    from collections import Counter

    if dev.type != "cuda":
        return -1, {}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in seen
                    if "synchroniz" in str(w.message))
    return sum(sites.values()), dict(sites.most_common())


def phase_gate_paths(dev, args) -> dict:
    """16a: bench.py's gate (phase 3's pipeline and keyframes) down each
    path of ``process``, with the call counts that show the path taken,
    decisions against the exact path's on the same draws, pairs/s, kernel
    time, busy share, syncs and peak memory, then an overflow and an empty
    gate."""
    t0 = time.perf_counter()
    inputs = keyframes(args.keyframes)
    n = len(inputs[0])
    pipe = build_pipeline(dev, torch.bfloat16)
    images_dev = torch.as_tensor(inputs[0], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    probe = run_gate_path(pipe, "exact", inputs, images_dev, None, generator=gen)
    budget = probe.verified
    k = min(pipe.top_k, n)
    slots = {"exact": budget, "budgeted": min(budget, n * k),
             "one_fetch": min(budget_slots(budget), n * k)}
    slots["one_fetch_host"] = slots["one_fetch"]
    draws = torch.rand((slots["one_fetch"], 512, 8), generator=gen, device=dev)
    log("16a setup", t0, keyframes=n, budget=budget, slots=json.dumps(slots),
        upload_chunk=UPLOAD_CHUNK)

    ref, out, first = None, {}, {}
    for path in GATE_PATHS:
        t0 = time.perf_counter()
        with counting_calls(pipe) as calls:
            res = run_gate_path(pipe, path, inputs, images_dev, budget,
                                ransac_uniforms=draws[: slots[path]])
        first[path] = res
        if calls != expected_calls(path):
            raise AssertionError(f"16a {path}: calls {calls}, expected {expected_calls(path)}")
        if ref is None:
            ref = res
        else:
            check_same_gate(f"16a {path}", res, ref)
            compare_decisions(gate_pairs(res), gate_pairs(ref), GATE_PATH_BANDS,
                              f"16a {path} vs exact, same draws")
        if path == "one_fetch_host":
            same = sum(a == b for a, b in zip(gate_pairs(res)["pairs"],
                                              gate_pairs(first["one_fetch"])["pairs"]))
            print(f"  16a one_fetch_host vs one_fetch, same draws: {same} of {res.verified} "
                  "pairs identical", flush=True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(TIMED_REPS + 1):  # the first is the warm-up
            t1 = time.perf_counter()
            r = run_gate_path(pipe, path, inputs, images_dev, budget, generator=gen)
            sync(dev)
            walls.append(time.perf_counter() - t1)
            check_same_gate(f"16a {path} timed", r, ref)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        best = min(walls[1:])
        if dev.type == "cuda":
            profile_run(dev, lambda: run_gate_path(pipe, path, inputs, images_dev, budget,
                                                   generator=gen), best)
        syncs, sync_sites = count_syncs(dev, lambda: run_gate_path(
            pipe, path, inputs, images_dev, budget, generator=gen))
        out[path] = {"pairs_per_s": ref.total_pairs / best, "walls": walls[1:]}
        log(f"16a {path}", t0, candidates=res.total_pairs, floor_rejected=res.cross_floor_rejected,
            verified=res.verified, accepted=res.geometrically_valid,
            pairs_per_s=f"{ref.total_pairs / best:.1f}",
            walls=",".join(f"{w:.4f}" for w in walls[1:]), syncs=syncs, peak_mem_bytes=peak,
            calls=json.dumps({k: v for k, v in calls.items() if v}, separators=(",", ":")))
        if sync_sites:
            print(f"  16a {path} syncs by site: " + json.dumps(sync_sites), flush=True)

    # overflow: a budget of 1 (16 slots on the monolithic paths) reruns exact
    t0 = time.perf_counter()
    # the monolithic paths' 16 slots overflow only above 16 survivors
    for path in ("budgeted", "one_fetch") if budget > budget_slots(1) else ("budgeted",):
        with counting_calls(pipe) as calls:
            res = run_gate_path(pipe, path, inputs, images_dev, 1,
                                generator=torch.Generator(device=dev).manual_seed(1))
        want = expected_calls(path, overflow=True)
        if calls != want:
            raise AssertionError(f"16a {path} budget 1: calls {calls}, expected {want}")
        check_same_gate(f"16a {path} budget 1", res, ref)
    # nothing above any similarity: the one-fetch path's empty result
    pipe.similarity_threshold = 2.0
    try:
        with counting_calls(pipe) as calls:
            empty = run_gate_path(pipe, "one_fetch", inputs, images_dev, budget)
    finally:
        pipe.similarity_threshold = 0.3
    if (empty.total_pairs, empty.verified, calls["_verify_survivors"]) != (0, 0, 0):
        raise AssertionError(f"16a threshold 2.0: {empty.summary()}, calls {calls}")
    log("16a overflow and empty", t0, overflow_reruns=1 + (budget > budget_slots(1)),
        empty_total=empty.total_pairs)
    return out


def drive_one_fetch(phase: str, dev, pipe, inputs, expected_launches) -> dict:
    """An exact run for the budget, then the one-fetch path (frames on the
    card) once checked against it and TIMED_REPS timed after a warm-up,
    every launch counter set to 0 before each run."""
    images, timestamps, floors, K = inputs
    n = len(images)
    images_dev = torch.as_tensor(images, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ref = run_gate_path(pipe, "exact", inputs, images_dev, None, generator=gen)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for rep in range(TIMED_REPS + 1):
        reset_launch_counts()
        with counting_calls(pipe) as calls:
            t0 = time.perf_counter()
            res = run_gate_path(pipe, "one_fetch", inputs, images_dev, ref.verified,
                                generator=gen)
            sync(dev)
            wall = time.perf_counter() - t0
        counts = launch_counts()
        if calls != expected_calls("one_fetch"):
            raise AssertionError(f"{phase}: calls {calls}")
        check_same_gate(phase, res, ref)
        if dev.type == "cuda" and counts != expected_launches:
            raise AssertionError(f"{phase}: kernel launches {counts}, expected {expected_launches}")
        if rep:
            walls.append(wall)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    slots = min(budget_slots(ref.verified), n * min(pipe.top_k, n))
    log(f"{phase} one-fetch", time.perf_counter(), candidates=res.total_pairs,
        verified=res.verified, slots=slots, accepted=res.geometrically_valid,
        pairs_per_s=f"{res.total_pairs / min(walls):.1f}",
        walls=",".join(f"{w:.4f}" for w in walls),
        exact_pairs_per_s=f"{ref.total_pairs / ref.elapsed_s:.1f}", peak_mem_bytes=peak,
        launches_per_run=json.dumps(counts, separators=(",", ":")))
    return counts


def phase_one_fetch_a(dev, args) -> dict:
    """16b: path A's CricaVPR (ViT-B/14 at 322) through the one-fetch path:
    one encode call over every keyframe, each block's attention one launch
    of the dense kernel; one fused call over every slot, 2 x depth flash
    launches."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.weights import default_matcher_checkpoint

    t0 = time.perf_counter()
    inputs = keyframes(args.keyframes)
    matcher = LightGlue.from_checkpoint(
        default_matcher_checkpoint(), sp_cfg=SuperPointConfig(max_keypoints=1024), device=dev)
    spr = SemanticPlaceRecognition("cricavpr", similarity_threshold=0.3, min_time_gap=10.0,
                                   device=dev)
    pipe = FullGatePipeline(vpr=spr, verifier=GeometricVerifier(matcher=matcher),
                            similarity_threshold=0.3, verify_batch=VERIFY_BATCH, match_top_k=512,
                            matcher_weights=None, num_hypotheses=512, device=dev)
    log("16b setup", t0, keyframes=len(inputs[0]), vpr="cricavpr", encode_calls=1)
    return drive_one_fetch("16b", dev, pipe, inputs,
                           {"tri_count": 0, "flash_attention": 2 * matcher.cfg.depth,
                            "dense_attention": 12})


def phase_one_fetch_b(dev, args) -> dict:
    """16c: path B (540x720, 2048 keypoints all matched, the fullres
    LightGlue) through the one-fetch path: one fused call over every slot,
    2 x depth flash launches."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue
    from mlis_tpu_torch.models.resnet import ResNetConfig
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.weights import default_fullres_matcher_checkpoint

    t0 = time.perf_counter()
    inputs = keyframes(args.keyframes, 540, 720, cell=16)
    matcher = LightGlue.from_checkpoint(default_fullres_matcher_checkpoint(),
                                        sp_cfg=SuperPointConfig(max_keypoints=2048), device=dev)
    spr = SemanticPlaceRecognition("mixvpr", similarity_threshold=0.3, min_time_gap=10.0,
                                   device=dev,
                                   backbone_cfg=ResNetConfig(crop_stage=3, dtype=torch.bfloat16))
    pipe = FullGatePipeline(vpr=spr, verifier=GeometricVerifier(matcher=matcher),
                            similarity_threshold=0.3, verify_batch=VERIFY_BATCH, match_top_k=None,
                            matcher_weights=None, num_hypotheses=512, device=dev)
    log("16c setup", t0, keyframes=len(inputs[0]), resolution="540x720", detect=2048)
    return drive_one_fetch("16c", dev, pipe, inputs,
                           {"tri_count": 0, "dense_attention": 0,
                            "flash_attention": 2 * matcher.cfg.depth})


def _finite_json(obj, where: str) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _finite_json(v, f"{where}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _finite_json(v, f"{where}[{i}]")
    elif isinstance(obj, float) and not np.isfinite(obj):
        raise AssertionError(f"{where} = {obj}")


def twin_summary(d: dict) -> dict:
    """A twin's result in one line: its top-level numbers and, for a table
    of rows, each row's first number."""
    out = {}
    for k, v in d.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = v
        elif isinstance(v, dict) and v and all(isinstance(x, dict) for x in v.values()):
            out[k] = {name: next((x for x in row.values() if isinstance(x, (int, float))), None)
                      for name, row in v.items()}
    return out


def phase_twins(dev) -> None:
    """16e: each experiment twin's ``main`` at one seed on the card, its
    outputs in a temporary directory; superglue_cut only where its
    checkpoint is in the copy. One configuration runs twice, in two
    twins: fullres_matcher_quality's fullres_trained row and
    fullres_pruning_quality's match_top_k=1024 row (the harness's default
    weights at 540 rows are that checkpoint); with RANSAC's draws seeded
    from the scene's seed, the two must read the same."""
    import importlib
    import tempfile

    from mlis_tpu_torch.weights import shipped_checkpoint

    if dev.type != "cuda":
        print("  16e: the twins run on the card (tier-1 runs each at a small size: "
              "tests/test_torch_experiments.py)", flush=True)
        return
    lines = {}
    with tempfile.TemporaryDirectory(prefix="mlis_phase16_") as tmp:
        for name, argv in TWIN_RUNS:
            t0 = time.perf_counter()
            if name == "superglue_cut" and shipped_checkpoint("superglue_parallax.npz") is None:
                log(f"16e {name}", t0, run=False,
                    reason="superglue_parallax.npz is not in the copy")
                continue
            mod = importlib.import_module(f"mlis_tpu_torch.experiments.{name}")
            fullres = name.startswith("fullres")
            extra = ["--device", dev.type] + ([] if fullres else
                                              ["--out", os.path.join(tmp, f"{name}.json")])
            reset_launch_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = mod.main(argv + extra)
            if fullres:
                res = {"lines": [json.loads(x) for x in buf.getvalue().splitlines()
                                 if x.startswith("{")]}
                if len(res["lines"]) != 2:
                    raise AssertionError(f"16e {name}: {len(res['lines'])} JSON lines, expected 2")
                lines[name] = res["lines"]
                summary = {f"{x['seed']}_{x.get('ckpt', x.get('match_top_k'))}": x["f1"]
                           for x in res["lines"]}
            else:
                with open(os.path.join(tmp, f"{name}.json")) as f:
                    if json.load(f) != json.loads(json.dumps(res)):
                        raise AssertionError(f"16e {name}: the written JSON is not the result")
                summary = twin_summary(res)
            _finite_json(res, f"16e {name}")
            log(f"16e {name}", t0, run=True, argv=json.dumps(argv),
                summary=json.dumps(summary, separators=(",", ":")),
                launches=json.dumps(launch_counts(), separators=(",", ":")))
    first = next(x for x in lines["fullres_matcher_quality"] if x["ckpt"] == "fullres_trained")
    again = next(x for x in lines["fullres_pruning_quality"] if x["match_top_k"] == 1024)
    pairs = {k: [first[k], again[k]] for k in ("f1", "precision", "recall")}
    log("16e repeat", time.perf_counter(), seed=first["seed"],
        runs=json.dumps(pairs, separators=(",", ":")))
    if any(a != b for a, b in pairs.values()):
        raise AssertionError(f"16e: one configuration run twice reads {pairs}")


def phase_budget_paths(dev, args) -> dict:
    """Phase 16, under inference mode."""
    name_power = gpu_name_and_power() if dev.type == "cuda" else "cpu rehearsal"
    t0 = time.perf_counter()
    paths = phase_gate_paths(dev, args)
    crica = phase_one_fetch_a(dev, args)
    fullres = phase_one_fetch_b(dev, args)
    phase_twins(dev)
    log("16 budget paths", t0, gpu=json.dumps(name_power),
        pairs_per_s=json.dumps({p: round(v["pairs_per_s"], 1) for p, v in paths.items()}))
    return {"16b": crica, "16c": fullres}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--keyframes", type=int, default=128)
    ap.add_argument("--scans", type=int, default=LIDAR_SCANS,
                    help="LiDAR scans of phase 10 (at least 600, for the rides to fit)")
    ap.add_argument("--real-iters", type=int, nargs=2, default=[12, 1024],
                    metavar=("NUM_ITERS", "CG_ITERS"),
                    help="phase 11's run_pgo_real depth (default: the JAX package's 12 x 1024)")
    ap.add_argument("--train-depth", type=int, default=12,
                    help="phase 13d's ViT-B/14 depth (default: CricaVPR's 12)")
    ap.add_argument("--io-scans", type=int, default=IO_SCANS,
                    help="phase 15a's OS-128 scans in the bag (default 300, the 30 s around a ride)")
    ap.add_argument("--io-fullgate-frames", type=int, default=64,
                    help="phase 15c's fullgate scene (default the CLI's 64 keyframes at 540x720)")
    ap.add_argument("--demo-iters", type=int, nargs=2, default=[20, 256],
                    metavar=("NUM_ITERS", "CG_ITERS"),
                    help="the pgo CLI's depth in a CPU rehearsal (the card runs its defaults)")
    args = ap.parse_args()

    def _timeout(signum, frame):
        raise TimeoutError(f"chip_smoke exceeded its {BUDGET_S} s budget")

    signal.signal(signal.SIGALRM, _timeout)
    signal.alarm(BUDGET_S)
    t_all = time.perf_counter()
    dev = phase_device(args)
    with torch.inference_mode():
        phase_build(dev)
        k1 = phase_kernel_check(dev)
        attn = phase_attention_check(dev)
        main_path = phase_main_path(dev, args, k1["sweep_counts"])
        phase_card_vs_cpu(dev)
        path_a = phase_path_a(dev, args)
        path_b = phase_path_b(dev, args)
        quality = phase_quality(dev)
        phase_quality_card_vs_cpu(dev)
        path_c = phase_path_c(dev, args)
        path_d = phase_path_d(dev, args)
        floor_path = phase_floor_labelling(dev, args)
    # the solvers differentiate: outside inference mode
    backend = phase_backend(dev, args)
    with torch.inference_mode():
        families = phase_model_families(dev, args)
    # the trainer differentiates: phase 13 enters inference mode itself
    parallel = phase_parallel(dev, args)
    # the pretraining drivers differentiate too
    phase_pretrain(dev, args)
    with torch.inference_mode():
        io_path = phase_io(dev, args, main_path)
        budget_paths = phase_budget_paths(dev, args)
    signal.alarm(0)
    print(f"[total] {time.perf_counter() - t_all:.3f}s", flush=True)
    if dev.type != "cuda":
        print("cpu rehearsal finished: no device result", flush=True)
        return 0
    io_cli = {name.replace(" ", "_").replace("-", "_"): c
              for name, c in io_path["launches"].items()}
    io_cli_gates = [io_cli[n] for n in IO_GATES]
    kernels = [{
        "name": "tri_count",
        "route": "cuda",
        "source": "mlis_tpu_torch/csrc/pairwise.cu",
        "replaces": "mlis_tpu/ops/pairwise.py:138",
        # one run of each path that reaches it: phase 3's sweep, phase 10's
        # three, phase 11's three (the LeGO-scale count and the gate CLI's
        # two), phase 15's all CLI or, without matplotlib, its gate step (three)
        "launches": (main_path["launches"] + floor_path["launches"] + backend["launches"]
                     + io_cli[io_path["k1_via"]]["tri_count"]),
        "launches_by_path": {"3": main_path["launches"], "10": floor_path["launches"],
                             "11": backend["launches"],
                             f"15_{io_path['k1_via']}": io_cli[io_path["k1_via"]]["tri_count"]},
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the floor-split count
        "by_case": k1["by_case"],  # phase 2's other sizes, each with its bound
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "mlis_tpu_torch/csrc/attention.cu",
        "replaces": "mlis_tpu/ops/flash_attention.py:31, mlis_tpu/ops/flash_attention.py:80",
        # one gate run of each path that reaches it
        "launches": (path_a["flash_attention"] + path_b["flash_attention"]
                     + sum(c["flash_attention"] for c in path_c.values())
                     + path_d["flash_attention"] + sum(io_gate["flash_attention"]
                                                       for io_gate in io_cli_gates)
                     + budget_paths["16b"]["flash_attention"]
                     + budget_paths["16c"]["flash_attention"]),
        "launches_by_path": {"A": path_a["flash_attention"], "B": path_b["flash_attention"],
                             **{f"C_{m}": c["flash_attention"] for m, c in path_c.items()},
                             "D": path_d["flash_attention"],
                             **{f"15_{n}": io_cli[n]["flash_attention"] for n in IO_GATES},
                             "16b": budget_paths["16b"]["flash_attention"],
                             "16c": budget_paths["16c"]["flash_attention"]},
        **attn["flash_attention"],
    }, {
        "name": "dense_attention",
        "route": "cuda",
        "source": "mlis_tpu_torch/csrc/attention.cu",
        "replaces": "mlis_tpu/ops/attention.py:25, mlis_tpu/ops/attention.py:38",
        "launches": (path_a["dense_attention"] + quality["dense_attention"]
                     + families["dense_attention"] + parallel["dense_attention"]
                     + sum(io_gate["dense_attention"] for io_gate in io_cli_gates)
                     + budget_paths["16b"]["dense_attention"]),
        "launches_by_path": {"A": path_a["dense_attention"],
                             "quality2_cricavpr_rows": quality["dense_attention"],
                             "12": families["dense_attention"],
                             "13": parallel["dense_attention"],
                             **{f"15_{n}": io_cli[n]["dense_attention"] for n in IO_GATES},
                             "16b": budget_paths["16b"]["dense_attention"]},
        **attn["dense_attention"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
