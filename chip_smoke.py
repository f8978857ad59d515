#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mlis_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                  # the check, on CUDA device 0
    python3 chip_smoke.py --device cpu --keyframes 16
                                           # rehearsal of every phase on the CPU

Phases, one line each as they end:

0. device: card name and power limit, TF32 settings, stale build lock;
1. build: one nvcc call over mlis_tpu_torch/csrc/*.cu (ptxas report);
2. kernel K1 (the candidate sweep) against its plain PyTorch version on
   the card: the 19,163-pose cloud, a clustered cloud with pairs at r and
   r +- 1e-9, and that cloud again through the full tile grid (the launch
   of the JAX package's full-grid kernel K6); counts must be identical;
3. the main path as bench.py's default mode runs it: the sweep through
   ``gating.integration.analyze``, then ``FullGatePipeline.process`` on
   128 mono8 keyframes at 270x360 with the shipped MixVPR and LightGlue
   checkpoints (one warm-up, three timed runs, one more under
   torch.profiler for the device time per stage and kernel);
4. the same gate at 16 keyframes on the card and on the CPU in float32
   with TF32 off and the same RANSAC draws: identical candidate and
   survivor pairs, decisions equal except within 1 inlier or 0.01 of
   ratio of a threshold.

The last two lines of standard output are the card's name and power limit
and ``{"ok": true, "device": {...}}``; the line before them lists each
ported kernel with its launches on the main path and its times. Any
failure exits nonzero; so does a run with no CUDA device, or one from a
directory without the mlis_tpu_torch package.
"""

from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
import time

import numpy as np
import torch

H100_FP64_FLOPS = 34e12  # H100 SXM, FP64 outside the tensor cores (NVIDIA data sheet)
H100_HBM_BYTES_S = 3.35e12
RADIUS, MIN_GAP = 2.0, 100
SWEEP_POSES = 19163  # ORB-SLAM3 scale (bench.py:85-91)
TIMED_REPS = 3
SMALL_KEYFRAMES = 16  # phase 4
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


def keyframes(n: int, h: int = 270, w: int = 360):
    """bench.py's headline workload: n mono8 keyframes repeating n/8 scenes."""
    rng = np.random.default_rng(0)
    n_scenes = max(n // 8, 1)
    bases = [
        np.kron(rng.integers(0, 255, (h // 8 + 1, w // 8 + 1), dtype=np.uint8),
                np.ones((8, 8), np.uint8))[:h, :w]
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
    for line in info["ptxas"].splitlines():
        if "ptxas" in line:
            print("  " + line.strip(), flush=True)
    log("1 build", t0, built=info["built"], nvcc_s=f"{info['seconds']:.3f}", lib=info["path"])


def time_kernel_ms(pos, fl, ti, tj, r2, reps: int = 50) -> float:
    """Mean device time of one K1 launch, CUDA events over ``reps`` launches
    after a warm-up (the raw C entry point: no host work between launches)."""
    import ctypes

    from mlis_tpu_torch import _build

    lib = _build.library()
    out = torch.zeros(2, dtype=torch.int64, device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    argv = [ctypes.c_void_p(t.data_ptr()) for t in (pos, fl, ti, tj)] + [
        ctypes.c_int(int(ti.numel())), ctypes.c_int(int(pos.shape[0])),
        ctypes.c_int(MIN_GAP), ctypes.c_double(r2), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(stream)]
    for _ in range(3):
        _build.check(lib.mlis_tri_count(*argv), "tri_count")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        _build.check(lib.mlis_tri_count(*argv), "tri_count")
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_check(dev) -> dict:
    from mlis_tpu_torch.ops import pairwise as pw

    t0 = time.perf_counter()
    r2 = RADIUS * RADIUS
    stats = {}
    cases = [("a_orbslam_scale", *orbslam_scale_cloud(SWEEP_POSES), "tri"),
             ("b_boundary", *boundary_cloud(), "tri"),
             ("c_boundary_all_tiles", *boundary_cloud(), "all")]
    max_err = 0
    for name, positions, floors, tiles in cases:
        pos, fl, ti, tj = pw.pack_sweep_inputs(positions, floors, MIN_GAP, dev)
        if tiles == "all":
            ti, tj = (torch.as_tensor(t, device=dev) for t in pw.all_tiles(pos.shape[0]))
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
                  "total": got[0], "same_floor": got[1], "cross_floor": got[0] - got[1],
                  "plain_ms": f"{plain_ms:.3f}"}
        if dev.type == "cuda":
            fields["kernel_ms"] = f"{time_kernel_ms(pos, fl, ti, tj, r2):.4f}"
        if name.startswith("a_"):
            pairs = pw.index_valid_pairs(pos.shape[0], MIN_GAP)
            ops = 9 * pairs
            nbytes = pos.shape[0] * (24 + 4) + 8 * int(ti.numel()) + 16
            bound_ms = max(ops / H100_FP64_FLOPS, nbytes / H100_HBM_BYTES_S) * 1e3
            stats = {"sweep_counts": got,
                     "ms": float(fields.get("kernel_ms", "nan")), "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "operations" if ops / H100_FP64_FLOPS >= nbytes / H100_HBM_BYTES_S
                     else "bytes"}
            fields.update(pair_distances=pairs, bound_ms=f"{bound_ms:.4f}")
        print("  K1 " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)
    stats["max_abs_err"] = max_err
    log("2 K1 vs plain", t0, identical=True, launches_so_far=pw.tri_count.launches)
    return stats


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


STAGES = ("gate.detect", "gate.encode", "gate.retrieval", "lightglue.match", "epipolar.ransac")


def profile_gate(dev, pipe, inputs, gen, best_wall: float) -> None:
    """One more gate run under torch.profiler: device time per stage range
    and per kernel, and the device's busy share of the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    images, timestamps, floors, K = inputs
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.process(images, timestamps, floors, K, encode_batch_size=128, generator=gen)
        sync(dev)
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev_events if e.name not in STAGES]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    spans = {name: sum(e.time_range.elapsed_us() for e in dev_events if e.name == name)
             for name in STAGES}
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0) + e.time_range.elapsed_us()
    print(f"  profile wall_s={wall:.4f} unprofiled_wall_s={best_wall:.4f} "
          f"kernel_s={busy_us / 1e6:.4f} busy_share={busy_us / 1e6 / wall:.4f} "
          f"kernels={len(kernels)}", flush=True)
    print("  profile stage device spans (s): " + " ".join(
        f"{k}={v / 1e6:.4f}" for k, v in spans.items()), flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda x: -x[1])[:15]:
        print(f"  profile kernel {us / 1e6:.4f}s {name[:110]}", flush=True)


def phase_main_path(dev, args, expected_sweep) -> dict:
    from mlis_tpu_torch.gating.integration import analyze
    from mlis_tpu_torch.ops import pairwise as pw

    t0 = time.perf_counter()
    positions, floors_sweep = orbslam_scale_cloud(SWEEP_POSES)
    images, timestamps, floors, K = keyframes(args.keyframes)
    pipe = build_pipeline(dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    log("3 setup", t0, keyframes=len(images), weights="vpr_mixvpr.npz+lightglue_homog_sp.npz")

    pw.tri_count.launches = 0  # counts from here on are the main path's
    t0 = time.perf_counter()
    analysis, _gate = analyze(positions, floors_sweep, RADIUS, MIN_GAP, device=dev)
    sync(dev)
    log("3 sweep", t0, poses=len(positions), total=analysis.total_candidates,
        same_floor=analysis.same_floor_candidates, cross_floor=analysis.cross_floor_candidates,
        cross_rate=f"{analysis.cross_floor_rate:.4f}")

    runs = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for rep in range(TIMED_REPS + 1):
        pipe.spr.vpr.descriptors = []
        t0 = time.perf_counter()
        res = pipe.process(images, timestamps, floors, K, encode_batch_size=128, generator=gen)
        sync(dev)
        wall = time.perf_counter() - t0
        kind = "warmup" if rep == 0 else f"timed{rep}"
        log(f"3 gate {kind}", t0, candidates=res.total_pairs,
            floor_rejected=res.cross_floor_rejected, verified=res.verified,
            accepted=res.geometrically_valid, pairs_per_s=f"{res.total_pairs / wall:.1f}",
            vpr_s=f"{res.vpr_s:.4f}", retrieval_s=f"{res.retrieval_s:.4f}",
            verify_s=f"{res.verify_s:.4f}")
        if rep:
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
    if dev.type == "cuda":
        pipe.spr.vpr.descriptors = []
        profile_gate(dev, pipe, (images, timestamps, floors, K), gen, best_wall)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu rehearsal"
    launches = pw.tri_count.launches
    log("3 main path", time.perf_counter(),
        pairs_per_s=f"{best.total_pairs / best_wall:.1f}", device=json.dumps(name),
        walls=",".join(f"{w:.4f}" for w, _ in runs), peak_mem_bytes=peak,
        K1_launches=launches)
    if dev.type == "cuda" and launches < 1:
        raise AssertionError("the main path did not launch kernel K1")
    return {"launches": launches}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--keyframes", type=int, default=128)
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
        main_path = phase_main_path(dev, args, k1["sweep_counts"])
        phase_card_vs_cpu(dev)
    signal.alarm(0)
    print(f"[total] {time.perf_counter() - t_all:.3f}s", flush=True)
    if dev.type != "cuda":
        print("cpu rehearsal finished: no device result", flush=True)
        return 0
    kernels = [{
        "name": "tri_count",
        "route": "cuda",
        "source": "mlis_tpu_torch/csrc/pairwise.cu",
        "replaces": "mlis_tpu/ops/pairwise.py:138",
        "launches": main_path["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the floor-split count
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_name_and_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
