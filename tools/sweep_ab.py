#!/usr/bin/env python3
"""Time the candidate-sweep kernel against an earlier build of it, in turns, on one card.

    python3 tools/sweep_ab.py --baseline OLD/mlis_tpu_torch/csrc/pairwise.cu

``--baseline`` is a ``pairwise.cu`` with the one-block-a-tile interface
(``mlis_tri_count`` without ``log_split``), unpacked from an earlier commit
into a git-ignored directory. The script builds this checkout's kernels
(``mlis_tpu_torch._build``) and the baseline with the same nvcc flags,
prints both ptxas reports, and then, at each sweep case of chip_smoke.py's
phase 2 (19,163, 1,926 and 2,406 poses on the upper-triangle tile list, the
4,000-pose boundary cloud on it and on the full grid):

- checks that both kernels give the plain version's counts;
- times baseline, current, current, baseline (CUDA events around a CUDA
  graph of ``--reps`` launches, after a warm-up), the current kernel at
  the wrapper's cut, and the same turns as ``--reps`` launches from Python;
- times the current kernel at every cut ``log_split`` 0-8, in two turns,
  and each ``--variant`` (a ``pairwise.cu`` with the current interface)
  the same way.

Then it holds the current kernel at the 19,163-pose case for about a
second while ``nvidia-smi`` samples the SM clock and the power draw, and
writes the kernel's SASS (``cuobjdump``) to ``tri_count.sass`` beside
``--out`` with the opcode counts of each instance's inner loop. Prints one
JSON line per case, the card's name and power limit, and writes everything
to ``--out`` (default ``build/sweep_ab/sweep_ab.json``). Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from mlis_tpu_torch import _build  # noqa: E402
from mlis_tpu_torch.ops import pairwise as pw  # noqa: E402


OUT_DIR = _build.BUILD_DIR.parent / "sweep_ab"


def build_other(src: Path, name: str, takes_split: bool) -> tuple[ctypes.CDLL, str]:
    """Build one source alone with the library's nvcc flags and load it."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = OUT_DIR / f"lib{name}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S,
                          stdin=subprocess.DEVNULL)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}: {proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.mlis_tri_count.argtypes = ([p, p, p, p, i, i, i, d, i, p, p] if takes_split
                                   else [p, p, p, p, i, i, i, d, p, p])
    lib.mlis_tri_count.restype = ctypes.c_int
    return lib, proc.stderr + proc.stdout


def loop_mix(sass: str) -> dict:
    """Opcode counts of the longest loop (the span back to the target of
    the branch that closes it) of each kernel function in a SASS listing."""
    out, name, body = {}, None, []

    def close():
        loops = []
        for addr, text in body:
            m = re.search(r"BRA (0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        if name and loops:
            lo, hi = max(loops, key=lambda ab: ab[1] - ab[0])
            ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
                          for a, t in body if lo <= a <= hi)
            out[name] = dict(ops.most_common())

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, body = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name:
            body.append((int(m.group(1), 16), m.group(2).strip()))
    close()
    return out


def dump_sass(path: Path) -> dict:
    cubin = OUT_DIR / "pairwise.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.find_nvcc(), *flags, "-cubin", "-o", str(cubin),
                    str(_build.CSRC_DIR / "pairwise.cu")], check=True, timeout=300,
                   stdin=subprocess.DEVNULL)
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True, text=True,
                          timeout=300, stdin=subprocess.DEVNULL)
    path.write_text(sass.stdout + sass.stderr)
    return loop_mix(sass.stdout)


def clocks_under_load(launch, seconds: float = 1.0) -> dict:
    """SM clock and power draw sampled every 100 ms while ``launch`` runs
    back to back for about ``seconds``."""
    per = time_ms(launch, 20)
    reps = max(int(seconds * 1e3 / per), 1)  # one graph of them
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                           stdin=subprocess.DEVNULL)
    try:
        ms = time_ms(launch, reps)
    finally:
        smi.terminate()
        text, _ = smi.communicate(timeout=30)
    samples = [[float(v) for v in line.split(",")] for line in text.splitlines()
               if line.count(",") == 2]
    return {"reps": reps, "ms": ms, "samples_sm_mhz_max_mhz_watts": samples}


def launcher(lib, pos, fl, ti, tj, r2, out, log_split=None):
    """A no-argument function that launches one sweep through the raw C
    entry point on the current stream; ``log_split=None`` calls the
    baseline's interface."""
    argv = [ctypes.c_void_p(t.data_ptr()) for t in (pos, fl, ti, tj)] + [
        ctypes.c_int(int(ti.numel())), ctypes.c_int(int(pos.shape[0])),
        ctypes.c_int(cs.MIN_GAP), ctypes.c_double(r2)]
    if log_split is not None:
        argv.append(ctypes.c_int(log_split))
    argv.append(ctypes.c_void_p(out.data_ptr()))

    def launch():
        stream = ctypes.c_void_p(torch.cuda.current_stream(pos.device).cuda_stream)
        _build.check(lib.mlis_tri_count(*argv, stream), "tri_count")
    return launch


def counts(launch, out) -> tuple[int, int]:
    out.zero_()
    launch()
    total, same = out.tolist()
    return total, same


def time_ms(launch, reps: int, loop: bool = False) -> float:
    """Device time of one launch: CUDA events around one replay of a CUDA
    graph of ``reps`` launches, or with ``loop`` around ``reps`` launches
    from Python (the host's launch rate bounds that below ~10 us)."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    return (cs.events_ms(launch, reps) if loop else cs.graph_ms(launch, reps))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="another pairwise.cu with the current interface (repeatable)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", type=Path, default=OUT_DIR / "sweep_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.gpu_name_and_power()
    info = _build.build(ptxas_verbose=True)
    lib = _build.library()
    base, base_ptxas = build_other(args.baseline, "baseline", takes_split=False)
    ptxas = {"current": cs.ptxas_report(info["ptxas"]), "baseline": cs.ptxas_report(base_ptxas)}
    variants = {}
    for k, src in enumerate(args.variant):
        name = f"v{k}_{src.parent.name}"
        variants[name], text = build_other(src, name, takes_split=True)
        ptxas[name] = cs.ptxas_report(text)
    print(json.dumps({"card": card, "ptxas": ptxas}), flush=True)

    r2 = cs.RADIUS * cs.RADIUS
    sms = pw.sm_count(dev)
    cases = [("a_orbslam_scale", *cs.orbslam_scale_cloud(cs.SWEEP_POSES), "tri"),
             ("d_droid_scale", *cs.orbslam_scale_cloud(cs.DROID_POSES), "tri"),
             ("e_lego_scale", *cs.orbslam_scale_cloud(cs.LEGO_POSES), "tri"),
             ("b_boundary", *cs.boundary_cloud(), "tri"),
             ("c_boundary_all_tiles", *cs.boundary_cloud(), "all")]
    rows = []
    with torch.inference_mode():
        for name, positions, floors, tiles in cases:
            pos, fl, ti, tj = pw.pack_sweep_inputs(positions, floors, cs.MIN_GAP, dev)
            if tiles == "all":
                ti, tj = (torch.as_tensor(t, device=dev) for t in pw.all_tiles(pos.shape[0]))
            out = torch.zeros(2, dtype=torch.int64, device=dev)
            want = pw.tri_count_plain(pos, fl, ti, tj, cs.MIN_GAP, r2)
            auto = pw.sweep_split(ti.numel(), sms)
            old = launcher(base, pos, fl, ti, tj, r2, out)
            new = {ls: launcher(lib, pos, fl, ti, tj, r2, out, ls)
                   for ls in range(pw.MAX_LOG_SPLIT + 1)}
            others = {(v, ls): launcher(vlib, pos, fl, ti, tj, r2, out, ls)
                      for v, vlib in variants.items() for ls in range(pw.MAX_LOG_SPLIT + 1)}
            got = {"baseline": counts(old, out),
                   **{f"log_split_{ls}": counts(fn, out) for ls, fn in new.items()},
                   **{f"{v}_log_split_{ls}": counts(fn, out) for (v, ls), fn in others.items()}}
            bad = {k: v for k, v in got.items() if v != want}
            if bad:
                raise AssertionError(f"{name}: plain {want}, kernels {bad}")
            turns = [("baseline", time_ms(old, args.reps)), ("current", time_ms(new[auto], args.reps)),
                     ("current", time_ms(new[auto], args.reps)), ("baseline", time_ms(old, args.reps))]
            loop_turns = [(who, time_ms(fn, args.reps, loop=True))
                          for who, fn in (("baseline", old), ("current", new[auto]),
                                          ("current", new[auto]), ("baseline", old))]
            by_split = {ls: [time_ms(fn, args.reps) for fn in (new[ls], new[ls])]
                        for ls in range(pw.MAX_LOG_SPLIT + 1)}
            by_variant = {v: {ls: [time_ms(others[v, ls], args.reps) for _ in range(2)]
                              for ls in range(pw.MAX_LOG_SPLIT + 1)} for v in variants}
            pairs = pw.index_valid_pairs(pos.shape[0], cs.MIN_GAP)
            bound_ms = max(9 * pairs / cs.H100_FP64_ISSUE,
                           (pos.shape[0] * 28 + 8 * ti.numel() + 16) / cs.H100_HBM_BYTES_S) * 1e3
            row = {"case": name, "n": pos.shape[0], "tiles": int(ti.numel()), "sms": sms,
                   "auto_log_split": auto, "counts": want, "pairs": pairs, "bound_ms": bound_ms,
                   "turns_ms": turns, "launch_loop_turns_ms": loop_turns, "by_log_split_ms": by_split, "variants_ms": by_variant}
            print(json.dumps(row), flush=True)
            rows.append(row)
            if name.startswith("a_"):
                load = clocks_under_load(new[auto])
                print(json.dumps({"case": name, "under_load": load}), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    mix = dump_sass(args.out.parent / "tri_count.sass")
    print(json.dumps({"inner_loop_opcodes": mix}), flush=True)
    args.out.write_text(json.dumps({"card": card, "ptxas": ptxas, "cases": rows,
                                    "under_load": load, "inner_loop_opcodes": mix}, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
