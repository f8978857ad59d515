"""Run one benchmark cell once: ``python3 -m gatebench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout.

The cell's configuration, traffic mix and metrics are found by name:
``BENCHMARK.json`` names the cell's configuration file and traffic mix;
the mix is ``gatebench/traffic/<mix>.json``; each metric is read by
``gatebench/metrics/<metric>.py``'s ``read(run)``. Set-up builds the
gate, draws the mix's pool of scenes from the seed and runs each once;
the window then calls ``FullGatePipeline.process`` back to back on the
pool, in turn, each call with RANSAC draws of its own, until a call ends
past ``--seconds``. With ``--trace 1`` the window runs under
``torch.profiler`` and the per-layer metrics are read from its trace.
After the window the outputs are judged (``gatebench/check.py``) and one
JSON line is printed last on standard output.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mlis_tpu")
CHECK_RANDOM_CALLS = 2  # calls judged besides the one that verified the most pairs


def _process_age_s() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age_s()


def use_checkout_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


# -- finding a cell's files by name ------------------------------------------------------

def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def check_config(cfg: dict) -> None:
    """Refuses (SystemExit) a configuration whose encoder the harness cannot
    build, count or judge: its reference module lacks ``encode`` or
    ``frame_flops``; not exactly one of ``vpr.checkpoint`` and
    ``vpr.weights``; ``vpr.weights`` other than ``{"seed": <int>}``, or
    given for a module without ``seeded_params``."""
    from gatebench import reference

    v = cfg["vpr"]
    where = f"configuration {cfg.get('name', '?')}"
    try:
        mod = reference.encoder(v["method"])
    except ValueError as e:
        raise SystemExit(f"{where}: {e}") from e
    if ("checkpoint" in v) == ("weights" in v):
        raise SystemExit(f"{where}: give exactly one of vpr.checkpoint and vpr.weights")
    w = v.get("weights")
    if w is not None:
        if set(w) != {"seed"} or not isinstance(w["seed"], int) or isinstance(w["seed"], bool):
            raise SystemExit(f'{where}: vpr.weights must be {{"seed": <int>}}, got {w!r}')
        if not callable(getattr(mod, "seeded_params", None)):
            raise SystemExit(f"{where}: gatebench/reference/{v['method']}.py defines no "
                             "seeded_params for vpr.weights")


def cell_files(name: str, man: Optional[dict] = None) -> Tuple[dict, dict, dict]:
    """(the cell's manifest entry, its configuration, its traffic mix). The
    configuration gets its manifest ``name`` and is checked (``check_config``)."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    cfg = dict(load_json(cfg_entry["file"]), name=cfg_entry["name"])
    check_config(cfg)
    mix = load_json(os.path.join("gatebench", "traffic", cell["traffic"] + ".json"))
    return cell, cfg, mix


def reader(metric: str):
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"gatebench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: end-to-end untraced, per-layer traced."""
    group = man["per_layer"] if traced else man["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


# -- one run -----------------------------------------------------------------------------

@dataclass
class Call:
    index: int
    scene: int
    wall_s: float
    total: int
    rejected: int
    frames: int
    rows: list  # check.Row per verified pair (MatchResults until the window closes)
    record: Optional[dict]  # what the stages handed on (system.Recorder.take)
    pair_keypoints: List[Tuple[int, int]] = field(default_factory=list)


@dataclass
class Run:
    cell: str
    cfg: dict
    mix: dict
    calls: List[Call]
    window_s: float
    setup_s: float
    failed: int = 0
    trace: object = None


def rows_of(results) -> list:
    """The program's MatchResults as the check's rows."""
    from gatebench.check import Row

    return [Row(int(r.query_idx), int(r.match_idx), int(r.num_matches), int(r.num_inliers),
                float(r.inlier_ratio), bool(r.is_valid)) for r in results]


class Harness:
    """The gate of one configuration on one device, driven over a pool."""

    def __init__(self, cfg: dict, device):
        import torch

        from gatebench import system

        self.torch, self.cfg, self.device = torch, cfg, torch.device(device)
        self.pipe = system.build(cfg, self.device)
        self.recorder = system.Recorder(self.pipe)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def call(self, scene, seed: int):
        """One ``process`` call with RANSAC's draws from a generator seeded ``seed``."""
        gen = self.torch.Generator(device=self.device).manual_seed(seed)
        return self.pipe.process(scene.images, scene.timestamps, scene.floors, scene.K,
                                 encode_batch_size=int(self.cfg["vpr"]["encode_batch_size"]),
                                 generator=gen)

    def warm(self, pool, seed: int) -> None:
        from gatebench.traffic.scene import scene_seed

        for j, sc in enumerate(pool):
            self.call(sc, scene_seed(seed, 2, j))
            self.recorder.take(False)
        self.sync()

    def window(self, pool, seed: int, seconds: float, prof=None, max_calls: int = 0):
        """Calls back to back until one ends past ``seconds``, cycling through
        the pool in the seed's order: (calls, window seconds, failed calls).
        The first cycle keeps its stages' whole outputs for the check."""
        from torch.profiler import record_function

        from gatebench.trace import CALL, WINDOW
        from gatebench.traffic.scene import pool_order, scene_seed

        order = pool_order(len(pool), seed)
        calls: List[Call] = []
        failed = 0
        with record_function(WINDOW):
            t_w0 = time.perf_counter()
            t1 = t_w0
            c = 0
            while True:
                j = order[c % len(pool)]
                sc = pool[j]
                with record_function(CALL):
                    t0 = time.perf_counter()
                    try:
                        res = self.call(sc, scene_seed(seed, 1, c))
                        self.sync()
                    except (RuntimeError, ValueError) as e:
                        print(f"call {c} failed: {type(e).__name__}: {e}", file=sys.stderr)
                        res = None
                        failed += 1
                    t1 = time.perf_counter()
                rec = self.recorder.take(c < len(pool))
                if res is not None:
                    calls.append(Call(c, j, t1 - t0, int(res.total_pairs),
                                      int(res.cross_floor_rejected), len(sc.images),
                                      res.results, rec))
                c += 1
                if t1 - t_w0 >= seconds or (max_calls and c >= max_calls) or failed > 2:
                    break
        for call in calls:
            call.rows = rows_of(call.rows)
        return calls, t1 - t_w0, failed

    def close(self) -> None:
        """Free the program's state (weights, caches) before the reference runs."""
        import gc

        self.pipe = self.recorder = None
        gc.collect()  # the recorder and the gate refer to each other
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def count_keypoints(calls: List[Call]) -> None:
    """Each verified pair's valid keypoint counts, from the recorded masks."""
    import torch

    masks = [c.record["mask"] for c in calls if c.record]
    if not masks:
        return
    counts = torch.stack(masks).sum(-1).cpu().numpy()
    for c, n in zip([c for c in calls if c.record], counts):
        c.pair_keypoints = [(int(n[r.q]), int(n[r.m])) for r in c.rows]


def judged_calls(calls: List[Call], seed: int) -> List[Call]:
    """The calls the check judges: two drawn from the seed among those whose
    stages were kept, and the one of them that verified the most pairs."""
    import numpy as np

    from gatebench.traffic.scene import scene_seed

    kept = [c for c in calls if c.record and "kp" in c.record]
    if not kept:
        return []
    rng = np.random.default_rng(scene_seed(seed, 3))
    pick = {int(i) for i in rng.choice(len(kept), size=min(CHECK_RANDOM_CALLS, len(kept)),
                                       replace=False)}
    pick.add(max(range(len(kept)), key=lambda i: len(kept[i].rows)))
    return [kept[i] for i in sorted(pick)]


def reference_for(cfg: dict, device):
    """The reference gate of ``cfg``: weights read from the files the program read."""
    from gatebench import reference
    from gatebench.check import Reference
    from gatebench.reference.weights import load_group
    from gatebench.system import checkpoint, vpr_file

    mt = checkpoint(cfg["matcher"]["checkpoint"])
    weights = {"superpoint": load_group(mt, "superpoint", device),
               "matcher": load_group(mt, "matcher", device),
               "vpr": load_group(vpr_file(cfg), "vpr", device)}
    return Reference(cfg, weights, reference.encoder(cfg["vpr"]["method"]), device)


def judge(run: Run, pool, seed: int, device, ref=None) -> Dict[str, Optional[float]]:
    """Every number compared: the structure of every call, and the judged
    calls against the reference (``ref``, else one built here)."""
    import torch

    from gatebench import check
    from gatebench.traffic.scene import scene_seed

    structure = sum(check.structure_faults(c.total, c.rejected, c.rows, pool[c.scene].floors)
                    for c in run.calls)
    chosen = judged_calls(run.calls, seed)
    keep = {id(c) for c in chosen}
    for c in run.calls:  # free what the check does not read
        if id(c) not in keep:
            c.record = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ref or reference_for(run.cfg, device)
    g = run.cfg["gate"]
    per_call = []
    with torch.inference_mode():
        for c in chosen:
            sc = pool[c.scene]
            batches = c.record["matches"]
            matches = tuple(torch.cat(x) for x in zip(*batches)) if batches else (None, None)
            out = check.CallOutput(c.total, c.rejected, c.rows, c.record["kp"],
                                   torch.cat(c.record["db"]), matches)
            draws = check.draws_replay(scene_seed(seed, 1, c.index), int(g["verify_batch"]),
                                       int(g["num_hypotheses"]), device)
            per_call.append(ref.judge(sc.images, sc.timestamps, sc.floors, sc.K, out, draws))
    if not chosen:
        structure += 1  # nothing judged is a fault of the run
    return check.worst(per_call, structure)


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, stdin=subprocess.DEVNULL)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             mix: Optional[dict] = None, max_calls: int = 0) -> Tuple[dict, List[str]]:
    """One run of one cell: (the result object, the compared numbers' lines).
    ``mix`` replaces the cell's traffic mix and ``max_calls`` ends the
    window early (CPU rehearsals at a tiny size)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gatebench import check, trace
    from gatebench.traffic.scene import make_pool

    man = manifest()
    _cell, cfg, cell_mix = cell_files(cell_name, man)
    mix = mix or cell_mix
    torch.set_grad_enabled(False)
    dev = torch.device(device)
    stamps = [("imports", time.perf_counter())]
    harness = Harness(cfg, dev)
    stamps.append(("gate built", time.perf_counter()))
    pool = make_pool(mix, tuple(cfg["keyframe_hw"]), dev)
    stamps.append(("pool drawn", time.perf_counter()))
    harness.warm(pool, seed)
    stamps.append(("warmed up", time.perf_counter()))
    setup_s = _AGE0 + time.perf_counter() - _T0

    prof = None
    if traced:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        calls, window_s, failed = harness.window(pool, seed, seconds, prof, max_calls)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    stamps.append(("window", time.perf_counter()))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run = Run(cell_name, cfg, mix, calls, window_s, setup_s, failed)
    if prof is not None:
        run.trace = trace.read(prof)
        del prof
        stamps.append(("trace read", time.perf_counter()))
    count_keypoints(calls)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded after the window: {', '.join(found)}")

    metrics, notes = {}, []
    for m in cell_metrics(man, cell_name, traced):
        got = reader(m["name"])(run)
        if isinstance(got, tuple):
            got, note = got
            notes.append(f"{m['name']}: {note}")
        if got is not None:
            metrics[m["name"]] = {"value": float(got), "unit": m["unit"]}

    harness.close()
    numbers = judge(run, pool, seed, dev)
    stamps.append(("judged", time.perf_counter()))
    ok, lines = check.verdict(numbers, cfg["limits"])
    prev = _T0 - _AGE0
    timing = []
    for name, t in stamps:
        timing.append(f"{name} {t - prev:.3f} s")
        prev = t
    notes.append(f"seconds: {', '.join(timing)}; {len(calls)} calls")
    ok = ok and failed == 0
    result = {
        "correct": bool(ok),
        "attempted": len(calls) + failed,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if dev.type == "cuda":
        result["device"]["power_limit"] = power_limit()
    if run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.top_idle()}
    result["checks"] = {name: {"value": numbers.get(name), "limit": cfg["limits"][name]}
                        for name in check.NUMBERS}
    return result, notes + lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()
    import torch

    cell, _cfg, _mix = cell_files(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"gatebench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    emit(*run_cell(args.workload, args.seed, args.seconds, bool(args.trace)))
    return 0


def emit(result: dict, lines: List[str]) -> None:
    """The compared numbers beside their limits last on standard error, the
    result last on standard output."""
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
