#!/usr/bin/env python3
"""One traced benchmark run of a cell, with the program's host ranges read beside it.

    python3 tools/gate_spans.py --workload crica_lg512.floors2 --seed 2150000001 \
        --seconds 51 --out build/gate_spans/crica_lg512.floors2.json

Runs ``gatebench.run``'s traced run of the cell (``--trace 1``: its result
line and every per-layer metric, correctness judged as usual) and reads
the same profiler's host ranges with ``gatebench.spans``: the ``sync.*``
ranges a call by site, the idle device milliseconds a call charged to
each (the gap each wait ends in), the host milliseconds a call in each
range, and the idle milliseconds a call. Prints the result line and the
summary, and writes both to ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summary(spans, trace, calls: int) -> dict:
    """Per-call figures of one traced window."""
    per = 1.0 / max(calls, 1)
    syncs = {k: v * per for k, v in sorted(spans.host_n.items()) if k.startswith("sync.")}
    idle = {k: 1e3 * v * per for k, v in sorted(spans.sync_idle_s.items(), key=lambda x: -x[1])}
    return {
        "calls": calls,
        "syncs_per_call": sum(syncs.values()),
        "syncs_by_site": syncs,
        "sync_idle_ms": sum(idle.values()),
        "sync_idle_ms_by_site": idle,
        "host_ms": {k: 1e3 * v * per for k, v in sorted(spans.host_s.items())
                    if not k.startswith("sync.")},
        "host_ms_sync": {k: 1e3 * v * per for k, v in sorted(spans.host_s.items())
                         if k.startswith("sync.")},
        "idle_ms": 1e3 * (trace.window_s - trace.busy_s) * per,
        "device_ms": {k: 1e3 * v * per for k, v in sorted(trace.range_s.items())},
        "idle_by_range_ms": {k: 1e3 * v * per for k, v in trace.top_idle(40)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from gatebench import run, spans, trace

    run.use_checkout_caches()
    read = trace.read
    held = {}

    def read_both(prof):
        held["spans"] = spans.read(prof)
        held["trace"] = read(prof)
        return held["trace"]

    trace.read = read_both
    result, lines = run.run_cell(args.workload, args.seed, args.seconds, True)
    out = {"workload": args.workload, "seed": args.seed, "result": result,
           "spans": summary(held["spans"], held["trace"], result["attempted"] - result["failed"])}
    run.emit(result, lines)
    print(json.dumps(out["spans"]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
