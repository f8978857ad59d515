"""The program's host ranges in the traced window, from the same raw
``torch.profiler`` events that ``gatebench/trace.py`` reads.

The program names its stages (``gate.process`` around each call,
``gate.results``, ...) and each host wait (``sync.<site>``: a pageable copy,
a fetch, a ``synchronize``, an SVD that checks its result on the host)
with ranges recorded through the profiler, so host ranges and device
events share one clock. From them:

* ``host_n`` / ``host_s``: the count and the summed host seconds of each
  host range name that lies wholly inside the window;
* ``sync_idle_s``: idle device seconds by ``sync.*`` name. An idle gap of
  the device (between the union of its kernel, copy and set intervals) is
  charged to the last ``sync.*`` range whose end falls inside the gap,
  and only where the gap lies wholly inside one ``gate.process`` range:
  the gap between calls holds the harness's own work and stays out.

``trace.read`` does not expose these; ``read`` here takes the profiler
the same way.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from gatebench.trace import WINDOW, _kind, _merge

PROCESS = "gate.process"
SYNC = "sync."


@dataclass
class HostSpans:
    host_n: Dict[str, int] = field(default_factory=dict)
    host_s: Dict[str, float] = field(default_factory=dict)
    sync_idle_s: Dict[str, float] = field(default_factory=dict)


def read(prof) -> HostSpans:
    events = prof.profiler.kineto_results.events()
    host: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int, str]] = []
    for e in events:
        kind = _kind(e)
        a = e.start_ns()
        b = a + e.duration_ns()
        if kind == "user_annotation":
            host.append((a, b, e.name()))
        elif kind in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((a, b, e.name()))
    window = next(((a, b) for a, b, name in host if name == WINDOW), None)
    if window is None:
        raise RuntimeError(f"the trace holds no '{WINDOW}' range")
    w0, w1 = window
    # a device event named as a host range is that range's device annotation
    names = {name for _, _, name in host}
    merged = _merge([(max(a, w0), min(b, w1)) for a, b, name in device
                     if name not in names and b > w0 and a < w1])
    inside = [r for r in host if r[0] >= w0 and r[1] <= w1]
    host_n: Dict[str, int] = defaultdict(int)
    host_ns: Dict[str, int] = defaultdict(int)
    for a, b, name in inside:
        host_n[name] += 1
        host_ns[name] += b - a
    calls = sorted((a, b) for a, b, name in inside if name == PROCESS)
    starts = [a for a, _ in calls]
    syncs = sorted((b, name) for _, b, name in inside if name.startswith(SYNC))
    ends = [b for b, _ in syncs]
    idle: Dict[str, int] = defaultdict(int)
    prev = w0
    for a, b in merged + [(w1, w1)]:
        g0, g1 = prev, a
        prev = max(prev, b)
        if g1 <= g0:
            continue
        i = bisect.bisect_right(starts, g0) - 1
        if i < 0 or calls[i][1] < g1:
            continue  # not wholly inside one call
        j = bisect.bisect_right(ends, g1) - 1
        if j >= 0 and ends[j] >= g0:
            idle[syncs[j][1]] += g1 - g0
    return HostSpans(dict(host_n), {k: v / 1e9 for k, v in host_ns.items()},
                     {k: v / 1e9 for k, v in idle.items()})
