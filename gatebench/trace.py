"""The traced window's device timeline, read from ``torch.profiler``'s raw events.

The run wraps its window in the host range ``gatebench.window`` and each
call in ``gatebench.call``; the program's own ranges (``gate.detect``,
``gate.encode``, ``gate.retrieval``, ``lightglue.match``,
``epipolar.ransac``) appear on the device as annotations. From the raw
events (building the profiler's event tree takes minutes at 10^5
kernels) this module takes:

* the device's busy time: the union of kernel, copy and set intervals
  inside the window (not their sum: overlapping work counts once);
* each range's device time: the busy time inside its device annotations;
* kernel counts and time by kernel name;
* the idle gaps between busy intervals, each labelled by the innermost
  host range open at its middle (what the host was doing while the
  device waited).
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "gatebench.window"
CALL = "gatebench.call"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    kernel_s: Dict[str, float] = field(default_factory=dict)  # by kernel name
    kernel_n: Dict[str, int] = field(default_factory=dict)
    range_s: Dict[str, float] = field(default_factory=dict)  # device busy time in each range
    idle_s: Dict[str, float] = field(default_factory=dict)  # idle time by host range

    def top_ops(self, n: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(self.kernel_s.items(), key=lambda x: -x[1])[:n]]

    def top_idle(self, n: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(self.idle_s.items(), key=lambda x: -x[1])[:n]]


def _kind(e) -> str:
    """The event's activity type; older profilers (such as torch 2.11's) lack
    ``activity_type``, and their kind is read from the device and the name."""
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    if kind:
        return kind
    name = e.name()
    if str(e.device_type()).endswith("CPU"):
        return "user_annotation" if "." in name and not name.startswith("aten::") else "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    iv.sort()
    out: List[List[int]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Busy:
    """Prefix sums over merged busy intervals: busy time inside [a, b]."""

    def __init__(self, merged: List[Tuple[int, int]]):
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.cum = [0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + (b - a))

    def within(self, a: int, b: int) -> int:
        i = bisect.bisect_right(self.ends, a)  # first interval ending after a
        j = bisect.bisect_left(self.starts, b)  # intervals starting before b
        if j <= i:
            return 0
        total = self.cum[j] - self.cum[i]
        total -= max(0, a - self.starts[i])
        total -= max(0, self.ends[j - 1] - b)
        return max(total, 0)


def read(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    host_ranges: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int, str, str]] = []
    for e in events:
        kind = _kind(e)
        if kind in ("cpu_op", "cuda_runtime", "cuda_driver", "python_function"):
            continue
        a = e.start_ns()
        b = a + e.duration_ns()
        if kind == "user_annotation":
            host_ranges.append((a, b, e.name()))
        elif kind in ("gpu_user_annotation", "kernel", "gpu_memcpy", "gpu_memset"):
            device.append((a, b, e.name(), kind))
    # a device event named as a host range is that range's device annotation,
    # whatever activity type this profiler version gives it
    names = {name for _, _, name in host_ranges}
    dev_ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    busy: List[Tuple[int, int]] = []
    kernel_ns: Dict[str, int] = defaultdict(int)
    kernel_n: Dict[str, int] = defaultdict(int)
    for a, b, name, kind in device:
        if kind == "gpu_user_annotation" or name in names:
            dev_ranges[name].append((a, b))
            continue
        busy.append((a, b))
        kernel_ns[name] += b - a
        if kind == "kernel":
            kernel_n[name] += 1
    window = next(((a, b) for a, b, name in host_ranges if name == WINDOW), None)
    if window is None:
        raise RuntimeError(f"the trace holds no '{WINDOW}' range")
    w0, w1 = window
    inside = [(max(a, w0), min(b, w1)) for a, b in busy if b > w0 and a < w1]
    merged = _merge(inside)
    tracker = _Busy(merged)
    range_s = {name: sum(tracker.within(a, b) for a, b in iv) / 1e9 for name, iv in dev_ranges.items()}
    # idle gaps and the innermost host range open at each gap's middle
    gaps = []
    prev = w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    ranges = sorted(r for r in host_ranges if r[1] > w0 and r[0] < w1)
    idle: Dict[str, float] = defaultdict(float)
    active: List[Tuple[int, int, int, str]] = []  # (-start, end, index, name): latest start first
    r = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        t = (a + b) // 2
        while r < len(ranges) and ranges[r][0] <= t:
            heapq.heappush(active, (-ranges[r][0], ranges[r][1], r, ranges[r][2]))
            r += 1
        # drop closed ranges from the top until the innermost open one is there
        while active and active[0][1] < t:
            heapq.heappop(active)
        label = active[0][3] if active else "outside ranges"
        idle[label] += (b - a) / 1e9
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=sum(b - a for a, b in merged) / 1e9,
                 kernels=sum(kernel_n.values()),
                 kernel_s={k: v / 1e9 for k, v in kernel_ns.items()}, kernel_n=dict(kernel_n),
                 range_s=range_s, idle_s=dict(idle))
