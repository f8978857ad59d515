"""Profiling and tracing utilities.

Counterpart of ``mlis_tpu/utils/profiling.py``. :class:`StageTimer`
collects named wall-clock stages, synchronising the card at each boundary
(``torch.cuda.synchronize()`` once CUDA is initialised; nothing on a
CPU-only run); :func:`profile_trace` wraps ``torch.profiler`` (CPU and CUDA
activities) and writes a Chrome trace into its directory.

:func:`span` and :func:`sync_point` name the program's stages and host
waits in a ``torch.profiler`` trace. They record only through the profiler
(its host ranges and the device events share one clock), and with no
profiler recording they cost one flag check. Every name holds a ``.``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a ``torch.profiler`` session
    records on this thread; otherwise a context that does nothing."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


def sync_point(site: str):
    """``span("sync." + site)``: wraps one call that makes the host wait
    for the device (a pageable copy, a fetch, a ``synchronize``, a size
    known only on the device, an op that checks its result on the host)."""
    return span("sync." + site)


class StageTimer:
    """Accumulating stage timer with optional device sync at boundaries."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _sync(self):
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "calls": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def summary(self) -> str:
        lines = [f"{'stage':<28} {'calls':>6} {'total (s)':>10} {'mean (ms)':>10}"]
        for name, r in sorted(self.report().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"{name:<28} {r['calls']:>6} {r['total_s']:>10.3f} "
                f"{r['mean_s'] * 1e3:>10.1f}"
            )
        return "\n".join(lines)

    def save(self, path: str) -> None:
        Path(path).write_text(json.dumps(self.report(), indent=2))


@contextlib.contextmanager
def profile_trace(log_dir: str = "./results/trace"):
    """``torch.profiler`` over the block, CPU and (when CUDA is available)
    CUDA activities; on exit the Chrome trace is written to
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields ``log_dir``, as the JAX package's does."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
