"""The program's host ranges read from a trace (``gatebench/spans.py``): a
synthetic event list worked out by hand, with ``trace.read``'s fields on
the same list, and a traced CPU rehearsal of the gate."""

from types import SimpleNamespace

import pytest

from gatebench import run, spans, trace
from gatebench.tests.conftest import TINY_MIX

HOST, DEVICE = "DeviceType.CPU", "DeviceType.CUDA"


class Event:
    def __init__(self, name, a, b, device, kind, typed):
        self._e = (name, a, b, device)
        if typed:
            self.activity_type = lambda: kind

    def name(self):
        return self._e[0]

    def start_ns(self):
        return self._e[1]

    def duration_ns(self):
        return self._e[2] - self._e[1]

    def device_type(self):
        return self._e[3]


# (name, start, end, device, activity type), times in ns
EVENTS = [
    ("gate.process", -500, -100, HOST, "user_annotation"),  # a warm-up call, before the window
    ("gatebench.window", 0, 1000, HOST, "user_annotation"),
    ("gatebench.call", 10, 500, HOST, "user_annotation"),
    ("gate.process", 20, 480, HOST, "user_annotation"),
    ("aten::mm", 25, 35, HOST, "cpu_op"),
    ("kernel_a", 30, 100, DEVICE, "kernel"),
    ("sync.upload_images", 40, 110, HOST, "user_annotation"),  # ends in the gap 100-150
    ("kernel_b", 150, 200, DEVICE, "kernel"),
    ("sync.svd", 160, 210, HOST, "user_annotation"),  # ends in the gap 200-300 ...
    ("sync.counts", 212, 230, HOST, "user_annotation"),  # ... and so does this, later
    ("kernel_c", 300, 400, DEVICE, "kernel"),
    ("sync.fetch_rows", 410, 420, HOST, "user_annotation"),  # in the gap 400-600: between calls
    ("gate.results", 430, 470, HOST, "user_annotation"),
    ("gatebench.call", 550, 990, HOST, "user_annotation"),
    ("gate.process", 560, 980, HOST, "user_annotation"),
    ("kernel_a", 600, 700, DEVICE, "kernel"),
    ("Memcpy HtoD (Pageable -> Device)", 700, 720, DEVICE, "gpu_memcpy"),
    ("sync.upload_floors", 700, 720, DEVICE, "gpu_user_annotation"),
    ("sync.upload_floors", 650, 730, HOST, "user_annotation"),  # ends in the gap 720-800
    ("kernel_b", 800, 810, DEVICE, "kernel"),
    ("kernel_c", 820, 950, DEVICE, "kernel"),  # no sync ends in the gap 810-820
]


def _prof(typed: bool):
    events = [Event(*e, typed) for e in EVENTS]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


@pytest.mark.parametrize("typed", [True, False], ids=["activity_type", "without_activity_type"])
def test_host_ranges_by_hand(typed):
    got = spans.read(_prof(typed))
    assert got.host_n == {"gatebench.window": 1, "gatebench.call": 2, "gate.process": 2,
                          "sync.upload_images": 1, "sync.svd": 1, "sync.counts": 1,
                          "sync.fetch_rows": 1, "gate.results": 1, "sync.upload_floors": 1}
    assert got.host_s == pytest.approx({
        "gatebench.window": 1000e-9, "gatebench.call": 930e-9, "gate.process": 880e-9,
        "sync.upload_images": 70e-9, "sync.svd": 50e-9, "sync.counts": 18e-9,
        "sync.fetch_rows": 10e-9, "gate.results": 40e-9, "sync.upload_floors": 80e-9})
    # 0-30 starts before the first call, 400-600 and 950-1000 leave a call
    assert got.sync_idle_s == pytest.approx({"sync.upload_images": 50e-9, "sync.counts": 100e-9,
                                             "sync.upload_floors": 80e-9})


@pytest.mark.parametrize("typed", [True, False], ids=["activity_type", "without_activity_type"])
def test_trace_fields_on_the_same_events(typed):
    t = trace.read(_prof(typed))
    assert t.window_s == pytest.approx(1000e-9) and t.busy_s == pytest.approx(480e-9)
    assert t.kernels == 6 and t.kernel_n == {"kernel_a": 2, "kernel_b": 2, "kernel_c": 2}
    assert t.range_s == pytest.approx({"sync.upload_floors": 20e-9})
    assert t.idle_s == pytest.approx({"gatebench.call": 230e-9, "gate.process": 290e-9})


def test_traced_cpu_rehearsal_reads_the_program_ranges(monkeypatch):
    held = {}
    read = trace.read

    def both(prof):
        held["spans"] = spans.read(prof)
        return read(prof)

    monkeypatch.setattr(trace, "read", both)
    result, _lines = run.run_cell("crica_lg512.floors2", 2**31 + 5, 0.1, True, device="cpu",
                                  mix=TINY_MIX, max_calls=1)
    got = held["spans"]
    assert result["attempted"] == 1 and got.host_n["gate.process"] == 1
    assert got.host_n["gate.results"] == 1 and got.host_s["gate.results"] > 0
    # one encode batch (the ImageNet statistics, the position table's two
    # axes) and one verify batch (the image size, two SVDs, two constants)
    syncs = {k: v for k, v in got.host_n.items() if k.startswith("sync.")}
    assert syncs == {"sync.upload_floors": 1, "sync.upload_images": 1, "sync.upload_scale": 1,
                     "sync.upload_norm": 2, "sync.posembed": 2, "sync.upload_times": 1,
                     "sync.detect_encode": 1, "sync.counts": 1, "sync.survivors": 2,
                     "sync.image_size": 1, "sync.svd": 2, "sync.upload_const": 2,
                     "sync.fetch_rows": 1, "sync.fetch_pairs": 1}
    assert got.sync_idle_s == {}  # no device events on the CPU
    # the device-time readers find nothing to read on the CPU
    assert not {"match_attn_ms", "match_assign_ms", "detect_nms_topk_ms"} & set(result["metrics"])
