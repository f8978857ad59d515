"""A run end to end: a tiny CPU rehearsal of the output, and the refusal
without a card."""

import json
import os
import subprocess
import sys

import pytest

from gatebench import run
from gatebench.tests.conftest import TINY_MIX

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("traced", [False, True])
def test_cpu_rehearsal_prints_one_result_line(traced, capsys):
    result, lines = run.run_cell("crica_lg512.floors2", 2**31 + 5, 0.1, traced, device="cpu",
                                 mix=TINY_MIX, max_calls=1)
    run.emit(result, lines)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    want = KEYS[:5] + (["breakdown"] if traced else []) + KEYS[5:]
    assert list(last) == want
    assert last["correct"] is True and last["attempted"] == 1 and last["failed"] == 0
    assert err.strip().splitlines()[-1].startswith("decisions ")
    names = {m["name"] for m in run.cell_metrics(run.manifest(), "crica_lg512.floors2", traced)}
    assert set(last["metrics"]) <= names
    if traced:
        assert set(last["device"]) >= {"busy_s", "window_s"}
    else:
        assert set(last["metrics"]) == {"pairs_per_s", "setup_s"}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "gatebench.run", "--workload", "crica_lg512.floors2",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_fresh_directory_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and gatebench/ cannot run a cell."""
    import shutil

    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "gatebench"), tmp_path / "gatebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "gatebench.run", "--workload", "crica_lg512.floors2",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
