"""The comparison that decides ``correct`` fails what it must.

The control (the reference in the program's place at float8) has to fail
the configured limits; so has a run whose timed path is broken
underneath: half of the survivors left unverified, one answer altered
where it is produced, a stage returning its state unchanged. Tiny scenes
on the CPU, the configurations' own weights and limits.
"""

import numpy as np
import torch

from gatebench import check, run
from gatebench.tests.conftest import TINY_MIX
from gatebench.traffic.scene import make_pool, scene_seed

CELL = "crica_lg512.floors2"
SEED = 2**31 + 11


def _rehearse():
    result, _lines = run.run_cell(CELL, SEED, 1e9, False, device="cpu",
                                  mix=TINY_MIX, max_calls=2)
    return result


def test_float8_control_fails_the_limits():
    _cell, cfg, _mix = run.cell_files(CELL)
    torch.set_grad_enabled(False)
    dev = torch.device("cpu")
    ref = run.reference_for(cfg, dev)
    g = cfg["gate"]
    pool = make_pool(TINY_MIX, tuple(cfg["keyframe_hw"]), dev)
    sc = pool[0]
    draws = check.draws_replay(scene_seed(SEED, 1, 0), int(g["verify_batch"]),
                               int(g["num_hypotheses"]), dev)
    out = ref.control_outputs(sc.images, sc.timestamps, sc.floors, sc.K, draws)
    numbers = check.worst([ref.judge(sc.images, sc.timestamps, sc.floors, sc.K, out, draws)],
                          check.structure_faults(out.total, out.rejected, out.rows, sc.floors))
    ok, lines = check.verdict(numbers, cfg["limits"])
    assert not ok, lines


def test_sound_rehearsal_is_correct():
    assert _rehearse()["correct"] is True


def test_half_the_survivors_left_out(monkeypatch):
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline

    orig = FullGatePipeline._verify_survivors

    def half(self, kp_all, qi, mi, *a, **kw):
        h = max(qi.numel() // 2, 1)
        return orig(self, kp_all, qi[:h], mi[:h], *a, **kw)

    monkeypatch.setattr(FullGatePipeline, "_verify_survivors", half)
    result = _rehearse()
    assert result["correct"] is False
    assert result["checks"]["structure"]["value"] > 0


def test_one_answer_altered_where_produced(monkeypatch):
    from mlis_tpu_torch.gating import full_gate

    orig = full_gate.pack_rows

    def altered(out):
        rows = orig(out).clone()
        i = int(torch.nonzero(rows[:, 2] >= 25)[0, 0])  # a pair with matches to spare
        flip = rows[i, 3] >= 20
        rows[i, 3] = 0.0 if flip else rows[i, 2]
        rows[i, 4] = 0.0 if flip else 1.0
        return rows

    monkeypatch.setattr(full_gate, "pack_rows", altered)
    result = _rehearse()
    assert result["correct"] is False
    assert result["checks"]["decisions"]["value"] > 0


def test_encoder_returning_its_state_unchanged(monkeypatch):
    from mlis_tpu_torch.models.cricavpr import CricaVPR

    orig = CricaVPR.encode_batch_device
    first = {}

    def stale(self, images):
        out = orig(self, images)
        return first.setdefault(tuple(out.shape), out)

    monkeypatch.setattr(CricaVPR, "encode_batch_device", stale)
    result = _rehearse()
    assert result["correct"] is False
    assert result["checks"]["encoder"]["value"] > result["checks"]["encoder"]["limit"]


def test_structure_faults_count_each_break():
    rows = [check.Row(0, 2, 30, 25, 0.8, True), check.Row(1, 3, 10, 2, 0.2, False)]
    floors = np.array([5, 5, 5, 5])
    assert check.structure_faults(4, 2, rows, floors) == 0
    assert check.structure_faults(5, 2, rows, floors) == 1  # a survivor without a result
    assert check.structure_faults(4, 2, rows[::-1], floors) == 1  # out of order
    assert check.structure_faults(4, 2, rows, np.array([5, 5, 2, 5])) == 1  # cross-floor pair
