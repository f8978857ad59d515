"""Encoder weights drawn from a seed (``vpr.weights``) in place of a
checkpoint: a copy of crica_lg512's configuration, its file written on the
CPU into a temporary directory, read by the program and by the reference."""

import types

import numpy as np
import pytest
import torch

from gatebench import run, system
from gatebench.reference import cricavpr
from gatebench.reference.nets import F32
from gatebench.reference.weights import load_group, seeded_npz
from gatebench.tests.conftest import TINY_MIX
from gatebench.traffic.scene import make_pool

SEED = 2**31 + 23


def _seeded(seed=SEED, input_size=(56, 56)):
    cfg = run.cell_files("crica_lg512.floors2")[1]
    del cfg["vpr"]["checkpoint"]
    cfg["vpr"].update(weights={"seed": seed}, input_size=list(input_size))
    run.check_config(cfg)
    return cfg


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("weights"))
    cfg = _seeded()
    return d, cfg, seeded_npz(d, cfg["name"], cfg["vpr"], cricavpr)


def test_the_file_has_the_shipped_layout(written):
    _d, _cfg, path = written
    with np.load(path) as got, np.load(system.checkpoint("checkpoints/vpr_crica.npz")) as shipped:
        assert sorted(got.files) == sorted(shipped.files)
        for k in shipped.files:
            assert got[k].shape == shipped[k].shape and got[k].dtype == np.float16, k
            assert np.isfinite(got[k]).all(), k


def test_the_same_seed_writes_the_same_values(written, tmp_path):
    _d, cfg, path = written
    want = _arrays(path)
    assert _same(_arrays(seeded_npz(str(tmp_path / "a"), cfg["name"], cfg["vpr"], cricavpr)), want)
    other = _seeded(SEED + 1)
    got = _arrays(seeded_npz(str(tmp_path / "b"), cfg["name"], other["vpr"], cricavpr))
    assert got.keys() == want.keys() and not _same(got, want)


def test_the_file_is_written_once_and_anew_on_a_change(tmp_path):
    calls = []

    def seeded_params(vpr_cfg, gen):
        calls.append(vpr_cfg["weights"]["seed"])
        return {"vpr:params/w": torch.randn(3, generator=gen).to(torch.float16).numpy()}

    mod = types.SimpleNamespace(seeded_params=seeded_params, __file__=cricavpr.__file__)
    d = str(tmp_path)
    first = seeded_npz(d, "c", {"weights": {"seed": 1}}, mod)
    assert seeded_npz(d, "c", {"weights": {"seed": 1}}, mod) == first and calls == [1]
    second = seeded_npz(d, "c", {"weights": {"seed": 2}}, mod)
    other = seeded_npz(d, "c-2", {"weights": {"seed": 1}}, mod)
    assert calls == [1, 2, 1] and second != first
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        p.split("/")[-1] for p in (second, other))


def test_the_program_reads_the_reference_file(written, monkeypatch):
    """The gate that ``system.build`` makes from the seeded configuration
    (bf16, on the CPU) against ``reference/cricavpr.encode`` in float32 on
    the same file: two keyframes within crica_lg512's ``encoder`` limit."""
    d, cfg, path = written
    monkeypatch.setattr(system, "WEIGHTS_DIR", d)
    assert system.vpr_file(cfg) == path
    dev = torch.device("cpu")
    images = make_pool(TINY_MIX, tuple(cfg["keyframe_hw"]), dev)[0].images[:2]
    with torch.no_grad():
        pipe = system.build(cfg, dev)
        got = pipe.spr.vpr.encode_batch_device(images)
        want = cricavpr.encode(load_group(path, "vpr", dev), torch.as_tensor(images), cfg["vpr"], F32)
    a = torch.nn.functional.normalize(got.to(torch.float32), dim=-1)
    b = torch.nn.functional.normalize(want, dim=-1)
    gap = float((1.0 - (a * b).sum(-1)).max())
    assert gap <= cfg["limits"]["encoder"], gap
