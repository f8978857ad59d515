"""The port's twins of experiments/*.py: superglue_cut's scoring and cut
selection against the script's own; every twin against its script on the
same deterministic stand-ins for the harness, the loaders and the
checkpoints (written JSON and printed lines equal); and each twin's
``main`` on the CPU at a small size.

The small size: every scene maker returns 2 floors x 2 places (v2) or 2
places (v1) at 135x180, and the harness detects 64 keypoints in float32
(the twins' own 512 in bf16 take 45 s a LightGlue call on one CPU
thread); the fullres twins run at 135x180 with 256 keypoints, 128
matched. The JSON files must carry the keys of the committed
results/<name>.json, and every number in them or in a printed JSON line
must be finite."""

import functools
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mlis_tpu_torch.eval import quality as q

ROOT = Path(__file__).resolve().parents[1]
SMALL_HW = (135, 180)


def _reference_script(name: str):
    """experiments/<name>.py loaded by path (its module level imports only
    numpy and the standard library)."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded_capture(seed: int):
    """Per-pair captures as run_gate_quality(return_pairs=True) gives them,
    drawn from a seed: pairs over 24 frames, some invalid, confident counts
    from -1 (no count) to 30, and a ground truth overlapping them."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(60):
        a, b = rng.choice(24, 2, replace=False)
        pairs.append({"q": int(a), "m": int(b), "is_valid": bool(rng.random() < 0.7),
                      "num_inliers": int(rng.integers(0, 80)), "inlier_ratio": float(rng.random()),
                      "num_confident_matches": int(rng.integers(-1, 31))})
    gt = {(min(p["q"], p["m"]), max(p["q"], p["m"])) for p in pairs[::3]}
    gt |= {(int(a), int(a) + 12) for a in rng.integers(0, 12, 4)}
    return pairs, sorted(gt)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_superglue_cut_score_matches_the_script(seed):
    from mlis_tpu_torch.experiments import superglue_cut

    ref = _reference_script("superglue_cut")
    assert superglue_cut.CUTS == ref.CUTS
    pairs, gt = _seeded_capture(seed)
    for cut in ref.CUTS + (1, 31):
        assert superglue_cut._score(pairs, gt, cut) == ref._score(pairs, gt, cut)


def test_superglue_cut_selection_matches_the_script(tmp_path, monkeypatch, capsys):
    """The twin's main on seeded captures in place of the gate: the sweep,
    the chosen cut and its F1s are those the script's _score and CUTS give
    under the script's selection rule."""
    from mlis_tpu_torch.experiments import superglue_cut

    ref = _reference_script("superglue_cut")
    captures = {s: _seeded_capture(10 + s) for s in range(4)}

    def scene(seed, device):
        return type("Scene", (), {"gt_pairs": captures[seed][1]})()

    def gate(*a, scene=None, **kw):
        seed = next(s for s, c in captures.items() if c[1] is scene.gt_pairs)
        return {"pairs": captures[seed][0], "weights": "seeded", "retrieval_recall": 1.0,
                "f1": 0.0, "precision": 0.0, "recall": 0.0}

    monkeypatch.setattr(superglue_cut, "make_quality_scene_v2", scene)
    monkeypatch.setattr(superglue_cut, "run_gate_quality", gate)
    out = tmp_path / "superglue_cut.json"
    res = superglue_cut.main(["--seeds", "0,1,2,3", "--select-seeds", "0,1",
                              "--out", str(out), "--device", "cpu"])
    select = {c: np.mean([ref._score(*captures[s], c)["f1"] for s in (0, 1)]) for c in ref.CUTS}
    holdout = {c: np.mean([ref._score(*captures[s], c)["f1"] for s in (2, 3)]) for c in ref.CUTS}
    best = max(ref.CUTS, key=lambda c: round(float(select[c]), 3))
    assert res["chosen_cut"] == best
    assert res["chosen_select_f1"] == round(float(select[best]), 3)
    assert res["chosen_holdout_f1"] == round(float(holdout[best]), 3)
    assert res["uncut_holdout_f1"] == round(float(holdout[0]), 3)
    assert json.loads(out.read_text())["chosen_cut"] == best
    assert (tmp_path / "superglue_cut.json.partial").exists()
    capsys.readouterr()


def _small_v2(seed=0, device="cuda", **_):
    return _REAL["v2"](n_floors=2, n_places=2, hw=SMALL_HW, seed=seed, device=device)


def _small_v1(n_places=8, hw=(270, 360), seed=0, device="cuda", **_):
    return _REAL["v1"](n_places=2, hw=SMALL_HW, seed=seed, device=device)


_REAL = {"v1": q.make_quality_scene, "v2": q.make_quality_scene_v2}


def _finite(obj, where="") -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _finite(v, f"{where}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _finite(v, f"{where}[{i}]")
    elif isinstance(obj, float):
        assert math.isfinite(obj), where


def _small(monkeypatch, mod):
    """Shrink ``mod``'s run to the small size described above."""
    monkeypatch.setattr(q, "make_quality_scene", _small_v1)
    for name, fn in (("make_quality_scene_v2", _small_v2), ("make_quality_scene", _small_v1)):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, fn)
    if hasattr(mod, "run_gate_quality"):
        monkeypatch.setattr(mod, "run_gate_quality", functools.partial(
            q.run_gate_quality, max_keypoints=64, model_dtype=torch.float32))
    if hasattr(mod, "run_gate_quality_rerank"):
        monkeypatch.setattr(mod, "run_gate_quality_rerank", functools.partial(
            q.run_gate_quality_rerank, max_keypoints=64))
    if hasattr(mod, "HW"):
        monkeypatch.setattr(mod, "HW", SMALL_HW)
        monkeypatch.setattr(mod, "DETECT", 256)
    if hasattr(mod, "MATCH_TOP_K"):
        monkeypatch.setattr(mod, "MATCH_TOP_K", 128)


def _keys(d: dict) -> dict:
    """Top-level keys and, for a dict of dicts, each inner dict's keys."""
    return {k: sorted(next(iter(v.values())).keys())
            if isinstance(v, dict) and v and all(isinstance(x, dict) for x in v.values())
            else None for k, v in d.items()}


# (twin, argv, the committed results file its keys are held to)
TWINS = [
    ("v2_scoreboard", ["--seeds", "0", "--families", "trained,loftr"],
     "quality_v2_scoreboard.json"),
    ("encoder_rows", ["--seeds", "0"], "vpr_encoder_rows.json"),
    ("encoder_intervention", ["--seeds", "0"], None),
    ("rerank_quality", ["--seeds", "0"], "rerank_scoreboard.json"),
    ("superglue_cut", ["--seeds", "0,1", "--select-seeds", "0"], "superglue_cut.json"),
    ("loftr_heldout", ["--seeds", "4"], "loftr_heldout.json"),
]


@pytest.mark.parametrize("name,argv,committed", TWINS, ids=[t[0] for t in TWINS])
def test_twin_main_on_the_cpu(tmp_path, monkeypatch, capsys, name, argv, committed):
    mod = importlib.import_module(f"mlis_tpu_torch.experiments.{name}")
    _small(monkeypatch, mod)
    out = tmp_path / "torch" / f"{name}.json"
    res = mod.main(argv + ["--device", "cpu", "--out", str(out)])
    written = json.loads(out.read_text())
    assert written == json.loads(json.dumps(res))
    _finite(written)
    printed = capsys.readouterr().out
    _finite(json.loads(printed[printed.index("{"):]))
    if committed:
        want = json.loads((ROOT / "results" / committed).read_text())
        assert set(written) == set(want)
        if name == "v2_scoreboard":
            fam = next(iter(want["families"].values()))
            for got in written["families"].values():
                assert set(got) == set(fam)
                assert set(got["per_seed"][0]) == set(fam["per_seed"][0])
        elif name == "encoder_rows":
            assert set(written["encoders"]) == set(want["encoders"])
            assert _keys(written["encoders"]) == _keys(want["encoders"])
        elif name in ("rerank_quality", "loftr_heldout"):
            assert set(written["per_seed"][0]) == set(want["per_seed"][0])
        elif name == "superglue_cut":
            assert set(written["cuts"]) == set(want["cuts"])
            assert set(written["cuts"]["0"]) == set(want["cuts"]["0"])
    else:  # encoder_intervention: the script's keys, as its main builds them
        assert set(written) == {"matcher", "top_k", "threshold", "seeds", "per_encoder",
                                "f1_mean_trained_vpr_v2", "rr_mean_trained_vpr_v2",
                                "f1_mean_mixvpr_trained", "rr_mean_mixvpr_trained"}


@pytest.mark.parametrize("name,keys", [
    ("fullres_matcher_quality",
     {"seed", "ckpt", "weights", "f1", "precision", "recall", "wall_s"}),
    ("fullres_pruning_quality",
     {"seed", "match_top_k", "f1", "precision", "recall", "retrieval_recall", "wall_s"}),
])
def test_fullres_twin_main_on_the_cpu(monkeypatch, capsys, name, keys):
    """The fullres twins print one JSON line per (seed, variant), with the
    script's keys."""
    mod = importlib.import_module(f"mlis_tpu_torch.experiments.{name}")
    _small(monkeypatch, mod)
    mod.main(["0", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 2
    for line in lines:
        assert set(line) == keys and line["seed"] == 0
        _finite(line)
    if name == "fullres_matcher_quality":
        assert [x["weights"] for x in lines] == ["lightglue_homog_sp.npz",
                                                 "lightglue_homog_sp_fullres.npz"]
    else:
        assert [x["match_top_k"] for x in lines] == [512, 1024]


def test_twin_outputs_default_under_results_torch():
    """No twin writes a committed results/*.json by default."""
    import argparse

    for name, _, committed in TWINS:
        mod = importlib.import_module(f"mlis_tpu_torch.experiments.{name}")
        seen = {}

        def parse(self, argv=None, _seen=seen):
            _seen["out"] = self.get_default("out")
            _seen["device"] = self.get_default("device")
            raise SystemExit

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(argparse.ArgumentParser, "parse_args", parse)
            with pytest.raises(SystemExit):
                mod.main([])
        assert seen["out"] == f"results/torch/{committed or name + '.json'}"
        assert seen["device"] == "cuda"


# -- every twin against its script on shared stand-ins ------------------------------


def _key(args, kw) -> str:
    """A call's arguments less ``device``, scenes and encoders by their
    names: what both sides must pass alike."""
    kw = {k: v for k, v in kw.items() if k != "device"}
    name = lambda v: getattr(v, "name", v)  # noqa: E731
    return repr(([name(a) for a in args], sorted((k, name(v)) for k, v in kw.items())))


def _rng(*parts) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


def _scene(kind):
    def make(*args, **kw):
        rng = _rng(kind, _key(args, kw))
        gt = sorted({(int(a), int(a) + int(d)) for a, d in zip(rng.integers(0, 20, 8),
                                                                  rng.integers(1, 6, 8))})
        return SimpleNamespace(name=f"{kind}{_key(args, kw)}", gt_pairs=gt)
    return make


def _gate(*args, **kw):
    """run_gate_quality: the scores, the weights' file and, with
    ``return_pairs``, per-pair captures, all drawn from the call."""
    rng = _rng("gate", _key(args, kw))
    out = {k: float(rng.random()) for k in ("f1", "precision", "recall", "retrieval_recall")}
    out["weights"] = os.path.basename(kw.get("weights_path") or f"default_{args[0]}.npz")
    out["pairs"] = [{"q": int(a), "m": int(a) + int(d), "is_valid": bool(v),
                     "num_inliers": int(n), "inlier_ratio": float(r),
                     "num_confident_matches": int(c)}
                    for a, d, v, n, r, c in zip(rng.integers(0, 20, 30), rng.integers(1, 6, 30),
                                                rng.random(30) < 0.7, rng.integers(0, 80, 30),
                                                rng.random(30), rng.integers(-1, 31, 30))
                    ] if kw.get("return_pairs") else None
    return out


def _scores(tag, fields):
    def run(*args, **kw):
        rng = _rng(tag, _key(args, kw))
        return {k: float(rng.random()) for k in fields}
    return run


def _loader(tag, missing=()):
    def load(*args, **kw):
        token = f"{tag}{_key(args, kw)}"
        return None if kw.get("arch") in missing else SimpleNamespace(
            name=token, encode_batch_device=SimpleNamespace(name=f"{token}.encode"))
    return load


STANDINS = {
    "make_quality_scene": _scene("v1"),
    "make_quality_scene_v2": _scene("v2"),
    "run_gate_quality": _gate,
    "run_gate_quality_rerank": _scores("rerank", ("f1", "precision", "recall")),
    "retrieval_metrics": _scores("retrieval", ("retrieval_recall", "aliased_rate")),
    "_pixel_encoder": SimpleNamespace(name="pixel"),
    "default_parallax_matcher_checkpoint": lambda: "checkpoints/lightglue_parallax.npz",
    "default_parallax_superglue_checkpoint": lambda: "checkpoints/superglue_parallax.npz",
    "default_parallax_loftr_checkpoint": lambda: "checkpoints/loftr_parallax.npz",
    "load_encoder": _loader("encoder", missing=("anyloc",)),
    "load_mixvpr_vpr": _loader("mixvpr"),
    "load_crica_tiny_vpr": _loader("crica_tiny"),
}

# (twin, argv): several seeds each, so that a row read from the wrong seed shows
SCRIPT_RUNS = [
    ("v2_scoreboard", ["--seeds", "0,1,2"]),
    ("encoder_rows", ["--seeds", "0,1"]),
    ("encoder_intervention", ["--seeds", "0,1,2"]),
    ("rerank_quality", ["--seeds", "0,1"]),
    ("superglue_cut", ["--seeds", "0,1,2,3", "--select-seeds", "0,1"]),
    ("loftr_heldout", ["--seeds", "4,5"]),
    ("loftr_heldout", ["--seeds", "4", "--threshold", "0.1"]),
    ("fullres_matcher_quality", ["0", "1"]),
    ("fullres_pruning_quality", ["0", "1"]),
]


def _printed(captured) -> tuple:
    """stdout and stderr with the wall clock taken out: the seconds in the
    progress lines and the fullres lines' ``wall_s``."""
    out = [json.dumps({k: v for k, v in json.loads(x).items() if k != "wall_s"})
           if x.startswith("{") and x.endswith("}") else x for x in captured.out.splitlines()]
    return out, re.sub(r"\d+\.\ds\b", "<t>s", captured.err)


@pytest.mark.parametrize("name,argv", SCRIPT_RUNS,
                         ids=[f"{n}-{'-'.join(a)}" for n, a in SCRIPT_RUNS])
def test_twin_matches_its_script(tmp_path, monkeypatch, capsys, name, argv):
    """The script (its harness, weights and loaders patched in the JAX
    package's modules before it imports them) and the twin (the same
    stand-ins patched into its module) write the same JSON and print the
    same lines. Every stand-in draws its outputs from its arguments, so a
    twin that passes other arguments, reads another field, mixes up seeds
    or rounds differently does not pass."""
    jax_mods = [importlib.import_module(m) for m in (
        "mlis_tpu.eval.quality", "mlis_tpu.models.weights", "mlis_tpu.train.pretrain_vpr")]
    twin = importlib.import_module(f"mlis_tpu_torch.experiments.{name}")
    for mod in jax_mods + [twin]:
        for attr, standin in STANDINS.items():
            if hasattr(mod, attr):
                monkeypatch.setattr(mod, attr, standin)
    monkeypatch.chdir(tmp_path)  # superglue_cut's script makes results/ in the working directory
    script = _reference_script(name)
    fullres = name.startswith("fullres")
    runs = {}
    for side in ("script", "twin"):
        out = tmp_path / f"{side}_{name}.json"  # the script makes no directory for it
        if fullres:
            monkeypatch.setattr(sys, "argv", [name] + argv)
            script.main() if side == "script" else twin.main(argv + ["--device", "cpu"])
        else:
            extra = ["--out", str(out)]
            script.main(argv + extra) if side == "script" else twin.main(
                argv + extra + ["--device", "cpu"])
        runs[side] = _printed(capsys.readouterr())
        if not fullres:
            runs[side] += (json.loads(out.read_text()),)
        if name == "superglue_cut":
            runs[side] += (json.loads(Path(f"{out}.partial").read_text()),)
    assert runs["twin"] == runs["script"]
    assert runs["twin"][0], "the twin printed nothing"


def test_gate_quality_repeats_at_one_seed():
    """Without ``ransac_uniforms`` the harness draws RANSAC's hypotheses
    from a generator seeded with ``seed``: two calls read the same, however
    the global stream moved between them (the twins' scoreboards repeat)."""
    scene = _small_v1(device="cpu")
    kw = dict(scene=scene, max_keypoints=64, model_dtype=torch.float32, return_pairs=True,
              seed=3, device="cpu")
    torch.manual_seed(0)
    first = q.run_gate_quality("trained", **kw)
    torch.manual_seed(1)
    torch.rand(1000)
    again = q.run_gate_quality("trained", **kw)
    assert first["pairs"], "the small scene verified no pair"
    assert again["pairs"] == first["pairs"]
    assert (again["f1"], again["precision"], again["recall"]) == (
        first["f1"], first["precision"], first["recall"])
