"""The manifest and every file it names load by name and keep the forms the
manifest allows: names, units, one-line texts, a reader a metric."""

import copy
import json
import os
import re
import sys
import types

import pytest

from gatebench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def man():
    return run.manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_paths(man):
    assert set(man) == KEYS["top"]
    assert man["paths"] == ["gatebench"]
    assert not any(w.startswith("/") or ".." in w for w in man["command"])
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_name_and_unit(man):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in man[group]:
            kind = group[:-1] if group in ("configs", "workloads") else group
            assert set(entry) <= KEYS[kind], (group, entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry and group in ("configs", "workloads", "per_layer"):
                    assert _line(entry[key]), (entry["name"], key)
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_configs_mixes_and_metrics_load_by_name(man):
    configs = {c["name"] for c in man["configs"]}
    for c in man["configs"]:
        cfg = run.load_json(c["file"])
        assert c["file"].startswith("gatebench/")
        assert cfg["reduced"] == c["reduced"] and len(cfg["source"]) <= 200
        assert set(cfg["limits"]) >= {"structure", "retrieval", "encoder", "matcher"}
    seen = set()
    for w in man["workloads"]:
        cell, cfg, mix = run.cell_files(w["name"], man)
        assert w["config"] in configs and w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert set(mix) == {"floors", "places", "passes", "frame_dt", "pool", "scenes_seed", "why"}
        assert mix["floors"] * mix["places"] * mix["passes"] == 128
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(run.reader(m["name"]))
        assert set(m.get("workloads", [])) <= {w["name"] for w in man["workloads"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(man):
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in man["end_to_end"])
    for w in man["workloads"]:
        e2e = [m["name"] for m in run.cell_metrics(man, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(man, w["name"], True)
    e2e_names = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e_names and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def _crica():
    return run.cell_files("crica_lg512.floors2")[1]


def _load(tmp_path, man, cfg):
    """``cfg`` written to a file of its own and loaded through a manifest
    whose crica_lg512 names that file, as a run loads it."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    man = copy.deepcopy(man)
    for c in man["configs"]:
        if c["name"] == "crica_lg512":
            c["file"] = str(path)
    return run.cell_files("crica_lg512.floors2", man)


@pytest.mark.parametrize("change, refusal", [
    (lambda v: v.update(weights={"seed": 5}), "exactly one"),
    (lambda v: v.pop("checkpoint"), "exactly one"),
    (lambda v: (v.pop("checkpoint"), v.update(weights={"seed": "5"})), "seed"),
    (lambda v: (v.pop("checkpoint"), v.update(weights={"seed": 5, "std": 1})), "seed"),
], ids=["both", "neither", "seed_not_int", "weights_extra_key"])
def test_encoder_sources_are_refused_at_load(tmp_path, man, change, refusal):
    cfg = _crica()
    change(cfg["vpr"])
    with pytest.raises(SystemExit, match=refusal):
        _load(tmp_path, man, cfg)


def test_seeded_weights_need_a_seeded_params(tmp_path, man):
    cfg = _crica()
    cfg["vpr"].update(method="mixvpr", weights={"seed": 5})
    cfg["vpr"].pop("checkpoint")
    with pytest.raises(SystemExit, match="seeded_params"):
        _load(tmp_path, man, cfg)


@pytest.mark.parametrize("defined, refusal", [
    (("encode",), "frame_flops"),
    (("frame_flops",), "encode"),
    ((), "encode, frame_flops"),
])
def test_a_method_without_its_functions_is_refused_at_load(tmp_path, man, monkeypatch,
                                                           defined, refusal):
    mod = types.ModuleType("gatebench.reference.bare")
    for f in defined:
        setattr(mod, f, lambda *a: None)
    monkeypatch.setitem(sys.modules, "gatebench.reference.bare", mod)
    cfg = _crica()
    cfg["vpr"]["method"] = "bare"
    with pytest.raises(SystemExit, match=f"defines no {refusal}"):
        _load(tmp_path, man, cfg)


def test_a_method_without_a_module_is_refused_at_load(tmp_path, man):
    cfg = _crica()
    cfg["vpr"]["method"] = "no_such_encoder"
    with pytest.raises(SystemExit, match="no reference module"):
        _load(tmp_path, man, cfg)


def test_the_shipped_configurations_load_as_they_are(tmp_path, man):
    cfg = _crica()
    _cell, got, _mix = _load(tmp_path, man, {k: v for k, v in cfg.items() if k != "name"})
    assert got == cfg and got["name"] == "crica_lg512"


def test_layers_are_one_line_and_consistent(man):
    by_layer = {}
    for m in man["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_manifest_is_plain_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        json.load(f)
