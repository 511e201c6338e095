"""BENCHMARK.json against the contract's shape, every cell's files found
by name, and a new cell added by data alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import core

ROOT = Path(core.ROOT)
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"render": dict(width=12, height=8, spp=2, max_bounces=3),
        "train": dict(width=10, height=6, spp=2, max_bounces=3)}


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_entries(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for e in MANIFEST[kind]:
        assert NAME.match(e["name"]), e["name"]
        assert set(e) - {"workloads"} == keys, e["name"]
        for cell in e.get("workloads", ()):
            assert cell in cells
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
        if kind == "workloads":
            assert e["chips"] == 1
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if kind == "per_layer":
            assert e["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    for w in MANIFEST["workloads"]:
        cell = core.find_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_found_by_name(cell):
    c = core.find_cell(cell)
    assert (ROOT / "perfbench" / "workloads" / f"{cell}.json").is_file()
    assert (ROOT / "perfbench" / "traffic"
            / f"{c.entry['traffic']}.py").is_file()
    for m in c.per_layer:
        reader = core.load_module(
            ROOT / "perfbench" / "layer_metrics" / f"{m['name']}.py", "r")
        assert callable(reader.read)


def test_a_new_cell_is_data_alone(tmp_path):
    """A cell added by its workload file and a manifest entry (no file of
    the benchmark edited) is found and runs."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append(
        {"name": "cornell.render_preview", "config": "cornell",
         "traffic": "render", "chips": 1, "why": "spp 16 previews"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "cornell.render" in m.get("workloads", ()):
            m["workloads"].append("cornell.render_preview")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    params = json.loads((ROOT / "perfbench" / "workloads"
                         / "cornell.render.json").read_text())
    params.update(TINY["render"])
    (root / "perfbench" / "workloads" / "cornell.render_preview.json"
     ).write_text(json.dumps(params))
    before = {p: p.read_bytes() for p in (ROOT / "perfbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    cell = core.find_cell("cornell.render_preview", root=root)
    res = core.run(cell, seed=3, seconds=0.2, trace=False, device="cpu")
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"render_mrays_s", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert before == after
