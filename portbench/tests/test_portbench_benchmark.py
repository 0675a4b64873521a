"""BENCHMARK.json against the benchmark's contract, and the harness finding
each cell's files by name, new ones included, with no edit."""

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness

REPO = Path(__file__).resolve().parents[2]

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in SPEC["end_to_end"]}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("key,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source",
                    "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"})])
def test_entries_keys_and_names(key, keys):
    names = [e["name"] for e in SPEC[key]]
    assert len(names) == len(set(names))
    for e in SPEC[key]:
        assert set(e) <= keys and set(e) >= keys - {"workloads"}, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
                assert "\t" not in e[text]


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (REPO / "portbench" / "metrics" / f"{metric['name']}.py").exists()
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in E2E
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    if metric["name"].endswith("_roofline") or "_roofline." in metric[
            "name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_and_metrics(cell):
    bench = harness.Bench()
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] == 1
    cfg = bench.config(cell["config"])
    assert cfg["name"] == cell["config"] and cfg["reduced"] == []
    assert bench.traffic(cell["traffic"])["entry"] in harness.ENTRIES
    e2e = {m["name"] for m in bench.metrics(cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = bench.metrics(cell["name"], True)
    assert layer
    for m in layer:                    # a per-layer metric's cells report
        assert m["moves"] in e2e       # the end-to-end metric it moves


def test_config_entries_match_their_files():
    for entry in SPEC["configs"]:
        cfg = json.loads((REPO / entry["file"]).read_text())
        assert entry["file"].startswith("portbench/configs/")
        assert cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]


@pytest.mark.parametrize("stage", harness.Bench().stages())
def test_stage_files(stage):
    """Every stage file: its name, the work it stands for, and kernel
    names that no other stage's file shares, so that no device op counts
    in two stages."""
    bench = harness.Bench()
    s = bench.stage(stage)
    assert s["name"] == stage and s["work"]
    assert s["kernels"] and all(isinstance(k, str) and k
                                for k in s["kernels"])
    others = [k for o in bench.stages() if o != stage
              for k in bench.stage(o)["kernels"]]
    assert not [(k, o) for k in s["kernels"] for o in others
                if k in o or o in k]


def test_new_files_are_found_with_no_edit(tmp_path):
    """A configuration, a traffic mix, a metric and a stage added as new
    files (and entries in a copy of BENCHMARK.json) are found by name and
    run; no existing file changes."""
    root = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", root, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "uhd_420_q90.json").read_text())
    cfg.update(name="tiny_422_q75", subsampling="422", quality=75,
               width=40, height=24, canvas=[32, 48], distinct=2)
    (root / "configs" / "tiny_422_q75.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "device_ring.json").read_text())
    mix.update(name="ring_once", warmup_rounds=1, sample=2)
    (root / "traffic" / "ring_once.json").write_text(json.dumps(mix))
    (root / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return run.calls / run.window_s\n")
    (root / "stages" / "glue.json").write_text(json.dumps(
        {"name": "glue", "kernels": ["index"]}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_422_q75", "source": "x",
                            "file": "portbench/configs/tiny_422_q75.json",
                            "reduced": [], "why": "x"})
    cell = "tiny_422_q75.ring_once"
    spec["workloads"].append({"name": cell, "config": "tiny_422_q75",
                              "traffic": "ring_once", "chips": 1,
                              "why": "x"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(tmp_path / "BENCHMARK.json", root)
    assert bench.stage("glue")["kernels"] == ["index"]
    assert bench.stages() == ["entropy", "glue", "pixel"]
    result, _ = harness.run_cell(bench, cell, 5, 0.2, False,
                                 torch.device("cpu"), 0.0)
    assert result["correct"]
    assert set(result["metrics"]) == {"calls_per_s", "setup_s"}
    after = {p.relative_to(root): p.read_bytes()
             for p in root.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
