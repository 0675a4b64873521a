"""Runs of the harness: the command without a card, every cell on the CPU
at a tiny size (correct), and with the timed path broken underneath
(not correct), once for each fault a cell can have."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]
TINY = {"uhd_420_q90": {"width": 72, "height": 40, "canvas": [48, 80]},
        "fhd_420_q90_x8": {"width": 48, "height": 24, "canvas": [32, 64],
                           "batch": 4}}


def _run(bench, cell, seed=2**31 + 77, seconds=0.3):
    return harness.run_cell(bench, cell, seed, seconds, False,
                            torch.device("cpu"), 0.0,
                            TINY[cell.split(".")[0]])


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "uhd_420_q90.device_ring", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _cli(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "is_available() is False" in out.stderr


def test_command_with_only_the_benchmark_fails(tmp_path):
    """A directory that holds BENCHMARK.json and portbench/ alone, with no
    program: non-zero, no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(bench, cell):
    result, lines = _run(bench, cell)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    n = result["checks"]["checked"]["value"]
    assert n >= 1 and lines[-3:] == ["check wrong 0 limit 0",
                                     "check failed 0 limit 0",
                                     f"check checked {n} at least 1"]
    assert result["device"]["platform"] == "cpu"
    assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2


def test_traced_run_reads_its_slice_on_the_cpu(bench):
    """The traced path end to end: the slice is profiled and reduced; on
    the CPU no device op is traced, so every device reader finds nothing
    and the line carries no per-layer metric, never a CPU number."""
    result, _ = harness.run_cell(bench, "uhd_420_q90.device_ring",
                                 9, 0.6, True, torch.device("cpu"), 0.0,
                                 TINY["uhd_420_q90"])
    assert result["correct"] and result["metrics"] == {}
    assert result["device"]["busy_s"] == 0.0
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _stale(fn):
    """A step that returns its state unchanged: every call gives back the
    first call's output."""
    first = []

    def call(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0]
    return call


def _half_batch(fn):
    """Half of the batch left out: the second half's images encoded as
    blank frames."""
    def call(imgs, *a, **k):
        imgs = imgs.clone()
        imgs[imgs.shape[0] // 2:] = 0
        return fn(imgs, *a, **k)
    return call


def _altered(fn):
    """An answer altered where it is produced: one byte of the stuffed scan
    flipped in the stuffing stage's output."""
    def call(*a, **k):
        out = fn(*a, **k)
        buf = out[0].clone()
        buf[int(out[1]) // 2] ^= 0x10
        return (buf, *out[1:])
    return call


FAULTS = [(cell, fault) for cell in CELLS for fault in (
    ("device_encode_batch", _stale), ("device_encode_batch", _half_batch))
    if "x8" in cell] + [(cell, fault) for cell in CELLS for fault in (
        ("device_encode", _stale),) if "x8" not in cell] + [
    (cell, ("compact_segments_stuffed_grouped", _altered)) for cell in CELLS]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=lambda v: v if isinstance(v, str) else v[1]
                         .__name__.strip("_"))
def test_broken_path_is_not_correct(bench, cell, fault, monkeypatch):
    from jpegtpu_torch import encoder
    from jpegtpu_torch.kernels import compact
    name, wrap = fault
    where = compact if name.startswith("compact") else encoder
    monkeypatch.setattr(where, name, wrap(getattr(where, name)))
    result, lines = _run(bench, cell)
    assert not result["correct"]
    assert result["checks"]["wrong"]["value"] > 0, lines


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    """One short traced run of each cell on the card (the command the
    benchmark runs): correct, with a device busy time."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "12345", "--seconds", "2", "--trace", "1"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0


def test_float32_control_through_the_harness_is_not_correct(bench):
    """The control in the program's place, through run_cell: at 1080p on
    the CPU every sampled output of the float32 reference differs from the
    float64 one, so ``wrong`` equals ``checked``, the whole sample."""
    from portbench import control
    result, lines = control.run(
        bench, "uhd_420_q90.device_ring", 7, 3.0, torch.device("cpu"),
        {"width": 1920, "height": 1080, "canvas": [1080, 1920],
         "distinct": 1})
    checks = result["checks"]
    assert not result["correct"], lines
    assert checks["checked"]["value"] == bench.traffic("device_ring")[
        "sample"]
    assert checks["wrong"]["value"] == checks["checked"]["value"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_on_the_card_is_not_correct(bench, cell, card):
    """The control at the cell's own size on the card, through run_cell:
    every sampled output wrong, on three seeds."""
    from portbench import control
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        result, lines = control.run(bench, cell, seed, 5.0, card)
        checks = result["checks"]
        assert not result["correct"], lines
        assert checks["checked"]["value"] == bench.traffic(
            bench.cell(cell)["traffic"])["sample"]
        assert checks["wrong"]["value"] == checks["checked"]["value"]
