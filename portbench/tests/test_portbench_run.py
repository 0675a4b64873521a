"""Runs of the harness: the command without a card, every cell on the CPU
at a tiny size (correct), and with the timed path broken underneath
(not correct), once for each fault a cell can have. A cell's CPU size and
its faults follow from its configuration, never from its name, so a new
configuration and its cell go in as new files and entries only."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.reference import tables

REPO = Path(__file__).resolve().parents[2]
# A CPU frame is this many whole MCUs down and across, plus the
# configuration's own remainder; a batch holds at most CPU_BATCH frames.
CPU_MCUS = (2, 3)
CPU_BATCH = 4


def cpu_override(cfg: dict) -> dict:
    """The keys of a configuration that its CPU runs replace: the frame, a
    few whole MCUs of the configuration's mode plus its own remainder
    (``height % mcu_h`` rows, ``width % mcu_w`` columns), so that a frame
    of whole MCUs stays whole and one that is not still takes the row fold;
    a canvas one MCU larger each way; the batch cut to CPU_BATCH. The
    mode, quality, restart interval and distinct inputs stay."""
    mode = cfg["subsampling"]
    if mode not in tables.MODES:
        raise ValueError(f"configuration {cfg['name']!r}: the reference "
                         f"covers no {mode!r} mode")
    (mh, mw), _ = tables.MODES[mode]
    h = CPU_MCUS[0] * mh + cfg["height"] % mh
    w = CPU_MCUS[1] * mw + cfg["width"] % mw
    return {"height": h, "width": w, "canvas": [h + mh, w + mw],
            "batch": min(cfg["batch"], CPU_BATCH)}


def cells(bench) -> list:
    return [w["name"] for w in bench.spec["workloads"]]


CELLS = cells(harness.Bench())


def _run(bench, cell, seed=2**31 + 77, seconds=0.3, traced=False):
    cfg = bench.config(bench.cell(cell)["config"])
    return harness.run_cell(bench, cell, seed, seconds, traced,
                            torch.device("cpu"), 0.0, cpu_override(cfg))


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
    result, _ = _run(bench, CELLS[0], seed=9, seconds=0.6, traced=True)
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


STUFF = "compact_segments_stuffed_grouped"


def faults(bench) -> list:
    """(cell, (function, wrapper)) for each fault a cell can have, chosen
    from its configuration's ``batch``: a batch's entry
    (``device_encode_batch``) returning its state unchanged or leaving half
    of the batch out, a single frame's entry (``device_encode``) returning
    its state unchanged, and in every cell a scan byte altered where
    stuffing writes it (``compact_segments_stuffed_grouped``)."""
    out = []
    for cell in cells(bench):
        if bench.config(bench.cell(cell)["config"])["batch"] > 1:
            entry = (("device_encode_batch", _stale),
                     ("device_encode_batch", _half_batch))
        else:
            entry = (("device_encode", _stale),)
        out += [(cell, fault) for fault in entry + ((STUFF, _altered),)]
    return out


def _break(monkeypatch, fault):
    from jpegtpu_torch import encoder
    from jpegtpu_torch.kernels import compact
    name, wrap = fault
    where = compact if name == STUFF else encoder
    monkeypatch.setattr(where, name, wrap(getattr(where, name)))


def _fault_id(v):
    return v if isinstance(v, str) else v[1].__name__.strip("_")


@pytest.mark.parametrize("cell,fault", faults(harness.Bench()),
                         ids=_fault_id)
def test_broken_path_is_not_correct(bench, cell, fault, monkeypatch):
    _break(monkeypatch, fault)
    result, lines = _run(bench, cell)
    assert not result["correct"]
    assert result["checks"]["wrong"]["value"] > 0, lines


def test_cpu_size_refuses_a_mode_the_reference_lacks(bench):
    cfg = {**bench.config(bench.cell(CELLS[0])["config"]),
           "name": "uhd_gray_q90", "subsampling": "gray"}
    with pytest.raises(ValueError, match="uhd_gray_q90"):
        cpu_override(cfg)


# The next configurations' shapes, each made from a configuration that is
# there: a 4:4:4 single frame and a batch of 3 whose name has no "x8"; and
# the functions their faults break. Their names are no real
# configuration's, so that the copy holds them apart from the real ones
# once those are added.
NEXT = {"trial_uhd_444_q90": ("uhd_420_q90", {"subsampling": "444"},
                              ["device_encode", STUFF]),
        "trial_fhd_420_q90_b3": ("fhd_420_q90_x8", {"batch": 3},
                                 ["device_encode_batch"] * 2 + [STUFF])}


def _add_configurations(tmp_path):
    """A copy of BENCHMARK.json and portbench/ with NEXT's configurations
    added as the contract says: a new file each, new entries under
    ``configs`` and ``workloads``, and each new cell's name appended to the
    ``workloads`` list of every metric that has one. -> (bench, the
    copy's files' bytes before the additions)."""
    root = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", root, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (base, change, _) in NEXT.items():
        cfg = json.loads((root / "configs" / f"{base}.json").read_text())
        cfg.update(name=name, **change)
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": cfg["source"],
                                "file": f"portbench/configs/{name}.json",
                                "reduced": [], "why": "x"})
        cell = f"{name}.device_ring"
        spec["workloads"].append({"name": cell, "config": name,
                                  "traffic": "device_ring", "chips": 1,
                                  "why": "x"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(tmp_path / "BENCHMARK.json", root), before


@pytest.mark.parametrize("name", NEXT)
def test_next_configuration_needs_only_new_files_and_entries(
        tmp_path, monkeypatch, name):
    """A new configuration and its cell, added as new files and entries
    only, are sized and broken by the same functions as the cells that are
    there: correct on the CPU, reporting every metric it joined, not
    correct under each of its faults; no file of the copy's portbench/,
    its tests included, changes."""
    bench, before = _add_configurations(tmp_path)
    cell = f"{name}.device_ring"
    assert cell in cells(bench)
    result, lines = _run(bench, cell)
    assert result["correct"], lines
    assert set(result["metrics"]) == {
        m["name"] for m in bench.metrics(cell, False)} >= {
        "device_mpix_s", "setup_s"}
    assert {m["name"] for m in bench.metrics(cell, True)} == {
        m["name"] for m in bench.spec["per_layer"]}
    mine = [fault for c, fault in faults(bench) if c == cell]
    assert [fault[0] for fault in mine] == NEXT[name][2]
    for fault in mine:
        with monkeypatch.context() as m:
            _break(m, fault)
            result, lines = _run(bench, cell)
        assert result["checks"]["wrong"]["value"] > 0, (fault, lines)
    root = bench.root
    after = {p.relative_to(root): p.read_bytes()
             for p in root.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        Path("configs") / f"{n}.json" for n in NEXT}


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
    checked = checks["checked"]["value"]
    assert checked == min(bench.traffic("device_ring")["sample"],
                          result["attempted"])
    assert checked >= 1 and checks["wrong"]["value"] == checked


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
