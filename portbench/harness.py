"""The port's benchmark: one run of one cell, driven by data.

``BENCHMARK.json`` at the repository's root names the cells. A cell
``<config>.<traffic>`` takes its configuration from the file that the
configuration's entry names (``configs/<name>.json``), its traffic mix from
``traffic/<name>.json``, each metric's reader from ``metrics/<name>.py``
(a module with ``read(run) -> float | None``) and each stage's kernels
from ``stages/<name>.json``, all found by name under this directory. A new
configuration, mix, metric or stage is a new file.

A run makes its inputs on the device from the seed, builds the encoder,
calls every input through the traffic's entry point until the work is
warm (set-up), then calls the inputs round the ring, one call after
another, for the window. With a trace, one slice in the middle of the
window runs under the profiler. Once the window has closed it reads the
device's memory peak, fetches a sample of the outputs drawn from the seed,
frees the encoder, and holds the sample to the plain reference
(``reference/jpeg.py``) computed from the same inputs.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import frames, timeline
from portbench.reference import jpeg

ROOT = Path(__file__).resolve().parent
SPEC = ROOT.parent / "BENCHMARK.json"


class Bench:
    """BENCHMARK.json and the files it names, found by name."""

    def __init__(self, spec: Path = SPEC, root: Path = ROOT):
        self.spec_path, self.root = Path(spec), Path(root)
        self.spec = json.loads(self.spec_path.read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"{key} has no entry {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        path = self.spec_path.parent / self._entry("configs", name)["file"]
        return json.loads(path.read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "traffic" / f"{name}.json").read_text())

    def stage(self, name: str) -> dict:
        return json.loads((self.root / "stages" / f"{name}.json").read_text())

    def stages(self) -> list:
        """Every stage that has a file."""
        return sorted(p.stem for p in (self.root / "stages").glob("*.json"))

    def reader(self, name: str):
        path = self.root / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def metrics(self, cell: str, traced: bool) -> list:
        """The metrics a run of the cell reports: the end-to-end ones
        untraced, the per-layer ones traced; those with a ``workloads``
        key only in the cells it lists."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key]
                if cell in m.get("workloads", [cell])]


class Reservoir:
    """A uniform sample of k of the calls, whatever their number, drawn
    from the seed (algorithm R); the draws are made before the window."""

    def __init__(self, k: int, seed: int):
        self.k, self.items = k, []
        self._rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
        self._u = self._rng.random(1 << 16)

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self.items.append(item)
            return
        if i >= self._u.size:
            self._u = np.concatenate([self._u, self._rng.random(self._u.size)])
        j = int(self._u[i] * (i + 1))
        if j < self.k:
            self.items[j] = item


class DeviceEncode:
    """The program's entry point that a traffic mix drives:
    ``encoder.device_encode`` of a device-resident frame, or
    ``device_encode_batch`` of a batch; the output stays on the device.
    ``fetch`` takes an output off the device after the window; what is
    judged is the scan up to its total (and a batch's offsets), against
    ``expected``, what the reference's scans of the input call for."""

    def __init__(self, cfg: dict, device: torch.device):
        import jpegtpu_torch
        from jpegtpu_torch import encoder
        self.cfg = cfg
        c = jpegtpu_torch.EncoderConfig(
            quality=cfg["quality"], subsampling=cfg["subsampling"],
            restart_interval=cfg["restart_interval"])
        self.encoder = jpegtpu_torch.Encoder(c, device=device)
        restart = self.encoder.restart_for(cfg["height"], cfg["width"])
        fn = (encoder.device_encode if cfg["batch"] == 1
              else encoder.device_encode_batch)
        t = self.encoder.tables
        self.call = lambda x: fn(x, t, c.subsampling, restart,
                                 c.device_stuff, c.pixel_path, c.fuse_bp)

    @staticmethod
    def fetch(out):
        scan = out[0][:int(out[1])].cpu().numpy().tobytes()
        return scan if len(out) == 2 else (scan, tuple(out[2].tolist()))

    def expected(self, scans: list):
        if self.cfg["batch"] == 1:
            return scans[0]
        starts = np.cumsum([0] + [len(s) for s in scans[:-1]])
        return b"".join(scans), tuple(int(v) for v in starts)


ENTRIES = {"device_encode": DeviceEncode}


@dataclass
class Run:
    """What a run measured; the metric readers read it."""
    cell: str
    config: dict
    traffic: dict
    bench: Bench
    setup_s: float = 0.0
    calls: int = 0
    failed: int = 0
    window_s: float = 0.0
    trace: timeline.Slice | None = None
    # Calls and seconds of the window before the traced slice, up to the
    # synchronise that starts it: the untraced pace of the same run.
    lead: tuple = (0, 0.0)
    slice_inputs: list = field(default_factory=list)
    scan_bytes: list = field(default_factory=list)   # per input, all images

    @property
    def entry(self) -> str:
        return self.traffic["entry"]

    @property
    def pixels_per_call(self) -> int:
        c = self.config
        return c["batch"] * c["height"] * c["width"]

    def stage_ops(self, stage: str) -> list:
        """The traced slice's device ops that the stage's file names."""
        return self.trace.ops_of(*self.bench.stage(stage)["kernels"])

    def unstaged_ops(self) -> list:
        """The traced slice's device ops that no stage's file names."""
        staged = {id(op) for s in self.bench.stages()
                  for op in self.stage_ops(s)}
        return [op for op in self.trace.device if id(op) not in staged]

    def slice_scan_bytes(self) -> float:
        """Mean stuffed-scan bytes of a call in the traced slice."""
        return float(np.mean([self.scan_bytes[k] for k in self.slice_inputs]))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: Bench, cell: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t_start: float,
             override: dict | None = None) -> tuple:
    """One run -> (result dict, stderr lines). ``override`` replaces keys
    of the configuration (the tests shrink the frames); t_start is the
    process's start on the host clock, where set-up begins."""
    spec = bench.cell(cell)
    cfg = {**bench.config(spec["config"]), **(override or {})}
    mix = bench.traffic(spec["traffic"])
    run = Run(cell, cfg, mix, bench)
    seed = seed % (1 << 64)

    inputs = frames.make_inputs(cfg, seed, device)
    entry = ENTRIES[mix["entry"]](cfg, device)
    for _ in range(mix["warmup_rounds"]):
        for x in inputs:
            entry.call(x)
    _sync(device)
    sample = Reservoir(mix["sample"], seed)
    errors = []
    run.setup_s = time.perf_counter() - t_start

    def step():
        k = run.calls % len(inputs)
        try:
            out = entry.call(inputs[k])
        except (RuntimeError, ValueError):
            run.failed += 1
            errors.append(traceback.format_exc())
            out = None
        if out is not None:
            sample.offer(run.calls, (k, out))
        run.calls += 1
        return k

    def traced_slice():
        from torch.profiler import record_function
        n, t0 = 0, time.perf_counter()
        while (n < mix["trace_min_calls"]
               or time.perf_counter() - t0 < mix["trace_seconds"]):
            with record_function("portbench.call"):
                run.slice_inputs.append(step())
            n += 1
        _sync(device)
        return n

    t0 = time.perf_counter()
    while True:
        step()
        now = time.perf_counter()
        if traced and run.trace is None and now - t0 >= seconds / 2:
            # The slice starts on an empty queue: the profiler records only
            # work enqueued after it starts, so device time still owed to
            # earlier calls would read as idle.
            _sync(device)
            run.lead = (run.calls, time.perf_counter() - t0)
            run.trace = timeline.record(traced_slice)
        if now - t0 >= seconds:
            break
    _sync(device)
    run.window_s = time.perf_counter() - t0

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    got = [(k, entry.fetch(out)) for k, out in sample.items]
    sample = entry.call = entry.encoder = None       # free the program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    restart = jpeg.restart_mcus(cfg["restart_interval"], cfg["width"],
                                cfg["subsampling"])
    scans = [[jpeg.scan(img, cfg["quality"], cfg["subsampling"], restart)
              for img in (x if cfg["batch"] > 1 else [x])] for x in inputs]
    run.scan_bytes = [sum(len(s) for s in ss) for ss in scans]
    want = [entry.expected(ss) for ss in scans]
    wrong = [(k, out) for k, out in got if out != want[k]]
    checks = {"wrong": {"value": len(wrong), "limit": 0},
              "failed": {"value": run.failed, "limit": 0},
              "checked": {"value": len(got), "at_least": 1}}
    correct = not wrong and not run.failed and len(got) >= 1

    metrics = {}
    for m in bench.metrics(cell, traced):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.calls,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops_top(),
                               "idle_gaps": run.trace.idle_gaps_top()}
    result["checks"] = checks

    lines = [f"calls {run.calls}, window {run.window_s:.3f} s, set-up "
             f"{run.setup_s:.3f} s, sample of {len(got)} outputs"]
    lines += errors[:1]
    for k, out in wrong[:3]:
        lines.append(f"input {k}: output differs from the reference: "
                     f"{_first_difference(out, want[k])}")
    lines += [f"check {name} {c['value']} " + " ".join(
        f"{k.replace('_', ' ')} {v}" for k, v in c.items() if k != "value")
        for name, c in checks.items()]
    return result, lines


def _first_difference(a, b) -> str:
    if isinstance(a, tuple) and isinstance(b, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return f"part {i}: {_first_difference(x, y)}"
        return f"{len(a)} parts against {len(b)}"
    if not isinstance(a, bytes):
        return f"{a!r} against {b!r}"
    n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    return f"{len(a)} bytes against {len(b)}, first difference at byte {n}"
