"""The control of the benchmark's correctness check: the plain reference,
put in the program's place, with its pixel product in float32 (TF32 off),
the nearest precision below the float64 that the configurations state.

    python3 portbench/control.py --workload uhd_420_q90.device_ring \
        --seeds 11 12 13 --seconds 5

For each seed it runs the cell through the harness's own ``run_cell``,
untraced and at the configuration's own size, with the cell's entry point
replaced by ``ReferenceEncode``, and prints one JSON line: ``correct`` and
the checks of the run. The control has to come out not correct: ``wrong``
equal to ``checked``, every sampled output differing from the float64
reference. It runs on the GPU; the tests run it on the CPU at a size they
can hold, and at the cell's own size where a card is present.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(HERE.parent)

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import jpeg  # noqa: E402


class ReferenceEncode(harness.DeviceEncode):
    """The reference in float32, called as the program's entry is and
    returning what the program returns: the scan on the device with its
    total, and a batch's image offsets. It builds no encoder."""

    def __init__(self, cfg: dict, device: torch.device):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg, self.encoder = cfg, None
        restart = jpeg.restart_mcus(cfg["restart_interval"], cfg["width"],
                                    cfg["subsampling"])

        def call(x):
            scans = [jpeg.scan(img, cfg["quality"], cfg["subsampling"],
                               restart, torch.float32)
                     for img in (x if cfg["batch"] > 1 else [x])]
            buf = torch.frombuffer(bytearray(b"".join(scans)),
                                   dtype=torch.uint8).to(x.device)
            total = torch.tensor(buf.numel(), device=x.device)
            if cfg["batch"] == 1:
                return buf, total
            starts = [0]
            for s in scans[:-1]:
                starts.append(starts[-1] + len(s))
            return buf, total, torch.tensor(starts, device=x.device)
        self.call = call


def run(bench, cell: str, seed: int, seconds: float, device,
        override: dict | None = None) -> tuple:
    """run_cell with the cell's entry point replaced by the control."""
    entry = bench.traffic(bench.cell(cell)["traffic"])["entry"]
    program = harness.ENTRIES[entry]
    harness.ENTRIES[entry] = ReferenceEncode
    try:
        return harness.run_cell(bench, cell, seed, seconds, False, device,
                                time.perf_counter(), override)
    finally:
        harness.ENTRIES[entry] = program


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    bench = harness.Bench()
    for seed in args.seeds:
        result, _ = run(bench, args.workload, seed, args.seconds,
                        torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
