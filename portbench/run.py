"""One run of one cell of jpegtpu_torch's benchmark on the local GPU.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks`` last:
each number compared with the reference, beside its limit); the same
checks are the last lines of standard error. Exits non-zero, printing no
result, without CUDA or with fewer cards than the cell asks for, and when
a module of JAX or of the JAX package is loaded once the window has closed.
Caches: the kernel library in ``jpegtpu_torch/kernels/_build/`` (the
program's own fixed directory), Triton's and torch's extension caches
under ``portbench/.cache/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jpegtpu")


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.splitlines()[0].strip() if out.strip() else "unknown"


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    # Import the harness as the package portbench, from the checkout's
    # root, and keep its modules' names from shadowing others.
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path[0] = str(HERE.parent)
    else:
        sys.path.insert(0, str(HERE.parent))

    import torch
    from portbench import harness
    bench = harness.Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present; no result",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{found}; no result", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    result["checks"] = result.pop("checks")          # the last key
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
