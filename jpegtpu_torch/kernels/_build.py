"""Build the port's CUDA kernels on first use, load them, launch them.

The sources in ``csrc/`` are compiled by ``nvcc`` for Hopper (``sm_90a``),
each in its own process, into one shared library with a plain C interface,
and loaded
with ``ctypes``: no PyTorch headers, so the build takes seconds, and no
``ninja``. The library lands in ``_build/`` beside this file, named by a
hash of the sources, the headers they share and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. The pattern is ``jpegtpu/native/__init__.py``'s.

Each launcher takes device pointers, sizes and a CUDA stream, launches on
that stream and returns the ``cudaError_t`` of the launch, which
``Kernel.launch`` turns into an exception; it runs the launcher with its
operands' device current and on that device's current stream, whatever
device the caller has made current. Nothing here runs at import: this
module is imported on machines without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("pixel_mma.cu", "block_pack.cu", "seg_merge.cu", "stuff.cu",
           "compact.cu", "fused_px_bp.cu", "pixel_dma.cu", "chain.cu")
# Headers the sources include; part of the library's hash.
HEADERS = ("pixel_common.cuh", "block_pack.cuh", "lookback.cuh", "grid.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# ctypes types of the launchers' arguments; every launcher takes the CUDA
# stream as its last argument.
PTR = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
# The type of the device the kernels run on.
DEVICE_TYPE = "cuda"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds jpegtpu_torch's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libjpegtpu_torch_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the kernels if the library for these sources is missing:
    one ``nvcc -c`` per source, all started together, then one link.
    Returns the seconds spent (0.0 when it was already built). The
    compiler's report (registers, spills) goes to ``<library>.log``."""
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp / f"{Path(name).stem}.o" for name in SOURCES]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                               str(tmp / "lib.so"), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        out.with_suffix(".log").write_text("".join(logs))
        failed = [(p.args[-1], p.returncode) for p in procs if p.returncode]
        if failed or link.returncode:
            raise RuntimeError(f"nvcc failed {failed or link.returncode}:\n"
                               f"{''.join(logs)[-4000:]}")
        os.replace(tmp / "lib.so", out)   # atomic: never a half-written .so
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once a process)."""
    build()
    return ctypes.CDLL(str(library_path()))


def check_cuda(*tensors: torch.Tensor,
               device: torch.device | None = None) -> None:
    """Raise unless every tensor is a contiguous tensor on one device of
    ``DEVICE_TYPE`` (on device, where it is given)."""
    dev = tensors[0].device if device is None else device
    for t in tensors:
        if t.device != dev or dev.type != DEVICE_TYPE:
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{[str(x.device) for x in tensors]} for {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


class Kernel:
    """One C launcher of the library and its launch count.

    ``launches`` counts the launches that went through this handle; a run
    sets it to 0 before the work it checks and reads it after, to show the
    work went through the kernel and not through its plain twin."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes) + [PTR]   # + the stream
        self.launches = 0
        self._fn = None

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device`` (the operands' CUDA device): the launcher
        runs with it current, on its current stream."""
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1
