"""Design runs of K7, the oracle tier's per-block pack
(``jpegtpu_torch/kernels/csrc/block_pack.cu`` ``jt_block_pack``), on the
card: build the source as it is and variants of it that each change one
thing, then time K7 alone at 3840x2160 q90 on the oracle ladder's 4:2:0
rows and 4:4:4 rows blocks (194,400 and 388,800 blocks; profiler, 20
launches), each variant in turns, first forward then backward. Each
variant is held to the plain twin (``entropy_pack.block_pack_plain``)
first, whole rows and lengths, bit for bit.

    python3 pack_variants.py [variant ...]

Variants:
    final    the kernel as it is: kPackPer blocks a warp, 8 warps a block
    per1     one block a warp (no blocks in flight beside it)
    per2     two blocks a warp
    per4     four blocks a warp
    per6     six blocks a warp (K2's MCU at 4:2:0)
    warps4   4 warps a block, not 8

The copies go to ``.chipcheck/pack_variants/`` (git-ignored), each built
with block_pack.cu alone. Needs a CUDA GPU and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / ".chipcheck" / "pack_variants"
CSRC = ROOT / "jpegtpu_torch" / "kernels" / "csrc"
PER = r"constexpr int kPackPer = \d+;"
WARPS = r"constexpr int kPackWarps = \d+;"

# name -> (pattern, replacement) edits of block_pack.cu.
VARIANTS = {
    "final": [],
    "per1": [(PER, "constexpr int kPackPer = 1;")],
    "per2": [(PER, "constexpr int kPackPer = 2;")],
    "per4": [(PER, "constexpr int kPackPer = 4;")],
    "per6": [(PER, "constexpr int kPackPer = 6;")],
    "warps4": [(WARPS, "constexpr int kPackWarps = 4;")],
}


def build(names) -> dict:
    """Each variant's block_pack.cu alone, compiled into its own library
    (all nvcc processes at once) -> name -> ctypes.CDLL."""
    from jpegtpu_torch.kernels import _build
    src = (CSRC / "block_pack.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for pat, new in VARIANTS[name]:
            if not re.search(pat, text):
                raise AssertionError(f"variant {name}: {pat!r} not found")
            text = re.sub(pat, new, text)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "block_pack.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(CSRC),
             "-o", str(d / "lib.so"), str(d / "block_pack.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
        lines = log.splitlines()
        k7 = [" ".join(x.strip() for x in lines[i + 1:i + 4])
              for i, ln in enumerate(lines)
              if "Compiling entry" in ln and "block_pack_kernel" in ln]
        print(f"[build] {name}: K7 {k7}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.jt_block_pack.argtypes = ([ctypes.c_void_p] * 9 +
                                      [ctypes.c_longlong, ctypes.c_void_p])
        lib.jt_block_pack.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(names) -> int:
    import torch

    import chip_smoke
    from jpegtpu_torch.core import ops
    from jpegtpu_torch.encoder import EncoderTables
    from jpegtpu_torch.entropy import scan
    from jpegtpu_torch.kernels import entropy_pack, fused_dctq

    if not torch.cuda.is_available():
        print("pack_variants: no CUDA GPU", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    names = names or list(VARIANTS)
    dev = torch.device("cuda")
    x = torch.from_numpy(chip_smoke.bench_image()).to(dev)
    h, w = chip_smoke.BENCH_SHAPE
    luts = entropy_pack.standard_luts(dev)
    cases = {}
    for sub, n_luma in (("420", 4), ("444", 1)):
        t = EncoderTables.for_quality(chip_smoke.QUALITY, sub, dev)
        c = fused_dctq.encode_blocks_pairs(x, t.m, t.bias, sub)
        nm, g = c.shape[0], c.shape[1] // 64
        r = ops.mcu_grid(h, w, sub)[1]
        d = scan.dc_diffs_from_dc(c[:, ::64], n_luma, r).reshape(-1)
        k = entropy_pack.block_classes(nm, g, n_luma, dev)
        blocks = c.reshape(-1, 64)
        cases[f"K7 {sub} rows"] = (
            blocks, k, d, entropy_pack.block_pack_plain(blocks, k, d, *luts))
    libs = build(names)

    def runner(name, case):
        blocks, k, d, _ = cases[case]
        n = blocks.shape[0]
        out = torch.empty((n, entropy_pack.BLOCK_WORDS), dtype=torch.int32,
                          device=dev)
        lens = torch.empty((n,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = libs[name].jt_block_pack(
                blocks.data_ptr(), k.data_ptr(), d.data_ptr(),
                *(t.data_ptr() for t in luts), out.data_ptr(),
                lens.data_ptr(), n, stream)
            if err:
                raise RuntimeError(f"{name} {case}: CUDA error {err}")
        return run, out, lens

    for name in names:
        bad = 0
        for case, (*_, twin) in cases.items():
            run, out, lens = runner(name, case)
            out.fill_(chip_smoke.SENTINEL)
            run()
            torch.cuda.synchronize()
            bad += int((out != twin[0]).sum() + (lens != twin[1]).sum())
        print(f"[parity] {name}: {bad} mismatches against the twin on "
              f"{', '.join(cases)} (whole rows, lengths)")
        if bad:
            raise AssertionError(f"variant {name}: {bad} mismatches")
    times = {}
    for order, seq in (("forward", names), ("backward", names[::-1])):
        for name in seq:
            for case in cases:
                times[order, name, case] = chip_smoke.kernel_device_ms(
                    runner(name, case)[0], "::block_pack_kernel(", reps=20)
    for name in names:
        cells = "; ".join(f"{case} {times['forward', name, case]} / "
                          f"{times['backward', name, case]} ms"
                          for case in cases)
        print(f"[time] {name} (forward / backward): {cells}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
