"""GPU smoke test of jpegtpu_torch: build the fourteen CUDA kernels, hold
each against its plain torch twin on the card at 3840x2160, drive every encode
path (``jpegtpu_torch.encode``: 4:2:0 with a restart marker every MCU row,
the main path; 4:2:0 with no restart markers, with a ragged interval and
with a marker after every MCU; 4:2:2, 4:4:4 (also with a marker after every
MCU), 4:4:4s and gray; 4:2:0 rows and restart 0 stuffed on the host,
``device_stuff=False``; the pixel-path selectors: ``fuse_bp`` at 4:2:0
rows and restart 0, 4:2:2 and 4:4:4, ``pixel_path`` "dma" and "xla" and
``JPEGTPU_PIXEL_DC``'s route at 4:2:0 rows; the i8-view pixel kernel
through its entry point; ``jpegtpu_torch.encode_batch`` of 8 x 1920x1080
with ``device_stuff`` on and off and with ``fuse_bp``) and check its
bytes, drive jpegtpu's oracle tier (``block_pack``, ``mcu_merge``,
``seg_merge``, ``seg_merge_v2``, ``seg_merge_v3``) at 4:2:0 rows, 4:2:0
restart 0 and 4:4:4 rows and check each rung's segments against the
encode path's, then time everything.

    python3 chip_smoke.py

Needs one CUDA GPU of compute capability 9.0 (Hopper) and ``nvcc``; exits
non-zero, printing no result, without them. Each phase prints a line and
raises on failure. The last line is a JSON object with ``"ok": true``.
The package imports no JAX: the 1920x1080 golden hashes below tie the
card's output to jpegtpu's (``tests/test_torch_encoder.py`` and
``tests/test_torch_modes.py`` pin them to ``jpegtpu.encode``'s bytes).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time

import numpy as np

QUALITY = 90
BENCH_SHAPE = (2160, 3840)
GOLDEN_SHAPE = (1080, 1920)
# sha256 of jpegtpu.encode(golden_image(), quality=90, subsampling="420").
GOLDEN_SHA256 = "09075b2c8fee7778657b237bee596408452841144052381a2947bb0419199dea"
# The other paths' golden files at quality 90: name -> (subsampling,
# restart_interval, image name in golden_input, sha256 of jpegtpu.encode).
GOLDENS = {
    "420 restart 0": (
        "420", 0, "rings",
        "edbb1641a3d47cf8c9cd5ec5e3f42843acf5b2ed5b8e5985d2a833ff72b45618"),
    "422": (
        "422", "rows", "rings422",
        "8c5397c934809701caca680ca950d1df0880fb67ae74b9122e1e1055bfbc20a1"),
    "444": (
        "444", "rows", "blocks",
        "f4feda11a921149a509522b9cb15ed8e1fa9ffaf1a30afe54c27444d04a9b6fa"),
    "444s": (
        "444s", "rows", "blocks",
        "13ba1f350516e279e1db13f3c4985440ea2584c3f025559b0dddd79ca9fd8c19"),
    "gray": (
        "gray", "rows", "blocks_gray",
        "f21611fef2c16ddeef50cfb8e12378d9a4e5d3d5bd3c0acc9bf37b51f20e1837"),
}
# The encode paths at 3840x2160 (subsampling, restart_interval); the first
# is the main path.
PATHS = (("420", "rows"), ("420", 0), ("420", 7), ("420", 1),
         ("422", "rows"), ("444", "rows"), ("444", 1), ("444s", "rows"),
         ("gray", "rows"))
# The 3840x2160 paths stuffed on the host (device_stuff=False).
HOST_STUFF_PATHS = (("420", "rows"), ("420", 0))
# The 3840x2160 paths of the pixel-path selectors: (subsampling,
# restart_interval, EncoderConfig fields; "pixel_dc" sets
# fused_dctq.PIXEL_DC, JPEGTPU_PIXEL_DC's flag, for the path).
SELECTOR_PATHS = (("420", "rows", {"fuse_bp": True}),
                  ("420", 0, {"fuse_bp": True}),
                  ("422", "rows", {"fuse_bp": True}),
                  ("444", "rows", {"fuse_bp": True}),
                  ("420", "rows", {"pixel_path": "dma"}),
                  ("420", "rows", {"pixel_path": "xla"}),
                  ("420", "rows", {"pixel_dc": True}))
BATCH = 8                  # images of GOLDEN_SHAPE in the batch paths
# The paths whose device time the profiler splits by kernel (with their
# selectors).
PROFILED = (("420", "rows", {}), ("420", 0, {}), ("420", 7, {}),
            ("420", 1, {}), ("444", 1, {}), ("420", "rows", {"fuse_bp": True}),
            ("422", "rows", {"fuse_bp": True}),
            ("444", "rows", {"fuse_bp": True}),
            ("420", "rows", {"pixel_path": "dma"}),
            ("420", "rows", {"pixel_dc": True}))
TIMING_REPS = 20
# Profiler keys of the segment-merge body's instances <kPad, kZeroTail,
# kSplit>.
K3_KEY = "seg_merge_mcu_kernel<true, false, 256>"
K10_KEY = "seg_merge_mcu_kernel<true, true, 512>"
K8_KEY = "seg_merge_mcu_kernel<false, true, 512>"
K9_KEY = "seg_merge_mcu_kernel<true, true, 256>"
# Launches of each stuffing wrapper on each stuffing input in phase 3.
STUFF_REPEATS = 20
# Qualities at which phase 3 holds K1 and K12 (every geometry), K13 and K14
# (4:2:0) against the dense twin.
PIXEL_QUALITIES = (1, 50, 90, 100)
# What a buffer holds before a kernel writes it, where a check must show
# that every value was written.
SENTINEL = 0x7FFFFFFF
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float64 FLOP/s (the tensor-core rate, the card's highest for float64).
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 67e12


def bench_image(h: int = BENCH_SHAPE[0], w: int = BENCH_SHAPE[1]) -> np.ndarray:
    """bench.py's synthetic content: smooth gradients plus sensor noise."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 97.0) * np.cos(yy / 53.0)
    return np.clip(base[..., None] + rng.normal(0, 12, (h, w, 3)),
                   0, 255).astype(np.uint8)


def golden_image(h: int = GOLDEN_SHAPE[0], w: int = GOLDEN_SHAPE[1],
                 rings=((1104, 876, 1088), (304, 476, 1185),
                        (804, 776, 1282))) -> np.ndarray:
    """Elliptic rings, one (centre x, centre y, divisor) per channel, in
    integer arithmetic only, so every machine makes the same pixels. The
    centres were chosen so that no coefficient lies near a rounding tie:
    jpegtpu's float32 product rounds a few such coefficients of most 1080p
    images differently from the exact value (ROADMAP.md, faults 3.1). The
    default is tie-free for 4:2:0, the 4:2:2 rings in golden_input for
    4:2:2."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.int64)
    chans = [((xx - cx) ** 2 + 2 * (yy - cy) ** 2) // d % 256
             for cx, cy, d in rings]
    return np.stack(chans, axis=-1).astype(np.uint8)


def golden_blocks(h: int = GOLDEN_SHAPE[0], w: int = GOLDEN_SHAPE[1],
                  planes: int = 3) -> np.ndarray:
    """Tie-free by construction at q90, for 4:4:4, 4:4:4s and gray: every
    8x8 block of a plane is a + b*s(x) + c*s(y) + d*s(x)*s(y), with s the
    sign pattern of the DCT's 4th basis vector (+ - - + + - - +), so its
    only nonzero coefficients are the 4 whose basis is rational, with
    exact values 8a - 1024, 8b, 8c, 8d. At q90 their quantizers are odd
    (3, 5, 3, 17) and B equals G, so Cb and Cr are 4(R - G) over odd
    quantizers too: no exact value lies within 1e-4 of x.5. The block
    parameters come from an integer hash of the block's position."""
    by, bx = np.mgrid[0:h // 8, 0:w // 8].astype(np.int64)
    s = np.array([1, -1, -1, 1, 1, -1, -1, 1])
    sx, sy = s[None, None, None, :], s[None, :, None, None]
    out = []
    for ch in range(min(planes, 2)):
        k = (by * 7919 + bx * 104729 + by * bx * 31 + ch * 65537) % 1000003
        a = 40 + k % 176
        amp = np.minimum(a, 255 - a) // 3
        b, c, d = ((k // m % 3 - 1) * amp for m in (176, 528, 1584))
        e = lambda t: t[:, None, :, None]  # noqa: E731
        blk = e(a) + e(b) * sx + e(c) * sy + e(d) * sx * sy
        out.append(blk.reshape(h, w).astype(np.uint8))
    if planes == 1:
        return out[0]
    return np.stack([out[0], out[1], out[1]], axis=-1)


def batch_images(full: np.ndarray) -> np.ndarray:
    """[BATCH, 1080, 1920, 3]: golden_image() first, then 1920x1080 crops
    of the 3840x2160 bench image at fixed offsets."""
    h, w = GOLDEN_SHAPE
    offsets = ((0, 0), (0, 1920), (1080, 0), (1080, 1920), (540, 960),
               (37, 101), (1000, 1777))
    crops = [full[y:y + h, x:x + w] for y, x in offsets[:BATCH - 1]]
    return np.stack([golden_image()] + crops)


def golden_input(name: str) -> np.ndarray:
    """The golden images by name (see GOLDENS)."""
    if name == "rings":
        return golden_image()
    if name == "rings422":
        return golden_image(rings=((1515, 961, 1168), (346, 254, 1268),
                                   (1343, 990, 1220)))
    return golden_blocks(planes=1 if name == "blocks_gray" else 3)


def operator_fmas(m: np.ndarray, subsampling: str) -> int:
    """Multiply-adds per MCU that the fused product of operator m [in, out]
    needs: a column reads the exact integer sum of the pixels that one
    chroma sample covers (2x2 in 4:2:0 and 4:4:4s, 1x2 in 4:2:2; summed
    once per MCU) once where its weights over them are equal, and each
    other nonzero weight once. Inputs are MCU pixels (y, x, c) row-major."""
    from jpegtpu_torch.kernels import fused_dctq
    mh, mw, _, _ = fused_dctq.fused_geometry(subsampling)
    gy, gx = {"420": (2, 2), "422": (1, 2), "444s": (2, 2)}.get(subsampling,
                                                               (1, 1))
    g = m.reshape(mh // gy, gy, mw // gx, gx, 3, -1).transpose(0, 2, 4, 1, 3,
                                                               5)
    g = g.reshape(mh // gy, mw // gx, 3, gy * gx, -1)
    same = (g == g[..., :1, :]).all(axis=3)
    nz = g != 0
    return int(np.where(same, nz[..., 0, :], nz.sum(axis=3)).sum())


def ptxas_entries(log: str, names) -> list:
    """(kernel, "registers, spills, stack") for each kernel in an nvcc
    -Xptxas -v log whose mangled name holds one of names; the kernel named
    by its name and template arguments as they appear in the mangled one."""
    out, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m or not any(n in m.group(1) for n in names):
            continue
        name = next(n for n in names if n in m.group(1))
        args = re.search(name + r"(I\S*?E)E", m.group(1))
        props = " ".join(x.strip().replace("ptxas info    : ", "")
                         for x in lines[i + 2:i + 4])
        out.append((name + (args.group(1) if args else ""), props))
    return out


def card_line() -> str:
    """`name, power.limit` of GPU 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_scan_structure(jpg: bytes, n_rst: int) -> None:
    """SOI ... EOI, exactly n_rst RST markers numbered 0xD0 + i % 8 in
    order, and every other 0xFF in the scan followed by 0x00."""
    if jpg[:2] != b"\xff\xd8" or jpg[-2:] != b"\xff\xd9":
        raise AssertionError("missing SOI/EOI")
    sos = jpg.find(b"\xff\xda")
    scan_start = sos + 2 + int.from_bytes(jpg[sos + 2:sos + 4], "big")
    body = np.frombuffer(jpg[scan_start:-2], np.uint8)
    ff = np.flatnonzero(body == 0xFF)
    if ff.size and ff[-1] == body.size - 1:
        raise AssertionError("scan ends in a bare 0xFF")
    nxt = body[ff + 1]
    is_rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    rst = int(np.count_nonzero(is_rst))
    bad = int(np.count_nonzero((nxt != 0) & ~is_rst))
    if bad or rst != n_rst:
        raise AssertionError(f"scan structure: {rst} RST markers (want "
                             f"{n_rst}), {bad} unstuffed 0xFF bytes")
    if not np.array_equal(nxt[is_rst], 0xD0 + np.arange(rst) % 8):
        raise AssertionError("RST markers out of order")


def profile_device_encode(fn, wall_ms: float, card: str, reps: int = 5,
                          top: int = 14) -> None:
    """Device time by kernel over `reps` runs of fn (torch.profiler), the
    device's busy share of the CUDA-event time of one run, the host ops
    that take the most time, and the host's time to enqueue one run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return e.self_device_time_total

    # Kernels and copies are the events that run on the device itself; an
    # aten op's device time would count its kernels a second time.
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / reps / 1e3
    if not rows:
        print("[profile] device time: not measured (no CUDA events traced)")
        return
    n_ops = sum(e.count for e in rows) / reps
    print(f"[profile] device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms per "
          f"encode (idle share {1 - busy_ms / wall_ms:.3f}), {n_ops:g} "
          f"device launches per encode (kernels, memsets, copies)  [{card}]")
    for e in rows[:top]:
        print(f"[profile] {dev_us(e) / reps / 1e3:9.4f} ms  "
              f"x{e.count // reps:<3d} {e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host[:8]:
        print(f"[profile] host {e.self_cpu_time_total / reps / 1e3:9.4f} ms"
              f"  x{e.count // reps:<3d} {e.key[:80]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    print(f"[profile] host enqueue {enqueue_ms:.4f} ms per encode (no sync)")


def kernel_device_ms(fn, *keys: str, reps: int = 5) -> float | str:
    """Device time of the kernels whose name holds every one of `keys`, per
    call of fn (torch.profiler), or "not measured" when no such kernel was
    traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.self_device_time_total for e in prof.key_averages()
          if all(k in e.key for k in keys)]
    return sum(us) / reps / 1e3 if us else "not measured"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    import jpegtpu_torch
    from jpegtpu_torch.config import EncoderConfig
    from jpegtpu_torch.container import jfif
    from jpegtpu_torch.core import ops
    from jpegtpu_torch import native
    from jpegtpu_torch.encoder import (EncoderTables, device_encode,
                                       device_encode_batch, geometry)
    from jpegtpu_torch.entropy import scan
    from jpegtpu_torch.kernels import (_build, compact, entropy_oracles,
                                       entropy_pack, fused_dctq,
                                       fused_pipeline)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()

    # 1. Banner
    cap = torch.cuda.get_device_capability(0)
    print(f"[banner] {name} cc={cap[0]}.{cap[1]} torch={torch.__version__} "
          f"cuda={torch.version.cuda} devices={torch.cuda.device_count()}")
    print(f"[banner] nvidia-smi: {card}")
    if cap != (9, 0):
        raise AssertionError(f"expected compute capability 9.0, got {cap}")

    # 2. Build (one nvcc per source, all at once, then one link)
    secs = _build.build()
    lib = _build.library_path()
    print(f"[build] {lib.name} from {', '.join(_build.SOURCES)} "
          f"in {secs:.1f} s")
    build_log = lib.with_suffix(".log").read_text()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")
    klib = _build.library()
    klib.jt_pixel_smem.argtypes = [ctypes.c_int] * 3
    klib.jt_pixel_smem.restype = klib.jt_pixel_dma_smem.restype = ctypes.c_int
    klib.jt_pixel_dma_smem.argtypes = []
    klib.jt_fused_px_bp_smem.argtypes = [ctypes.c_int] * 2
    klib.jt_fused_px_bp_smem.restype = ctypes.c_int
    # K1, K12 (four geometries each), K13, K14 and K11 (three geometries):
    # registers, spills and shared memory; pixel_mma_kernel's last two
    # template arguments are kI8 (K13) and kDc (K12), fused_px_bp_kernel's
    # the MCU's height and width and the tile's MCUs.
    for kernel, props in ptxas_entries(build_log, ("pixel_mma_kernel",
                                                   "pixel_dma_kernel",
                                                   "fused_px_bp_kernel")):
        dims = tuple(int(v) for v in re.findall(r"Li(\d+)E", kernel))
        smem = (klib.jt_fused_px_bp_smem(*dims[:2])
                if kernel.startswith("fused_px_bp") else
                klib.jt_pixel_smem(*dims[:3]) if dims
                else klib.jt_pixel_dma_smem())
        print(f"[build] {kernel}: {props}; dynamic shared memory {smem} "
              f"bytes a block")
    # The segment-merge body's instances, by <kPad, kZeroTail, kSplit>: K3
    # <1, 0, 256>, K10 <1, 1, 512>, K8 <0, 1, 512>, K9 <1, 1, 256>; K2's
    # instances <kDerive, kG> and K7.
    for kernel, props in ptxas_entries(build_log, ("seg_merge_mcu_kernel",
                                                   "block_pack_mcu_kernel",
                                                   "block_pack_kernel")):
        print(f"[build] {kernel}: {props}")

    # 3. Each kernel against its plain twin, at the paths' shapes.
    h, w = BENCH_SHAPE
    img = bench_image()
    x = torch.from_numpy(img).to(dev)
    tabs = {sub: EncoderTables.for_quality(QUALITY, sub, dev)
            for sub in ("420", "422", "444", "444s", "gray")}
    tables = tabs["420"]
    luts = tables.luts()
    my, mx = ops.mcu_grid(h, w, "420")
    n_mcu, n_seg, restart = my * mx, my, mx

    def report(label, n_bad, err):
        # Integer outputs: the kernel must equal its twin exactly.
        print(f"[parity] {label}: {n_bad} mismatches, max_abs_err {err} "
              f"(tolerance 0)")
        if n_bad:
            raise AssertionError(f"{label} disagrees with its plain twin")

    def diff(a, b):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return int((d != 0).sum()), int(d.max()) if d.numel() else 0

    def stuff_diff(fn, plain, sw_, sb_, *args):
        buf_, tot_ = fn(sw_, sb_, *args)[:2]
        buf_p_, tot_p_ = plain(sw_, sb_, *args)[:2]
        tot_, tot_p_ = int(tot_), int(tot_p_)
        n_by, e_by = diff(buf_[:tot_], buf_p_[:tot_])
        return int(tot_ != tot_p_) + n_by, max(e_by, abs(tot_ - tot_p_)), tot_

    def stream_diff(w_, l_, w_p, l_p):
        """MCU streams against their twin's: the lengths, and the stream
        bits only (bit i of word j is kept while 32j+i < the length)."""
        j = torch.arange(w_.shape[1], device=dev)[None, :]
        valid = torch.clamp(l_.to(torch.int64)[:, None] - 32 * j, 0, 32)
        word_mask = (0xFFFFFFFF << (32 - valid)) & 0xFFFFFFFF
        n_len, e_len = diff(l_, l_p)
        n_w, e_w = diff((w_.to(torch.int64) & 0xFFFFFFFF) & word_mask,
                        (w_p.to(torch.int64) & 0xFFFFFFFF) & word_mask)
        return n_len + n_w, max(e_len, e_w)

    def run_path(kw, fn):
        """fn(fields): the EncoderConfig fields of a path's selectors, with
        fused_dctq.PIXEL_DC (JPEGTPU_PIXEL_DC's flag) set for the call
        when kw holds "pixel_dc", and restored after."""
        old = fused_dctq.PIXEL_DC
        fused_dctq.PIXEL_DC = bool(kw.get("pixel_dc"))
        try:
            return fn({k: v for k, v in kw.items() if k != "pixel_dc"})
        finally:
            fused_dctq.PIXEL_DC = old

    def compact_diff(sw_, sb_):
        """K6 against its twin: the byte counts, and the first sum(nbytes)
        bytes of the stream."""
        buf_, nb_ = compact.compact_segments(sw_, sb_)
        buf_p_, nb_p_ = compact.compact_segments_plain(sw_, sb_)
        tot_ = int(nb_p_.sum())
        n_nb, e_nb = diff(nb_, nb_p_)
        n_by, e_by = diff(buf_[:tot_], buf_p_[:tot_])
        return n_nb + n_by, max(e_nb, e_by), tot_

    def seg_diff(sw_, sb_, sw_p, sb_p):
        """Segments against their twin's: seg_bits, and each segment's
        first ceil(seg_bits / 8) bytes (the card leaves the rest
        undefined)."""
        n_b, e_b = diff(sb_, sb_p)
        nb = (sb_p.to(torch.int64) + 7) // 8
        keep = (compact._stream_pos(sw_.shape[1], dev)[None, :] <
                nb[:, None])
        by = sw_.contiguous().view(torch.uint8).reshape(sw_.shape[0], -1)
        by_p = sw_p.contiguous().view(torch.uint8).reshape(sw_.shape[0], -1)
        d = (by.to(torch.int64) - by_p.to(torch.int64)).abs() * keep
        return n_b + int((d != 0).sum()), max(e_b, int(d.max()) if
                                               d.numel() else 0)

    def past(words, nbits):
        """Words of each row at or past ceil(nbits / 32) that are not
        SENTINEL: written where nothing may be."""
        j = torch.arange(words.shape[1], device=dev)[None, :]
        beyond = j >= (nbits.to(torch.int64)[:, None] + 31) // 32
        return int((beyond & (words != SENTINEL)).sum())

    def seg_set(c, sub, r):
        """(segment words, seg_bits, r) of coefficients c at interval r,
        through K2 and K3 as the encoder calls them."""
        ns, mps = geometry(c.shape[0], r)
        a, bl = entropy_pack.block_pack_mcu_segments(
            c, EncoderConfig(subsampling=sub).n_luma, r, luts)
        return (*entropy_pack.seg_merge_mcu(a, bl, ns, mps), r)

    errs = {}
    coeffs = fused_dctq.encode_blocks_pairs(x, tables.m, tables.bias)
    coeffs_p = fused_dctq.encode_blocks_pairs_plain(x, tables.m, tables.bias)
    torch.cuda.synchronize()
    n_bad, errs["pixel"] = diff(coeffs, coeffs_p)
    report(f"K1 pixel 420 coefficients {tuple(coeffs.shape)}", n_bad,
           errs["pixel"])
    # The factored tensor-core product at the qualities PIXEL_QUALITIES
    # against the dense twin: K1 and K12 (its DC plane too) in every
    # geometry, K13 (the int8 view) and K14 (bulk copies) at 4:2:0.
    errs.update(pixel_dc=0, pixel_i8=0, pixel_dma=0)

    def with_dc(img_, m_, bias_, sub_):
        return fused_dctq.encode_blocks_pairs(img_, m_, bias_, sub_,
                                              with_dc=True)

    for q in PIXEL_QUALITIES:
        for sub in ("420", "422", "444", "444s"):
            t = (tabs[sub] if q == QUALITY
                 else EncoderTables.for_quality(q, sub, dev))
            c_p = fused_dctq.encode_blocks_pairs_plain(x, t.m, t.bias, sub)
            routes = {"K1": (fused_dctq.encode_blocks_pairs, "pixel"),
                      "K12": (with_dc, "pixel_dc")}
            if sub == "420":
                routes["K13"] = (fused_dctq.encode_blocks_i8_pairs,
                                 "pixel_i8")
                routes["K14"] = (fused_dctq.encode_blocks_dma_pairs,
                                 "pixel_dma")
            for label, (fn, err_key) in routes.items():
                got = fn(x, t.m, t.bias, sub)
                c_k, dc_k = got if isinstance(got, tuple) else (got, None)
                n_bad, e = diff(c_k, c_p)
                what = f"coefficients {tuple(c_k.shape)}"
                if dc_k is not None:
                    n_d, e_d = diff(dc_k, fused_dctq.dc_plane(c_p))
                    n_bad, e = n_bad + n_d, max(e, e_d)
                    what += f" + DC plane {tuple(dc_k.shape)}"
                errs[err_key] = max(errs[err_key], e)
                report(f"{label} factored pixel {sub} q{q} {what} against "
                       f"the dense twin", n_bad, e)
                del got, c_k, dc_k
            del c_p

    # K12 launched directly onto buffers filled with SENTINEL and one MCU
    # row longer than the image, in every geometry: every coefficient and
    # plane lane of the image's MCUs is written (the zero lanes too), and
    # nothing past them.
    for sub in ("420", "422", "444", "444s"):
        t = tabs[sub]
        mh, mwid, _, n_out = fused_dctq.fused_geometry(sub)
        nm, nrx_ = (h // mh) * (w // mwid), w // mwid
        out_s = torch.full((nm + nrx_, n_out), SENTINEL, dtype=torch.int32,
                           device=dev)
        dc_s = torch.full((nm + nrx_, fused_dctq.DC_LANES), SENTINEL,
                          dtype=torch.int32, device=dev)
        lum, chroma = fused_dctq.cuda_factors(t.m, t.bias, sub)
        fused_dctq.PIXEL_DC_PLANE.launch(
            dev, x.data_ptr(), lum.data_ptr(), chroma.data_ptr(),
            t.bias.data_ptr(), out_s.data_ptr(), dc_s.data_ptr(), nm, nrx_,
            w * 3, mh, mwid, fused_dctq.chroma_groups(sub)[0])
        c_p = fused_dctq.encode_blocks_pairs_plain(x, t.m, t.bias, sub)
        n_c, e_c = diff(out_s[:nm], c_p)
        n_d, e_d = diff(dc_s[:nm], fused_dctq.dc_plane(c_p))
        n_past = int((out_s[nm:] != SENTINEL).sum() +
                     (dc_s[nm:] != SENTINEL).sum())
        report(f"K12 jt_pixel_dc {sub} onto sentinel buffers of {nm} + "
               f"{nrx_} MCUs: coefficients + DC plane of the {nm}, and "
               f"{n_past} values written past them", n_c + n_d + n_past,
               max(e_c, e_d))
        del out_s, dc_s, c_p

    # K2 (both launchers) and K3 on the inputs of every encode path: the
    # coefficients of its pixel route (the staged ops for gray; K12's DC
    # plane on the PIXEL_DC route) at its interval. Each wrapper
    # STUFF_REPEATS times against the twins (K2: lengths and stream bits;
    # K3: seg_bits and each segment's first ceil(seg_bits / 8) bytes), and
    # each launcher once onto SENTINEL-filled outputs: K2 writes the first
    # ceil(mlen / 32) words of each MCU row and nothing past them, K3 the
    # first ceil(seg_bits / 32) words of each segment (the 1-padded byte,
    # then zeros, as the twin's) and nothing past them. Then the consumers
    # on those SENTINEL segments (0xFF bytes past every segment's data): the
    # stuffing kernel (K4, or K5 for one segment) and K6 against their twins
    # on the twin's zero-filled segments.
    def k2k3_inputs():
        for sub_, ri in PATHS:
            t_ = tabs[sub_]
            xi = x[..., 0].contiguous() if sub_ == "gray" else x
            if fused_dctq.uses_fused(h, w, sub_):
                c_ = fused_dctq.encode_blocks_pairs(xi, t_.m, t_.bias, sub_)
            else:
                c_ = ops.encode_blocks(xi, t_.block_m, t_.block_bias, sub_)
                c_ = c_.reshape(c_.shape[0], -1)
            yield f"{sub_} restart {ri!r}", sub_, c_, None, ri
        c_, dc_ = fused_dctq.encode_blocks_pairs(x, tables.m, tables.bias,
                                                 with_dc=True)
        yield "420 rows, PIXEL_DC (K12's DC plane)", "420", c_, dc_, "rows"
        c_ = fused_dctq.encode_blocks_batch(
            torch.from_numpy(batch_images(img)).to(dev), tables, "420")
        yield f"batch {BATCH} x 1080p 420 rows", "420", c_, None, bmx

    bmy, bmx = ops.mcu_grid(*GOLDEN_SHAPE, "420")
    errs.update(block_pack=0, seg_merge=0)
    for label, sub, c, dc, ri in k2k3_inputs():
        cfg = EncoderConfig(subsampling=sub, restart_interval=ri)
        r = cfg.resolve_restart(ops.mcu_grid(h, w, sub)[1])
        nm, g = c.shape[0], c.shape[1] // 64
        mw_ = entropy_pack.mcu_words(g)
        ns, mps = geometry(nm, r)
        nl = cfg.n_luma
        mw_p, ml_p = entropy_pack.block_pack_mcu_segments_plain(
            c, nl, r, luts, dc)
        dcd_ = scan.dc_diffs_from_dc(c[:, ::64] if dc is None else
                                     dc[:, :g], nl, r).reshape(-1)
        cls_ = entropy_pack.block_classes(nm, g, nl, dev)
        n_bad = e = n_past = 0
        for _ in range(STUFF_REPEATS):
            for got in (entropy_pack.block_pack_mcu_segments(c, nl, r, luts,
                                                             dc),
                        entropy_pack.block_pack_mcu_pairs(c, cls_, dcd_,
                                                          *luts)):
                n_, e_ = stream_diff(*got, mw_p, ml_p)
                n_bad, e = n_bad + n_, max(e, e_)
        a_s = torch.full((nm, mw_), SENTINEL, dtype=torch.int32, device=dev)
        l_s = torch.full((nm,), SENTINEL, dtype=torch.int32, device=dev)
        src, strides = (c, (g * 64, 64)) if dc is None else (dc, (8, 1))
        lut_ptrs = [t.data_ptr() for t in luts]
        entropy_pack.BLOCK_PACK_SEGMENTS.launch(
            dev, c.data_ptr(), src.data_ptr(), *strides, *lut_ptrs,
            a_s.data_ptr(), l_s.data_ptr(), nm, g, nl, r, mw_)
        b_s = torch.full_like(a_s, SENTINEL)
        bl_s = torch.full_like(l_s, SENTINEL)
        entropy_pack.BLOCK_PACK.launch(
            dev, c.data_ptr(), cls_.data_ptr(), dcd_.data_ptr(), *lut_ptrs,
            b_s.data_ptr(), bl_s.data_ptr(), nm, g, mw_)
        for ws, ls in ((a_s, l_s), (b_s, bl_s)):
            n_, e_ = stream_diff(ws, ls, mw_p, ml_p)
            n_bad, e, n_past = n_bad + n_, max(e, e_), n_past + past(ws,
                                                                    ml_p)
        errs["block_pack"] = max(errs["block_pack"], e)
        report(f"K2 block pack {label}: {nm} MCUs of {g} blocks, both "
               f"launchers {STUFF_REPEATS} times and onto SENTINEL rows: "
               f"mlens + stream bits; {n_past} words written past "
               f"ceil(mlen / 32)", n_bad + n_past, e)
        del b_s, bl_s, dcd_, cls_

        sw_p, sb_p = entropy_pack.seg_merge_mcu_plain(mw_p, ml_p, ns, mps)
        n_bad = e = 0
        for _ in range(STUFF_REPEATS):
            n_, e_ = seg_diff(*entropy_pack.seg_merge_mcu(a_s, l_s, ns, mps),
                              sw_p, sb_p)
            n_bad, e = n_bad + n_, max(e, e_)
        seg_w = sw_p.shape[1]
        s_s = torch.full((ns, seg_w), SENTINEL, dtype=torch.int32,
                         device=dev)
        sb_s = torch.full((ns,), SENTINEL, dtype=torch.int32, device=dev)
        n_scr = entropy_pack.seg_merge_scratch_words(ns, mps)
        scr = torch.empty(max(n_scr, 1), dtype=torch.int64, device=dev)
        entropy_pack.SEG_MERGE.launch(
            dev, a_s.data_ptr(), l_s.data_ptr(), s_s.data_ptr(),
            sb_s.data_ptr(), scr.data_ptr() if n_scr else None, nm, ns, mps,
            mw_, seg_w)
        n_, e_ = seg_diff(s_s, sb_s, sw_p, sb_p)
        # The segment's valid words whole: the padded byte, then zeros.
        n_w, e_w = stream_diff(s_s, (sb_p.to(torch.int64) + 31) // 32 * 32,
                               sw_p, (sb_p.to(torch.int64) + 31) // 32 * 32)
        n_past = past(s_s, sb_p)
        errs["seg_merge"] = max(errs["seg_merge"], e, e_, e_w)
        report(f"K3 seg merge {label}: {ns} segments of {mps} MCUs"
               f"{' (the last ragged)' if ns * mps > nm else ''}, "
               f"{STUFF_REPEATS} launches and onto SENTINEL rows: seg_bits "
               f"+ the first ceil(seg_bits / 8) bytes, the valid words "
               f"whole; {n_past} words written past ceil(seg_bits / 32)",
               n_bad + n_ + n_w + n_past, max(e, e_, e_w))
        del a_s, l_s, mw_p, ml_p
        spi_ = ns // BATCH if "batch" in label else None
        stuff_k, stuff_p = ((compact.compact_segments_stuffed_grouped,
                             compact.compact_segments_stuffed_grouped_plain)
                            if ns > 1 else
                            (compact.compact_segments_stuffed,
                             compact.compact_segments_stuffed_plain))
        extra = (spi_,) if ns > 1 else ()
        buf_, got_tot = stuff_k(s_s, sb_s, r, *extra)[:2]
        want_, tot_ = stuff_p(sw_p, sb_p, r, *extra)[:2]
        tot_ = int(tot_)
        n_s, e_s = diff(buf_[:tot_], want_[:tot_])
        n_s += int(int(got_tot) != tot_)
        buf_, nb_ = compact.compact_segments(s_s, sb_s)
        want_, nb_p = compact.compact_segments_plain(sw_p, sb_p)
        n_c, e_c = diff(buf_[:int(nb_p.sum())], want_[:int(nb_p.sum())])
        n_nb, e_nb = diff(nb_, nb_p)
        report(f"{'K4' if ns > 1 else 'K5'} and K6 {label} on K3's SENTINEL "
               f"segments against their twins on the twin's: {tot_} "
               f"stuffed bytes, {int(nb_p.sum())} compacted",
               n_s + n_c + n_nb, max(e_s, e_c, e_nb))
        del s_s, sb_s, sw_p, sb_p, buf_, want_, c, dc

    # The main path's MCU streams and segments (K2 -> K3), and the
    # restart-0 program's single segment, for the checks and timings below.
    mw, ml = entropy_pack.block_pack_mcu_segments(coeffs, 4, restart, luts)
    sw, sb = entropy_pack.seg_merge_mcu(mw, ml, n_seg, restart)
    dcd = scan.dc_diffs_from_dc(coeffs[:, ::64], 4, restart).reshape(-1)
    cls = entropy_pack.block_classes(n_mcu, 6, 4, dev)
    mw0, ml0 = entropy_pack.block_pack_mcu_segments(coeffs, 4, 0, luts)
    sw0, sb0 = entropy_pack.seg_merge_mcu(mw0, ml0, 1, n_mcu)
    del mw0, ml0

    n_bad, errs["stuff"], total = stuff_diff(
        compact.compact_segments_stuffed_grouped,
        compact.compact_segments_stuffed_grouped_plain, sw, sb, restart)
    report(f"K4 stuffing, {n_seg} segments, total {total} bytes", n_bad,
           errs["stuff"])

    n_chunks = -(-sw0.shape[1] // compact.CHUNK_WORDS)
    live = -(-int(sb0[0]) // (8 * compact.CHUNK_BYTES))
    n_bad, errs["stuff_chunks"], total0 = stuff_diff(
        compact.compact_segments_stuffed,
        compact.compact_segments_stuffed_plain, sw0, sb0, 0)
    report(f"K5 chunk stuffing, restart 0: one segment, {live} live of "
           f"{n_chunks} chunks, total {total0} bytes", n_bad,
           errs["stuff_chunks"])
    n_bad, e, _ = stuff_diff(compact.compact_segments_stuffed,
                             compact.compact_segments_stuffed_plain, sw, sb,
                             restart)
    errs["stuff_chunks"] = max(errs["stuff_chunks"], e)
    report(f"K5 chunk stuffing, {n_seg} rows-restart segments", n_bad, e)

    # K6 on one segment set per layout: rows, one segment, one MCU each.
    sw1, sb1, _ = seg_set(coeffs, "420", 1)
    k6_sets = {"420 rows": (sw, sb), "420 restart 0": (sw0, sb0),
               "420 restart 1": (sw1, sb1)}
    errs["compact"] = 0
    for label, (sw_, sb_) in k6_sets.items():
        n_bad, e, tot = compact_diff(sw_, sb_)
        errs["compact"] = max(errs["compact"], e)
        report(f"K6 compaction, {label}: {sw_.shape[0]} segments of "
               f"{sw_.shape[1]} words, {tot} bytes", n_bad, e)

    # K4 with a marker table numbered within each image, on the segments
    # of the 8 x 1920x1080 batch (68 segments an image).
    batch = batch_images(img)
    xb = torch.from_numpy(batch).to(dev)
    swb, sbb, _ = seg_set(fused_dctq.encode_blocks_batch(xb, tables, "420"),
                          "420", bmx)
    n_bad, e, total_b = stuff_diff(
        compact.compact_segments_stuffed_grouped,
        compact.compact_segments_stuffed_grouped_plain, swb, sbb, bmx, bmy)
    off_k = compact.compact_segments_stuffed_grouped(swb, sbb, bmx, bmy)[2]
    off_p = compact.compact_segments_stuffed_grouped_plain(swb, sbb, bmx,
                                                           bmy)[2]
    n_off, e_off = diff(off_k, off_p)
    errs["stuff"] = max(errs["stuff"], e, e_off)
    report(f"K4 stuffing with per-image markers, {BATCH} images of {bmy} "
           f"segments, total {total_b} bytes, image offsets", n_bad + n_off,
           max(e, e_off))

    # K4 and K5 (one look-back kernel body, two launchers) launched
    # STUFF_REPEATS times each on every stuffing input of the paths, against
    # the twins' outputs: 4:2:0 rows, restart 0, restart 7, 4:4:4 restart 1
    # (129,600 one-tile segments), the batch with per-image markers (K5
    # given K4's marker table), and segments of all-0xFF words (every byte
    # stuffed, the capacity's worst case) at the main path's shape with
    # ragged byte counts. A race in the look-back would show as a mismatch
    # in some repeat.
    c444 = fused_dctq.encode_blocks_pairs(x, tabs["444"].m, tabs["444"].bias,
                                          "444")
    sw7, sb7, _ = seg_set(coeffs, "420", 7)
    sw444, sb444, _ = seg_set(c444, "444", 1)
    del c444
    rng = np.random.default_rng(0)
    ffw = torch.full_like(sw, -1)
    ffb = torch.from_numpy(rng.integers(0, 32 * sw.shape[1] + 1, n_seg)).to(
        dev, torch.int32)
    ffb[::9] = torch.from_numpy(8 * 4096 * rng.integers(    # whole tiles
        0, sw.shape[1] // 1024 + 1, ffb[::9].numel())).to(dev, torch.int32)
    stuff_inputs = {
        "420 rows": (sw, sb, restart, None),
        "420 restart 0": (sw0, sb0, 0, None),
        "420 restart 7": (sw7, sb7, 7, None),
        "444 restart 1": (sw444, sb444, 1, None),
        f"batch {BATCH} x 1080p, per-image markers": (swb, sbb, bmx, bmy),
        "all-0xFF words, ragged counts": (ffw, ffb, restart, None)}
    for label, (sw_, sb_, r_, spi_) in stuff_inputs.items():
        want = compact.compact_segments_stuffed_grouped_plain(sw_, sb_, r_,
                                                             spi_)
        tot_ = int(want[1])
        mnum_ = compact.marker_table(sw_.shape[0], r_, spi_, dev)
        runs = {"stuff": lambda: compact.compact_segments_stuffed_grouped(
                    sw_, sb_, r_, spi_),
                "stuff_chunks": lambda: compact.compact_segments_stuffed(
                    sw_, sb_, r_, mnum_)}
        for n, fn in runs.items():
            n_bad = e = 0
            for _ in range(STUFF_REPEATS):
                got = fn()
                n_by, e_by = diff(got[0][:tot_], want[0][:tot_])
                n_off, e_off = (diff(got[2], want[2]) if len(got) == 3
                                else (0, 0))
                n_bad += n_by + n_off + int(int(got[1]) != tot_)
                e = max(e, e_by, e_off, abs(int(got[1]) - tot_))
                del got
            errs[n] = max(errs[n], e)
            report(f"{'K4' if n == 'stuff' else 'K5'} {label}: "
                   f"{sw_.shape[0]} segments of {sw_.shape[1]} words, "
                   f"{tot_} bytes, {STUFF_REPEATS} launches: bytes, total"
                   f"{', image offsets' if n == 'stuff' else ''}", n_bad, e)
        del want
    del stuff_inputs, ffw, ffb

    # K11-K14, the kernels of the pixel-path selectors. K11 at 420 rows,
    # restart 0 (each block's run of tiles takes its first DC predictor
    # from the scalar dot products) and 7 (resets inside tiles), 422 rows
    # and 444 rows (odd g), the 8 x 1080p batch padded to whole MCUs and
    # viewed as one tall image (resets at every image start), and the
    # factored product's qualities PIXEL_QUALITIES at 420, 422 and 444
    # rows: the lengths and the stream bits against the twin's (the words
    # past ceil(mlen / 32) are undefined on the card, as K2's), through the
    # wrapper and through the launcher onto SENTINEL-filled outputs one MCU
    # row too long, which must show no word written past ceil(mlen / 32)
    # and no row past the image's MCUs.
    xb_fused = ops.pad_to_multiple(xb, ops.mcu_shape("420"))
    xb_fused = xb_fused.reshape(-1, *xb_fused.shape[2:])
    fused_cases = {"420 rows": (x, "420", restart, QUALITY),
                   "420 restart 0": (x, "420", 0, QUALITY),
                   "420 restart 7": (x, "420", 7, QUALITY),
                   f"batch {BATCH} x 1080p 420 rows":
                   (xb_fused, "420", bmx, QUALITY)}
    for q in PIXEL_QUALITIES:
        for sub in fused_pipeline.FUSED_MODES:
            if q != QUALITY or sub != "420":
                fused_cases[f"{sub} rows q{q}"] = (
                    x, sub, ops.mcu_grid(h, w, sub)[1], q)
    errs["fused_px_bp"] = 0
    for label, (xf, sub, r, q) in fused_cases.items():
        t = (tabs[sub] if q == QUALITY
             else EncoderTables.for_quality(q, sub, dev))
        fw, fl = fused_pipeline.fused_pixel_block_pack_pairs(xf, t, sub, r)
        fw_p, fl_p = fused_pipeline.fused_pixel_block_pack_pairs_plain(
            xf, t, sub, r)
        n_bad, e = stream_diff(fw, fl, fw_p, fl_p)
        mh, mwid = ops.mcu_shape(sub)
        nm, nrx_ = fw.shape[0], xf.shape[1] // mwid
        fw_s = torch.full((nm + nrx_, fw.shape[1]), SENTINEL,
                          dtype=torch.int32, device=dev)
        fl_s = torch.full((nm + nrx_,), SENTINEL, dtype=torch.int32,
                          device=dev)
        lum, chroma = fused_dctq.cuda_factors(t.m, t.bias, sub)
        fused_pipeline.FUSED_PX_BP.launch(
            dev, xf.data_ptr(), lum.data_ptr(), chroma.data_ptr(),
            t.bias.data_ptr(), *(u.data_ptr() for u in t.luts()),
            fw_s.data_ptr(), fl_s.data_ptr(), nm, nrx_, xf.shape[1] * 3, r,
            mh, mwid, fw.shape[1])
        n_s, e_s = stream_diff(fw_s[:nm], fl_s[:nm], fw_p, fl_p)
        n_past = past(fw_s[:nm], fl_p)
        n_rows = int((fw_s[nm:] != SENTINEL).sum() +
                     (fl_s[nm:] != SENTINEL).sum())
        errs["fused_px_bp"] = max(errs["fused_px_bp"], e, e_s)
        report(f"K11 fused pixel + block pack {label}: mlens "
               f"{tuple(fl.shape)} + stream bits {tuple(fw.shape)}, wrapped "
               f"and onto SENTINEL rows; {n_past} words written past "
               f"ceil(mlen / 32), {n_rows} values past the {nm} MCUs",
               n_bad + n_s + n_past + n_rows, max(e, e_s))
        del fw, fl, fw_p, fl_p, fw_s, fl_s
    del xb_fused
    # K12 is held above, in every geometry; K13 also against its own twin,
    # which restores + 128 from the view.
    x8 = fused_dctq.i8_view(x)
    n_bad, e = diff(
        fused_dctq.encode_blocks_i8_pairs(x, tables.m, tables.bias),
        fused_dctq.pixel_i8_plain(x8, tables.m, tables.bias))
    errs["pixel_i8"] = max(errs["pixel_i8"], e)
    report(f"K13 i8-view pixel 420 coefficients from the view "
           f"{tuple(x8.shape)} against the i8 twin", n_bad, e)

    # 4. Every path end to end, through the public entry point, each with
    # the launch counts set to 0 just before it and read just after. A
    # kernel's count is the sum over its launchers (K2 has two: jpegtpu's
    # signature and the encoder's).
    kernels = (("pixel", fused_dctq.PIXEL, "pixel_mma.cu",
                "jpegtpu/kernels/fused_dctq.py:388"),
               ("block_pack", (entropy_pack.BLOCK_PACK,
                               entropy_pack.BLOCK_PACK_SEGMENTS),
                "block_pack.cu", "jpegtpu/kernels/entropy_pack.py:619"),
               ("seg_merge", entropy_pack.SEG_MERGE, "seg_merge.cu",
                "jpegtpu/kernels/entropy_pack.py:879"),
               ("stuff", compact.STUFF, "stuff.cu",
                "jpegtpu/kernels/compact.py:1004"),
               ("stuff_chunks", compact.STUFF_CHUNKS, "stuff.cu",
                "jpegtpu/kernels/compact.py:317"),
               ("compact", compact.COMPACT, "compact.cu",
                "jpegtpu/kernels/compact.py:44"),
               ("block_pack_blocks", entropy_pack.PACK_BLOCKS,
                "block_pack.cu", "jpegtpu/kernels/entropy_pack.py:334"),
               ("mcu_merge", entropy_oracles.MCU_MERGE, "seg_merge.cu",
                "jpegtpu/kernels/entropy_oracles.py:33"),
               ("seg_merge_window", entropy_oracles.SEG_MERGE_WINDOW,
                "seg_merge.cu", "jpegtpu/kernels/entropy_oracles.py:125"),
               ("seg_merge_v1", entropy_oracles.SEG_MERGE_V1,
                "seg_merge.cu", "jpegtpu/kernels/entropy_oracles.py:266"),
               ("fused_px_bp", fused_pipeline.FUSED_PX_BP, "fused_px_bp.cu",
                "jpegtpu/kernels/fused_pipeline.py:57"),
               ("pixel_dc", fused_dctq.PIXEL_DC_PLANE, "pixel_mma.cu",
                "jpegtpu/kernels/fused_dctq.py:358"),
               ("pixel_i8", fused_dctq.PIXEL_I8, "pixel_mma.cu",
                "jpegtpu/kernels/fused_dctq.py:128"),
               ("pixel_dma", fused_dctq.PIXEL_DMA, "pixel_dma.cu",
                "jpegtpu/kernels/fused_dctq.py:246"))
    launches = {n: 0 for n, _, _, _ in kernels}

    def path_input(sub):
        return np.ascontiguousarray(img[..., 0]) if sub == "gray" else img

    def want_launches(sub, ns, kw):
        """Each kernel's launches in one 3840x2160 encode of a path with
        the selectors kw."""
        ds = kw.get("device_stuff", True)
        fuse = bool(kw.get("fuse_bp")) and sub in fused_pipeline.FUSED_MODES
        split_px = fused_dctq.uses_fused(h, w, sub) and not fuse
        route = kw.get("pixel_path", "nat")
        dc = bool(kw.get("pixel_dc"))
        return {"pixel": int(split_px and route == "nat" and not dc),
                "block_pack": int(not fuse), "seg_merge": 1,
                "stuff": int(ds and ns > 1),
                "stuff_chunks": int(ds and ns == 1),
                "compact": int(not ds), "block_pack_blocks": 0,
                "mcu_merge": 0, "seg_merge_window": 0, "seg_merge_v1": 0,
                "fused_px_bp": int(fuse),
                "pixel_dc": int(split_px and route == "nat" and dc),
                "pixel_i8": 0,
                "pixel_dma": int(split_px and route == "dma" and sub == "420")}

    def selectors(kw):
        return "".join(f" {k}={v}" for k, v in kw.items())

    def path_geometry(image, sub, restart_interval):
        cfg = EncoderConfig(quality=QUALITY, subsampling=sub,
                            restart_interval=restart_interval)
        hh, ww = image.shape[:2]
        pmy, pmx = ops.mcu_grid(hh, ww, sub)
        r = cfg.resolve_restart(pmx)
        return cfg, r, geometry(pmy * pmx, r)

    def encode_plain(image, sub, restart_interval, device_stuff=True):
        """The same program on the plain twins, on the card (without
        device_stuff: the compaction twin, then the host stuffing)."""
        cfg, r, (ns, mps) = path_geometry(image, sub, restart_interval)
        hh, ww = image.shape[:2]
        t = tabs[sub]
        xi = torch.from_numpy(image).to(dev)
        if fused_dctq.uses_fused(hh, ww, sub):
            c = fused_dctq.encode_blocks_pairs_plain(xi, t.m, t.bias, sub)
        else:
            c = ops.encode_blocks(xi, t.block_m, t.block_bias, sub)
            c = c.reshape(c.shape[0], -1)
        a, bl = entropy_pack.block_pack_mcu_segments_plain(c, cfg.n_luma, r,
                                                           luts)
        s, sbits = entropy_pack.seg_merge_mcu_plain(a, bl, ns, mps)
        if not device_stuff:
            out, nb = compact.compact_segments_plain(s, sbits)
            nb = nb.cpu().numpy()
            scan_bytes = native.stuff_assemble_contig(
                out[:int(nb.sum())].cpu().numpy(), nb, r)
        else:
            stuff = (compact.compact_segments_stuffed_grouped_plain
                     if ns > 1 else compact.compact_segments_stuffed_plain)
            out, tot = stuff(s, sbits, r)[:2]
            scan_bytes = out[:int(tot)].cpu().numpy().tobytes()
        return jfif.wrap_jpeg(hh, ww, QUALITY, sub, r, scan_bytes)

    def handles(k):
        return k if isinstance(k, tuple) else (k,)

    def counted(fn):
        """fn() with every launch count set to 0 just before it; (its
        result, the launches it made per kernel)."""
        for _, k, _, _ in kernels:
            for kh in handles(k):
                kh.launches = 0
        out = fn()
        counts = {n: sum(kh.launches for kh in handles(k))
                  for n, k, _, _ in kernels}
        for n in launches:
            launches[n] += counts[n]
        return out, counts

    for sub, restart_interval, kw in (
            [(sub, r, {}) for sub, r in PATHS] +
            [(sub, r, {"device_stuff": False})
             for sub, r in HOST_STUFF_PATHS] + list(SELECTOR_PATHS)):
        image = path_input(sub)
        _, r, (ns, _) = path_geometry(image, sub, restart_interval)
        want = want_launches(sub, ns, kw)
        jpg, counts = counted(lambda: run_path(kw, lambda f: (
            jpegtpu_torch.encode(image, quality=QUALITY, subsampling=sub,
                                 restart_interval=restart_interval, **f))))
        label = (f"{w}x{h} q{QUALITY} {sub} restart {restart_interval!r}"
                 f"{selectors(kw)}")
        print(f"[e2e] encode {label}: {len(jpg)} bytes, launches {counts}")
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, want {want}")
        if jpg != encode_plain(image, sub, restart_interval,
                               kw.get("device_stuff", True)):
            raise AssertionError(f"{label}: bytes differ from the "
                                 f"plain-twin pipeline")
        n_rst = ns - 1 if r > 0 else 0
        check_scan_structure(jpg, n_rst)
        print(f"[e2e] {label}: bytes equal to the plain-twin pipeline on "
              f"the GPU; {n_rst} RST markers in order; stuffing valid")

    # The i8-view kernel's entry point (jpegtpu's encode_blocks_pallas_pairs,
    # which no encode path of jpegtpu takes either): one launch, the
    # coefficients of the pixel twin.
    got8, counts = counted(lambda: fused_dctq.encode_blocks_i8_pairs(
        x, tables.m, tables.bias))
    want = dict.fromkeys(counts, 0)
    want["pixel_i8"] = 1
    if counts != want or diff(got8, coeffs_p)[0]:
        raise AssertionError(f"encode_blocks_i8_pairs: launches {counts}, "
                             f"want {want}, or coefficients differ")
    print(f"[e2e] fused_dctq.encode_blocks_i8_pairs {w}x{h} 420: launches "
          f"{counts}; coefficients equal to the pixel twin's")
    del got8

    # The batch paths: one program over 8 x 1920x1080 (golden_image()
    # first), each kernel launched once (with fuse_bp the fused kernel in
    # place of K1 and K2), every file equal to the per-image encode of its
    # image, RST markers 0..7 from each image's start, and golden_image()'s
    # file at GOLDEN_SHA256.
    singles = [jpegtpu_torch.encode(im, quality=QUALITY) for im in batch]
    for bkw in ({"device_stuff": True}, {"device_stuff": False},
                {"fuse_bp": True}):
        ds, fuse = bkw.get("device_stuff", True), bkw.get("fuse_bp", False)
        files, counts = counted(lambda: jpegtpu_torch.encode_batch(
            list(batch), quality=QUALITY, **bkw))
        label = (f"encode_batch {BATCH} x {GOLDEN_SHAPE[1]}x"
                 f"{GOLDEN_SHAPE[0]} q{QUALITY} 420 rows{selectors(bkw)}")
        print(f"[e2e] {label}: {sum(map(len, files))} bytes, launches "
              f"{counts}")
        want = dict.fromkeys(counts, 0)
        want.update(pixel=int(not fuse), block_pack=int(not fuse),
                    seg_merge=1, stuff=int(ds), compact=int(not ds),
                    fused_px_bp=int(fuse))
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, want {want}")
        for i, jpg in enumerate(files):
            if jpg != singles[i]:
                raise AssertionError(f"{label}: file {i} differs from the "
                                     f"per-image encode")
            check_scan_structure(jpg, bmy - 1)
        digest = hashlib.sha256(files[0]).hexdigest()
        if digest != GOLDEN_SHA256:
            raise AssertionError(f"{label}: golden sha256 {digest} != "
                                 f"{GOLDEN_SHA256}")
        print(f"[e2e] {label}: {BATCH} files equal to the per-image "
              f"encodes; {bmy - 1} RST markers in order in each; file 0 "
              f"sha256 {digest} (golden)")

    # The oracle ladder, jpegtpu's test-oracle tier (block_pack, mcu_merge,
    # seg_merge v1, seg_merge_v2, seg_merge_v3), through its entry points on
    # three 4K inputs: 4:2:0 rows, 4:2:0 restart 0 (one segment of 194,400
    # blocks) and 4:4:4 rows (g = 3), each run with the launch counts set to
    # 0 just before it and read just after. Then each of K7-K10 against its
    # twin on the inputs it had in that run, K8 of K7 against K2's MCU
    # streams, and each rung's segments against the encode path's K2 -> K3
    # segments: the same bits, and the same words through the padded byte.
    def sentinel_merge(kern, rows, lens, ns_, per, width, split_rows=None):
        """K8, K9 or K10 launched directly into rows 1 .. ns_ of an [ns_ + 2,
        width] buffer filled with SENTINEL (the bit counts likewise), not
        counted as a launch: (the buffer, its bit counts)."""
        buf = torch.full((ns_ + 2, width), SENTINEL, dtype=torch.int32,
                         device=dev)
        sbuf = torch.full((ns_ + 2,), SENTINEL, dtype=torch.int32,
                          device=dev)
        n_scr = entropy_pack.seg_merge_scratch_words(ns_, per, True, width,
                                                     split_rows)
        scr = torch.empty(max(n_scr, 1), dtype=torch.int64, device=dev)
        kern.launch(dev, rows.data_ptr(), lens.data_ptr(), buf[1].data_ptr(),
                    sbuf[1:].data_ptr(), scr.data_ptr() if n_scr else None,
                    ns_, per, rows.shape[1], width)
        kern.launches -= 1
        return buf, sbuf

    def ladder(c, k, d, ns, mps, g, w_cap):
        bw_, bl_ = entropy_pack.block_pack(c.reshape(-1, 64), k, d)
        return bw_, bl_, entropy_pack.mcu_merge(bw_, bl_, g), {
            "v1": entropy_pack.seg_merge(bw_, bl_, ns, mps * g, w_cap),
            "v2": entropy_pack.seg_merge_v2(bw_, bl_, ns, mps * g, w_cap, g),
            "v3": entropy_pack.seg_merge_v3(bw_, bl_, ns, mps * g, w_cap,
                                            g)[:2]}

    c444 = fused_dctq.encode_blocks_pairs(x, tabs["444"].m, tabs["444"].bias,
                                          "444")
    ladder_inputs = {"420 rows": (coeffs, "420", restart),
                     "420 restart 0": (coeffs, "420", 0),
                     "444 rows": (c444, "444", ops.mcu_grid(h, w, "444")[1])}
    want = dict.fromkeys(launches, 0)
    want.update(block_pack_blocks=1, mcu_merge=3, seg_merge_window=1,
                seg_merge_v1=1, seg_merge=1)
    oracle_names = ("block_pack_blocks", "mcu_merge", "seg_merge_window",
                    "seg_merge_v1")
    errs.update(dict.fromkeys(oracle_names, 0))
    lad = {}            # the 420 rows and restart-0 runs and 444's, for timing
    for label, (c, sub, r) in ladder_inputs.items():
        n_luma = EncoderConfig(subsampling=sub).n_luma
        nm, g = c.shape[0], c.shape[1] // 64
        ns, mps = geometry(nm, r)
        d = scan.dc_diffs_from_dc(c[:, ::64], n_luma, r).reshape(-1)
        k = entropy_pack.block_classes(nm, g, n_luma, dev)
        pw, pml = entropy_pack.block_pack_mcu_pairs(c, k, d, *luts)
        psw, psb = entropy_pack.seg_merge_mcu(pw, pml, ns, mps)
        w_cap = entropy_pack.segment_words(ns, mps, pw.shape[1])
        (bw, bl, (mw8, ml8), rungs), counts = counted(
            lambda: ladder(c, k, d, ns, mps, g, w_cap))
        print(f"[ladder] {w}x{h} q{QUALITY} {label}: {nm * g} blocks in {ns} "
              f"segments, w_cap {w_cap}, launches {counts}")
        if counts != want:
            raise AssertionError(f"ladder {label}: launches {counts}, want "
                                 f"{want}")
        checks = {
            "block_pack_blocks": (
                f"K7 block pack {label}: lens {tuple(bl.shape)} + words "
                f"{tuple(bw.shape)}", (bw, bl),
                entropy_pack.block_pack_plain(c.reshape(-1, 64), k, d,
                                              *luts)),
            "mcu_merge": (
                f"K8 MCU merge {label}: mlens {tuple(ml8.shape)} + words "
                f"{tuple(mw8.shape)}", (mw8, ml8),
                entropy_oracles.mcu_merge_plain(bw, bl, g, mw8.shape[1])),
            "seg_merge_window": (
                f"K9 segment merge v2 {label}: seg_bits + words "
                f"{tuple(rungs['v2'][0].shape)}", rungs["v2"],
                entropy_oracles.seg_merge_window_plain(
                    mw8, ml8, ns, rungs["v2"][0].shape[1])),
            "seg_merge_v1": (
                f"K10 segment merge v1 {label}: seg_bits + words "
                f"{tuple(rungs['v1'][0].shape)}", rungs["v1"],
                entropy_oracles.seg_merge_plain(bw, bl, ns,
                                                rungs["v1"][0].shape[1]))}
        for n, (what, got, twin) in checks.items():
            (n0, e0), (n1, e1) = diff(got[0], twin[0]), diff(got[1], twin[1])
            errs[n] = max(errs[n], e0, e1)
            report(what, n0 + n1, max(e0, e1))
        # K8, K9 and K10 (instances of K3's body with the zero tail) once
        # more between sentinel rows: every word of each output row
        # written, nothing outside the output.
        for n, kk, kern, rows_, lens_, ns_, per, split_rows in (
                ("mcu_merge", "K8", entropy_oracles.MCU_MERGE, bw, bl, nm, g,
                 None),
                ("seg_merge_window", "K9", entropy_oracles.SEG_MERGE_WINDOW,
                 mw8, ml8, ns, mps, entropy_pack.SEG_MERGE_TILE),
                ("seg_merge_v1", "K10", entropy_oracles.SEG_MERGE_V1, bw, bl,
                 ns, mps * g, None)):
            twin_w, twin_b = checks[n][2]
            tiles = entropy_pack.seg_merge_tiles(ns_, per, twin_w.shape[1],
                                                 True, split_rows)
            buf, sbuf = sentinel_merge(kern, rows_, lens_, ns_, per,
                                       twin_w.shape[1], split_rows)
            (n0, e0), (n1, e1) = (diff(buf[1:-1], twin_w),
                                  diff(sbuf[1:-1], twin_b))
            n2 = (int((buf[0] != SENTINEL).sum() + (buf[-1] != SENTINEL).sum())
                  + int(sbuf[0] != SENTINEL) + int(sbuf[-1] != SENTINEL))
            errs[n] = max(errs[n], e0, e1)
            report(f"{kk} onto sentinel rows {label}: {ns_} whole rows of "
                   f"{twin_w.shape[1]} words + lengths ({tiles[0]} tiles, "
                   f"{tiles[1]} tail tiles), {n2} values written outside",
                   n0 + n1 + n2, max(e0, e1))
            del buf, sbuf
        del checks
        # K2's stream bits (bits past each length are undefined on the
        # card), and K8's rows past K2's width are zero.
        kw = pw.shape[1]
        n1, e1 = stream_diff(mw8[:, :kw], ml8, pw, pml)
        n2 = int(mw8[:, kw:].count_nonzero())
        report(f"K8 of K7 against K2's MCU streams {label}: mlens, the "
               f"stream bits of the first {kw} words, {n2} nonzero words "
               f"past them", n1 + n2, e1)
        for rung, (rw, rb) in rungs.items():
            n0, e0 = seg_diff(rw[:, :psw.shape[1]], rb, psw, psb)
            report(f"ladder {rung} rung {label} against K2 -> K3: seg_bits + "
                   f"each segment's first ceil(seg_bits / 8) bytes, {ns} "
                   f"segments", n0, e0)
        run_ = dict(bw=bw, bl=bl, mw8=mw8, ml8=ml8, ns=ns, mps=mps, g=g,
                    w_cap=w_cap, sb=psb, v2_words=rungs["v2"][0].shape[1])
        if sub == "420":
            lad[r] = run_
        else:
            lad[sub] = dict(run_, c=c.reshape(-1, 64), k=k, d=d)
        del pw, psw, rungs
    del c444

    # 5. Golden files from jpegtpu.
    gold = jpegtpu_torch.encode(golden_image(), quality=QUALITY,
                                subsampling="420")
    digest = hashlib.sha256(gold).hexdigest()
    print(f"[golden] {GOLDEN_SHAPE[1]}x{GOLDEN_SHAPE[0]} q{QUALITY}: "
          f"{len(gold)} bytes sha256 {digest}")
    if digest != GOLDEN_SHA256:
        raise AssertionError(f"golden sha256 {digest} != {GOLDEN_SHA256}")
    for _, _, kw in (p for p in SELECTOR_PATHS if p[:2] == ("420", "rows")):
        gold = run_path(kw, lambda f: jpegtpu_torch.encode(
            golden_image(), quality=QUALITY, subsampling="420", **f))
        digest = hashlib.sha256(gold).hexdigest()
        print(f"[golden] {GOLDEN_SHAPE[1]}x{GOLDEN_SHAPE[0]} q{QUALITY}"
              f"{selectors(kw)}: {len(gold)} bytes sha256 {digest}")
        if digest != GOLDEN_SHA256:
            raise AssertionError(f"golden{selectors(kw)} sha256 {digest} != "
                                 f"{GOLDEN_SHA256}")
    for label, (sub, restart_interval, image_name, sha) in GOLDENS.items():
        gold = jpegtpu_torch.encode(golden_input(image_name),
                                    quality=QUALITY, subsampling=sub,
                                    restart_interval=restart_interval)
        digest = hashlib.sha256(gold).hexdigest()
        print(f"[golden] {label} ({image_name}) q{QUALITY}: {len(gold)} "
              f"bytes sha256 {digest}")
        if digest != sha:
            raise AssertionError(f"golden {label} sha256 {digest} != {sha}")

    # 6. Timing, for the record: CUDA events over TIMING_REPS after warm-up.
    mpix = h * w / 1e6

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(TIMING_REPS):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / TIMING_REPS

    def line(label, ms):
        print(f"[time] {label}: {ms:.4f} ms  {mpix / ms * 1e3:.2f} MPix/s  "
              f"[{card}]")

    pairs = {
        "pixel": (lambda: fused_dctq.encode_blocks_pairs(x, tables.m,
                                                         tables.bias),
                  lambda: fused_dctq.encode_blocks_pairs_plain(
                      x, tables.m, tables.bias)),
        "block_pack": (lambda: entropy_pack.block_pack_mcu_segments(
                           coeffs, 4, restart, luts),
                       lambda: entropy_pack.block_pack_mcu_segments_plain(
                           coeffs, 4, restart, luts)),
        "seg_merge": (lambda: entropy_pack.seg_merge_mcu(mw, ml, n_seg,
                                                         restart),
                      lambda: entropy_pack.seg_merge_mcu_plain(
                          mw, ml, n_seg, restart)),
        "stuff": (lambda: compact.compact_segments_stuffed_grouped(
                      sw, sb, restart),
                  lambda: compact.compact_segments_stuffed_grouped_plain(
                      sw, sb, restart)),
        "stuff_chunks": (lambda: compact.compact_segments_stuffed(
                             sw0, sb0, 0),
                         lambda: compact.compact_segments_stuffed_plain(
                             sw0, sb0, 0)),
        "compact": (lambda: compact.compact_segments(sw, sb),
                    lambda: compact.compact_segments_plain(sw, sb)),
        "fused_px_bp": (
            lambda: fused_pipeline.fused_pixel_block_pack_pairs(
                x, tables, "420", restart),
            lambda: fused_pipeline.fused_pixel_block_pack_pairs_plain(
                x, tables, "420", restart)),
        "pixel_dc": (
            lambda: fused_dctq.encode_blocks_pairs(x, tables.m, tables.bias,
                                                   with_dc=True),
            lambda: fused_dctq.dc_plane(fused_dctq.encode_blocks_pairs_plain(
                x, tables.m, tables.bias))),
        "pixel_i8": (
            lambda: fused_dctq.encode_blocks_i8_pairs(x, tables.m,
                                                      tables.bias),
            lambda: fused_dctq.pixel_i8_plain(fused_dctq.i8_view(x),
                                              tables.m, tables.bias)),
        "pixel_dma": (
            lambda: fused_dctq.encode_blocks_dma_pairs(x, tables.m,
                                                       tables.bias),
            lambda: fused_dctq.encode_blocks_pairs_plain(x, tables.m,
                                                         tables.bias)),
    }
    # K7-K10 on the oracle ladder's 4:2:0 rows inputs.
    lr, l0 = lad[restart], lad[0]
    blocks = coeffs.reshape(-1, 64)
    pairs.update({
        "block_pack_blocks": (
            lambda: entropy_pack.block_pack(blocks, cls, dcd),
            lambda: entropy_pack.block_pack_plain(blocks, cls, dcd, *luts)),
        "mcu_merge": (
            lambda: entropy_pack.mcu_merge(lr["bw"], lr["bl"], 6),
            lambda: entropy_oracles.mcu_merge_plain(
                lr["bw"], lr["bl"], 6, lr["mw8"].shape[1])),
        "seg_merge_window": (
            lambda: entropy_oracles.seg_merge_window(
                lr["mw8"], lr["ml8"], lr["ns"], lr["mps"], lr["v2_words"]),
            lambda: entropy_oracles.seg_merge_window_plain(
                lr["mw8"], lr["ml8"], lr["ns"], lr["v2_words"])),
        "seg_merge_v1": (
            lambda: entropy_pack.seg_merge(lr["bw"], lr["bl"], lr["ns"],
                                           lr["mps"] * 6, lr["w_cap"]),
            lambda: entropy_oracles.seg_merge_plain(
                lr["bw"], lr["bl"], lr["ns"], -(-lr["w_cap"] // 128) * 128)),
    })
    for sub in ("422", "444", "444s"):
        t = tabs[sub]
        pairs[f"pixel {sub}"] = (
            lambda t=t, sub=sub: fused_dctq.encode_blocks_pairs(
                x, t.m, t.bias, sub),
            lambda t=t, sub=sub: fused_dctq.encode_blocks_pairs_plain(
                x, t.m, t.bias, sub))
        pairs[f"pixel_dc {sub}"] = (
            lambda t=t, sub=sub: fused_dctq.encode_blocks_pairs(
                x, t.m, t.bias, sub, with_dc=True),
            lambda t=t, sub=sub: fused_dctq.dc_plane(
                fused_dctq.encode_blocks_pairs_plain(x, t.m, t.bias, sub)))
    times = {}
    for label, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        times[label] = (min(k1, k2), min(p1, p2))
        line(f"{label} kernel (wrapper + glue)", times[label][0])
        line(f"{label} plain twin", times[label][1])
    # The pixel kernels at 4:2:0 alone (profiler), by their template
    # arguments: K1, K12 (kDc, its DC plane), K13 (kI8, int8 input), K14,
    # K11 (MCU height and width, tile).
    pixel_keys = {
        "pixel": ("pixel_mma_kernel<16, 16, 64, 32, false, false>",),
        "pixel_dc": ("pixel_mma_kernel<16, 16, 64, 32, false, true>",),
        "pixel_i8": ("pixel_mma_kernel<16, 16, 64, 32, true, false>",),
        "pixel_dma": ("pixel_dma_kernel(",),
        "fused_px_bp": ("fused_px_bp_kernel<16, 16, 32>",)}
    for n, keys in pixel_keys.items():
        print(f"[time] {n} kernel alone (profiler), 420 {w}x{h}: "
              f"{kernel_device_ms(pairs[n][0], *keys)} ms  [{card}]")
    # K11 alone at 4:2:2 and 4:4:4 rows, twice each (profiler).
    for sub, dims in (("422", "8, 16, 32"), ("444", "8, 8, 64")):
        t = tabs[sub]
        r = ops.mcu_grid(h, w, sub)[1]
        k11 = lambda t=t, sub=sub, r=r: (  # noqa: E731
            fused_pipeline.fused_pixel_block_pack_pairs(x, t, sub, r))
        key = f"fused_px_bp_kernel<{dims}>"
        ka = kernel_device_ms(k11, key, reps=20)
        kb = kernel_device_ms(k11, key, reps=20)
        print(f"[time] fused_px_bp kernel alone (profiler), {sub} rows "
              f"{w}x{h}: {ka} / {kb} ms  [{card}]")
    # K2 (the encoder's launcher) and K3 alone (profiler) on the main path,
    # restart 0, 7, 420 restart 1 and 444 restart 1, each twice, in turns
    # K2, K3, K3, K2; K3's scratch memset (restart 0 only) beside it.
    for sub, r, what in (("420", restart, "rows (the main path)"),
                         ("420", 0, "0"), ("420", 7, "7"), ("420", 1, "1"),
                         ("444", 1, "1")):
        t = tabs[sub]
        c_ = (coeffs if sub == "420" else
              fused_dctq.encode_blocks_pairs(x, t.m, t.bias, sub))
        nl = EncoderConfig(subsampling=sub).n_luma
        ns, mps = geometry(c_.shape[0], r)
        a_, l_ = entropy_pack.block_pack_mcu_segments(c_, nl, r, luts)
        k2 = lambda: entropy_pack.block_pack_mcu_segments(  # noqa: E731
            c_, nl, r, luts)
        k3 = lambda: entropy_pack.seg_merge_mcu(a_, l_, ns, mps)  # noqa
        t2a = kernel_device_ms(k2, "block_pack_mcu_kernel<", reps=20)
        t3a = kernel_device_ms(k3, K3_KEY, reps=20)
        t3b = kernel_device_ms(k3, K3_KEY, reps=20)
        t2b = kernel_device_ms(k2, "block_pack_mcu_kernel<", reps=20)
        print(f"[time] K2 and K3 alone (profiler, 20 launches, in turns), "
              f"{sub} restart {what} ({c_.shape[0]} MCUs in {ns} segments): "
              f"K2 "
              f"{t2a} / {t2b} ms, K3 {t3a} / {t3b} ms, K3 memset "
              f"{kernel_device_ms(k3, 'Memset')} ms  [{card}]")
        del a_, l_, c_
    line("K4 jt_stuff_segments on the restart-0 segment (K5's input)",
         time_ms(lambda: compact.compact_segments_stuffed_grouped(
             sw0, sb0, 0)))
    # K7-K10 alone (profiler, 20 launches, twice) on the ladder's 4:2:0
    # rows inputs, K7, K8 and K9 also on 4:4:4 rows (g = 3), then K9 and
    # K10 on the restart-0 segment (32,400 MCUs, 194,400 blocks): wrapper
    # (CUDA events) and kernel alone. K9 and K10 also give their scratch's
    # memset, the one fill of a launch (none where no segment is split).
    oracle_keys = {"block_pack_blocks": "::block_pack_kernel(",
                   "mcu_merge": K8_KEY,
                   "seg_merge_window": K9_KEY,
                   "seg_merge_v1": K10_KEY}
    l4 = lad["444"]
    oracle_runs = {n: ("420 rows", pairs[n][0]) for n in oracle_keys}
    oracle_runs.update({
        "block_pack_blocks 444": ("444 rows", lambda: entropy_pack.block_pack(
            l4["c"], l4["k"], l4["d"])),
        "mcu_merge 444": ("444 rows", lambda: entropy_pack.mcu_merge(
            l4["bw"], l4["bl"], l4["g"])),
        "seg_merge_window 444": ("444 rows",
                                 lambda: entropy_oracles.seg_merge_window(
                                     l4["mw8"], l4["ml8"], l4["ns"],
                                     l4["mps"], l4["v2_words"])),
        "seg_merge_window 0": ("420 restart 0",
                               lambda: entropy_oracles.seg_merge_window(
                                   l0["mw8"], l0["ml8"], 1, l0["mps"],
                                   l0["v2_words"])),
        "seg_merge_v1 0": ("420 restart 0", lambda: entropy_pack.seg_merge(
            l0["bw"], l0["bl"], 1, l0["mps"] * 6, l0["w_cap"]))})
    for n, (what, fn) in oracle_runs.items():
        key = oracle_keys[n.split()[0]]
        ka = kernel_device_ms(fn, key, reps=20)
        kb = kernel_device_ms(fn, key, reps=20)
        memset = (f", scratch memset {kernel_device_ms(fn, 'Memset')} ms"
                  if n.startswith(("seg_merge_v1", "seg_merge_window"))
                  else "")
        print(f"[time] {n.split()[0]} kernel alone (profiler), oracle ladder "
              f"{what} {w}x{h}: {ka} / {kb} ms{memset}, wrapper "
              f"{time_ms(fn):.4f} ms  [{card}]")

    # K6 on its three segment sets: wrapper with glue (CUDA events), the
    # kernel alone (profiler) and its bound (the valid bytes read once and
    # written once, plus each segment's bit count in and byte count out).
    for label, (sw_, sb_) in k6_sets.items():
        k6 = lambda: compact.compact_segments(sw_, sb_)  # noqa: E731
        nb_ = int(((sb_.to(torch.int64) + 7) // 8).sum())
        by_ = 2 * nb_ + sw_.shape[0] * 12
        print(f"[time] K6 compact.cu on {label} ({sw_.shape[0]} segments, "
              f"{nb_} bytes): wrapper {time_ms(k6):.4f} ms, kernel alone "
              f"(profiler) {kernel_device_ms(k6, '::compact_kernel(')} ms, "
              f"bound {by_ / HBM_BYTES_PER_S * 1e3:.6f} ms ({by_} bytes)  "
              f"[{card}]")
    # K4 and K5 on the inputs the paths give them: the main path's 135
    # segments (K4), the restart-0 segment (K5) and the batch's 544
    # segments with per-image markers (K4). The wrapper (CUDA events: the
    # scratch memset, the kernel and the host's launch), the kernel alone
    # and the memset alone (profiler), and the bound: what the function
    # needs, the valid bytes in, the stuffed bytes out, seg_bits and mnum
    # (4 bytes a segment each) and bounds (8 an image, plus the total), over
    # the HBM rate. The scratch is not the function's and is left out.
    def stuff_bytes(sw_, sb_, tot_, n_img):
        valid = int(((sb_.to(torch.int64) + 7) // 8).sum())
        return valid + tot_ + 8 * sw_.shape[0] + 8 * (n_img + 1)

    stuff_cases = {
        "main path 420 rows, K4": (
            "stuff", lambda: compact.compact_segments_stuffed_grouped(
                sw, sb, restart), sw, sb, 1),
        "420 restart 0, K5": (
            "stuff_chunks", lambda: compact.compact_segments_stuffed(
                sw0, sb0, 0), sw0, sb0, 1),
        f"batch {BATCH} x 1080p with per-image markers, K4": (
            "stuff", lambda: compact.compact_segments_stuffed_grouped(
                swb, sbb, bmx, bmy), swb, sbb, BATCH)}
    stuff_bound = {}
    for label, (n, fn, sw_, sb_, n_img) in stuff_cases.items():
        by_ = stuff_bytes(sw_, sb_, int(fn()[1]), n_img)
        stuff_bound.setdefault(n, by_)
        print(f"[time] {label} ({sw_.shape[0]} segments, "
              f"{compact.stuff_tiles(*sw_.shape)} chunks): wrapper "
              f"{time_ms(fn):.4f} ms, kernel alone (profiler) "
              f"{kernel_device_ms(fn, 'stuff_lookback_kernel')} ms, scratch "
              f"memset {kernel_device_ms(fn, 'Memset')} ms, bound "
              f"{by_ / HBM_BYTES_PER_S * 1e3:.6f} ms ({by_} bytes)  [{card}]")
    del k6_sets, swb, sbb

    # K4 and K5 on the same multi-segment sets, in turns (K4, K5, K5, K4),
    # wrapper (CUDA events) and kernel alone (profiler); one kernel body,
    # so the two must give the same scan.
    c444 = fused_dctq.encode_blocks_pairs(x, tabs["444"].m, tabs["444"].bias,
                                          "444")
    seg_sets = {"420 rows": (sw, sb, restart),
                "420 restart 7": (sw7, sb7, 7),
                "420 restart 1": (sw1, sb1, 1),
                "444 rows": seg_set(c444, "444",
                                    ops.mcu_grid(h, w, "444")[1]),
                "444 restart 1": (sw444, sb444, 1)}
    del c444
    for label, (sw_, sb_, r_) in seg_sets.items():
        b4, t4, _ = compact.compact_segments_stuffed_grouped(sw_, sb_, r_)
        b5, t5 = compact.compact_segments_stuffed(sw_, sb_, r_)
        t4, t5 = int(t4), int(t5)
        n_bad, e = diff(b5[:t4], b4[:t4])
        report(f"K5 against K4 on the {label} segments "
               f"{tuple(sw_.shape)}, {t4} bytes", n_bad + int(t4 != t5),
               max(e, abs(t4 - t5)))
        del b4, b5
        k4 = lambda: compact.compact_segments_stuffed_grouped(  # noqa: E731
            sw_, sb_, r_)
        k5 = lambda: compact.compact_segments_stuffed(  # noqa: E731
            sw_, sb_, r_)
        a1, c1, c2, a2 = time_ms(k4), time_ms(k5), time_ms(k5), time_ms(k4)
        line(f"{label} segments: K4 jt_stuff_segments wrapper", min(a1, a2))
        line(f"{label} segments: K5 jt_stuff_chunks wrapper", min(c1, c2))
        print(f"[time] {label} segments: kernel alone (profiler): K4 "
              f"{kernel_device_ms(k4, 'stuff_lookback_kernel')} ms, K5 "
              f"{kernel_device_ms(k5, 'stuff_lookback_kernel')} ms  "
              f"[{card}]")
    # The chain's width at restart 7: 4,629 segments of 2,186 words (3
    # tiles), each segment's data in its first tile. The kernel alone on
    # the segments as they are and cut to their first tile (the same data
    # tiles and scan, a chain of one tile a segment, no width to find), in
    # turns: what the wider chain, or finding its width, costs.
    if int((sb7.to(torch.int64) + 7).max()) // 8 <= compact.CHUNK_BYTES:
        sw7n = sw7[:, :compact.CHUNK_WORDS].contiguous()
        k_w = lambda: compact.compact_segments_stuffed_grouped(  # noqa: E731
            sw7, sb7, 7)
        k_n = lambda: compact.compact_segments_stuffed_grouped(  # noqa: E731
            sw7n, sb7, 7)
        (bw, tw, _), (bn, tn, _) = k_w(), k_n()
        tw, tn = int(tw), int(tn)
        n_bad, e = diff(bn[:tw], bw[:tw])
        report(f"K4 on the 420 restart 7 segments cut to one tile "
               f"{tuple(sw7n.shape)} against the whole rows, {tw} bytes",
               n_bad + int(tw != tn), max(e, abs(tw - tn)))
        del bw, bn
        ms = [kernel_device_ms(k, "stuff_lookback_kernel", reps=20)
              for k in (k_w, k_n, k_n, k_w)]
        print(f"[time] 420 restart 7, kernel alone (profiler, 20 launches, "
              f"in turns): rows of {sw7.shape[1]} words {ms[0]} / {ms[3]} "
              f"ms, rows cut to {compact.CHUNK_WORDS} words {ms[1]} / "
              f"{ms[2]} ms  [{card}]")
        del sw7n
    del seg_sets, sw1, sb1, sw7, sb7, sw444, sb444

    # The library yardstick of K1: one float64 torch.matmul of the MCU
    # tiles by the operator (timed here, never called by the port).
    library = {}
    for sub in ("420", "422", "444", "444s"):
        mh, mwid, _, _ = fused_dctq.fused_geometry(sub)
        tiles = fused_dctq.mcu_tiles(ops.pad_to_multiple(x, (mh, mwid)), mh,
                                     mwid).to(torch.float64)
        m64 = tabs[sub].m.to(torch.float64)
        library[sub] = time_ms(lambda: torch.matmul(tiles, m64))
        line(f"pixel {sub} library: float64 torch.matmul {tuple(tiles.shape)}"
             f" x {tuple(m64.shape)}", library[sub])
        del tiles
    # K1, K12, K13 and K14 (the factored tensor-core product) and the
    # library call, in turns in one call: in order, then in reverse.
    # Wrappers with their glue (K13's: the int8 view's XOR pass), then the
    # kernels alone: each launcher on operands made once (the library call
    # on tiles gathered once). CUDA events.
    tiles = fused_dctq.mcu_tiles(x, 16, 16).to(torch.float64)
    m64 = tables.m.to(torch.float64)
    lum, chroma = fused_dctq.cuda_factors(tables.m, tables.bias, "420")
    out_a = torch.empty((n_mcu, 384), dtype=torch.int32, device=dev)
    dc_a = torch.empty((n_mcu, fused_dctq.DC_LANES), dtype=torch.int32,
                       device=dev)
    x8 = fused_dctq.i8_view(x)
    head = (lum.data_ptr(), chroma.data_ptr(), tables.bias.data_ptr(),
            out_a.data_ptr())
    tail = (n_mcu, mx, w * 3)
    library_call = ("library float64 torch.matmul",
                    lambda: torch.matmul(tiles, m64))
    in_turns = {
        "wrappers": dict([
            ("K1 jt_pixel", pairs["pixel"][0]),
            ("K12 jt_pixel_dc", pairs["pixel_dc"][0]),
            ("K13 jt_pixel_i8", pairs["pixel_i8"][0]),
            ("K14 jt_pixel_dma (bulk copies)", pairs["pixel_dma"][0]),
            library_call]),
        "kernels alone": dict([
            ("K1 jt_pixel", lambda: fused_dctq.PIXEL.launch(
                dev, x.data_ptr(), *head, *tail, 16, 16, 64)),
            ("K12 jt_pixel_dc", lambda: fused_dctq.PIXEL_DC_PLANE.launch(
                dev, x.data_ptr(), *head, dc_a.data_ptr(), *tail, 16, 16,
                64)),
            ("K13 jt_pixel_i8", lambda: fused_dctq.PIXEL_I8.launch(
                dev, x8.data_ptr(), *head, *tail)),
            ("K14 jt_pixel_dma (bulk copies)",
             lambda: fused_dctq.PIXEL_DMA.launch(dev, x.data_ptr(), *head,
                                                 *tail)),
            library_call])}
    for what, turns in in_turns.items():
        there = {k: time_ms(f) for k, f in turns.items()}
        back = {k: time_ms(f) for k, f in reversed(list(turns.items()))}
        for k in turns:
            print(f"[time] pixel product in turns, {what}, 420 {w}x{h}: "
                  f"{k}: {there[k]:.4f} / {back[k]:.4f} ms  [{card}]")
    if not (torch.equal(out_a, coeffs_p) and
            torch.equal(dc_a, fused_dctq.dc_plane(coeffs_p))):
        raise AssertionError("the kernels timed alone disagree with the "
                             "dense twin")
    del tiles, m64, out_a, dc_a, x8
    # The host's cost of one launch: Kernel.launch (the operands' device
    # made current, its stream looked up) against the bare launcher on the
    # current stream, K1 on one MCU, 200 launches a turn in turns (A B B A,
    # three times), host clock, synced between turns; medians.
    one = x[:16, :16].contiguous()
    out1 = torch.empty((1, 384), dtype=torch.int32, device=dev)
    lum, chroma = fused_dctq.cuda_factors(tables.m, tables.bias, "420")
    args = (one.data_ptr(), lum.data_ptr(), chroma.data_ptr(),
            tables.bias.data_ptr(), out1.data_ptr(), 1, 1, 48, 16, 16, 64)
    k1 = fused_dctq.PIXEL
    ways = {"Kernel.launch (device guard, its stream)":
            lambda: k1.launch(one.device, *args),
            "bare launcher (current stream)":
            lambda: k1._fn(*args, torch.cuda.current_stream().cuda_stream)}
    host_us = {k: [] for k in ways}
    for k in list(ways) + list(ways)[::-1] * 2 + list(ways):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            ways[k]()
        host_us[k].append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    if not torch.equal(out1, fused_dctq.encode_blocks_pairs_plain(
            one, tables.m, tables.bias)):
        raise AssertionError("K1 on one MCU disagrees with the dense twin")
    for k, v in host_us.items():
        print(f"[time] host per launch, {k}: {float(np.median(v)):.2f} us "
              f"(turns {', '.join(f'{u:.2f}' for u in v)})  [{card}]")
    for sub, dims in (("422", "8, 16, 64, 96"), ("444", "8, 8, 64, 64"),
                      ("444s", "8, 8, 16, 128")):
        for n, dc_arg in (("pixel", "false"), ("pixel_dc", "true")):
            alone = kernel_device_ms(
                pairs[f"{n} {sub}"][0],
                f"pixel_mma_kernel<{dims}, false, {dc_arg}>")
            print(f"[time] {n} kernel alone (profiler), {sub} {w}x{h}: "
                  f"{alone} ms  [{card}]")

    def device_path(image, sub, r, kw):
        """One device encode of a path with the selectors kw (no fetch)."""
        return run_path(kw, lambda f: device_encode(
            image, tabs[sub], sub, r, True, f.get("pixel_path", "nat"),
            f.get("fuse_bp", False)))

    dev_ms = {}
    for sub, restart_interval in PATHS:
        image = torch.from_numpy(path_input(sub)).to(dev)
        _, r, _ = path_geometry(path_input(sub), sub, restart_interval)
        dev_ms[sub, restart_interval, ""] = time_ms(
            lambda: device_encode(image, tabs[sub], sub, r))
        line(f"encode on device (no host fetch), {sub} restart "
             f"{restart_interval!r}", dev_ms[sub, restart_interval, ""])
    # Each selector path beside its split path (the same mode and
    # interval), in turns: split, path, path, split.
    for sub, restart_interval, kw in SELECTOR_PATHS:
        _, r, _ = path_geometry(img, sub, restart_interval)
        split = lambda: device_encode(x, tabs[sub], sub, r)  # noqa: E731
        sel = lambda: device_path(x, sub, r, kw)  # noqa: E731
        a1, b1, b2, a2 = time_ms(split), time_ms(sel), time_ms(sel), \
            time_ms(split)
        dev_ms[sub, restart_interval, selectors(kw)] = min(b1, b2)
        line(f"encode on device (no host fetch), {sub} restart "
             f"{restart_interval!r}{selectors(kw)}", min(b1, b2))
        line(f"  beside it: {sub} restart {restart_interval!r} split path",
             min(a1, a2))
    enc = jpegtpu_torch.Encoder(jpegtpu_torch.EncoderConfig(
        quality=QUALITY, subsampling="420"))
    enc.encode(img)
    t_wall = time.perf_counter()
    for _ in range(TIMING_REPS):
        enc.encode(img)                   # ends in the host fetch: synced
    line("encode with host upload + fetch + JFIF wrap (host clock)",
         (time.perf_counter() - t_wall) * 1e3 / TIMING_REPS)

    # device_stuff=False at 3840x2160 rows: the device program, then the
    # fetch of the byte counts (the sync), the fetch of exactly the
    # compacted bytes, the host stuffing and the wrap, each on the host
    # clock, over TIMING_REPS after warm-up.
    dev_ms["420", "rows", " device_stuff=False"] = time_ms(
        lambda: device_encode(x, tables, "420", restart, False))
    line("encode on device (no host fetch), 420 rows device_stuff=False",
         dev_ms["420", "rows", " device_stuff=False"])

    def host_split():
        t0 = time.perf_counter()
        xh = torch.from_numpy(img).to(dev)
        buf_, nb_ = device_encode(xh, tables, "420", restart, False)
        nb_ = nb_.cpu().numpy()
        t1 = time.perf_counter()
        stream_ = buf_[:int(nb_.sum())].cpu().numpy()
        t2 = time.perf_counter()
        scan_ = native.stuff_assemble_contig(stream_, nb_, restart)
        t3 = time.perf_counter()
        jfif.wrap_jpeg(h, w, QUALITY, "420", restart, scan_)
        t4 = time.perf_counter()
        return np.array([t1 - t0, t2 - t1, t3 - t2, t4 - t3]) * 1e3

    host_split()
    split = sum(host_split() for _ in range(TIMING_REPS)) / TIMING_REPS
    print(f"[time] encode device_stuff=False, 420 rows (host clock, ms): "
          f"upload + device program + byte-count fetch {split[0]:.4f}, "
          f"stream fetch {split[1]:.4f}, host stuffing {split[2]:.4f}, "
          f"wrap {split[3]:.4f}, total {split.sum():.4f}  [{card}]")
    enc_h = jpegtpu_torch.Encoder(jpegtpu_torch.EncoderConfig(
        quality=QUALITY, device_stuff=False))
    enc_h.encode(img)
    t_wall = time.perf_counter()
    for _ in range(TIMING_REPS):
        enc_h.encode(img)
    line("encode device_stuff=False with upload + fetch + host stuffing + "
         "wrap (host clock)", (time.perf_counter() - t_wall) * 1e3 /
         TIMING_REPS)

    # The batch: one program for 8 x 1920x1080 beside 8 single device
    # encodes of the same images, in turns (batch, singles, singles, batch).
    bmpix = BATCH * GOLDEN_SHAPE[0] * GOLDEN_SHAPE[1] / 1e6
    for ds, fuse in ((True, False), (False, False), (True, True)):
        one = lambda: device_encode_batch(  # noqa: E731
            xb, tables, "420", bmx, ds, fuse_bp=fuse)
        each = lambda: [device_encode(xb[i], tables, "420", bmx, ds,  # noqa
                                      fuse_bp=fuse) for i in range(BATCH)]
        b1, s1, s2, b2 = time_ms(one), time_ms(each), time_ms(each), \
            time_ms(one)
        dev_ms["batch", ds, fuse] = min(b1, b2)
        for label, ms in (("one batch program", min(b1, b2)),
                          (f"{BATCH} single device encodes", min(s1, s2))):
            print(f"[time] {BATCH} x {GOLDEN_SHAPE[1]}x{GOLDEN_SHAPE[0]} "
                  f"420 rows device_stuff={ds} fuse_bp={fuse}, {label}: "
                  f"{ms:.4f} ms per batch  {bmpix / ms * 1e3:.2f} MPix/s  "
                  f"[{card}]")
    print("[profile] encode_batch device program, device_stuff=True")
    profile_device_encode(
        lambda: device_encode_batch(xb, tables, "420", bmx, True),
        dev_ms["batch", True, False], card)
    print("[profile] encode_batch device program, fuse_bp=True")
    profile_device_encode(
        lambda: device_encode_batch(xb, tables, "420", bmx, True,
                                    fuse_bp=True),
        dev_ms["batch", True, True], card)
    for sub, restart_interval, kw in PROFILED:
        _, r, _ = path_geometry(img, sub, restart_interval)
        print(f"[profile] {sub} restart {restart_interval!r}{selectors(kw)}")
        profile_device_encode(lambda: device_path(x, sub, r, kw),
                              dev_ms[sub, restart_interval, selectors(kw)],
                              card)

    # The least time the card could take for each kernel's work on these
    # inputs: the larger of its bytes (inputs read once, outputs written
    # once; the entropy kernels touch only the valid words and bytes, not
    # the worst-case buffers) over the HBM rate and, for K1, the float64
    # FLOPs that its operator needs (operator_fmas) over the float64 peak.
    # The entropy kernels' integer operations, and K1's integer pixel sums,
    # are not counted.
    valid_mcu_words = int(((ml.to(torch.int64) + 31) // 32).sum())
    valid_seg_words = int(((sb.to(torch.int64) + 31) // 32).sum())
    nbytes_rows = int(((sb.to(torch.int64) + 7) // 8).sum())
    lut_bytes = sum(t.numel() * 4 for t in luts)
    # K2 on the main path derives each block's class and DC difference (the
    # DC from the coefficients it reads): the coefficients and the LUTs in,
    # the valid MCU words and the lengths out. K3 reads the valid MCU words
    # and the lengths and writes the valid segment words and seg_bits.
    bytes_moved = {
        "block_pack": (coeffs.numel() * 4 + lut_bytes +
                       (valid_mcu_words + ml.numel()) * 4),
        "seg_merge": (valid_mcu_words + n_mcu + valid_seg_words + n_seg) * 4,
        "stuff": stuff_bound["stuff"],
        "stuff_chunks": stuff_bound["stuff_chunks"],
        "compact": 2 * nbytes_rows + n_seg * 12,
    }
    # K7-K10 on the ladder's inputs: the valid block or MCU words and their
    # lengths in (K7: the coefficients, classes, DC differences and LUTs);
    # out, the whole rows that jpegtpu's contract writes, zeros past each
    # length included (K7 [blocks, 56], K8 [MCUs, chunks * 128], K9
    # [segments, frames * 1024], K10 [segments, ceil(w_cap / 128) * 128]),
    # and the lengths.
    def valid_words(lens_):
        return int(((lens_.to(torch.int64) + 31) // 32).sum())

    def rows_out(n_rows, width):
        return (n_rows * width + n_rows) * 4

    n_blocks = lr["bl"].numel()
    valid_block_words = valid_words(lr["bl"])
    bytes_moved.update({
        "block_pack_blocks": ((blocks.numel() + cls.numel() + dcd.numel()) * 4
                              + lut_bytes +
                              rows_out(n_blocks, entropy_pack.BLOCK_WORDS)),
        "mcu_merge": ((valid_block_words + n_blocks) * 4 +
                      rows_out(n_mcu, lr["mw8"].shape[1])),
        "seg_merge_window": ((valid_mcu_words + n_mcu) * 4 +
                             rows_out(n_seg, lr["v2_words"])),
        "seg_merge_v1": ((valid_block_words + n_blocks) * 4 +
                         rows_out(n_seg, -(-lr["w_cap"] // 128) * 128))})
    # The same count for K7, K8 and K9 on 4:4:4 rows and K9 and K10 on the
    # restart-0 segment (not in the kernels line, which is at 4:2:0 rows).
    more_bounds = {
        "block_pack_blocks 444 rows": (
            (l4["c"].numel() + l4["k"].numel() + l4["d"].numel()) * 4 +
            lut_bytes + rows_out(l4["bl"].numel(), entropy_pack.BLOCK_WORDS)),
        "mcu_merge 444 rows": (
            (valid_words(l4["bl"]) + l4["bl"].numel()) * 4 +
            rows_out(l4["bl"].numel() // l4["g"],
                     128 * entropy_oracles.default_chunks(l4["g"]))),
        "seg_merge_window 444 rows": (
            (valid_words(l4["ml8"]) + l4["ml8"].numel()) * 4 +
            rows_out(l4["ns"], l4["v2_words"])),
        "seg_merge_window 420 restart 0": (
            (valid_words(l0["ml8"]) + l0["ml8"].numel()) * 4 +
            rows_out(1, l0["v2_words"])),
        "seg_merge_v1 420 restart 0": (
            (valid_words(l0["bl"]) + l0["bl"].numel()) * 4 +
            rows_out(1, -(-l0["w_cap"] // 128) * 128))}
    for n, by in more_bounds.items():
        print(f"[bound] {n}: {by} bytes -> "
              f"{by / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes)")
    flops = {}
    for sub in ("420", "422", "444", "444s"):
        t = tabs[sub]
        nm = int(np.prod(ops.mcu_grid(h, w, sub)))
        key = "pixel" if sub == "420" else f"pixel {sub}"
        bytes_moved[key] = (x.numel() + (t.m.numel() + t.bias.numel()) * 4
                            + nm * t.m.shape[1] * 4)
        flops[key] = 2.0 * nm * operator_fmas(t.m.cpu().numpy(), sub)
    # K11: the image, the operator's factors, the bias and the LUTs in, the
    # valid MCU words and the lengths out, and K1's FLOPs; K12 K1's bytes
    # and the plane, K13 and K14 K1's.
    bytes_moved["fused_px_bp"] = (
        x.numel() + (tables.lum.numel() + tables.chroma.numel() +
                     tables.bias.numel()) * 4 +
        sum(t.numel() * 4 for t in luts) + (valid_mcu_words + n_mcu) * 4)
    bytes_moved["pixel_dc"] = bytes_moved["pixel"] + n_mcu * 8 * 4
    bytes_moved["pixel_i8"] = bytes_moved["pixel_dma"] = bytes_moved["pixel"]
    for n in ("fused_px_bp", "pixel_dc", "pixel_i8", "pixel_dma"):
        flops[n] = flops["pixel"]
    bound = {}
    for n, by in bytes_moved.items():
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        t_ops = flops.get(n, 0.0) / FP64_FLOP_PER_S * 1e3
        bound[n] = (max(t_bytes, t_ops),
                    "operations" if t_ops > t_bytes else "bytes")
        print(f"[bound] {n}: {by} bytes, {flops.get(n, 0.0):.0f} float64 "
              f"FLOPs -> {bound[n][0]:.6f} ms ({bound[n][1]})")
    # K11 at 4:2:2 and 4:4:4 rows, counted as at 4:2:0.
    for sub in ("422", "444"):
        t = tabs[sub]
        fl_ = fused_pipeline.fused_pixel_block_pack_pairs(
            x, t, sub, ops.mcu_grid(h, w, sub)[1])[1].to(torch.int64)
        by = (x.numel() + (t.lum.numel() + t.chroma.numel() +
                           t.bias.numel()) * 4 + lut_bytes +
              (int(((fl_ + 31) // 32).sum()) + fl_.numel()) * 4)
        t_ops = flops[f"pixel {sub}"] / FP64_FLOP_PER_S * 1e3
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        print(f"[bound] fused_px_bp {sub} rows: {by} bytes, "
              f"{flops[f'pixel {sub}']:.0f} float64 FLOPs -> "
              f"{max(t_ops, t_bytes):.6f} ms "
              f"({'operations' if t_ops > t_bytes else 'bytes'})")
        del fl_
    by = bytes_moved["block_pack"] + (cls.numel() + dcd.numel()) * 4
    print(f"[bound] block_pack through jpegtpu's signature (class and DC "
          f"difference read, not derived): {by} bytes -> "
          f"{by / HBM_BYTES_PER_S * 1e3:.6f} ms (bytes)")

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"jpegtpu_torch/kernels/csrc/{src}", "replaces": rep,
         "launches": launches[n], "max_abs_err": errs[n],
         "ms": times[n][0], "plain_ms": times[n][1],
         "bound_ms": bound[n][0], "bound_by": bound[n][1],
         "library_ms": (library["420"] if n in ("pixel", "pixel_dc",
                                                "pixel_i8", "pixel_dma")
                        else None)}
        for n, _, src, rep in kernels]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
