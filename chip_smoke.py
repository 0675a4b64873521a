"""GPU smoke test of jpegtpu_torch: build the five CUDA kernels, hold each
against its plain torch twin on the card at 3840x2160, drive every encode
path (``jpegtpu_torch.encode``: 4:2:0 with a restart marker every MCU row,
the main path; 4:2:0 with no restart markers, with a ragged interval and
with a marker after every MCU; 4:2:2, 4:4:4 (also with a marker after every
MCU), 4:4:4s and gray) and check its bytes, then time everything.

    python3 chip_smoke.py

Needs one CUDA GPU of compute capability 9.0 (Hopper) and ``nvcc``; exits
non-zero, printing no result, without them. Each phase prints a line and
raises on failure. The last line is a JSON object with ``"ok": true``.
The package imports no JAX: the 1920x1080 golden hashes below tie the
card's output to jpegtpu's (``tests/test_torch_encoder.py`` and
``tests/test_torch_modes.py`` pin them to ``jpegtpu.encode``'s bytes).
"""

from __future__ import annotations

import hashlib
import json
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
# The paths whose device time the profiler splits by kernel.
PROFILED = (("420", "rows"), ("420", 0), ("420", 7), ("420", 1),
            ("444", 1))
TIMING_REPS = 20
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
    print(f"[profile] device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms per "
          f"encode (idle share {1 - busy_ms / wall_ms:.3f})  [{card}]")
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


def kernel_device_ms(fn, key: str, reps: int = 5) -> float | str:
    """Device time of the kernels whose name holds `key`, per call of fn
    (torch.profiler), or "not measured" when no such kernel was traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.self_device_time_total for e in prof.key_averages()
          if key in e.key]
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
    from jpegtpu_torch.encoder import EncoderTables, device_encode, geometry
    from jpegtpu_torch.entropy import scan
    from jpegtpu_torch.kernels import _build, compact, entropy_pack, fused_dctq

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
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")
    _build.library()

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

    def stuff_diff(fn, plain, sw_, sb_, restart_):
        buf_, tot_ = fn(sw_, sb_, restart_)
        buf_p_, tot_p_ = plain(sw_, sb_, restart_)
        tot_, tot_p_ = int(tot_), int(tot_p_)
        n_by, e_by = diff(buf_[:tot_], buf_p_[:tot_])
        return int(tot_ != tot_p_) + n_by, max(e_by, abs(tot_ - tot_p_)), tot_

    errs = {}
    coeffs = fused_dctq.encode_blocks_pairs(x, tables.m, tables.bias)
    coeffs_p = fused_dctq.encode_blocks_pairs_plain(x, tables.m, tables.bias)
    torch.cuda.synchronize()
    n_bad, errs["pixel"] = diff(coeffs, coeffs_p)
    report(f"K1 pixel 420 coefficients {tuple(coeffs.shape)}", n_bad,
           errs["pixel"])
    for sub in ("422", "444", "444s"):
        t = tabs[sub]
        c_k = fused_dctq.encode_blocks_pairs(x, t.m, t.bias, sub)
        c_p = fused_dctq.encode_blocks_pairs_plain(x, t.m, t.bias, sub)
        n_bad, e = diff(c_k, c_p)
        errs["pixel"] = max(errs["pixel"], e)
        report(f"K1 pixel {sub} coefficients {tuple(c_k.shape)}", n_bad, e)
        del c_k, c_p

    dcd = scan.dc_diffs_from_dc(coeffs[:, ::64], 4, restart).reshape(-1)
    cls = (torch.arange(n_mcu * 6, device=dev) % 6 >= 4).to(torch.int32)
    mw, ml = entropy_pack.block_pack_mcu_pairs(coeffs, cls, dcd, *luts)
    mw_p, ml_p = entropy_pack.block_pack_mcu_pairs_plain(coeffs, cls, dcd,
                                                         *luts)
    # Compare the stream bits only: bit i of word j is kept while 32j+i < ml.
    j = torch.arange(mw.shape[1], device=dev)[None, :]
    valid = torch.clamp(ml.to(torch.int64)[:, None] - 32 * j, 0, 32)
    word_mask = (0xFFFFFFFF << (32 - valid)) & 0xFFFFFFFF
    n_len, e_len = diff(ml, ml_p)
    n_w, e_w = diff((mw.to(torch.int64) & 0xFFFFFFFF) & word_mask,
                    (mw_p.to(torch.int64) & 0xFFFFFFFF) & word_mask)
    errs["block_pack"] = max(e_len, e_w)
    report(f"K2 block pack mlens {tuple(ml.shape)} + masked words "
           f"{tuple(mw.shape)}", n_len + n_w, errs["block_pack"])
    del mw_p, ml_p, valid, word_mask

    sw, sb = entropy_pack.seg_merge_mcu(mw, ml, n_seg, restart)
    sw_p, sb_p = entropy_pack.seg_merge_mcu_plain(mw, ml, n_seg, restart)
    n_b, e_b = diff(sb, sb_p)
    n_w, e_w = diff(sw, sw_p)
    errs["seg_merge"] = max(e_b, e_w)
    report(f"K3 seg merge seg_bits {tuple(sb.shape)} + words "
           f"{tuple(sw.shape)}", n_b + n_w, errs["seg_merge"])
    del sw_p

    n_bad, errs["stuff"], total = stuff_diff(
        compact.compact_segments_stuffed_grouped,
        compact.compact_segments_stuffed_grouped_plain, sw, sb, restart)
    report(f"K4 stuffing, {n_seg} segments, total {total} bytes", n_bad,
           errs["stuff"])

    # The restart-0 program's single segment: its DC chain has no reset,
    # and all n_mcu MCUs merge into one stream.
    dcd0 = scan.dc_diffs_from_dc(coeffs[:, ::64], 4, 0).reshape(-1)
    mw0, ml0 = entropy_pack.block_pack_mcu_pairs(coeffs, cls, dcd0, *luts)
    sw0, sb0 = entropy_pack.seg_merge_mcu(mw0, ml0, 1, n_mcu)
    sw0_p, sb0_p = entropy_pack.seg_merge_mcu_plain(mw0, ml0, 1, n_mcu)
    n_b, e_b = diff(sb0, sb0_p)
    n_w, e_w = diff(sw0, sw0_p)
    errs["seg_merge"] = max(errs["seg_merge"], e_b, e_w)
    report(f"K3 seg merge, one segment of {n_mcu} MCUs", n_b + n_w,
           max(e_b, e_w))
    del sw0_p, mw0
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

    # 4. Every path end to end, through the public entry point, each with
    # the launch counts set to 0 just before it and read just after.
    kernels = (("pixel", fused_dctq.PIXEL, "pixel.cu",
                "jpegtpu/kernels/fused_dctq.py:388"),
               ("block_pack", entropy_pack.BLOCK_PACK, "block_pack.cu",
                "jpegtpu/kernels/entropy_pack.py:619"),
               ("seg_merge", entropy_pack.SEG_MERGE, "seg_merge.cu",
                "jpegtpu/kernels/entropy_pack.py:879"),
               ("stuff", compact.STUFF, "stuff.cu",
                "jpegtpu/kernels/compact.py:1004"),
               ("stuff_chunks", compact.STUFF_CHUNKS, "stuff_chunks.cu",
                "jpegtpu/kernels/compact.py:317"))
    launches = {n: 0 for n, _, _, _ in kernels}

    def path_input(sub):
        return np.ascontiguousarray(img[..., 0]) if sub == "gray" else img

    def path_geometry(image, sub, restart_interval):
        cfg = EncoderConfig(quality=QUALITY, subsampling=sub,
                            restart_interval=restart_interval)
        hh, ww = image.shape[:2]
        pmy, pmx = ops.mcu_grid(hh, ww, sub)
        r = cfg.resolve_restart(pmx)
        return cfg, r, geometry(pmy * pmx, r)

    def encode_plain(image, sub, restart_interval):
        """The same program on the plain twins, on the card."""
        cfg, r, (ns, mps) = path_geometry(image, sub, restart_interval)
        hh, ww = image.shape[:2]
        t = tabs[sub]
        xi = torch.from_numpy(image).to(dev)
        if fused_dctq.uses_fused(hh, ww, sub):
            c = fused_dctq.encode_blocks_pairs_plain(xi, t.m, t.bias, sub)
        else:
            c = ops.encode_blocks(xi, t.block_m, t.block_bias, sub)
            c = c.reshape(c.shape[0], -1)
        nm, b = c.shape[0], c.shape[1] // 64
        d = scan.dc_diffs_from_dc(c[:, ::64], cfg.n_luma, r).reshape(-1)
        k = (torch.arange(nm * b, device=dev) % b >= cfg.n_luma
             ).to(torch.int32)
        a, bl = entropy_pack.block_pack_mcu_pairs_plain(c, k, d, *luts)
        a, bl = entropy_pack.pad_segments(a, bl, ns, mps)
        s, sbits = entropy_pack.seg_merge_mcu_plain(a, bl, ns, mps)
        stuff = (compact.compact_segments_stuffed_grouped_plain if ns > 1
                 else compact.compact_segments_stuffed_plain)
        out, tot = stuff(s, sbits, r)
        return jfif.wrap_jpeg(hh, ww, QUALITY, sub, r,
                              out[:int(tot)].cpu().numpy().tobytes())

    for sub, restart_interval in PATHS:
        image = path_input(sub)
        _, r, (ns, _) = path_geometry(image, sub, restart_interval)
        want = {"pixel": fused_dctq.uses_fused(h, w, sub), "block_pack": 1,
                "seg_merge": 1, "stuff": ns > 1, "stuff_chunks": ns == 1}
        for _, k, _, _ in kernels:
            k.launches = 0
        jpg = jpegtpu_torch.encode(image, quality=QUALITY, subsampling=sub,
                                   restart_interval=restart_interval)
        counts = {n: k.launches for n, k, _, _ in kernels}
        label = f"{w}x{h} q{QUALITY} {sub} restart {restart_interval!r}"
        print(f"[e2e] encode {label}: {len(jpg)} bytes, launches {counts}")
        missed = [n for n, on in want.items() if on and counts[n] < 1]
        if missed:
            raise AssertionError(f"{label}: kernels {missed} did not run")
        for n in launches:
            launches[n] += counts[n]
        if jpg != encode_plain(image, sub, restart_interval):
            raise AssertionError(f"{label}: bytes differ from the "
                                 f"plain-twin pipeline")
        n_rst = ns - 1 if r > 0 else 0
        check_scan_structure(jpg, n_rst)
        print(f"[e2e] {label}: bytes equal to the plain-twin pipeline on "
              f"the GPU; {n_rst} RST markers in order; stuffing valid")

    # 5. Golden files from jpegtpu.
    gold = jpegtpu_torch.encode(golden_image(), quality=QUALITY,
                                subsampling="420")
    digest = hashlib.sha256(gold).hexdigest()
    print(f"[golden] {GOLDEN_SHAPE[1]}x{GOLDEN_SHAPE[0]} q{QUALITY}: "
          f"{len(gold)} bytes sha256 {digest}")
    if digest != GOLDEN_SHA256:
        raise AssertionError(f"golden sha256 {digest} != {GOLDEN_SHA256}")
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
        "block_pack": (lambda: entropy_pack.block_pack_mcu_pairs(
                           coeffs, cls, dcd, *luts),
                       lambda: entropy_pack.block_pack_mcu_pairs_plain(
                           coeffs, cls, dcd, *luts)),
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
    }
    for sub in ("422", "444", "444s"):
        t = tabs[sub]
        pairs[f"pixel {sub}"] = (
            lambda t=t, sub=sub: fused_dctq.encode_blocks_pairs(
                x, t.m, t.bias, sub),
            lambda t=t, sub=sub: fused_dctq.encode_blocks_pairs_plain(
                x, t.m, t.bias, sub))
    times = {}
    for label, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        times[label] = (min(k1, k2), min(p1, p2))
        line(f"{label} kernel (wrapper + glue)", times[label][0])
        line(f"{label} plain twin", times[label][1])
    line("stuff.cu (one block per segment) on the restart-0 segment",
         time_ms(lambda: compact.compact_segments_stuffed_grouped(
             sw0, sb0, 0)))

    # K4 and K5 on the same multi-segment sets, in turns (K4, K5, K5, K4),
    # wrapper with glue (CUDA events) and kernel alone (profiler). K5 takes
    # the words padded to whole 4 KB chunks, padded outside the timing (the
    # layout a single segment has); its scan must equal K4's.
    def seg_set(c, sub, r):
        n_luma = EncoderConfig(subsampling=sub).n_luma
        nm, b = c.shape[0], c.shape[1] // 64
        ns, mps = geometry(nm, r)
        d = scan.dc_diffs_from_dc(c[:, ::64], n_luma, r).reshape(-1)
        k = (torch.arange(nm * b, device=dev) % b >= n_luma).to(torch.int32)
        a, bl = entropy_pack.block_pack_mcu_pairs(c, k, d, *luts)
        a, bl = entropy_pack.pad_segments(a, bl, ns, mps)
        return (*entropy_pack.seg_merge_mcu(a, bl, ns, mps), r)

    c444 = fused_dctq.encode_blocks_pairs(x, tabs["444"].m, tabs["444"].bias,
                                          "444")
    seg_sets = {"420 rows": (sw, sb, restart),
                "420 restart 7": seg_set(coeffs, "420", 7),
                "420 restart 1": seg_set(coeffs, "420", 1),
                "444 rows": seg_set(c444, "444",
                                    ops.mcu_grid(h, w, "444")[1])}
    del c444
    for label, (sw_, sb_, r_) in seg_sets.items():
        sw5 = torch.nn.functional.pad(sw_,
                                      (0, -sw_.shape[1] % compact.CHUNK_WORDS))
        b4, t4 = compact.compact_segments_stuffed_grouped(sw_, sb_, r_)
        b5, t5 = compact.compact_segments_stuffed(sw5, sb_, r_)
        t4, t5 = int(t4), int(t5)
        n_bad, e = diff(b5[:t4], b4[:t4])
        report(f"K5 against K4 on the {label} segments "
               f"{tuple(sw_.shape)}, {t4} bytes", n_bad + int(t4 != t5),
               max(e, abs(t4 - t5)))
        del b4, b5
        k4 = lambda: compact.compact_segments_stuffed_grouped(  # noqa: E731
            sw_, sb_, r_)
        k5 = lambda: compact.compact_segments_stuffed(  # noqa: E731
            sw5, sb_, r_)
        a1, c1, c2, a2 = time_ms(k4), time_ms(k5), time_ms(k5), time_ms(k4)
        line(f"{label} segments: K4 stuff.cu wrapper", min(a1, a2))
        line(f"{label} segments: K5 stuff_chunks.cu wrapper", min(c1, c2))
        print(f"[time] {label} segments: kernel alone (profiler): K4 "
              f"{kernel_device_ms(k4, '::stuff_kernel(')} ms, K5 "
              f"{kernel_device_ms(k5, '::stuff_chunks_kernel(')} ms  "
              f"[{card}]")
    del seg_sets

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

    dev_ms = {}
    for sub, restart_interval in PATHS:
        image = torch.from_numpy(path_input(sub)).to(dev)
        _, r, _ = path_geometry(path_input(sub), sub, restart_interval)
        dev_ms[sub, restart_interval] = time_ms(
            lambda: device_encode(image, tabs[sub], sub, r))
        line(f"encode on device (no host fetch), {sub} restart "
             f"{restart_interval!r}", dev_ms[sub, restart_interval])
    enc = jpegtpu_torch.Encoder(jpegtpu_torch.EncoderConfig(
        quality=QUALITY, subsampling="420"))
    enc.encode(img)
    t_wall = time.perf_counter()
    for _ in range(TIMING_REPS):
        enc.encode(img)                   # ends in the host fetch: synced
    line("encode with host upload + fetch + JFIF wrap (host clock)",
         (time.perf_counter() - t_wall) * 1e3 / TIMING_REPS)
    for sub, restart_interval in PROFILED:
        _, r, _ = path_geometry(img, sub, restart_interval)
        print(f"[profile] {sub} restart {restart_interval!r}")
        profile_device_encode(lambda: device_encode(x, tabs[sub], sub, r),
                              dev_ms[sub, restart_interval], card)

    # The least time the card could take for each kernel's work on these
    # inputs: the larger of its bytes (inputs read once, outputs written
    # once; the entropy kernels touch only the valid words and bytes, not
    # the worst-case buffers) over the HBM rate and, for K1, the float64
    # FLOPs that its operator needs (operator_fmas) over the float64 peak.
    # The entropy kernels' integer operations, and K1's integer pixel sums,
    # are not counted.
    valid_mcu_words = int(((ml.to(torch.int64) + 31) // 32).sum())
    nbytes_rows = int(((sb.to(torch.int64) + 7) // 8).sum())
    nbytes0 = (int(sb0[0]) + 7) // 8
    bytes_moved = {
        "block_pack": ((coeffs.numel() + cls.numel() + dcd.numel()) * 4 +
                       sum(t.numel() * 4 for t in luts) +
                       (valid_mcu_words + ml.numel()) * 4),
        "seg_merge": 2 * valid_mcu_words * 4 + n_mcu * 8 + n_seg * 4,
        "stuff": nbytes_rows + n_seg * 12 + total,
        "stuff_chunks": nbytes0 + n_chunks * 12 + 16 + total0,
    }
    flops = {}
    for sub in ("420", "422", "444", "444s"):
        t = tabs[sub]
        nm = int(np.prod(ops.mcu_grid(h, w, sub)))
        key = "pixel" if sub == "420" else f"pixel {sub}"
        bytes_moved[key] = (x.numel() + (t.m.numel() + t.bias.numel()) * 4
                            + nm * t.m.shape[1] * 4)
        flops[key] = 2.0 * nm * operator_fmas(t.m.cpu().numpy(), sub)
    bound = {}
    for n, by in bytes_moved.items():
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        t_ops = flops.get(n, 0.0) / FP64_FLOP_PER_S * 1e3
        bound[n] = (max(t_bytes, t_ops),
                    "operations" if t_ops > t_bytes else "bytes")
        print(f"[bound] {n}: {by} bytes, {flops.get(n, 0.0):.0f} float64 "
              f"FLOPs -> {bound[n][0]:.6f} ms ({bound[n][1]})")

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"jpegtpu_torch/kernels/csrc/{src}", "replaces": rep,
         "launches": launches[n], "max_abs_err": errs[n],
         "ms": times[n][0], "plain_ms": times[n][1],
         "bound_ms": bound[n][0], "bound_by": bound[n][1],
         "library_ms": library["420"] if n == "pixel" else None}
        for n, _, src, rep in kernels]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
