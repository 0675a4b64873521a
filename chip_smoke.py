"""GPU smoke test of jpegtpu_torch: build the four CUDA kernels, hold each
against its plain torch twin on the card at 3840x2160, drive the main path
(``jpegtpu_torch.encode``) and check its bytes, then time everything.

    python3 chip_smoke.py

Needs one CUDA GPU of compute capability 9.0 (Hopper) and ``nvcc``; exits
non-zero, printing no result, without them. Each phase prints a line and
raises on failure. The last line is a JSON object with ``"ok": true``.
The package imports no JAX: the 1920x1080 golden hash below ties the card's
output to jpegtpu's (``tests/test_torch_encoder.py`` pins it to
``jpegtpu.encode``'s bytes).
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
TIMING_REPS = 20


def bench_image(h: int = BENCH_SHAPE[0], w: int = BENCH_SHAPE[1]) -> np.ndarray:
    """bench.py's synthetic content: smooth gradients plus sensor noise."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 97.0) * np.cos(yy / 53.0)
    return np.clip(base[..., None] + rng.normal(0, 12, (h, w, 3)),
                   0, 255).astype(np.uint8)


def golden_image(h: int = GOLDEN_SHAPE[0],
                 w: int = GOLDEN_SHAPE[1]) -> np.ndarray:
    """Elliptic rings, one centre per channel, in integer arithmetic only,
    so every machine makes the same pixels. The centres were chosen so that
    no coefficient lies near a rounding tie: jpegtpu's float32 product
    rounds a few such coefficients of most 1080p images differently from
    the exact value (ROADMAP.md, faults 3.1)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.int64)
    chans = [((xx - cx) ** 2 + 2 * (yy - cy) ** 2) // d % 256
             for cx, cy, d in ((1104, 876, 1088), (304, 476, 1185),
                               (804, 776, 1282))]
    return np.stack(chans, axis=-1).astype(np.uint8)


def card_line() -> str:
    """`name, power.limit` of GPU 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check_scan_structure(jpg: bytes, n_rst: int) -> None:
    """SOI ... EOI, exactly n_rst RST markers, and every 0xFF in the scan
    followed by 0x00 or an RST code."""
    if jpg[:2] != b"\xff\xd8" or jpg[-2:] != b"\xff\xd9":
        raise AssertionError("missing SOI/EOI")
    sos = jpg.find(b"\xff\xda")
    scan_start = sos + 2 + int.from_bytes(jpg[sos + 2:sos + 4], "big")
    body = np.frombuffer(jpg[scan_start:-2], np.uint8)
    ff = np.flatnonzero(body == 0xFF)
    if ff.size and ff[-1] == body.size - 1:
        raise AssertionError("scan ends in a bare 0xFF")
    nxt = body[ff + 1]
    rst = int(np.count_nonzero((nxt >= 0xD0) & (nxt <= 0xD7)))
    bad = int(np.count_nonzero((nxt != 0) & ~((nxt >= 0xD0) & (nxt <= 0xD7))))
    if bad or rst != n_rst:
        raise AssertionError(f"scan structure: {rst} RST markers (want "
                             f"{n_rst}), {bad} unstuffed 0xFF bytes")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    import jpegtpu_torch
    from jpegtpu_torch.container import jfif
    from jpegtpu_torch.core import ops
    from jpegtpu_torch.encoder import EncoderTables, device_encode
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

    # 2. Build
    secs = _build.build()
    lib = _build.library_path()
    print(f"[build] {lib.name} from {', '.join(_build.SOURCES)} "
          f"in {secs:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")
    _build.library()

    # 3. Each kernel against its plain twin, at the main path's shapes.
    h, w = BENCH_SHAPE
    img = bench_image()
    x = torch.from_numpy(img).to(dev)
    tables = EncoderTables.for_quality(QUALITY, dev)
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

    coeffs = fused_dctq.encode_blocks_pairs(x, tables.m, tables.bias)
    coeffs_p = fused_dctq.encode_blocks_pairs_plain(x, tables.m, tables.bias)
    torch.cuda.synchronize()
    errs = {}
    n_bad, errs["pixel"] = diff(coeffs, coeffs_p)
    report(f"K1 pixel coefficients {tuple(coeffs.shape)}", n_bad,
           errs["pixel"])

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

    sw, sb = entropy_pack.seg_merge_mcu(mw, ml, n_seg, restart)
    sw_p, sb_p = entropy_pack.seg_merge_mcu_plain(mw, ml, n_seg, restart)
    n_b, e_b = diff(sb, sb_p)
    n_w, e_w = diff(sw, sw_p)
    errs["seg_merge"] = max(e_b, e_w)
    report(f"K3 seg merge seg_bits {tuple(sb.shape)} + words "
           f"{tuple(sw.shape)}", n_b + n_w, errs["seg_merge"])

    buf, total = compact.compact_segments_stuffed(sw, sb, restart)
    buf_p, total_p = compact.compact_segments_stuffed_plain(sw, sb, restart)
    total, total_p = int(total), int(total_p)
    n_t = int(total != total_p)
    n_by, e_by = diff(buf[:total], buf_p[:total])
    errs["stuff"] = max(e_by, abs(total - total_p))
    report(f"K4 stuffing total {total} bytes", n_t + n_by, errs["stuff"])

    # 4. The main path end to end, through the public entry point.
    kernels = (("pixel", fused_dctq.PIXEL, "pixel.cu",
                "jpegtpu/kernels/fused_dctq.py:388"),
               ("block_pack", entropy_pack.BLOCK_PACK, "block_pack.cu",
                "jpegtpu/kernels/entropy_pack.py:619"),
               ("seg_merge", entropy_pack.SEG_MERGE, "seg_merge.cu",
                "jpegtpu/kernels/entropy_pack.py:879"),
               ("stuff", compact.STUFF, "stuff.cu",
                "jpegtpu/kernels/compact.py:1004"))
    for _, k, _, _ in kernels:
        k.launches = 0
    jpg = jpegtpu_torch.encode(img, quality=QUALITY, subsampling="420")
    launches = {n: k.launches for n, k, _, _ in kernels}
    print(f"[e2e] encode {w}x{h} q{QUALITY} 420: {len(jpg)} bytes, "
          f"launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel did not run on the main path: "
                             f"{launches}")

    def encode_plain(image):
        hh, ww = image.shape[:2]
        r = ops.mcu_grid(hh, ww, "420")[1]
        xi = torch.from_numpy(image).to(dev)
        c = fused_dctq.encode_blocks_pairs_plain(xi, tables.m, tables.bias)
        d = scan.dc_diffs_from_dc(c[:, ::64], 4, r).reshape(-1)
        k = (torch.arange(c.shape[0] * 6, device=dev) % 6 >= 4).to(torch.int32)
        a, b = entropy_pack.block_pack_mcu_pairs_plain(c, k, d, *luts)
        s, sbits = entropy_pack.seg_merge_mcu_plain(a, b, c.shape[0] // r, r)
        out, tot = compact.compact_segments_stuffed_plain(s, sbits, r)
        return jfif.wrap_jpeg(hh, ww, QUALITY, "420", r,
                              out[:int(tot)].cpu().numpy().tobytes())

    jpg_plain = encode_plain(img)
    if jpg != jpg_plain:
        raise AssertionError("4K encode differs from the plain-twin pipeline")
    check_scan_structure(jpg, n_seg - 1)
    print(f"[e2e] bytes equal to the plain-twin pipeline on the GPU; "
          f"{n_seg - 1} RST markers; stuffing valid")

    # 5. Golden file from jpegtpu.
    gold = jpegtpu_torch.encode(golden_image(), quality=QUALITY,
                                subsampling="420")
    digest = hashlib.sha256(gold).hexdigest()
    print(f"[golden] {GOLDEN_SHAPE[1]}x{GOLDEN_SHAPE[0]} q{QUALITY}: "
          f"{len(gold)} bytes sha256 {digest}")
    if digest != GOLDEN_SHA256:
        raise AssertionError(f"golden sha256 {digest} != {GOLDEN_SHA256}")

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
        "stuff": (lambda: compact.compact_segments_stuffed(sw, sb, restart),
                  lambda: compact.compact_segments_stuffed_plain(
                      sw, sb, restart)),
    }
    times = {}
    for label, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        times[label] = (min(k1, k2), min(p1, p2))
        line(f"{label} kernel (wrapper + glue)", times[label][0])
        line(f"{label} plain twin", times[label][1])
    enc = jpegtpu_torch.Encoder(jpegtpu_torch.EncoderConfig(
        quality=QUALITY, subsampling="420"))
    dev_ms = time_ms(lambda: device_encode(x, enc.tables, restart))
    line("encode on device (no host fetch)", dev_ms)
    enc.encode(img)
    t_wall = time.perf_counter()
    for _ in range(TIMING_REPS):
        enc.encode(img)                   # ends in the host fetch: synced
    line("encode with host upload + fetch + JFIF wrap (host clock)",
         (time.perf_counter() - t_wall) * 1e3 / TIMING_REPS)
    profile_device_encode(lambda: device_encode(x, enc.tables, restart),
                          dev_ms, card)

    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"jpegtpu_torch/kernels/csrc/{src}", "replaces": rep,
         "launches": launches[n], "max_abs_err": errs[n],
         "ms": times[n][0], "plain_ms": times[n][1]}
        for n, _, src, rep in kernels]}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
