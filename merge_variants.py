"""Design runs of K8, K9 and K10, the zero-tail instances of the
segment-merge body (``jpegtpu_torch/kernels/csrc/seg_merge.cu``), on the
card: build the body as it is and variants of it that each change one
thing, then time K8 (``jt_mcu_merge``) at 3840x2160 q90 4:2:0 and 4:4:4
rows, K10 (``jt_seg_merge_v1``) at 4:2:0 rows and restart 0 on the oracle
ladder's block streams (K7's), and K9 (``jt_seg_merge_window``) at 4:2:0
rows, 4:4:4 rows and 4:2:0 restart 0 on K8's MCU streams, each variant
alone (profiler, 20 launches, the kernel and its scratch memset apart), in
turns, first forward then backward. Each variant is held to the plain
twins first, whole rows and lengths, bit for bit (the timing-only variants
must disagree).

    python3 merge_variants.py [variant ...]
    python3 merge_variants.py --wrappers

With --wrappers it builds no variant and times K8, K9 and K10 through the
wrappers of the package beside the script (every device op of a call:
kernel, memsets, fills), so a copy of the script beside an earlier
commit's package times that commit's kernels.

Variants:
    final     the body as it is: whole-segment tiles of up to 512 rows,
              their zeros stored first in 16-byte stores, then the data
              words; split tiles of 512 rows; tail tiles of 16,384 words
              in 16-byte stores
    first     the first design: whole-segment tiles of about 128 rows
              (K3's size), each thread storing its words in row order, one
              word a store, a data word built where it falls
    scalar    final with the whole tile's zeros stored a word at a time
    target    whole-segment tiles of about 128 rows (K3's size)
    tail64k   tail tiles of 65,536 words
    split256  split tiles of 256 rows (K3's), not 512
    interleave  each segment's tail tiles taken right after its data
              tiles, not after every data tile
    prefetch  a whole tile's lengths loaded during the tile before it
    notail    tail tiles that store nothing (timing only: disagrees)
    nodata    no data words in K8, K9 and K10 (timing only: disagrees)
    k9whole   segments of up to 512 rows go whole whatever their row's
              width (K9 at 4K 4:2:0 rows: a thread block two 76,800-word
              rows)
    k9whole1  k9whole, with tiles of whole segments that aim for 256 rows,
              not 512 (one 240- or 480-MCU segment a tile)
    k9split512  K9's split tiles of 512 MCUs (K8's and K10's), not 256

The copies go to ``.chipcheck/merge_variants/`` (git-ignored), each built
with seg_merge.cu alone. Needs a CUDA GPU and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / ".chipcheck" / "merge_variants"
CSRC = ROOT / "jpegtpu_torch" / "kernels" / "csrc"

# The zero-tail whole tile's store phase as the body has it (from its
# comment to the data words' loop), and two earlier designs of it.
ZERO_BLOCK = ("    if (kZeroTail && !split) {\n      // 4'.",
              "    // 4. Each word from the row")
SCALAR = """    if (kZeroTail && !split) {
      const int sw = (int)max(seg_words, 1LL);
      const int step_p = kThreads / sw, step_q = kThreads - step_p * sw;
      int p = tid / sw, qi = tid - p * sw;
      uint32_t* dst = out + s0 * seg_words;
      for (long long f = tid; f < np * seg_words; f += kThreads) {
        DATA_OR_ZERO
        p += step_p;
        qi += step_q;
        if (qi >= sw) {
          qi -= sw;
          ++p;
        }
      }
    }

"""
ZEROS = "if (qi >= s_wpre[p + 1] - s_wpre[p]) dst[f] = 0u;"
INLINE = """uint32_t v = 0u;
        if (qi < s_wpre[p + 1] - s_wpre[p]) {
          const int lo = p * per;
          v = segment_word<kPad>(mwords, mlens, s_off, s_len, lo,
              lo + per - 1, 32 * qi + s_off[lo], first, n, nm,
              (s0 + p + 1) * mps, mcu_words);
        }
        dst[f] = v;"""
# Tail tickets right after their segment's data tiles, not after every
# data tile.
INTERLEAVE_OLD = """    const long long t = split ? s_tile : k;
    if constexpr (kZeroTail) {
      if (split && t >= n_tiles) {
        // A tail tile: share j of segment s's row, past its data.
        const long long u = t - n_tiles;
        if (u >= n_seg * tails) break;
        const long long s = u / tails, j = u - s * tails;
"""
INTERLEAVE_NEW = """    long long t = split ? s_tile : k;
    if constexpr (kZeroTail) {
      const long long r = split ? t % (tps + tails) : 0;
      if (split && r < tps && t < n_seg * (tps + tails)) {
        t = t / (tps + tails) * tps + r;
      } else if (split) {
        if (t >= n_seg * (tps + tails)) break;
        const long long s = t / (tps + tails), j = r - tps;
"""
TARGET_128 = ("const long long target = kZeroTail ? kMaxTile : kTargetMcus;",
              "const long long target = kTargetMcus;")
# Segments of up to kMaxTile rows whole, whatever their rows' width.
WHOLE_WIDE = ("  const bool split = mps > kMaxTile || (kZeroTail && seg_words > "
              "kTailWords);", "  const bool split = mps > kMaxTile;")


def store_phase(body: str):
    """A replacement of the zero-tail whole tile's store phase."""
    def edit(src: str) -> str:
        i, j = src.index(ZERO_BLOCK[0]), src.index(ZERO_BLOCK[1])
        return src[:i] + body + src[j:]
    return edit


# name -> edits of seg_merge.cu: (text, its replacement) pairs, or
# functions of the source. Variants in TIMING_ONLY take out work and must
# disagree with the twins.
VARIANTS = {
    "final": [],
    "first": [TARGET_128, store_phase(SCALAR.replace("DATA_OR_ZERO",
                                                     INLINE)),
              ("    for (int f = tid; f < n_words; f += kThreads) {",
               "    for (int f = tid; f < (kZeroTail && !split ? 0 : n_words);"
               "\n         f += kThreads) {")],
    "scalar": [store_phase(SCALAR.replace("DATA_OR_ZERO", ZEROS))],
    "target": [TARGET_128],
    "tail64k": [("constexpr long long kTailWords = 16384;",
                 "constexpr long long kTailWords = 65536;")],
    "split256": [("constexpr int kZeroSplit = 512;",
                  "constexpr int kZeroSplit = 256;")],
    "interleave": [(INTERLEAVE_OLD, INTERLEAVE_NEW)],
    "prefetch": [
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
         "  int len_next = 0;\n"),
        ("    const int len = tid < n && gi < nm ? mlens[gi] : 0;",
         "    const int len = kZeroTail && !split && k != blockIdx.x\n"
         "        ? len_next : tid < n && gi < nm ? mlens[gi] : 0;"),
        ("    if (kZeroTail && !split && tid == 0) s_wpre[np] = n_words;\n",
         "    if (kZeroTail && !split && tid == 0) s_wpre[np] = n_words;\n"
         "    if (kZeroTail && !split) {\n"
         "      const long long s1 = (k + gridDim.x) * spt;\n"
         "      const long long g1 = s1 * mps + tid;\n"
         "      len_next = s1 < n_seg && tid < min(spt, n_seg - s1) * per &&\n"
         "                 g1 < nm ? mlens[g1] : 0;\n"
         "    }\n")],
    "notail": [("        if (tid < a - lo) row[lo + tid] = 0u;",
                "        if (lo < 0) row[lo + tid] = 0u;"),
               ("        for (long long q4 = (a >> 2) + tid; q4 < (hi >> 2);",
                "        for (long long q4 = hi; q4 < (hi >> 2);")],
    "nodata": [("    for (int f = tid; f < n_words; f += kThreads) {",
                "    for (int f = tid; f < (kZeroTail ? 0 : n_words);"
                " f += kThreads) {")],
    "k9whole": [WHOLE_WIDE],
    "k9whole1": [WHOLE_WIDE,
                 ("const long long target = kZeroTail ? kMaxTile : "
                  "kTargetMcus;",
                  "const long long target = kZeroTail ? 256 : kTargetMcus;")],
    "k9split512": [("  return launch<true, true, kSplitMcus>(mwords,",
                    "  return launch<true, true, kZeroSplit>(mwords,")],
}
TIMING_ONLY = {"notail", "nodata"}


def build(names) -> dict:
    """Each variant's seg_merge.cu alone, compiled into its own library
    (all nvcc processes at once) -> name -> ctypes.CDLL."""
    from jpegtpu_torch.kernels import _build
    src = (CSRC / "seg_merge.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for edit in VARIANTS[name]:
            if callable(edit):
                text = edit(text)
                continue
            old, new = edit
            if old not in text:
                raise AssertionError(f"variant {name}: {old!r} not found")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "seg_merge.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(CSRC),
             "-o", str(d / "lib.so"), str(d / "seg_merge.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: {regs}")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in (libs[name].jt_mcu_merge, libs[name].jt_seg_merge_v1,
                   libs[name].jt_seg_merge_window):
            fn.argtypes = ([ctypes.c_void_p] * 5 +
                           [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return libs


def device_ops(fn, reps: int = 20) -> dict:
    """Device time per call of fn by device op (kernels, memsets, fills),
    from torch.profiler over reps calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def time_wrappers(cases, entropy_pack, card) -> int:
    """K8, K9 and K10 through the package's wrappers (entropy_pack's
    mcu_merge, seg_merge_v2's seg_merge_window and seg_merge; whichever
    package this copy of the script imports), every device op of a call,
    twice in turns."""
    from jpegtpu_torch.kernels import entropy_oracles
    fns = {}
    for case, (sym, bw, bl, ns, per, width) in cases.items():
        fns[case] = ((lambda bw=bw, bl=bl, g=per: entropy_pack.mcu_merge(
                         bw, bl, g)) if sym == "jt_mcu_merge" else
                     (lambda bw=bw, bl=bl, ns=ns, per=per, width=width:
                      entropy_oracles.seg_merge_window(bw, bl, ns, per,
                                                       width))
                     if sym == "jt_seg_merge_window" else
                     (lambda bw=bw, bl=bl, ns=ns, per=per, width=width:
                      entropy_pack.seg_merge(bw, bl, ns, per, width)))
    runs = {}
    for turn in (0, 1):
        for case, fn in fns.items():
            runs[turn, case] = device_ops(fn)
    for case in fns:
        for turn in (0, 1):
            ops_ = runs[turn, case]
            print(f"[wrapper] {case} turn {turn + 1}: "
                  f"{sum(ops_.values()):.4f} ms on the device per call: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in ops_.items())
                  + f"  [{card}]")
    return 0


def main(names) -> int:
    import torch

    import chip_smoke
    from jpegtpu_torch.core import ops
    from jpegtpu_torch.encoder import EncoderTables, geometry
    from jpegtpu_torch.entropy import scan
    from jpegtpu_torch.kernels import entropy_oracles, entropy_pack, fused_dctq

    if not torch.cuda.is_available():
        print("merge_variants: no CUDA GPU", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    wrappers = "--wrappers" in names
    names = [n for n in names if n != "--wrappers"] or list(VARIANTS)
    dev = torch.device("cuda")
    x = torch.from_numpy(chip_smoke.bench_image()).to(dev)
    cases = {}
    h, w = chip_smoke.BENCH_SHAPE
    for sub, n_luma, restarts in (("420", 4, ("rows", 0)),
                                  ("444", 1, ("rows",))):
        t = EncoderTables.for_quality(chip_smoke.QUALITY, sub, dev)
        c = fused_dctq.encode_blocks_pairs(x, t.m, t.bias, sub)
        nm, g = c.shape[0], c.shape[1] // 64
        for ri in restarts:
            r = ops.mcu_grid(h, w, sub)[1] if ri == "rows" else 0
            ns, mps = geometry(nm, r)
            d = scan.dc_diffs_from_dc(c[:, ::64], n_luma, r).reshape(-1)
            k = entropy_pack.block_classes(nm, g, n_luma, dev)
            bw, bl = entropy_pack.block_pack(c.reshape(-1, 64), k, d)
            w_cap = entropy_pack.segment_words(ns, mps,
                                               entropy_pack.mcu_words(g))
            label = f"{sub} {'rows' if r else 'restart 0'}"
            if r:
                cases[f"K8 {label}"] = (
                    "jt_mcu_merge", bw, bl, nm, g,
                    128 * entropy_oracles.default_chunks(g))
            if sub == "420":
                cases[f"K10 {label}"] = ("jt_seg_merge_v1", bw, bl, ns,
                                         mps * g, -(-w_cap // 128) * 128)
            mw, ml = entropy_oracles.mcu_merge(bw, bl, g)
            cases[f"K9 {label}"] = ("jt_seg_merge_window", mw, ml, ns, mps,
                                    (-(-w_cap // 1024) + 1) * 1024)
        del c
    if wrappers:
        return time_wrappers(cases, entropy_pack, card)
    libs = build(names)
    twins = {}
    for case, (sym, bw, bl, ns, per, width) in cases.items():
        # K9's twin and K10's are one join (seg_merge_window_plain).
        twins[case] = (entropy_oracles.mcu_merge_plain(bw, bl, per, width)
                       if sym == "jt_mcu_merge" else
                       entropy_oracles.seg_merge_plain(bw, bl, ns, width))

    def runner(name, case):
        sym, bw, bl, ns, per, width = cases[case]
        out = torch.empty((ns, width), dtype=torch.int32, device=dev)
        sb = torch.empty((ns,), dtype=torch.int32, device=dev)
        # Room for any variant's status words: split tiles of 256 rows or
        # more (the count of K3's tiles), or one a segment split for its
        # row's width.
        n_scr = (entropy_pack.SEG_MERGE_SCRATCH_HEAD +
                 ns * -(-per // entropy_pack.SEG_MERGE_TILE))
        scr = torch.empty(n_scr, dtype=torch.int64, device=dev)
        fn = getattr(libs[name], sym)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = fn(bw.data_ptr(), bl.data_ptr(), out.data_ptr(),
                     sb.data_ptr(), scr.data_ptr(), ns, per, bw.shape[1],
                     width, stream)
            if err:
                raise RuntimeError(f"{name} {case}: CUDA error {err}")
        return run, out, sb

    for name in names:
        bad = 0
        for case in cases:
            run, out, sb = runner(name, case)
            out.fill_(chip_smoke.SENTINEL)
            run()
            torch.cuda.synchronize()
            bad += int((out != twins[case][0]).sum() +
                       (sb != twins[case][1]).sum())
        print(f"[parity] {name}: {bad} mismatches against the twins on "
              f"{', '.join(cases)} (whole rows, lengths)")
        if bool(bad) != (name in TIMING_ONLY):
            raise AssertionError(f"variant {name}: {bad} mismatches")
    for case in cases:
        out = runner(names[0], case)[1]
        fill = chip_smoke.kernel_device_ms(out.zero_, "", reps=20)
        print(f"[time] reference: torch zero_ of {case}'s output "
              f"{tuple(out.shape)} (profiler, every device op): {fill} ms  "
              f"[{card}]")
    times = {}
    for order, seq in (("forward", names), ("backward", names[::-1])):
        for name in seq:
            for case in cases:
                run = runner(name, case)[0]
                # One instance runs a case: any instance's name is its key.
                kern = chip_smoke.kernel_device_ms(
                    run, "seg_merge_mcu_kernel<", reps=20)
                mem = chip_smoke.kernel_device_ms(run, "Memset", reps=20)
                times[order, name, case] = (kern, mem)
    for name in names:
        cells = "; ".join(
            f"{case} {times['forward', name, case][0]} / "
            f"{times['backward', name, case][0]} ms"
            + (f" (+ memset {times['forward', name, case][1]})"
               if times['forward', name, case][1] != "not measured" else "")
            for case in cases)
        print(f"[time] {name} (forward / backward): {cells}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
