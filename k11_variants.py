"""Design runs of K11 (``jpegtpu_torch/kernels/csrc/fused_px_bp.cu``) on
the card: build the kernel as it is and variants of it that each change
one thing, then time each alone at 3840x2160 q90, 4:2:0, 4:2:2 and 4:4:4
rows (profiler, 20 launches), in turns, first forward then backward, one
process a run. Each run also holds the variant against the plain twin at
420 rows / restart 0 / restart 7, 422 and 444 rows (lengths and masked
stream bits); the variants that take a phase out are for timing only and
must disagree.

    python3 k11_variants.py [variant ...]

Variants (the kernel's loop over its run of tiles, rewritten):
    final    the kernel as it is: the next tile staged beside the pack,
             three barriers a tile
    first    the first design: staging, sums, product and pack in turn,
             four barriers a tile
    nopack   first, with the pack taken out (the product alone)
    noprod   first, with the product run on the run's first tile alone
             (the pack alone, on real coefficients)
    halo     first over K1's strided tiles, the DC values of every tile's
             predecessor from halo_dc (no carry from tile to tile)
    two      first, each warp packing two MCUs at once (j and j + 12),
             the second into a row in the pixel buffer

The copies go to ``.chipcheck/k11_variants/`` (git-ignored), each built
with fused_px_bp.cu alone. Needs a CUDA GPU and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / ".chipcheck" / "k11_variants"
KERNEL = "jpegtpu_torch/kernels/csrc/fused_px_bp.cu"

# The first design's loop over the run of tiles (replaces the kernel's, from
# its run bounds to the end of the kernel body).
FIRST = '''  const long long t0 = (long long)blockIdx.x * n_tiles / gridDim.x;
  const long long t1 = (long long)(blockIdx.x + 1) * n_tiles / gridDim.x;
  if (warp == 0 && t0 > 0 && (t0 * kTile) % interval != 0)
    halo_dc<F>(img, lum, chroma, bias, t0 * kTile - 1, nrx, row_bytes, lane,
               carry);
  typename S::Piece r[S::kPerThread];
  S::template fetch<false>(r, img, t0 * kTile, n_mcu, nrx, row_bytes);
  for (long long tile = t0; tile < t1; ++tile) {
    const long long m0 = tile * kTile;
    __syncthreads();
    if (tile != t0 && threadIdx.x < kG)
      carry[threadIdx.x] =
          coef[(kTile - 1) * F::kCoefStride + 64 * threadIdx.x];
#pragma unroll
    for (int i = 0; i < S::kPerThread; ++i)
      pieces[threadIdx.x + i * kThreads] = r[i];
    if (tile + 1 < t1)
      S::template fetch<false>(r, img, m0 + kTile, n_mcu, nrx, row_bytes);
    __syncthreads();
    jt::group_sums<F>(px, sums, threadIdx.x, kThreads);
    __syncthreads();
    PRODUCT
    __syncthreads();
    const int* cur = carry;
PACK  }
}

'''
PRODUCT = '''jt::tile_product<F>(px, sums, lum_f, chroma_f, bias, coef, m0, n_mcu,
                        warp, kWarps, lane);'''

HALO = '''  typename S::Piece r[S::kPerThread];
  long long tile = blockIdx.x;
  if (warp == 0 && tile > 0 && (tile * kTile) % interval != 0)
    halo_dc<F>(img, lum, chroma, bias, tile * kTile - 1, nrx, row_bytes, lane,
               carry);
  int slot = 0;
  if (tile < n_tiles)
    S::template fetch<false>(r, img, tile * kTile, n_mcu, nrx, row_bytes);
  for (; tile < n_tiles; tile += gridDim.x, slot ^= 1) {
    const long long m0 = tile * kTile;
    const long long next = tile + gridDim.x;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < S::kPerThread; ++i)
      pieces[threadIdx.x + i * kThreads] = r[i];
    if (next < n_tiles)
      S::template fetch<false>(r, img, next * kTile, n_mcu, nrx, row_bytes);
    __syncthreads();
    jt::group_sums<F>(px, sums, threadIdx.x, kThreads);
    __syncthreads();
    jt::tile_product<F>(px, sums, lum_f, chroma_f, bias, coef, m0, n_mcu,
                        warp, kWarps, lane);
    __syncthreads();
    const int* cur = carry + 8 * slot;
    if (warp == kWarps - 1 && next < n_tiles &&
        (next * kTile) % interval != 0)
      halo_dc<F>(img, lum, chroma, bias, next * kTile - 1, nrx, row_bytes,
                 lane, carry + 8 * (slot ^ 1));
PACK  }
}

'''

# The two-MCU pack (variant "two"), in place of the kernel's pack loop.
TWO_PACK = '''    const unsigned phase = (unsigned)(m0 % interval);
    uint32_t* buf2 = reinterpret_cast<uint32_t*>(px) + warp * K::kMcuWords;
    for (int w = lane; w < K::kMcuWords; w += 32) buf2[w] = 0;
    __syncwarp();
    for (int j = warp; j < kTile; j += 2 * kWarps) {
      const long long m = m0 + j;
      if (m >= n_mcu) break;
      const int j2 = j + kWarps;
      const bool two = j2 < kTile && m0 + j2 < n_mcu;
      auto load = [&](int k, int bi, int& a, int& b, int& bcls, int& dcd) {
        const int jj = k ? j2 : j;
        const int16_t* row = coef + jj * F::kCoefStride;
        const bool reset = (phase + jj) % interval == 0;
        const uint32_t pair =
            reinterpret_cast<const uint32_t*>(row + 64 * bi)[lane];
        a = (int)(int16_t)(pair & 0xFFFF);
        b = (int)pair >> 16;
        bcls = bi >= kLuma;
        const bool same = bi > 0 && bi < kLuma;
        const int pb = same ? bi - 1 : bi == 0 ? kLuma - 1 : bi;
        int pred = 0;
        if (same)
          pred = row[64 * pb];
        else if (!reset)
          pred = jj ? row[64 * pb - F::kCoefStride] : cur[pb];
        dcd = row[64 * bi] - pred;
      };
      constexpr int kN = 2 * kG;
      int a[kN], b[kN], bcls[kN], dcd[kN];
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        a[u] = b[u] = bcls[u] = dcd[u] = 0;
        if (u < kG || two) load(u / kG, u % kG, a[u], b[u], bcls[u], dcd[u]);
      }
      unsigned long long run[kN];
      int where[kN], total[kN];
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        run[u] = 0;
        where[u] = total[u] = 0;
        if (u < kG || two) {
          int len;
          jt::pair_run(a[u], b[u], bcls[u], dcd[u], lut, lane, &run[u],
                       &len);
          const int ex = jt::warp_exclusive_scan(len, lane);
          where[u] = (ex << 8) | len;
          total[u] = __shfl_sync(0xffffffffu, ex + len, 31);
        }
      }
      int base = 0, base2 = 0;
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const int len = where[u] & 255;
        if (u < kG) {
          if (len) jt::put_run(buf, base + (where[u] >> 8), run[u], len);
          base += total[u];
        } else {
          if (len) jt::put_run(buf2, base2 + (where[u] >> 8), run[u], len);
          base2 += total[u];
        }
      }
      jt::store_mcu(buf, mwords + m * K::kMcuWords, mlens + m, base, lane);
      if (two)
        jt::store_mcu(buf2, mwords + (m + kWarps) * K::kMcuWords,
                      mlens + m + kWarps, base2, lane);
    }
'''


def variants() -> dict:
    """name -> the variant's source of fused_px_bp.cu."""
    src = (ROOT / KERNEL).read_text()
    start = src.index("  const long long t0 = (long long)blockIdx.x")
    end = src.index("template <int kMh, int kMw, int kTile>\nint launch(")
    p0 = src.index("    const unsigned phase = (unsigned)(m0 % interval);")
    p1 = src.index("    __syncthreads();            // the next tile is")
    pack = src[p0:p1]
    if "cur[pb]" not in pack:
        raise ValueError(f"{KERNEL}: the pack loop is not where expected")
    head, tail = src[:start], src[end:]
    first = FIRST.replace("    PRODUCT\n", "    " + PRODUCT + "\n")
    out = {"final": src,
           "first": head + first.replace("PACK", pack) + tail,
           "nopack": head + first.replace(
               "PACK", pack.replace("    for (int j = warp; j < kTile;",
                                    "    if (m0 >= 0) continue;\n"
                                    "    for (int j = warp; j < kTile;"))
           + tail,
           "noprod": head + first.replace(
               "    " + PRODUCT, "    if (tile == t0)\n      " + PRODUCT)
           .replace("PACK", pack) + tail,
           "halo": head + HALO.replace("PACK", pack) + tail,
           "two": (head + first.replace("PACK", TWO_PACK) + tail).replace(
               '  static_assert(kSmemBytes <= 232448, "shared memory");',
               '  static_assert(kSmemBytes <= 232448, "shared memory");\n'
               '  static_assert(kWarps * kMcuWords * 4 <= F::kTileBytes, '
               '"rows in px");')}
    return out


def write(name: str, source: str) -> Path:
    """A copy of the package under OUT/name with this kernel source, built
    from fused_px_bp.cu alone."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "jpegtpu_torch", d / "jpegtpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", d / "chip_smoke.py")
    (d / KERNEL).write_text(source)
    b = d / "jpegtpu_torch/kernels/_build.py"
    b.write_text(re.sub(r"SOURCES = \([^)]*\)",
                        'SOURCES = ("fused_px_bp.cu",)', b.read_text()))
    return d


def child(build_only: bool) -> None:
    """In a variant's copy: build (print ptxas), or check and time."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from jpegtpu_torch.core import ops
    from jpegtpu_torch.encoder import EncoderTables
    from jpegtpu_torch.kernels import _build, fused_pipeline

    name = Path.cwd().name
    if build_only:
        _build.build()
        log = _build.library_path().with_suffix(".log").read_text()
        for k, props in cs.ptxas_entries(log, ("fused_px_bp_kernel",)):
            print(f"[ptxas] {name} {k}: {props}")
        return
    dev = torch.device("cuda")
    img = cs.bench_image()
    x = torch.from_numpy(img).to(dev)
    out = {"variant": name, "card": cs.card_line()}
    for sub, ri in (("420", "rows"), ("420", 0), ("420", 7), ("422", "rows"),
                    ("444", "rows")):
        t = EncoderTables.for_quality(cs.QUALITY, sub, dev)
        r = ops.mcu_grid(*img.shape[:2], sub)[1] if ri == "rows" else ri
        fw, fl = fused_pipeline.fused_pixel_block_pack_pairs(x, t, sub, r)
        fw_p, fl_p = fused_pipeline.fused_pixel_block_pack_pairs_plain(
            x, t, sub, r)
        j = torch.arange(fw.shape[1], device=dev)[None, :]
        valid = torch.clamp(fl_p.to(torch.int64)[:, None] - 32 * j, 0, 32)
        mask = (0xFFFFFFFF << (32 - valid)) & 0xFFFFFFFF
        out[f"mismatches {sub} {ri}"] = int((fl != fl_p).sum()) + int(
            (((fw.to(torch.int64) & 0xFFFFFFFF) & mask) !=
             ((fw_p.to(torch.int64) & 0xFFFFFFFF) & mask)).sum())
        if ri == "rows":
            out[f"ms {sub}"] = cs.kernel_device_ms(
                lambda: fused_pipeline.fused_pixel_block_pack_pairs(
                    x, t, sub, r), "fused_px_bp_kernel", reps=20)
    print(json.dumps(out), flush=True)


def main(names) -> int:
    srcs = variants()
    names = names or list(srcs)
    dirs = {n: write(n, srcs[n]) for n in names}
    builds = {n: subprocess.Popen([sys.executable, __file__, "--build"],
                                  cwd=d, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for n, d in dirs.items()}
    built = []
    for n, p in builds.items():
        log = p.communicate()[0]
        print(log.strip() if p.returncode == 0 else log[-4000:], flush=True)
        if p.returncode == 0:
            built.append(n)
        else:
            print(f"[build] {n} failed")
    for n in built + built[::-1]:
        r = subprocess.run([sys.executable, __file__, "--run"], cwd=dirs[n],
                           capture_output=True, text=True)
        print(r.stdout.strip() or r.stderr[-2000:], flush=True)
    return 0 if len(built) == len(names) else 1


if __name__ == "__main__":
    if sys.argv[1:2] in (["--build"], ["--run"]):
        child(sys.argv[1] == "--build")
    else:
        sys.exit(main(sys.argv[1:]))
