"""Fused pixel path: raw RGB MCU -> quantized zigzag coefficients in one
affine map (counterpart of ``jpegtpu.kernels.fused_dctq``).

CSC, 2x2 chroma averaging, level shift, 8x8 DCT, quantization and zigzag are
all linear in the pixels, so one MCU maps to its blocks' zigzag
coefficients as ``round_half_away(tiles @ M + bias)`` with ``M`` from
``mcu_operator``: 768 -> 384 for 4:2:0, 384 -> 256 for 4:2:2, 192 -> 192
for 4:4:4 and 4:4:4s (whose operator folds the 2x2 chroma smoothing in).

``encode_blocks`` dispatches as jpegtpu does (``fused_dctq.py:445-452,
514-531``): the fused product for 4:2:0, 4:2:2, 4:4:4 and 8-aligned 4:4:4s,
the staged ops of ``jpegtpu_torch.core.ops`` for gray and for 4:4:4s of
another size (smoothing comes before padding there, which no per-MCU
operator expresses); ``encode_blocks_batch`` codes a batch of images in
one call, by the route that ``pixel_path`` names (jpegtpu's
``encoder._pixel_path_pairs``). The fused product has four hand kernels
and one library route, each the counterpart of one jpegtpu function:

    encode_blocks_pairs           csrc/pixel_mma.cu jt_pixel (K1,
                                  _pixel_kernel_nat); "nat"
    encode_blocks_pairs(with_dc)  csrc/pixel_mma.cu jt_pixel_dc (K12,
                                  _pixel_kernel_nat_dc), the DC plane too;
                                  "nat" when ``PIXEL_DC`` is set
    encode_blocks_i8_pairs        csrc/pixel_mma.cu jt_pixel_i8 (K13,
                                  _pixel_kernel, encode_blocks_pallas_pairs)
    encode_blocks_dma_pairs       csrc/pixel_dma.cu (K14, _pixel_kernel_dma,
                                  encode_blocks_pallas_dma_pairs); "dma"
    encode_blocks_matmul_pairs    float64 torch.matmul (jpegtpu's XLA
                                  encode_blocks_pairs); "xla"

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain twin (``encode_blocks_pairs_plain``, ``dc_plane``,
``pixel_i8_plain``). K13 and K14 exist for 4:2:0 alone, as in jpegtpu;
their wrappers give the other modes to the "xla" route, as jpegtpu's do.

K1, K12, K13 and K14 multiply by the operator's two factors
(``factor_operator``): one luma block's operator lum [192, 64], the same
for every luma block, and chroma [G*3, 128] over the exact integer sums of
the chroma groups, on the float64 tensor cores; K1, K12 and K13 are one
kernel body (K12 adds the DC plane to its epilogue, K13 XORs the int8
view back to u8 as it stages it), and the fused K11 (``fused_pipeline``)
runs the same staging and product into a shared int16 tile.
``encode_blocks_factored_plain`` is the factored arithmetic in torch.
Where an image's height is not whole MCUs (1080 rows at 4:2:0) but its
width is, K1 and K12 on the "nat" route read the unpadded image or batch
and mirror the last MCU row's missing rows as they stage it
(``row_fold``); every other route and shape, and the twins, pad first
(``pad_mcus``, a gather). ``PADS`` counts the two. The encoder's routes
take the factors its ``EncoderTables`` made (``kernel_factors``); the
wrappers of jpegtpu's signature (img, m, bias) factor the operator they
are given (``cuda_factors``). An operator that does not factor raises.

The product accumulates in float64. jpegtpu's f32 product on CPU and an f32
product summed in any other order disagree on a few coefficients that sit
near x.5; products of u8 pixels and f32 operator entries are exact in
float64, and ``factor_operator`` checks that every column's sum is exact
in float64 in any order (``operator_bits``), so the dense twin, the
factored form and every kernel give the same integers.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import weakref
from typing import Tuple

import numpy as np
import torch

from jpegtpu_torch.config import PIXEL_PATHS
from jpegtpu_torch.core import ops, tables
from jpegtpu_torch.kernels import _build

PIXEL = _build.Kernel("jt_pixel", [
    _build.PTR, _build.PTR, _build.PTR,               # img, lum, chroma
    _build.PTR, _build.PTR,                           # bias, out
    _build.I64, _build.I64, _build.I64,               # n_mcu, nrx, row_bytes
    _build.I64, _build.I64,                           # image rows h, my
    _build.I32, _build.I32, _build.I32])              # MCU h, w, groups
PIXEL_DC_PLANE = _build.Kernel("jt_pixel_dc", [
    _build.PTR, _build.PTR, _build.PTR,               # img, lum, chroma
    _build.PTR, _build.PTR, _build.PTR,               # bias, out, dc
    _build.I64, _build.I64, _build.I64,               # n_mcu, nrx, row_bytes
    _build.I64, _build.I64,                           # image rows h, my
    _build.I32, _build.I32, _build.I32])              # MCU h, w, groups
PIXEL_I8 = _build.Kernel("jt_pixel_i8", [
    _build.PTR, _build.PTR, _build.PTR,               # img (i8), lum, chroma
    _build.PTR, _build.PTR,                           # bias, out
    _build.I64, _build.I64, _build.I64])              # n_mcu, nrx, row_bytes
PIXEL_DMA = _build.Kernel("jt_pixel_dma", [
    _build.PTR, _build.PTR, _build.PTR,               # img, lum, chroma
    _build.PTR, _build.PTR,                           # bias, out
    _build.I64, _build.I64, _build.I64])              # n_mcu, nrx, row_bytes

# Take the DC plane from the DC-plane kernel on the "nat" route (jpegtpu's
# _PIXEL_DC, read from the same variable at import, fused_dctq.py:354).
PIXEL_DC = os.environ.get("JPEGTPU_PIXEL_DC", "0") != "0"
DC_LANES = 8                                          # lanes of a DC row
INT16_MAX = 32767


@dataclasses.dataclass
class PadCounts:
    """How the pixel routes met images whose sides are not whole MCUs:
    ``folds`` counts the launches of K1 or K12 that read each image's
    mirrored last MCU row themselves (``row_fold``), ``gathers`` the pads
    that made a padded copy by ``ops.pad_to_multiple``'s gather
    (``pad_mcus``). A run sets both to 0 before the work it checks and
    reads them after, as it does ``_build.Kernel.launches``."""
    folds: int = 0
    gathers: int = 0


PADS = PadCounts()


def fused_geometry(subsampling: str) -> Tuple[int, int, int, int]:
    """(MCU height, MCU width, operator inputs, operator outputs) of a
    fused mode."""
    if subsampling not in ("420", "422", "444", "444s"):
        raise ValueError(f"unsupported fused subsampling {subsampling!r}")
    mh, mw = ops.mcu_shape(subsampling)
    n_blocks = {"420": 6, "422": 4}.get(subsampling, 3)
    return mh, mw, mh * mw * 3, n_blocks * 64


def uses_fused(h: int, w: int, subsampling: str) -> bool:
    """Whether an h x w image takes the fused product (else the staged
    ops): gray never does, 4:4:4s only when h and w are multiples of 8."""
    if subsampling == "gray":
        return False
    return subsampling != "444s" or not (h % 8 or w % 8)


def row_fold(h: int, w: int, subsampling: str) -> bool:
    """Whether K1 and K12 read an h x w image of a fused mode unpadded,
    mirroring its last MCU row's missing rows themselves: where h is not
    whole MCUs, w is, and the pad is shorter than h (numpy's symmetric
    mirror; ``ops.pad_to_multiple`` takes ``edge`` otherwise). Every other
    shape, and every other route, is padded by ``pad_mcus``."""
    mh, mw = ops.mcu_shape(subsampling)
    ph = (-h) % mh
    return ph != 0 and w % mw == 0 and ph < h


def pad_mcus(img: torch.Tensor, subsampling: str) -> torch.Tensor:
    """``ops.pad_to_multiple`` of [..., H, W, C] to whole MCUs of a mode,
    counting in ``PADS.gathers`` the pads that gather a copy."""
    mh, mw = ops.mcu_shape(subsampling)
    if img.shape[-3] % mh or img.shape[-2] % mw:
        PADS.gathers += 1
    return ops.pad_to_multiple(img, (mh, mw))


@functools.lru_cache(maxsize=32)
def mcu_operator(quality: int, subsampling: str) -> Tuple[np.ndarray, np.ndarray]:
    """(M [in_dim, out_dim] f32, bias [out_dim] f32); a numpy copy of
    ``jpegtpu.kernels.fused_dctq.mcu_operator`` (pinned by the tests).

    Input layout: MCU pixels row-major (y, x, c) flattened. Output layout:
    scan-order blocks x 64 zigzag coefficients (420: Y00,Y01,Y10,Y11,Cb,Cr;
    444: Y,Cb,Cr).
    """
    if subsampling == "420":
        (mh, mw), n_luma = (16, 16), 4
    elif subsampling == "422":
        (mh, mw), n_luma = (8, 16), 2
    elif subsampling in ("444", "444s"):
        # 444s: in-operator 2x2 chroma smoothing, valid only for 8-aligned
        # images (see jpegtpu.kernels.fused_dctq.mcu_operator).
        (mh, mw), n_luma = (8, 8), 1
    else:
        raise ValueError(f"unsupported fused subsampling {subsampling!r}")
    in_dim = mh * mw * 3
    out_dim = (n_luma + 2) * 64

    m_l, b_l = tables.fused_block_operator(quality, chroma=False)
    m_c, _ = tables.fused_block_operator(quality, chroma=True)
    m_l = m_l.astype(np.float64)
    m_c = m_c.astype(np.float64)
    w = tables.CSC_MATRIX.astype(np.float64)      # [rgb_c, ycc_c]

    big = np.zeros((in_dim, out_dim), np.float64)
    bias = np.zeros(out_dim, np.float64)

    ys, xs = np.mgrid[0:mh, 0:mw]
    for c in range(3):
        pix = (ys * mw + xs) * 3 + c              # input index per (y, x)
        # Luma blocks: passthrough samples, raster order within the MCU.
        for blk in range(n_luma):
            by, bx = divmod(blk, mw // 8)
            sel = (slice(by * 8, by * 8 + 8), slice(bx * 8, bx * 8 + 8))
            samp = (ys[sel] % 8) * 8 + (xs[sel] % 8)
            big[pix[sel].ravel(), blk * 64:(blk + 1) * 64] += \
                w[c, 0] * m_l[samp.ravel(), :]
        # Chroma blocks: (possibly averaged) samples. The +128 chroma offset
        # cancels the -128 level shift exactly, so no bias term.
        if subsampling == "420":
            m_sel = m_c[((ys // 2) * 8 + (xs // 2)).ravel(), :]
            scale = 0.25
        elif subsampling == "422":
            m_sel = m_c[(ys * 8 + (xs // 2)).ravel(), :]
            scale = 0.5
        elif subsampling == "444s":
            by, bx = (ys // 2) * 2, (xs // 2) * 2
            m_sel = sum(
                m_c[((by + dy) * 8 + (bx + dx)).ravel(), :]
                for dy in (0, 1) for dx in (0, 1))
            scale = 0.25
        else:
            m_sel = m_c[(ys * 8 + xs).ravel(), :]
            scale = 1.0
        for comp, col in ((1, n_luma), (2, n_luma + 1)):
            big[pix.ravel(), col * 64:(col + 1) * 64] += \
                scale * w[c, comp] * m_sel

    for blk in range(n_luma):
        bias[blk * 64:(blk + 1) * 64] = b_l
    return big.astype(np.float32), bias.astype(np.float32)


def chroma_groups(subsampling: str) -> Tuple[int, int, int]:
    """(G, gy, gx): the chroma groups of a fused mode's MCU, each gy x gx
    pixels over which every chroma column of ``mcu_operator`` weighs the
    pixels of one channel equally (the pixels one chroma sample covers;
    4:4:4s's in-operator 2x2 smoothing makes its groups 2x2 as well)."""
    gy, gx = {"420": (2, 2), "422": (1, 2), "444": (1, 1),
              "444s": (2, 2)}[subsampling]
    mh, mw = ops.mcu_shape(subsampling)
    return (mh // gy) * (mw // gx), gy, gx


def _operator_array(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    return np.ascontiguousarray(a, dtype=np.float32)


def expand_factors(lum: np.ndarray, chroma: np.ndarray,
                   subsampling: str) -> np.ndarray:
    """The dense [in, out] f32 operator whose factors are lum and chroma
    (the inverse of ``factor_operator``)."""
    mh, mw, _, n_out = fused_geometry(subsampling)
    _, gy, gx = chroma_groups(subsampling)
    n_luma = n_out // 64 - 2
    ys, xs, cs = np.meshgrid(np.arange(mh), np.arange(mw), np.arange(3),
                             indexing="ij")
    big = np.zeros((mh, mw, 3, n_out), np.float32)
    blk = (ys // 8) * (mw // 8) + xs // 8
    lum_rows = lum[((ys % 8) * 8 + xs % 8) * 3 + cs]       # [mh, mw, 3, 64]
    for b in range(n_luma):
        big[..., b * 64:(b + 1) * 64] = np.where((blk == b)[..., None],
                                                 lum_rows, 0)
    grp = ((ys // gy) * (mw // gx) + xs // gx) * 3 + cs
    big[..., n_luma * 64:] = chroma[grp]
    return big.reshape(mh * mw * 3, n_out)


def _weights_and_bias(m, bias=None) -> Tuple[np.ndarray, np.ndarray]:
    w = _operator_array(m)
    b = np.zeros(w.shape[1], np.float32) if bias is None else \
        _operator_array(bias)
    return w, b


def _column_bounds(w: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per column, the magnitude bound ``255 * sum|w| + |bias|`` of its sum
    over u8 pixels, summed in float64 and raised by 2**-40 (far above that
    sum's rounding error), so it never comes out low."""
    return (255.0 * np.abs(w.astype(np.float64)).sum(axis=0) +
            np.abs(b.astype(np.float64))) * (1 + 2.0 ** -40)


def operator_bits(m, bias=None) -> np.ndarray:
    """Per output column of an operator [in, out] f32 (with its bias): how
    many bits lie between the finest bit set in any nonzero weight or the
    bias and the magnitude bound of the column's sum over u8 pixels
    (``_column_bounds``). Every partial sum of such a column, in any order
    and any association, is a multiple of that finest bit no larger than
    the bound, so it is exact in float64 (53 bits) where this is <= 53."""
    w, b = _weights_and_bias(m, bias)
    vals = np.concatenate([w, b[None, :]], axis=0)
    bits = vals.view(np.uint32) & 0x7FFFFFFF
    exp = (bits >> 23).astype(np.int64)
    mant = ((bits & 0x7FFFFF) | np.where(exp > 0, 1 << 23, 0)).astype(
        np.int64)
    low = np.frexp((mant & -mant).astype(np.float64))[1] - 1   # ctz(mant)
    finest = np.where(mant != 0, np.maximum(exp, 1) - 150 + low,
                      np.iinfo(np.int64).max).min(axis=0)
    bound = _column_bounds(w, b)
    top = np.ceil(np.log2(np.where(bound > 0, bound, 1.0))).astype(np.int64)
    return np.where(bound > 0, top - finest, 0)


def coefficient_bound(m, bias=None) -> float:
    """The largest magnitude a coefficient of the operator m [in, out] f32
    with bias can take over u8 pixels, before rounding: the widest
    column's bound (``_column_bounds``). Every rounded coefficient fits in
    int16 where this is at most ``INT16_MAX`` (3,064.00 for every fused
    mode at every quality 1-100)."""
    return float(_column_bounds(*_weights_and_bias(m, bias)).max())


def factor_operator(m, subsampling: str, bias=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(lum [192, 64] f32, chroma [G*3, 128] f32): the factors of a fused
    mode's ``mcu_operator`` m [in, out] (numpy or a CPU tensor) that the
    pixel kernels multiply by.

    lum is the operator of one luma block, rows its in-block pixels (y, x,
    c) row-major: every luma block of the MCU has the same one and is zero
    outside its block. chroma holds the Cb then the Cr columns, rows the
    chroma groups (gy, gx, c) of ``chroma_groups``: each chroma column
    weighs a group's pixels equally, so it reads the exact integer sum of
    the group once. Raises ValueError, naming the mode, unless m is
    bitwise the expansion of the two, or unless every column (with its
    bias, when given) is exact in float64 in any order (``operator_bits``
    <= 53): nothing goes back to the dense product."""
    mh, mw, n_in, n_out = fused_geometry(subsampling)
    m = _operator_array(m)
    if m.shape != (n_in, n_out):
        raise ValueError(f"{subsampling} operator must be [{n_in}, {n_out}]"
                         f", got {list(m.shape)}")
    g, gy, gx = chroma_groups(subsampling)
    n_luma = n_out // 64 - 2
    pix = m.reshape(mh, mw, 3, n_out)
    lum = np.ascontiguousarray(pix[:8, :8, :, :64].reshape(192, 64))
    chroma = np.ascontiguousarray(
        pix[::gy, ::gx, :, n_luma * 64:].reshape(g * 3, 128))
    dense = expand_factors(lum, chroma, subsampling)
    if not np.array_equal(dense.view(np.uint32), m.view(np.uint32)):
        raise ValueError(f"the {subsampling} operator is not the expansion "
                         f"of one luma block operator and {gy}x{gx} chroma "
                         f"groups")
    wide = int(operator_bits(m, bias).max())
    if wide > 53:
        raise ValueError(f"the {subsampling} operator has a column {wide} "
                         f"bits wide: its float64 sum would not be exact")
    return lum, chroma


# (id of an operator, mode) -> weak references to the operator and its
# bias, their version counters, which prove the entry is still those
# tensors, unmodified, and the factors; the entry goes when either tensor
# does. The memo of ``cuda_factors``, for the wrappers of jpegtpu's
# signature (img, m, bias, subsampling), which has no place for factors.
_FACTORS: dict = {}


def cuda_factors(m: torch.Tensor, bias: torch.Tensor, subsampling: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The factors of the operator m with bias as f32 tensors on m's
    device: ``factor_operator`` of host copies of the two (a device sync)
    on the first call, from the memo while neither is modified."""
    key = (id(m), subsampling)
    hit = _FACTORS.get(key)
    if (hit is not None and hit[0]() is m and hit[1] == m._version
            and hit[2]() is bias and hit[3] == bias._version):
        return hit[4:]
    lum, chroma = (torch.from_numpy(a).to(m.device)
                   for a in factor_operator(m, subsampling, bias))

    def drop(_):
        # At interpreter exit the module's globals may already be cleared
        # (set to None) when the last tensors die: nothing is left to drop.
        factors = globals().get("_FACTORS")
        if factors is not None and factors.get(key) is entry:
            del factors[key]

    entry = (weakref.ref(m, drop), m._version, weakref.ref(bias, drop),
             bias._version, lum, chroma)
    _FACTORS[key] = entry
    return lum, chroma


def kernel_factors(tables, subsampling: str
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lum, chroma, bias) f32 of an ``EncoderTables``, made with it, as
    the factored kernels read them; ValueError unless they are this mode's
    (4:4:4s's operator has 4:4:4's shape, not its factors)."""
    if tables.subsampling != subsampling:
        raise ValueError(f"the {subsampling} kernels need {subsampling} "
                         f"factors, the tables hold {tables.subsampling}'s")
    return tuple(t.to(torch.float32)
                 for t in (tables.lum, tables.chroma, tables.bias))


def _operator_factors(m: torch.Tensor, bias: torch.Tensor, subsampling: str
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``kernel_factors`` of an operator and its bias (``cuda_factors``)."""
    bias = bias.to(torch.float32).contiguous()
    return (*cuda_factors(m, bias, subsampling), bias)


def mcu_tiles(img: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """[H, W, C] (padded) -> [nMCU, mh*mw*C], MCUs in raster order."""
    h, w, ch = img.shape
    x = img.reshape(h // mh, mh, w // mw, mw, ch).transpose(1, 2)
    return x.reshape((h // mh) * (w // mw), mh * mw * ch)


def _tile_product(padded: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
                  mh: int, mw: int) -> torch.Tensor:
    """MCU tile gather of a padded image, float64 product, round half
    away: int32 [nMCU, B*64]."""
    x = mcu_tiles(padded, mh, mw).to(torch.float64)
    y = x @ m.to(torch.float64) + bias.to(torch.float64)
    return ops.round_half_away(y).to(torch.int32)


def encode_blocks_pairs_plain(img: torch.Tensor, m: torch.Tensor,
                              bias: torch.Tensor,
                              subsampling: str = "420") -> torch.Tensor:
    """Plain twin of the pixel kernels (K1, and K14 on 4:2:0): u8
    [H, W, 3] -> int32 [nMCU, B*64] (block-major columns: block i's zigzag
    slots at [64i, 64i+64))."""
    mh, mw, _, _ = fused_geometry(subsampling)
    return _tile_product(pad_mcus(img, subsampling), m, bias, mh, mw)


def encode_blocks_factored_plain(img: torch.Tensor, lum: torch.Tensor,
                                 chroma: torch.Tensor, bias: torch.Tensor,
                                 subsampling: str = "420") -> torch.Tensor:
    """The factored product in torch, the arithmetic of K1, K12, K13 and
    K14: u8 [H, W, 3] and the factors of ``factor_operator`` -> int32
    [nMCU, B*64], equal to ``encode_blocks_pairs_plain`` of the operator
    they factor.
    Each luma block's 192 pixels times lum, each MCU's chroma group sums
    times chroma, in float64, plus the bias, rounded half away."""
    mh, mw, _, _ = fused_geometry(subsampling)
    g, gy, gx = chroma_groups(subsampling)
    x = mcu_tiles(pad_mcus(img, subsampling), mh, mw).to(torch.int64)
    n = x.shape[0]
    luma = x.reshape(n, mh // 8, 8, mw // 8, 8, 3).permute(0, 1, 3, 2, 4, 5)
    sums = x.reshape(n, mh // gy, gy, mw // gx, gx, 3).sum(dim=(2, 4))
    y = torch.cat([
        (luma.reshape(-1, 192).to(torch.float64) @ lum.to(torch.float64)
         ).reshape(n, -1),
        sums.reshape(n, g * 3).to(torch.float64) @ chroma.to(torch.float64)],
        dim=1) + bias.to(torch.float64)
    return ops.round_half_away(y).to(torch.int32)


def dc_plane(coeffs: torch.Tensor) -> torch.Tensor:
    """Plain twin of the DC plane: int32 [nMCU, DC_LANES], lane k the DC
    coefficient of block k (column 64k), lanes B..7 zero."""
    dc = coeffs.new_zeros((coeffs.shape[0], DC_LANES))
    dc[:, :coeffs.shape[1] // 64] = coeffs[:, ::64]
    return dc


def operand_geometry(img: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
                     subsampling: str, lead: int = 0
                     ) -> Tuple[int, int, int, int]:
    """Raise unless img is u8 [H, W, 3] (lead 1: a batch [n, H, W, 3]) and
    m/bias are the operator of a fused mode; its fused_geometry."""
    if img.dtype != torch.uint8 or img.ndim != 3 + lead or img.shape[-1] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {img.dtype} "
                         f"{tuple(img.shape)}")
    mh, mw, n_in, n_out = fused_geometry(subsampling)
    if tuple(m.shape) != (n_in, n_out) or tuple(bias.shape) != (n_out,):
        raise ValueError(f"{subsampling} operator must be [{n_in}, {n_out}] "
                         f"+ [{n_out}], got {tuple(m.shape)}, "
                         f"{tuple(bias.shape)}")
    return mh, mw, n_in, n_out


def factored_sizes(mcu_rows: int, w: int, mw: int) -> Tuple[int, int, int]:
    """(n_mcu, nrx, row_bytes): the sizes every factored pixel kernel takes
    after its pointers, for mcu_rows MCU rows of a u8 [., w, 3] image of
    mw-wide MCUs."""
    return mcu_rows * (w // mw), w // mw, w * 3


def nat_view(h: int, subsampling: str) -> Tuple[int, ...]:
    """(h, my, mh, mw, groups): the sizes K1 and K12 take after
    ``factored_sizes`` for a tall view of images of h rows (whole MCUs, or
    a height ``row_fold`` takes), my MCU rows each, of a fused mode."""
    mh, mw, _, _ = fused_geometry(subsampling)
    return h, -(-h // mh), mh, mw, chroma_groups(subsampling)[0]


def _launch_factored(kernel, img, factors, subsampling, *extra,
                     with_dc=False, mcu_rows=None):
    """Launch K1, K12, K13 or K14 on factors (``kernel_factors``: lum,
    chroma, bias), img [H, W, 3] of a fused mode (u8, or K13's int8 view
    reshaped to it, the same bytes) contiguous at a 16-byte aligned address
    (the kernels' copies are 16 or 8 bytes): whole MCUs, H // mh MCU rows
    (K13, K14); or, for K1 and K12, the tall view of images of extra's h
    rows and my MCU rows each, whose MCU rows ``mcu_rows`` counts. int32
    [nMCU, B*64] out and, with_dc, the DC plane [nMCU, DC_LANES] (returns
    (out, dc))."""
    mh, mw, _, n_out = fused_geometry(subsampling)
    img = img.contiguous()
    _build.check_cuda(img, *factors)
    if img.data_ptr() % 16:
        img = img.clone()
    h, w, _ = img.shape
    sizes = factored_sizes(h // mh if mcu_rows is None else mcu_rows, w, mw)
    n_mcu = sizes[0]
    out = torch.empty((n_mcu, n_out), dtype=torch.int32, device=img.device)
    dc = [torch.empty((n_mcu, DC_LANES), dtype=torch.int32,
                      device=img.device)] if with_dc else []
    kernel.launch(img.device, img.data_ptr(),
                  *(f.data_ptr() for f in factors), out.data_ptr(),
                  *(d.data_ptr() for d in dc), *sizes, *extra)
    return (out, *dc) if with_dc else out


def _pixel_nat(imgs: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
               factors, subsampling: str, with_dc: bool):
    """The "nat" route on a checked batch u8 [n, H, W, 3] of a fused mode:
    image i's MCUs in rows [i * nMCU, (i + 1) * nMCU) (with_dc: and the DC
    plane). Where factors is None (a CPU tensor) the plain twin of m and
    bias on the batch padded to whole MCUs. On the card one launch of K1
    (with_dc: K12) on factors (``kernel_factors``) for the batch: where
    ``row_fold`` allows, on the unpadded batch viewed as [n * H, W, 3],
    the kernel reading each image's mirrored last MCU row itself
    (``PADS.folds``); else on the batch padded to whole MCUs
    (``pad_mcus``), viewed as one tall image."""
    n, h, w, _ = imgs.shape
    if factors is not None and row_fold(h, w, subsampling):
        PADS.folds += 1
    else:
        imgs = pad_mcus(imgs, subsampling)
    view = nat_view(imgs.shape[1], subsampling)
    x = imgs.reshape(n * view[0], imgs.shape[2], imgs.shape[3])
    if factors is None:
        y = encode_blocks_pairs_plain(x, m, bias, subsampling)
        return (y, dc_plane(y)) if with_dc else y
    return _launch_factored(PIXEL_DC_PLANE if with_dc else PIXEL, x, factors,
                            subsampling, *view, with_dc=with_dc,
                            mcu_rows=n * view[1])


def encode_blocks_pairs(img: torch.Tensor, m: torch.Tensor,
                        bias: torch.Tensor, subsampling: str = "420",
                        with_dc: bool = False):
    """u8 RGB [H, W, 3] -> int32 [nMCU, B*64] quantized zigzag coefficients
    of the MCUs of a fused mode, in raster MCU order, with ``m``/``bias``
    that mode's ``mcu_operator`` (jpegtpu's
    ``encode_blocks_pallas_nat_pairs``). Launches ``csrc/pixel_mma.cu``
    (``jt_pixel``, the factored product) on a CUDA tensor, on the unpadded
    image where ``row_fold`` allows; runs the plain twin on a CPU
    tensor.

    with_dc: return (coeffs, dc), dc [nMCU, DC_LANES] int32 with dc[:, k]
    = coeffs[:, 64k] and the lanes >= B zero, from one launch of the
    DC-plane kernel (``jt_pixel_dc``, the same product). jpegtpu gives no
    plane (None) when its kernel's lane rule refuses the width; the port
    has no such rule."""
    operand_geometry(img, m, bias, subsampling)
    factors = (None if img.device.type == "cpu"
               else _operator_factors(m, bias, subsampling))
    return _pixel_nat(img[None], m, bias, factors, subsampling, with_dc)


def encode_blocks_matmul_pairs(img: torch.Tensor, m: torch.Tensor,
                               bias: torch.Tensor,
                               subsampling: str = "420") -> torch.Tensor:
    """The "xla" route: u8 [H, W, 3] -> int32 [nMCU, B*64] by the MCU tile
    gather, one float64 ``torch.matmul`` and round half away, on the
    image's device. The counterpart of jpegtpu's ``encode_blocks_pairs``,
    which leaves this product to XLA outside any Pallas kernel, so it is a
    library call here by design and launches no hand kernel."""
    mh, mw, _, _ = operand_geometry(img, m, bias, subsampling)
    return _tile_product(pad_mcus(img, subsampling), m, bias, mh, mw)


def pixel_i8_plain(x8: torch.Tensor, m: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain twin of the i8-view kernel: the centred int8 view [rows, mh,
    nrx, row_bytes] of a padded image (x ^ 0x80, i.e. x - 128) -> int32
    [rows * nrx, B*64], each pixel restored exactly as int8 + 128.0."""
    rows, mh, nrx, rb = x8.shape
    x = x8.permute(0, 2, 1, 3).reshape(rows * nrx, mh * rb)
    y = (x.to(torch.float64) + 128.0) @ m.to(torch.float64) + \
        bias.to(torch.float64)
    return ops.round_half_away(y).to(torch.int32)


def i8_view(img: torch.Tensor) -> torch.Tensor:
    """The i8-view kernel's input: a u8 [H, W, 3] image padded to whole
    4:2:0 MCUs, XOR 0x80, viewed as int8 [rows, 16, nrx, 48] (a reshape
    of the padded image, jpegtpu's ``fused_dctq.py:216-217``)."""
    padded = pad_mcus(img, "420")
    h, w, _ = padded.shape
    x8 = torch.bitwise_xor(padded, 0x80).view(torch.int8)
    return x8.reshape(h // 16, 16, w // 16, 48)


def encode_blocks_i8_pairs(img: torch.Tensor, m: torch.Tensor,
                           bias: torch.Tensor,
                           subsampling: str = "420") -> torch.Tensor:
    """The counterpart of jpegtpu's ``encode_blocks_pallas_pairs``: u8
    [H, W, 3] -> int32 [nMCU, B*64]. For 4:2:0 the glue views the padded
    image XOR 0x80 as int8 [rows, 16, nrx, 48] (``fused_dctq.py:216-217``)
    and ``csrc/pixel_mma.cu`` (``jt_pixel_i8``, K1's factored product)
    XORs each byte back to u8 as it stages it on a CUDA tensor, the plain
    twin ``pixel_i8_plain`` restores + 128 on a CPU tensor; the other
    modes take the "xla" route (``encode_blocks_matmul_pairs``), as
    jpegtpu's ``:210-213`` takes its XLA path."""
    operand_geometry(img, m, bias, subsampling)
    if subsampling != "420":
        return encode_blocks_matmul_pairs(img, m, bias, subsampling)
    x8 = i8_view(img)
    if img.device.type == "cpu":
        return pixel_i8_plain(x8, m, bias)
    rows, _, nrx, _ = x8.shape
    return _launch_factored(PIXEL_I8, x8.reshape(rows * 16, nrx * 16, 3),
                            _operator_factors(m, bias, subsampling),
                            subsampling)


def encode_blocks_dma_pairs(img: torch.Tensor, m: torch.Tensor,
                            bias: torch.Tensor,
                            subsampling: str = "420") -> torch.Tensor:
    """The "dma" route, counterpart of jpegtpu's
    ``encode_blocks_pallas_dma_pairs``: u8 [H, W, 3] -> int32 [nMCU,
    B*64]. For 4:2:0 on a CUDA tensor ``csrc/pixel_dma.cu`` reads the
    padded u8 image where it lies, brings its tiles into shared memory by
    bulk copies and runs K1's factored product; on a CPU tensor the plain
    twin ``encode_blocks_pairs_plain`` (the same function of the same
    input) runs. The other modes take the "xla" route, as jpegtpu's
    ``:306-309`` takes its XLA path."""
    operand_geometry(img, m, bias, subsampling)
    if subsampling != "420":
        return encode_blocks_matmul_pairs(img, m, bias, subsampling)
    if img.device.type == "cpu":
        return encode_blocks_pairs_plain(img, m, bias, subsampling)
    return _launch_factored(PIXEL_DMA, pad_mcus(img, subsampling),
                            _operator_factors(m, bias, subsampling),
                            subsampling)


def encode_blocks(img: torch.Tensor, tables, subsampling: str) -> torch.Tensor:
    """u8 [H, W, 3] (gray: [H, W]) -> int32 [nMCU, B*64] coefficients in
    scan order, by the fused product where jpegtpu takes it and by the
    staged ops elsewhere. ``tables`` is an ``EncoderTables`` of this mode."""
    return encode_blocks_batch(img[None], tables, subsampling)


def encode_blocks_batch(imgs: torch.Tensor, tables, subsampling: str,
                        pixel_path: str = "nat", with_dc: bool = False):
    """u8 [n, H, W, 3] (gray: [n, H, W]) -> int32 [n * nMCU, B*64]: image
    i's MCUs in rows [i * nMCU, (i + 1) * nMCU), each image as
    ``encode_blocks`` codes it. For the fused product the batch is one
    launch of a pixel kernel, on the route ``pixel_path`` names ("nat",
    "dma" or "xla"; jpegtpu's ``_pixel_path_pairs``), over one tall image
    whose MCUs in raster order are image 0's, then image 1's, and so on.
    On the card, "nat" reads the unpadded batch [n * H, W, 3] where
    ``row_fold`` allows (K1 and K12 mirror each image's last MCU row
    themselves); otherwise, and on the other routes and a CPU tensor,
    each image is padded to whole MCUs (``pad_mcus``) and the batch viewed
    as [n * Hp, Wp, 3]. The staged ops take the batch axis as it is.

    with_dc: return (coeffs, dc), dc the DC plane of the DC-plane kernel on
    the fused "nat" route, None on the others (the caller slices
    coeffs[:, ::64] instead), as jpegtpu's ``with_dc``."""
    if pixel_path not in PIXEL_PATHS:
        raise ValueError(f"pixel_path must be 'nat', 'xla' or 'dma', "
                         f"got {pixel_path!r}")
    h, w = imgs.shape[1], imgs.shape[2]
    if uses_fused(h, w, subsampling):
        m, bias = tables.m, tables.bias
        mh, mw, _, _ = operand_geometry(imgs, m, bias, subsampling, 1)
        factors = (None if imgs.device.type == "cpu"
                   else kernel_factors(tables, subsampling))
        if pixel_path == "nat":
            return _pixel_nat(imgs, m, bias, factors, subsampling, with_dc)
        padded = pad_mcus(imgs, subsampling)
        x = padded.reshape(-1, *padded.shape[2:])
        if pixel_path == "dma" and subsampling == "420" and factors:
            y = _launch_factored(PIXEL_DMA, x, factors, subsampling)
        else:       # "xla", and "dma" where it is the same product
            y = _tile_product(x, m, bias, mh, mw)
        return (y, None) if with_dc else y
    if subsampling == "gray":
        imgs = imgs[..., None]          # [n, H, W, 1]: never read as RGB
    c = ops.encode_blocks(imgs, tables.block_m, tables.block_bias,
                          subsampling)
    c = c.reshape(-1, c.shape[-2] * 64)
    return (c, None) if with_dc else c
