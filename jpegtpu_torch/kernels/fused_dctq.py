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
operator expresses). ``encode_blocks_pairs`` is the fused product: on a
CUDA tensor it launches the hand-written kernel ``csrc/pixel.cu`` (the
port of ``_pixel_kernel_nat``); on a CPU tensor it runs the plain twin
``encode_blocks_pairs_plain``.

The product accumulates in float64. jpegtpu's f32 product on CPU and an f32
product summed in any other order disagree on a few coefficients that sit
near x.5; products of u8 pixels and f32 operator entries are exact in
float64, and the float64 sum matched jpegtpu on every image tried.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from jpegtpu_torch.core import ops, tables
from jpegtpu_torch.kernels import _build

PIXEL = _build.Kernel("jt_pixel", [
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # img, m, bias, out
    _build.I64, _build.I64, _build.I64,               # n_mcu, nrx, row_bytes
    _build.I32, _build.I32])                          # MCU height, width


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


def mcu_tiles(img: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """[H, W, C] (padded) -> [nMCU, mh*mw*C], MCUs in raster order."""
    h, w, ch = img.shape
    x = img.reshape(h // mh, mh, w // mw, mw, ch).transpose(1, 2)
    return x.reshape((h // mh) * (w // mw), mh * mw * ch)


def encode_blocks_pairs_plain(img: torch.Tensor, m: torch.Tensor,
                              bias: torch.Tensor,
                              subsampling: str = "420") -> torch.Tensor:
    """Plain twin of the pixel kernel: u8 [H, W, 3] -> int32 [nMCU, B*64]
    (block-major columns: block i's zigzag slots at [64i, 64i+64))."""
    mh, mw, _, _ = fused_geometry(subsampling)
    padded = ops.pad_to_multiple(img, (mh, mw))
    x = mcu_tiles(padded, mh, mw).to(torch.float64)
    y = x @ m.to(torch.float64) + bias.to(torch.float64)
    return ops.round_half_away(y).to(torch.int32)


def encode_blocks_pairs(img: torch.Tensor, m: torch.Tensor,
                        bias: torch.Tensor,
                        subsampling: str = "420") -> torch.Tensor:
    """u8 RGB [H, W, 3] -> int32 [nMCU, B*64] quantized zigzag coefficients
    of the MCUs of a fused mode, in raster MCU order, with ``m``/``bias``
    that mode's ``mcu_operator``. Launches ``csrc/pixel.cu`` on a CUDA
    tensor; runs the plain twin on a CPU tensor."""
    if img.dtype != torch.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {img.dtype} "
                         f"{tuple(img.shape)}")
    mh, mw, n_in, n_out = fused_geometry(subsampling)
    if tuple(m.shape) != (n_in, n_out) or tuple(bias.shape) != (n_out,):
        raise ValueError(f"{subsampling} operator must be [{n_in}, {n_out}] "
                         f"+ [{n_out}], got {tuple(m.shape)}, "
                         f"{tuple(bias.shape)}")
    if img.device.type == "cpu":
        return encode_blocks_pairs_plain(img, m, bias, subsampling)
    padded = ops.pad_to_multiple(img, (mh, mw)).contiguous()
    m = m.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    _build.check_cuda(padded, m, bias)
    h, w, _ = padded.shape
    nrx = w // mw
    n_mcu = (h // mh) * nrx
    out = torch.empty((n_mcu, n_out), dtype=torch.int32,
                      device=padded.device)
    PIXEL.launch(padded.data_ptr(), m.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), n_mcu, nrx, w * 3, mh, mw)
    return out


def encode_blocks(img: torch.Tensor, tables, subsampling: str) -> torch.Tensor:
    """u8 [H, W, 3] (gray: [H, W]) -> int32 [nMCU, B*64] coefficients in
    scan order, by the fused product where jpegtpu takes it and by the
    staged ops elsewhere. ``tables`` is an ``EncoderTables`` of this mode."""
    h, w = img.shape[0], img.shape[1]
    if uses_fused(h, w, subsampling):
        return encode_blocks_pairs(img, tables.m, tables.bias, subsampling)
    c = ops.encode_blocks(img, tables.block_m, tables.block_bias,
                          subsampling)
    return c.reshape(c.shape[0], -1)
