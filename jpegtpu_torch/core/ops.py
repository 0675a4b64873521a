"""Pixel-path ops on torch tensors (counterparts of ``jpegtpu.core.ops``).

MCU geometry, the half-away rounding of the reference, jpegtpu's mirror
padding, and the staged pixel path that gray and non-8-aligned 4:4:4s take
instead of the fused product: color conversion, 2x2 chroma smoothing,
chroma downsampling, blocking, the per-block DCT/quantize/zigzag product and
the scan-order block interleave. jpegtpu computes these in XLA outside any
Pallas kernel, so they stay plain torch on every device.

Every value is float64 (jpegtpu's are float32): products of u8 pixels and
f32 constants are exact in float64, so the coefficients are the exact ones
to ~1e-13, as the fused path's are (ROADMAP.md, faults 3.1). The per-block
operator comes in as tensors (``block_m`` [2, 64, 64] and ``block_bias``
[2, 64], luma then chroma, from ``tables.fused_block_operator``).

The padding is built as an index gather because ``F.pad(mode="reflect")``
excludes the edge sample (``1,2,3 -> 1,2,3,2,1``) while jpegtpu pads
numpy-``symmetric`` (``1,2,3 -> 1,2,3,3,2``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from jpegtpu_torch.core import tables


def mcu_shape(subsampling: str) -> Tuple[int, int]:
    """(mcu_height, mcu_width) in pixels for a subsampling mode."""
    return {"420": (16, 16), "422": (8, 16)}.get(subsampling, (8, 8))


def mcu_grid(h: int, w: int, subsampling: str) -> Tuple[int, int]:
    """MCU grid (rows, cols) for an image of size h x w."""
    mh, mw = mcu_shape(subsampling)
    return -(-h // mh), -(-w // mw)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """std::round semantics (half away from zero), as jpegtpu rounds."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _pad_index(n: int, pad: int, symmetric: bool,
               device: torch.device) -> torch.Tensor:
    """Source index of each of the n + pad output positions along one axis:
    numpy's ``symmetric`` mirror (edge sample repeated) or ``edge``."""
    i = torch.arange(n + pad, device=device)
    if symmetric:
        return torch.where(i < n, i, 2 * n - 1 - i)
    return torch.clamp(i, max=n - 1)


def pad_to_multiple(img: torch.Tensor, multiple) -> torch.Tensor:
    """Mirror-pad H and W (axes -3, -2 of [..., H, W, C]) up to `multiple`
    (an int or an (mh, mw) pair), exactly as ``jpegtpu.core.ops`` does:
    numpy-``symmetric`` reflection, or ``edge`` when a pad is at least as
    long as its axis."""
    mh, mw = (multiple, multiple) if isinstance(multiple, int) else multiple
    h, w = img.shape[-3], img.shape[-2]
    ph = (-h) % mh
    pw = (-w) % mw
    if ph == 0 and pw == 0:
        return img
    symmetric = not (ph >= h or pw >= w)
    # Gather only along an axis that grows (a 1920x1080 batch pads its
    # rows alone).
    if ph:
        img = img.index_select(-3, _pad_index(h, ph, symmetric, img.device))
    if pw:
        img = img.index_select(-2, _pad_index(w, pw, symmetric, img.device))
    return img


def rgb_to_ycbcr(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] RGB -> float64 full-range BT.601 YCbCr,
    ``rgb @ CSC_MATRIX + CSC_OFFSET``."""
    csc = torch.from_numpy(tables.CSC_MATRIX).to(img.device, torch.float64)
    off = torch.from_numpy(tables.CSC_OFFSET).to(img.device, torch.float64)
    return img.to(torch.float64) @ csc + off


def smooth_chroma_2x2(ycc: torch.Tensor) -> torch.Tensor:
    """The reference's 4:4:4s chroma smoothing: Cb and Cr averaged over each
    2x2 quad and written back to all four pixels; an odd last row or column
    passes through untouched."""
    h, w = ycc.shape[-3], ycc.shape[-2]
    he, we = h - h % 2, w - w % 2
    c = ycc[..., :he, :we, 1:]
    c4 = c.reshape(*c.shape[:-3], he // 2, 2, we // 2, 2, 2)
    avg = c4.mean(dim=(-4, -2), keepdim=True)
    out = ycc.clone()
    out[..., :he, :we, 1:] = avg.expand(c4.shape).reshape(c.shape)
    return out


def downsample_chroma_422(ycc: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., H, W, 3] (W even) -> (Y, Cb, Cr), chroma averaged over 2x1."""
    c = ycc[..., 1:]
    w = c.shape[-2]
    cd = c.reshape(*c.shape[:-2], w // 2, 2, 2).mean(dim=-2)
    return ycc[..., 0], cd[..., 0], cd[..., 1]


def downsample_chroma_420(ycc: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., H, W, 3] (H, W even) -> (Y [..., H, W], Cb, Cr [..., H/2,
    W/2]), chroma averaged over 2x2."""
    c = ycc[..., 1:]
    h, w = c.shape[-3], c.shape[-2]
    cd = c.reshape(*c.shape[:-3], h // 2, 2, w // 2, 2, 2).mean(dim=(-4, -2))
    return ycc[..., 0], cd[..., 0], cd[..., 1]


def blockify(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H/8, W/8, 64] raster-order 8x8 blocks, row-major
    within each block."""
    *b, h, w = plane.shape
    x = plane.reshape(*b, h // 8, 8, w // 8, 8).transpose(-3, -2)
    return x.reshape(*b, h // 8, w // 8, 64)


def fused_dct_quant_zigzag(blocks: torch.Tensor, m: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """[..., 64] samples -> [..., 64] int32 quantized zigzag coefficients:
    level shift + DCT + quantization + zigzag as one affine map (``m``
    [64, 64], ``bias`` [64] of ``tables.fused_block_operator``)."""
    y = (blocks.to(torch.float64) @ m.to(torch.float64) +
         bias.to(torch.float64))
    return round_half_away(y).to(torch.int32)


def scan_blocks_444(y: torch.Tensor, cb: torch.Tensor,
                    cr: torch.Tensor) -> torch.Tensor:
    """Full-resolution planes [..., H, W] -> [..., nMCU, 3, 64], Y Cb Cr
    per 8x8 MCU."""
    stk = torch.stack([blockify(y), blockify(cb), blockify(cr)], dim=-2)
    *b, by, bx, s, _ = stk.shape
    return stk.reshape(*b, by * bx, s, 64)


def scan_blocks_422(y: torch.Tensor, cb: torch.Tensor,
                    cr: torch.Tensor) -> torch.Tensor:
    """Y [..., H, W], Cb/Cr [..., H, W/2] -> [..., nMCU, 4, 64], Y0 Y1 Cb
    Cr per 8x16 MCU."""
    yb = blockify(y)
    *b, by, bx, _ = yb.shape
    mx = bx // 2
    stk = torch.cat([yb.reshape(*b, by, mx, 2, 64),
                     blockify(cb)[..., None, :], blockify(cr)[..., None, :]],
                    dim=-2)
    return stk.reshape(*b, by * mx, 4, 64)


def scan_blocks_420(y: torch.Tensor, cb: torch.Tensor,
                    cr: torch.Tensor) -> torch.Tensor:
    """Y [..., H, W], Cb/Cr [..., H/2, W/2] -> [..., nMCU, 6, 64], Y00 Y01
    Y10 Y11 Cb Cr per 16x16 MCU (ITU-T T.81 A.2.3)."""
    yb = blockify(y)
    *b, by, bx, _ = yb.shape
    my, mx = by // 2, bx // 2
    y4 = yb.reshape(*b, my, 2, mx, 2, 64).transpose(-4, -3)
    stk = torch.cat([y4.reshape(*b, my, mx, 4, 64),
                     blockify(cb)[..., None, :], blockify(cr)[..., None, :]],
                    dim=-2)
    return stk.reshape(*b, my * mx, 6, 64)


def encode_blocks(img: torch.Tensor, block_m: torch.Tensor,
                  block_bias: torch.Tensor, subsampling: str) -> torch.Tensor:
    """u8 RGB [..., H, W, 3] (or [..., H, W] / [..., H, W, 1] for gray) ->
    int32 [..., nMCU, B, 64] quantized zigzag coefficients in scan order:
    the whole staged pixel path."""
    if subsampling == "gray":
        y = img[..., 0] if img.ndim >= 3 and img.shape[-1] == 1 else img
        yb = blockify(pad_to_multiple(y.to(torch.float64)[..., None],
                                      8)[..., 0])
        *b, by, bx, _ = yb.shape
        coeffs = fused_dct_quant_zigzag(yb.reshape(*b, by * bx, 64),
                                        block_m[0], block_bias[0])
        return coeffs[..., None, :]
    ycc = rgb_to_ycbcr(img)
    if subsampling == "444s":
        ycc = smooth_chroma_2x2(ycc)
    ycc = pad_to_multiple(ycc, mcu_shape(subsampling))
    if subsampling == "420":
        blocks, n_luma = scan_blocks_420(*downsample_chroma_420(ycc)), 4
    elif subsampling == "422":
        blocks, n_luma = scan_blocks_422(*downsample_chroma_422(ycc)), 2
    else:
        blocks = scan_blocks_444(ycc[..., 0], ycc[..., 1], ycc[..., 2])
        n_luma = 1
    lq = fused_dct_quant_zigzag(blocks[..., :n_luma, :], block_m[0],
                                block_bias[0])
    cq = fused_dct_quant_zigzag(blocks[..., n_luma:, :], block_m[1],
                                block_bias[1])
    return torch.cat([lq, cq], dim=-2)
