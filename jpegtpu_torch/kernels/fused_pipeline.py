"""Fused front end: u8 pixels -> MCU bitstreams in one kernel, so that the
coefficient tensor never reaches device memory (counterpart of
``jpegtpu.kernels.fused_pipeline``).

``fused_pixel_block_pack_pairs`` launches ``csrc/fused_px_bp.cu`` (K11, the
port of ``_fused_px_bp_kernel``) on a CUDA tensor: K1's factored
tensor-core product on the operator's factors into a shared int16
coefficient tile, the DC differences with their restart resets, and K2's
MCU pack on that tile (``csrc/pixel_common.cuh``, ``csrc/block_pack.cuh``).
Only each MCU's valid words, ceil(mlen / 32), are written, as K2 writes
them: the words past them are undefined on the card. On a CPU tensor it
runs the plain twin ``fused_pixel_block_pack_pairs_plain``, which composes
the split stages' twins (zeros past each stream's length). Both refuse an
operator whose coefficients could leave int16 (``fused_dctq.INT16_MAX``),
which no jpegtpu quality gives. It covers 4:2:0, 4:2:2 and 4:4:4 at every
width (jpegtpu's kernel refuses widths whose MCU count is not a multiple
of its lane group, a rule of the TPU's layout); 4:4:4s and gray take the
split stages, as in jpegtpu's encoder. ``halo_dc_plain`` is the kernel's
arithmetic for the DC values that start a block's run of tiles.
"""

from __future__ import annotations

from typing import Tuple

import torch

from jpegtpu_torch.core import ops
from jpegtpu_torch.kernels import _build, entropy_pack, fused_dctq

FUSED_PX_BP = _build.Kernel("jt_fused_px_bp", [
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # img, lum, chroma, bias
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # dc/ac codes + lens
    _build.PTR, _build.PTR,                           # mwords, mlens
    _build.I64, _build.I64, _build.I64,               # n_mcu, nrx, row_bytes
    _build.I64,                                       # restart
    _build.I32, _build.I32, _build.I32])              # MCU h, w, mcu_words

# The modes the fused kernel takes (jpegtpu's _fused_bp_or_none).
FUSED_MODES = ("420", "422", "444")


def _checked(img: torch.Tensor, tables, subsampling: str) -> Tuple[int, int]:
    """(MCU height, width); raises on a mode the kernel does not take, an
    image that is not u8 [H, W, 3], tables of another mode, or an operator
    whose coefficients could leave the kernel's int16 tile."""
    if subsampling not in FUSED_MODES:
        raise ValueError(f"the fused front end takes {FUSED_MODES}, got "
                         f"{subsampling!r}")
    mh, mw = fused_dctq.operand_geometry(img, tables.m, tables.bias,
                                         subsampling)[:2]
    bound = tables.coefficient_bound
    if bound > fused_dctq.INT16_MAX:
        raise ValueError(f"the fused front end holds coefficients in int16: "
                         f"the {subsampling} operator's reach {bound:.1f}, "
                         f"above {fused_dctq.INT16_MAX}")
    return mh, mw


def halo_dc_plain(img: torch.Tensor, lum: torch.Tensor, chroma: torch.Tensor,
                  bias: torch.Tensor, subsampling: str) -> torch.Tensor:
    """The arithmetic of the kernel's ``halo_dc`` for every MCU of u8
    [H, W, 3] in a fused mode: int32 [nMCU, 3], the DC coefficients of its
    last luma block, its Cb and its Cr, each a float64 dot product of the
    MCU's pixels with one column of the factors (lum's 0 over the last luma
    block's pixels, chroma's 0 and 64 over the exact group sums) plus the
    bias, rounded half away. Every column's sum is exact in any order, so
    they are the product's DC coefficients."""
    mh, mw, _, n_out = fused_dctq.fused_geometry(subsampling)
    g, gy, gx = fused_dctq.chroma_groups(subsampling)
    n_luma = n_out // 64 - 2
    x = fused_dctq.mcu_tiles(ops.pad_to_multiple(img, (mh, mw)), mh, mw)
    n = x.shape[0]
    pix = x.to(torch.int64).reshape(n, mh, mw, 3)
    by, bx = divmod(n_luma - 1, mw // 8)
    last = pix[:, 8 * by:8 * by + 8, 8 * bx:8 * bx + 8].reshape(n, 192)
    sums = pix.reshape(n, mh // gy, gy, mw // gx, gx, 3).sum(dim=(2, 4))
    f64 = torch.float64
    b = bias.to(f64)
    cols = chroma[:, [0, 64]].to(f64)
    dc = torch.cat([
        (last.to(f64) @ lum[:, :1].to(f64)) + b[64 * (n_luma - 1)],
        sums.reshape(n, g * 3).to(f64) @ cols + b[[64 * n_luma,
                                                  64 * n_luma + 64]]], dim=1)
    return ops.round_half_away(dc).to(torch.int32)


def fused_pixel_block_pack_pairs_plain(img: torch.Tensor, tables,
                                       subsampling: str, restart: int
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the fused kernel: the pixel twin, the DC glue and the
    block-pack twin in turn."""
    _checked(img, tables, subsampling)
    coeffs = fused_dctq.encode_blocks_pairs_plain(img, tables.m, tables.bias,
                                                  subsampling)
    return entropy_pack.block_pack_mcu_segments_plain(
        coeffs, coeffs.shape[1] // 64 - 2, restart, tables.luts())


def fused_pixel_block_pack_pairs(img: torch.Tensor, tables, subsampling: str,
                                 restart: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u8 RGB [H, W, 3] (a batch padded to whole MCUs per image and viewed
    as one tall image) -> (MCU streams [nM, g*52+2] int32, bit lengths [nM]
    int32): ``entropy_pack.block_pack_mcu_segments`` of
    ``fused_dctq.encode_blocks_pairs(img)``, in one launch of
    ``csrc/fused_px_bp.cu`` on a CUDA tensor, on the tables' own factors
    (``fused_dctq.kernel_factors``; the plain twin on a CPU tensor).
    ``tables`` is an ``EncoderTables`` of this mode;
    the DC predictor resets where the MCU index is a multiple of
    ``restart`` (restart > 0), or at MCU 0 alone (restart 0). On the card
    each MCU's words past ceil(mlen / 32) are undefined (never written), as
    K2's; the twin zeroes them."""
    mh, mw = _checked(img, tables, subsampling)
    entropy_pack.check_restart(restart)
    if img.device.type == "cpu":
        return fused_pixel_block_pack_pairs_plain(img, tables, subsampling,
                                                  restart)
    padded = fused_dctq.pad_mcus(img, subsampling).contiguous()
    factors = fused_dctq.kernel_factors(tables, subsampling)
    luts = entropy_pack.kernel_luts(tables.luts())
    _build.check_cuda(padded, *factors, *luts)
    if padded.data_ptr() % 16:
        padded = padded.clone()
    h, w, _ = padded.shape
    nrx = w // mw
    n_mcu = (h // mh) * nrx
    words = entropy_pack.mcu_words(factors[2].shape[0] // 64)
    mwords = torch.empty((n_mcu, words), dtype=torch.int32,
                         device=padded.device)
    mlens = torch.empty((n_mcu,), dtype=torch.int32, device=padded.device)
    FUSED_PX_BP.launch(padded.device, padded.data_ptr(),
                       *(f.data_ptr() for f in factors),
                       *(t.data_ptr() for t in luts), mwords.data_ptr(),
                       mlens.data_ptr(), n_mcu, nrx, w * 3, restart, mh, mw,
                       words)
    return mwords, mlens
