"""Fused front end: u8 pixels -> MCU bitstreams in one kernel, so that the
coefficient tensor never reaches device memory (counterpart of
``jpegtpu.kernels.fused_pipeline``).

``fused_pixel_block_pack_pairs`` launches ``csrc/fused_px_bp.cu`` (the port
of ``_fused_px_bp_kernel``) on a CUDA tensor: the dense pixel product of
``csrc/pixel_common.cuh``, the DC differences with their restart resets,
and the per-block pack of ``csrc/block_pack.cuh``, per MCU. On a CPU tensor
it runs the plain twin ``fused_pixel_block_pack_pairs_plain``, which
composes the split stages' twins. Either way the output is word for word
that of the split stages' twins, zeros past each stream's length included
(the split block pack on the card leaves those bits undefined). It covers
4:2:0, 4:2:2 and 4:4:4 at every width (jpegtpu's kernel refuses widths
whose MCU count is not a multiple of its lane group, a rule of the TPU's
layout); 4:4:4s and gray take the split stages, as in jpegtpu's encoder.
"""

from __future__ import annotations

from typing import Tuple

import torch

from jpegtpu_torch.core import ops
from jpegtpu_torch.kernels import _build, entropy_pack, fused_dctq

FUSED_PX_BP = _build.Kernel("jt_fused_px_bp", [
    _build.PTR, _build.PTR, _build.PTR,               # img, m, bias
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # dc/ac codes + lens
    _build.PTR, _build.PTR,                           # mwords, mlens
    _build.I64, _build.I64, _build.I64,               # n_mcu, nrx, row_bytes
    _build.I64,                                       # restart
    _build.I32, _build.I32, _build.I32])              # MCU h, w, mcu_words

# The modes the fused kernel takes (jpegtpu's _fused_bp_or_none).
FUSED_MODES = ("420", "422", "444")


def _checked(img: torch.Tensor, tables, subsampling: str) -> Tuple[int, int]:
    """(MCU height, width); raises on a mode the kernel does not take, an
    image that is not u8 [H, W, 3] or tables of another mode."""
    if subsampling not in FUSED_MODES:
        raise ValueError(f"the fused front end takes {FUSED_MODES}, got "
                         f"{subsampling!r}")
    return fused_dctq.operand_geometry(img, tables.m, tables.bias,
                                       subsampling)[:2]


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
    ``csrc/fused_px_bp.cu`` on a CUDA tensor (the plain twin on a CPU
    tensor). ``tables`` is an ``EncoderTables`` of this mode; the DC
    predictor resets where the MCU index is a multiple of ``restart``
    (restart > 0), or at MCU 0 alone (restart 0)."""
    mh, mw = _checked(img, tables, subsampling)
    if restart < 0:
        raise ValueError(f"restart must be >= 0, got {restart}")
    if img.device.type == "cpu":
        return fused_pixel_block_pack_pairs_plain(img, tables, subsampling,
                                                  restart)
    padded = ops.pad_to_multiple(img, (mh, mw)).contiguous()
    m = tables.m.to(torch.float32).contiguous()
    bias = tables.bias.to(torch.float32).contiguous()
    luts = [t.to(torch.int32).contiguous() for t in tables.luts()]
    _build.check_cuda(padded, m, bias, *luts)
    h, w, _ = padded.shape
    nrx = w // mw
    n_mcu = (h // mh) * nrx
    g = m.shape[1] // 64
    words = entropy_pack.mcu_words(g)
    mwords = torch.empty((n_mcu, words), dtype=torch.int32,
                         device=padded.device)
    mlens = torch.empty((n_mcu,), dtype=torch.int32, device=padded.device)
    FUSED_PX_BP.launch(padded.device, padded.data_ptr(), m.data_ptr(),
                       bias.data_ptr(), *(t.data_ptr() for t in luts),
                       mwords.data_ptr(), mlens.data_ptr(), n_mcu, nrx,
                       w * 3, restart, mh, mw, words)
    return mwords, mlens
