"""Entropy back-end kernels: symbolize + pack each MCU, then merge MCU
streams into restart segments (counterpart of
``jpegtpu.kernels.entropy_pack``).

``block_pack_mcu_pairs`` launches ``csrc/block_pack.cu`` (the port of
``_block_pack_mcu_kernel``) and ``seg_merge_mcu`` launches
``csrc/seg_merge.cu`` (the port of ``_seg_merge_v3_kernel``) on CUDA
tensors. On CPU tensors each runs its plain twin (``*_plain``), built from
the oracle formulation in ``jpegtpu_torch.entropy``. ``pad_segments`` fills
a ragged last segment with zero-length MCUs, so that every segment holds
the same number of MCUs.

Streams are u32 big-endian words stored as int32 bit patterns. Buffers are
sized for the worst case: an MCU of g blocks holds g*52+2 words, a segment
of mps MCUs mps*g*52+2 words (a single segment rounded up to whole 4 KB
chunks), so no input can overflow them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from jpegtpu_torch.entropy import assemble, scan
from jpegtpu_torch.kernels import _build

BLOCK_PACK = _build.Kernel("jt_block_pack_mcu", [
    _build.PTR, _build.PTR, _build.PTR,               # coeffs, cls, dcdiff
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # dc/ac codes + lens
    _build.PTR, _build.PTR,                           # mwords, mlens
    _build.I64, _build.I32, _build.I32])              # n_mcu, g, mcu_words

SEG_MERGE = _build.Kernel("jt_seg_merge_mcu", [
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # mwords, mlens, off, out
    _build.I64, _build.I64, _build.I32, _build.I64])  # n_mcu, mps, mcu_w, seg_w


def mcu_words(g: int) -> int:
    """Worst-case words of one MCU stream of g blocks."""
    return g * assemble.WORDS_PER_BLOCK + 2


def segment_words(n_seg: int, mps: int, mw: int) -> int:
    """Words of each of n_seg segments of mps MCU streams of mw words:
    their mw-2 data words each plus 2 of slack. A single segment, which the
    chunk stuffing kernel takes, is rounded up to whole 1024-word (4 KB)
    chunks, so that its glue views the words as chunks without a copy;
    several segments are not, so small intervals stay small."""
    words = mps * (mw - 2) + 2
    return -(-words // 1024) * 1024 if n_seg == 1 else words


def block_pack_mcu_pairs_plain(c2: torch.Tensor, cls: torch.Tensor,
                               dcdiff: torch.Tensor, dc_codes: torch.Tensor,
                               dc_lens: torch.Tensor, ac_codes: torch.Tensor,
                               ac_lens: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the block-pack kernel: ``scan.block_symbols``, then an
    int64 scatter-add pack of each MCU's g*64 slots."""
    nm, gx64 = c2.shape
    g = gx64 // 64
    lens, bits = scan.block_symbols(c2.reshape(-1, 64), cls.reshape(-1),
                                    dcdiff.reshape(-1), dc_codes, dc_lens,
                                    ac_codes, ac_lens)
    words, mlens = assemble.pack_words(lens, bits, nm, mcu_words(g))
    return assemble.to_i32_bits(words), mlens.to(torch.int32)


def block_pack_mcu_pairs(c2: torch.Tensor, cls: torch.Tensor,
                         dcdiff: torch.Tensor, dc_codes: torch.Tensor,
                         dc_lens: torch.Tensor, ac_codes: torch.Tensor,
                         ac_lens: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coefficients [nM, g*64] int32 (block-major columns), class [nM*g]
    (0 luma, 1 chroma) and DC differences [nM*g], plus the packed Huffman
    LUTs dc_* [2,16] / ac_* [2,256] -> (MCU streams [nM, g*52+2] int32,
    bit lengths [nM] int32). Each MCU stream is zero past its length."""
    if c2.device.type == "cpu":
        return block_pack_mcu_pairs_plain(c2, cls, dcdiff, dc_codes,
                                          dc_lens, ac_codes, ac_lens)
    nm, gx64 = c2.shape
    g = gx64 // 64
    args = [t.to(torch.int32).contiguous()
            for t in (c2, cls, dcdiff, dc_codes, dc_lens, ac_codes, ac_lens)]
    _build.check_cuda(*args)
    if (gx64 % 64 or args[1].numel() != nm * g or args[2].numel() != nm * g
            or args[3].shape != (2, 16) or args[4].shape != (2, 16)
            or args[5].shape != (2, 256) or args[6].shape != (2, 256)):
        raise ValueError("block_pack_mcu_pairs: bad input shapes")
    mw = mcu_words(g)
    mwords = torch.empty((nm, mw), dtype=torch.int32, device=c2.device)
    mlens = torch.empty((nm,), dtype=torch.int32, device=c2.device)
    BLOCK_PACK.launch(*(a.data_ptr() for a in args), mwords.data_ptr(),
                      mlens.data_ptr(), nm, g, mw)
    return mwords, mlens


def pad_segments(mwords: torch.Tensor, mlens: torch.Tensor, n_seg: int,
                 mps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append n_seg*mps - nM zero-length MCUs, so that a ragged last
    segment holds mps MCUs like the others (``jpegtpu/encoder.py:266-275``).
    A pad MCU adds no bits, so the segment's bytes do not change."""
    pad = n_seg * mps - mwords.shape[0]
    if pad < 0 or pad >= mps:
        raise ValueError(f"{mwords.shape[0]} MCUs do not fill the last of "
                         f"{n_seg} segments of {mps}")
    if pad == 0:
        return mwords, mlens
    return (torch.cat([mwords, mwords.new_zeros((pad, mwords.shape[1]))]),
            torch.cat([mlens, mlens.new_zeros(pad)]))


def segment_offsets(mlens: torch.Tensor, n_seg: int, mps: int,
                    mcu_bits_cap: int | None = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each MCU's exclusive bit offset within its segment ([nM] int32) and
    each segment's bit count ([n_seg] int32): the glue before the merge.

    The sums are int64. A segment of 2^31 bits or more raises ValueError
    instead of wrapping. On a CUDA tensor the check reads the sums back (a
    device sync) only when mps MCUs of mcu_bits_cap bits (an MCU stream's
    capacity) could reach 2^31."""
    ml = mlens.reshape(-1).to(torch.int64)
    # One flat scan over all MCUs, less each segment's base: a scan along
    # many short rows (small intervals) is slow on the card.
    incl = torch.cumsum(ml, dim=0).reshape(n_seg, mps)
    excl = incl - ml.reshape(n_seg, mps)
    base = excl[:, :1]
    seg_bits = incl[:, -1] - base[:, 0]
    if (mlens.device.type == "cpu" or mcu_bits_cap is None
            or mps * mcu_bits_cap >= 1 << 31):
        most = int(seg_bits.max())
        if most >= 1 << 31:
            raise ValueError(f"a segment holds {most} bits; a segment "
                             f"must hold fewer than 2^31")
    return (excl - base).reshape(-1).to(torch.int32), seg_bits.to(torch.int32)


def seg_merge_mcu_plain(mwords: torch.Tensor, mlens: torch.Tensor,
                        n_seg: int, mps: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the segment-merge kernel: every MCU stream word is a
    symbol of up to 32 bits, packed by the int64 scatter-add of
    ``assemble.pack_words``, then each segment's last byte is 1-padded."""
    nm, mw = mwords.shape
    j = torch.arange(mw, device=mwords.device)[None, :]
    ml = mlens.to(torch.int64)[:, None]
    lens = torch.clamp(ml - 32 * j, 0, 32)
    words = assemble.from_i32_bits(mwords)
    bits = torch.where(lens > 0, words >> (32 - lens), 0)
    seg, seg_bits = assemble.pack_words(lens, bits, n_seg,
                                        segment_words(n_seg, mps, mw))
    if int(seg_bits.max()) >= 1 << 31:
        raise ValueError("a segment must hold fewer than 2^31 bits")
    assemble.pad_ones(seg, seg_bits)
    return assemble.to_i32_bits(seg), seg_bits.to(torch.int32)


def seg_merge_mcu(mwords: torch.Tensor, mlens: torch.Tensor, n_seg: int,
                  mps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """MCU streams [nM, W] int32 (+ bit lengths [nM]) -> (segment streams
    [n_seg, segment_words(n_seg, mps, W)] int32, seg_bits [n_seg] int32):
    segment s joins MCUs s*mps .. s*mps+mps-1 bit-contiguously and 1-pads
    its last byte. Stream bits past an MCU's length are ignored."""
    if mwords.device.type == "cpu":
        return seg_merge_mcu_plain(mwords, mlens, n_seg, mps)
    nm, mw = mwords.shape
    if nm != n_seg * mps or mlens.shape != (nm,):
        raise ValueError(f"seg_merge_mcu: {nm} MCUs is not {n_seg} "
                         f"segments of {mps}")
    mwords = mwords.to(torch.int32).contiguous()
    mlens = mlens.to(torch.int32).contiguous()
    off, seg_bits = segment_offsets(mlens, n_seg, mps, 32 * mw)
    _build.check_cuda(mwords, mlens, off)
    seg_w = segment_words(n_seg, mps, mw)
    out = torch.zeros((n_seg, seg_w), dtype=torch.int32, device=mwords.device)
    SEG_MERGE.launch(mwords.data_ptr(), mlens.data_ptr(), off.data_ptr(),
                     out.data_ptr(), nm, mps, mw, seg_w)
    return out, seg_bits
