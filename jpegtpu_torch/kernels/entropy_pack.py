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

The oracle tier that jpegtpu's tests climb starts here too: ``block_pack``
packs one stream per block (``csrc/block_pack.cu`` ``jt_block_pack``, the
port of ``_block_pack_kernel``) and ``seg_merge_v3`` merges block streams
into MCUs (``entropy_oracles.mcu_merge``) and then into segments
(``seg_merge_mcu``). ``mcu_merge``, ``seg_merge`` and ``seg_merge_v2`` are
re-exported from ``entropy_oracles``, as jpegtpu re-exports them.

Streams are u32 big-endian words stored as int32 bit patterns. Buffers are
sized for the worst case: an MCU of g blocks holds g*52+2 words, a segment
of mps MCUs mps*g*52+2 words (a single segment rounded up to whole 4 KB
chunks), so no input can overflow them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from jpegtpu_torch.entropy import assemble, scan
from jpegtpu_torch.entropy import huffman_tables as ht
from jpegtpu_torch.kernels import _build

# Words of one block's stream row in the oracle tier: a block holds at most
# 1660 bits (52 words) + 1 spill word, padded to 56 as jpegtpu pads it.
BLOCK_WORDS = 56

PACK_BLOCKS = _build.Kernel("jt_block_pack", [
    _build.PTR, _build.PTR, _build.PTR,               # coeffs, cls, dcdiff
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # dc/ac codes + lens
    _build.PTR, _build.PTR,                           # words, lens
    _build.I64])                                      # n_blocks

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


def mcu_capacity(g: int, bits_budget: int) -> Tuple[int, int]:
    """(chunks, cap_bits): an MCU of g blocks under a per-block budget of
    bits_budget bits is staged in chunks*128 words, and cap_bits is the
    largest MCU bit count that provably fits (2 words of slack), as
    jpegtpu's ``mcu_capacity`` (``entropy_pack.py:605-616``)."""
    cap_words = min(g * 52 + 2, -(-g * bits_budget // 32) + 2)
    chunks = -(-cap_words // 128)
    return chunks, (chunks * 128 - 2) * 32


def block_classes(n_mcu: int, g: int, n_luma: int,
                  device: torch.device) -> torch.Tensor:
    """The class of every block of n_mcu MCUs of g blocks, [n_mcu * g]
    int32 (the block pack's ``cls``): 0 for luma (the first n_luma of each
    MCU), 1 for chroma."""
    return (torch.arange(n_mcu * g, device=device) % g >= n_luma
            ).to(torch.int32)


@functools.lru_cache(maxsize=None)
def standard_luts(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The standard Huffman LUTs (``huffman_tables.packed_luts``) as int32
    tensors on one device, built once per device: dc_codes, dc_lens [2, 16],
    ac_codes, ac_lens [2, 256]."""
    return tuple(torch.from_numpy(a.astype("int32")).to(device)
                 for a in ht.packed_luts())


def block_pack_plain(coeffs: torch.Tensor, cls: torch.Tensor,
                     dcdiff: torch.Tensor, dc_codes: torch.Tensor,
                     dc_lens: torch.Tensor, ac_codes: torch.Tensor,
                     ac_lens: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the per-block pack kernel: ``scan.block_symbols``,
    then an int64 scatter-add pack of each block's 64 slots into its own
    BLOCK_WORDS-word row."""
    n = coeffs.shape[0]
    lens, bits = scan.block_symbols(coeffs.reshape(n, 64), cls.reshape(-1),
                                    dcdiff.reshape(-1), dc_codes, dc_lens,
                                    ac_codes, ac_lens)
    words, blens = assemble.pack_words(lens, bits, n, BLOCK_WORDS)
    return assemble.to_i32_bits(words), blens.to(torch.int32)


def block_pack(coeffs: torch.Tensor, cls: torch.Tensor, dcdiff: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zigzag blocks [N, 64] int32, class [N] (0 luma, 1 chroma) and DC
    differences [N] -> (block streams [N, BLOCK_WORDS] int32, bit lengths
    [N] int32): one Huffman stream per block from bit 0, zero past its
    length, with the standard tables (jpegtpu's ``block_pack``; its padding
    of N to whole 1024-row tiles is a TPU layout and is not ported)."""
    luts = standard_luts(coeffs.device)
    if coeffs.device.type == "cpu":
        return block_pack_plain(coeffs, cls, dcdiff, *luts)
    n = coeffs.shape[0]
    args = [t.to(torch.int32).contiguous()
            for t in (coeffs, cls.reshape(-1), dcdiff.reshape(-1))]
    _build.check_cuda(*args, *luts)
    if (coeffs.shape != (n, 64) or args[1].numel() != n
            or args[2].numel() != n):
        raise ValueError("block_pack: want coeffs [N, 64], cls and dcdiff "
                         f"[N]; got {tuple(coeffs.shape)}, "
                         f"{tuple(cls.shape)}, {tuple(dcdiff.shape)}")
    words = torch.empty((n, BLOCK_WORDS), dtype=torch.int32,
                        device=coeffs.device)
    lens = torch.empty((n,), dtype=torch.int32, device=coeffs.device)
    PACK_BLOCKS.launch(coeffs.device,
                       *(a.data_ptr() for a in (*args, *luts)),
                       words.data_ptr(), lens.data_ptr(), n)
    return words, lens


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
    BLOCK_PACK.launch(c2.device, *(a.data_ptr() for a in args),
                      mwords.data_ptr(), mlens.data_ptr(), nm, g, mw)
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


def join_streams_plain(words: torch.Tensor, lens: torch.Tensor,
                       n_out: int, width: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain join shared by the merge twins: stream rows [n, W] int32 (+
    bit lengths [n], each at most 32*W) -> (n_out streams [n_out, width]
    int64 holding u32, their bit counts [n_out] int64), each joining n/n_out
    consecutive rows bit-contiguously. Every stream word is a symbol of up
    to 32 bits (none past the row's length), packed by the int64
    scatter-add of ``assemble.pack_words``; words past `width` are
    dropped, the bit counts stay whole."""
    j = torch.arange(words.shape[1], device=words.device)[None, :]
    sym = torch.clamp(lens.reshape(-1, 1).to(torch.int64) - 32 * j, 0, 32)
    w = assemble.from_i32_bits(words)
    bits = torch.where(sym > 0, w >> (32 - sym), 0)
    return assemble.pack_words(sym, bits, n_out, width)


def merge_segments_plain(words: torch.Tensor, lens: torch.Tensor,
                         n_seg: int, width: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``join_streams_plain`` into n_seg segments of `width` words, each
    segment's last byte 1-padded -> (int32 words, int32 seg_bits). A segment
    of 2^31 bits or more raises ValueError."""
    seg, seg_bits = join_streams_plain(words, lens, n_seg, width)
    if int(seg_bits.max()) >= 1 << 31:
        raise ValueError("a segment must hold fewer than 2^31 bits")
    assemble.pad_ones(seg, seg_bits)
    return assemble.to_i32_bits(seg), seg_bits.to(torch.int32)


def seg_merge_mcu_plain(mwords: torch.Tensor, mlens: torch.Tensor,
                        n_seg: int, mps: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the segment-merge kernel: ``merge_segments_plain``
    into segments of ``segment_words`` words."""
    return merge_segments_plain(
        mwords, mlens, n_seg, segment_words(n_seg, mps, mwords.shape[1]))


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
    SEG_MERGE.launch(mwords.device, mwords.data_ptr(), mlens.data_ptr(),
                     off.data_ptr(), out.data_ptr(), nm, mps, mw, seg_w)
    return out, seg_bits


def seg_merge_v3(words: torch.Tensor, lens: torch.Tensor, n_seg: int,
                 bps: int, w_cap: int, blocks_per_mcu: int,
                 mcu_chunks: int | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block streams [n_seg*bps, W] (+ lengths) -> (segment streams
    [n_seg, segment_words(...)] int32, seg_bits [n_seg] int32, max_mcu_bits
    0-d int32): ``mcu_merge`` of each MCU's blocks_per_mcu blocks, then
    ``seg_merge_mcu`` (jpegtpu's ``seg_merge_v3``). The segments are sized
    for the worst case, not by w_cap and jpegtpu's 1024-word frames (a TPU
    layout), so none overflows; w_cap is accepted for jpegtpu's signature.
    An mcu_chunks smaller than the worst case truncates an MCU over its
    capacity (``mcu_capacity``) in jpegtpu, which leaves the check to its
    caller; here such an MCU raises ValueError (a device sync)."""
    from jpegtpu_torch.kernels.entropy_oracles import default_chunks, mcu_merge
    g = blocks_per_mcu
    if g <= 0 or bps % g:
        raise ValueError(f"seg_merge_v3: {bps} blocks a segment is not "
                         f"whole MCUs of {g}")
    mwords, mlens = mcu_merge(words, lens, g, mcu_chunks)
    max_mcu_bits = mlens.max()
    chunks = mwords.shape[1] // 128
    if chunks < default_chunks(g):
        cap_bits = (chunks * 128 - 2) * 32
        if int(max_mcu_bits) > cap_bits:
            raise ValueError(f"seg_merge_v3: an MCU of {int(max_mcu_bits)} "
                             f"bits exceeds the {cap_bits} bits that "
                             f"{chunks} chunks hold")
    seg, seg_bits = seg_merge_mcu(mwords, mlens, n_seg, bps // g)
    return seg, seg_bits, max_mcu_bits


def __getattr__(name: str):
    """``mcu_merge``, ``seg_merge`` and ``seg_merge_v2`` from
    ``entropy_oracles`` (PEP 562; lazy, since that module imports this
    one), as jpegtpu's ``entropy_pack`` re-exports them."""
    if name in ("mcu_merge", "seg_merge", "seg_merge_v2"):
        from jpegtpu_torch.kernels import entropy_oracles
        return getattr(entropy_oracles, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
