"""Entropy back-end kernels: symbolize + pack each MCU, then merge MCU
streams into restart segments (counterpart of
``jpegtpu.kernels.entropy_pack``).

``csrc/block_pack.cu`` holds the port of ``_block_pack_mcu_kernel`` (K2),
one kernel body with two launchers: ``block_pack_mcu_pairs`` takes each
block's class and DC difference (jpegtpu's signature; the oracle tier and
the parity checks call it), ``block_pack_mcu_segments`` derives both in the
kernel from the MCU layout, the restart interval and the DC values (the
encoder calls it, so no glue runs before it). ``seg_merge_mcu`` launches
``csrc/seg_merge.cu`` (the port of ``_seg_merge_v3_kernel``, K3), which
scans the MCU lengths itself and takes a ragged last segment as it is.
On CPU tensors each runs its plain twin (``*_plain``), built from the oracle
formulation in ``jpegtpu_torch.entropy``: ``scan.dc_diffs_from_dc`` and
``block_classes`` for the derived inputs, ``pad_segments`` (zero-length MCUs
that fill a ragged last segment) before the merge. The CUDA path runs none
of them.

The oracle tier that jpegtpu's tests climb starts here too: ``block_pack``
packs one stream per block (``csrc/block_pack.cu`` ``jt_block_pack``, the
port of ``_block_pack_kernel``: K2's pair-run steps on several blocks a
warp, each at bit 0 of its own row, whole rows written) and
``seg_merge_v3`` merges block streams
into MCUs (``entropy_oracles.mcu_merge``) and then into segments
(``seg_merge_mcu``). ``mcu_merge``, ``seg_merge`` and ``seg_merge_v2`` are
re-exported from ``entropy_oracles``, as jpegtpu re-exports them.

Streams are u32 big-endian words stored as int32 bit patterns. Buffers are
sized for the worst case: an MCU of g blocks holds g*52+2 words, a segment
of mps MCUs mps*g*52+2 words (a single segment rounded up to whole 4 KB
chunks), so no input can overflow them. On the card K2 writes an MCU's
first ceil(mlen / 32) words and K3 a segment's first ceil(seg_bits / 32):
the bits past mlens and the bytes past ceil(seg_bits / 8) are undefined
there, and every consumer reads no further. The twins zero them.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

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

# K2's two launchers (one kernel body).
BLOCK_PACK = _build.Kernel("jt_block_pack_mcu", [
    _build.PTR, _build.PTR, _build.PTR,               # coeffs, cls, dcdiff
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # dc/ac codes + lens
    _build.PTR, _build.PTR,                           # mwords, mlens
    _build.I64, _build.I32, _build.I32])              # n_mcu, g, mcu_words
BLOCK_PACK_SEGMENTS = _build.Kernel("jt_block_pack_mcu_segments", [
    _build.PTR, _build.PTR, _build.I64, _build.I64,   # coeffs, dc + strides
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # dc/ac codes + lens
    _build.PTR, _build.PTR,                           # mwords, mlens
    _build.I64, _build.I32, _build.I32, _build.I64,   # n_mcu, g, n_luma,
    _build.I32])                                      # restart, mcu_words
# The most blocks an MCU may have in K2 (csrc/block_pack.cu's kMaxG).
BLOCK_PACK_MAX_G = 48

SEG_MERGE = _build.Kernel("jt_seg_merge_mcu", [
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # mwords, mlens, out,
    _build.PTR,                                       # seg_bits, scratch
    _build.I64, _build.I64, _build.I64, _build.I32,   # nm, n_seg, mps, mcu_w
    _build.I64])                                      # seg_w
# csrc/seg_merge.cu's tiles (K3, K8, K9, K10): segments of up to
# SEG_MERGE_WHOLE rows go whole, about SEG_MERGE_TARGET rows a tile (K3; K8,
# K9 and K10, with the zero tail, SEG_MERGE_WHOLE); a longer one, and with
# the zero tail one whose output row is wider than SEG_MERGE_TAIL words (one
# tile where it has no more than SEG_MERGE_WHOLE rows), is cut into tiles
# of SEG_MERGE_TILE rows (K3 and K9; K8 and K10 SEG_MERGE_ZERO_TILE), which
# need a scratch of SEG_MERGE_SCRATCH_HEAD
# int64 words (the ticket counter) and one a tile, and (zero tail) tail
# tiles of SEG_MERGE_TAIL words of its row. Input rows must be narrower
# than SEG_MERGE_MAX_ROW words.
SEG_MERGE_WHOLE = 512
SEG_MERGE_TARGET = 128
SEG_MERGE_TILE = 256
SEG_MERGE_ZERO_TILE = 512
SEG_MERGE_SCRATCH_HEAD = 16
SEG_MERGE_TAIL = 16384
SEG_MERGE_MAX_ROW = (1 << 31) // (32 * SEG_MERGE_WHOLE)


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
    if args[0].data_ptr() % 8:
        # The kernel loads two slots at once: an 8-byte aligned copy.
        args[0] = args[0].clone()
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
    bit lengths [nM] int32). On the card the bits past each length are
    undefined (the twin's are zero)."""
    if c2.device.type == "cpu":
        return block_pack_mcu_pairs_plain(c2, cls, dcdiff, dc_codes,
                                          dc_lens, ac_codes, ac_lens)
    nm, gx64 = c2.shape
    g = gx64 // 64
    args = [t.to(torch.int32).contiguous() for t in (c2, cls, dcdiff)]
    args += kernel_luts((dc_codes, dc_lens, ac_codes, ac_lens))
    _build.check_cuda(*args)
    if gx64 % 64 or args[1].numel() != nm * g or args[2].numel() != nm * g:
        raise ValueError("block_pack_mcu_pairs: bad input shapes")
    mwords, mlens = _mcu_outputs(nm, g, c2.device)
    BLOCK_PACK.launch(c2.device, *(a.data_ptr() for a in args),
                      mwords.data_ptr(), mlens.data_ptr(), nm, g,
                      mwords.shape[1])
    return mwords, mlens


def kernel_luts(luts: Sequence[torch.Tensor]) -> list:
    """The packed Huffman LUTs as K2 reads them, int32 and contiguous;
    ValueError unless dc_* are [2, 16] and ac_* [2, 256]."""
    luts = [t.to(torch.int32).contiguous() for t in luts]
    if [tuple(t.shape) for t in luts] != [(2, 16), (2, 16), (2, 256),
                                          (2, 256)]:
        raise ValueError("block_pack: bad Huffman LUT shapes")
    return luts


def check_restart(restart: int) -> None:
    """ValueError unless restart (MCUs a segment; 0: one) is >= 0."""
    if restart < 0:
        raise ValueError(f"restart must be >= 0, got {restart}")


def dc_strides(g: int, dc_width: int | None = None) -> Tuple[int, int]:
    """(MCU stride, block step) at which K2 reads the DC of each block: the
    coefficients [nM, g*64] themselves (slot 0 of each block) where
    dc_width is None, else a DC plane [nM, dc_width]."""
    return (64 * g, 64) if dc_width is None else (dc_width, 1)


def _mcu_outputs(nm: int, g: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's outputs, uninitialised: streams [nM, g*52+2], lengths [nM]. A g
    past the kernel's limit raises ValueError."""
    if not 1 <= g <= BLOCK_PACK_MAX_G:
        raise ValueError(f"the block pack takes 1-{BLOCK_PACK_MAX_G} blocks "
                         f"an MCU, got {g}")
    return (torch.empty((nm, mcu_words(g)), dtype=torch.int32, device=device),
            torch.empty((nm,), dtype=torch.int32, device=device))


def block_pack_mcu_segments_plain(coeffs: torch.Tensor, n_luma: int,
                                  restart: int, luts: Sequence[torch.Tensor],
                                  dc: torch.Tensor | None = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the encoder's block-pack launcher: the class vector
    (``block_classes``) and the DC differences (``scan.dc_diffs_from_dc``
    of dc's first g lanes, or of the coefficients' slot 0), then
    ``block_pack_mcu_pairs_plain``."""
    nm, g = coeffs.shape[0], coeffs.shape[1] // 64
    dc_src = coeffs[:, ::64] if dc is None else dc[:, :g]
    dcd = scan.dc_diffs_from_dc(dc_src, n_luma, restart).reshape(-1)
    cls = block_classes(nm, g, n_luma, coeffs.device)
    return block_pack_mcu_pairs_plain(coeffs, cls, dcd, *luts)


def block_pack_mcu_segments(coeffs: torch.Tensor, n_luma: int, restart: int,
                            luts: Sequence[torch.Tensor],
                            dc: torch.Tensor | None = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coefficients [nM, g*64] int32 (block-major columns) of MCUs whose
    first n_luma blocks are luma, and the packed Huffman LUTs -> (MCU
    streams [nM, g*52+2] int32, bit lengths [nM] int32), as
    ``block_pack_mcu_pairs`` with the class of each block from its place in
    the MCU and the DC differences of ``scan.dc_diffs_from_dc``: each block
    less the previous block of its component in scan order, the predictor
    reset to 0 where the MCU index is a multiple of restart (restart > 0)
    or at MCU 0 alone (restart 0). The DC values come from dc [nM, >= g]
    (the pixel kernel's DC plane) where given, else from each block's slot
    0. On the card one launch derives both (``jt_block_pack_mcu_segments``)
    and the bits past each length are undefined; on the CPU the twin."""
    if coeffs.device.type == "cpu":
        return block_pack_mcu_segments_plain(coeffs, n_luma, restart, luts,
                                             dc)
    nm, gx64 = coeffs.shape
    g = gx64 // 64
    coeffs = coeffs.to(torch.int32).contiguous()
    src = coeffs if dc is None else dc.to(torch.int32).contiguous()
    luts = kernel_luts(luts)
    check_restart(restart)
    _build.check_cuda(coeffs, src, *luts)
    if (gx64 % 64 or not 1 <= n_luma <= g or (dc is not None and (
            src.dim() != 2 or src.shape[0] != nm or src.shape[1] < g))):
        raise ValueError("block_pack_mcu_segments: bad input shapes")
    strides = dc_strides(g, None if dc is None else src.shape[1])
    mwords, mlens = _mcu_outputs(nm, g, coeffs.device)
    BLOCK_PACK_SEGMENTS.launch(
        coeffs.device, coeffs.data_ptr(), src.data_ptr(), *strides,
        *(t.data_ptr() for t in luts), mwords.data_ptr(), mlens.data_ptr(),
        nm, g, n_luma, restart, mwords.shape[1])
    return mwords, mlens


def pad_segments(mwords: torch.Tensor, mlens: torch.Tensor, n_seg: int,
                 mps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append n_seg*mps - nM zero-length MCUs, so that a ragged last
    segment holds mps MCUs like the others (``jpegtpu/encoder.py:266-275``).
    A pad MCU adds no bits, so the segment's bytes do not change."""
    pad = _pad_count(mwords.shape[0], n_seg, mps)
    if pad == 0:
        return mwords, mlens
    return (torch.cat([mwords, mwords.new_zeros((pad, mwords.shape[1]))]),
            torch.cat([mlens, mlens.new_zeros(pad)]))


def _pad_count(nm: int, n_seg: int, mps: int) -> int:
    """The zero-length MCUs that fill nM MCUs to n_seg segments of mps;
    ValueError unless that is fewer than mps (a ragged last segment)."""
    pad = n_seg * mps - nm
    if pad < 0 or pad >= max(mps, 1):
        raise ValueError(f"{nm} MCUs do not fill the last of {n_seg} "
                         f"segments of {mps}")
    return pad


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


def segment_bits(lens: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Bit lengths of streams [n] -> each of n_seg segments' bit count
    ([n_seg] int64), a segment joining n/n_seg consecutive streams: the
    merges' 2^31-bit guard. A segment of 2^31 bits or more raises
    ValueError (on a CUDA tensor, a device sync)."""
    seg_bits = lens.reshape(n_seg, lens.numel() // max(n_seg, 1)).sum(
        1, dtype=torch.int64)
    most = int(seg_bits.max()) if n_seg else 0
    if most >= 1 << 31:
        raise ValueError(f"a segment holds {most} bits; a segment must "
                         f"hold fewer than 2^31")
    return seg_bits


def merge_segments_plain(words: torch.Tensor, lens: torch.Tensor,
                         n_seg: int, width: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``join_streams_plain`` into n_seg segments of `width` words, each
    segment's last byte 1-padded -> (int32 words, int32 seg_bits). A segment
    of 2^31 bits or more raises ValueError (``segment_bits``)."""
    segment_bits(lens, n_seg)
    seg, seg_bits = join_streams_plain(words, lens, n_seg, width)
    assemble.pad_ones(seg, seg_bits)
    return assemble.to_i32_bits(seg), seg_bits.to(torch.int32)


def seg_merge_mcu_plain(mwords: torch.Tensor, mlens: torch.Tensor,
                        n_seg: int, mps: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the segment-merge kernel: ``pad_segments``, then
    ``merge_segments_plain`` into segments of ``segment_words`` words."""
    mwords, mlens = pad_segments(mwords, mlens.reshape(-1), n_seg, mps)
    return merge_segments_plain(
        mwords, mlens, n_seg, segment_words(n_seg, mps, mwords.shape[1]))


def _seg_merge_split(mps: int, seg_words: int, zero_tail: bool) -> bool:
    """Whether the segment-merge body cuts each segment into tiles."""
    return mps > SEG_MERGE_WHOLE or (zero_tail and seg_words > SEG_MERGE_TAIL)


def seg_merge_tiles(n_seg: int, mps: int, seg_words: int,
                    zero_tail: bool, split_rows: int | None = None
                    ) -> Tuple[int, int]:
    """(data tiles, tail tiles) of one launch of the segment-merge body on
    n_seg segments of mps rows into rows of seg_words words: tiles of
    max(1, SEG_MERGE_TARGET // mps) whole segments (with the zero tail
    max(1, SEG_MERGE_WHOLE // mps)), or, past SEG_MERGE_WHOLE rows,
    ceil(mps / split_rows) tiles a segment, and (zero tail) past
    SEG_MERGE_TAIL words a row one tile a segment that has fewer rows; with
    the zero tail then ceil(seg_words / SEG_MERGE_TAIL) tail tiles a
    segment. split_rows is the instance's: SEG_MERGE_TILE for K3
    and K9, SEG_MERGE_ZERO_TILE for K8 and K10 (the default by
    zero_tail)."""
    if not _seg_merge_split(mps, seg_words, zero_tail):
        target = SEG_MERGE_WHOLE if zero_tail else SEG_MERGE_TARGET
        return -(-n_seg // max(1, target // mps)), 0
    if split_rows is None:
        split_rows = SEG_MERGE_ZERO_TILE if zero_tail else SEG_MERGE_TILE
    tps = -(-mps // split_rows) if mps > SEG_MERGE_WHOLE else 1
    tails = -(-seg_words // SEG_MERGE_TAIL) if zero_tail else 0
    return n_seg * tps, n_seg * tails


def seg_merge_scratch_words(n_seg: int, mps: int, zero_tail: bool = False,
                            seg_words: int = 0,
                            split_rows: int | None = None) -> int:
    """int64 words of the segment-merge kernel's scratch (K3; with
    zero_tail, K8's, K9's and K10's, whose rows are seg_words words): none
    where no segment is split, else the ticket counter and its padding,
    then a status word a data tile (tail tiles have none)."""
    if not _seg_merge_split(mps, seg_words, zero_tail):
        return 0
    return (SEG_MERGE_SCRATCH_HEAD +
            seg_merge_tiles(n_seg, mps, seg_words, zero_tail, split_rows)[0])


def seg_merge_sizes(n_seg: int, mps: int, mw: int
                    ) -> Tuple[int, int, bool]:
    """(segment words, scratch words, whether a segment may reach 2^31
    bits) of K3 on n_seg segments of mps MCU streams of mw words: the
    last, where a run must check ``seg_bits`` for the kernel's overflow
    mark."""
    return (segment_words(n_seg, mps, mw),
            seg_merge_scratch_words(n_seg, mps), mps * 32 * mw >= 1 << 31)


def seg_merge_mcu(mwords: torch.Tensor, mlens: torch.Tensor, n_seg: int,
                  mps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """MCU streams [nM, W] int32 (+ bit lengths [nM]) -> (segment streams
    [n_seg, segment_words(n_seg, mps, W)] int32, seg_bits [n_seg] int32):
    segment s joins MCUs s*mps .. s*mps+mps-1 bit-contiguously and 1-pads
    its last byte. nM may fall short of n_seg*mps by less than mps (a ragged
    last segment: the missing MCUs have no bits). Stream bits past an MCU's
    length are ignored. On the card one launch, no glue: its words past
    ceil(seg_bits / 32) are never written (undefined), and a segment of
    2^31 bits or more raises ValueError (a device sync, only where mps MCUs
    of W words could reach it)."""
    if mwords.device.type == "cpu":
        return seg_merge_mcu_plain(mwords, mlens, n_seg, mps)
    nm, mw = mwords.shape
    if mlens.shape != (nm,):
        raise ValueError(f"seg_merge_mcu: mlens {tuple(mlens.shape)} for "
                         f"{nm} MCUs")
    _pad_count(nm, n_seg, mps)
    mwords = mwords.to(torch.int32).contiguous()
    mlens = mlens.to(torch.int32).contiguous()
    _build.check_cuda(mwords, mlens)
    dev = mwords.device
    seg_w, n_scratch, may_overflow = seg_merge_sizes(n_seg, mps, mw)
    out = torch.empty((n_seg, seg_w), dtype=torch.int32, device=dev)
    seg_bits = torch.empty((n_seg,), dtype=torch.int32, device=dev)
    if n_seg == 0:
        return out, seg_bits
    scratch = (torch.empty(n_scratch, dtype=torch.int64, device=dev)
               if n_scratch else None)
    SEG_MERGE.launch(dev, mwords.data_ptr(), mlens.data_ptr(),
                     out.data_ptr(), seg_bits.data_ptr(),
                     scratch.data_ptr() if n_scratch else None, nm, n_seg,
                     mps, mw, seg_w)
    if may_overflow and bool((seg_bits < 0).any()):
        raise ValueError("a segment must hold fewer than 2^31 bits")
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
