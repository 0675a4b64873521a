"""Oracle-tier merges: block streams -> MCU streams -> segment streams
(counterpart of ``jpegtpu.kernels.entropy_oracles``).

jpegtpu keeps these earlier generations as the bit-exactness ladder its
tests climb (block pack -> v1 -> v2 -> v3 -> the fused main path); the port
keeps them with jpegtpu's signatures and output shapes:

* ``mcu_merge`` joins g block streams into one MCU stream (K8, the port
  of ``_mcu_merge_kernel``);
* ``seg_merge_v2`` is ``mcu_merge`` and then the join of each segment's
  MCU streams (K9, the port of ``_seg_merge_window_kernel``);
* ``seg_merge`` (v1) joins each segment's block streams (K10, the port of
  ``_seg_merge_kernel``).

K8, K9 and K10 are instances of K3's body (``csrc/seg_merge.cu``,
launchers ``jt_mcu_merge``, ``jt_seg_merge_window`` and
``jt_seg_merge_v1``): a "segment" of K8 is one MCU of g block streams,
unpadded; K9's is a restart segment of MCU streams and K10's one of block
streams, 1-padded. All three write whole output rows, zeros past the data,
so their outputs need no fill.

On CUDA tensors each wrapper launches its kernel; on CPU tensors it runs
its plain twin (``*_plain``), the int64 scatter-add join of
``entropy_pack.join_streams_plain``. Stream bits past a row's length are
ignored. A segment that outgrows its output row keeps its true bit count
and loses the words past the row, kernel and twin alike (jpegtpu clamps
v2 to its last frame and lets v1 write past its buffer: no contract).
"""

from __future__ import annotations

from typing import Tuple

import torch

from jpegtpu_torch.entropy import assemble
from jpegtpu_torch.kernels import _build, entropy_pack

# K8's, K9's and K10's arguments: rows, lens, out, seg_bits, scratch, then
# n_seg, streams per segment, words per row and words per segment.
_MERGE_ARGS = [_build.PTR, _build.PTR, _build.PTR, _build.PTR, _build.PTR,
               _build.I64, _build.I64, _build.I32, _build.I64]
MCU_MERGE = _build.Kernel("jt_mcu_merge", _MERGE_ARGS)
SEG_MERGE_V1 = _build.Kernel("jt_seg_merge_v1", _MERGE_ARGS)
SEG_MERGE_WINDOW = _build.Kernel("jt_seg_merge_window", _MERGE_ARGS)


def default_chunks(g: int) -> int:
    """128-word chunks of an MCU row of g blocks at the worst case
    (``entropy_pack.mcu_words``), jpegtpu's default for ``mcu_merge``."""
    return -(-entropy_pack.mcu_words(g) // 128)


def _int32_rows(words: torch.Tensor, lens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows [n, W] and lengths [n] as contiguous int32 CUDA tensors."""
    words = words.to(torch.int32).contiguous()
    lens = lens.reshape(-1).to(torch.int32).contiguous()
    _build.check_cuda(words, lens)
    if words.dim() != 2 or lens.numel() != words.shape[0]:
        raise ValueError(f"want stream rows [n, W] and lengths [n], got "
                         f"{tuple(words.shape)} and {tuple(lens.shape)}")
    return words, lens


def mcu_merge_plain(words: torch.Tensor, lens: torch.Tensor, g: int,
                    width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the MCU-merge kernel: ``join_streams_plain`` of each
    g consecutive rows into a row of `width` words."""
    mwords, mlens = entropy_pack.join_streams_plain(
        words, lens, words.shape[0] // g, width)
    return assemble.to_i32_bits(mwords), mlens.to(torch.int32)


def _check_widths(what: str, rows: torch.Tensor, width: int) -> None:
    """Refuse, on either device, rows or an output row wider than the
    merge body takes (K8, K9, K10), or an output row that is not whole
    16-byte quads (it writes whole rows in 16-byte stores)."""
    if (rows.shape[-1] >= entropy_pack.SEG_MERGE_MAX_ROW or width >= 1 << 31
            or width % 4):
        raise ValueError(f"{what}: stream rows of {rows.shape[-1]} words "
                         f"(must be under {entropy_pack.SEG_MERGE_MAX_ROW}) "
                         f"into rows of {width} (must be under 2^31 and a "
                         f"multiple of 4)")


def _merge(kernel: _build.Kernel, rows: torch.Tensor, lens: torch.Tensor,
           n_seg: int, per_seg: int, width: int, split_rows: int | None = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8, K9 or K10 on CUDA tensors: one launch of the segment-merge body,
    n_seg segments of per_seg rows each into an [n_seg, width] output that
    it writes whole (no fill), and the true bit counts. split_rows: the
    instance's split tiles (``entropy_pack.seg_merge_tiles``)."""
    rows, lens = _int32_rows(rows, lens)
    dev = rows.device
    out = torch.empty((n_seg, width), dtype=torch.int32, device=dev)
    seg_bits = torch.empty((n_seg,), dtype=torch.int32, device=dev)
    if n_seg == 0:
        return out, seg_bits
    if per_seg * 32 * rows.shape[1] >= 1 << 31:
        # The kernel writes -1 for a segment of 2^31 bits or more: read the
        # sums back (a device sync) only where rows this long could reach it.
        entropy_pack.segment_bits(lens, n_seg)
    n_scratch = entropy_pack.seg_merge_scratch_words(
        n_seg, per_seg, True, width, split_rows)
    scratch = (torch.empty(n_scratch, dtype=torch.int64, device=dev)
               if n_scratch else None)
    kernel.launch(dev, rows.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  seg_bits.data_ptr(),
                  scratch.data_ptr() if n_scratch else None, n_seg, per_seg,
                  rows.shape[1], width)
    return out, seg_bits


def mcu_merge(words: torch.Tensor, lens: torch.Tensor, g: int,
              chunks: int | None = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block streams [N, W] int32 (+ bit lengths [N]) -> (MCU streams
    [N/g, chunks*128] int32, lengths [N/g] int32): each g consecutive
    streams joined bit-contiguously, zero past the length. chunks defaults
    to the worst case (``default_chunks``); a smaller one (from
    ``mcu_capacity``) drops the words past chunks*128 while the length
    stays the full sum, as in jpegtpu, whose callers check the lengths
    against the capacity."""
    n = words.shape[0]
    if g <= 0 or n % g:
        raise ValueError(f"mcu_merge: {n} blocks is not whole MCUs of {g}")
    width = 128 * (default_chunks(g) if chunks is None else chunks)
    _check_widths("mcu_merge", words, width)
    if words.device.type == "cpu":
        return mcu_merge_plain(words, lens, g, width)
    return _merge(MCU_MERGE, words, lens, n // g, g, width)


# The plain twins of K9 and K10: (rows, lens, n_seg, width) -> the rows
# joined into n_seg segments of `width` words, 1-padded.
seg_merge_window_plain = seg_merge_plain = entropy_pack.merge_segments_plain


def seg_merge_window(mwords: torch.Tensor, mlens: torch.Tensor, n_seg: int,
                     mps: int, width: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MCU streams [n_seg*mps, W] int32 (+ lengths) -> (segment streams
    [n_seg, width] int32, true seg_bits [n_seg] int32): segment s joins
    MCUs s*mps .. s*mps+mps-1 and 1-pads its last byte (K9). width must be
    a multiple of 4 (jpegtpu's rows are frames*1024 words)."""
    if mps <= 0 or mwords.shape[0] != n_seg * mps:
        raise ValueError(f"{mwords.shape[0]} streams is not {n_seg} segments "
                         f"of {mps}")
    _check_widths("seg_merge_window", mwords, width)
    if mwords.device.type == "cpu":
        return seg_merge_window_plain(mwords, mlens, n_seg, width)
    return _merge(SEG_MERGE_WINDOW, mwords, mlens, n_seg, mps, width,
                  entropy_pack.SEG_MERGE_TILE)


def seg_merge_v2(words: torch.Tensor, lens: torch.Tensor, n_seg: int,
                 bps: int, w_cap: int, blocks_per_mcu: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block streams [n_seg*bps, W] (+ lengths) -> (segment streams
    [n_seg, frames*1024] int32, seg_bits [n_seg] int32) with frames =
    ceil(w_cap/1024) + 1: ``mcu_merge`` at the worst-case chunks, then the
    serial append of each segment's MCUs (jpegtpu's ``seg_merge_v2``)."""
    g = blocks_per_mcu
    if g <= 0 or bps % g:
        raise ValueError(f"seg_merge_v2: {bps} blocks a segment is not "
                         f"whole MCUs of {g}")
    mwords, mlens = mcu_merge(words, lens, g)
    frames = -(-w_cap // 1024) + 1
    return seg_merge_window(mwords, mlens, n_seg, bps // g, frames * 1024)


def seg_merge(words: torch.Tensor, lens: torch.Tensor, n_seg: int, bps: int,
              w_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block streams [n_seg*bps, W] int32 (+ lengths) -> (segment streams
    [n_seg, rows*128] int32, true seg_bits [n_seg] int32) with rows =
    ceil(w_cap/128): segment s appends blocks s*bps .. s*bps+bps-1 one by
    one and 1-pads its last byte (jpegtpu's ``seg_merge``, v1)."""
    if bps <= 0 or words.shape[0] != n_seg * bps:
        raise ValueError(f"{words.shape[0]} streams is not {n_seg} segments "
                         f"of {bps}")
    width = -(-w_cap // 128) * 128
    _check_widths("seg_merge", words, width)
    if words.device.type == "cpu":
        return seg_merge_plain(words, lens, n_seg, width)
    return _merge(SEG_MERGE_V1, words, lens, n_seg, bps, width)
