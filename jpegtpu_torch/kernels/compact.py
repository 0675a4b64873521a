"""Device stuffing: segment bitstreams -> the finished entropy-coded scan
(counterpart of ``jpegtpu.kernels.compact``).

``stuff_precompute`` is the glue (jpegtpu's ``_stuff_precompute``): every
output byte offset follows from each segment's byte count and 0xFF count,
so the kernel reads them as inputs. ``compact_segments_stuffed`` launches
``csrc/stuff.cu`` (the port of ``_compact_stuff_kernel_gkb``) on CUDA
tensors and runs the plain twin ``compact_segments_stuffed_plain`` on CPU
tensors. Both return one contiguous u8 buffer whose first ``total`` bytes
are the scan.
"""

from __future__ import annotations

from typing import Tuple

import torch

from jpegtpu_torch.entropy import assemble
from jpegtpu_torch.kernels import _build

STUFF = _build.Kernel("jt_stuff_segments", [
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # words, nbytes, start, out
    _build.I64, _build.I64, _build.I32])               # n_seg, stride, markers


def scan_capacity(n_seg: int, seg_words: int) -> int:
    """Bytes that hold any scan of n_seg segments of seg_words words: every
    byte stuffed, plus one 2-byte RST marker per segment."""
    return n_seg * (8 * seg_words + 2)


def stuff_precompute(seg_words: torch.Tensor, seg_bits: torch.Tensor,
                     restart: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """(nbytes [n_seg] int32, 0xFF count [n_seg] int64, stuffed start
    [n_seg] int64, total bytes int64 scalar) of the scan that
    ``compact_segments_stuffed`` writes."""
    n_seg, w = seg_words.shape
    nbytes = (seg_bits.to(torch.int64) + 7) >> 3
    # The words' bytes in memory order (little-endian); byte i of word j
    # is stream byte 4j + 3 - i.
    by = seg_words.contiguous().view(torch.uint8).reshape(n_seg, w, 4)
    pos = (4 * torch.arange(w, device=seg_words.device)[:, None] + 3 -
           torch.arange(4, device=seg_words.device)[None, :])
    ffc = ((by == 0xFF) & (pos < nbytes[:, None, None])).sum(dim=(1, 2))
    # A 2-byte RST marker follows every segment but the last.
    has_marker = (torch.arange(n_seg, device=seg_words.device) <
                  (n_seg - 1 if restart > 0 else 0))
    seg_len = nbytes + ffc + 2 * has_marker
    seg_start = torch.cumsum(seg_len, dim=0) - seg_len
    return nbytes.to(torch.int32), ffc, seg_start, seg_len.sum()


def compact_segments_stuffed_plain(seg_words: torch.Tensor,
                                   seg_bits: torch.Tensor, restart: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the stuffing kernel: explode the words to bytes, then
    scatter them to their stuffed positions and splice the RST markers
    (``assemble.stuff_and_splice``)."""
    n_seg, w = seg_words.shape
    nbytes, _, seg_start, total = stuff_precompute(seg_words, seg_bits,
                                                   restart)
    out = assemble.stuff_and_splice(
        assemble.explode_bytes(seg_words), nbytes.to(torch.int64),
        seg_start, restart, scan_capacity(n_seg, w))
    return out, total


def compact_segments_stuffed(seg_words: torch.Tensor, seg_bits: torch.Tensor,
                             restart: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment streams [n_seg, W] int32 (u32 bit patterns, 1-padded) and
    seg_bits [n_seg] -> (u8 buffer [n_seg*(8W+2)], total bytes int64
    scalar); the scan is the buffer's first ``total`` bytes. Bytes past the
    scan are unspecified."""
    if seg_words.device.type == "cpu":
        return compact_segments_stuffed_plain(seg_words, seg_bits, restart)
    n_seg, w = seg_words.shape
    seg_words = seg_words.to(torch.int32).contiguous()
    nbytes, _, seg_start, total = stuff_precompute(seg_words, seg_bits,
                                                   restart)
    _build.check_cuda(seg_words, nbytes, seg_start)
    out = torch.empty(scan_capacity(n_seg, w), dtype=torch.uint8,
                      device=seg_words.device)
    STUFF.launch(seg_words.data_ptr(), nbytes.data_ptr(),
                 seg_start.data_ptr(), out.data_ptr(), n_seg, w,
                 int(restart > 0))
    return out, total
