"""Device stuffing: segment bitstreams -> the finished entropy-coded scan
(counterpart of ``jpegtpu.kernels.compact``).

Two kernels, as in jpegtpu, chosen by the encoder from the segment count:

- ``compact_segments_stuffed`` (one segment, or any count in one chain)
  launches ``csrc/stuff_chunks.cu``, the port of ``_compact_stuff_kernel``
  / ``_compact_stuff_kernel_kb``. Its glue ``stuff_precompute_chunks`` is
  jpegtpu's ``_stuff_precompute``: the stuffed output offset of every
  4 KB chunk of every segment, so no chunk waits for another.
- ``compact_segments_stuffed_grouped`` (several segments) launches
  ``csrc/stuff.cu``, the port of ``_compact_stuff_kernel_gkb``, one thread
  block per segment; its glue ``stuff_precompute`` gives each segment's
  stuffed start.

On CPU tensors each wrapper runs its plain twin (``*_plain``). Both return
one contiguous u8 buffer whose first ``total`` bytes are the scan.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from jpegtpu_torch.entropy import assemble
from jpegtpu_torch.kernels import _build

CHUNK_WORDS = 1024                  # one 4 KB chunk of segment words
CHUNK_BYTES = 4 * CHUNK_WORDS

STUFF = _build.Kernel("jt_stuff_segments", [
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # words, nbytes, start, out
    _build.I64, _build.I64, _build.I32])               # n_seg, stride, markers

STUFF_CHUNKS = _build.Kernel("jt_stuff_chunks", [
    _build.PTR, _build.PTR, _build.PTR,   # words, chunk_off, in_chunk
    _build.PTR, _build.PTR, _build.PTR,   # seg_end, nchunks, mnum
    _build.PTR,                           # out
    _build.I64, _build.I64, _build.I64])  # n_seg, stride, chunks a segment


def scan_capacity(n_seg: int, seg_words: int) -> int:
    """Bytes that hold any scan of n_seg segments of seg_words words: every
    byte stuffed, plus one 2-byte RST marker per segment."""
    return n_seg * (8 * seg_words + 2)


@functools.lru_cache(maxsize=64)
def marker_table(n_seg: int, restart: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """mnum [n_seg] int32: the second byte of the RST marker after each
    segment, 0xD0 + s % 8, and 0 (no marker) after the last segment or when
    restart is 0 (``compact.py:942-947``, one image). Cached: callers must
    not write to it."""
    s = torch.arange(n_seg, dtype=torch.int32, device=device)
    keep = (s != n_seg - 1) & (restart > 0)
    return torch.where(keep, 0xD0 + s % 8, 0).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _stream_pos(n_words: int, device: torch.device) -> torch.Tensor:
    """[4 * n_words] int64: the stream position of each byte of n_words
    big-endian words in memory order (byte i of word j is stream byte
    4j + 3 - i). Cached per device, so that the glue launches no kernel to
    build it; int64 like the byte counts it meets, so that no comparison
    casts."""
    j = torch.arange(n_words, device=device)
    return (4 * j[:, None] + 3 - torch.arange(4, device=device)).reshape(-1)


@functools.lru_cache(maxsize=64)
def _chunk_starts(f: int, device: torch.device) -> torch.Tensor:
    """[f] int64: the first stream byte of each of f chunks (cached)."""
    return CHUNK_BYTES * torch.arange(f, device=device)


def _ff_per_chunk(seg_words: torch.Tensor,
                  left: torch.Tensor) -> torch.Tensor:
    """[n_seg, f] int64: the 0xFF bytes of each 1024-word chunk among its
    first left[s, c] bytes (the segment's bytes from the chunk's start on),
    in one pass over a byte view of the words."""
    n_seg, w = seg_words.shape
    f = left.shape[1]
    if w != f * CHUNK_WORDS:
        seg_words = torch.nn.functional.pad(seg_words,
                                            (0, f * CHUNK_WORDS - w))
    by = seg_words.contiguous().view(torch.uint8).reshape(n_seg, f,
                                                          CHUNK_BYTES)
    pos = _stream_pos(CHUNK_WORDS, seg_words.device)
    return ((by == 0xFF) & (pos < left[:, :, None])).sum(dim=2)


def _bytes_left(seg_words: torch.Tensor,
                seg_bits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nbytes [n_seg] int64, the segment's bytes from each chunk's start
    on [n_seg, f] int64, negative past the end)."""
    f = max(1, -(-seg_words.shape[1] // CHUNK_WORDS))
    nbytes = (seg_bits.to(torch.int64) + 7) >> 3
    return nbytes, nbytes[:, None] - _chunk_starts(f, seg_words.device)


def stuff_precompute(seg_words: torch.Tensor, seg_bits: torch.Tensor,
                     restart: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """(nbytes [n_seg] int32, 0xFF count [n_seg] int64, stuffed start
    [n_seg] int64, total bytes int64 scalar) of the scan that
    ``compact_segments_stuffed_grouped`` writes."""
    n_seg, w = seg_words.shape
    nbytes = (seg_bits.to(torch.int64) + 7) >> 3
    # The 0xFF bytes among each segment's first nbytes, in one pass over a
    # byte view of the words (no chunk view: these buffers are not whole
    # chunks).
    by = seg_words.contiguous().view(torch.uint8)
    ffc = ((by == 0xFF) & (_stream_pos(w, seg_words.device) < nbytes[:, None])
           ).sum(dim=1)
    # A 2-byte RST marker follows every segment but the last.
    mnum = marker_table(n_seg, restart, device=seg_words.device)
    seg_len = nbytes + ffc + 2 * (mnum > 0)
    seg_start = torch.cumsum(seg_len, dim=0) - seg_len
    return nbytes.to(torch.int32), ffc, seg_start, seg_len.sum()


def stuff_precompute_chunks(seg_words: torch.Tensor, seg_bits: torch.Tensor,
                            mnum: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """The chunk tables of ``compact_segments_stuffed`` (jpegtpu's
    ``_stuff_precompute``, ``compact.py:192-231``), for segment words
    [n_seg, W] cut into f = ceil(W / 1024) chunks of 1024 words:

        chunk_off [n_seg, f] int64  stuffed output offset of each chunk
        out_chunk [n_seg, f] int64  stuffed bytes of each chunk
        in_chunk  [n_seg, f] int32  valid input bytes of each chunk
        seg_end   [n_seg]    int64  where the segment's RST marker goes
        nchunks   [n_seg]    int32  chunks holding valid bytes
        seg_start [n_seg]    int64  stuffed start of each segment
        total     scalar     int64  bytes in the scan

    Bytes past a segment's byte count are neither copied nor counted."""
    nbytes, left = _bytes_left(seg_words, seg_bits)
    in_chunk = torch.clamp(left, 0, CHUNK_BYTES)
    out_chunk = in_chunk + _ff_per_chunk(seg_words, left)
    seg_data = out_chunk.sum(dim=1)
    seg_len = seg_data + 2 * (mnum.to(seg_words.device) > 0)
    seg_start = torch.cumsum(seg_len, dim=0) - seg_len
    chunk_off = seg_start[:, None] + torch.cumsum(out_chunk, dim=1) - out_chunk
    nchunks = (nbytes + CHUNK_BYTES - 1) // CHUNK_BYTES
    return (chunk_off, out_chunk, in_chunk.to(torch.int32),
            seg_start + seg_data, nchunks.to(torch.int32), seg_start,
            seg_len.sum())


def compact_segments_stuffed_plain(seg_words: torch.Tensor,
                                   seg_bits: torch.Tensor, restart: int,
                                   mnum: torch.Tensor | None = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the chunk stuffing kernel, on the same chunk tables:
    byte i of chunk c of segment s lands at chunk_off[s, c] + i + (#0xFF
    before i in the chunk); the 0x00 after each 0xFF comes from the
    zero-filled output; 0xFF, mnum[s] goes to seg_end[s] where mnum[s] != 0."""
    n_seg, w = seg_words.shape
    dev = seg_words.device
    if mnum is None:
        mnum = marker_table(n_seg, restart, device=dev)
    chunk_off, _, in_chunk, seg_end, _, _, total = stuff_precompute_chunks(
        seg_words, seg_bits, mnum)
    f = chunk_off.shape[1]
    by = assemble.explode_bytes(seg_words)
    by = torch.nn.functional.pad(by, (0, f * CHUNK_BYTES - 4 * w)).reshape(
        n_seg, f, CHUNK_BYTES)
    i = torch.arange(CHUNK_BYTES, device=dev)
    valid = i < in_chunk[:, :, None]
    is_ff = ((by == 0xFF) & valid).to(torch.int64)
    pos = chunk_off[:, :, None] + i + torch.cumsum(is_ff, dim=2) - is_ff
    out = torch.zeros(scan_capacity(n_seg, w), dtype=torch.uint8, device=dev)
    out[pos[valid]] = by[valid].to(torch.uint8)
    marked = mnum.to(dev) > 0
    out[seg_end[marked]] = 0xFF
    out[seg_end[marked] + 1] = mnum.to(dev)[marked].to(torch.uint8)
    return out, total


def compact_segments_stuffed(seg_words: torch.Tensor, seg_bits: torch.Tensor,
                             restart: int, mnum: torch.Tensor | None = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment streams [n_seg, W] int32 (u32 bit patterns, 1-padded) and
    seg_bits [n_seg] -> (u8 buffer [n_seg*(8W+2)], total bytes int64
    scalar), in one chain of 4 KB chunks, each chunk its own thread block.
    mnum [n_seg] (default ``marker_table(n_seg, restart)``) is the RST
    marker byte after each segment, 0 for none. The scan is the buffer's
    first ``total`` bytes; bytes past it are unspecified."""
    if seg_words.device.type == "cpu":
        return compact_segments_stuffed_plain(seg_words, seg_bits, restart,
                                              mnum)
    n_seg, w = seg_words.shape
    seg_words = seg_words.to(torch.int32).contiguous()
    mnum = (marker_table(n_seg, restart, device=seg_words.device)
            if mnum is None else mnum.to(torch.int32).contiguous())
    if mnum.shape != (n_seg,):
        raise ValueError(f"mnum must be [{n_seg}], got {tuple(mnum.shape)}")
    chunk_off, _, in_chunk, seg_end, nchunks, _, total = \
        stuff_precompute_chunks(seg_words, seg_bits, mnum)
    _build.check_cuda(seg_words, chunk_off, in_chunk, seg_end, nchunks, mnum)
    out = torch.empty(scan_capacity(n_seg, w), dtype=torch.uint8,
                      device=seg_words.device)
    STUFF_CHUNKS.launch(seg_words.data_ptr(), chunk_off.data_ptr(),
                        in_chunk.data_ptr(), seg_end.data_ptr(),
                        nchunks.data_ptr(), mnum.data_ptr(), out.data_ptr(),
                        n_seg, w, chunk_off.shape[1])
    return out, total


def compact_segments_stuffed_grouped_plain(seg_words: torch.Tensor,
                                           seg_bits: torch.Tensor,
                                           restart: int
                                           ) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Plain twin of the per-segment stuffing kernel: explode the words to
    bytes, then scatter them to their stuffed positions and splice the RST
    markers (``assemble.stuff_and_splice``)."""
    n_seg, w = seg_words.shape
    nbytes, _, seg_start, total = stuff_precompute(seg_words, seg_bits,
                                                   restart)
    out = assemble.stuff_and_splice(
        assemble.explode_bytes(seg_words), nbytes.to(torch.int64),
        seg_start, restart, scan_capacity(n_seg, w))
    return out, total


def compact_segments_stuffed_grouped(seg_words: torch.Tensor,
                                     seg_bits: torch.Tensor, restart: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """As ``compact_segments_stuffed`` (RST 0xD0 + s % 8 after every segment
    but the last when restart > 0), with one thread block per segment."""
    if seg_words.device.type == "cpu":
        return compact_segments_stuffed_grouped_plain(seg_words, seg_bits,
                                                      restart)
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
