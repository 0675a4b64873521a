"""Device compaction and stuffing: segment bitstreams -> the finished
entropy-coded scan, or the segments' bytes back to back for the host to
stuff (counterpart of ``jpegtpu.kernels.compact``).

Two stuffing wrappers, as in jpegtpu, chosen by the encoder from the
segment count, launch one kernel body, ``csrc/stuff.cu``: a single pass
over the segment words in 4 KB tiles in stream order, each tile counting
its own 0xFF bytes and learning its output offset from the tiles before it
by a decoupled look-back. Neither runs any glue on the card: the words,
bit counts and marker table go in, the scan and its bounds come out.

- ``compact_segments_stuffed`` (one segment, or any count in one chain)
  launches ``jt_stuff_chunks``, the port of ``_compact_stuff_kernel`` /
  ``_compact_stuff_kernel_kb``.
- ``compact_segments_stuffed_grouped`` (several segments) launches
  ``jt_stuff_segments``, the port of ``_compact_stuff_kernel_gkb``, and
  also gives each image's first byte (a batch is one scan of whole image
  scans, its RST markers numbered within each image).

Both return one contiguous u8 buffer whose first ``total`` bytes are the
scan. Their plain twins (``*_plain``) stay on jpegtpu's two-step form:
the tables of ``stuff_precompute`` / ``stuff_precompute_chunks`` (jpegtpu's
``_stuff_precompute``), then a scatter. With ``device_stuff=False`` the
encoder takes ``compact_segments`` instead, which launches
``csrc/compact.cu``, the port of ``_compact_kernel``: each segment trimmed
to its bytes, the segments joined with no stuffing and no markers, one
thread block per (segment, 4 KB chunk) at offsets from a cumsum of the
byte counts. On CPU tensors each wrapper runs its plain twin.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from jpegtpu_torch.entropy import assemble
from jpegtpu_torch.kernels import _build

CHUNK_WORDS = 1024                  # one 4 KB chunk of segment words
CHUNK_BYTES = 4 * CHUNK_WORDS

# The two launchers of csrc/stuff.cu's one kernel body.
_STUFF_ARGS = [_build.PTR, _build.PTR, _build.PTR,   # words, bits, mnum
               _build.PTR, _build.PTR, _build.PTR,   # out, bounds, scratch
               _build.I64, _build.I64]               # n_seg, stride
STUFF = _build.Kernel("jt_stuff_segments",
                      _STUFF_ARGS + [_build.I64])    # + segments an image
STUFF_CHUNKS = _build.Kernel("jt_stuff_chunks", _STUFF_ARGS)
# int64 words of the stuffing kernel's scratch before its status words (the
# ticket counter, then padding); csrc/stuff.cu's kScratchHead.
STUFF_SCRATCH_HEAD = 16

COMPACT = _build.Kernel("jt_compact_segments", [
    _build.PTR, _build.PTR, _build.PTR, _build.PTR,   # words, nbytes, off, out
    _build.I64, _build.I64, _build.I64])  # n_seg, stride, chunks a segment


def scan_capacity(n_seg: int, seg_words: int) -> int:
    """Bytes that hold any scan of n_seg segments of seg_words words: every
    byte stuffed, plus one 2-byte RST marker per segment."""
    return n_seg * (8 * seg_words + 2)


def stuff_tiles(n_seg: int, seg_words: int) -> int:
    """4 KB chunks of n_seg segments of seg_words words, ceil(seg_words /
    1024) each (at least one): the most tiles the stuffing kernel's chain
    can hold, each with a status word in its scratch."""
    return n_seg * max(1, -(-seg_words // CHUNK_WORDS))


def stuff_scratch_words(n_seg: int, seg_words: int) -> int:
    """int64 words of the stuffing kernel's scratch: the ticket counter and
    its padding, then one status word a chunk."""
    return STUFF_SCRATCH_HEAD + stuff_tiles(n_seg, seg_words)


def stuff_launcher(n_seg: int, grouped: bool) -> _build.Kernel:
    """The stuffing launcher of a scan of n_seg segments: one chain of 4 KB
    tiles (K5, ``compact_segments_stuffed``) for a single image's one
    segment, else the segments' (K4, ``compact_segments_stuffed_grouped``),
    which a batch (grouped) always takes."""
    return STUFF_CHUNKS if n_seg == 1 and not grouped else STUFF


@functools.lru_cache(maxsize=64)
def marker_table(n_seg: int, restart: int, segs_per_image: int | None = None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """mnum [n_seg] int32: the second byte of the RST marker after each
    segment, 0 for none (``compact.py:942-947``). The n_seg segments are
    images of spi = segs_per_image segments each (default one image):
    segment s is number s % spi of its image, followed by 0xD0 + (s % spi)
    % 8, except an image's last segment, and none at all when restart is 0.
    Cached: callers must not write to it."""
    spi = segs_per_image or n_seg
    if n_seg % spi:
        raise ValueError(f"{n_seg} segments are not whole images of {spi}")
    within = torch.arange(n_seg, dtype=torch.int32, device=device) % spi
    keep = (within != spi - 1) & (restart > 0)
    return torch.where(keep, 0xD0 + within % 8, 0).to(torch.int32)


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
                     mnum: torch.Tensor, segs_per_image: int | None = None
                     ) -> Tuple[torch.Tensor, ...]:
    """(nbytes [n_seg] int32, 0xFF count [n_seg] int64, stuffed start
    [n_seg] int64, each image's first byte ``img_off`` [n_seg / spi]
    int64, total bytes int64 scalar) of the scan that
    ``compact_segments_stuffed_grouped`` writes with marker table mnum, for
    images of spi = segs_per_image segments (default one image); the
    plain twin's tables."""
    n_seg, w = seg_words.shape
    nbytes = (seg_bits.to(torch.int64) + 7) >> 3
    # The 0xFF bytes among each segment's first nbytes, in one pass over a
    # byte view of the words (no chunk view: these buffers are not whole
    # chunks).
    by = seg_words.contiguous().view(torch.uint8)
    ffc = ((by == 0xFF) & (_stream_pos(w, seg_words.device) < nbytes[:, None])
           ).sum(dim=1)
    # A 2-byte RST marker follows each segment with a marker number.
    seg_len = nbytes + ffc + 2 * (mnum > 0)
    seg_start = torch.cumsum(seg_len, dim=0) - seg_len
    return (nbytes.to(torch.int32), ffc, seg_start,
            seg_start[::segs_per_image or n_seg], seg_len.sum())


def stuff_precompute_chunks(seg_words: torch.Tensor, seg_bits: torch.Tensor,
                            mnum: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """The chunk tables of ``compact_segments_stuffed``'s plain twin
    (jpegtpu's ``_stuff_precompute``, ``compact.py:192-231``), for segment
    words [n_seg, W] cut into f = ceil(W / 1024) chunks of 1024 words
    (chunk_off is the kernel's exclusive tile prefix):

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
    scalar), in one chain of 4 KB tiles (``jt_stuff_chunks``). mnum
    [n_seg] (default ``marker_table(n_seg, restart)``) is the RST marker
    byte after each segment, 0 for none. The scan is the buffer's first
    ``total`` bytes; bytes past it are unspecified."""
    if seg_words.device.type == "cpu":
        return compact_segments_stuffed_plain(seg_words, seg_bits, restart,
                                              mnum)
    n_seg = seg_words.shape[0]
    if mnum is None:
        mnum = marker_table(n_seg, restart, device=seg_words.device)
    out, bounds = _stuff(STUFF_CHUNKS, seg_words, seg_bits, mnum, 1)
    return out, bounds[-1]


def compact_segments_stuffed_grouped_plain(seg_words: torch.Tensor,
                                           seg_bits: torch.Tensor,
                                           restart: int,
                                           segs_per_image: int | None = None
                                           ) -> Tuple[torch.Tensor, ...]:
    """Plain twin of the per-segment stuffing kernel: explode the words to
    bytes, then scatter them to their stuffed positions and splice the RST
    markers (``assemble.stuff_and_splice``)."""
    n_seg, w = seg_words.shape
    mnum = marker_table(n_seg, restart, segs_per_image, seg_words.device)
    nbytes, _, seg_start, img_off, total = stuff_precompute(
        seg_words, seg_bits, mnum, segs_per_image)
    out = assemble.stuff_and_splice(
        assemble.explode_bytes(seg_words), nbytes.to(torch.int64),
        seg_start, mnum, scan_capacity(n_seg, w))
    return out, total, img_off


def compact_segments_stuffed_grouped(seg_words: torch.Tensor,
                                     seg_bits: torch.Tensor, restart: int,
                                     segs_per_image: int | None = None
                                     ) -> Tuple[torch.Tensor, ...]:
    """As ``compact_segments_stuffed`` (``jt_stuff_segments``), for images
    of segs_per_image segments each (default one image): RST
    0xD0 + i % 8 after segment i of an image but its last, when restart >
    0 (``marker_table``). Returns (u8 buffer, total bytes int64 scalar,
    each image's first byte in the scan [n_seg / segs_per_image] int64)."""
    if seg_words.device.type == "cpu":
        return compact_segments_stuffed_grouped_plain(seg_words, seg_bits,
                                                      restart, segs_per_image)
    n_seg = seg_words.shape[0]
    spi = segs_per_image or n_seg
    mnum = marker_table(n_seg, restart, segs_per_image, seg_words.device)
    out, bounds = _stuff(STUFF, seg_words, seg_bits, mnum, n_seg // spi, spi)
    return out, bounds[-1], bounds[:-1]


def _stuff(kernel: _build.Kernel, seg_words: torch.Tensor,
           seg_bits: torch.Tensor, mnum: torch.Tensor, n_img: int, *extra
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one of csrc/stuff.cu's launchers on CUDA tensors: (u8 scan
    buffer, bounds [n_img + 1] int64, each image's first byte then the
    total). Nothing runs on the card but the kernel and the memset of its
    scratch (the casts are no-ops for the encoder's int32 inputs)."""
    n_seg, w = seg_words.shape
    seg_words = seg_words.to(torch.int32).contiguous()
    seg_bits = seg_bits.to(torch.int32).contiguous()
    mnum = mnum.to(torch.int32).contiguous()
    for name, t in (("seg_bits", seg_bits), ("mnum", mnum)):
        if t.shape != (n_seg,):
            raise ValueError(f"{name} must be [{n_seg}], got "
                             f"{tuple(t.shape)}")
    _build.check_cuda(seg_words, seg_bits, mnum)
    dev = seg_words.device
    out = torch.empty(scan_capacity(n_seg, w), dtype=torch.uint8, device=dev)
    if n_seg == 0:                  # no tiles, so nothing to launch
        return out, torch.zeros(n_img + 1, dtype=torch.int64, device=dev)
    bounds = torch.empty(n_img + 1, dtype=torch.int64, device=dev)
    scratch = torch.empty(stuff_scratch_words(n_seg, w), dtype=torch.int64,
                          device=dev)
    kernel.launch(dev, seg_words.data_ptr(), seg_bits.data_ptr(),
                  mnum.data_ptr(), out.data_ptr(), bounds.data_ptr(),
                  scratch.data_ptr(), n_seg, w, *extra)
    return out, bounds


def compact_offsets(seg_bits: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nbytes [n_seg] int64, each segment's first byte in the compacted
    stream [n_seg] int64): ceil(bits / 8) and its exclusive cumsum."""
    nbytes = (seg_bits.to(torch.int64) + 7) >> 3
    return nbytes, torch.cumsum(nbytes, dim=0) - nbytes


def compact_segments_plain(seg_words: torch.Tensor, seg_bits: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the compaction kernel: explode the words to bytes and
    keep each segment's first nbytes in row-major order, which is stream
    order."""
    n_seg, w = seg_words.shape
    nbytes, _ = compact_offsets(seg_bits)
    by = assemble.explode_bytes(seg_words)
    keep = torch.arange(4 * w, device=by.device) < nbytes[:, None]
    kept = by[keep].to(torch.uint8)
    out = torch.zeros(4 * n_seg * w, dtype=torch.uint8, device=by.device)
    out[:kept.numel()] = kept
    return out, nbytes


def compact_segments(seg_words: torch.Tensor, seg_bits: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment streams [n_seg, W] int32 (u32 bit patterns, the last byte
    1-padded) and seg_bits [n_seg] (at most 32 W each) -> (u8 buffer
    [4 n_seg W], nbytes [n_seg] int64): each segment trimmed to
    ceil(bits / 8) bytes and the segments joined back to back in stream
    byte order, with no stuffing and no markers. The stream is the
    buffer's first ``sum(nbytes)`` bytes; bytes past it are unspecified.
    Launches ``csrc/compact.cu`` on CUDA tensors, one thread block per
    (segment, 4 KB chunk)."""
    if seg_words.device.type == "cpu":
        return compact_segments_plain(seg_words, seg_bits)
    n_seg, w = seg_words.shape
    seg_words = seg_words.to(torch.int32).contiguous()
    nbytes, off = compact_offsets(seg_bits)
    _build.check_cuda(seg_words, nbytes, off)
    out = torch.empty(4 * n_seg * w, dtype=torch.uint8,
                      device=seg_words.device)
    COMPACT.launch(out.device, seg_words.data_ptr(), nbytes.data_ptr(),
                   off.data_ptr(), out.data_ptr(), n_seg, w,
                   -(-w // CHUNK_WORDS))
    return out, nbytes
