"""A plain baseline JPEG encoder in torch: the benchmark's reference.

``scan(img, quality, mode, restart)`` gives the entropy-coded scan of one
uint8 RGB image [H, W, 3], stuffed, with its RST markers; ``jfif(...)``
wraps it in a complete file. The steps are the textbook ones, written
from ITU-T T.81 and vectorised over the whole image:

1. mirror-pad to whole MCUs (numpy's ``symmetric``; ``edge`` where a pad is
   as long as its axis), cut into MCUs, and map each MCU's pixels to its
   blocks' quantized zigzag coefficients by the affine operator of
   ``tables.mcu_operator``, rounding half away from zero. The product runs
   in ``dtype``: float64 makes it exact (the products of u8 pixels and
   float32 entries and their sums are exact in float64); float32, the
   control, rounds some coefficients near x.5 the other way;
2. code each block (F.1.2): the DC difference from the previous block of
   its component, reset at each restart segment, then each nonzero AC
   coefficient with its run of zeros (ZRL for each 16) and an EOB where
   the block ends in zeros;
3. concatenate the codes of each restart segment, pad it with 1-bits to a
   byte, put a 0x00 after every 0xFF byte and an RSTn marker (n = segment
   index mod 8) between segments (B.1.1.5, F.1.2.3).

It runs on whatever device ``img`` is on, and imports nothing of the
program under test.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from portbench.reference import tables


def _pad_index(n: int, pad: int, symmetric: bool) -> np.ndarray:
    i = np.arange(n + pad)
    return np.where(i < n, i, 2 * n - 1 - i) if symmetric else np.minimum(
        i, n - 1)


def mcu_grid(h: int, w: int, mode: str) -> tuple:
    (mh, mw), _ = tables.MODES[mode]
    return -(-h // mh), -(-w // mw)


def coefficients(img: torch.Tensor, quality: int, mode: str,
                 dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """uint8 [H, W, 3] -> int64 [MCUs, blocks * 64] quantized zigzag
    coefficients, MCUs in raster order."""
    (mh, mw), _ = tables.MODES[mode]
    h, w, _ = img.shape
    ph, pw = (-h) % mh, (-w) % mw
    sym = not (ph >= h or pw >= w)
    dev = img.device
    x = img.index_select(0, torch.from_numpy(_pad_index(h, ph, sym)).to(dev))
    x = x.index_select(1, torch.from_numpy(_pad_index(w, pw, sym)).to(dev))
    ny, nx = (h + ph) // mh, (w + pw) // mw
    tiles = x.reshape(ny, mh, nx, mw, 3).transpose(1, 2).reshape(
        ny * nx, mh * mw * 3)
    m, bias = (torch.from_numpy(a).to(dev, dtype)
               for a in tables.mcu_operator(quality, mode))
    y = tiles.to(dtype) @ m + bias
    return (torch.sign(y) * torch.floor(y.abs() + 0.5)).to(torch.int64)


def _size(v: torch.Tensor) -> torch.Tensor:
    """Bits of |v| (the size category of F.1.2.1.1)."""
    a = v.abs()
    s = torch.zeros_like(a)
    while bool((a > 0).any()):
        s += (a > 0).to(a.dtype)
        a = a >> 1
    return s


def _magnitude(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """The size low bits that follow a code: v, or v - 1 in ones'
    complement for v < 0."""
    return torch.where(v < 0, v + (1 << size) - 1, v)


def _luts(device):
    def pair(table):
        return tuple(torch.from_numpy(a).to(device)
                     for a in tables.huffman_codes(table))
    return ([pair(tables.DC_LUMA), pair(tables.DC_CHROMA)],
            [pair(tables.AC_LUMA), pair(tables.AC_CHROMA)])


def block_codes(coeffs: torch.Tensor, n_luma: int, restart: int
                ) -> tuple:
    """int64 [MCUs, B * 64] -> (values, lengths) int64 [MCUs * B, 65]: each
    block's codes in stream order, slot 0 the DC code, slot k in 1..63 the
    code of the AC coefficient k with the ZRLs before it, slot 64 the EOB;
    length 0 where a slot emits nothing."""
    n, width = coeffs.shape
    nb = width // 64
    dev = coeffs.device
    c = coeffs.reshape(n, nb, 64)
    dc_luts, ac_luts = _luts(dev)
    # DC differences per component; the predictor is 0 at a segment start.
    dc = c[:, :, 0]
    seg_start = torch.zeros(n, dtype=torch.bool, device=dev)
    seg_start[::restart if restart > 0 else n] = True
    diff = torch.empty_like(dc)
    comps = [list(range(n_luma))] + [[k] for k in range(n_luma, nb)]
    for cols in comps:
        v = dc[:, cols].reshape(-1)
        prev = torch.cat([v.new_zeros(1), v[:-1]])
        first = torch.zeros(n, len(cols), dtype=torch.bool, device=dev)
        first[:, 0] = seg_start
        prev = torch.where(first.reshape(-1), torch.zeros_like(prev), prev)
        diff[:, cols] = (v - prev).reshape(n, len(cols))
    chroma = torch.arange(nb, device=dev) >= n_luma          # [B]
    chroma = chroma.expand(n, nb).reshape(-1)
    c = c.reshape(n * nb, 64)
    diff = diff.reshape(-1)

    def lut(pairs, idx):
        code = torch.where(chroma[:, None] if idx.dim() > 1 else chroma,
                           pairs[1][0][idx], pairs[0][0][idx])
        ln = torch.where(chroma[:, None] if idx.dim() > 1 else chroma,
                         pairs[1][1][idx], pairs[0][1][idx])
        return code, ln

    ds = _size(diff)
    dcode, dlen = lut(dc_luts, ds)
    values = torch.zeros(n * nb, 65, dtype=torch.int64, device=dev)
    lengths = torch.zeros_like(values)
    values[:, 0] = (dcode << ds) | _magnitude(diff, ds)
    lengths[:, 0] = dlen + ds

    ac = c[:, 1:]
    pos = torch.arange(1, 64, device=dev).expand_as(ac)
    nz = ac != 0
    last = torch.cummax(torch.where(nz, pos, torch.zeros_like(pos)), dim=1)[0]
    before = torch.cat([torch.zeros_like(last[:, :1]), last[:, :-1]], dim=1)
    run = pos - before - 1
    size = _size(ac)
    code, clen = lut(ac_luts, ((run % 16) << 4) | size.clamp(max=15))
    zcode, zlen = lut(ac_luts, torch.full_like(ac, 0xF0))
    val = torch.zeros_like(ac)
    length = torch.zeros_like(ac)
    for k in range(3):                      # a run of up to 62 zeros
        more = (run // 16) > k
        val = torch.where(more, (val << zlen) | zcode, val)
        length = length + torch.where(more, zlen, 0)
    val = (((val << clen) | code) << size) | _magnitude(ac, size)
    length = length + clen + size
    values[:, 1:64] = torch.where(nz, val, 0)
    lengths[:, 1:64] = torch.where(nz, length, 0)
    eob = last[:, -1] < 63
    ecode, elen = lut(ac_luts, torch.zeros_like(diff))
    values[:, 64] = torch.where(eob, ecode, 0)
    lengths[:, 64] = torch.where(eob, elen, 0)
    return values, lengths


def _pack(values: torch.Tensor, lengths: torch.Tensor, starts: torch.Tensor,
          n_bytes: int) -> torch.Tensor:
    """Write each code (MSB first, up to 63 bits) at its bit offset into a
    zeroed big-endian bit string of n_bytes -> uint8 [n_bytes]. The bit
    ranges are disjoint, so adding is or-ing."""
    words = torch.zeros(n_bytes // 4 + 4, dtype=torch.int64,
                        device=values.device)
    w0 = starts >> 5
    end = (starts & 31) + lengths        # end of the code within word w0
    for j in range(3):
        lo, hi = 32 * j, 32 * (j + 1)
        inside = end > lo
        if j:
            inside &= (starts & 31) < hi
        # The code's bits that fall in [lo, hi) of its window, at their
        # places in that word.
        right = torch.clamp(end - hi, min=0)
        part = values >> right
        keep = torch.clamp(end - lo, max=32) - torch.clamp(
            (starts & 31) - lo, min=0).clamp(max=32)
        part = part & ((1 << keep.clamp(min=0)) - 1)
        part = part << torch.clamp(hi - end, min=0)
        words.index_add_(0, (w0 + j)[inside], part[inside])
    shifts = torch.tensor([24, 16, 8, 0], device=values.device)
    by = (words[:, None] >> shifts) & 0xFF
    return by.reshape(-1)[:n_bytes].to(torch.uint8)


def scan(img: torch.Tensor, quality: int, mode: str, restart: int,
         dtype: torch.dtype = torch.float64) -> bytes:
    """The stuffed entropy-coded scan of img, restart segments of
    `restart` MCUs (0: one segment, no markers)."""
    coeffs = coefficients(img, quality, mode, dtype)
    n = coeffs.shape[0]
    values, lengths = block_codes(coeffs, tables.MODES[mode][1], restart)
    nb = coeffs.shape[1] // 64
    per = restart if restart > 0 else n
    seg = torch.arange(n, device=coeffs.device) // per        # per MCU
    seg = seg.repeat_interleave(nb * 65)
    lengths = lengths.reshape(-1)
    values = values.reshape(-1)
    n_seg = -(-n // per)
    seg_bits = torch.zeros(n_seg, dtype=torch.int64, device=coeffs.device)
    seg_bits.index_add_(0, seg, lengths)
    seg_bytes = (seg_bits + 7) // 8
    seg_first = torch.cumsum(seg_bytes, 0) - seg_bytes        # byte offset
    bit_first = torch.cumsum(seg_bits, 0) - seg_bits          # unpadded
    starts = (torch.cumsum(lengths, 0) - lengths - bit_first[seg]
              + 8 * seg_first[seg])
    pad = seg_bytes * 8 - seg_bits
    values = torch.cat([values, (1 << pad) - 1])
    starts = torch.cat([starts, 8 * seg_first + seg_bits])
    lengths = torch.cat([lengths, pad])
    live = lengths > 0
    total = int(seg_bytes.sum())
    raw = _pack(values[live], lengths[live], starts[live], total)
    # Stuffing and markers: byte i moves past the 0x00s before it and past
    # two marker bytes for each segment before its own.
    ff = raw == 0xFF
    byte_seg = torch.repeat_interleave(
        torch.arange(n_seg, device=raw.device), seg_bytes)
    stuffed = torch.cumsum(ff.to(torch.int64), 0) - ff.to(torch.int64)
    dest = torch.arange(total, device=raw.device) + stuffed + 2 * byte_seg
    size = total + int(ff.sum()) + 2 * (n_seg - 1)
    out = torch.zeros(size, dtype=torch.uint8, device=raw.device)
    out[dest] = raw
    ends = torch.cumsum(seg_bytes, 0)[:-1] - 1                # last bytes
    mark = dest[ends] + 1 + ff[ends].to(torch.int64)
    out[mark] = 0xFF
    out[mark + 1] = (0xD0 + torch.arange(n_seg - 1, device=raw.device) % 8
                     ).to(torch.uint8)
    return out.cpu().numpy().tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def jfif(height: int, width: int, quality: int, mode: str, restart: int,
         scan_bytes: bytes) -> bytes:
    """A complete JFIF file around a scan (B.2, JFIF 1.01): SOI, APP0, one
    DQT with both tables, SOF0, one DHT with the four tables, DRI when
    restart > 0, SOS, the scan, EOI."""
    zz = tables.zigzag()
    dqt = b"".join(bytes([tid]) + bytes(
        int(v) for v in tables.scaled_quant(chroma, quality).reshape(64)[zz])
        for tid, chroma in ((0, False), (1, True)))
    luma = {"420": 0x22, "422": 0x21}.get(mode, 0x11)
    sof = struct.pack(">BHHB", 8, height, width, 3) + bytes(
        [1, luma, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(bytes([cls]) + bytes(t[0]) + bytes(t[1]) for cls, t in (
        (0x00, tables.DC_LUMA), (0x10, tables.AC_LUMA),
        (0x01, tables.DC_CHROMA), (0x11, tables.AC_CHROMA)))
    head = [b"\xFF\xD8",
            _segment(0xE0, b"JFIF\x00\x01\x01\x00" +
                     struct.pack(">HH", 1, 1) + b"\x00\x00"),
            _segment(0xDB, dqt), _segment(0xC0, sof), _segment(0xC4, dht)]
    if restart > 0:
        head.append(_segment(0xDD, struct.pack(">H", restart)))
    head.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                      0])))
    return b"".join(head) + scan_bytes + b"\xFF\xD9"


def restart_mcus(restart_interval, width: int, mode: str) -> int:
    """The restart interval in MCUs: "rows" is one MCU row."""
    if restart_interval == "rows":
        return mcu_grid(1, width, mode)[1]
    return int(restart_interval)


def encode(img: torch.Tensor, quality: int, mode: str, restart_interval,
           dtype: torch.dtype = torch.float64) -> bytes:
    """uint8 [H, W, 3] -> the complete JFIF file."""
    h, w, _ = img.shape
    restart = restart_mcus(restart_interval, w, mode)
    return jfif(h, w, quality, mode, restart,
                scan(img, quality, mode, restart, dtype))
