"""JFIF/JPEG marker-segment writer (ITU-T T.81 Annex B).

The reference computes Huffman bit-strings but never emits a decodable file —
no SOI/APP0/DQT/SOF0/DHT/SOS markers, no byte packing, no EOI (SURVEY §2.10
"Missing JPEG container", §7). This module is that missing container layer:
given geometry + tables + the packed entropy-coded scan, it produces a
complete baseline JFIF byte stream that any standard decoder accepts.

A copy of ``jpegtpu.container.jfif`` over the port's copied tables;
``tests/test_torch_tables.py`` pins its header bytes to the original's.
"""

from __future__ import annotations

import struct

from jpegtpu_torch.core import tables
from jpegtpu_torch.entropy import huffman_tables as ht

SOI = b"\xFF\xD8"
EOI = b"\xFF\xD9"


def _seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def app0_jfif() -> bytes:
    # JFIF 1.01, no density units, 1:1 aspect, no thumbnail.
    return _seg(0xE0, b"JFIF\x00" + bytes([1, 1, 0]) +
                struct.pack(">HH", 1, 1) + bytes([0, 0]))


def dqt(quality: int) -> bytes:
    """Both quantization tables (id 0 = luma, 1 = chroma), zigzag order,
    8-bit precision, in one DQT segment."""
    payload = b""
    for tid, chroma in ((0, False), (1, True)):
        tbl = tables.quant_table_zigzag(quality, chroma)
        payload += bytes([tid]) + bytes(int(x) for x in tbl)
    return _seg(0xDB, payload)


def sof0(height: int, width: int, subsampling: str) -> bytes:
    """Baseline DCT frame header. Component ids 1/2/3 = Y/Cb/Cr; sampling
    factors 2x2+1x1+1x1 for 4:2:0, all 1x1 for 4:4:4 (and the reference's
    smoothed '444s' mode, which is structurally 4:4:4 — SURVEY §2.3).
    'gray' emits a single-component frame."""
    if subsampling == "gray":
        comps = bytes([1, 0x11, 0])
        return _seg(0xC0, struct.pack(">BHHB", 8, height, width, 1) + comps)
    y_samp = {"420": 0x22, "422": 0x21}.get(subsampling, 0x11)
    comps = bytes([1, y_samp, 0, 2, 0x11, 1, 3, 0x11, 1])
    return _seg(0xC0, struct.pack(">BHHB", 8, height, width, 3) + comps)


def dht() -> bytes:
    """All four Annex-K Huffman tables in one DHT segment.

    Payload is BITS+HUFFVAL straight from jpegtpu_torch.entropy.huffman_tables —
    the same data the encoder's lookup arrays are generated from, so the file
    and the coder cannot disagree."""
    payload = b""
    for tc_th, tbl in ((0x00, ht.dc_table(False)), (0x10, ht.ac_table(False)),
                       (0x01, ht.dc_table(True)), (0x11, ht.ac_table(True))):
        payload += bytes([tc_th]) + tbl.dht_payload
    return _seg(0xC4, payload)


def dri(restart_interval: int) -> bytes:
    return _seg(0xDD, struct.pack(">H", restart_interval))


def sos(subsampling: str = "420") -> bytes:
    """Scan header: 3 interleaved components (Y tables 0/0, chroma 1/1) or
    a single luma component for 'gray'; spectral selection 0..63, no
    successive approximation (baseline)."""
    if subsampling == "gray":
        return _seg(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
    return _seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))


def wrap_jpeg(height: int, width: int, quality: int, subsampling: str,
              restart_interval: int, entropy_scan: bytes) -> bytes:
    """Assemble the complete file around an entropy-coded (stuffed) scan."""
    head = [SOI, app0_jfif(), dqt(quality),
            sof0(height, width, subsampling), dht()]
    if restart_interval > 0:
        head.append(dri(restart_interval))
    head.append(sos(subsampling))
    return b"".join(head) + entropy_scan + EOI
