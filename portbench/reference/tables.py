"""The constant tables of baseline JPEG, and the per-MCU pixel operator.

ITU-T T.81 Annex K: the quantization matrices (K.1, K.2) with libjpeg's
quality scaling, and the four Huffman tables (K.3) with the canonical code
generation of Annex C. The pixel operator folds colour conversion (BT.601
full range), chroma averaging, the level shift, the 8x8 DCT, quantization
and the zigzag order into one affine map per MCU; its float32 entries are
built here from the formulas, in the same steps and roundings as the
encoder under test builds its own, so that the coefficients compare
exactly. Plain numpy; nothing here imports the program.
"""

from __future__ import annotations

import functools

import numpy as np

QUANT_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.int64)
QUANT_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99]] + [[99] * 8] * 4, dtype=np.int64)

# BT.601 full-range RGB -> YCbCr, rows r, g, b; columns Y, Cb, Cr.
CSC = np.array([[0.299, -0.168736, 0.5],
                [0.587, -0.331264, -0.418688],
                [0.114, 0.5, -0.081312]], dtype=np.float32)

# (number of codes of each length 1..16, symbols in code order), K.3.
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])

# MCU (height, width) and luma blocks per MCU of each mode the operator
# covers; 444s smooths chroma over 2x2 inside the operator (8-aligned
# images only).
MODES = {"420": ((16, 16), 4), "422": ((8, 16), 2), "444": ((8, 8), 1),
         "444s": ((8, 8), 1)}


def scaled_quant(chroma: bool, quality: int) -> np.ndarray:
    """The quantization matrix [8, 8] at a libjpeg quality 1..100."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    base = QUANT_CHROMA if chroma else QUANT_LUMA
    return np.clip((base * scale + 50) // 100, 1, 255)


def zigzag() -> np.ndarray:
    """zigzag()[z]: the row-major index of zigzag position z."""
    order = []
    for s in range(15):
        cells = [(s - j, j) for j in range(max(0, s - 7), min(s, 7) + 1)]
        order += [r * 8 + c for r, c in (cells[::-1] if s % 2 else cells)]
    return np.array(order)


def block_operator(chroma: bool, quality: int):
    """(m [64 samples, 64 zigzag coefficients] float32, bias [64] float32)
    of one 8x8 block: coefficient = round(samples @ m + bias)."""
    u = np.arange(8)[:, None]
    c = 0.5 * np.cos((2 * np.arange(8)[None, :] + 1) * u * np.pi / 16)
    c[0, :] *= 1.0 / np.sqrt(2.0)
    q = scaled_quant(chroma, quality).reshape(64).astype(np.float64)
    kq = (np.kron(c, c) / q[:, None])[zigzag(), :]
    bias = np.zeros(64)
    bias[0] = -(128.0 * 8.0) / q[0]
    return (np.ascontiguousarray(kq.T, dtype=np.float32),
            bias.astype(np.float32))


@functools.lru_cache(maxsize=8)
def mcu_operator(quality: int, mode: str):
    """(m [MCU pixels * 3, blocks * 64] float32, bias float32): the MCU's
    pixels (y, x, channel, row-major) to its blocks' zigzag coefficients in
    scan order (the luma blocks in raster order, then Cb, Cr)."""
    (mh, mw), n_luma = MODES[mode]
    m_l, b_l = (a.astype(np.float64) for a in block_operator(False, quality))
    m_c = block_operator(True, quality)[0].astype(np.float64)
    w = CSC.astype(np.float64)
    big = np.zeros((mh * mw * 3, (n_luma + 2) * 64))
    ys, xs = np.mgrid[0:mh, 0:mw]
    for ch in range(3):
        pix = (ys * mw + xs) * 3 + ch
        for blk in range(n_luma):
            by, bx = divmod(blk, mw // 8)
            sel = (slice(by * 8, by * 8 + 8), slice(bx * 8, bx * 8 + 8))
            samp = (ys[sel] % 8) * 8 + xs[sel] % 8
            big[pix[sel].ravel(), blk * 64:(blk + 1) * 64] += (
                w[ch, 0] * m_l[samp.ravel()])
        if mode == "420":
            sel, scale = m_c[((ys // 2) * 8 + xs // 2).ravel()], 0.25
        elif mode == "422":
            sel, scale = m_c[(ys * 8 + xs // 2).ravel()], 0.5
        elif mode == "444s":
            qy, qx = (ys // 2) * 2, (xs // 2) * 2
            sel = sum(m_c[((qy + dy) * 8 + qx + dx).ravel()]
                      for dy in (0, 1) for dx in (0, 1))
            scale = 0.25
        else:
            sel, scale = m_c[(ys * 8 + xs).ravel()], 1.0
        # The chroma offset of +128 cancels the level shift: no bias.
        for comp, blk in ((1, n_luma), (2, n_luma + 1)):
            big[pix.ravel(), blk * 64:(blk + 1) * 64] += (
                scale * w[ch, comp] * sel)
    bias = np.zeros(big.shape[1])
    for blk in range(n_luma):
        bias[blk * 64:(blk + 1) * 64] = b_l
    return big.astype(np.float32), bias.astype(np.float32)


def huffman_codes(table) -> tuple:
    """(codes [256] int64, lengths [256] int64) of a (bits, symbols) table,
    by symbol (Annex C.2)."""
    bits, vals = table
    codes, lengths = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]], lengths[vals[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return codes, lengths
