"""Constant tables for the JPEG pixel path, and the fused block operator.

A numpy copy of ``jpegtpu.core.tables``: importing any ``jpegtpu`` module
imports the package ``__init__``, which imports JAX, and the port must run
where JAX is absent. ``tests/test_torch_tables.py`` pins every table here to
jpegtpu's own.

Capability parity (SURVEY §2.6-2.8): the reference carries the ITU-T T.81
Annex-K K.1/K.2 quantization matrices as compile-time constants
(src/utils.hpp:42-62), a textbook O(N^4) per-block DCT (src/utils.cpp:314-348)
and an arithmetic zigzag traversal (src/utils.cpp:539-551). It has *no*
quality scaling (SURVEY §2.7 notes its absence; BASELINE requires q=50/75/90).

TPU-native design — instead of translating those loops, the whole per-block
pixel path

    level-shift(-128) -> 2D DCT -> quantize(1/q) -> zigzag

is folded into ONE affine map per table class:

    coeff_zz = round( x_flat @ M + b )        # x_flat: [N, 64] raw samples

where M = P_zz · diag(1/q_zz) · (C (x) C) (a 64x64 constant, (x) = Kronecker)
and b folds the -128 level shift (which only touches the DC term, because the
DCT of a constant block is DC-only). ``fused_dctq.mcu_operator`` folds the
color transform and chroma subsampling in too, so a whole MCU is one product.
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# Annex K quantization matrices (ITU-T T.81 Tables K.1 / K.2), row-major u,v.
# Same values the reference embeds at src/utils.hpp:42-62.
# ---------------------------------------------------------------------------

QUANT_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.int32)

QUANT_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.int32)


def scale_quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg-style quality scaling (jcparam.c semantics).

    Absent from the reference (fixed 50% tables only — SURVEY §2.7); required
    by BASELINE.json's q=50/75/90 configs. quality=50 returns `base` exactly.
    """
    if not (1 <= quality <= 100):
        raise ValueError(f"quality must be 1..100, got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    tbl = (base.astype(np.int64) * scale + 50) // 100
    return np.clip(tbl, 1, 255).astype(np.int32)


# ---------------------------------------------------------------------------
# Zigzag scan. ZIGZAG_ORDER[z] = row-major index holding zigzag position z —
# the same permutation the reference computes arithmetically
# (src/utils.cpp:539-551) and embeds literally in its zigzagKernel
# (src/OpenCLProject_JpegEncoder.cl:185-192). Derived here, not copied.
# ---------------------------------------------------------------------------

def _make_zigzag_order() -> np.ndarray:
    order = []
    for s in range(15):                       # anti-diagonal index u+v = s
        rng = range(s + 1) if s < 8 else range(s - 7, 8)
        idx = [(s - j, j) for j in rng]       # (row, col) pairs on diagonal
        if s % 2 == 1:                        # odd diagonals walk top-down
            idx = idx[::-1]
        order.extend(r * 8 + c for r, c in idx)
    return np.array(order, dtype=np.int32)


ZIGZAG_ORDER = _make_zigzag_order()


# ---------------------------------------------------------------------------
# DCT basis.
# ---------------------------------------------------------------------------

def dct_matrix_8x8() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix C, float64.

    C[u, x] = 0.5 * a(u) * cos((2x+1) u pi / 16),  a(0)=1/sqrt(2) else 1.
    2D block DCT = C @ X @ C.T — exactly the quantity the reference's
    performDCTBlock computes with quadruple loops (src/utils.cpp:314-348,
    minus its in-place aliasing bug, which we deliberately do not reproduce).
    """
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    c[0, :] *= 1.0 / np.sqrt(2.0)
    return c


@functools.lru_cache(maxsize=32)
def fused_block_operator(quality: int, chroma: bool) -> tuple[np.ndarray, np.ndarray]:
    """(M, b) of the fused shift+DCT+quant+zigzag affine map, float32.

    coeff_zz[N,64] = round(x_flat[N,64] @ M + b) with x_flat raw 0..255
    samples of one component, row-major within the 8x8 block.
    """
    c = dct_matrix_8x8()
    k = np.kron(c, c)                                  # [64out, 64in]
    base = QUANT_CHROMA if chroma else QUANT_LUMA
    q = scale_quant_table(base, quality).reshape(64).astype(np.float64)
    kq = k / q[:, None]                                # quantize rows
    kq = kq[ZIGZAG_ORDER, :]                           # zigzag-order rows
    m = np.ascontiguousarray(kq.T, dtype=np.float32)   # [64in, 64out_zz]
    # Level shift: DCT(x - 128) = DCT(x) - [8*128 at DC]; DC is zz pos 0.
    b = np.zeros(64, dtype=np.float64)
    b[0] = -(128.0 * 8.0) / q[0]
    return m, b.astype(np.float32)


def quant_table_zigzag(quality: int, chroma: bool) -> np.ndarray:
    """Scaled quant table in zigzag order (what DQT segments carry)."""
    base = QUANT_CHROMA if chroma else QUANT_LUMA
    return scale_quant_table(base, quality).reshape(64)[ZIGZAG_ORDER]


# BT.601 full-range RGB -> YCbCr, the exact coefficients of the reference CPU
# path (src/utils.cpp:92-110; the GPU kernel's rounded variants .cl:23-24 are
# a reference inconsistency we do not reproduce). y = rgb @ CSC_MATRIX +
# CSC_OFFSET; the chroma offset cancels the level shift inside mcu_operator.
CSC_MATRIX = np.array([
    [0.299,     -0.168736,  0.5],
    [0.587,     -0.331264, -0.418688],
    [0.114,      0.5,      -0.081312],
], dtype=np.float32)
CSC_OFFSET = np.array([0.0, 128.0, 128.0], dtype=np.float32)
