"""The yardstick of the roofline metrics: the card's peaks and the least
time each stage of an encode could take on it.

A stage's bound depends only on the cell's shapes and on the scan that the
run produced, never on which kernels implement the stage, so a change that
fuses or splits kernels inside a stage leaves it unchanged. Bytes between
kernels of one stage are not counted: each input byte is read once and
each output byte written once.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import jpeg, tables

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: float64 on the
# tensor cores (the card's highest float64 rate) and HBM3 bandwidth.
PEAK_FP64_FLOP_S = 67e12
PEAK_HBM_BYTES_S = 3.35e12
# The Huffman tables the entropy stage reads: DC codes and lengths [2, 16],
# AC codes and lengths [2, 256], int32.
LUT_BYTES = (2 * 16 * 2 + 2 * 256 * 2) * 4


def operator_fmas(m: np.ndarray, mode: str) -> int:
    """Multiply-adds per MCU of the factored product of operator m [in,
    out]: a column reads the exact integer sum of the pixels that one
    chroma sample covers (2x2 in 4:2:0 and 4:4:4s, 1x2 in 4:2:2; summed
    once per MCU) once where its weights over them are equal, and each
    other nonzero weight once. Inputs are MCU pixels (y, x, c) row-major."""
    (mh, mw), _ = tables.MODES[mode]
    gy, gx = {"420": (2, 2), "422": (1, 2), "444s": (2, 2)}.get(mode, (1, 1))
    g = m.reshape(mh // gy, gy, mw // gx, gx, 3, -1).transpose(0, 2, 4, 1, 3,
                                                               5)
    g = g.reshape(mh // gy, mw // gx, 3, gy * gx, -1)
    same = (g == g[..., :1, :]).all(axis=3)
    nz = g != 0
    return int(np.where(same, nz[..., 0, :], nz.sum(axis=3)).sum())


def _shape(cfg: dict) -> tuple:
    """(images a call, MCUs an image, coefficients an MCU)."""
    my, mx = jpeg.mcu_grid(cfg["height"], cfg["width"], cfg["subsampling"])
    _, n_luma = tables.MODES[cfg["subsampling"]]
    return cfg["batch"], my * mx, (n_luma + 2) * 64


def pixel_bound_s(cfg: dict) -> float:
    """Least seconds of the pixel stage for one call: the larger of the
    float64 FLOPs of the factored operator over the float64 peak, and the
    frames in plus the int32 coefficients out over the HBM rate."""
    n, mcus, coef = _shape(cfg)
    m, _ = tables.mcu_operator(cfg["quality"], cfg["subsampling"])
    flops = 2.0 * n * mcus * operator_fmas(m, cfg["subsampling"])
    nbytes = n * (cfg["height"] * cfg["width"] * 3 + mcus * coef * 4)
    return max(flops / PEAK_FP64_FLOP_S, nbytes / PEAK_HBM_BYTES_S)


def entropy_bound_s(cfg: dict, scan_bytes: float) -> float:
    """Least seconds of the entropy stage (block pack, segment merge and
    stuffing) for one call that writes scan_bytes of stuffed scan: the
    int32 coefficients and the Huffman tables in, the scan and its offsets
    (the total, and each image's first byte in a batch) out, over the HBM
    rate."""
    n, mcus, coef = _shape(cfg)
    offsets = 8 * (n + 1 if n > 1 else 1)
    nbytes = n * mcus * coef * 4 + LUT_BYTES + scan_bytes + offsets
    return nbytes / PEAK_HBM_BYTES_S
