"""Pixel-path helpers on torch tensors (counterparts of ``jpegtpu.core.ops``).

Only what the 4:2:0 slice needs: MCU geometry, the half-away rounding of the
reference, and jpegtpu's mirror padding. The padding is built as an index
gather because ``F.pad(mode="reflect")`` excludes the edge sample
(``1,2,3 -> 1,2,3,2,1``) while jpegtpu pads numpy-``symmetric``
(``1,2,3 -> 1,2,3,3,2``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def mcu_shape(subsampling: str) -> Tuple[int, int]:
    """(mcu_height, mcu_width) in pixels for a subsampling mode."""
    return {"420": (16, 16), "422": (8, 16)}.get(subsampling, (8, 8))


def mcu_grid(h: int, w: int, subsampling: str) -> Tuple[int, int]:
    """MCU grid (rows, cols) for an image of size h x w."""
    mh, mw = mcu_shape(subsampling)
    return -(-h // mh), -(-w // mw)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """std::round semantics (half away from zero), as jpegtpu rounds."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _pad_index(n: int, pad: int, symmetric: bool,
               device: torch.device) -> torch.Tensor:
    """Source index of each of the n + pad output positions along one axis:
    numpy's ``symmetric`` mirror (edge sample repeated) or ``edge``."""
    i = torch.arange(n + pad, device=device)
    if symmetric:
        return torch.where(i < n, i, 2 * n - 1 - i)
    return torch.clamp(i, max=n - 1)


def pad_to_multiple(img: torch.Tensor, multiple) -> torch.Tensor:
    """Mirror-pad H and W (axes -3, -2 of [..., H, W, C]) up to `multiple`
    (an int or an (mh, mw) pair), exactly as ``jpegtpu.core.ops`` does:
    numpy-``symmetric`` reflection, or ``edge`` when a pad is at least as
    long as its axis."""
    mh, mw = (multiple, multiple) if isinstance(multiple, int) else multiple
    h, w = img.shape[-3], img.shape[-2]
    ph = (-h) % mh
    pw = (-w) % mw
    if ph == 0 and pw == 0:
        return img
    symmetric = not (ph >= h or pw >= w)
    rows = _pad_index(h, ph, symmetric, img.device)
    cols = _pad_index(w, pw, symmetric, img.device)
    return img.index_select(-3, rows).index_select(-2, cols)
