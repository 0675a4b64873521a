"""Vectorized RLE + Huffman symbolization on torch tensors (counterpart of
``jpegtpu.entropy.scan``), in int64.

Every zigzag position is a symbol slot; a slot emits 0 bits if nothing is
coded there. Per 64-slot block:

    slot 0         -> the DC (size, diff) symbol
    slot k, c!=0   -> AC (runlength%16, size) symbol + magnitude bits
    slot k, c==0   -> ZRL (15,0) iff k precedes a nonzero and the zero-run
                      through k is a multiple of 16
    slot last+1    -> EOB iff the block has trailing zeros

These functions are the plain twin of the block-pack kernel's symbolizer
(``csrc/block_pack.cu``) and the DC glue of the encoder.
"""

from __future__ import annotations

from typing import Tuple

import torch

from jpegtpu_torch.entropy import huffman_tables as ht


def _size_category(av: torch.Tensor) -> torch.Tensor:
    """JPEG size category: bits needed for |v| (0 for v=0); av < 2^12 for
    baseline JPEG."""
    s = torch.zeros_like(av)
    for i in range(12):
        s = s + (av >= (1 << i)).to(av.dtype)
    return s


def _magnitude_bits(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """JPEG magnitude (1's-complement for negatives) in the low `size` bits."""
    return torch.where(v < 0, v + (1 << size) - 1, v)


def dc_diffs_from_dc(dc: torch.Tensor, n_luma: int,
                     restart: int) -> torch.Tensor:
    """DC differentials with restart-interval predictor resets:
    dc [nM, B] (each block's DC coefficient, scan order) -> [nM, B] int32.

    Each component's DC values form one chain in scan order; the predictor
    resets to 0 at the first block of every restart segment."""
    n_mcu, b = dc.shape
    out = []
    for (lo, hi), per in (((0, n_luma), n_luma), ((n_luma, n_luma + 1), 1),
                          ((n_luma + 1, b), 1)):
        lo, hi = min(lo, b), min(hi, b)
        if hi <= lo:
            continue
        d = dc[:, lo:hi].reshape(-1).to(torch.int64)
        mod = (restart if restart > 0 else n_mcu) * per
        idx = torch.arange(d.shape[0], device=d.device)
        prev = torch.where(idx % mod == 0, 0, torch.roll(d, 1))
        out.append((d - prev).reshape(n_mcu, hi - lo))
    return torch.cat(out, dim=1).to(torch.int32)


def block_symbols(coeffs: torch.Tensor, cls: torch.Tensor,
                  dcdiff: torch.Tensor, dc_codes: torch.Tensor,
                  dc_lens: torch.Tensor, ac_codes: torch.Tensor,
                  ac_lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symbolize blocks: ([N,64] coeffs, [N] class 0/1, [N] dcdiff, and the
    packed Huffman LUTs dc_* [2,16] / ac_* [2,256]) -> (lens [N,64],
    bits [N,64]), both int64.

    bits holds code||magnitude right-aligned in the low `lens` bits; a slot
    with lens==0 emits nothing.
    """
    n = coeffs.shape[0]
    dev = coeffs.device
    ac_codes = ac_codes.reshape(-1).to(torch.int64)
    ac_lens = ac_lens.reshape(-1).to(torch.int64)
    dc_codes = dc_codes.to(torch.int64)
    dc_lens = dc_lens.to(torch.int64)
    cls = cls.to(torch.int64)
    dcdiff = dcdiff.to(torch.int64)

    k = torch.arange(64, device=dev)[None, :]
    c = coeffs.to(torch.int64)
    nz = c != 0
    # Sentinel: treat the DC slot as "nonzero" so AC runs start after it.
    m = nz.clone()
    m[:, 0] = True

    # prev[k] = index of the last emitted-coefficient position before k.
    masked = torch.where(m, k, -1)
    cmax = torch.cummax(masked, dim=1).values
    prev = torch.cat([torch.zeros((n, 1), dtype=torch.int64, device=dev),
                      cmax[:, :-1]], dim=1)
    last_nz = torch.where(m, k, 0).amax(dim=1, keepdim=True)

    run = k - prev - 1                                    # zeros before k
    size = _size_category(torch.abs(c))

    is_ac = k > 0
    emit_nz = is_ac & nz
    emit_zrl = is_ac & ~nz & (k < last_nz) & ((k - prev) % 16 == 0)
    emit_eob = (k == last_nz + 1) & (last_nz < 63)

    rs = torch.where(emit_nz, ((run % 16) << 4) | size,
                     torch.where(emit_zrl, ht.ZRL, ht.EOB))
    tbl_idx = cls[:, None] * 256 + rs
    a_code = ac_codes[tbl_idx]
    a_len = ac_lens[tbl_idx]

    mag = _magnitude_bits(c, size)
    ac_bits = (a_code << size) | torch.where(emit_nz, mag, 0)
    ac_total = a_len + torch.where(emit_nz, size, 0)
    emit_any = emit_nz | emit_zrl | emit_eob
    ac_bits = torch.where(emit_any, ac_bits, 0)
    ac_total = torch.where(emit_any, ac_total, 0)

    # DC slot.
    d_size = _size_category(torch.abs(dcdiff))
    d_code = dc_codes[cls, d_size]
    d_len = dc_lens[cls, d_size]
    d_bits = (d_code << d_size) | _magnitude_bits(dcdiff, d_size)

    ac_total[:, 0] = d_len + d_size
    ac_bits[:, 0] = d_bits
    return ac_total, ac_bits
