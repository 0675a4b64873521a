"""Top-level encoder: one uint8 image -> complete JFIF/JPEG bytes, on torch
(counterpart of ``jpegtpu.encoder``'s single-image path,
``_device_encode_pallas`` with ``device_stuff``, and
``Encoder.encode_to_scan`` / ``encode``), for every subsampling mode and
restart interval.

The device program runs up to five kernels with plain torch glue between
them:

    pixel       fused_dctq.encode_blocks          u8 -> coefficients
                (the fused kernel, or the staged ops for gray and
                non-8-aligned 4:4:4s)
    (glue)      scan.dc_diffs_from_dc, the class vector
    block pack  entropy_pack.block_pack_mcu_pairs   -> MCU bitstreams
    (glue)      zero-length pad MCUs for a ragged last segment, each MCU's
                bit offset in its segment
    seg merge   entropy_pack.seg_merge_mcu          -> segment bitstreams
    (glue)      byte and 0xFF counts, offsets
    stuffing    compact.compact_segments_stuffed_grouped (several segments)
                or compact.compact_segments_stuffed (one)  -> the scan

and the host fetches exactly the scan's bytes and wraps them in the JFIF
headers. On a CUDA device the hand-written kernels run; on the CPU (the
tests pass ``device="cpu"``) each stage runs its plain twin. Every buffer
has its worst-case size, so jpegtpu's first-pass bit budget and its re-run
on overflow have no counterpart here, and neither have its TPU-layout
choices that change no bytes (``mcu_group``, ``compact_groups``, the 8-way
virtual split of a single segment).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from jpegtpu_torch.config import EncoderConfig
from jpegtpu_torch.container import jfif
from jpegtpu_torch.core import ops, tables
from jpegtpu_torch.entropy import huffman_tables as ht
from jpegtpu_torch.entropy import scan
from jpegtpu_torch.kernels import compact, entropy_pack, fused_dctq


def block_operators(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """(block_m [2, 64, 64] f32, block_bias [2, 64] f32): the per-block
    operator of ``tables.fused_block_operator``, luma then chroma."""
    (m_l, b_l), (m_c, b_c) = (tables.fused_block_operator(quality, chroma)
                              for chroma in (False, True))
    return np.stack([m_l, m_c]), np.stack([b_l, b_c])


class EncoderTables(nn.Module):
    """The encoder's per-quality, per-mode state as device buffers: the
    fused MCU operator ``m`` [in, out] f32 and ``bias`` [out] f32 of the
    mode (``mcu_operator``; for gray, the luma block operator), the staged
    path's ``block_m`` [2, 64, 64] and ``block_bias`` [2, 64] f32, and the
    packed Huffman LUTs ``dc_codes``/``dc_lens`` [2, 16] and ``ac_codes``/
    ``ac_lens`` [2, 256] int32 (index 0 luma, 1 chroma). The kernels and
    their plain twins read the same tensors."""

    def __init__(self, m: torch.Tensor, bias: torch.Tensor,
                 dc_codes: torch.Tensor, dc_lens: torch.Tensor,
                 ac_codes: torch.Tensor, ac_lens: torch.Tensor,
                 block_m: torch.Tensor, block_bias: torch.Tensor):
        super().__init__()
        for name, t in (("m", m), ("bias", bias), ("block_m", block_m),
                        ("block_bias", block_bias)):
            self.register_buffer(name, t.to(torch.float32))
        for name, t in (("dc_codes", dc_codes), ("dc_lens", dc_lens),
                        ("ac_codes", ac_codes), ("ac_lens", ac_lens)):
            self.register_buffer(name, t.to(torch.int32))

    @classmethod
    def from_numpy(cls, m: np.ndarray, bias: np.ndarray,
                   dc_codes: np.ndarray, dc_lens: np.ndarray,
                   ac_codes: np.ndarray, ac_lens: np.ndarray,
                   block_m: np.ndarray, block_bias: np.ndarray,
                   device: torch.device | str = "cpu") -> "EncoderTables":
        """Build from numpy arrays (``mcu_operator(q, mode)``,
        ``packed_luts()`` and ``block_operators(q)``, of this package or of
        jpegtpu)."""
        as_t = lambda a, dt: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a).astype(dt))
        return cls(as_t(m, np.float32), as_t(bias, np.float32),
                   as_t(dc_codes, np.int32), as_t(dc_lens, np.int32),
                   as_t(ac_codes, np.int32), as_t(ac_lens, np.int32),
                   as_t(block_m, np.float32), as_t(block_bias, np.float32)
                   ).to(device)

    @classmethod
    def for_quality(cls, quality: int, subsampling: str = "420",
                    device: torch.device | str = "cpu") -> "EncoderTables":
        """The tables of one quality and mode, from this package's table
        copies."""
        if subsampling == "gray":
            m, bias = tables.fused_block_operator(quality, chroma=False)
        else:
            m, bias = fused_dctq.mcu_operator(quality, subsampling)
        return cls.from_numpy(m, bias, *ht.packed_luts(),
                              *block_operators(quality), device=device)

    def luts(self) -> Tuple[torch.Tensor, ...]:
        return self.dc_codes, self.dc_lens, self.ac_codes, self.ac_lens


def resolve_device(device: torch.device | str | None) -> torch.device:
    """None means "cuda". A CUDA device without CUDA raises: nothing falls
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("jpegtpu_torch: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def geometry(n_mcu: int, restart: int) -> Tuple[int, int]:
    """(n_seg, mcus_per_seg) of n_mcu MCUs at a concrete restart interval
    (jpegtpu's ``_geometry``, ``encoder.py:434-441``): restart 0 is one
    segment. An interval longer than the image is one segment of n_mcu
    MCUs here (jpegtpu pads it to `restart` zero-length MCUs, which add no
    bytes)."""
    if restart <= 0:
        return 1, n_mcu
    return -(-n_mcu // restart), min(restart, n_mcu)


def device_encode(img: torch.Tensor, tables: EncoderTables, subsampling: str,
                  restart: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """u8 [H, W, 3] (gray [H, W]) on the tables' device -> (u8 scan buffer,
    total bytes scalar): the device program."""
    n_luma = EncoderConfig(subsampling=subsampling).n_luma
    coeffs = fused_dctq.encode_blocks(img, tables, subsampling)
    n_mcu, b = coeffs.shape[0], coeffs.shape[1] // 64
    n_seg, mps = geometry(n_mcu, restart)
    dcd = scan.dc_diffs_from_dc(coeffs[:, ::64], n_luma, restart).reshape(-1)
    cls = (torch.arange(n_mcu * b, device=coeffs.device) % b >= n_luma
           ).to(torch.int32)
    mwords, mlens = entropy_pack.block_pack_mcu_pairs(coeffs, cls, dcd,
                                                      *tables.luts())
    mwords, mlens = entropy_pack.pad_segments(mwords, mlens, n_seg, mps)
    seg_words, seg_bits = entropy_pack.seg_merge_mcu(mwords, mlens, n_seg,
                                                     mps)
    if n_seg > 1:
        return compact.compact_segments_stuffed_grouped(seg_words, seg_bits,
                                                        restart)
    return compact.compact_segments_stuffed(seg_words, seg_bits, restart)


class Encoder:
    """Reusable encoder for one configuration on one device."""

    def __init__(self, config: EncoderConfig | None = None,
                 device: torch.device | str | None = None):
        self.config = config or EncoderConfig()
        self.device = resolve_device(device)
        self.tables = EncoderTables.for_quality(
            self.config.quality, self.config.subsampling, self.device)

    def encode_to_scan(self, img: np.ndarray) -> Tuple[bytes, int]:
        """Device pipeline + exact-size fetch -> (entropy scan bytes,
        restart interval)."""
        img = np.asarray(img)
        if self.config.subsampling == "gray":
            if img.ndim == 3 and img.shape[2] == 1:
                img = img[..., 0]
            if img.ndim != 2:
                raise ValueError(
                    f"gray mode expects [H, W] input, got {img.shape}")
        elif img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected [H, W, 3] RGB, got {img.shape}")
        if img.dtype != np.uint8:
            raise ValueError(f"expected uint8 pixels, got {img.dtype}")
        h, w = img.shape[:2]
        _, mx = ops.mcu_grid(h, w, self.config.subsampling)
        restart = self.config.resolve_restart(mx)
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        buf, total = device_encode(x, self.tables, self.config.subsampling,
                                   restart)
        scan_bytes = buf[:int(total)].cpu().numpy().tobytes()
        return scan_bytes, restart

    def encode(self, img: np.ndarray) -> bytes:
        """uint8 RGB [H, W, 3] (gray: [H, W] or [H, W, 1]) -> complete
        JFIF/JPEG bytes."""
        h, w = np.shape(img)[:2]
        scan_bytes, restart = self.encode_to_scan(img)
        return jfif.wrap_jpeg(h, w, self.config.quality,
                              self.config.subsampling, restart, scan_bytes)


def encode(img: np.ndarray, quality: int = 50, subsampling: str = "420",
           restart_interval: int | str = "rows",
           device: torch.device | str | None = None) -> bytes:
    """One-shot convenience wrapper; device None means "cuda"."""
    cfg = EncoderConfig(quality=quality, subsampling=subsampling,
                        restart_interval=restart_interval)
    return Encoder(cfg, device=device).encode(img)
