"""Top-level encoder: uint8 RGB image -> complete JFIF/JPEG bytes, on torch
(counterpart of ``jpegtpu.encoder``'s main path, ``_device_encode_pallas``
with ``device_stuff``, and ``Encoder.encode_to_scan`` / ``encode``).

The device program runs four kernels with plain torch glue between them:

    pixel       fused_dctq.encode_blocks_pairs   u8 -> coefficients
    (glue)      scan.dc_diffs_from_dc, the class vector
    block pack  entropy_pack.block_pack_mcu_pairs   -> MCU bitstreams
    (glue)      each MCU's bit offset in its segment
    seg merge   entropy_pack.seg_merge_mcu          -> segment bitstreams
    (glue)      compact.stuff_precompute: byte and 0xFF counts, offsets
    stuffing    compact.compact_segments_stuffed    -> the stuffed scan

and the host fetches exactly the scan's bytes and wraps them in the JFIF
headers. On a CUDA device the four hand-written kernels run; on the CPU
(the tests pass ``device="cpu"``) each stage runs its plain twin. Every
buffer has its worst-case size, so jpegtpu's first-pass bit budget and its
re-run on overflow have no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from jpegtpu_torch.config import EncoderConfig
from jpegtpu_torch.container import jfif
from jpegtpu_torch.core import ops
from jpegtpu_torch.entropy import huffman_tables as ht
from jpegtpu_torch.entropy import scan
from jpegtpu_torch.kernels import compact, entropy_pack, fused_dctq


class EncoderTables(nn.Module):
    """The encoder's per-quality state as device buffers: the 4:2:0 MCU
    operator ``m`` [768, 384] f32 and ``bias`` [384] f32, and the packed
    Huffman LUTs ``dc_codes``/``dc_lens`` [2, 16] and ``ac_codes``/
    ``ac_lens`` [2, 256] int32 (index 0 luma, 1 chroma). The kernels and
    their plain twins read the same tensors."""

    def __init__(self, m: torch.Tensor, bias: torch.Tensor,
                 dc_codes: torch.Tensor, dc_lens: torch.Tensor,
                 ac_codes: torch.Tensor, ac_lens: torch.Tensor):
        super().__init__()
        self.register_buffer("m", m.to(torch.float32))
        self.register_buffer("bias", bias.to(torch.float32))
        for name, t in (("dc_codes", dc_codes), ("dc_lens", dc_lens),
                        ("ac_codes", ac_codes), ("ac_lens", ac_lens)):
            self.register_buffer(name, t.to(torch.int32))

    @classmethod
    def from_numpy(cls, m: np.ndarray, bias: np.ndarray,
                   dc_codes: np.ndarray, dc_lens: np.ndarray,
                   ac_codes: np.ndarray, ac_lens: np.ndarray,
                   device: torch.device | str = "cpu") -> "EncoderTables":
        """Build from numpy arrays (``mcu_operator(q, "420")`` and
        ``packed_luts()``, of this package or of jpegtpu)."""
        as_t = lambda a, dt: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a).astype(dt))
        return cls(as_t(m, np.float32), as_t(bias, np.float32),
                   as_t(dc_codes, np.int32), as_t(dc_lens, np.int32),
                   as_t(ac_codes, np.int32), as_t(ac_lens, np.int32)
                   ).to(device)

    @classmethod
    def for_quality(cls, quality: int,
                    device: torch.device | str = "cpu") -> "EncoderTables":
        """The tables of one quality, from this package's table copies."""
        return cls.from_numpy(*fused_dctq.mcu_operator(quality, "420"),
                              *ht.packed_luts(), device=device)

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


def device_encode(img: torch.Tensor, tables: EncoderTables,
                  restart: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """u8 [H, W, 3] on the tables' device -> (u8 scan buffer, total bytes
    scalar): the device program of the 4:2:0, rows-restart main path."""
    n_luma, b = 4, 6
    coeffs = fused_dctq.encode_blocks_pairs(img, tables.m, tables.bias)
    n_mcu = coeffs.shape[0]
    n_seg = n_mcu // restart
    dcd = scan.dc_diffs_from_dc(coeffs[:, ::64], n_luma, restart).reshape(-1)
    cls = (torch.arange(n_mcu * b, device=coeffs.device) % b >= n_luma
           ).to(torch.int32)
    mwords, mlens = entropy_pack.block_pack_mcu_pairs(coeffs, cls, dcd,
                                                      *tables.luts())
    seg_words, seg_bits = entropy_pack.seg_merge_mcu(mwords, mlens, n_seg,
                                                     restart)
    return compact.compact_segments_stuffed(seg_words, seg_bits, restart)


class Encoder:
    """Reusable encoder for one configuration on one device."""

    def __init__(self, config: EncoderConfig | None = None,
                 device: torch.device | str | None = None):
        self.config = config or EncoderConfig()
        if self.config.subsampling != "420":
            raise NotImplementedError(
                f"subsampling={self.config.subsampling!r}: the port covers "
                f"4:2:0 only (ROADMAP.md Open items 1.9)")
        if self.config.restart_interval != "rows":
            raise NotImplementedError(
                f"restart_interval={self.config.restart_interval!r}: the "
                f"port covers restart_interval='rows' only (ROADMAP.md Open "
                f"items 1.9 and 1.10)")
        self.device = resolve_device(device)
        self.tables = EncoderTables.for_quality(self.config.quality,
                                                self.device)

    def encode_to_scan(self, img: np.ndarray) -> Tuple[bytes, int]:
        """Device pipeline + exact-size fetch -> (entropy scan bytes,
        restart interval)."""
        img = np.asarray(img)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected [H, W, 3] RGB, got {img.shape}")
        if img.dtype != np.uint8:
            raise ValueError(f"expected uint8 pixels, got {img.dtype}")
        h, w = img.shape[:2]
        _, mx = ops.mcu_grid(h, w, self.config.subsampling)
        restart = self.config.resolve_restart(mx)
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        buf, total = device_encode(x, self.tables, restart)
        scan_bytes = buf[:int(total)].cpu().numpy().tobytes()
        return scan_bytes, restart

    def encode(self, img: np.ndarray) -> bytes:
        """uint8 RGB [H, W, 3] -> complete JFIF/JPEG bytes."""
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
