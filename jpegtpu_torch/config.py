"""Encoder configuration for the PyTorch port.

The fields that change the output bytes (``quality``, ``subsampling``,
``restart_interval``), with ``jpegtpu.config``'s validation and messages,
and three that choose how the device program computes them and change no
byte: ``device_stuff`` (the scan stuffed on the device, or on the host
after a device compaction), ``pixel_path`` and ``fuse_bp``, jpegtpu's
pixel-path selectors, each with jpegtpu's default, environment override
(``JPEGTPU_PIXEL_PATH``, ``JPEGTPU_FUSE_BP``, read when a config is made)
and validation. Each selects its own hand-written kernel here, as it
selects its own TPU kernel in jpegtpu; ``JPEGTPU_PIXEL_DC`` (read at
import, ``jpegtpu_torch.kernels.fused_dctq.PIXEL_DC``) is the third such
selector, as in jpegtpu. jpegtpu's ``compact_kb``, ``bp_merge_rot``,
``compact_groups`` and its first-pass ``bits_budget`` choose TPU layouts
of one kernel, or a buffer size: the port has one layout per kernel and
sizes every buffer for the worst case, so it has none of them.
"""

from __future__ import annotations

import dataclasses
import os

# Chroma subsampling modes (see jpegtpu.config for what each one means).
SUBSAMPLING_MODES = ("444", "444s", "420", "422", "gray")
# The pixel routes of pixel_path (see EncoderConfig).
PIXEL_PATHS = ("nat", "xla", "dma")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Configuration of one encode pipeline."""

    quality: int = 50                 # libjpeg-style quality 1..100
    subsampling: str = "420"          # one of SUBSAMPLING_MODES
    # Restart interval in MCUs; "rows" makes each MCU row one restart
    # segment, 0 disables restart markers.
    restart_interval: int | str = "rows"
    # Stuff the scan on the device (0xFF00 stuffing and RSTn markers in the
    # stuffing kernel; the host fetches the finished scan). False compacts
    # the segments on the device and stuffs them on the host
    # (``native.stuff_assemble_contig``). The same bytes either way.
    device_stuff: bool = True
    # The pixel route of the fused modes: "nat" the pixel kernel
    # (csrc/pixel_mma.cu), "dma" the kernel that brings its input in by bulk
    # copies (csrc/pixel_dma.cu; 4:2:0 only, the other modes take "xla"),
    # "xla" the tile gather and a float64 torch.matmul, no hand kernel. The
    # same bytes on every route.
    pixel_path: str = dataclasses.field(
        default_factory=lambda: os.environ.get("JPEGTPU_PIXEL_PATH", "nat"))
    # One kernel for the pixel product, the DC differences and the block
    # pack (csrc/fused_px_bp.cu), so that the coefficients never reach
    # device memory; 4:2:0, 4:2:2 and 4:4:4 (4:4:4s and gray take the
    # split kernels). The same bytes either way.
    fuse_bp: bool = dataclasses.field(
        default_factory=lambda: os.environ.get("JPEGTPU_FUSE_BP", "0") != "0")

    def __post_init__(self):
        if not (1 <= self.quality <= 100):
            raise ValueError(f"quality must be in 1..100, got {self.quality}")
        if self.subsampling not in SUBSAMPLING_MODES:
            raise ValueError(
                f"subsampling must be one of {SUBSAMPLING_MODES}, "
                f"got {self.subsampling!r}")
        if isinstance(self.restart_interval, str):
            if self.restart_interval != "rows":
                raise ValueError("restart_interval must be an int >= 0 or 'rows'")
        elif self.restart_interval < 0:
            raise ValueError("restart_interval must be >= 0")
        if self.pixel_path not in PIXEL_PATHS:
            raise ValueError(
                f"pixel_path must be 'nat', 'xla' or 'dma', "
                f"got {self.pixel_path!r}")

    @property
    def mcu_shape(self) -> tuple:
        """(height, width) of one MCU in pixels."""
        return {"420": (16, 16), "422": (8, 16)}.get(self.subsampling,
                                                     (8, 8))

    @property
    def blocks_per_mcu(self) -> int:
        return {"420": 6, "422": 4, "gray": 1}.get(self.subsampling, 3)

    @property
    def n_luma(self) -> int:
        return {"420": 4, "422": 2}.get(self.subsampling, 1)

    def resolve_restart(self, mcus_per_row: int) -> int:
        """Concrete restart interval in MCUs for a given image geometry."""
        if self.restart_interval == "rows":
            return mcus_per_row
        return int(self.restart_interval)
