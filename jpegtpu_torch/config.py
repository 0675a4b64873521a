"""Encoder configuration for the PyTorch port.

The fields that change the output bytes (``quality``, ``subsampling``,
``restart_interval``), with ``jpegtpu.config``'s validation and messages,
and ``device_stuff``, which chooses where the scan is stuffed (on the
device, or on the host after a device compaction) and changes no bytes.
jpegtpu's kernel-variant selectors (``pixel_path``, ``fuse_bp``,
``compact_kb``, ``bp_merge_rot``, ``compact_groups``) and its first-pass
``bits_budget`` choose between TPU kernels that give the same bytes; the
port has one kernel per stage and sizes every buffer for the worst case,
so it has none of them.
"""

from __future__ import annotations

import dataclasses

# Chroma subsampling modes (see jpegtpu.config for what each one means).
SUBSAMPLING_MODES = ("444", "444s", "420", "422", "gray")


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
