"""jpegtpu_torch — the PyTorch + CUDA port of jpegtpu.

``encode(img, quality, subsampling="420", restart_interval="rows",
device=None)`` returns the same JFIF bytes as ``jpegtpu.encode`` for one
image, in every subsampling mode (4:2:0, 4:2:2, 4:4:4, 4:4:4s, gray) and
at every restart interval ("rows", 0 for none, or a number of MCUs);
``encode_batch(imgs, config=None, device=None, **kw)`` returns
``jpegtpu.encode_batch``'s files, one device program for a batch of
same-shaped images whose restart segments divide each image's MCU count.
``device_stuff=False`` stuffs the scan on the host instead of the device,
and jpegtpu's pixel-path selectors (``pixel_path`` "nat", "xla" or "dma",
``fuse_bp``, the ``JPEGTPU_PIXEL_DC`` variable) choose other kernels, all
with the same bytes. On a CUDA device it runs the hand-written kernels
(built on first use from ``kernels/csrc``); with ``device="cpu"`` it runs
their plain torch twins. The package imports torch and numpy, never JAX.
"""

from jpegtpu_torch.config import EncoderConfig
from jpegtpu_torch.encoder import (BatchGeometryError, Encoder,
                                   EncoderTables, encode, encode_batch)

__all__ = ["BatchGeometryError", "EncoderConfig", "Encoder", "EncoderTables",
           "encode", "encode_batch"]
