"""jpegtpu_torch — the PyTorch + CUDA port of jpegtpu.

``encode(img, quality, subsampling="420", restart_interval="rows",
device=None)`` returns the same JFIF bytes as ``jpegtpu.encode`` for one
image, in every subsampling mode (4:2:0, 4:2:2, 4:4:4, 4:4:4s, gray) and
at every restart interval ("rows", 0 for none, or a number of MCUs). On a
CUDA device it runs the hand-written kernels (built on first use from
``kernels/csrc``); with ``device="cpu"`` it runs their plain torch twins.
The package imports torch and numpy, never JAX.
"""

from jpegtpu_torch.config import EncoderConfig
from jpegtpu_torch.encoder import Encoder, EncoderTables, encode

__all__ = ["EncoderConfig", "Encoder", "EncoderTables", "encode"]
