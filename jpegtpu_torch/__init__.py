"""jpegtpu_torch — the PyTorch + CUDA port of jpegtpu.

``encode(img, quality, subsampling="420", device=None)`` returns the same
JFIF bytes as ``jpegtpu.encode`` for 4:2:0 with a restart marker every MCU
row. On a CUDA device it runs four hand-written kernels (built on first
use from ``kernels/csrc``); with ``device="cpu"`` it runs their plain torch
twins. The package imports torch and numpy, never JAX.
"""

from jpegtpu_torch.config import EncoderConfig
from jpegtpu_torch.encoder import Encoder, EncoderTables, encode

__all__ = ["EncoderConfig", "Encoder", "EncoderTables", "encode"]
