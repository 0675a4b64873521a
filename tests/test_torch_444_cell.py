"""The correctness check of the benchmark's 4:4:4 cell
(``portbench/configs/uhd_444_q90.json``), on the CPU at a cut size: a few
MCU rows of the configuration's own 3840-pixel width, so that a restart
segment is a whole 4K MCU row of 480 MCUs, as in the cell.

The port's path is the cell's: ``encoder.device_encode`` with the
``EncoderTables`` that ``Encoder`` builds for ``subsampling="444"``, on the
default route; on a CPU tensor it takes the kernels' plain twins. Its scan,
read up to its total as the harness reads a device output, has to equal
the plain reference's (``portbench.reference.jpeg.scan``, float64 product)
byte for byte. The same check has to fail the reference computed in
float32, the precision below the configuration's: on a crop this size a
float32 product rounds a coefficient or more the other way on most seeds,
and the test tries the seeds of ``SEEDS`` in turn (at most 8) until one
does. Imports no JAX."""

import json
from pathlib import Path

import pytest
import torch

import jpegtpu_torch
from jpegtpu_torch import encoder
from portbench import frames
from portbench.reference import jpeg

CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / (
    "uhd_444_q90.json")
# MCU rows of the cut frame (8 pixel rows each at 4:4:4).
ROWS = 8
SEEDS = [2**31 + 444 + k for k in range(8)]


def _cut(restart_interval) -> dict:
    """The configuration cut to ROWS MCU rows at its own width, one frame
    on a canvas of the frame's size, with the given restart interval."""
    cfg = json.loads(CONFIG.read_text())
    h = ROWS * 8
    return {**cfg, "height": h, "canvas": [h, cfg["width"]], "distinct": 1,
            "restart_interval": restart_interval}


def _encoder(cfg: dict) -> jpegtpu_torch.Encoder:
    return jpegtpu_torch.Encoder(jpegtpu_torch.EncoderConfig(
        quality=cfg["quality"], subsampling=cfg["subsampling"],
        restart_interval=cfg["restart_interval"]), device="cpu")


def _frame(cfg: dict, seed: int) -> torch.Tensor:
    return frames.make_inputs(cfg, seed, torch.device("cpu"))[0]


def _reference(cfg: dict, img: torch.Tensor, dtype=torch.float64) -> bytes:
    restart = jpeg.restart_mcus(cfg["restart_interval"], cfg["width"],
                                cfg["subsampling"])
    return jpeg.scan(img, cfg["quality"], cfg["subsampling"], restart, dtype)


def test_configuration_builds_the_444_operator():
    """The cell's tables: the [192, 192] operator read as 4:4:4 (1x1
    chroma groups), not 4:4:4s, factored into luma [192, 64] and chroma
    [192, 128]; a restart every MCU row is 480 MCUs at 3840 pixels."""
    cfg = json.loads(CONFIG.read_text())
    assert (cfg["subsampling"], cfg["restart_interval"]) == ("444", "rows")
    enc = _encoder(cfg)
    t = enc.tables
    assert t.subsampling == "444"
    assert tuple(t.m.shape) == (192, 192)
    assert tuple(t.lum.shape) == (192, 64)
    assert tuple(t.chroma.shape) == (192, 128)
    assert enc.restart_for(cfg["height"], cfg["width"]) == 480


@pytest.mark.parametrize("restart_interval", ["rows", 0])
def test_port_equals_the_reference(restart_interval):
    cfg = _cut(restart_interval)
    enc = _encoder(cfg)
    restart = enc.restart_for(cfg["height"], cfg["width"])
    assert restart == jpeg.restart_mcus(restart_interval, cfg["width"], "444")
    img = _frame(cfg, SEEDS[0])
    out = encoder.device_encode(img, enc.tables, enc.config.subsampling,
                                restart, enc.config.device_stuff,
                                enc.config.pixel_path, enc.config.fuse_bp)
    got = out[0][:int(out[1])].numpy().tobytes()
    assert got == _reference(cfg, img)


@pytest.mark.parametrize("restart_interval", ["rows", 0])
def test_float32_reference_fails_the_check(restart_interval):
    """The exact comparison catches a lower-precision 4:4:4 product: on
    one of SEEDS the float32 reference's scan differs from the float64
    one's."""
    cfg = _cut(restart_interval)
    tried = []
    for seed in SEEDS:
        img = _frame(cfg, seed)
        q, mode = cfg["quality"], cfg["subsampling"]
        coded_apart = int((jpeg.coefficients(img, q, mode) != jpeg.
                           coefficients(img, q, mode, torch.float32)).sum())
        tried.append((seed, coded_apart))
        if _reference(cfg, img, torch.float32) != _reference(cfg, img):
            assert coded_apart > 0
            return
    pytest.fail(f"float32 scan equal to float64 on every seed: {tried}")
