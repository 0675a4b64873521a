"""The port's encoder end to end against jpegtpu.encode, plus its guards:
no JAX import, no silent CPU fallback, NotImplementedError outside the
4:2:0 rows-restart slice, and chip_smoke.py's golden hash."""

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jpegtpu
import jpegtpu.config
import jpegtpu_torch
from jpegtpu.entropy import huffman_tables as ht
from jpegtpu.kernels import fused_dctq
from jpegtpu_torch.container import jfif
from jpegtpu_torch.encoder import EncoderTables, device_encode

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

QUALITIES = [50, 90]
_REFS = {}


def _random(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module", params=["smooth", "random_120x200",
                                        "odd_37x53", "one_row_16x40"])
def image(request, smooth_img):
    """The test fixtures, plus one MCU row: a single segment, no RST."""
    return request.param, {"smooth": smooth_img,
                           "random_120x200": _random(120, 200, 7),
                           "odd_37x53": _random(37, 53, 11),
                           "one_row_16x40": _random(16, 40, 13),
                           }[request.param]


def _jpegtpu(name, img, q):
    if (name, q) not in _REFS:
        _REFS[name, q] = jpegtpu.encode(img, quality=q, subsampling="420")
    return _REFS[name, q]


@pytest.mark.parametrize("q", QUALITIES)
def test_encode_matches_jpegtpu(image, q):
    name, img = image
    got = jpegtpu_torch.encode(img, quality=q, subsampling="420",
                               device="cpu")
    assert got == _jpegtpu(name, img, q)


@pytest.mark.parametrize("q", QUALITIES)
def test_encode_with_jpegtpu_tables_matches(image, q):
    """The device program on tables built from jpegtpu's own arrays."""
    name, img = image
    tables = EncoderTables.from_numpy(*fused_dctq.mcu_operator(q, "420"),
                                      *ht.packed_luts(), device="cpu")
    restart = -(-img.shape[1] // 16)
    buf, total = device_encode(torch.from_numpy(img), tables, restart)
    got = jfif.wrap_jpeg(img.shape[0], img.shape[1], q, "420", restart,
                         buf[:int(total)].numpy().tobytes())
    assert got == _jpegtpu(name, img, q)


def test_golden_hash_matches_jpegtpu():
    """chip_smoke.py's constant is jpegtpu's file, and the port's CPU path
    gives the same file."""
    img = chip_smoke.golden_image()
    assert img.shape == (1080, 1920, 3)
    ref = jpegtpu.encode(img, quality=chip_smoke.QUALITY, subsampling="420")
    assert hashlib.sha256(ref).hexdigest() == chip_smoke.GOLDEN_SHA256
    got = jpegtpu_torch.encode(img, quality=chip_smoke.QUALITY,
                               subsampling="420", device="cpu")
    assert got == ref


def test_import_does_not_load_jax():
    code = ("import sys, jpegtpu_torch, jpegtpu_torch.kernels._build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'jpegtpu')]; print(bad); assert not bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        jpegtpu_torch.Encoder(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        jpegtpu_torch.encode(_random(16, 16, 0), device=None)


@pytest.mark.parametrize("kw", [
    {"subsampling": "444"}, {"subsampling": "444s"}, {"subsampling": "422"},
    {"subsampling": "gray"}, {"restart_interval": 0},
    {"restart_interval": 3}])
def test_outside_the_slice_raises(kw):
    cfg = jpegtpu_torch.EncoderConfig(quality=90, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jpegtpu_torch.Encoder(cfg, device="cpu")


@pytest.mark.parametrize("kw", [
    {"quality": 0}, {"quality": 101}, {"subsampling": "421"},
    {"restart_interval": -1}, {"restart_interval": "cols"}])
def test_config_validation_matches_jpegtpu(kw):
    with pytest.raises(ValueError) as want:
        jpegtpu.config.EncoderConfig(**kw)
    with pytest.raises(ValueError) as got:
        jpegtpu_torch.EncoderConfig(**kw)
    assert str(got.value) == str(want.value)


def test_config_geometry_matches_jpegtpu():
    for sub in ("444", "444s", "420", "422", "gray"):
        a = jpegtpu.config.EncoderConfig(subsampling=sub)
        b = jpegtpu_torch.EncoderConfig(subsampling=sub)
        assert (a.mcu_shape, a.blocks_per_mcu, a.n_luma,
                a.resolve_restart(7)) == (b.mcu_shape, b.blocks_per_mcu,
                                          b.n_luma, b.resolve_restart(7))


def test_bad_input_raises():
    enc = jpegtpu_torch.Encoder(device="cpu")
    with pytest.raises(ValueError, match="RGB"):
        enc.encode(np.zeros((16, 16), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        enc.encode(np.zeros((16, 16, 3), np.float32))


def test_chip_smoke_without_cuda_fails(tmp_path):
    """Without a GPU, and alone in a directory, the smoke test exits
    non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
