"""The port's encoder end to end against jpegtpu.encode, plus its guards:
no JAX import, no silent CPU fallback, every mode and restart interval that
slice 1 refused now encoding like jpegtpu, and chip_smoke.py's golden
hashes."""

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
from jpegtpu.core import tables as jtables
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
    blk = [jtables.fused_block_operator(q, c) for c in (False, True)]
    tables = EncoderTables.from_numpy(*fused_dctq.mcu_operator(q, "420"),
                                      *ht.packed_luts(),
                                      np.stack([b[0] for b in blk]),
                                      np.stack([b[1] for b in blk]),
                                      device="cpu")
    restart = -(-img.shape[1] // 16)
    buf, total = device_encode(torch.from_numpy(img), tables, "420", restart)
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


@pytest.mark.parametrize("name", sorted(chip_smoke.GOLDENS))
def test_path_golden_hashes_match_jpegtpu(name):
    """Each other path's golden constant in chip_smoke.py is jpegtpu's file
    of that path's golden image (chosen or built free of rounding ties)."""
    sub, restart, image_name, sha = chip_smoke.GOLDENS[name]
    ref = jpegtpu.encode(chip_smoke.golden_input(image_name),
                         quality=chip_smoke.QUALITY, subsampling=sub,
                         restart_interval=restart)
    assert hashlib.sha256(ref).hexdigest() == sha


def test_import_does_not_load_jax():
    code = ("import sys, jpegtpu_torch, jpegtpu_torch.kernels._build, "
            "jpegtpu_torch.kernels.compact, jpegtpu_torch.native, "
            "jpegtpu_torch.kernels.fused_pipeline, jpegtpu_torch.encoder; "
            "assert jpegtpu_torch.encode_batch and "
            "jpegtpu_torch.BatchGeometryError; "
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
def test_former_slice_limits_encode_like_jpegtpu(kw):
    """The configurations slice 1 refused with NotImplementedError now
    return jpegtpu's bytes (the odd 37x53 fixture, free of ties in every
    mode at q90)."""
    img = _random(37, 53, 11)
    if kw.get("subsampling") == "gray":
        img = np.ascontiguousarray(img[..., 0])
    enc = jpegtpu_torch.Encoder(jpegtpu_torch.EncoderConfig(quality=90, **kw),
                                device="cpu")
    assert enc.encode(img) == jpegtpu.encode(img, quality=90, **kw)


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
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    # Both runs at once: each spends its time importing torch.
    procs = [subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cwd in (REPO, tmp_path)]
    for proc in procs:
        stdout, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0 and stdout == ""
