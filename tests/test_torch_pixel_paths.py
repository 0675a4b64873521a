"""The port's pixel-path selectors against jpegtpu's: ``EncoderConfig``'s
``pixel_path`` and ``fuse_bp`` (validation messages, environment
defaults), the plain twins of the DC-plane (K12), i8-view (K13) and
async-copy (K14) pixel kernels against jpegtpu's TPU kernels in interpret
mode, and the bytes of every ``pixel_path`` x ``fuse_bp`` x mode x restart
configuration, and of ``JPEGTPU_PIXEL_DC``'s route, against
``jpegtpu.encode`` on the CPU. Every output is an integer or a byte, so
every comparison is exact (tolerance 0). The images are free of rounding
ties (ROADMAP.md, faults 3.1 and 3.5)."""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpegtpu
import jpegtpu.config
import jpegtpu_torch
from jpegtpu.kernels import fused_dctq
from jpegtpu_torch import EncoderTables
from jpegtpu_torch.kernels import fused_dctq as t_fused_dctq

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

QUALITY = 90
MODES = ("420", "422", "444", "444s", "gray")
# Per mode, a restart interval that leaves the last segment of a 37x53
# image short (4:2:0 has 12 MCUs, 4:2:2 20, the others 35).
RAGGED = {"420": 5, "422": 3, "444": 3, "444s": 3, "gray": 3}
# jpegtpu's Pallas pixel kernels of the selectors, each compiled once, in
# interpret mode on the CPU.
_nat_pairs = jax.jit(fused_dctq.encode_blocks_pallas_nat_pairs,
                     static_argnums=(1, 2), static_argnames=("with_dc",))
_i8_pairs = jax.jit(fused_dctq.encode_blocks_pallas_pairs,
                    static_argnums=(1, 2))
_dma_pairs = jax.jit(fused_dctq.encode_blocks_pallas_dma_pairs,
                     static_argnums=(1, 2))
_REFS = {}


def _random(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _image(mode):
    """The odd 37x53 fixture, free of ties in every mode at q90; at 4:2:0
    its 4 MCUs a row are no multiple of the 8 that jpegtpu's nat kernels
    need, so there jpegtpu's Pallas tier would take its XLA path."""
    img = _random(37, 53, 11)
    return np.ascontiguousarray(img[..., 0]) if mode == "gray" else img


def _jpegtpu(mode, restart):
    """jpegtpu.encode's file, once per (mode, restart): on the CPU its
    bytes do not depend on the selectors (checked below)."""
    if (mode, restart) not in _REFS:
        _REFS[mode, restart] = jpegtpu.encode(
            _image(mode), quality=QUALITY, subsampling=mode,
            restart_interval=restart)
    return _REFS[mode, restart]


@pytest.mark.parametrize("kw", [{"pixel_path": "bogus"},
                                {"pixel_path": "NAT"}, {"pixel_path": ""}])
def test_config_validation_matches_jpegtpu(kw):
    with pytest.raises(ValueError) as want:
        jpegtpu.config.EncoderConfig(**kw)
    with pytest.raises(ValueError) as got:
        jpegtpu_torch.EncoderConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("env", [
    {}, {"JPEGTPU_PIXEL_PATH": "xla"}, {"JPEGTPU_PIXEL_PATH": "dma"},
    {"JPEGTPU_FUSE_BP": "1"}, {"JPEGTPU_FUSE_BP": "0"},
    {"JPEGTPU_FUSE_BP": ""}, {"JPEGTPU_PIXEL_PATH": "nat",
                              "JPEGTPU_FUSE_BP": "yes"},
    {"JPEGTPU_PIXEL_PATH": "tpu"}])
def test_config_env_defaults_match_jpegtpu(monkeypatch, env):
    """The defaults come from the environment when a config is made, as
    jpegtpu's do; an unknown route raises jpegtpu's message."""
    for name in ("JPEGTPU_PIXEL_PATH", "JPEGTPU_FUSE_BP"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    try:
        want = jpegtpu.config.EncoderConfig()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            jpegtpu_torch.EncoderConfig()
        assert str(got.value) == str(e)
        return
    got = jpegtpu_torch.EncoderConfig()
    assert (got.pixel_path, got.fuse_bp) == (want.pixel_path, want.fuse_bp)


@pytest.fixture(scope="module")
def bands():
    """Two images of one 4:2:0 MCU row each, 16x7680: bands of 16 rows of
    chip_smoke's 1080p golden image side by side, free of rounding ties
    against all four of jpegtpu's kernels here (a random image this size
    has some). jpegtpu's kernels take the batch, the port's counterparts
    the tall image (the view its batch path gives them). 480 MCUs a row
    make jpegtpu's kernels take 2 rows a grid step where 8 MCUs a row
    would make them take 8, and their interpret-mode compile, the cost of
    these tests, grows with the rows a step."""
    g = chip_smoke.golden_image(h=128)
    batch = np.stack([np.concatenate([g[16 * k:16 * k + 16]
                                      for k in range(4 * i, 4 * i + 4)],
                                     axis=1) for i in range(2)])
    return batch.reshape(32, 7680, 3), jnp.asarray(batch)


def test_dc_plane_twin_matches_pallas_kernel_interpret(bands):
    """K12's twin against _pixel_kernel_nat_dc: the coefficients and the
    [nMCU, 8] plane, lanes 6 and 7 zero; through the batch path too."""
    img, batch = bands
    want_c, want_dc = _nat_pairs(batch, QUALITY, "420", with_dc=True)
    want_c = np.asarray(want_c).reshape(-1, 384)
    want_dc = np.asarray(want_dc).reshape(-1, 8)
    assert not want_dc[:, 6:].any()
    t = EncoderTables.for_quality(QUALITY)
    c, dc = t_fused_dctq.encode_blocks_pairs(torch.from_numpy(img), t.m,
                                             t.bias, with_dc=True)
    np.testing.assert_array_equal(c.numpy(), want_c)
    np.testing.assert_array_equal(dc.numpy(), want_dc)
    c, dc = t_fused_dctq.encode_blocks_batch(
        torch.from_numpy(np.array(batch)), t, "420", "nat", with_dc=True)
    np.testing.assert_array_equal(c.numpy(), want_c)
    np.testing.assert_array_equal(dc.numpy(), want_dc)


@pytest.mark.parametrize("mode,n_mcu", [("422", 8), ("444", 16)])
def test_dc_plane_twin_matches_pallas_kernel_interpret_422_444(mode, n_mcu):
    """K12's twin against _pixel_kernel_nat_dc in the other geometries that
    have a DC plane in jpegtpu, on one MCU row of one whole lane group (8
    MCUs of 48 bytes a row at 4:2:2, 16 of 24 at 4:4:4): the coefficients
    and the plane, lanes past the MCU's blocks zero; through the batch
    path too."""
    mh, mw = {"422": (8, 16), "444": (8, 8)}[mode]
    img = _random(mh, mw * n_mcu, 31)
    want_c, want_dc = _nat_pairs(jnp.asarray(img), QUALITY, mode,
                                 with_dc=True)
    want_c, want_dc = np.asarray(want_c), np.asarray(want_dc)
    n_blocks = want_c.shape[1] // 64
    assert want_dc.shape == (n_mcu, 8) and not want_dc[:, n_blocks:].any()
    t = EncoderTables.for_quality(QUALITY, mode)
    x = torch.from_numpy(img)
    c, dc = t_fused_dctq.encode_blocks_pairs(x, t.m, t.bias, mode,
                                             with_dc=True)
    np.testing.assert_array_equal(c.numpy(), want_c)
    np.testing.assert_array_equal(dc.numpy(), want_dc)
    c, dc = t_fused_dctq.encode_blocks_batch(x[None], t, mode, "nat",
                                             with_dc=True)
    np.testing.assert_array_equal(c.numpy(), want_c)
    np.testing.assert_array_equal(dc.numpy(), want_dc)


def test_i8_twin_matches_pallas_kernel_interpret(bands):
    """K13's twin (the centred int8 view, + 128 restored) against
    _pixel_kernel, which reads the same view."""
    img, batch = bands
    want = np.asarray(_i8_pairs(batch, QUALITY, "420")).reshape(-1, 384)
    t = EncoderTables.for_quality(QUALITY)
    got = t_fused_dctq.encode_blocks_i8_pairs(torch.from_numpy(img), t.m,
                                              t.bias)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dma_twin_matches_pallas_kernel_interpret(bands):
    """K14's route on the CPU against _pixel_kernel_dma."""
    img, batch = bands
    want = np.asarray(_dma_pairs(batch, QUALITY, "420")).reshape(-1, 384)
    t = EncoderTables.for_quality(QUALITY)
    got = t_fused_dctq.encode_blocks_dma_pairs(torch.from_numpy(img), t.m,
                                               t.bias)
    np.testing.assert_array_equal(got.numpy(), want)


def test_i8_view_restores_every_byte():
    """The int8 view x ^ 0x80 is x - 128, so + 128 gives back every u8
    value exactly."""
    x = torch.arange(256, dtype=torch.uint8)
    x8 = torch.bitwise_xor(x, 0x80).view(torch.int8)
    assert torch.equal(x8.to(torch.int64), x.to(torch.int64) - 128)
    assert torch.equal((x8.to(torch.float64) + 128.0).to(torch.uint8), x)


@pytest.mark.parametrize("mode", ["422", "444", "444s"])
def test_i8_and_dma_give_other_modes_to_the_matmul_route(mode):
    """Only 4:2:0 has the i8 and async-copy kernels (as in jpegtpu); the
    other modes get the "xla" route's coefficients."""
    img = torch.from_numpy(_random(40, 48, 5))
    t = EncoderTables.for_quality(QUALITY, mode)
    want = t_fused_dctq.encode_blocks_matmul_pairs(img, t.m, t.bias, mode)
    np.testing.assert_array_equal(
        want.numpy(), t_fused_dctq.encode_blocks_pairs(img, t.m, t.bias,
                                                       mode).numpy())
    for fn in (t_fused_dctq.encode_blocks_i8_pairs,
               t_fused_dctq.encode_blocks_dma_pairs):
        assert torch.equal(fn(img, t.m, t.bias, mode), want)


def test_pixel_path_is_checked():
    t = EncoderTables.for_quality(QUALITY)
    with pytest.raises(ValueError, match="pixel_path"):
        t_fused_dctq.encode_blocks_batch(
            torch.zeros((1, 16, 16, 3), dtype=torch.uint8), t, "420", "tpu")


def test_jpegtpu_bytes_ignore_the_selectors():
    """On the CPU jpegtpu's oracle path ignores pixel_path and fuse_bp, so
    one reference file per (mode, restart) stands for every selector."""
    img = _image("420")
    assert jpegtpu.encode(img, quality=QUALITY, pixel_path="dma",
                          fuse_bp=True) == _jpegtpu("420", "rows")


@pytest.mark.parametrize("fuse_bp", [False, True])
@pytest.mark.parametrize("pixel_path", ["nat", "xla", "dma"])
@pytest.mark.parametrize("restart", ["rows", 0, "ragged"])
@pytest.mark.parametrize("mode", MODES)
def test_selectors_encode_like_jpegtpu(mode, restart, pixel_path, fuse_bp):
    restart = RAGGED[mode] if restart == "ragged" else restart
    got = jpegtpu_torch.encode(_image(mode), QUALITY, mode, restart,
                               device="cpu", pixel_path=pixel_path,
                               fuse_bp=fuse_bp)
    assert got == _jpegtpu(mode, restart)


@pytest.mark.parametrize("restart", ["rows", 0, "ragged"])
@pytest.mark.parametrize("mode", MODES)
def test_pixel_dc_route_encodes_like_jpegtpu(monkeypatch, mode, restart):
    """JPEGTPU_PIXEL_DC's route: the DC differences from the DC plane."""
    monkeypatch.setattr(t_fused_dctq, "PIXEL_DC", True)
    restart = RAGGED[mode] if restart == "ragged" else restart
    got = jpegtpu_torch.encode(_image(mode), QUALITY, mode, restart,
                               device="cpu")
    assert got == _jpegtpu(mode, restart)


@pytest.mark.parametrize("value,want", [(None, False), ("0", False),
                                        ("1", True), ("on", True)])
def test_pixel_dc_reads_jpegtpus_variable(monkeypatch, value, want):
    """PIXEL_DC is read from JPEGTPU_PIXEL_DC at import, as jpegtpu's
    _PIXEL_DC (``fused_dctq.py:354``): "0" or unset is off, anything else
    on. The module is imported again under the variable, and once more
    without it afterwards."""
    monkeypatch.delenv("JPEGTPU_PIXEL_DC", raising=False)
    if value is not None:
        monkeypatch.setenv("JPEGTPU_PIXEL_DC", value)
    try:
        assert importlib.reload(t_fused_dctq).PIXEL_DC is want
    finally:
        monkeypatch.undo()
        importlib.reload(t_fused_dctq)
