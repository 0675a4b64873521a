"""The port's fused front end (K11, ``kernels.fused_pipeline``) against
jpegtpu's: its plain twin against jpegtpu's ``_fused_px_bp_kernel`` in
interpret mode, word and length, then its contract with the split stages
(pixel product, DC differences, block pack) word for word, zeros past each
length included, at every mode it takes, widths whose MCU count is no
multiple of 8, restart intervals that reset inside and across rows, and a
batch viewed as one tall image; ``encode_batch`` with ``fuse_bp`` against
``jpegtpu.encode_batch``. Every comparison is exact (tolerance 0); the
images are free of rounding ties (ROADMAP.md, faults 3.1 and 3.5)."""

import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpegtpu
from jpegtpu.kernels import entropy_pack, fused_pipeline
import jpegtpu_torch
from jpegtpu_torch import EncoderTables
from jpegtpu_torch.core import ops
from jpegtpu_torch.encoder import _segments
from jpegtpu_torch.entropy import scan
from jpegtpu_torch.kernels import entropy_pack as t_entropy_pack
from jpegtpu_torch.kernels import fused_dctq as t_fused_dctq
from jpegtpu_torch.kernels import fused_pipeline as t_fused_pipeline

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

QUALITY = 90
# jpegtpu's fused kernel, compiled once (interpret mode on the CPU).
_fused = jax.jit(fused_pipeline.fused_pixel_block_pack_pairs,
                 static_argnums=(1, 2, 3, 4, 5))
# Per mode, a restart interval dividing a 37x53 image's MCU count (4:2:0
# 12 MCUs, 4:2:2 20, 4:4:4 35), as test_torch_batch.py's.
DIVIDING = {"420": 3, "422": 2, "444": 5, "444s": 5, "gray": 1}


def _random(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _first_bits_equal(got, want, nbits):
    """Rows of u32 words agree on their first nbits[i] bits."""
    for i, n in enumerate(np.asarray(nbits, np.int64)):
        full, tail = divmod(int(n), 32)
        np.testing.assert_array_equal(got[i, :full], want[i, :full])
        if tail:
            mask = np.uint32((0xFFFFFFFF << (32 - tail)) & 0xFFFFFFFF)
            assert got[i, full] & mask == want[i, full] & mask, i


def test_fused_twin_matches_pallas_kernel_interpret():
    """Two images of one 4:2:0 MCU row each (16x7680, bands of chip_smoke's
    tie-free golden image, as in test_torch_pixel_paths.py) as a batch
    (jpegtpu's kernel) and as one tall image (the port's), restart 8:
    resets inside each 480-MCU row and at each image start. Wide rows keep
    the interpret-mode compile short (it grows with the rows of a grid
    step)."""
    g = chip_smoke.golden_image(h=128)
    batch = np.stack([np.concatenate([g[16 * k:16 * k + 16]
                                      for k in range(4 * i, 4 * i + 4)],
                                     axis=1) for i in range(2)])
    img = batch.reshape(32, 7680, 3)
    chunks, _ = entropy_pack.mcu_capacity(6, 384)
    want_w, want_l = _fused(jnp.asarray(batch), QUALITY, "420", 8, chunks, 4)
    want_w, want_l = np.asarray(want_w), np.asarray(want_l)
    mw, ml = t_fused_pipeline.fused_pixel_block_pack_pairs(
        torch.from_numpy(img), EncoderTables.for_quality(QUALITY), "420", 8)
    np.testing.assert_array_equal(ml.numpy(), want_l)
    got = mw.numpy().view(np.uint32)
    _first_bits_equal(got, want_w, want_l)
    j = np.arange(got.shape[1])[None, :]
    assert not got[j * 32 >= ml.numpy()[:, None]].any()


def _split(x, tables, mode, restart):
    """The split stages on the CPU: the pixel twin, the DC glue, the class
    vector and the block-pack twin."""
    c = t_fused_dctq.encode_blocks_pairs(x, tables.m, tables.bias, mode)
    g = c.shape[1] // 64
    dcd = scan.dc_diffs_from_dc(c[:, ::64], g - 2, restart).reshape(-1)
    cls = t_entropy_pack.block_classes(c.shape[0], g, g - 2, c.device)
    return t_entropy_pack.block_pack_mcu_pairs(c, cls, dcd, *tables.luts())


# (mode, h, w, restart): widths with 4 and 13 MCUs a row at 4:2:0 (no
# multiple of 8), g = 6, 4 and 3, no restart, a reset after every MCU, and
# intervals that fall inside rows and cross them.
CONTRACT_CASES = [(m, h, w, r) for m in ("420", "422", "444")
                  for h, w in ((37, 53), (120, 200)) for r in (0, 1, 5)] + [
    ("420", 120, 200, 13), ("444", 1, 1, 0), ("420", 16, 16, 0)]


@pytest.mark.parametrize("mode,h,w,restart", CONTRACT_CASES)
def test_fused_matches_split_stages(mode, h, w, restart):
    x = torch.from_numpy(_random(h, w, h * w))
    t = EncoderTables.for_quality(QUALITY, mode)
    mw, ml = t_fused_pipeline.fused_pixel_block_pack_pairs(x, t, mode,
                                                           restart)
    want_w, want_l = _split(x, t, mode, restart)
    assert mw.dtype == ml.dtype == torch.int32
    assert torch.equal(ml, want_l) and torch.equal(mw, want_w)


@pytest.mark.parametrize("mode", ["420", "422", "444"])
def test_fused_on_a_batch_view_matches_the_encoder_split(mode):
    """Three padded 37x53 images viewed as one tall image, restart one MCU
    row: the streams and lengths of the encoder's split segments."""
    imgs = torch.from_numpy(np.stack([_random(37, 53, s)
                                      for s in (11, 22, 23)]))
    t = EncoderTables.for_quality(QUALITY, mode)
    my, mx = ops.mcu_grid(37, 53, mode)
    padded = ops.pad_to_multiple(imgs, ops.mcu_shape(mode))
    mw, ml = t_fused_pipeline.fused_pixel_block_pack_pairs(
        padded.reshape(-1, *padded.shape[2:]), t, mode, mx)
    want_w, want_l = _split(padded.reshape(-1, *padded.shape[2:]), t, mode,
                            mx)
    assert torch.equal(ml, want_l) and torch.equal(mw, want_w)
    fused = _segments(imgs, t, mode, mx, 3 * my, mx, fuse_bp=True)
    split = _segments(imgs, t, mode, mx, 3 * my, mx)
    assert all(torch.equal(a, b) for a, b in zip(fused, split))


def test_fused_wrapper_rejects_what_it_does_not_take():
    x = torch.zeros((16, 16, 3), dtype=torch.uint8)
    t420 = EncoderTables.for_quality(QUALITY, "420")
    for mode in ("444s", "gray"):
        with pytest.raises(ValueError, match="fused front end"):
            t_fused_pipeline.fused_pixel_block_pack_pairs(
                x, EncoderTables.for_quality(QUALITY, mode), mode, 0)
    with pytest.raises(ValueError, match="operator"):
        t_fused_pipeline.fused_pixel_block_pack_pairs(x, t420, "444", 0)
    with pytest.raises(ValueError, match="uint8"):
        t_fused_pipeline.fused_pixel_block_pack_pairs(x.float(), t420,
                                                      "420", 0)
    with pytest.raises(ValueError, match="restart"):
        t_fused_pipeline.fused_pixel_block_pack_pairs(x, t420, "420", -1)


@pytest.mark.parametrize("restart", ["rows", "dividing"])
@pytest.mark.parametrize("mode", ["420", "422", "444", "444s", "gray"])
def test_fused_batch_encodes_like_jpegtpu(mode, restart):
    """encode_batch with fuse_bp: one program (no fallback warning; the
    fused kernel for 4:2:0, 4:2:2 and 4:4:4, the split kernels for the
    others) giving jpegtpu.encode_batch's files."""
    restart = DIVIDING[mode] if restart == "dividing" else restart
    imgs = [_random(37, 53, s) for s in (11, 22, 23)]
    if mode == "gray":
        imgs = [np.ascontiguousarray(im[..., 0]) for im in imgs]
    kw = dict(quality=QUALITY, subsampling=mode, restart_interval=restart)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = jpegtpu_torch.encode_batch(imgs, device="cpu", fuse_bp=True,
                                         **kw)
    assert got == jpegtpu.encode_batch(imgs, **kw)
