"""The port's 4:2:2, 4:4:4, 4:4:4s and gray modes against jpegtpu: each
staged pixel op, the fused pixel twin at every geometry, the fused/staged
dispatch, the per-mode tables, and whole files for every mode at restart
"rows", 0 and a ragged interval.

The staged ops' float outputs are compared on integer-valued inputs, where
a mean of 2 or 4 samples is exact in both float32 and float64, so those
comparisons are exact too; the color conversion alone has a tolerance
(below). Coefficients and files are compared exactly, on fixtures checked
free of rounding ties (ROADMAP.md, faults 3.1): gray has ties on the
120x200 random fixture at q90 and q50 and on the smooth fixture at q90, so
gray takes the fixtures that have none."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpegtpu
from jpegtpu.core import ops, tables
from jpegtpu.entropy import huffman_tables as ht
from jpegtpu.kernels import fused_dctq
from jpegtpu_torch import EncoderTables
from jpegtpu_torch import encode as t_encode
from jpegtpu_torch.core import ops as t_ops
from jpegtpu_torch.encoder import block_operators
from jpegtpu_torch.kernels import fused_dctq as t_fused_dctq

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

MODES = ("422", "444", "444s", "gray")
_encode_blocks = jax.jit(fused_dctq.encode_blocks, static_argnums=(1, 2))
_staged = jax.jit(ops.encode_blocks, static_argnums=(1, 2))


def _random(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def images(smooth_img):
    return {"smooth": smooth_img, "random_120x200": _random(120, 200, 7),
            "odd_37x53": _random(37, 53, 11),
            "one_row_16x40": _random(16, 40, 13)}


def _plane(img, mode):
    return np.ascontiguousarray(img[..., 0]) if mode == "gray" else img


def _block_ops(q):
    return tuple(torch.from_numpy(a) for a in block_operators(q))


def test_rgb_to_ycbcr_matches():
    """Tolerance 1e-4: jpegtpu sums three float32 products in float32
    (values up to 255, ulp 1.5e-5); the port's float64 sum is exact to
    ~1e-13."""
    img = _random(37, 53, 1)
    want = np.asarray(ops.rgb_to_ycbcr(jnp.asarray(img)))
    got = t_ops.rgb_to_ycbcr(torch.from_numpy(img))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(37, 53), (16, 40), (1, 1), (2, 3)])
def test_smooth_chroma_2x2_matches(shape):
    """Odd last rows and columns pass through untouched."""
    ycc = _random(*shape, seed=sum(shape)).astype(np.float32)
    want = np.asarray(ops.smooth_chroma_2x2(jnp.asarray(ycc)))
    got = t_ops.smooth_chroma_2x2(torch.from_numpy(ycc).to(torch.float64))
    np.testing.assert_array_equal(got.numpy(), want)


def test_downsample_and_scan_blocks_match():
    ycc = _random(32, 48, 2).astype(np.float32)
    j, t = jnp.asarray(ycc), torch.from_numpy(ycc).to(torch.float64)
    for down, blocks in (("downsample_chroma_420", "scan_blocks_420"),
                         ("downsample_chroma_422", "scan_blocks_422")):
        want = getattr(ops, down)(j)
        got = getattr(t_ops, down)(t)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        np.testing.assert_array_equal(
            getattr(t_ops, blocks)(*got).numpy(),
            np.asarray(getattr(ops, blocks)(*want)))
    np.testing.assert_array_equal(
        t_ops.scan_blocks_444(t[..., 0], t[..., 1], t[..., 2]).numpy(),
        np.asarray(ops.scan_blocks_444(j[..., 0], j[..., 1], j[..., 2])))
    np.testing.assert_array_equal(t_ops.blockify(t[..., 0]).numpy(),
                                  np.asarray(ops.blockify(j[..., 0])))


def test_fused_dct_quant_zigzag_matches():
    """On blocks built to have no coefficient near x.5 at q90 (see
    chip_smoke.golden_blocks), for the luma and the chroma operator."""
    blocks = np.array(ops.blockify(jnp.asarray(
        chip_smoke.golden_blocks(64, 96, planes=1), jnp.float32)))
    blocks = blocks.reshape(-1, 64)
    bm, bb = _block_ops(90)
    for k, chroma in enumerate((False, True)):
        want = np.asarray(ops.fused_dct_quant_zigzag(jnp.asarray(blocks), 90,
                                                     chroma))
        got = t_ops.fused_dct_quant_zigzag(torch.from_numpy(blocks), bm[k],
                                           bb[k])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.count_nonzero(want[:, 1:]), "AC coefficients expected"


@pytest.mark.parametrize("q", [50, 90])
@pytest.mark.parametrize("mode", ("420",) + MODES)
def test_staged_encode_blocks_matches(images, mode, q):
    """The whole staged path of every mode on the odd 37x53 fixture."""
    img = _plane(images["odd_37x53"], mode)
    want = np.asarray(_staged(jnp.asarray(img), q, mode))
    got = t_ops.encode_blocks(torch.from_numpy(img), *_block_ops(q), mode)
    np.testing.assert_array_equal(got.numpy(), want)


# (fixture, quality) pairs free of ties per mode.
PIXEL_CASES = [(m, name, q) for m in ("422", "444", "444s")
               for name in ("smooth", "random_120x200", "odd_37x53")
               for q in (50, 90)] + [
    ("gray", "odd_37x53", 50), ("gray", "odd_37x53", 90),
    ("gray", "smooth", 50), ("gray", "one_row_16x40", 50)]


@pytest.mark.parametrize("mode,name,q", PIXEL_CASES)
def test_pixel_coefficients_match_jpegtpu(images, mode, name, q):
    """The dispatch (fused twin for 422/444 and 8-aligned 444s, staged ops
    for gray and odd 444s) against jpegtpu's fused_dctq.encode_blocks."""
    img = _plane(images[name], mode)
    want = np.asarray(_encode_blocks(jnp.asarray(img), q, mode))
    got = t_fused_dctq.encode_blocks(torch.from_numpy(img),
                                     EncoderTables.for_quality(q, mode), mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.reshape(want.shape[0],
                                                            -1))


# Gray coefficients that jpegtpu's float32 product and the port's float64
# sum round apart, per (fixture, quality): every one an exact x.5 tie
# (ROADMAP.md, faults 3.1). The fixtures of the cases above avoid them; a
# change in these counts is a change in how often the two encoders' gray
# files differ.
GRAY_TIE_COUNTS = {("smooth", 90): 4, ("random_120x200", 50): 1,
                   ("random_120x200", 90): 5, ("one_row_16x40", 90): 1}


@pytest.mark.parametrize("name,q", list(GRAY_TIE_COUNTS))
def test_gray_differs_from_jpegtpu_only_at_exact_ties(images, name, q):
    img = _plane(images[name], "gray")
    want = np.asarray(_encode_blocks(jnp.asarray(img), q, "gray")).reshape(-1)
    got = t_fused_dctq.encode_blocks(torch.from_numpy(img),
                                     EncoderTables.for_quality(q, "gray"),
                                     "gray").numpy().reshape(-1)
    # Each coefficient's exact value, from the float64 DCT and quantizers.
    blocks = t_ops.blockify(t_ops.pad_to_multiple(
        torch.from_numpy(img).to(torch.float64)[..., None], 8)[..., 0])
    c = tables.dct_matrix_8x8().astype(np.float64)
    quant = tables.scale_quant_table(tables.QUANT_LUMA, q).reshape(64, 1)
    kq = (np.kron(c, c) / quant)[tables.ZIGZAG_ORDER]
    exact = ((blocks.reshape(-1, 64).numpy() - 128) @ kq.T).reshape(-1)
    d = np.flatnonzero(got != want)
    assert d.size == GRAY_TIE_COUNTS[name, q]
    ties = np.floor(exact[d]) + 0.5
    assert np.abs(exact[d] - ties).max() < 1e-9
    # The port rounds each tie half away from zero; jpegtpu is 1 off.
    np.testing.assert_array_equal(got[d], np.sign(ties) * np.ceil(abs(ties)))
    np.testing.assert_array_equal(np.abs(got[d] - want[d]), 1)


def test_pixel_twin_matches_pallas_kernel_interpret():
    """jpegtpu's TPU pixel kernel itself (_pixel_kernel_nat, interpret
    mode) at the 4:2:2 geometry (jpegtpu's own tests hold it equal to
    fused_dctq.encode_blocks at the others, which the test above holds the
    port to)."""
    img = _random(16, 128, 3)
    want = np.asarray(fused_dctq.encode_blocks_pallas_nat_pairs(
        jnp.asarray(img), 90, "422"))
    t = EncoderTables.for_quality(90, "422")
    got = t_fused_dctq.encode_blocks_pairs(torch.from_numpy(img), t.m,
                                           t.bias, "422")
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_dispatch_and_operator_shapes():
    for h, w in ((8, 8), (37, 53), (16, 40), (120, 200), (9, 16)):
        for mode in ("420",) + MODES:
            want = mode != "gray" and not (mode == "444s" and (h % 8 or
                                                               w % 8))
            assert t_fused_dctq.uses_fused(h, w, mode) == want
    t = EncoderTables.for_quality(90, "444")
    img = torch.zeros((16, 16, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="operator"):
        t_fused_dctq.encode_blocks_pairs(img, t.m, t.bias, "420")
    with pytest.raises(ValueError, match="fused"):
        t_fused_dctq.encode_blocks_pairs(img, t.m, t.bias, "gray")


@pytest.mark.parametrize("mode", ("420",) + MODES)
def test_tables_for_quality_match_jpegtpu_arrays(mode):
    """EncoderTables of each mode from this package's copies = from
    jpegtpu's own arrays."""
    if mode == "gray":
        m, bias = tables.fused_block_operator(75, chroma=False)
    else:
        m, bias = fused_dctq.mcu_operator(75, mode)
    blk = [tables.fused_block_operator(75, c) for c in (False, True)]
    ref = EncoderTables.from_numpy(
        m, bias, *ht.packed_luts(), np.stack([b[0] for b in blk]),
        np.stack([b[1] for b in blk]))
    own = dict(EncoderTables.for_quality(75, mode).named_buffers())
    for name, buf in ref.named_buffers():
        assert torch.equal(own[name], buf), name


# (mode, fixture, quality, restart): every mode at restart "rows", 0 and
# a ragged interval, on the odd 37x53 and the one-row fixtures, and two
# 120x200 cases, all free of ties.
ENCODE_CASES = [(m, name, q, r) for m in MODES for name, q, r in (
    ("odd_37x53", 90, "rows"), ("odd_37x53", 50, 0), ("odd_37x53", 90, 3),
    ("one_row_16x40", 50, "rows"))] + [
    ("444s", "random_120x200", 90, 0), ("gray", "smooth", 50, 7)]


@pytest.mark.parametrize("mode,name,q,restart", ENCODE_CASES)
def test_encode_matches_jpegtpu(images, mode, name, q, restart):
    img = _plane(images[name], mode)
    kw = dict(quality=q, subsampling=mode, restart_interval=restart)
    assert t_encode(img, device="cpu", **kw) == jpegtpu.encode(img, **kw)


def test_gray_input_shapes(images):
    """Gray takes [H, W] and [H, W, 1] (the same file) and refuses RGB."""
    img = _plane(images["odd_37x53"], "gray")
    want = jpegtpu.encode(img, quality=90, subsampling="gray")
    for x in (img, img[..., None]):
        assert t_encode(x, quality=90, subsampling="gray",
                        device="cpu") == want
    with pytest.raises(ValueError, match="gray"):
        t_encode(images["odd_37x53"], subsampling="gray", device="cpu")
