"""The port's pixel stage against jpegtpu's: the plain twin of the pixel
kernel (float64 product) must give jpegtpu's coefficients exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu.core import ops
from jpegtpu.kernels import fused_dctq
from jpegtpu_torch.core import ops as t_ops
from jpegtpu_torch.encoder import EncoderTables
from jpegtpu_torch.kernels import fused_dctq as t_fused_dctq

# jpegtpu's pixel paths, each compiled once per shape. The Pallas one is
# jitted as test_torch_batch.py's batch program jits it, which calls it on
# the same batch: in one process the two share its interpret-mode compile.
_xla_pairs = jax.jit(fused_dctq.encode_blocks_pairs, static_argnums=(1, 2))
_pallas_pairs = jax.jit(fused_dctq.encode_blocks_pallas_nat_pairs,
                        static_argnums=(1, 2), static_argnames=("with_dc",))


def _random(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module", params=["smooth", "random_120x200",
                                        "odd_37x53"])
def image(request, smooth_img):
    return {"smooth": smooth_img,
            "random_120x200": _random(120, 200, 7),
            "odd_37x53": _random(37, 53, 11)}[request.param]


def _twin(img, q):
    t = EncoderTables.for_quality(q)
    return t_fused_dctq.encode_blocks_pairs(torch.from_numpy(img), t.m,
                                            t.bias).numpy()


@pytest.mark.parametrize("q", [50, 90])
def test_pixel_twin_matches_jpegtpu_exactly(image, q):
    want = np.asarray(_xla_pairs(jnp.asarray(image), q, "420"))
    got = _twin(image, q)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pixel_twin_matches_pallas_kernel_interpret():
    """The TPU pixel kernel itself (_pixel_kernel_nat, interpret mode) on a
    64x128 image given as a batch of its two MCU-row halves, whose MCUs in
    order are the image's: the port's twin of the whole image and its
    batch pixel path both give the kernel's coefficients."""
    img = _random(64, 128, 3)
    halves = np.stack([img[:32], img[32:]])
    want = np.asarray(_pallas_pairs(jnp.asarray(halves), 90, "420",
                                    with_dc=False)).reshape(-1, 384)
    np.testing.assert_array_equal(_twin(img, 90), want)
    got = t_fused_dctq.encode_blocks_batch(
        torch.from_numpy(halves), EncoderTables.for_quality(90), "420")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("view", ["image", "batch_view"])
def test_factored_plain_matches_pallas_kernel_interpret(view):
    """The factored product of K1 and K14 (the luma block operator on each
    block's pixels, the chroma factor on the exact 2x2 group sums), in
    torch, gives the TPU pixel kernel's coefficients on the same 64x128
    image and batch of its halves (the compile the test above jits)."""
    img = _random(64, 128, 3)
    halves = np.stack([img[:32], img[32:]])
    want = np.asarray(_pallas_pairs(jnp.asarray(halves), 90, "420",
                                    with_dc=False)).reshape(-1, 384)
    x = img if view == "image" else halves.reshape(64, 128, 3)
    t = EncoderTables.for_quality(90)
    got = t_fused_dctq.encode_blocks_factored_plain(torch.from_numpy(x),
                                                    t.lum, t.chroma, t.bias)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(37, 53), (16, 16), (5, 7), (16, 3),
                                   (30, 17), (1, 1)])
def test_pad_to_multiple_matches(shape):
    """Symmetric mirror (edge sample repeated), and the edge fallback when
    a pad is at least as long as its axis."""
    img = _random(*shape, seed=sum(shape))
    want = np.asarray(ops.pad_to_multiple(jnp.asarray(img), (16, 16)))
    got = t_ops.pad_to_multiple(torch.from_numpy(img), (16, 16)).numpy()
    np.testing.assert_array_equal(got, want)


def test_round_half_away_and_mcu_tiles():
    x = np.array([-2.5, -1.5, -0.5, -0.49, 0.0, 0.49, 0.5, 1.5, 2.5],
                 np.float64)
    np.testing.assert_array_equal(
        t_ops.round_half_away(torch.from_numpy(x)).numpy(),
        np.asarray(ops.round_half_away(jnp.asarray(x))))
    img = _random(32, 48, 5)
    np.testing.assert_array_equal(
        t_fused_dctq.mcu_tiles(torch.from_numpy(img), 16, 16).numpy(),
        np.asarray(fused_dctq.mcu_tiles(jnp.asarray(img), 16, 16)))
    assert t_ops.mcu_grid(37, 53, "420") == ops.mcu_grid(37, 53, "420")


def test_pixel_wrapper_rejects_bad_input():
    t = EncoderTables.for_quality(90)
    with pytest.raises(ValueError, match="uint8"):
        t_fused_dctq.encode_blocks_pairs(torch.zeros(16, 16, 3), t.m, t.bias)
    with pytest.raises(ValueError, match="uint8"):
        t_fused_dctq.encode_blocks_pairs(
            torch.zeros(16, 16, dtype=torch.uint8), t.m, t.bias)
