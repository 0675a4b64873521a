"""The factored pixel product of K1, K12, K13, K14 and K11 on the CPU: the
factors reproduce ``mcu_operator`` bit for bit, every column's sum is
exact in float64 in any order, an operator that does not factor raises,
the factored plain form gives the dense twin's coefficients, its DC plane
(K12's) and, on the image the int8 view restores, the i8 twin's (K13's),
K11's scalar DC dot products give the dense twin's DC coefficients, every
coefficient fits K11's int16 tile at every quality and the fused wrapper
refuses an operator whose coefficients could not, ``Kernel.launch`` runs
on its operands' device, and a process that made ``EncoderTables`` exits
quietly. Imports no JAX: the port's
``mcu_operator`` is pinned to jpegtpu's by ``tests/test_torch_tables.py``
and ``tests/test_torch_modes.py``."""

import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jpegtpu_torch.core import ops
from jpegtpu_torch.encoder import EncoderTables
from jpegtpu_torch.kernels import _build, fused_dctq, fused_pipeline

MODES = ("420", "422", "444", "444s")
QUALITIES = (1, 10, 50, 75, 90, 95, 100)
# The qualities at which the GPU checks hold the pixel kernels to the twin.
PIXEL_QUALITIES = (1, 50, 90, 100)


def _random(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("mode", MODES)
def test_factor_operator_round_trips_bitwise(mode, q):
    m, bias = fused_dctq.mcu_operator(q, mode)
    lum, chroma = fused_dctq.factor_operator(m, mode, bias)
    g, _, _ = fused_dctq.chroma_groups(mode)
    assert lum.shape == (192, 64) and lum.dtype == np.float32
    assert chroma.shape == (g * 3, 128) and chroma.dtype == np.float32
    back = fused_dctq.expand_factors(lum, chroma, mode)
    np.testing.assert_array_equal(back.view(np.uint32), m.view(np.uint32))


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("mode", MODES)
def test_every_column_is_exact_in_float64(mode, q):
    """The bound of each column's sum over u8 pixels, bias included, lies
    at most 53 bits above the finest bit of its weights and bias (47 at
    most on these operators)."""
    m, bias = fused_dctq.mcu_operator(q, mode)
    bits = fused_dctq.operator_bits(m, bias)
    assert bits.shape == (m.shape[1],)
    assert int(bits.max()) <= 53


def test_operator_bits_counts_exactly():
    """One column of weights 1 and 2^-10 over u8 pixels: bound 255 * (1 +
    2^-10) < 2^8, finest bit 2^-10, so 18 bits; a bias of 2^40 makes it
    51, and 2^44 makes it 55."""
    m = np.array([[1.0], [2.0 ** -10]], np.float32)
    assert fused_dctq.operator_bits(m).tolist() == [18]
    assert fused_dctq.operator_bits(m, np.float32([2.0 ** 40])) == [51]
    assert fused_dctq.operator_bits(m, np.float32([2.0 ** 44])) == [55]


# One entry changed: a luma weight outside its block (modes with several
# luma blocks), a chroma weight that differs from the rest of its group
# (2x2 or 1x2 groups), or a weight of the one luma block made so small that
# its column is wider than 53 bits (the modes whose only change of one
# entry that keeps the expansion is to a factor).
PERTURBED = [("420", "luma"), ("420", "chroma"), ("422", "luma"),
             ("422", "chroma"), ("444s", "chroma"), ("444", "width"),
             ("444s", "width")]


@pytest.mark.parametrize("mode,where", PERTURBED)
def test_operator_that_does_not_factor_raises(mode, where):
    m, bias = fused_dctq.mcu_operator(90, mode)
    m = m.copy()
    n_luma = m.shape[1] // 64 - 2
    if where == "luma":         # pixel (0, 0), a column of the last block
        m[0, 64 * (n_luma - 1) + 5] = 0.25
    elif where == "chroma":     # the MCU's last pixel, a Cb column
        m[-1, 64 * n_luma + 3] *= 1.5
    else:
        m[0, 5] = 2.0 ** -100
    with pytest.raises(ValueError, match=mode):
        fused_dctq.factor_operator(m, mode, bias)
    with pytest.raises(ValueError, match=mode):
        fused_dctq.cuda_factors(torch.from_numpy(m), torch.from_numpy(bias),
                                mode)


@pytest.mark.parametrize("mode", MODES)
def test_too_wide_a_column_raises(mode):
    """A bias far above the weights' finest bit breaks the exactness
    condition: the factoring refuses it."""
    m, bias = fused_dctq.mcu_operator(90, mode)
    big = bias.copy()
    big[0] = 2.0 ** 40
    with pytest.raises(ValueError, match=f"{mode} operator has a column"):
        fused_dctq.factor_operator(m, mode, big)


@pytest.fixture(scope="module", params=["smooth", "random_120x200",
                                        "odd_37x53"])
def image(request, smooth_img):
    return {"smooth": smooth_img,
            "random_120x200": _random(120, 200, 7),
            "odd_37x53": _random(37, 53, 11)}[request.param]


@pytest.mark.parametrize("q", [50, 90])
@pytest.mark.parametrize("mode", MODES)
def test_factored_plain_equals_dense_plain(image, mode, q):
    t = EncoderTables.for_quality(q, mode)
    x = torch.from_numpy(image)
    want = fused_dctq.encode_blocks_pairs_plain(x, t.m, t.bias, mode)
    got = fused_dctq.encode_blocks_factored_plain(x, t.lum, t.chroma,
                                                  t.bias, mode)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("q", PIXEL_QUALITIES)
@pytest.mark.parametrize("mode", MODES)
def test_factored_dc_plane_equals_the_dense_twins(image, mode, q):
    """K12's arithmetic: the DC plane of the factored product is the dense
    twin's, lane k the coefficient of column 64k, the lanes past the MCU's
    blocks zero."""
    t = EncoderTables.for_quality(q, mode)
    x = torch.from_numpy(image)
    dense = fused_dctq.encode_blocks_pairs_plain(x, t.m, t.bias, mode)
    got = fused_dctq.dc_plane(fused_dctq.encode_blocks_factored_plain(
        x, t.lum, t.chroma, t.bias, mode))
    assert torch.equal(got, fused_dctq.dc_plane(dense))
    n_blocks = dense.shape[1] // 64
    assert torch.equal(got[:, :n_blocks], dense[:, ::64])
    assert not got[:, n_blocks:].any()


@pytest.mark.parametrize("q", PIXEL_QUALITIES)
def test_factored_plain_on_the_restored_i8_view(image, q):
    """K13's arithmetic: the factored product of the u8 image that the
    centred int8 view gives back byte for byte (view ^ 0x80) equals the i8
    twin of the view."""
    t = EncoderTables.for_quality(q, "420")
    x8 = fused_dctq.i8_view(torch.from_numpy(image))
    rows, _, nrx, _ = x8.shape
    restored = torch.bitwise_xor(x8.view(torch.uint8), 0x80).reshape(
        rows * 16, nrx * 16, 3)
    got = fused_dctq.encode_blocks_factored_plain(restored, t.lum, t.chroma,
                                                  t.bias, "420")
    assert torch.equal(got, fused_dctq.pixel_i8_plain(x8, t.m, t.bias))


@pytest.mark.parametrize("mode", MODES)
def test_factored_plain_on_a_batch_view(mode):
    """Three 37x53 images padded to whole MCUs and viewed as one tall image
    (the batch path's input): the per-image dense twins, in order."""
    imgs = torch.from_numpy(np.stack([_random(37, 53, s)
                                      for s in (11, 22, 23)]))
    t = EncoderTables.for_quality(75, mode)
    padded = ops.pad_to_multiple(imgs, ops.mcu_shape(mode))
    got = fused_dctq.encode_blocks_factored_plain(
        padded.reshape(-1, *padded.shape[2:]), t.lum, t.chroma, t.bias, mode)
    want = torch.cat([fused_dctq.encode_blocks_pairs_plain(im, t.m, t.bias,
                                                           mode)
                      for im in imgs])
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", MODES + ("gray",))
def test_encoder_tables_carry_the_factors(mode, monkeypatch):
    """for_quality and from_numpy factor once on the host, in the mode
    read off the operator, and ``kernel_factors`` gives the encoder's
    kernels those very tensors, after a move too; the memo of the wrappers
    that take (img, m, bias) factors an operator once, to the same
    factors, and anew once it is changed in place or given another bias."""
    t = EncoderTables.for_quality(90, mode)
    if mode == "gray":
        assert t.lum is None and t.chroma is None and t.subsampling is None
        return
    m, bias = fused_dctq.mcu_operator(90, mode)
    lum, chroma = fused_dctq.factor_operator(m, mode, bias)
    assert t.subsampling == mode
    assert np.array_equal(t.lum.numpy(), lum)
    assert np.array_equal(t.chroma.numpy(), chroma)
    ref = EncoderTables.from_numpy(m, bias, *(a.numpy() for a in (
        t.dc_codes, t.dc_lens, t.ac_codes, t.ac_lens, t.block_m,
        t.block_bias)))
    assert ref.subsampling == mode and torch.equal(ref.chroma, t.chroma)
    moved = t.to(torch.float32)
    got = fused_dctq.kernel_factors(moved, mode)
    assert (got[0] is moved.lum and got[1] is moved.chroma
            and got[2] is moved.bias)
    calls = []
    real = fused_dctq.factor_operator
    monkeypatch.setattr(fused_dctq, "factor_operator",
                        lambda *a: calls.append(a) or real(*a))
    for _ in range(2):
        got = fused_dctq.cuda_factors(moved.m, moved.bias, mode)
        assert len(calls) == 1
        assert torch.equal(got[0], t.lum) and torch.equal(got[1], t.chroma)
    moved.m.mul_(1.0)           # in place: a new version of the operator
    fused_dctq.cuda_factors(moved.m, moved.bias, mode)
    assert len(calls) == 2
    other = moved.bias.clone()
    fused_dctq.cuda_factors(moved.m, other, mode)
    assert len(calls) == 3 and calls[-1][2] is other
    fused_dctq.cuda_factors(moved.m, other, mode)
    assert len(calls) == 3


def test_factor_lookup_checks_the_width_with_the_given_bias():
    """The same operator with a bias that makes a column wider than 53
    bits raises, although its factors were recorded with the tables'
    bias."""
    t = EncoderTables.for_quality(90, "420")
    wide = t.bias.clone()
    wide[0] = 2.0 ** 40
    with pytest.raises(ValueError, match="420 operator has a column"):
        fused_dctq.cuda_factors(t.m, wide, "420")


def _perturbed_tables(mode, where):
    t = EncoderTables.for_quality(90, mode)
    m = t.m.clone()
    n_luma = m.shape[1] // 64 - 2
    if where == "luma":
        m[0, 64 * (n_luma - 1) + 5] = 0.25
    elif where == "chroma":
        m[-1, 64 * n_luma + 3] *= 1.5
    else:
        m[0, 5] = 2.0 ** -100
    return lambda: EncoderTables(m, t.bias, *t.luts(), t.block_m,
                                 t.block_bias)


@pytest.mark.parametrize("mode,where", [p for p in PERTURBED
                                        if p != ("444s", "chroma")])
def test_encoder_tables_refuse_an_operator_that_does_not_factor(mode,
                                                                where):
    """The constructor factors whatever operator it is given, in the mode
    its shape and groups give: one that is no expansion of its factors
    raises (a [192, 192] one that is no 4:4:4s operator is read as
    4:4:4)."""
    with pytest.raises(ValueError, match="444" if mode == "444s" else mode):
        _perturbed_tables(mode, where)()


def test_encoder_tables_read_uneven_groups_as_444():
    """A 4:4:4s operator with one chroma weight off its 2x2 group is a
    4:4:4 operator: the constructor factors it with 1x1 groups, and the
    factored product still gives the dense twin's integers."""
    t = _perturbed_tables("444s", "chroma")()
    assert t.subsampling == "444" and t.chroma.shape == (192, 128)
    x = torch.from_numpy(_random(24, 40, 5))
    assert torch.equal(
        fused_dctq.encode_blocks_factored_plain(x, t.lum, t.chroma, t.bias,
                                                "444"),
        fused_dctq.encode_blocks_pairs_plain(x, t.m, t.bias, "444"))


class _Stream:
    def __init__(self, device):
        self.cuda_stream = 1000 + device.index


@pytest.mark.parametrize("index", [0, 1, 3])
def test_kernel_launch_enters_the_operands_device(index, monkeypatch):
    """Kernel.launch makes its operands' device current around the
    launcher and passes that device's current stream, whichever device was
    current before."""
    entered, current, args_seen = [], [], []

    @contextlib.contextmanager
    def device(dev):
        entered.append(torch.device(dev))
        current.append(torch.device(dev))
        yield
        current.pop()

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: _Stream(torch.device(dev)))
    k = _build.Kernel("jt_test", [_build.PTR, _build.I64])
    k._fn = lambda *a: args_seen.append((a, list(current))) or 0
    dev = torch.device("cuda", index)
    k.launch(dev, 1234, 5)
    assert entered == [dev] and current == []
    assert args_seen == [((1234, 5, 1000 + index), [dev])]
    assert k.launches == 1
    k._fn = lambda *a: 719
    with pytest.raises(RuntimeError, match="jt_test: CUDA error 719"):
        k.launch(dev, 1234, 5)
    assert k.launches == 1


def test_factor_table_is_quiet_at_exit():
    """The factor table's weak-reference callbacks may run after the
    module's globals are cleared at interpreter exit (ROADMAP fault 3.9): a
    process that made tables in every mode exits with nothing ignored on
    stderr."""
    code = ("from jpegtpu_torch.encoder import EncoderTables\n"
            "t = [EncoderTables.for_quality(90, m, 'cpu')\n"
            "     for m in ('420', '422', '444', '444s', 'gray')]\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Exception ignored" not in res.stderr, res.stderr


@pytest.mark.parametrize("q", PIXEL_QUALITIES)
@pytest.mark.parametrize("mode", fused_pipeline.FUSED_MODES)
def test_halo_dc_equals_the_dense_twins_dc(image, mode, q):
    """K11's arithmetic where a block's run of tiles starts: the scalar
    float64 dot products of each MCU's pixels with the factors' DC columns
    (lum's 0 over the last luma block, chroma's 0 and 64 over the group
    sums), plus the bias and rounded, are the dense twin's DC
    coefficients of that block, Cb and Cr, which predict the next MCU."""
    t = EncoderTables.for_quality(q, mode)
    x = torch.from_numpy(image)
    dense = fused_dctq.encode_blocks_pairs_plain(x, t.m, t.bias, mode)
    n_luma = dense.shape[1] // 64 - 2
    got = fused_pipeline.halo_dc_plain(x, t.lum, t.chroma, t.bias, mode)
    assert got.dtype == torch.int32
    assert torch.equal(got, dense[:, [64 * (n_luma - 1), 64 * n_luma,
                                      64 * n_luma + 64]])


@pytest.mark.parametrize("mode", fused_pipeline.FUSED_MODES)
def test_every_coefficient_fits_int16_at_every_quality(mode):
    """K11 keeps a tile's coefficients in int16: at every quality 1-100 the
    widest column's bound over u8 pixels, bias included, is at most 32,767
    (3,064.0 at most: the DC column's 255 * 8 + 1,024)."""
    bounds = [fused_dctq.coefficient_bound(*fused_dctq.mcu_operator(q, mode))
              for q in range(1, 101)]
    assert max(bounds) <= fused_dctq.INT16_MAX
    assert 3064 <= max(bounds) < 3064.001


def test_coefficient_bound_counts_exactly():
    """Columns [1, 0.5] and [-2, 0] over u8 pixels with biases -3 and 10:
    255 * 1.5 + 3 and 255 * 2 + 10, the larger, raised by 2**-40."""
    m = np.array([[1.0, -2.0], [0.5, 0.0]], np.float32)
    got = fused_dctq.coefficient_bound(m, np.float32([-3.0, 10.0]))
    assert got == 520.0 * (1 + 2.0 ** -40)
    assert fused_dctq.coefficient_bound(m) == 510.0 * (1 + 2.0 ** -40)


def test_fused_wrapper_refuses_coefficients_past_int16():
    """The 4:2:0 operator and bias times 64 still factor and are exact in
    float64, but their coefficients could reach 64 * 3,064: the tables
    hold that bound, and the fused wrapper and its twin raise on it."""
    t = EncoderTables.for_quality(90, "420")
    big = EncoderTables(t.m * 64, t.bias * 64, *t.luts(), t.block_m,
                        t.block_bias)
    assert big.coefficient_bound == 64 * t.coefficient_bound
    assert fused_dctq.coefficient_bound(big.m, big.bias) == \
        big.coefficient_bound
    x = torch.from_numpy(_random(16, 16, 3))
    for fn in (fused_pipeline.fused_pixel_block_pack_pairs,
               fused_pipeline.fused_pixel_block_pack_pairs_plain):
        with pytest.raises(ValueError, match="int16"):
            fn(x, big, "420", 0)
