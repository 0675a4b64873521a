"""Where the pixel routes read images whose height is not whole MCUs, on
the CPU: ``fused_dctq.row_fold`` (which shapes K1 and K12 read unpadded,
mirroring the last MCU row themselves), a numpy model of the kernel's
folded row read against ``ops.pad_to_multiple``, which routes and shapes
keep the gather, and the ``fused_dctq.PADS`` counters. The kernels run
only on the card (``tests/test_torch_cuda.py``); here the launch is
replaced by a recorder, or the tensor is on the CPU and takes the plain
twin. Imports no JAX."""

import numpy as np
import pytest
import torch

from jpegtpu_torch.core import ops
from jpegtpu_torch.encoder import EncoderTables, device_encode_batch
from jpegtpu_torch.kernels import fused_dctq

# (h, w, mode, folds): heights that are not whole MCUs with whole-MCU
# widths fold; whole heights, widths that are not whole MCUs and pads at
# least as long as the image (numpy's edge case) do not.
SHAPES = [
    (1080, 1920, "420", True), (1081, 1920, "420", True),
    (1087, 1920, "420", True), (1090, 1920, "420", True),
    (24, 208, "420", True), (9, 16, "420", True),
    (1083, 1920, "422", True), (17, 208, "444", True),
    (17, 208, "444s", True), (5, 8, "444", True),
    (2160, 3840, "420", False), (1088, 1920, "420", False),
    (16, 16, "420", False), (48, 520, "444", False),
    (1080, 1921, "420", False), (37, 53, "420", False),
    (17, 204, "422", False),
    (8, 16, "420", False), (5, 16, "420", False), (1, 8, "444", False),
    (4, 16, "422", False),
]


@pytest.mark.parametrize("h,w,mode,folds", SHAPES)
def test_which_shapes_fold(h, w, mode, folds):
    assert fused_dctq.row_fold(h, w, mode) is folds


def _folded_rows(n, h, mh):
    """The image row each staged row reads under the kernel's fold
    (``Staging::fetch`` with kRowFold): MCU row ``row`` of the tall view,
    pixel row y -> image i = row // my, p = (row - i * my) * mh + y, row
    i * h + min(p, 2h - 1 - p)."""
    my = -(-h // mh)
    row = np.arange(n * my)[:, None]
    y = np.arange(mh)[None, :]
    i = row // my
    p = (row - i * my) * mh + y
    return (i * h + np.minimum(p, 2 * h - 1 - p)).ravel()


@pytest.mark.parametrize("mh", [8, 16])
def test_folded_rows_are_the_symmetric_pad(mh):
    """For every height up to 6 MCU rows that folds, the fold's rows are
    the rows ``pad_to_multiple`` copies, image by image, in a batch of
    three: the kernel reads what the gather would have made."""
    mode = "420" if mh == 16 else "444"
    for h in range(1, 6 * mh + 1):
        if not fused_dctq.row_fold(h, mh, mode):
            continue
        n, my = 3, -(-h // mh)
        rows = torch.arange(n * h).reshape(n, h, 1, 1).expand(n, h, mh, 1)
        want = ops.pad_to_multiple(rows, (mh, mh))[:, :, 0, 0].reshape(-1)
        assert want.shape[0] == n * my * mh
        np.testing.assert_array_equal(_folded_rows(n, h, mh), want.numpy())


class _Recorder:
    """Stands in for ``fused_dctq._launch_factored``: records the image it
    would launch on and the kernel's arguments, returns placeholders."""

    def __init__(self):
        self.calls = []

    def __call__(self, kernel, img, factors, subsampling, *extra,
                 with_dc=False, mcu_rows=None):
        self.calls.append((kernel, img, extra, with_dc, mcu_rows))
        return ("out", "dc") if with_dc else "out"


def _batch(n, h, w):
    rng = np.random.default_rng(n * 1000 + h)
    return torch.from_numpy(rng.integers(0, 256, (n, h, w, 3),
                                         dtype=np.uint8))


@pytest.mark.parametrize("with_dc", [False, True])
@pytest.mark.parametrize("h,w,mode,folds", [
    s for s in SHAPES if fused_dctq.uses_fused(*s[:3])])
def test_nat_route_launches_folded_or_padded(monkeypatch, h, w, mode, folds,
                                             with_dc):
    """The "nat" route's launch on a batch of 2 (the launch recorded in
    place of the card): a folding shape launches K1 / K12 on the unpadded
    batch viewed as [2h, W, 3] with the image's rows h and MCU rows my,
    counting a fold and no gather; any other shape launches on the batch
    padded to whole MCUs (h == my * mh), counting a gather where a side
    grew."""
    rec = _Recorder()
    monkeypatch.setattr(fused_dctq, "_launch_factored", rec)
    fused_dctq.PADS.folds = fused_dctq.PADS.gathers = 0
    imgs = torch.empty((2, h, w, 3), dtype=torch.uint8, device="meta")
    t = EncoderTables.for_quality(90, mode, "cpu")
    fused_dctq.encode_blocks_batch(imgs, t, mode, "nat", with_dc)
    (kernel, img, extra, dc, mcu_rows), = rec.calls
    mh, mw = ops.mcu_shape(mode)
    my = -(-h // mh)
    assert kernel is (fused_dctq.PIXEL_DC_PLANE if with_dc
                      else fused_dctq.PIXEL)
    assert dc is with_dc and mcu_rows == 2 * my
    assert extra == ((h if folds else my * mh), my, mh, mw,
                     fused_dctq.chroma_groups(mode)[0])
    if folds:
        assert tuple(img.shape) == (2 * h, w, 3)
        assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (1, 0)
    else:
        assert tuple(img.shape) == (2 * my * mh, -(-w // mw) * mw, 3)
        grew = bool(h % mh or w % mw)
        assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (0, grew)


@pytest.mark.parametrize("pixel_path", ["dma", "xla"])
def test_other_routes_keep_the_gather(monkeypatch, pixel_path):
    """The "dma" and "xla" routes pad a 1080-row-like batch to whole MCUs
    by the gather, once for the batch, and fold nothing."""
    rec = _Recorder()
    monkeypatch.setattr(fused_dctq, "_launch_factored", rec)
    imgs = _batch(2, 24, 32)
    t = EncoderTables.for_quality(90, "420", "cpu")
    fused_dctq.PADS.folds = fused_dctq.PADS.gathers = 0
    got = fused_dctq.encode_blocks_batch(imgs, t, "420", pixel_path)
    assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (0, 1)
    assert not rec.calls
    want = torch.cat([fused_dctq.encode_blocks_pairs_plain(
        im, t.m, t.bias) for im in imgs])
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_dc", [False, True])
def test_cpu_tensor_takes_the_plain_twin(monkeypatch, with_dc):
    """On a CPU tensor the "nat" route of a folding shape runs the plain
    twin on the padded batch: a gather, no fold, no launch."""
    rec = _Recorder()
    monkeypatch.setattr(fused_dctq, "_launch_factored", rec)
    imgs = _batch(3, 24, 32)
    t = EncoderTables.for_quality(90, "420", "cpu")
    fused_dctq.PADS.folds = fused_dctq.PADS.gathers = 0
    got = fused_dctq.encode_blocks_batch(imgs, t, "420", "nat", with_dc)
    assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (0, 1)
    assert not rec.calls
    want = torch.cat([fused_dctq.encode_blocks_pairs_plain(
        im, t.m, t.bias) for im in imgs])
    if with_dc:
        assert torch.equal(got[0], want)
        assert torch.equal(got[1], fused_dctq.dc_plane(want))
    else:
        assert torch.equal(got, want)


def test_fused_front_end_keeps_the_gather():
    """fuse_bp (K11) reads a padded copy: the batch program of a folding
    shape counts one gather and no fold."""
    imgs = _batch(2, 24, 32)
    t = EncoderTables.for_quality(90, "420", "cpu")
    fused_dctq.PADS.folds = fused_dctq.PADS.gathers = 0
    device_encode_batch(imgs, t, "420", 2, fuse_bp=True)
    assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (0, 1)


def test_whole_mcus_neither_fold_nor_gather(monkeypatch):
    """A 4K-like shape of whole MCUs launches on the image as it is:
    neither counter moves."""
    rec = _Recorder()
    monkeypatch.setattr(fused_dctq, "_launch_factored", rec)
    t = EncoderTables.for_quality(90, "420", "cpu")
    fused_dctq.PADS.folds = fused_dctq.PADS.gathers = 0
    fused_dctq.encode_blocks_pairs(torch.empty((32, 48, 3), dtype=torch.uint8,
                                               device="meta"), t.m, t.bias)
    (_, img, extra, _, mcu_rows), = rec.calls
    assert tuple(img.shape) == (32, 48, 3) and extra[:2] == (32, 2)
    assert mcu_rows == 2
    assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (0, 0)
