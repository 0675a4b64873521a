"""The port's CUDA kernels on the card, at small and edge-case shapes: each
kernel against its plain twin on the same CUDA tensors, and the whole
encode on the GPU against the port's CPU path, for every mode and restart
interval. Every test here needs a
CUDA GPU and ``nvcc``; without them each skips. The file imports no JAX,
so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

import jpegtpu_torch
from jpegtpu_torch.encoder import EncoderTables
from jpegtpu_torch.entropy import scan
from jpegtpu_torch.kernels import compact, entropy_pack, fused_dctq

pytestmark = pytest.mark.gpu

KERNELS = (fused_dctq.PIXEL, entropy_pack.BLOCK_PACK, entropy_pack.SEG_MERGE,
           compact.STUFF, compact.STUFF_CHUNKS)
MODES = ("420", "422", "444", "444s", "gray")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _random(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _gradient(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx * 2) % 256, (yy * 3) % 256, (xx + yy) % 256],
                    axis=-1).astype(np.uint8)


IMAGES = {
    "random_120x200": lambda: _random(120, 200, 7),
    "odd_37x53": lambda: _random(37, 53, 11),          # pad; 12 MCUs
    "one_row_16x40": lambda: _random(16, 40, 13),      # 1 segment, no RST
    "pixel_1x1": lambda: _random(1, 1, 17),            # edge-pad fallback
    "gradient_64x128": lambda: _gradient(64, 128),
    "flat_255_48x32": lambda: np.full((48, 32, 3), 255, np.uint8),
}


def _launches(img, **kw):
    """(bytes, launches per kernel) of one encode on the card."""
    for k in KERNELS:
        k.launches = 0
    got = jpegtpu_torch.encode(img, device=torch.device("cuda"), **kw)
    return got, [k.launches for k in KERNELS]


@pytest.mark.parametrize("q", [1, 50, 90, 100])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_encode_on_gpu_equals_cpu_path(dev, name, q):
    img = IMAGES[name]()
    got, launches = _launches(img, quality=q, subsampling="420")
    # One MCU row is one segment, which the chunk kernel stuffs.
    one_seg = -(-img.shape[0] // 16) == 1
    assert launches == [1, 1, 1, int(not one_seg), int(one_seg)]
    want = jpegtpu_torch.encode(img, quality=q, subsampling="420",
                                device="cpu")
    assert got == want


@pytest.mark.parametrize("restart", ["rows", 0, 5, 1000])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["odd_37x53", "random_120x200"])
def test_modes_on_gpu_equal_cpu_path(dev, name, mode, restart):
    """Every mode and restart interval (rows, none, ragged, longer than the
    image), through the kernels its path runs."""
    img = IMAGES[name]()
    if mode == "gray":
        img = np.ascontiguousarray(img[..., 1])
    kw = dict(quality=75, subsampling=mode, restart_interval=restart)
    got, launches = _launches(img, **kw)
    assert got == jpegtpu_torch.encode(img, device="cpu", **kw)
    h, w = img.shape[:2]
    fused = fused_dctq.uses_fused(h, w, mode)
    my, mx = jpegtpu_torch.EncoderConfig(**kw).mcu_shape
    n_mcu = -(-h // my) * -(-w // mx)
    r = -(-w // mx) if restart == "rows" else restart
    one_seg = r == 0 or r >= n_mcu
    assert launches == [int(fused), 1, 1, int(not one_seg), int(one_seg)]


def _coeffs(kind, n_mcu, seed):
    """[n_mcu, 384] int32 coefficients that stress the block packer:
    'dense' has every slot nonzero at up to 10-bit magnitudes (longest AC
    codes) and DC steps up to 11 bits; 'sparse' has zero runs of 15, 16,
    31, 32 and 47 before a nonzero (ZRL) and trailing zeros (EOB)."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        c = rng.integers(-1023, 1024, (n_mcu * 6, 64))
        c[c == 0] = 1
        c[:, 0] = rng.choice([-1024, 1023], n_mcu * 6)
    else:
        c = np.zeros((n_mcu * 6, 64), np.int64)
        c[:, 0] = rng.integers(-300, 300, n_mcu * 6)
        for row in c:
            k = 0
            for run in rng.choice([0, 15, 16, 31, 32, 47], 3):
                k += int(run) + 1
                if k < 64:
                    row[k] = rng.integers(1, 600) * rng.choice([-1, 1])
        c[::5, 63] = -7                  # last slot nonzero: no EOB
    return c.reshape(n_mcu, 384).astype(np.int32)


def _masked(words, mlens):
    """MCU words as u32 in int64, with the bits past each length cleared."""
    j = torch.arange(words.shape[1], device=words.device)[None, :]
    valid = torch.clamp(mlens.to(torch.int64)[:, None] - 32 * j, 0, 32)
    return (words.to(torch.int64) & 0xFFFFFFFF) & \
        ((0xFFFFFFFF << (32 - valid)) & 0xFFFFFFFF)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("n_seg,mps", [(3, 5), (1, 9), (4, 1)])
def test_entropy_kernels_match_twins(dev, kind, n_seg, mps):
    """Block pack, segment merge and stuffing, each fed the same CUDA
    tensors as its twin; MCU counts that fill no whole thread block."""
    n_mcu = n_seg * mps
    c = torch.from_numpy(_coeffs(kind, n_mcu, n_seg * 10 + mps)).to(dev)
    luts = EncoderTables.for_quality(90, "420", dev).luts()
    dcd = scan.dc_diffs_from_dc(c[:, ::64], 4, mps).reshape(-1)
    cls = (torch.arange(n_mcu * 6, device=dev) % 6 >= 4).to(torch.int32)

    mw, ml = entropy_pack.block_pack_mcu_pairs(c, cls, dcd, *luts)
    mw_p, ml_p = entropy_pack.block_pack_mcu_pairs_plain(c, cls, dcd, *luts)
    assert torch.equal(ml, ml_p)
    assert torch.equal(_masked(mw, ml), _masked(mw_p, ml_p))
    # The kernel's streams are zero past their length, as the twin's are.
    assert torch.equal(mw, mw_p)

    sw, sb = entropy_pack.seg_merge_mcu(mw, ml, n_seg, mps)
    sw_p, sb_p = entropy_pack.seg_merge_mcu_plain(mw, ml, n_seg, mps)
    assert torch.equal(sb, sb_p) and torch.equal(sw, sw_p)

    for restart in (mps, 0):
        for fn in (compact.compact_segments_stuffed_grouped,
                   compact.compact_segments_stuffed):
            buf, total = fn(sw, sb, restart)
            buf_p, total_p = getattr(compact, fn.__name__ + "_plain")(
                sw, sb, restart)
            assert int(total) == int(total_p)
            assert torch.equal(buf[:int(total)], buf_p[:int(total)])


@pytest.mark.parametrize("fn", ["compact_segments_stuffed_grouped",
                                "compact_segments_stuffed"])
def test_stuffing_kernel_all_ff_segments(dev, fn):
    """Every byte 0xFF (each one stuffed) across several 1 KB tiles and
    4 KB chunks, with byte counts that end inside a word."""
    n_seg, w = 3, 2700
    words = torch.full((n_seg, w), -1, dtype=torch.int32, device=dev)
    bits = torch.tensor([w * 32, 8 * 4099 - 3, 8 * 5], device=dev)
    buf, total = getattr(compact, fn)(words, bits, 1)
    buf_p, total_p = getattr(compact, fn + "_plain")(words, bits, 1)
    want = 2 * (w * 4 + 4099 + 5) + 2 * (n_seg - 1)
    assert int(total) == int(total_p) == want
    assert torch.equal(buf[:want], buf_p[:want])


def _segments(n_seg, w, seed, ff_share=0.05):
    """Random segment words with a share of 0xFF bytes, on the card."""
    rng = np.random.default_rng(seed)
    by = rng.integers(0, 256, (n_seg, w * 4), dtype=np.uint8)
    by[rng.random(by.shape) < ff_share] = 0xFF
    return torch.from_numpy(by.view(np.int32).copy()).to("cuda")


@pytest.mark.parametrize("case", ["many_chunks", "ff_at_chunk_end",
                                  "markers", "no_marker", "empty_segment"])
def test_chunk_stuffing_kernel_matches_twin(dev, case):
    """The chunk kernel against its twin: one segment of many 4 KB chunks
    with a byte count that ends inside a word; a 0xFF as the last valid
    byte of a chunk and of the segment; an explicit marker table with and
    without markers; a segment of zero bytes between two others."""
    n_seg, w, mnum = 1, 9 * 1024 + 300, None
    words = _segments(n_seg, w, 1)
    bits = torch.tensor([8 * (5 * 4096 + 4099) - 5], device=dev)
    if case == "ff_at_chunk_end":
        by = words.view(torch.uint8).reshape(n_seg, w, 4)
        for i in (4095, 2 * 4096 - 1, 3 * 4096 + 17):   # stream bytes
            by[0, i // 4, 3 - i % 4] = 0xFF
        bits = torch.tensor([8 * (3 * 4096 + 18)], device=dev)
    elif case in ("markers", "no_marker", "empty_segment"):
        n_seg, w = 4, 2 * 1024 + 5
        words = _segments(n_seg, w, 2, ff_share=0.2)
        bits = torch.tensor([8 * 4096, 8 * 8211 + 3, 1, 8 * 100],
                            device=dev)
        mnum = torch.tensor([0xD3, 0xD4, 0xD5, 0] if case != "no_marker"
                            else [0, 0, 0, 0], dtype=torch.int32,
                            device=dev)
        if case == "empty_segment":
            bits[1] = 0
    buf, total = compact.compact_segments_stuffed(words, bits, 1, mnum)
    buf_p, total_p = compact.compact_segments_stuffed_plain(words, bits, 1,
                                                            mnum)
    assert int(total) == int(total_p)
    assert torch.equal(buf[:int(total)], buf_p[:int(total)])


@pytest.mark.parametrize("mode", ["420", "422", "444", "444s"])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_pixel_kernel_matches_twin(dev, name, mode):
    """Every fused geometry, with odd padding (37x53, 1x1) and MCU counts
    that fill no whole thread block."""
    img = torch.from_numpy(IMAGES[name]()).to(dev)
    t = EncoderTables.for_quality(100, mode, dev)
    got = fused_dctq.encode_blocks_pairs(img, t.m, t.bias, mode)
    want = fused_dctq.encode_blocks_pairs_plain(img, t.m, t.bias, mode)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_seg_merge_pads_ragged_last_segment(dev, kind):
    """Seven MCUs in segments of three: the last segment ends in two
    zero-length pad MCUs, and the kernel still 1-pads its last real byte."""
    n_mcu, n_seg, mps = 7, 3, 3
    c = torch.from_numpy(_coeffs(kind, n_mcu, 7)).to(dev)
    luts = EncoderTables.for_quality(90, "420", dev).luts()
    dcd = scan.dc_diffs_from_dc(c[:, ::64], 4, mps).reshape(-1)
    cls = (torch.arange(n_mcu * 6, device=dev) % 6 >= 4).to(torch.int32)
    mw, ml = entropy_pack.pad_segments(
        *entropy_pack.block_pack_mcu_pairs(c, cls, dcd, *luts), n_seg, mps)
    assert int(ml[-1]) == int(ml[-2]) == 0
    sw, sb = entropy_pack.seg_merge_mcu(mw, ml, n_seg, mps)
    sw_p, sb_p = entropy_pack.seg_merge_mcu_plain(mw, ml, n_seg, mps)
    assert torch.equal(sb, sb_p) and torch.equal(sw, sw_p)
    last = int(sb[-1])
    assert last % 8, "pick inputs whose last segment ends inside a byte"
    word = int(sw[-1, last // 32]) & 0xFFFFFFFF
    pad = 8 - last % 8
    shift = 32 - last % 32 - pad
    assert (word >> shift) & ((1 << pad) - 1) == (1 << pad) - 1


def test_wrappers_raise_on_cpu_operands(dev):
    """A CUDA input with CPU tables raises: nothing falls back to a twin."""
    img = torch.zeros((16, 16, 3), dtype=torch.uint8, device=dev)
    t = EncoderTables.for_quality(90, "420", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        fused_dctq.encode_blocks_pairs(img, t.m, t.bias)
    c = torch.zeros((1, 384), dtype=torch.int32, device=dev)
    cls = torch.zeros(6, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_pack.block_pack_mcu_pairs(c, cls, cls, *t.luts())
