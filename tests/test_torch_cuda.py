"""The port's CUDA kernels on the card, at small and edge-case shapes: each
kernel against its plain twin on the same CUDA tensors, and the whole
encode on the GPU against the port's CPU path, for every mode, restart
interval, ``device_stuff``, ``pixel_path`` and ``fuse_bp``, and the
oracle tier's kernels (K7-K10) against their twins and against the main
path's segments. Every test here needs a
CUDA GPU and ``nvcc``; without them each skips. The file imports no JAX,
so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q -p no:cacheprovider
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jpegtpu_torch
from jpegtpu_torch.core import ops
from jpegtpu_torch.encoder import EncoderTables
from jpegtpu_torch.entropy import scan
from jpegtpu_torch import encoder
from jpegtpu_torch.kernels import (_build, chain, compact, entropy_oracles,
                                   entropy_pack, fused_dctq, fused_pipeline)
from test_torch_stuff import CHUNK_CASES, chunk_case

pytestmark = pytest.mark.gpu

# The kernels of an encode path; K2 by the encoder's launcher.
KERNELS = (fused_dctq.PIXEL, entropy_pack.BLOCK_PACK_SEGMENTS,
           entropy_pack.SEG_MERGE, compact.STUFF, compact.STUFF_CHUNKS,
           compact.COMPACT)
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
    assert launches == [1, 1, 1, int(not one_seg), int(one_seg), 0]
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
    assert launches == [int(fused), 1, 1, int(not one_seg), int(one_seg), 0]


@pytest.mark.parametrize("restart", ["rows", 0, 5])
@pytest.mark.parametrize("mode", MODES)
def test_encode_without_device_stuff_on_gpu_equals_cpu_path(dev, mode,
                                                            restart):
    """device_stuff=False: the compaction kernel, then the host stuffing,
    for several segments, one, and a ragged last one."""
    img = IMAGES["odd_37x53"]()
    if mode == "gray":
        img = np.ascontiguousarray(img[..., 1])
    kw = dict(quality=75, subsampling=mode, restart_interval=restart)
    got, launches = _launches(img, device_stuff=False, **kw)
    assert got == jpegtpu_torch.encode(img, device="cpu", **kw)
    fused = fused_dctq.uses_fused(*img.shape[:2], mode)
    assert launches == [int(fused), 1, 1, 0, 0, 1]


@pytest.mark.parametrize("device_stuff", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_encode_batch_on_gpu_equals_cpu_path(dev, mode, device_stuff):
    """One program for the batch: each kernel launched once, RST numbers
    restarting in each image, the files of the CPU path."""
    imgs = [_random(37, 53, s) for s in (11, 22, 23)]
    if mode == "gray":
        imgs = [np.ascontiguousarray(im[..., 0]) for im in imgs]
    kw = dict(quality=90, subsampling=mode, device_stuff=device_stuff)
    for k in KERNELS:
        k.launches = 0
    got = jpegtpu_torch.encode_batch(imgs, device=dev, **kw)
    launches = [k.launches for k in KERNELS]
    fused = fused_dctq.uses_fused(37, 53, mode)
    assert launches == [int(fused), 1, 1, int(device_stuff), 0,
                        int(not device_stuff)]
    assert got == jpegtpu_torch.encode_batch(imgs, device="cpu", **kw)


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
    """MCU words as u32 in int64, with the bits past each length cleared
    (the card leaves them undefined)."""
    j = torch.arange(words.shape[1], device=words.device)[None, :]
    valid = torch.clamp(mlens.to(torch.int64)[:, None] - 32 * j, 0, 32)
    return (words.to(torch.int64) & 0xFFFFFFFF) & \
        ((0xFFFFFFFF << (32 - valid)) & 0xFFFFFFFF)


def _same_segments(sw, sb, sw_p, sb_p):
    """K3's segments equal the twin's: seg_bits, and each segment's words
    through its 1-padded last byte (zero after it, as the twin's); the
    words past them are undefined on the card."""
    return torch.equal(sb, sb_p) and torch.equal(
        _masked(sw, (sb.to(torch.int64) + 31) // 32 * 32),
        _masked(sw_p, (sb_p.to(torch.int64) + 31) // 32 * 32))


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
    # The stream bits only: the card leaves the bits past each length
    # undefined.
    assert torch.equal(_masked(mw, ml), _masked(mw_p, ml_p))

    sw, sb = entropy_pack.seg_merge_mcu(mw, ml, n_seg, mps)
    sw_p, sb_p = entropy_pack.seg_merge_mcu_plain(mw, ml, n_seg, mps)
    assert _same_segments(sw, sb, sw_p, sb_p)

    for restart in (mps, 0):
        for fn in (compact.compact_segments_stuffed_grouped,
                   compact.compact_segments_stuffed):
            buf, total = fn(sw, sb, restart)[:2]
            buf_p, total_p = getattr(compact, fn.__name__ + "_plain")(
                sw, sb, restart)[:2]
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
    buf, total = getattr(compact, fn)(words, bits, 1)[:2]
    buf_p, total_p = getattr(compact, fn + "_plain")(words, bits, 1)[:2]
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


@pytest.mark.parametrize("case", ["empty_segments", "chunk_boundary",
                                  "many_chunks", "one_byte_segments"])
def test_compact_kernel_matches_twin(dev, case):
    """The compaction kernel against its twin: segments of 0 bytes among
    others; segments that end exactly on a 4 KB chunk boundary (and one
    byte short of it); one segment of many chunks ending inside a word;
    32,768 one-byte segments (every offset unaligned)."""
    rng = np.random.default_rng(5)
    if case == "empty_segments":
        w, bits = 300, [0, 8 * 7 + 3, 0, 0, 8 * 1200]
    elif case == "chunk_boundary":
        w, bits = 2 * 1024 + 5, [8 * 4096, 8 * 8192, 8 * 4095]
    elif case == "many_chunks":
        w, bits = 9 * 1024 + 300, [8 * (9 * 4096 + 1000) - 5]
    else:
        w, bits = 2, rng.integers(1, 9, 32768).tolist()
    words = _segments(len(bits), w, 3, ff_share=0.1)
    bits = torch.tensor(bits, device=dev)
    buf, nbytes = compact.compact_segments(words, bits)
    buf_p, nbytes_p = compact.compact_segments_plain(words, bits)
    total = int(nbytes.sum())
    assert torch.equal(nbytes, nbytes_p)
    assert torch.equal(buf[:total], buf_p[:total])


@pytest.mark.parametrize("spi", [1, 3, 12])
def test_stuffing_kernel_per_image_markers(dev, spi):
    """The per-segment stuffing kernel with a marker table numbered within
    each image of spi segments, and each image's first byte."""
    n_seg, w = 24, 700
    words = _segments(n_seg, w, 4, ff_share=0.2)
    bits = torch.from_numpy(np.random.default_rng(6).integers(
        0, 32 * w, n_seg)).to(dev)
    buf, total, off = compact.compact_segments_stuffed_grouped(words, bits,
                                                               1, spi)
    buf_p, total_p, off_p = compact.compact_segments_stuffed_grouped_plain(
        words, bits, 1, spi)
    assert int(total) == int(total_p) and torch.equal(off, off_p)
    assert off.shape == (n_seg // spi,)
    assert torch.equal(buf[:int(total)], buf_p[:int(total)])


# The two stuffing wrappers (one kernel body, csrc/stuff.cu) and the
# number of outputs of each: K4 also gives each image's first byte.
STUFFERS = {"compact_segments_stuffed_grouped": compact.STUFF,
            "compact_segments_stuffed": compact.STUFF_CHUNKS}


def _stuffed_like_twin(fn, words, bits, restart, *extra):
    """The wrapper fn on the card against its plain twin: the scan's bytes,
    its total and (K4) each image's first byte. Returns the kernel's
    outputs."""
    got = getattr(compact, fn)(words, bits, restart, *extra)
    want = getattr(compact, fn + "_plain")(words, bits, restart, *extra)
    total = int(want[1])
    assert int(got[1]) == total
    assert torch.equal(got[0][:total], want[0][:total])
    if len(want) == 3:
        assert torch.equal(got[2], want[2])
    return got


@pytest.mark.parametrize("fn", sorted(STUFFERS))
@pytest.mark.parametrize("name", CHUNK_CASES)
def test_stuffing_kernel_chunk_cases(dev, name, fn):
    """The look-back stuffing kernel through both launchers on the restart
    tests' chunk cases: a segment whose byte count is a whole 4 KB tile,
    0xFF as a tile's last valid byte, counts that end inside a word with a
    0xFF past them."""
    words, bits, restart = chunk_case(name)
    _stuffed_like_twin(fn, torch.from_numpy(words.view(np.int32)).to(dev),
                       torch.from_numpy(bits).to(dev), restart)


def test_stuffing_no_segments_launches_nothing(dev):
    """Zero segments: a total of 0, as the twin gives, and no launch."""
    compact.STUFF_CHUNKS.launches = 0
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    _, total = _stuffed_like_twin(
        "compact_segments_stuffed",
        torch.zeros((0, 5), dtype=torch.int32, device=dev), none, 1, none)
    assert int(total) == 0 and compact.STUFF_CHUNKS.launches == 0


@pytest.mark.parametrize("restart", [0, 1])
@pytest.mark.parametrize("fn", sorted(STUFFERS))
def test_stuffing_kernel_zero_and_whole_tile_segments(dev, fn, restart):
    """Segments of zero bytes (first, between others, last) beside
    segments of exactly one and two 4 KB tiles and one of 5 bytes; with
    restart 1 every segment but the last carries a marker, a zero-byte
    one on its tile 0."""
    words = _segments(6, 2 * 1024 + 7, 8, ff_share=0.3)
    bits = torch.tensor([0, 8 * 4096, 0, 8 * 8192, 37, 0], device=dev)
    _stuffed_like_twin(fn, words, bits, restart)


@pytest.mark.parametrize("fn", sorted(STUFFERS))
def test_stuffing_kernel_chain_longer_than_the_grid(dev, fn):
    """40,000 one-tile segments, far more tiles than the persistent grid
    holds blocks, with per-image markers (images of 8 segments) for K4."""
    n_seg, w = 40000, 3
    words = _segments(n_seg, w, 10, ff_share=0.2)
    bits = torch.from_numpy(np.random.default_rng(12).integers(
        0, 32 * w + 1, n_seg)).to(dev)
    extra = (8,) if fn == "compact_segments_stuffed_grouped" else ()
    _stuffed_like_twin(fn, words, bits, 1, *extra)


def test_stuffing_many_tiles_444_restart_1(dev):
    """A 4:4:4 image with a marker after every MCU: 375 segments, one tile
    each, stuffed by K4 alone, bytes equal to the CPU path's."""
    img = IMAGES["random_120x200"]()
    kw = dict(quality=90, subsampling="444", restart_interval=1)
    got, launches = _launches(img, **kw)
    assert launches == [1, 1, 1, 1, 0, 0]
    assert got == jpegtpu_torch.encode(img, device="cpu", **kw)


@pytest.mark.parametrize("n_seg,w", [(64, 3000), (20000, 3)])
@pytest.mark.parametrize("fn", sorted(STUFFERS))
def test_stuffing_kernel_repeats_identically(dev, fn, n_seg, w):
    """50 launches on one input (segments of three tiles; one-tile
    segments, taken many tiles a ticket; many 0xFF bytes, images of 4
    segments for K4) give the twin's outputs every time: no look-back race
    shows."""
    words = _segments(n_seg, w, 9, ff_share=0.1)
    bits = torch.from_numpy(np.random.default_rng(13).integers(
        0, 32 * w + 1, n_seg)).to(dev, torch.int32)
    extra = (4,) if fn == "compact_segments_stuffed_grouped" else ()
    first = _stuffed_like_twin(fn, words, bits, 1, *extra)
    total = int(first[1])
    for _ in range(50):
        got = getattr(compact, fn)(words, bits, 1, *extra)
        assert int(got[1]) == total
        assert torch.equal(got[0][:total], first[0][:total])
        if len(got) == 3:
            assert torch.equal(got[2], first[2])


def test_stuffing_launches_one_kernel_and_no_glue(dev, monkeypatch):
    """Each stuffing wrapper launches its one kernel once and calls none
    of the twins' tables (stuff_precompute*), alone and inside encodes at
    restart "rows" (K4) and 0 (K5)."""
    img = IMAGES["random_120x200"]()
    want = {r: jpegtpu_torch.encode(img, restart_interval=r, device="cpu")
            for r in ("rows", 0)}

    def glue(*args, **kwargs):
        raise AssertionError("stuffing glue on the CUDA path")

    monkeypatch.setattr(compact, "stuff_precompute", glue)
    monkeypatch.setattr(compact, "stuff_precompute_chunks", glue)
    words = _segments(5, 1500, 14, ff_share=0.1)
    bits = torch.tensor([100, 0, 8 * 4096, 47000, 9], device=dev)
    for fn, kernel in STUFFERS.items():
        for k in KERNELS:
            k.launches = 0
        getattr(compact, fn)(words, bits, 1)
        assert [k.launches for k in KERNELS] == [int(k is kernel)
                                                 for k in KERNELS]
    for restart, one_seg in (("rows", False), (0, True)):
        got, launches = _launches(img, restart_interval=restart)
        assert launches == [1, 1, 1, int(not one_seg), int(one_seg), 0]
        assert got == want[restart]


@pytest.mark.parametrize("q", [1, 50, 90, 100])
@pytest.mark.parametrize("mode", ["420", "422", "444", "444s"])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_pixel_kernel_matches_twin(dev, name, mode, q):
    """K1's factored tensor-core product at every fused geometry against
    the dense twin, with odd padding (37x53, 1x1) and MCU counts that fill
    no whole tile."""
    img = torch.from_numpy(IMAGES[name]()).to(dev)
    t = EncoderTables.for_quality(q, mode, dev)
    got, launches = _path_launches(
        lambda: fused_dctq.encode_blocks_pairs(img, t.m, t.bias, mode))
    assert launches["pixel"] == 1
    want = fused_dctq.encode_blocks_pairs_plain(img, t.m, t.bias, mode)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["420", "422", "444", "444s"])
def test_pixel_kernel_on_a_batch_view(dev, mode):
    """K1 on three 37x53 images padded to whole MCUs and viewed as one tall
    image (the batch path's one launch), against the per-image twins."""
    imgs = torch.from_numpy(np.stack([_random(37, 53, s)
                                      for s in (11, 22, 23)])).to(dev)
    t = EncoderTables.for_quality(90, mode, dev)
    padded = ops.pad_to_multiple(imgs, ops.mcu_shape(mode))
    got = fused_dctq.encode_blocks_pairs(
        padded.reshape(-1, *padded.shape[2:]), t.m, t.bias, mode)
    want = torch.cat([fused_dctq.encode_blocks_pairs_plain(
        im, t.m, t.bias, mode) for im in imgs])
    assert torch.equal(got, want)


def test_pixel_kernel_refuses_an_operator_that_does_not_factor(dev):
    """An operator that is not the expansion of its factors raises on the
    card, in K1's, K12's, K13's and K14's wrappers: nothing falls back to
    the dense product or to the CPU, and no kernel is launched."""
    img = torch.from_numpy(IMAGES["odd_37x53"]()).to(dev)
    t = EncoderTables.for_quality(90, "420", dev)
    m = t.m.clone()
    m[5, 300] += 1.0                  # a chroma weight off its 2x2 group
    for fn in (fused_dctq.encode_blocks_pairs,
               lambda *a: fused_dctq.encode_blocks_pairs(*a, with_dc=True),
               fused_dctq.encode_blocks_i8_pairs,
               fused_dctq.encode_blocks_dma_pairs):
        with pytest.raises(ValueError, match="420"):
            _path_launches(lambda: fn(img, m, t.bias, "420"))
        assert not any(k.launches for k in PATH_KERNELS.values())


# Images whose MCU count leaves the last tile of K1 short in every geometry
# (tiles of 32 MCUs at 4:2:0, 96 at 4:2:2, 64 at 4:4:4, 128 at 4:4:4s), with
# MCU rows that cross tiles, and more tiles than one grid sweep covers.
SHORT_TILE_SHAPES = [(48, 520), (72, 200), (1400, 1608)]


@pytest.mark.parametrize("shape", SHORT_TILE_SHAPES)
@pytest.mark.parametrize("mode", ["420", "422", "444", "444s"])
def test_pixel_kernel_short_last_tile(dev, mode, shape):
    img = torch.from_numpy(_random(*shape, sum(shape))).to(dev)
    t = EncoderTables.for_quality(75, mode, dev)
    got = fused_dctq.encode_blocks_pairs(img, t.m, t.bias, mode)
    want = fused_dctq.encode_blocks_pairs_plain(img, t.m, t.bias, mode)
    assert torch.equal(got, want)


# Each geometry's K1 body (jt_pixel_split) and the dynamic shared memory a
# block takes (jt_pixel_smem): the half-operator body, whose staging ring
# fits beside half the operator in float64, at 4:2:0 and 4:4:4; the
# f32-fragment body at 4:2:2 (a ring of two 96-MCU tiles is past a block's
# 232,448 bytes) and 4:4:4s (its chroma depth of 48 is not the half's 192);
# nothing for a geometry no instance takes.
PIXEL_BODIES = {(16, 16, 64): (1, 224800), (8, 16, 64): (0, 224256),
                (8, 8, 64): (1, 226080), (8, 8, 16): (0, 110592),
                (16, 8, 64): (0, 0)}


def test_pixel_split_by_geometry(dev):
    lib = _build.library()
    got = {}
    for name in ("jt_pixel_split", "jt_pixel_smem"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    for geometry in PIXEL_BODIES:
        got[geometry] = (lib.jt_pixel_split(*geometry),
                         lib.jt_pixel_smem(*geometry))
    assert got == PIXEL_BODIES


# The benchmark cells' frames, one launch each (the batch's rows folded):
# (mode, images, rows, columns). Each leaves a count of K1's work items (a
# tile and a column half) that the grid of one block an SM does not divide,
# and the 4K 4:2:0 frame's last tile is short (32,400 MCUs, tiles of 32).
CELL_FRAMES = {"420_3840x2160": ("420", 1, 2160, 3840),
               "444_3840x2160": ("444", 1, 2160, 3840),
               "420_8x1920x1080": ("420", 8, 1080, 1920)}
HALF_TILES = {"420": 32, "444": 64}
CELL_ROUTES = [(case, route) for case in sorted(CELL_FRAMES)
               for route in ("pixel", "pixel_dc", "pixel_i8")
               if route != "pixel_i8" or case == "420_3840x2160"]


def _cell_frames(n, h, w, seed):
    """n frames of the benchmark's kind of content: a smooth pattern plus
    noise, clipped to u8."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    yy = torch.arange(h, device="cuda").view(1, h, 1, 1)
    xx = torch.arange(w, device="cuda").view(1, 1, w, 1)
    smooth = 128 + 60 * torch.sin(xx / 97.0) * torch.cos(yy / 53.0)
    return (smooth + noise.float() / 255 * 24 - 12).clamp(0, 255).to(
        torch.uint8).contiguous()


@pytest.mark.parametrize("q", [1, 50, 90, 100])
@pytest.mark.parametrize("case,route", CELL_ROUTES)
def test_half_operator_body_at_the_cells_sizes(dev, case, route, q):
    """K1, K12 and K13 at the sizes of the benchmark's cells, which take the
    half-operator body: one launch of the nat route (K13: the i8 view),
    coefficients equal to the plain twin's and to the benchmark's plain
    reference (portbench/reference), and K12's DC plane to the twin's."""
    from portbench.reference import jpeg
    mode, n, h, w = CELL_FRAMES[case]
    mh, mw = fused_dctq.fused_geometry(mode)[:2]
    n_mcu = n * -(-h // mh) * (w // mw)
    items = 2 * -(-n_mcu // HALF_TILES[mode])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert items % (sms & ~1)
    imgs = _cell_frames(n, h, w, seed=h * 7 + n)
    t = EncoderTables.for_quality(q, mode, dev)
    if route == "pixel_i8":
        got, launches = _path_launches(
            lambda: fused_dctq.encode_blocks_i8_pairs(imgs[0], t.m, t.bias,
                                                      mode))
    else:
        got, launches = _path_launches(
            lambda: fused_dctq._pixel_nat(imgs, t.m, t.bias,
                                          fused_dctq.kernel_factors(t, mode),
                                          mode, route == "pixel_dc"))
    assert launches == dict(dict.fromkeys(PATH_KERNELS, 0), **{route: 1})
    coeffs = got[0] if route == "pixel_dc" else got
    want = torch.cat([fused_dctq.encode_blocks_pairs_plain(
        im, t.m, t.bias, mode) for im in imgs])
    assert coeffs.dtype == torch.int32 and torch.equal(coeffs, want)
    if route == "pixel_dc":
        assert torch.equal(got[1], fused_dctq.dc_plane(want))
    ref = torch.cat([jpeg.coefficients(im, q, mode) for im in imgs])
    assert torch.equal(coeffs.long(), ref)


# K12 in every geometry and K13 at 4:2:0 (its only one), by the name of
# their launch count in PATH_KERNELS.
FACTORED_ROUTES = [("pixel_dc", m) for m in ("420", "422", "444", "444s")
                   ] + [("pixel_i8", "420")]


def _check_route(kernel, img, t, mode, want):
    """K12 or K13 on img, once: the coefficients want and, for K12, their
    DC plane."""
    if kernel == "pixel_dc":
        (got, dc), launches = _path_launches(
            lambda: fused_dctq.encode_blocks_pairs(img, t.m, t.bias, mode,
                                                   with_dc=True))
        assert dc.dtype == torch.int32
        assert torch.equal(dc, fused_dctq.dc_plane(want))
    else:
        got, launches = _path_launches(
            lambda: fused_dctq.encode_blocks_i8_pairs(img, t.m, t.bias,
                                                      mode))
    assert launches == dict(dict.fromkeys(PATH_KERNELS, 0), **{kernel: 1})
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("shape", SHORT_TILE_SHAPES)
@pytest.mark.parametrize("kernel,mode", FACTORED_ROUTES)
def test_dc_plane_and_i8_kernels_short_last_tile(dev, kernel, mode, shape):
    img = torch.from_numpy(_random(*shape, sum(shape))).to(dev)
    t = EncoderTables.for_quality(75, mode, dev)
    _check_route(kernel, img, t, mode,
                 fused_dctq.encode_blocks_pairs_plain(img, t.m, t.bias, mode))


@pytest.mark.parametrize("kernel,mode", FACTORED_ROUTES)
def test_dc_plane_and_i8_kernels_on_a_batch_view(dev, kernel, mode):
    """K12 and K13 on three 37x53 images padded to whole MCUs and viewed as
    one tall image, against the per-image twins."""
    imgs = torch.from_numpy(np.stack([_random(37, 53, s)
                                      for s in (11, 22, 23)])).to(dev)
    t = EncoderTables.for_quality(90, mode, dev)
    padded = ops.pad_to_multiple(imgs, ops.mcu_shape(mode))
    want = torch.cat([fused_dctq.encode_blocks_pairs_plain(
        im, t.m, t.bias, mode) for im in imgs])
    _check_route(kernel, padded.reshape(-1, *padded.shape[2:]), t, mode,
                 want)


SENTINEL = 0x7FFFFFFF


@pytest.mark.parametrize("mode", ["420", "422", "444", "444s"])
def test_dc_plane_kernel_writes_every_lane_and_no_more(dev, mode):
    """jt_pixel_dc launched directly onto buffers filled with a sentinel and
    one MCU row longer than the image: every coefficient and plane lane of
    the image's MCUs is written (the zero lanes too), nothing past them."""
    img = torch.from_numpy(_random(72, 200, 3)).to(dev)
    t = EncoderTables.for_quality(90, mode, dev)
    mh, mw, _, n_out = fused_dctq.fused_geometry(mode)
    x = ops.pad_to_multiple(img, (mh, mw)).contiguous()
    nrx = x.shape[1] // mw
    n_mcu = x.shape[0] // mh * nrx
    out = torch.full((n_mcu + nrx, n_out), SENTINEL, dtype=torch.int32,
                     device=dev)
    dc = torch.full((n_mcu + nrx, 8), SENTINEL, dtype=torch.int32,
                    device=dev)
    lum, chroma = fused_dctq.cuda_factors(t.m, t.bias, mode)
    fused_dctq.PIXEL_DC_PLANE.launch(
        dev, x.data_ptr(), lum.data_ptr(), chroma.data_ptr(),
        t.bias.data_ptr(), out.data_ptr(), dc.data_ptr(), n_mcu, nrx,
        x.shape[1] * 3, x.shape[0], x.shape[0] // mh, mh, mw,
        fused_dctq.chroma_groups(mode)[0])
    want = fused_dctq.encode_blocks_pairs_plain(img, t.m, t.bias, mode)
    assert torch.equal(out[:n_mcu], want)
    assert torch.equal(dc[:n_mcu], fused_dctq.dc_plane(want))
    assert bool((out[n_mcu:] == SENTINEL).all())
    assert bool((dc[n_mcu:] == SENTINEL).all())


def test_factored_launchers_refuse_what_they_do_not_take(dev):
    """The launchers of K1, K12 and K13 return K1's error codes, which the
    wrapper raises, and launch nothing: a misaligned image
    (cudaErrorMisalignedAddress, 716), a geometry they do not take, an
    MCU count past 2^31, or image rows that K1 and K12 cannot fold: rows
    past my MCU rows, rows not past my - 1 of them, a pad as long as the
    image (numpy's edge case), or MCUs that are not whole images
    (cudaErrorInvalidValue, 1)."""
    x = torch.zeros((32, 48, 3), dtype=torch.uint8, device=dev)
    t = EncoderTables.for_quality(90, "420", dev)
    lum, chroma = fused_dctq.cuda_factors(t.m, t.bias, "420")
    out = torch.empty((6, 384), dtype=torch.int32, device=dev)
    dc = torch.empty((6, 8), dtype=torch.int32, device=dev)
    operands = (lum.data_ptr(), chroma.data_ptr(), t.bias.data_ptr(),
            out.data_ptr())
    k1, k12, k13 = (fused_dctq.PIXEL, fused_dctq.PIXEL_DC_PLANE,
                    fused_dctq.PIXEL_I8)
    img, plane = x.data_ptr(), dc.data_ptr()
    cases = [
        (k12, (img + 1, *operands, plane, 6, 3, 144, 32, 2, 16, 16, 64),
         716),
        (k12, (img, *operands, plane, 6, 3, 144, 32, 2, 16, 8, 64), 1),
        (k1, (img, *operands, 6, 3, 144, 40, 2, 16, 16, 64), 1),
        (k1, (img, *operands, 6, 3, 144, 16, 2, 16, 16, 64), 1),
        (k1, (img, *operands, 3, 3, 144, 8, 1, 16, 16, 64), 1),
        (k12, (img, *operands, plane, 5, 3, 144, 24, 2, 16, 16, 64), 1),
        (k12, (img, *operands, plane, 6, 3, 144, 24, 0, 16, 16, 64), 1),
        (k13, (img + 8, *operands, 6, 3, 144), 716),
        (k13, (img, *operands, 6, 3, 152), 716),
        (k13, (img, *operands, 1 << 31, 3, 144), 1)]
    for kernel, args, code in cases:
        kernel.launches = 0
        with pytest.raises(RuntimeError, match=f"CUDA error {code} "):
            kernel.launch(dev, *args)
        assert kernel.launches == 0


# (mode, image rows, images) whose rows are not whole MCUs while the
# width is: 1080-row batches as the benchmark's, one row past and one short
# of whole MCUs, a pad of 6 rows (1090) and of 8 (24 rows: one and a half
# MCU rows) at 4:2:0, and odd heights at the 8-row geometries (4:4:4s is
# launched directly: the encoder stages that mode's odd heights).
FOLD_CASES = [("420", h, n) for h in (1080, 1081, 1087, 1090, 24)
              for n in (1, 3, 8)] + [
    (mode, h, 3) for mode in ("422", "444", "444s") for h in (1083, 17)]


@pytest.mark.parametrize("with_dc", [False, True])
@pytest.mark.parametrize("mode,h,n", FOLD_CASES)
def test_row_fold_equals_the_padded_launch(dev, mode, h, n, with_dc):
    """K1 (with_dc: K12) reading a batch of unpadded images and mirroring
    each one's last MCU row itself, one launch and no gather, gives the
    coefficients (and the DC plane) of ``pad_to_multiple`` and the launch
    on the padded batch (whole MCUs: the mirror never taken), and of the
    plain twin on each image."""
    w = 1920 if h >= 1080 else 208
    gen = torch.Generator(device=dev).manual_seed(h * 31 + n)
    imgs = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8,
                         device=dev, generator=gen)
    t = EncoderTables.for_quality(90, mode, dev)
    assert fused_dctq.row_fold(h, w, mode)
    fused_dctq.PADS.folds = fused_dctq.PADS.gathers = 0
    got, launches = _path_launches(
        lambda: fused_dctq._pixel_nat(imgs, t.m, t.bias,
                                      fused_dctq.kernel_factors(t, mode),
                                      mode, with_dc))
    assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (1, 0)
    assert launches["pixel_dc" if with_dc else "pixel"] == 1
    padded = ops.pad_to_multiple(imgs, ops.mcu_shape(mode))
    want = fused_dctq.encode_blocks_pairs(
        padded.reshape(-1, *padded.shape[2:]), t.m, t.bias, mode,
        with_dc=with_dc)
    plain = torch.cat([fused_dctq.encode_blocks_pairs_plain(
        im, t.m, t.bias, mode) for im in imgs])
    if with_dc:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[0], plain)
        assert torch.equal(got[1], fused_dctq.dc_plane(plain))
    else:
        assert torch.equal(got, want) and torch.equal(got, plain)


def test_batch_of_1080p_folds_and_equals_cpu_path(dev):
    """device_encode_batch of 8 x 1920x1080 at 4:2:0 q90 rows: K1 folds
    the rows (no gather, one launch) and the scan equals the plain-twin
    pipeline's on the CPU."""
    from jpegtpu_torch.encoder import device_encode_batch
    imgs = torch.from_numpy(np.stack([_random(1080, 1920, s)
                                      for s in range(8)]))
    bytes_of = {}
    for d in (dev, torch.device("cpu")):
        t = EncoderTables.for_quality(90, "420", d)
        fused_dctq.PADS.folds = fused_dctq.PADS.gathers = 0
        (buf, total, starts), launches = _path_launches(
            lambda: device_encode_batch(imgs.to(d), t, "420", 120))
        if d.type == "cuda":
            assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (1, 0)
            assert launches["pixel"] == 1
        bytes_of[d.type] = (buf[:int(total)].cpu(), starts.cpu())
    assert torch.equal(bytes_of["cuda"][0], bytes_of["cpu"][0])
    assert torch.equal(bytes_of["cuda"][1], bytes_of["cpu"][1])


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_seg_merge_pads_ragged_last_segment(dev, kind):
    """Seven MCUs in segments of three: the last segment holds one MCU,
    the kernel takes the seven as they are (its two missing MCUs are
    zero-length pads inside the kernel), equals the twin on the padded
    input, and still 1-pads the last real byte."""
    n_mcu, n_seg, mps = 7, 3, 3
    c = torch.from_numpy(_coeffs(kind, n_mcu, 7)).to(dev)
    luts = EncoderTables.for_quality(90, "420", dev).luts()
    mw, ml = entropy_pack.block_pack_mcu_segments(c, 4, mps, luts)
    sw, sb = entropy_pack.seg_merge_mcu(mw, ml, n_seg, mps)
    pw, pl = entropy_pack.pad_segments(mw, ml, n_seg, mps)
    assert int(pl[-1]) == int(pl[-2]) == 0
    sw_p, sb_p = entropy_pack.seg_merge_mcu_plain(pw, pl, n_seg, mps)
    assert _same_segments(sw, sb, sw_p, sb_p)
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
    for fn in (fused_dctq.encode_blocks_pairs,
               lambda *a: fused_dctq.encode_blocks_pairs(*a, with_dc=True),
               fused_dctq.encode_blocks_i8_pairs,
               fused_dctq.encode_blocks_dma_pairs):
        with pytest.raises(ValueError, match="CUDA"):
            fn(img, t.m, t.bias)
    c = torch.zeros((1, 384), dtype=torch.int32, device=dev)
    cls = torch.zeros(6, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_pack.block_pack_mcu_pairs(c, cls, cls, *t.luts())
    with pytest.raises(ValueError, match="CUDA"):
        entropy_pack.block_pack_mcu_segments(c, 4, 1, t.luts())


# The kernels of the pixel-path selectors, by name, beside K1 and K2 (the
# encoder's launcher).
PATH_KERNELS = {"pixel": fused_dctq.PIXEL,
                "pixel_dc": fused_dctq.PIXEL_DC_PLANE,
                "pixel_i8": fused_dctq.PIXEL_I8,
                "pixel_dma": fused_dctq.PIXEL_DMA,
                "fused_px_bp": fused_pipeline.FUSED_PX_BP,
                "block_pack": entropy_pack.BLOCK_PACK_SEGMENTS}


def _path_launches(fn):
    """(fn(), launches of each PATH_KERNELS kernel during it)."""
    for k in PATH_KERNELS.values():
        k.launches = 0
    out = fn()
    return out, {n: k.launches for n, k in PATH_KERNELS.items()}


def _restart_of(restart, w, mode):
    """The concrete interval of "rows" (MCUs per row) or an integer."""
    return -(-w // jpegtpu_torch.EncoderConfig(subsampling=mode).mcu_shape[1]
             ) if restart == "rows" else restart


# (mode, image, restart): the fused kernel at one pixel, at widths whose
# MCU count is no multiple of 8 (37x53: 4 MCUs a row at 4:2:0; 120x200:
# 13), at 4:4:4 (g = 3, odd), with no restart (every block's first MCU
# takes its DC predictor from the scalar dot products of the MCU before),
# resets after every MCU, and intervals that fall inside tiles (5, 7, rows
# of 13).
FUSED_CASES = [("420", "pixel_1x1", 0), ("420", "odd_37x53", "rows"),
               ("420", "random_120x200", 0), ("420", "random_120x200", 1),
               ("420", "random_120x200", 5), ("420", "gradient_64x128", 7),
               ("422", "odd_37x53", 0), ("422", "random_120x200", "rows"),
               ("422", "flat_255_48x32", 1), ("444", "pixel_1x1", 0),
               ("444", "odd_37x53", 7), ("444", "random_120x200", 0),
               ("444", "gradient_64x128", "rows")]


@pytest.mark.parametrize("mode,name,restart", FUSED_CASES)
def test_fused_kernel_matches_twin(dev, mode, name, restart):
    """K11 against its twin in one launch: the lengths and the stream bits
    (the words past ceil(mlen / 32) are undefined on the card, as K2's)."""
    x = torch.from_numpy(IMAGES[name]()).to(dev)
    t = EncoderTables.for_quality(90, mode, dev)
    r = _restart_of(restart, x.shape[1], mode)
    (mw, ml), launches = _path_launches(
        lambda: fused_pipeline.fused_pixel_block_pack_pairs(x, t, mode, r))
    assert launches["fused_px_bp"] == 1 and launches["block_pack"] == 0
    mw_p, ml_p = fused_pipeline.fused_pixel_block_pack_pairs_plain(x, t,
                                                                   mode, r)
    assert torch.equal(ml, ml_p)
    assert torch.equal(_masked(mw, ml), _masked(mw_p, ml_p))


@pytest.mark.parametrize("mode", ["420", "422", "444"])
def test_fused_kernel_on_a_batch_view(dev, mode):
    """Three 37x53 images padded to whole MCUs and viewed as one tall image,
    resets at every image start (the interval divides each image's MCU
    count)."""
    imgs = torch.from_numpy(np.stack([_random(37, 53, s)
                                      for s in (11, 22, 23)])).to(dev)
    padded = ops.pad_to_multiple(imgs, ops.mcu_shape(mode))
    x = padded.reshape(-1, *padded.shape[2:])
    t = EncoderTables.for_quality(90, mode, dev)
    my, mx = ops.mcu_grid(37, 53, mode)
    for r in (mx, my * mx):
        mw, ml = fused_pipeline.fused_pixel_block_pack_pairs(x, t, mode, r)
        mw_p, ml_p = fused_pipeline.fused_pixel_block_pack_pairs_plain(
            x, t, mode, r)
        assert torch.equal(ml, ml_p)
        assert torch.equal(_masked(mw, ml), _masked(mw_p, ml_p))


@pytest.mark.parametrize("q", [1, 100])
@pytest.mark.parametrize("mode", ["420", "422", "444"])
def test_fused_kernel_at_the_quality_extremes(dev, mode, q):
    """K11 at q 1 (almost every AC slot zero) and q 100 (the widest
    coefficients), restart 5, on a 1024x2048 image: 256 tiles at 4:2:0 and
    512 at 4:2:2 and 4:4:4, more than the grid's blocks, so each block's run
    holds several tiles and DC values carry from tile to tile."""
    x = torch.from_numpy(_random(1024, 2048, q)).to(dev)
    t = EncoderTables.for_quality(q, mode, dev)
    mw, ml = fused_pipeline.fused_pixel_block_pack_pairs(x, t, mode, 5)
    mw_p, ml_p = fused_pipeline.fused_pixel_block_pack_pairs_plain(x, t,
                                                                   mode, 5)
    assert torch.equal(ml, ml_p)
    assert torch.equal(_masked(mw, ml), _masked(mw_p, ml_p))


@pytest.mark.parametrize("restart", [0, 7])
@pytest.mark.parametrize("mode", ["420", "422", "444"])
def test_fused_kernel_writes_valid_words_and_no_more(dev, mode, restart):
    """K11 launched onto sentinel-filled outputs one MCU row longer than
    the image: each MCU's first ceil(mlen / 32) words and its length are
    the twin's, and nothing is written past them."""
    x = torch.from_numpy(_random(120, 200, 31)).to(dev)
    t = EncoderTables.for_quality(90, mode, dev)
    mh, mw = ops.mcu_shape(mode)
    padded = ops.pad_to_multiple(x, (mh, mw)).contiguous()
    nrx = padded.shape[1] // mw
    n_mcu = (padded.shape[0] // mh) * nrx
    words = entropy_pack.mcu_words(t.bias.shape[0] // 64)
    out = torch.full((n_mcu + nrx, words), SENTINEL, dtype=torch.int32,
                     device=dev)
    lens = torch.full((n_mcu + nrx,), SENTINEL, dtype=torch.int32,
                      device=dev)
    lum, chroma = fused_dctq.cuda_factors(t.m, t.bias, mode)
    fused_pipeline.FUSED_PX_BP.launch(
        dev, padded.data_ptr(), lum.data_ptr(), chroma.data_ptr(),
        t.bias.data_ptr(), *(u.data_ptr() for u in t.luts()),
        out.data_ptr(), lens.data_ptr(), n_mcu, nrx, padded.shape[1] * 3,
        restart, mh, mw, words)
    mw_p, ml_p = fused_pipeline.fused_pixel_block_pack_pairs_plain(
        x, t, mode, restart)
    assert torch.equal(lens[:n_mcu], ml_p) and _past(out[:n_mcu], ml_p) == 0
    assert torch.equal(_masked(out[:n_mcu], ml_p), _masked(mw_p, ml_p))
    assert bool((out[n_mcu:] == SENTINEL).all())
    assert bool((lens[n_mcu:] == SENTINEL).all())


def test_fused_kernel_refuses_coefficients_past_int16(dev):
    """An operator whose coefficients could pass 32,767 (the 4:2:0 one
    times 64: it still factors and is exact in float64) raises before a
    launch, on the card as on the CPU."""
    t = EncoderTables.for_quality(90, "420", dev)
    big = EncoderTables(t.m * 64, t.bias * 64, *t.luts(), t.block_m,
                        t.block_bias)
    x = torch.from_numpy(_random(32, 32, 3)).to(dev)
    fused_pipeline.FUSED_PX_BP.launches = 0
    with pytest.raises(ValueError, match="int16"):
        fused_pipeline.fused_pixel_block_pack_pairs(x, big, "420", 0)
    assert fused_pipeline.FUSED_PX_BP.launches == 0


@pytest.mark.parametrize("q", [1, 50, 90, 100])
@pytest.mark.parametrize("mode", ["420", "422", "444", "444s"])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_dc_plane_kernel_matches_twin(dev, name, mode, q):
    """K12 at every fused geometry: the coefficients of K1's twin and
    their DC plane, lanes past the MCU's blocks zero."""
    img = torch.from_numpy(IMAGES[name]()).to(dev)
    t = EncoderTables.for_quality(q, mode, dev)
    (got, dc), launches = _path_launches(
        lambda: fused_dctq.encode_blocks_pairs(img, t.m, t.bias, mode,
                                               with_dc=True))
    assert launches["pixel_dc"] == 1 and launches["pixel"] == 0
    want = fused_dctq.encode_blocks_pairs_plain(img, t.m, t.bias, mode)
    assert torch.equal(got, want)
    assert dc.shape == (want.shape[0], 8) and dc.dtype == torch.int32
    assert torch.equal(dc, fused_dctq.dc_plane(want))


def _strip_images():
    """4:2:0 inputs of the i8 and async-copy kernels: one MCU (16x16, and
    1x1 padded to it), an MCU count that leaves the last 8-MCU strip short
    (37x53: 12 MCUs), MCU rows that cross strips (120x200: rows of 13), a
    tall view of three padded images, and a 32x48 image at an odd
    address."""
    out = {n: torch.from_numpy(IMAGES[n]()) for n in
           ("pixel_1x1", "odd_37x53", "random_120x200")}
    out["one_mcu_16x16"] = torch.from_numpy(_random(16, 16, 19))
    imgs = torch.from_numpy(np.stack([_random(37, 53, s)
                                      for s in (11, 22, 23)]))
    padded = ops.pad_to_multiple(imgs, (16, 16))
    out["tall_3x37x53"] = padded.reshape(-1, *padded.shape[2:])
    flat = torch.from_numpy(_random(1, 1 + 32 * 48, 29).reshape(-1))
    out["odd_address_32x48"] = flat[1:1 + 32 * 48 * 3].view(32, 48, 3)
    return out


@pytest.mark.parametrize("q", [1, 50, 90, 100])
@pytest.mark.parametrize("route", ["i8", "dma"])
def test_i8_and_dma_kernels_match_twin(dev, route, q):
    t = EncoderTables.for_quality(q, "420", dev)
    fn = {"i8": fused_dctq.encode_blocks_i8_pairs,
          "dma": fused_dctq.encode_blocks_dma_pairs}[route]
    for name, img in _strip_images().items():
        x = img.to(dev)
        got, launches = _path_launches(lambda: fn(x, t.m, t.bias, "420"))
        assert launches[f"pixel_{route}"] == 1, name
        want = fused_dctq.encode_blocks_pairs_plain(x, t.m, t.bias)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("route", ["i8", "dma"])
@pytest.mark.parametrize("mode", ["422", "444", "444s"])
def test_i8_and_dma_take_the_matmul_route_off_420(dev, route, mode):
    """As in jpegtpu, only 4:2:0 has these kernels: the other modes take the
    float64 matmul ("xla") and launch no pixel kernel."""
    x = torch.from_numpy(IMAGES["odd_37x53"]()).to(dev)
    t = EncoderTables.for_quality(90, mode, dev)
    fn = {"i8": fused_dctq.encode_blocks_i8_pairs,
          "dma": fused_dctq.encode_blocks_dma_pairs}[route]
    got, launches = _path_launches(lambda: fn(x, t.m, t.bias, mode))
    assert not any(launches.values())
    assert torch.equal(got, fused_dctq.encode_blocks_pairs_plain(
        x, t.m, t.bias, mode))


def _want_path_launches(mode, fused, pixel_path, fuse_bp, pixel_dc):
    """The launches of PATH_KERNELS that one encode of this configuration
    makes."""
    want = dict.fromkeys(PATH_KERNELS, 0)
    if fuse_bp and mode in fused_pipeline.FUSED_MODES:
        want["fused_px_bp"] = 1
        return want
    want["block_pack"] = 1
    if fused and pixel_path == "nat":
        want["pixel_dc" if pixel_dc else "pixel"] = 1
    elif fused and pixel_path == "dma" and mode == "420":
        want["pixel_dma"] = 1
    return want


@pytest.mark.parametrize("fuse_bp", [False, True])
@pytest.mark.parametrize("pixel_path", ["nat", "xla", "dma"])
@pytest.mark.parametrize("mode", MODES)
def test_pixel_paths_on_gpu_equal_cpu_path(dev, mode, pixel_path, fuse_bp):
    """Every pixel_path x fuse_bp x mode on the card: the CPU path's bytes,
    through the kernels that configuration selects, at restart "rows"
    and 0."""
    img = IMAGES["random_120x200"]()
    if mode == "gray":
        img = np.ascontiguousarray(img[..., 1])
    fused = fused_dctq.uses_fused(*img.shape[:2], mode)
    for restart in ("rows", 0):
        kw = dict(quality=90, subsampling=mode, restart_interval=restart,
                  pixel_path=pixel_path, fuse_bp=fuse_bp)
        got, launches = _path_launches(
            lambda: jpegtpu_torch.encode(img, device=dev, **kw))
        assert launches == _want_path_launches(mode, fused, pixel_path,
                                               fuse_bp, False)
        assert got == jpegtpu_torch.encode(img, device="cpu", **kw)


@pytest.mark.parametrize("mode", MODES)
def test_pixel_dc_path_on_gpu_equals_cpu_path(dev, mode, monkeypatch):
    """JPEGTPU_PIXEL_DC's route: the DC-plane kernel on "nat"."""
    monkeypatch.setattr(fused_dctq, "PIXEL_DC", True)
    img = IMAGES["odd_37x53"]()
    if mode == "gray":
        img = np.ascontiguousarray(img[..., 1])
    kw = dict(quality=90, subsampling=mode)
    got, launches = _path_launches(
        lambda: jpegtpu_torch.encode(img, device=dev, **kw))
    assert launches == _want_path_launches(
        mode, fused_dctq.uses_fused(37, 53, mode), "nat", False, True)
    assert got == jpegtpu_torch.encode(img, device="cpu", **kw)


@pytest.mark.parametrize("mode", MODES)
def test_fused_batch_on_gpu_equals_cpu_path(dev, mode):
    """encode_batch with fuse_bp: one launch of the fused kernel for the
    batch (4:4:4s and gray: the split kernels), the CPU path's files."""
    imgs = [_random(37, 53, s) for s in (11, 22, 23)]
    if mode == "gray":
        imgs = [np.ascontiguousarray(im[..., 0]) for im in imgs]
    kw = dict(quality=90, subsampling=mode, fuse_bp=True)
    got, launches = _path_launches(
        lambda: jpegtpu_torch.encode_batch(imgs, device=dev, **kw))
    assert launches == _want_path_launches(
        mode, fused_dctq.uses_fused(37, 53, mode), "nat", True, False)
    assert got == jpegtpu_torch.encode_batch(imgs, device="cpu", **kw)


# --- The oracle tier: K7 (per-block pack), K8 (MCU merge), K9 (segment
# merge v2), K10 (segment merge v1), each against its twin on the same CUDA
# tensors, with its launch count.

ORACLE_KERNELS = (entropy_pack.PACK_BLOCKS, entropy_oracles.MCU_MERGE,
                  entropy_oracles.SEG_MERGE_WINDOW,
                  entropy_oracles.SEG_MERGE_V1, entropy_pack.SEG_MERGE)


def _oracle_launches(fn):
    """(fn(), launches of K7, K8, K9, K10, K3 during it)."""
    for k in ORACLE_KERNELS:
        k.launches = 0
    out = fn()
    return out, [k.launches for k in ORACLE_KERNELS]


def _oracle_streams(n, row_words, seed, dev):
    """n stream rows of random words with random lengths in [0, 32 *
    row_words] (some 0, whole words, full rows) and random bits past each
    length, which every merge ignores."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (n, row_words), dtype=np.uint64)
    lens = rng.integers(0, 32 * row_words + 1, n)
    lens[::11] = 0
    lens[1::13] = 32 * rng.integers(0, row_words + 1, len(lens[1::13]))
    lens[2::17] = 32 * row_words
    return (torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev))


@pytest.mark.parametrize("n", [1, 13, 1027, 20003])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_block_pack_kernel_matches_twin(dev, kind, n):
    """K7 at block counts that fill no whole thread block, and past one
    sweep of its grid (8 blocks of 8 warps per SM)."""
    c = torch.from_numpy(_coeffs(kind, -(-n // 6), n)).to(dev)
    c = c.reshape(-1, 64)[:n]
    rng = np.random.default_rng(n)
    cls = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)
    dcd = torch.from_numpy(rng.integers(-2047, 2048, n).astype(np.int32)
                           ).to(dev)
    (w, l), launches = _oracle_launches(
        lambda: entropy_pack.block_pack(c, cls, dcd))
    assert launches == [1, 0, 0, 0, 0]
    w_p, l_p = entropy_pack.block_pack_plain(
        c, cls, dcd, *entropy_pack.standard_luts(dev))
    assert torch.equal(l, l_p) and torch.equal(w, w_p)


def _k7_per():
    """csrc/block_pack.cu's kPackPer: the blocks a K7 warp takes."""
    src = (_build.CSRC / "block_pack.cu").read_text()
    return int(re.search(r"kPackPer = (\d+)", src).group(1))


@pytest.mark.parametrize("n", [1, 31, "per-1", "per+1", 100003])
@pytest.mark.parametrize("kind", ["dense", "sparse", "longest"])
def test_block_pack_kernel_writes_whole_rows_only(dev, kind, n):
    """K7 launched directly into rows 1 .. n of an [n + 2, 56] buffer of
    SENTINEL (the lengths likewise): every word of each row written (zeros
    past the stream), nothing outside, at counts that leave a warp's last
    group short and past one sweep of the persistent grid, and on blocks
    of the longest stream (every slot at 10 bits in luma, 1,658 bits)."""
    per = _k7_per()
    n = max(1, {"per-1": per - 1, "per+1": per + 1}.get(n, n))
    rng = np.random.default_rng(n)
    if kind == "longest":
        c = rng.choice([-1023, 1023], (n, 64)).astype(np.int32)
        cls = np.zeros(n, np.int32)
        dcd = rng.choice([-2047, 2047], n).astype(np.int32)
    else:
        c = _coeffs(kind, -(-n // 6), n).reshape(-1, 64)[:n]
        cls = rng.integers(0, 2, n).astype(np.int32)
        dcd = rng.integers(-2047, 2048, n).astype(np.int32)
    c, cls, dcd = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (c, cls, dcd))
    luts = entropy_pack.standard_luts(dev)
    w = torch.full((n + 2, entropy_pack.BLOCK_WORDS), SENTINEL,
                   dtype=torch.int32, device=dev)
    l = torch.full((n + 2,), SENTINEL, dtype=torch.int32, device=dev)
    entropy_pack.PACK_BLOCKS.launch(
        dev, c.data_ptr(), cls.data_ptr(), dcd.data_ptr(),
        *(t.data_ptr() for t in luts), w[1].data_ptr(), l[1:].data_ptr(), n)
    w_p, l_p = entropy_pack.block_pack_plain(c, cls, dcd, *luts)
    assert torch.equal(l[1:-1], l_p) and torch.equal(w[1:-1], w_p)
    assert bool((w[0] == SENTINEL).all() and (w[-1] == SENTINEL).all())
    assert int(l[0]) == int(l[-1]) == SENTINEL
    if kind == "longest":
        assert bool((l_p == 1658).all())


def test_block_pack_copies_a_misaligned_input(dev):
    """K7 loads two slots at once: a view of the coefficients 4 bytes off
    an 8-byte boundary goes through an aligned copy; the launcher refuses
    it (716, misaligned address) and an output row off 16 bytes."""
    n = 37
    flat = torch.from_numpy(_coeffs("dense", 7, 5).reshape(-1)).to(dev)
    c = flat[1:1 + 64 * n].reshape(n, 64)
    cls = torch.zeros(n, dtype=torch.int32, device=dev)
    dcd = torch.arange(n, dtype=torch.int32, device=dev)
    luts = entropy_pack.standard_luts(dev)
    w, l = entropy_pack.block_pack(c, cls, dcd)
    w_p, l_p = entropy_pack.block_pack_plain(c, cls, dcd, *luts)
    assert torch.equal(l, l_p) and torch.equal(w, w_p)
    out = torch.empty((n + 1, entropy_pack.BLOCK_WORDS), dtype=torch.int32,
                      device=dev)
    for cp, wp in ((c.data_ptr(), out.data_ptr()),
                   (c.contiguous().clone().data_ptr(), out.data_ptr() + 4)):
        with pytest.raises(RuntimeError, match="CUDA error 716"):
            entropy_pack.PACK_BLOCKS.launch(
                dev, cp, cls.data_ptr(), dcd.data_ptr(),
                *(t.data_ptr() for t in luts), wp, l.data_ptr(), n)


# (g, MCUs, chunks): g = 1, 3, 4 and 6, ragged tiles, budget-sized rows
# that truncate, more blocks than a warp's lanes (200), a row of 500
# chunks (64,000 words) and g past a whole-segment tile (1000 blocks: split
# tiles, a look-back and tail tiles).
MCU_CASES = [(1, 7, None), (3, 5, None), (4, 300, None), (6, 33, None),
             (3, 9, "budget"), (6, 33, "budget"), (200, 3, None),
             (12, 3, 500), (1000, 2, None)]


@pytest.mark.parametrize("g,n_mcu,chunks", MCU_CASES)
def test_mcu_merge_kernel_matches_twin(dev, g, n_mcu, chunks):
    words, lens = _oracle_streams(g * n_mcu, entropy_pack.BLOCK_WORDS,
                                  g + n_mcu, dev)
    if chunks == "budget":
        chunks = entropy_pack.mcu_capacity(g, 384)[0]
    (mw, ml), launches = _oracle_launches(
        lambda: entropy_oracles.mcu_merge(words, lens, g, chunks))
    assert launches == [0, 1, 0, 0, 0]
    width = mw.shape[1]
    mw_p, ml_p = entropy_oracles.mcu_merge_plain(words, lens, g, width)
    assert torch.equal(ml, ml_p) and torch.equal(mw, mw_p)
    if chunks is not None and width < 128 * entropy_oracles.default_chunks(g):
        assert bool((ml > 32 * width).any()), "pick truncating inputs"


# (n_seg, streams per segment, w_cap): one stream per segment, restart
# rows, segments of 600 blocks for v1 (split tiles), a 32,400-MCU single
# segment (194,400 blocks for v1), and rows too short for their segments
# (whole and split).
SEGMENT_CASES = {"one_per_segment": (50, 1, 64), "rows": (7, 45, None),
                 "split_rows": (5, 100, None),
                 "single_32400_mcus": (1, 32400, None),
                 "overflowing_w_cap": (5, 40, 300),
                 "overflowing_split": (3, 200, 500)}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
@pytest.mark.parametrize("rung", ["v1", "v2"])
def test_segment_merge_kernels_match_twins(dev, rung, case):
    """K10 (v1, over 56-word block rows) and K9 (v2, over K8's MCU rows)
    against their twins: true seg_bits, and the same words, 1-pad and
    dropped words past the row included."""
    n_seg, mps, w_cap = SEGMENT_CASES[case]
    g = 6
    words, lens = _oracle_streams(n_seg * mps * g, entropy_pack.BLOCK_WORDS,
                                  mps, dev)
    if w_cap is None:
        w_cap = mps * g * entropy_pack.BLOCK_WORDS + 2
    if rung == "v1":
        (sw, sb), launches = _oracle_launches(
            lambda: entropy_oracles.seg_merge(words, lens, n_seg, mps * g,
                                              w_cap))
        assert launches == [0, 0, 0, 1, 0]
        sw_p, sb_p = entropy_oracles.seg_merge_plain(words, lens, n_seg,
                                                     sw.shape[1])
    else:
        (sw, sb), launches = _oracle_launches(
            lambda: entropy_oracles.seg_merge_v2(words, lens, n_seg, mps * g,
                                                 w_cap, g))
        assert launches == [0, 1, 1, 0, 0]
        mw, ml = entropy_oracles.mcu_merge_plain(
            words, lens, g, 128 * entropy_oracles.default_chunks(g))
        sw_p, sb_p = entropy_oracles.seg_merge_window_plain(mw, ml, n_seg,
                                                            sw.shape[1])
    assert torch.equal(sb, sb_p) and torch.equal(sw, sw_p)
    if case == "overflowing_w_cap":
        assert bool((sb > 32 * sw.shape[1]).all()), "pick overflowing rows"


@pytest.mark.parametrize("mode,restart", [("420", 5), ("420", 0),
                                          ("444", 5)])
def test_oracle_rungs_equal_the_main_path(dev, mode, restart):
    """K7 -> K10 (v1), K7 -> K8 -> K9 (v2) and K7 -> K8 -> K3 (v3) give
    the segments of K2 -> K3, and K8 of K7 gives K2's MCU streams."""
    img = torch.from_numpy(_random(120, 200, 3)).to(dev)
    t = EncoderTables.for_quality(90, mode, dev)
    c = fused_dctq.encode_blocks_pairs(img, t.m, t.bias, mode)
    nm, g = c.shape[0], c.shape[1] // 64
    n_luma = 4 if mode == "420" else 1
    mps = restart or nm
    n_seg = nm // mps
    c = c[:n_seg * mps]
    nm = c.shape[0]
    dcd = scan.dc_diffs_from_dc(c[:, ::64], n_luma, restart).reshape(-1)
    cls = entropy_pack.block_classes(nm, g, n_luma, dev)
    mw, ml = entropy_pack.block_pack_mcu_pairs(c, cls, dcd, *t.luts())
    sw, sb = entropy_pack.seg_merge_mcu(mw, ml, n_seg, mps)
    (bw, bl), launches = _oracle_launches(
        lambda: entropy_pack.block_pack(c.reshape(-1, 64), cls, dcd))
    assert launches == [1, 0, 0, 0, 0]
    mw8, ml8 = entropy_oracles.mcu_merge(bw, bl, g)
    assert torch.equal(ml8, ml)
    # K2's stream bits (the card leaves the bits past each length
    # undefined); K8's rows are zero past them.
    assert torch.equal(_masked(mw8[:, :mw.shape[1]], ml), _masked(mw, ml))
    assert not bool(mw8[:, mw.shape[1]:].any())
    w_cap = entropy_pack.segment_words(n_seg, mps, mw.shape[1])
    rungs, launches = _oracle_launches(lambda: {
        "v1": entropy_oracles.seg_merge(bw, bl, n_seg, mps * g, w_cap),
        "v2": entropy_oracles.seg_merge_v2(bw, bl, n_seg, mps * g, w_cap, g),
        "v3": entropy_pack.seg_merge_v3(bw, bl, n_seg, mps * g, w_cap,
                                        g)[:2]})
    assert launches == [0, 2, 1, 1, 1]
    n = int(-(-sb.max() // 32))
    for rung, (rw, rb) in rungs.items():
        assert _same_segments(rw[:, :n], rb, sw[:, :n], sb), rung


def _sentinel_oracle(kernel, rows, lens, n_seg, per_seg, width):
    """K8, K9 or K10 launched directly into rows 1 .. n_seg of an [n_seg + 2,
    width] buffer filled with SENTINEL (seg_bits likewise): (the buffer,
    its seg_bits)."""
    buf = torch.full((n_seg + 2, width), SENTINEL, dtype=torch.int32,
                     device=rows.device)
    sb = torch.full((n_seg + 2,), SENTINEL, dtype=torch.int32,
                    device=rows.device)
    split_rows = (entropy_pack.SEG_MERGE_TILE
                  if kernel is entropy_oracles.SEG_MERGE_WINDOW else None)
    n_scratch = entropy_pack.seg_merge_scratch_words(n_seg, per_seg, True,
                                                     width, split_rows)
    scratch = torch.empty(max(n_scratch, 1), dtype=torch.int64,
                          device=rows.device)
    kernel.launch(rows.device, rows.data_ptr(), lens.data_ptr(),
                  buf[1].data_ptr(), sb[1:].data_ptr(),
                  scratch.data_ptr() if n_scratch else None, n_seg, per_seg,
                  rows.shape[1], width)
    return buf, sb


# (instance, segments, streams a segment, output words): K8 at g 1, 3, 4,
# 6 and 40 (past a warp's lanes), a budget row that truncates and g 600
# (split); K10 on segments of 6 blocks (whole), 480 (in rows wider than a
# tail tile: split) and 600 (split), one segment of 194,400 (the restart-0
# shape, 760 tiles and tail tiles) and rows shorter than their data (whole
# and split); K9 over K8's 384-word MCU rows, in jpegtpu's v2 rows of
# frames * 1024 words (None: the rows that hold the worst case), on one MCU
# a segment (whole tiles), the 240-MCU segments of 4:2:0 rows (rows wider
# than a tail tile: split), 600-MCU segments and the 32,400-MCU restart-0
# segment (split), and rows shorter than their data (whole and split).
SENTINEL_MERGES = {
    "K8_g1": ("K8", 50, 1, 128), "K8_g3": ("K8", 41, 3, 256),
    "K8_g4": ("K8", 37, 4, 256), "K8_g6": ("K8", 33, 6, 384),
    "K8_g40": ("K8", 5, 40, 2176), "K8_budget": ("K8", 33, 6, 128),
    "K8_g600": ("K8", 2, 600, 31232),
    "K10_6": ("K10", 40, 6, 384), "K10_480": ("K10", 5, 480, 27008),
    "K10_600": ("K10", 4, 600, 33664),
    "K10_194400": ("K10", 1, 194400, 10108928),
    "K10_short_whole": ("K10", 5, 240, 256),
    "K10_short_split": ("K10", 3, 1200, 512),
    "K9_one_mcu": ("K9", 50, 1, None), "K9_240": ("K9", 5, 240, None),
    "K9_600": ("K9", 3, 600, None), "K9_32400": ("K9", 1, 32400, None),
    "K9_short_whole": ("K9", 5, 240, 2048),
    "K9_short_split": ("K9", 2, 1200, 4096),
}


@pytest.mark.parametrize("case", sorted(SENTINEL_MERGES))
def test_merge_instances_write_whole_rows_only(dev, case):
    """K8, K9 and K10, instances of K3's body with the zero tail, against
    their twins on whole rows, bit for bit, launched between sentinel rows:
    every word of each output row written (zeros past the data), nothing
    outside the output, the true bit counts."""
    which, n_seg, per, width = SENTINEL_MERGES[case]
    row_w = 384 if which == "K9" else entropy_pack.BLOCK_WORDS
    words, lens = _oracle_streams(n_seg * per, row_w, n_seg + per, dev)
    if width is None:
        w_cap = entropy_pack.segment_words(n_seg, per, row_w)
        width = (-(-w_cap // 1024) + 1) * 1024
    if which == "K8":
        kernel = entropy_oracles.MCU_MERGE
        want_w, want_b = entropy_oracles.mcu_merge_plain(words, lens, per,
                                                         width)
    elif which == "K9":
        kernel = entropy_oracles.SEG_MERGE_WINDOW
        want_w, want_b = entropy_oracles.seg_merge_window_plain(
            words, lens, n_seg, width)
    else:
        kernel = entropy_oracles.SEG_MERGE_V1
        want_w, want_b = entropy_oracles.seg_merge_plain(words, lens, n_seg,
                                                         width)
    buf, sb = _sentinel_oracle(kernel, words, lens, n_seg, per, width)
    assert torch.equal(sb[1:-1], want_b) and torch.equal(buf[1:-1], want_w)
    assert bool((buf[0] == SENTINEL).all() and (buf[-1] == SENTINEL).all())
    assert int(sb[0]) == int(sb[-1]) == SENTINEL
    if case.endswith(("budget", "short_whole", "short_split")):
        assert bool((want_b > 32 * width).any()), "pick truncating rows"


def test_oracle_wrappers_raise_and_never_run_twins(dev, monkeypatch):
    """A CUDA tensor beside a CPU one, an output row of 2^31 words, or a
    launcher missing from the library raises; no twin runs."""
    for name in ("block_pack_plain",):
        monkeypatch.setattr(entropy_pack, name, None)
    for name in ("mcu_merge_plain", "seg_merge_window_plain",
                 "seg_merge_plain"):
        monkeypatch.setattr(entropy_oracles, name, None)
    words, lens = _oracle_streams(12, entropy_pack.BLOCK_WORDS, 1, dev)
    c = torch.zeros((12, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_pack.block_pack(c, lens.cpu(), lens)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_oracles.mcu_merge(words, lens.cpu(), 6)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_oracles.seg_merge(words, lens.cpu(), 2, 6, 1024)
    with pytest.raises(ValueError, match="under 2"):
        entropy_oracles.mcu_merge(words, lens, 12, 1 << 24)
    k = entropy_oracles.SEG_MERGE_WINDOW
    monkeypatch.setattr(k, "_fn", None)
    monkeypatch.setattr(k, "symbol", "jt_no_such_launcher")
    k.launches = 0
    with pytest.raises(AttributeError, match="jt_no_such_launcher"):
        entropy_oracles.seg_merge_v2(words, lens, 2, 6, 1024, 6)
    assert k.launches == 0


# --- K2's two launchers and K3, against their twins at small shapes and
# edge cases, onto buffers filled with SENTINEL first: K2 writes each MCU's
# first ceil(mlen / 32) words and K3 each segment's first ceil(seg_bits /
# 32), nothing past them.

SENTINEL = 0x7FFFFFFF


def _sentinel_block_pack(c, n_luma, restart, luts, dc=None, pairs=None):
    """K2 launched directly onto sentinel-filled outputs: by the encoder's
    launcher, or with pairs = (cls, dcd) by jpegtpu's signature."""
    nm, g = c.shape[0], c.shape[1] // 64
    mw = torch.full((nm, entropy_pack.mcu_words(g)), SENTINEL,
                    dtype=torch.int32, device=c.device)
    ml = torch.full((nm,), SENTINEL, dtype=torch.int32, device=c.device)
    ptrs = [t.data_ptr() for t in luts]
    if pairs is None:
        src = c if dc is None else dc
        strides = (g * 64, 64) if dc is None else (dc.shape[1], 1)
        entropy_pack.BLOCK_PACK_SEGMENTS.launch(
            c.device, c.data_ptr(), src.data_ptr(), *strides, *ptrs,
            mw.data_ptr(), ml.data_ptr(), nm, g, n_luma, restart,
            mw.shape[1])
    else:
        entropy_pack.BLOCK_PACK.launch(
            c.device, c.data_ptr(), pairs[0].data_ptr(), pairs[1].data_ptr(),
            *ptrs, mw.data_ptr(), ml.data_ptr(), nm, g, mw.shape[1])
    return mw, ml


def _past(words, nbits):
    """Words at or past ceil(nbits / 32) of each row that are not
    SENTINEL (written where nothing may be)."""
    j = torch.arange(words.shape[1], device=words.device)[None, :]
    past = j >= (nbits.to(torch.int64)[:, None] + 31) // 32
    return int((past & (words != SENTINEL)).sum())


def _sentinel_merge(mw, ml, n_seg, mps):
    """K3 launched directly onto sentinel-filled outputs."""
    seg_w = entropy_pack.segment_words(n_seg, mps, mw.shape[1])
    sw = torch.full((n_seg, seg_w), SENTINEL, dtype=torch.int32,
                    device=mw.device)
    sb = torch.full((n_seg,), SENTINEL, dtype=torch.int32, device=mw.device)
    n_scratch = entropy_pack.seg_merge_scratch_words(n_seg, mps)
    scratch = torch.empty(max(n_scratch, 1), dtype=torch.int64,
                          device=mw.device)
    entropy_pack.SEG_MERGE.launch(
        mw.device, mw.data_ptr(), ml.data_ptr(), sw.data_ptr(),
        sb.data_ptr(), scratch.data_ptr() if n_scratch else None,
        mw.shape[0], n_seg, mps, mw.shape[1], seg_w)
    return sw, sb


@pytest.mark.parametrize("source", ["coefficients", "dc_plane"])
@pytest.mark.parametrize("restart", [0, 1, 4, 7])
@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
def test_block_pack_launchers_match_twins(dev, mode, restart, source):
    """Both K2 launchers against the twin on one mode's coefficients (13
    MCUs, g = 6 / 4 / 3 / 1), wrapped and onto sentinel buffers: the
    lengths, the stream bits, and no word written past ceil(mlen / 32)."""
    g, n_luma = {"420": (6, 4), "422": (4, 2), "444": (3, 1),
                 "gray": (1, 1)}[mode]
    rng = np.random.default_rng(restart * 10 + g)
    c6 = _coeffs("sparse" if restart % 2 else "dense", 13, restart + g)
    c = torch.from_numpy(np.ascontiguousarray(
        c6.reshape(-1, 64)[:13 * g].reshape(13, g * 64))).to(dev)
    luts = EncoderTables.for_quality(90, "420", dev).luts()
    dc = None
    if source == "dc_plane":
        plane = rng.integers(-2000, 2000, (13, 8)).astype(np.int32)
        plane[:, :g] = c[:, ::64].cpu().numpy()
        dc = torch.from_numpy(plane).to(dev)
    mw, ml = entropy_pack.block_pack_mcu_segments(c, n_luma, restart, luts,
                                                  dc)
    mw_p, ml_p = entropy_pack.block_pack_mcu_segments_plain(
        c, n_luma, restart, luts, dc)
    assert torch.equal(ml, ml_p)
    assert torch.equal(_masked(mw, ml), _masked(mw_p, ml_p))
    sw, sl = _sentinel_block_pack(c, n_luma, restart, luts, dc)
    assert torch.equal(sl, ml_p) and _past(sw, ml_p) == 0
    assert torch.equal(_masked(sw, sl), _masked(mw_p, ml_p))
    dcd = scan.dc_diffs_from_dc(c[:, ::64] if dc is None else dc[:, :g],
                                n_luma, restart).reshape(-1)
    cls = entropy_pack.block_classes(13, g, n_luma, dev)
    pw, pl = _sentinel_block_pack(c, n_luma, restart, luts, pairs=(cls, dcd))
    assert torch.equal(pl, ml_p) and _past(pw, ml_p) == 0
    assert torch.equal(_masked(pw, pl), _masked(mw_p, ml_p))


def test_block_pack_refusals(dev):
    """A g past the kernel's limit raises ValueError; coefficients that are
    not 8-byte aligned are refused by the launcher (716), nothing
    launched."""
    luts = EncoderTables.for_quality(90, "420", dev).luts()
    g = entropy_pack.BLOCK_PACK_MAX_G + 1
    c = torch.zeros((2, g * 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="blocks an MCU"):
        entropy_pack.block_pack_mcu_segments(c, 1, 0, luts)
    flat = torch.zeros(1 + 2 * 384, dtype=torch.int32, device=dev)
    odd = flat[1:].view(2, 384)
    k = entropy_pack.BLOCK_PACK_SEGMENTS
    k.launches = 0
    mw = torch.empty((2, 314), dtype=torch.int32, device=dev)
    ml = torch.empty((2,), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error 716 "):
        k.launch(dev, odd.data_ptr(), odd.data_ptr(), 384, 64,
                 *(t.data_ptr() for t in luts), mw.data_ptr(), ml.data_ptr(),
                 2, 6, 4, 0, 314)
    assert k.launches == 0


def _merge_case(name, dev):
    """(MCU words, lengths, n_seg, mps) of a K3 edge case."""
    if name == "one_mcu_one_segment":
        w, l = _oracle_streams(1, 20, 1, dev)
        return w, l, 1, 1
    if name == "one_segment_of_2000_mcus":      # 8 tiles, a look-back chain
        w, l = _oracle_streams(2000, 20, 2, dev)
        return w, l, 1, 2000
    if name == "three_segments_of_700_ragged":  # tiles cut in each segment
        w, l = _oracle_streams(1900, 20, 3, dev)
        return w, l, 3, 700
    if name == "ragged_pads":                   # last segment 1 MCU of 5
        w, l = _oracle_streams(11, 20, 4, dev)
        return w, l, 3, 5
    if name == "whole_word_mcus":               # every MCU 32k bits long
        w, l = _oracle_streams(600, 20, 5, dev)
        l = 32 * torch.randint(0, 21, l.shape, device=dev, dtype=l.dtype)
        return w, l, 12, 50
    if name == "one_mcu_segments":
        w, l = _oracle_streams(3000, 20, 6, dev)
        return w, l, 3000, 1
    if name == "rows_of_240":
        w, l = _oracle_streams(2400, 20, 7, dev)
        return w, l, 10, 240
    raise KeyError(name)


MERGE_CASES = ["one_mcu_one_segment", "one_segment_of_2000_mcus",
               "three_segments_of_700_ragged", "ragged_pads",
               "whole_word_mcus", "one_mcu_segments", "rows_of_240"]


@pytest.mark.parametrize("name", MERGE_CASES)
def test_seg_merge_matches_twin(dev, name):
    """K3 against its twin on the edge cases (random bits past every MCU's
    length, which it must not read): wrapped, 20 times (the look-back's
    schedule differs from launch to launch), and onto sentinel buffers, with
    no word written past ceil(seg_bits / 32)."""
    mw, ml, n_seg, mps = _merge_case(name, dev)
    want_w, want_b = entropy_pack.seg_merge_mcu_plain(mw, ml, n_seg, mps)
    for _ in range(20):
        sw, sb = entropy_pack.seg_merge_mcu(mw, ml, n_seg, mps)
        assert _same_segments(sw, sb, want_w, want_b)
    sw, sb = _sentinel_merge(mw, ml, n_seg, mps)
    assert _same_segments(sw, sb, want_w, want_b)
    assert _past(sw, want_b) == 0


def test_seg_merge_no_segments_launches_nothing(dev):
    k = entropy_pack.SEG_MERGE
    k.launches = 0
    empty = torch.zeros((0, 314), dtype=torch.int32, device=dev)
    sw, sb = entropy_pack.seg_merge_mcu(empty, empty[:, 0], 0, 240)
    assert sw.shape == (0, entropy_pack.segment_words(0, 240, 314))
    assert sb.shape == (0,) and k.launches == 0


def test_seg_merge_raises_at_2_31_bits(dev):
    """1,024 MCUs of 2^21 bits in one segment: 2^31 bits, which the kernel
    flags and the wrapper raises on (the worst case can reach it); one MCU
    fewer fits."""
    n, row = 1024, 1 << 16
    mw = torch.zeros((n, row), dtype=torch.int32, device=dev)
    ml = torch.full((n,), 32 * row, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="2\\^31"):
        entropy_pack.seg_merge_mcu(mw, ml, 1, n)
    ml[0] = 0
    _, sb = entropy_pack.seg_merge_mcu(mw, ml, 1, n)
    assert int(sb[0]) == (1 << 31) - (1 << 21)


def test_k3_output_feeds_the_stuffing_and_compaction(dev):
    """K4, K5 and K6 on K3's segments with every word past each segment's
    data left at SENTINEL (0x7FFFFFFF: 0xFF bytes) give the bytes of their
    twins on the twin's zero-filled segments."""
    mw, ml, n_seg, mps = _merge_case("rows_of_240", dev)
    sw, sb = _sentinel_merge(mw, ml, n_seg, mps)
    tw, tb = entropy_pack.seg_merge_mcu_plain(mw, ml, n_seg, mps)
    for fn, plain in ((compact.compact_segments_stuffed_grouped,
                       compact.compact_segments_stuffed_grouped_plain),
                      (compact.compact_segments_stuffed,
                       compact.compact_segments_stuffed_plain)):
        buf, total = fn(sw, sb, mps)[:2]
        want, want_total = plain(tw, tb, mps)[:2]
        assert int(total) == int(want_total)
        assert torch.equal(buf[:int(total)], want[:int(total)])
    buf, nb = compact.compact_segments(sw, sb)
    want, want_nb = compact.compact_segments_plain(tw, tb)
    assert torch.equal(nb, want_nb)
    n = int(want_nb.sum())
    assert torch.equal(buf[:n], want[:n])


# (shape, mode, restart, PIXEL_DC, layout): the benchmark cells' geometries
# (4K 4:2:0 rows, 8 x 1080p 4:2:0 rows, 4K 4:4:4 rows), 4:2:2, restart 1,
# 0 and 7 (a ragged last segment), a single 1080-row frame, whose last MCU
# row K1 folds, and the DC-plane route (K12) on rows, restart 7 and the
# batch; then the inputs the chain makes readable first: a 4K frame one
# byte off an aligned address and a transposed (not contiguous) 1080p
# frame, which it copies, and a width that is not whole MCUs and an 8 x 16
# image (a row pad as long as the image), which it pads.
PLAN_GEOMETRIES = [
    ((2160, 3840, 3), "420", 240, False, "as_is"),
    ((8, 1080, 1920, 3), "420", 120, False, "as_is"),
    ((2160, 3840, 3), "444", 480, False, "as_is"),
    ((2160, 3840, 3), "422", 240, False, "as_is"),
    ((2160, 3840, 3), "420", 1, False, "as_is"),
    ((2160, 3840, 3), "420", 0, False, "as_is"),
    ((2160, 3840, 3), "420", 7, False, "as_is"),
    ((1080, 1920, 3), "420", 120, False, "as_is"),
    ((2160, 3840, 3), "420", 240, True, "as_is"),
    ((2160, 3840, 3), "420", 7, True, "as_is"),
    ((8, 1080, 1920, 3), "420", 120, True, "as_is"),
    ((2160, 3840, 3), "420", 240, False, "misaligned"),
    ((1080, 1920, 3), "420", 120, False, "transposed"),
    ((1080, 1916, 3), "420", 120, False, "as_is"),
    ((8, 16, 3), "420", 1, False, "as_is"),
]
PLAN_IDS = [f"shape{i}-{mode}-{restart}-{dc}" if i < 11 else
            f"{layout}-{'x'.join(map(str, shape[:2]))}-{mode}-{restart}"
            for i, (shape, mode, restart, dc, layout)
            in enumerate(PLAN_GEOMETRIES)]


def _per_kernel_path(x, t, mode, restart, batch):
    """The default route's wrappers one by one, composed here: the pixel
    kernel, the block pack and the merge (``encoder._segments``), then the
    stuffing wrapper of the scan's segment count."""
    n, h, w = (x.shape[0] if batch else 1), x.shape[-3], x.shape[-2]
    my, mx = ops.mcu_grid(h, w, mode)
    if batch:
        spi = encoder.batch_segments(my * mx, restart)
        n_seg, mps = n * spi, restart
    else:
        n_seg, mps = encoder.geometry(my * mx, restart)
        spi = n_seg
    sw, sb = encoder._segments(x if batch else x[None], t, mode, restart,
                               n_seg, mps)
    if n_seg == 1 and not batch:
        return compact.compact_segments_stuffed(sw, sb, restart)
    out = compact.compact_segments_stuffed_grouped(sw, sb, restart, spi)
    return out if batch else out[:2]


@pytest.mark.parametrize("shape,mode,restart,pixel_dc,layout",
                         PLAN_GEOMETRIES, ids=PLAN_IDS)
def test_planned_chain_equals_per_kernel_path_and_reference(
        dev, monkeypatch, shape, mode, restart, pixel_dc, layout):
    """The default route from its plan (``chain``): one native call a call,
    each kernel's launch count (K12's with PIXEL_DC) up by one as the
    chain reports it, the plan built once and then hit, a fold where K1
    folds and a gather where the image is padded first; its scan (and a
    batch's offsets) byte for byte the per-kernel path's on the same input
    and the plain reference's (``portbench/reference``). Each call's
    outputs are its own: the first call's scan is intact after the
    second."""
    from portbench import frames
    from portbench.reference import jpeg
    monkeypatch.setattr(fused_dctq, "PIXEL_DC", pixel_dc)
    batch = len(shape) == 4
    n, h, w = (shape[0] if batch else 1), shape[-3], shape[-2]
    made = (w, h) if layout == "transposed" else (h, w)
    cfg = {"canvas": list(made), "height": made[0], "width": made[1],
           "batch": n, "distinct": 1, "noise_sd": 12.0}
    x = frames.make_inputs(cfg, 2**31 + 18 + restart, dev)[0]
    if layout == "transposed":
        x = x.transpose(0, 1)
    elif layout == "misaligned":
        y = torch.empty(x.numel() + 1, dtype=torch.uint8, device=dev)[1:]
        x = y.view(x.shape).copy_(x)
    assert x.is_contiguous() == (layout != "transposed")
    assert (x.data_ptr() % 16 != 0) == (layout == "misaligned")
    t = EncoderTables.for_quality(90, mode, dev)
    fn = encoder.device_encode_batch if batch else encoder.device_encode
    kernels = (fused_dctq.PIXEL, fused_dctq.PIXEL_DC_PLANE,
               entropy_pack.BLOCK_PACK_SEGMENTS, entropy_pack.SEG_MERGE,
               compact.STUFF, compact.STUFF_CHUNKS, chain.CHAIN)
    for k in kernels:
        k.launches = 0
    chain.PLANS.built = chain.PLANS.hits = chain.PLANS.fallbacks = 0
    fused_dctq.PADS.folds = fused_dctq.PADS.gathers = 0
    planned = [fn(x, t, mode, restart) for _ in range(2)]
    my, mx = ops.mcu_grid(h, w, mode)
    one_seg = not batch and encoder.geometry(my * mx, restart)[0] == 1
    assert [k.launches for k in kernels] == [
        2 * (not pixel_dc), 2 * pixel_dc, 2, 2, 2 * (not one_seg),
        2 * one_seg, 2]
    mh, mw = ops.mcu_shape(mode)
    fold = fused_dctq.row_fold(h, w, mode)
    pad = not fold and bool(h % mh or w % mw)
    assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (
        2 * fold, 2 * pad)
    assert (chain.PLANS.built, chain.PLANS.hits,
            chain.PLANS.fallbacks) == (1, 1, 0)
    per_kernel = _per_kernel_path(x, t, mode, restart, batch)

    def scan_of(out):
        total = int(out[1])
        return (out[0][:total].cpu().numpy().tobytes(),
                out[2].tolist() if batch else None)

    imgs = x if batch else x[None]
    scans = [jpeg.scan(im, 90, mode, restart) for im in imgs]
    starts = np.cumsum([0] + [len(s) for s in scans[:-1]]).tolist()
    want = (b"".join(scans), starts if batch else None)
    assert planned[0][0].data_ptr() != planned[1][0].data_ptr()
    for out in (*planned, per_kernel):
        assert scan_of(out) == want
