"""The stuffing kernel's host side, on the CPU: the tile chain and scratch
sizes that the wrappers hand ``csrc/stuff.cu``, the constants the two
share, and a numpy model of the kernel's decoupled look-back (each tile's
aggregate, its exclusive prefix) held against the plain twins' tables and
scans. Also the segment sets that the CPU and GPU stuffing tests share
(``chunk_case``). Imports no JAX; every comparison is exact."""

import re

import numpy as np
import pytest
import torch

from jpegtpu_torch.kernels import _build, compact, entropy_pack


def stuff_words(n_seg, frames, seed, ff_share=0.05):
    """[n_seg, frames*1024] u32 words with a share of 0xFF bytes."""
    rng = np.random.default_rng(seed)
    by = rng.integers(0, 256, (n_seg, frames * 4096), dtype=np.uint8)
    by[rng.random(by.shape) < ff_share] = 0xFF
    return by.view(np.uint32).copy()


def set_stream_byte(words, seg, i, value):
    """Stream byte i of a segment (big-endian words) = value."""
    words.view(np.uint8)[seg, 4 * (i // 4) + 3 - i % 4] = value


def chunk_case(name):
    """(words [n_seg, F*1024] u32, seg_bits [n_seg], restart): one segment
    of several 4 KB chunks; segments with a byte count that is a whole
    chunk; 0xFF as the last valid byte of a chunk; byte counts that end
    inside a word, with a 0xFF just past the count (not counted)."""
    if name == "one_segment_3_chunks":
        return stuff_words(1, 4, 1), np.array([8 * (3 * 4096 + 700)]), 0
    if name == "several_segments":
        return (stuff_words(3, 2, 2, ff_share=0.3),
                np.array([8 * 5000 + 3, 8 * 4096, 8 * 10]), 5)
    if name == "ff_last_byte_of_chunk":
        w = stuff_words(2, 3, 3)
        for i in (4095, 2 * 4096 - 1, 2 * 4096 + 99):
            set_stream_byte(w, 0, i, 0xFF)
        set_stream_byte(w, 1, 4095, 0xFF)
        return w, np.array([8 * (2 * 4096 + 100), 8 * 4096]), 1
    if name == "ends_mid_word":
        w = stuff_words(2, 2, 4)
        set_stream_byte(w, 0, 4098, 0xFF)   # past the count: not counted
        return w, np.array([8 * 4098 - 5, 8 * 6 + 1]), 0
    raise KeyError(name)


CHUNK_CASES = ["one_segment_3_chunks", "several_segments",
               "ff_last_byte_of_chunk", "ends_mid_word"]


def _to_t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def lookback_model(words, bits, mnum, spi):
    """The kernel's chain in numpy: (aggregate [n_seg, f], exclusive prefix
    [n_seg, f], bounds [n_seg / spi + 1]) for u32 words [n_seg, W]. A tile
    holds clamp(nbytes - 4096c, 0, 4096) valid bytes; its aggregate adds
    their 0xFF bytes, and 2 on the segment's last data tile (tile 0 when
    it has no bytes) where mnum != 0."""
    n_seg, w = words.shape
    f = max(1, -(-w // 1024))
    by = np.zeros((n_seg, f * 4096), np.uint8)
    by[:, :4 * w] = words.astype(">u4").view(np.uint8).reshape(n_seg, -1)
    nbytes = np.minimum((np.asarray(bits, np.int64) + 7) >> 3, 4 * w)
    agg = np.zeros((n_seg, f), np.int64)
    for s in range(n_seg):
        last = max(1, -(-nbytes[s] // 4096)) - 1
        for c in range(f):
            valid = int(np.clip(nbytes[s] - 4096 * c, 0, 4096))
            tile = by[s, 4096 * c:4096 * c + valid]
            agg[s, c] = valid + int((tile == 0xFF).sum())
            agg[s, c] += 2 * int(c == last and mnum[s] != 0)
    flat = agg.reshape(-1)
    excl = (np.cumsum(flat) - flat).reshape(n_seg, f)
    bounds = np.append(excl[::spi, 0], flat.sum())
    return agg, excl, bounds


# 3840x2160: 4:2:0 MCU streams of 6 * 52 + 2 words, 4:4:4 of 3 * 52 + 2.
@pytest.mark.parametrize("n_seg,w,want", [
    (135, entropy_pack.segment_words(135, 240, 314), 9990),    # 4:2:0 rows
    (1, entropy_pack.segment_words(1, 32400, 314), 9872),      # restart 0
    (129600, entropy_pack.segment_words(129600, 1, 158), 129600),
    (4, 0, 4), (2, 1024, 2), (2, 1025, 4)])
def test_stuff_tiles_and_scratch(n_seg, w, want):
    """Tiles of the chain at the 4K main path, restart 0 and 4:4:4 restart
    1 (one tile a segment), and at edge widths."""
    assert compact.stuff_tiles(n_seg, w) == want
    assert compact.stuff_scratch_words(n_seg, w) == \
        compact.STUFF_SCRATCH_HEAD + want


def test_kernel_constants_match_the_wrappers():
    """csrc/stuff.cu's scratch head and tile size are the wrappers'."""
    src = (_build.CSRC / "stuff.cu").read_text()
    head = re.search(r"kScratchHead = (\d+)", src)
    assert int(head.group(1)) == compact.STUFF_SCRATCH_HEAD
    threads = int(re.search(r"kThreads = (\d+)", src).group(1))
    assert re.search(r"kTileWords = 4 \* kThreads", src)
    assert 4 * threads == compact.CHUNK_WORDS


@pytest.mark.parametrize("name", CHUNK_CASES)
@pytest.mark.parametrize("restart", [0, 1])
def test_lookback_prefix_is_the_chunk_offsets(name, restart):
    """The model's exclusive prefix on every tile that holds data (and on
    tile 0) is stuff_precompute_chunks's chunk_off; its last bound is both
    twins' total."""
    words, bits, _ = chunk_case(name)
    n_seg = words.shape[0]
    mnum = compact.marker_table(n_seg, restart)
    _, excl, bounds = lookback_model(words, bits, mnum.numpy(), n_seg)
    chunk_off, _, in_chunk, _, _, _, total = \
        compact.stuff_precompute_chunks(_to_t(words), torch.from_numpy(bits),
                                        mnum)
    data = (in_chunk.numpy() > 0)
    data[:, 0] = True
    np.testing.assert_array_equal(excl[data], chunk_off.numpy()[data])
    assert bounds[-1] == int(total)
    _, total_g, img_off = compact.compact_segments_stuffed_grouped_plain(
        _to_t(words), torch.from_numpy(bits), restart)
    assert bounds.tolist() == img_off.tolist() + [int(total_g)]


@pytest.mark.parametrize("spi", [1, 2, 6])
def test_lookback_bounds_with_images(spi):
    """Images of spi segments, zero-byte segments and whole-tile segments
    among them: the model's bounds are the grouped twin's img_off and
    total, and its tile-0 prefixes the twin's segment starts."""
    words = stuff_words(6, 2, 11, ff_share=0.2)
    bits = np.array([8 * 4096, 0, 8 * 5000 + 1, 0, 8 * 8192, 13])
    mnum = compact.marker_table(6, 1, spi)
    _, excl, bounds = lookback_model(words, bits, mnum.numpy(), spi)
    nbytes, _, seg_start, img_off, total = compact.stuff_precompute(
        _to_t(words), torch.from_numpy(bits), mnum, spi)
    np.testing.assert_array_equal(excl[:, 0], seg_start.numpy())
    assert bounds.tolist() == img_off.tolist() + [int(total)]


def test_no_segments_give_an_empty_scan():
    """Zero segments, with a marker table given: the chunk twin (what the
    wrapper runs on CPU tensors, and the GPU test's reference) gives a
    total of 0."""
    none = torch.zeros(0, dtype=torch.int32)
    _, total = compact.compact_segments_stuffed(
        torch.zeros((0, 5), dtype=torch.int32), none, 1, none)
    assert int(total) == 0
