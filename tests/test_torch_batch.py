"""Batches and host stuffing in the port against jpegtpu: the compaction
kernel's twin (K6) against jpegtpu's ``compact_segments`` in interpret
mode, the host stuffing against ``jpegtpu.native.stuff_assemble_contig``,
the per-image marker table, ``encode_batch`` against ``jpegtpu.encode_batch``
in every mode with ``device_stuff`` on and off, and once against jpegtpu's
own batch program (``_encode_batch_fused``) in interpret mode. Every output
is a byte or an integer, so every comparison is exact (tolerance 0). The
images are free of rounding ties (ROADMAP.md, faults 3.1 and 3.5)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpegtpu
import jpegtpu.config
import jpegtpu.encoder as jencoder
import jpegtpu.kernels.entropy_pack as jentropy_pack
import jpegtpu.native as jnative
import jpegtpu_torch
from jpegtpu.kernels import compact, fused_dctq
from jpegtpu_torch import EncoderTables, native
from jpegtpu_torch.encoder import device_encode, device_encode_batch
from jpegtpu_torch.kernels import compact as t_compact

MODES = ("420", "422", "444", "444s", "gray")
# Per mode, an integer restart interval that divides a 37x53 image's MCU
# count (4:2:0 12 MCUs, 4:2:2 20, the others 35); 4:2:2 and gray run more
# than 8 segments an image, so their RST numbers wrap within each image.
DIVIDING = {"420": 3, "422": 2, "444": 5, "444s": 5, "gray": 1}
QUALITY = 90
_REFS = {}
# jpegtpu's block pack and segment merge, jitted as test_torch_entropy.py
# (both) and test_torch_restart.py (the merge) jit them, with the same
# static arguments, so that in one process they share compiles.
_block_pack = jax.jit(jentropy_pack.block_pack_mcu_pairs,
                      static_argnums=(3, 4),
                      static_argnames=("n_luma", "merge_rot"))
_seg_merge = jax.jit(jentropy_pack.seg_merge_mcu, static_argnums=(2, 3, 4))


def _random(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _batch(mode, shape=(37, 53), seeds=(11, 22, 23)):
    """Three images (seeds checked free of ties at q90 in every mode)."""
    imgs = [_random(*shape, s) for s in seeds]
    if mode == "gray":
        imgs = [np.ascontiguousarray(im[..., 0]) for im in imgs]
    return imgs


def _jpegtpu_batch(mode, restart):
    """jpegtpu.encode_batch's files of _batch(mode), once per geometry. On
    the CPU jpegtpu encodes a batch image by image on its XLA path, which
    ignores ``device_stuff``; its batch program is held below."""
    if (mode, restart) not in _REFS:
        _REFS[mode, restart] = jpegtpu.encode_batch(
            _batch(mode), quality=QUALITY, subsampling=mode,
            restart_interval=restart)
    return _REFS[mode, restart]


def test_compact_twin_matches_jpegtpu_kernel(monkeypatch):
    """K6: segments of 0, 1, 7, 8, 33, 32768 (exactly one 4 KB chunk) and
    32776 bits (into a second chunk), so most start off a word boundary.
    jpegtpu's kernel ORs whole chunks into its window, so its input is
    zero past each segment's bytes, as the segment merge leaves it."""
    monkeypatch.setattr(jentropy_pack, "_interpret", lambda: True)
    bits = np.array([0, 1, 7, 8, 33, 32768, 32776], np.int32)
    nbytes = (bits + 7) // 8
    rng = np.random.default_rng(3)
    by = rng.integers(0, 256, (bits.size, 2 * 4096), dtype=np.uint8)
    by[np.arange(by.shape[1]) >= nbytes[:, None]] = 0
    # Stream byte i of a big-endian word row is memory byte i ^ 3.
    words = by[:, np.arange(by.shape[1]) ^ 3].copy().view(np.uint32)
    want = np.asarray(compact.compact_segments(
        jnp.asarray(words), jnp.asarray(bits), 2)).view(np.uint8)
    want = want[:nbytes.sum()]
    np.testing.assert_array_equal(want, np.concatenate(
        [row[:n] for row, n in zip(by, nbytes)]))
    for fn in (t_compact.compact_segments, t_compact.compact_segments_plain):
        buf, got_nbytes = fn(torch.from_numpy(words.view(np.int32)),
                             torch.from_numpy(bits))
        assert got_nbytes.dtype == torch.int64
        np.testing.assert_array_equal(got_nbytes.numpy(), nbytes)
        np.testing.assert_array_equal(buf[:nbytes.sum()].numpy(), want)


def _stream_of(words, bits):
    """The compacted stream by its definition: each segment's first
    ceil(bits / 8) big-endian bytes, back to back."""
    by = words.view(np.uint8).reshape(words.shape[0], -1, 4)[..., ::-1]
    by = by.reshape(words.shape[0], -1)
    return np.concatenate([row[:(int(n) + 7) // 8]
                           for row, n in zip(by, bits)])


# (segment words, bits a segment): the card tests' edge cases, on the CPU.
COMPACT_CASES = {
    "empty_segments": (300, [0, 8 * 7 + 3, 0, 0, 8 * 1200]),
    "chunk_boundary": (2 * 1024 + 5, [8 * 4096, 8 * 8192, 8 * 4095]),
    "many_chunks": (9 * 1024 + 300, [8 * (9 * 4096 + 1000) - 5]),
    "one_byte_segments": (2, [1 + i % 8 for i in range(4096)]),
    "all_empty": (16, [0, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compact_twin_edges(case):
    w, bits = COMPACT_CASES[case]
    rng = np.random.default_rng(len(bits))
    words = rng.integers(0, 2**32, (len(bits), w), dtype=np.uint64)
    words = words.astype(np.uint32)
    want = _stream_of(words, bits)
    buf, nbytes = t_compact.compact_segments(
        torch.from_numpy(words.view(np.int32)), torch.tensor(bits))
    assert int(nbytes.sum()) == want.size
    assert buf.numel() == 4 * words.size
    np.testing.assert_array_equal(buf[:want.size].numpy(), want)


def _dense_ff_stream(nbytes, seed):
    """Segment bytes, 40% of them 0xFF, every segment ending in 0xFF."""
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 256, int(nbytes.sum()), dtype=np.uint8)
    stream[rng.random(stream.size) < 0.4] = 0xFF
    ends = np.cumsum(nbytes)[nbytes > 0] - 1
    stream[ends] = 0xFF
    return stream


# Segment byte counts: ten segments (markers wrap past 0xD7), one empty;
# one segment; an empty last segment; segments of one byte each.
STUFF_LAYOUTS = {"ten": [5, 1, 0, 300, 2, 17, 1, 1, 9, 4], "one": [700],
                 "empty_last": [3, 9, 0], "one_byte": [1] * 12}


@pytest.mark.parametrize("restart", [0, 1, 7])
@pytest.mark.parametrize("layout", sorted(STUFF_LAYOUTS))
def test_stuff_assemble_contig_matches_jpegtpu(layout, restart):
    """Streams dense in 0xFF, every segment ending in one."""
    nbytes = np.array(STUFF_LAYOUTS[layout], np.int32)
    stream = _dense_ff_stream(nbytes, restart)
    want = jnative.stuff_assemble_contig(stream, nbytes, restart)
    got = native.stuff_assemble_contig(stream, nbytes, restart)
    assert isinstance(got, bytes) and got == want
    n_ff = int(np.count_nonzero(stream == 0xFF))
    n_rst = (nbytes.size - 1) * (restart > 0)
    assert len(got) == nbytes.sum() + n_ff + 2 * n_rst


@pytest.mark.parametrize("n_seg,restart,spi", [
    (24, 5, 12), (24, 5, 1), (24, 5, 3), (9, 0, 3), (20, 1, None)])
def test_marker_table_per_image(n_seg, restart, spi):
    """jpegtpu's table (compact.py:942-947): numbered within each image of
    spi segments, none after an image's last segment."""
    within = np.arange(n_seg) % (spi or n_seg)
    want = np.where((restart > 0) & (within != (spi or n_seg) - 1),
                    0xD0 + within % 8, 0)
    got = t_compact.marker_table(n_seg, restart, spi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_marker_table_rejects_partial_images():
    with pytest.raises(ValueError, match="whole images"):
        t_compact.marker_table(10, 1, 3)


@pytest.mark.parametrize("device_stuff", [True, False])
@pytest.mark.parametrize("restart", ["rows", "dividing"])
@pytest.mark.parametrize("mode", MODES)
def test_encode_batch_matches_jpegtpu(mode, restart, device_stuff):
    """One batch program (no fallback warning) giving jpegtpu's files."""
    restart = DIVIDING[mode] if restart == "dividing" else restart
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = jpegtpu_torch.encode_batch(
            _batch(mode), quality=QUALITY, subsampling=mode,
            restart_interval=restart, device_stuff=device_stuff,
            device="cpu")
    assert got == _jpegtpu_batch(mode, restart)


@pytest.mark.parametrize("mode,restart", [(m, "rows") for m in MODES] +
                         [("420", 0), ("422", 3)])
def test_single_image_without_device_stuff_matches_jpegtpu(mode, restart):
    """The compaction kernel's twin and the host stuffing, for one image:
    several segments, one segment (restart 0), a ragged last segment."""
    img = _batch(mode)[0]
    got = jpegtpu_torch.encode(img, QUALITY, mode, restart, device="cpu",
                               device_stuff=False)
    assert got == jpegtpu.encode(img, QUALITY, mode, restart)


@pytest.mark.parametrize("mode,restart", [("420", 0), ("422", 3)])
def test_encode_batch_geometry_falls_back_with_warning(mode, restart):
    """Restart 0, or an interval that does not divide each image's MCU
    count (4:2:2's 20 MCUs by 3), cannot be one program: a warning, then
    jpegtpu's files, image by image."""
    with pytest.warns(RuntimeWarning, match="per-image"):
        got = jpegtpu_torch.encode_batch(
            _batch(mode), quality=QUALITY, subsampling=mode,
            restart_interval=restart, device="cpu")
    assert got == _jpegtpu_batch(mode, restart)


@pytest.mark.parametrize("restart", [0, 5])
def test_device_encode_batch_refuses_other_geometry(restart):
    """The batch program itself refuses restart 0 and an interval that
    does not divide the MCU count (4:2:0 37x53: 12 MCUs)."""
    tables = EncoderTables.for_quality(QUALITY)
    x = torch.from_numpy(np.stack(_batch("420")))
    with pytest.raises(jpegtpu_torch.BatchGeometryError):
        device_encode_batch(x, tables, "420", restart)


@pytest.mark.parametrize("device_stuff", [True, False])
def test_device_encode_batch_splits_per_image(device_stuff):
    """The batch program's per-image split: each image's first byte (with
    device_stuff), or its segments' byte counts (without), give each
    image's own scan."""
    tables = EncoderTables.for_quality(QUALITY)
    imgs = _batch("420")
    singles = [device_encode(torch.from_numpy(im), tables, "420", 4,
                             device_stuff) for im in imgs]
    out = device_encode_batch(torch.from_numpy(np.stack(imgs)), tables,
                              "420", 4, device_stuff)
    if device_stuff:
        buf, total, img_off = out
        sizes = [int(t) for _, t in singles]
        assert img_off.tolist() == np.cumsum([0] + sizes[:-1]).tolist()
        assert int(total) == sum(sizes)
        for (b, t), off in zip(singles, img_off.tolist()):
            assert torch.equal(buf[off:off + int(t)], b[:int(t)])
    else:
        buf, nbytes = out
        assert nbytes.shape == (3, 3)
        for i, (_, nb) in enumerate(singles):
            assert torch.equal(nbytes[i], nb)


def test_encode_batch_of_one_and_of_none():
    img = _batch("420")[0]
    assert jpegtpu_torch.encode_batch([], device="cpu") == []
    assert jpegtpu_torch.encode_batch([img], quality=QUALITY,
                                      device="cpu") == [
        jpegtpu_torch.encode(img, QUALITY, device="cpu")]


def test_encode_batch_mixed_shapes_match_jpegtpu():
    imgs = [_random(37, 53, 11), _random(16, 40, 13), _random(37, 53, 22)]
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = jpegtpu_torch.encode_batch(imgs, quality=QUALITY,
                                         device="cpu")
    assert got == jpegtpu.encode_batch(imgs, quality=QUALITY)


def test_encode_batch_gray_takes_a_channel_axis():
    imgs = _batch("gray")
    want = jpegtpu_torch.encode_batch(imgs, quality=QUALITY,
                                      subsampling="gray", device="cpu")
    assert jpegtpu_torch.encode_batch(
        [im[..., None] for im in imgs], quality=QUALITY, subsampling="gray",
        device="cpu") == want


def test_encode_batch_config_and_keywords_raise():
    cfg = jpegtpu_torch.EncoderConfig(quality=QUALITY)
    with pytest.raises(TypeError):
        jpegtpu_torch.encode_batch(_batch("420"), cfg, device="cpu",
                                   quality=50)
    with pytest.raises(TypeError):
        jpegtpu.encode_batch(_batch("420"), jpegtpu.config.EncoderConfig(),
                             quality=50)
    assert (jpegtpu_torch.encode_batch(_batch("420"), cfg, device="cpu") ==
            _jpegtpu_batch("420", "rows"))


def test_encode_batch_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        jpegtpu_torch.encode_batch(_batch("420"), device=None)


@pytest.fixture(scope="module")
def batch_program_ref():
    """jpegtpu's batch program (_encode_batch_fused, its Pallas kernels in
    interpret mode) with device_stuff on (the single-chain stuffing kernel
    with per-image markers) and off (compact_segments, then the host
    stuffing), over two 32x128 images: the two MCU-row halves of
    test_torch_pixel.py's 64x128 image (checked free of ties against
    jpegtpu's pixel kernel), two segments of 8 MCUs each, so each file has
    one RST marker, RST0.

    Interpret time is almost all JAX lowering and compiling the kernels, so
    the program runs op by op around jitted kernel drivers (jit changes no
    value): the two programs share those compiles, and, in one process,
    with test_torch_entropy.py's pallas_ref, which calls the block pack and
    the merge on the same shapes. One stuffing chain, one chunk a step:
    jpegtpu's chains and chunks a step change no byte."""
    img = _random(64, 128, 3)
    imgs = np.stack([img[:32], img[32:]])
    orig = jencoder._jitted_encode_batch
    mp = pytest.MonkeyPatch()
    mp.setattr(jentropy_pack, "_interpret", lambda: True)
    mp.setattr(fused_dctq, "_interpret", lambda: True)
    mp.setattr(jentropy_pack, "block_pack_mcu_pairs", _block_pack)
    mp.setattr(jentropy_pack, "seg_merge_mcu", _seg_merge)
    mp.setattr(fused_dctq, "encode_blocks_pallas_nat_pairs", jax.jit(
        fused_dctq.encode_blocks_pallas_nat_pairs, static_argnums=(1, 2),
        static_argnames=("with_dc",)))

    def unjitted(*args):
        fn, *rest = orig(*args)
        return (fn.__wrapped__, *rest)

    mp.setattr(jencoder, "_jitted_encode_batch", unjitted)
    try:
        out = {ds: jencoder._encode_batch_fused(
            imgs, jpegtpu.config.EncoderConfig(
                quality=QUALITY, device_stuff=ds, compact_groups=1,
                compact_kb=1))
            for ds in (True, False)}
    finally:
        mp.undo()
        jencoder._jitted_encode_batch.cache_clear()
    return imgs, out


@pytest.mark.parametrize("device_stuff", [True, False])
def test_encode_batch_matches_jpegtpu_batch_program(batch_program_ref,
                                                    device_stuff):
    imgs, want = batch_program_ref
    got = jpegtpu_torch.encode_batch(list(imgs), quality=QUALITY,
                                     device_stuff=device_stuff, device="cpu")
    assert got == want[device_stuff]
    # Two segments an image: each file has one RST marker, RST0.
    for f in got:
        assert f.count(b"\xff\xd0") == 1 and f.count(b"\xff\xd1") == 0
