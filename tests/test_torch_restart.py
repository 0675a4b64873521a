"""Restart intervals in the port against jpegtpu: the chunk tables of the
single-chain stuffing kernel (K5), its plain twin against jpegtpu's
``compact_segments_stuffed`` in interpret mode, the zero-length pad MCUs of
a ragged last segment, the 2^31-bit guard, and whole files at restart
"rows", 0 and ragged intervals. Every output is an integer or a byte, so
every comparison is exact (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpegtpu
import jpegtpu.config
from jpegtpu import encoder as jencoder
from jpegtpu.entropy import assemble, scan
from jpegtpu.kernels import compact, entropy_pack, fused_dctq
from jpegtpu_torch import EncoderConfig
from jpegtpu_torch import encode as t_encode
from jpegtpu_torch.encoder import geometry
from jpegtpu_torch.kernels import compact as t_compact
from jpegtpu_torch.kernels import entropy_pack as t_entropy_pack

_stuff_precompute = jax.jit(compact._stuff_precompute, static_argnums=(2,))
_block_symbols = jax.jit(scan.block_symbols)
_pack_words = jax.jit(assemble.pack_words, static_argnums=(2, 3))


def _random(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _words(n_seg, frames, seed, ff_share=0.05):
    """[n_seg, frames*1024] u32 words with a share of 0xFF bytes."""
    rng = np.random.default_rng(seed)
    by = rng.integers(0, 256, (n_seg, frames * 4096), dtype=np.uint8)
    by[rng.random(by.shape) < ff_share] = 0xFF
    return by.view(np.uint32).copy()


def _set_stream_byte(words, seg, i, value):
    """Stream byte i of a segment (big-endian words) = value."""
    words.view(np.uint8)[seg, 4 * (i // 4) + 3 - i % 4] = value


def _to_t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _mnum(n_seg, restart):
    """jpegtpu's default marker table (compact.py:942-947)."""
    within = np.arange(n_seg) % n_seg
    return np.where((restart > 0) & (within != n_seg - 1),
                    0xD0 + within % 8, 0).astype(np.int32)


def _chunk_case(name):
    """(words [n_seg, F*1024] u32, seg_bits [n_seg], restart)."""
    if name == "one_segment_3_chunks":
        return _words(1, 4, 1), np.array([8 * (3 * 4096 + 700)]), 0
    if name == "several_segments":
        return (_words(3, 2, 2, ff_share=0.3),
                np.array([8 * 5000 + 3, 8 * 4096, 8 * 10]), 5)
    if name == "ff_last_byte_of_chunk":
        w = _words(2, 3, 3)
        for i in (4095, 2 * 4096 - 1, 2 * 4096 + 99):
            _set_stream_byte(w, 0, i, 0xFF)
        _set_stream_byte(w, 1, 4095, 0xFF)
        return w, np.array([8 * (2 * 4096 + 100), 8 * 4096]), 1
    if name == "ends_mid_word":
        w = _words(2, 2, 4)
        _set_stream_byte(w, 0, 4098, 0xFF)   # past the count: not counted
        return w, np.array([8 * 4098 - 5, 8 * 6 + 1]), 0
    raise KeyError(name)


CHUNK_CASES = ["one_segment_3_chunks", "several_segments",
               "ff_last_byte_of_chunk", "ends_mid_word"]


@pytest.mark.parametrize("name", CHUNK_CASES)
def test_stuff_precompute_chunks_matches_jpegtpu(name):
    words, bits, restart = _chunk_case(name)
    n_seg, n_words = words.shape
    mnum = _mnum(n_seg, restart)
    want = _stuff_precompute(jnp.asarray(words), jnp.asarray(bits, jnp.int32),
                             n_words // 1024, jnp.asarray(mnum))
    got = t_compact.stuff_precompute_chunks(
        _to_t(words), torch.from_numpy(bits), torch.from_numpy(mnum))
    assert len(got) == len(want) == 7
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_chunk_tables_with_words_not_a_whole_chunk():
    """A segment buffer of W words that is not a multiple of 1024 has
    ceil(W/1024) chunks, the same tables as the zero-padded buffer."""
    words, bits, restart = _chunk_case("several_segments")
    cut = words[:, :1024 + 300]
    bits = np.minimum(bits, 32 * cut.shape[1])
    mnum = torch.from_numpy(_mnum(3, restart))
    got = t_compact.stuff_precompute_chunks(_to_t(cut),
                                            torch.from_numpy(bits), mnum)
    padded = np.concatenate([cut, np.zeros((3, 1024 - 300), np.uint32)], 1)
    want = t_compact.stuff_precompute_chunks(_to_t(padded),
                                             torch.from_numpy(bits), mnum)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_marker_table():
    m = t_compact.marker_table(10, 3)
    assert m.dtype == torch.int32
    assert m.tolist() == [0xD0, 0xD1, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7,
                          0xD0, 0]
    np.testing.assert_array_equal(m.numpy(), _mnum(10, 3))
    assert t_compact.marker_table(4, 0).tolist() == [0, 0, 0, 0]
    # One segment (an interval >= the MCU count) has no marker after it.
    assert t_compact.marker_table(1, 5).tolist() == [0]


@pytest.fixture(scope="module")
def k5_ref():
    """jpegtpu's single-chain stuffing kernel (_compact_stuff_kernel_kb,
    k_chunks=3 as the encoder calls it) in interpret mode, on one segment
    of 4 chunks with 0xFF bytes at chunk edges and a byte count that ends
    inside a word."""
    words = _words(1, 5, 7)
    for i in (4095, 2 * 4096 - 1, 3 * 4096):
        _set_stream_byte(words, 0, i, 0xFF)
    bits = np.array([8 * (3 * 4096 + 1234) - 3], np.int32)
    stream, _, total = compact.compact_segments_stuffed(
        jnp.asarray(words), jnp.asarray(bits), 5, 0, k_chunks=3)
    scan_bytes = np.asarray(stream).view(np.uint8)[:int(total)].tobytes()
    return words, bits, scan_bytes


def test_chunk_stuffing_twin_matches_jpegtpu_kernel(k5_ref):
    words, bits, want = k5_ref
    for fn in (t_compact.compact_segments_stuffed,
               t_compact.compact_segments_stuffed_plain):
        buf, total = fn(_to_t(words), torch.from_numpy(bits), 0)
        assert int(total) == len(want)
        assert buf[:int(total)].numpy().tobytes() == want


@pytest.mark.parametrize("name", CHUNK_CASES)
@pytest.mark.parametrize("restart", [0, 1])
def test_chunk_twin_matches_segment_twin(name, restart):
    """The chunk formulation (K5's twin) and the per-segment formulation
    (K4's twin) give the same scan for any segments."""
    words, bits, _ = _chunk_case(name)
    a, ta = t_compact.compact_segments_stuffed_plain(
        _to_t(words), torch.from_numpy(bits), restart)
    b, tb = t_compact.compact_segments_stuffed_grouped_plain(
        _to_t(words), torch.from_numpy(bits), restart)
    assert int(ta) == int(tb)
    assert torch.equal(a[:int(ta)], b[:int(tb)])


@pytest.fixture(scope="module")
def ragged_ref():
    """jpegtpu's own ragged path (encoder.py:266-275): MCU streams of a
    37x53 4:2:0 image (12 MCUs) in segments of 5, with 3 zero-length pad
    MCUs appended, merged by jpegtpu's seg_merge_mcu in interpret mode."""
    img = _random(37, 53, 11)
    coeffs = np.asarray(fused_dctq.encode_blocks_pairs(jnp.asarray(img), 90,
                                                       "420"))
    n_mcu, restart = coeffs.shape[0], 5
    n_seg, mps = -(-n_mcu // restart), restart
    dcd = np.asarray(scan.dc_diffs_from_dc(jnp.asarray(coeffs[:, ::64]), 4,
                                           restart)).reshape(-1)
    cls = (np.arange(n_mcu * 6) % 6 >= 4).astype(np.int32)
    lens, sym = _block_symbols(coeffs.reshape(-1, 64), cls, dcd)
    words, mlens = _pack_words(lens, sym, n_mcu, 6)
    chunks = -(-words.shape[1] // 128)
    mw = np.zeros((n_seg * mps, chunks * 128), np.uint32)
    mw[:n_mcu, :words.shape[1]] = np.asarray(words)
    ml = np.zeros(n_seg * mps, np.int32)
    ml[:n_mcu] = np.asarray(mlens)
    w_cap = -(-mps * 6 * assemble.MAX_BITS_PER_BLOCK // 32)
    sw, sb, _ = entropy_pack.seg_merge_mcu(jnp.asarray(mw), jnp.asarray(ml),
                                           n_seg, mps, w_cap)
    return dict(mw=mw[:n_mcu], ml=ml[:n_mcu], n_seg=n_seg, mps=mps,
                sw=np.asarray(sw), sb=np.asarray(sb))


def test_ragged_pad_matches_jpegtpu_seg_merge(ragged_ref):
    r = ragged_ref
    mw, ml = t_entropy_pack.pad_segments(_to_t(r["mw"]),
                                         torch.from_numpy(r["ml"]),
                                         r["n_seg"], r["mps"])
    assert mw.shape[0] == r["n_seg"] * r["mps"] and int(ml[-1]) == 0
    sw, sb = t_entropy_pack.seg_merge_mcu(mw, ml, r["n_seg"], r["mps"])
    np.testing.assert_array_equal(sb.numpy(), r["sb"])
    assert int(r["sb"][-1]) % 8, "the last segment must end inside a byte"
    for s, n in enumerate(r["sb"].astype(np.int64)):
        nw = -(-int(n) // 32)          # through the 1-padded last byte
        np.testing.assert_array_equal(sw[s, :nw].numpy().view(np.uint32),
                                      r["sw"][s, :nw], err_msg=f"seg {s}")


def test_pad_segments_rejects_wrong_counts():
    mw = torch.zeros((7, 10), dtype=torch.int32)
    ml = torch.zeros(7, dtype=torch.int32)
    assert t_entropy_pack.pad_segments(mw, ml, 7, 1)[0] is mw
    for n_seg, mps in ((2, 3), (3, 2)):       # too few / a whole pad segment
        with pytest.raises(ValueError):
            t_entropy_pack.pad_segments(mw, ml, n_seg, mps)


@pytest.mark.parametrize("n_seg,mps,want", [
    (1, 3, 1024), (1, 400, 122 * 1024), (4, 3, 3 * 312 + 2),
    (32400, 1, 314)])
def test_segment_words_rounds_only_a_single_segment(n_seg, mps, want):
    """The one segment that the chunk kernel stuffs is whole 4 KB chunks;
    several segments keep their worst-case width (4:2:0 MCUs of 314
    words), so a small interval's buffer stays small."""
    assert t_entropy_pack.segment_words(n_seg, mps, 314) == want
    mw = torch.zeros((n_seg * mps, 314), dtype=torch.int32)
    if n_seg * mps <= 400:
        sw, _ = t_entropy_pack.seg_merge_mcu(mw, torch.zeros(n_seg * mps),
                                             n_seg, mps)
        assert sw.shape == (n_seg, want)


def test_segment_offsets_raise_at_2_31_bits():
    ok = torch.tensor([(1 << 30), (1 << 30) - 1, 5, 7], dtype=torch.int32)
    off, seg_bits = t_entropy_pack.segment_offsets(ok, 2, 2)
    assert seg_bits.tolist() == [(1 << 31) - 1, 12]
    assert off.tolist() == [0, 1 << 30, 0, 5]
    bad = torch.tensor([1 << 30, 1 << 30, 5, 7], dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        t_entropy_pack.segment_offsets(bad, 2, 2)
    with pytest.raises(ValueError, match="2\\^31"):
        t_entropy_pack.segment_offsets(bad, 1, 4, mcu_bits_cap=1 << 30)


@pytest.mark.parametrize("restart", ["rows", 0, 1, 3, 7, 13, 40, 1000])
@pytest.mark.parametrize("shape", [(37, 53), (16, 40), (120, 200)])
def test_geometry_matches_jpegtpu(shape, restart):
    cfg = jpegtpu.config.EncoderConfig(restart_interval=restart)
    r, n_seg, mps = jencoder._geometry(shape, cfg)
    my, mx = jencoder.ops.mcu_grid(*shape, "420")
    t_r = EncoderConfig(restart_interval=restart).resolve_restart(mx)
    t_n_seg, t_mps = geometry(my * mx, t_r)
    assert (t_r, t_n_seg) == (r, n_seg)
    # An interval longer than the image is one segment of all its MCUs.
    assert t_mps == min(mps, my * mx)


def _rst_count(jpg):
    sos = jpg.find(b"\xff\xda")
    body = np.frombuffer(jpg[sos + 2 + int.from_bytes(jpg[sos + 2:sos + 4],
                                                       "big"):-2], np.uint8)
    nxt = body[np.flatnonzero(body[:-1] == 0xFF) + 1]
    return int(np.count_nonzero((nxt >= 0xD0) & (nxt <= 0xD7)))


# (image, quality, restart): no markers, ragged intervals (the last
# segment shorter), an interval longer than the image, one MCU row.
ENCODE_CASES = [
    ("smooth", 90, 7), ("random_120x200", 50, 11), ("odd_37x53", 90, 0),
    ("odd_37x53", 50, 5), ("odd_37x53", 90, 100), ("one_row_16x40", 90, 0),
    ("one_row_16x40", 50, 2),
]


@pytest.mark.parametrize("name,q,restart", ENCODE_CASES)
def test_420_restart_matches_jpegtpu(smooth_img, name, q, restart):
    img = {"smooth": smooth_img, "random_120x200": _random(120, 200, 7),
           "odd_37x53": _random(37, 53, 11),
           "one_row_16x40": _random(16, 40, 13)}[name]
    want = jpegtpu.encode(img, quality=q, subsampling="420",
                          restart_interval=restart)
    got = t_encode(img, quality=q, subsampling="420",
                   restart_interval=restart, device="cpu")
    assert got == want
    n_mcu = -(-img.shape[0] // 16) * -(-img.shape[1] // 16)
    n_seg = -(-n_mcu // restart) if restart else 1
    assert _rst_count(got) == n_seg - 1
