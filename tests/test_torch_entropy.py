"""The port's entropy stages against jpegtpu's, each fed jpegtpu's own
coefficients so that no pixel rounding can hide an entropy fault: DC
differences, each MCU's bitstream, each segment's bitstream and the
stuffed scan, bit-exact. The TPU kernels run in interpret mode once, in
one module-scoped fixture; the dense (q=100) and sparse (ZRL/EOB) cases
are checked against jpegtpu's XLA oracle formulation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu.entropy import assemble, scan
from jpegtpu.entropy import huffman_tables as ht
from jpegtpu.kernels import compact, entropy_pack, fused_dctq
from jpegtpu_torch.entropy import scan as t_scan
from jpegtpu_torch.kernels import compact as t_compact
from jpegtpu_torch.kernels import entropy_pack as t_entropy_pack

LUTS = tuple(torch.from_numpy(a.astype(np.int32)) for a in ht.packed_luts())

# jpegtpu's oracle functions, each compiled once (eager op-by-op dispatch
# costs seconds per new shape on the CPU).
_dc_diffs = jax.jit(scan.dc_diffs_from_dc, static_argnums=(1, 2))
_block_symbols = jax.jit(scan.block_symbols)
_pack_words = jax.jit(assemble.pack_words, static_argnums=(2, 3))
# jpegtpu's block pack and segment merge, jitted as test_torch_batch.py
# and test_torch_restart.py jit them: their batch program and ragged
# fixture call them on pallas_ref's shapes, so in one process they share
# the interpret-mode compiles, the costly part of such a run.
_block_pack = jax.jit(entropy_pack.block_pack_mcu_pairs,
                      static_argnums=(3, 4),
                      static_argnames=("n_luma", "merge_rot"))
_seg_merge = jax.jit(entropy_pack.seg_merge_mcu, static_argnums=(2, 3, 4))


@jax.jit
def _oracle_segments(coeffs):
    """symbolize_scan + pack_segments for 4 rows of 8 MCUs."""
    lens, bits = scan.symbolize_scan(coeffs.reshape(32, 6, 64), 4, 8)
    return assemble.pack_segments(lens.reshape(-1, 64),
                                  bits.reshape(-1, 64), 4, 8 * 6)


def _u32_to_t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32))
                            .view(np.int32))


def _t_to_u32(t):
    return t.numpy().view(np.uint32)


def _assert_first_bits_equal(got, want, nbits, what):
    """Rows of u32 words agree on their first nbits[i] bits."""
    for i, n in enumerate(np.asarray(nbits, np.int64)):
        full, tail = divmod(int(n), 32)
        np.testing.assert_array_equal(got[i, :full], want[i, :full],
                                      err_msg=f"{what} {i}")
        if tail:
            mask = np.uint32((0xFFFFFFFF << (32 - tail)) & 0xFFFFFFFF)
            assert got[i, full] & mask == want[i, full] & mask, f"{what} {i}"


def _image_coeffs(h, w, q, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                               dtype=np.uint8)
    return np.array(fused_dctq.encode_blocks_pairs(jnp.asarray(img), q,
                                                    "420"))


def _sparse_coeffs(n_mcu, seed):
    """Mostly-zero blocks with a few far-apart AC values: long zero runs
    (ZRL) and trailing zeros (EOB)."""
    rng = np.random.default_rng(seed)
    c = np.zeros((n_mcu * 6, 64), np.int32)
    c[:, 0] = rng.integers(-300, 300, n_mcu * 6)
    for row in c:
        for k in rng.choice(np.arange(1, 64), rng.integers(0, 4),
                            replace=False):
            row[k] = rng.integers(1, 200) * rng.choice([-1, 1])
    c[::7, 63] = 5                       # last slot nonzero: no EOB
    return c.reshape(n_mcu, 384)


# (coefficients [nM, 384], restart = MCUs per row). One geometry for all
# cases (64x128: 4 rows of 8 MCUs), so jpegtpu's oracle ops compile once.
CASES = {
    "random_q90": lambda: (_image_coeffs(64, 128, 90, 1), 8),
    "dense_q100": lambda: (_image_coeffs(64, 128, 100, 2), 8),
    "sparse": lambda: (_sparse_coeffs(32, 3), 8),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return CASES[request.param]()


def _dc_and_cls(coeffs, restart):
    n_mcu = coeffs.shape[0]
    dcd = _dc_diffs(jnp.asarray(coeffs[:, ::64]), 4, restart).reshape(-1)
    cls = (np.arange(n_mcu * 6) % 6 >= 4).astype(np.int32)
    return np.array(dcd), cls


def _port_mcu_streams(coeffs, cls, dcd):
    return t_entropy_pack.block_pack_mcu_pairs(
        torch.from_numpy(coeffs), torch.from_numpy(cls),
        torch.from_numpy(dcd), *LUTS)


@pytest.fixture(scope="module")
def pallas_ref():
    """jpegtpu's main-path entropy kernels in interpret mode at 64x128 (4
    segments of 8 MCUs), as the encoder calls them, except that the
    stuffing runs 2 chains of 2 segments and one 4 KB chunk a step (the
    encoder's min(8, n_seg) chains would be 4 of 1 and its kb 3 chunks a
    step; interpret time grows with both, they change no byte, and 2
    chains of 2 also splice a marker inside a chain)."""
    coeffs = _image_coeffs(64, 128, 90, 1)
    restart, n_seg = 8, 4
    dcd, cls = _dc_and_cls(coeffs, restart)
    chunks, _ = entropy_pack.mcu_capacity(6, 384)
    mw, ml = _block_pack(jnp.asarray(coeffs), jnp.asarray(cls),
                         jnp.asarray(dcd), 6, chunks, n_luma=4,
                         merge_rot=False)
    w_cap = -(-restart * 6 * 384 // 32)
    sw, sb, _ = _seg_merge(mw, ml, n_seg, restart, w_cap)
    frames = sw.shape[1] // 1024
    st2, glens, _, total = compact.compact_segments_stuffed_grouped(
        sw, sb, frames, restart, 2, k_chunks=1)
    glens = np.asarray(glens)
    scan_bytes = b"".join(np.asarray(st2[g]).view(np.uint8)[:glens[g]]
                          .tobytes() for g in range(len(glens)))
    assert len(scan_bytes) == int(total)
    return dict(coeffs=coeffs, restart=restart, n_seg=n_seg, dcd=dcd,
                cls=cls, mw=np.array(mw), ml=np.array(ml),
                sw=np.array(sw), sb=np.array(sb), scan=scan_bytes)


@pytest.mark.parametrize("restart", [None, 1, 0])
def test_dc_diffs_match(case, restart):
    coeffs, rows = case
    restart = rows if restart is None else restart
    want = _dc_diffs(jnp.asarray(coeffs[:, ::64]), 4, restart)
    got = t_scan.dc_diffs_from_dc(torch.from_numpy(coeffs[:, ::64]), 4,
                                  restart)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block_symbols_match(case):
    coeffs, restart = case
    dcd, cls = _dc_and_cls(coeffs, restart)
    blocks = coeffs.reshape(-1, 64)
    want_l, want_b = _block_symbols(blocks, cls, dcd)
    got_l, got_b = t_scan.block_symbols(torch.from_numpy(blocks),
                                        torch.from_numpy(cls),
                                        torch.from_numpy(dcd), *LUTS)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def test_sparse_case_emits_zrl_and_eob():
    coeffs, restart = CASES["sparse"]()
    dcd, cls = _dc_and_cls(coeffs, restart)
    lens, bits = t_scan.block_symbols(torch.from_numpy(coeffs.reshape(-1, 64)),
                                      torch.from_numpy(cls),
                                      torch.from_numpy(dcd), *LUTS)
    c = torch.from_numpy(coeffs.reshape(-1, 64))
    zero_slot = (lens[:, 1:] > 0) & (c[:, 1:] == 0)   # ZRL or EOB symbols
    luma_zrl = (bits[:, 1:] == 0x7F9) & (lens[:, 1:] == 11)
    assert bool((zero_slot & luma_zrl).any())         # ZRL, luma code
    assert bool((zero_slot & ~luma_zrl).any())        # EOB (and more)


def test_mcu_streams_match_pallas_block_pack(pallas_ref):
    r = pallas_ref
    mw, ml = _port_mcu_streams(r["coeffs"], r["cls"], r["dcd"])
    np.testing.assert_array_equal(ml.numpy(), r["ml"])
    _assert_first_bits_equal(_t_to_u32(mw), r["mw"], r["ml"], "MCU")


def test_mcu_streams_match_oracle_pack(case):
    """Each MCU's stream = jpegtpu's oracle pack of its 6 blocks' symbols
    as one segment; the port's stream is zero past its length."""
    coeffs, restart = case
    dcd, cls = _dc_and_cls(coeffs, restart)
    lens, bits = _block_symbols(coeffs.reshape(-1, 64), cls, dcd)
    want_w, want_bits = _pack_words(lens, bits, coeffs.shape[0], 6)
    mw, ml = _port_mcu_streams(coeffs, cls, dcd)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(want_bits))
    got = _t_to_u32(mw)
    _assert_first_bits_equal(got, np.asarray(want_w), ml.numpy(), "MCU")
    j = np.arange(got.shape[1])[None, :]
    assert not got[j * 32 >= ml.numpy()[:, None]].any()


def test_segments_match_pallas_seg_merge(pallas_ref):
    """Fed jpegtpu's MCU streams: the same seg_bits, and the same bytes
    through the 1-padded last one."""
    r = pallas_ref
    sw, sb = t_entropy_pack.seg_merge_mcu(_u32_to_t(r["mw"]),
                                          torch.from_numpy(r["ml"]),
                                          r["n_seg"], r["restart"])
    np.testing.assert_array_equal(sb.numpy(), r["sb"])
    padded = (r["sb"].astype(np.int64) + 7) // 8 * 8
    _assert_first_bits_equal(_t_to_u32(sw), r["sw"], padded, "segment")


def test_scan_matches_grouped_compaction(pallas_ref):
    """Fed jpegtpu's segments: the bytes of the stitched grouped stuffing
    kernel's output."""
    r = pallas_ref
    buf, total, img_off = t_compact.compact_segments_stuffed_grouped(
        _u32_to_t(r["sw"]), torch.from_numpy(r["sb"]), r["restart"])
    assert img_off.tolist() == [0]
    assert int(total) == len(r["scan"])
    assert buf[:int(total)].numpy().tobytes() == r["scan"]


def test_scan_matches_oracle_assembly(case):
    """The port's three entropy stages end to end = jpegtpu's
    symbolize_scan + pack_segments + assemble_scan_host."""
    coeffs, restart = case
    n_seg = coeffs.shape[0] // restart
    stuffed, nbytes, _ = _oracle_segments(coeffs)
    want = assemble.assemble_scan_host(np.asarray(stuffed),
                                       np.asarray(nbytes), restart)
    dcd, cls = _dc_and_cls(coeffs, restart)
    mw, ml = _port_mcu_streams(coeffs, cls, dcd)
    sw, sb = t_entropy_pack.seg_merge_mcu(mw, ml, n_seg, restart)
    buf, total, _ = t_compact.compact_segments_stuffed_grouped(sw, sb,
                                                               restart)
    assert buf[:int(total)].numpy().tobytes() == want
    assert want.count(b"\xff\xd0") >= 1


def test_stuff_precompute_counts():
    """0xFF bytes past a segment's byte count are not counted; the last
    segment gets no marker; each image starts at its first segment."""
    words = torch.tensor([[-1, -1], [0x00FF00FF, -1]], dtype=torch.int32)
    bits = torch.tensor([36, 17])
    nbytes, ffc, start, img_off, total = t_compact.stuff_precompute(
        words, bits, t_compact.marker_table(2, 1))
    assert nbytes.tolist() == [5, 3]
    assert ffc.tolist() == [5, 1]
    assert start.tolist() == [0, 12] and int(total) == 16
    assert img_off.tolist() == [0]
    # Two one-segment images: no marker between them.
    _, _, start, img_off, total = t_compact.stuff_precompute(
        words, bits, t_compact.marker_table(2, 1, 1), 1)
    assert start.tolist() == img_off.tolist() == [0, 10] and int(total) == 14
