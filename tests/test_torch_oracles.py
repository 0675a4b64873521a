"""The port's oracle tier (``block_pack``, ``mcu_merge``, ``seg_merge`` v1,
``seg_merge_v2``, ``seg_merge_v3``) on the CPU, bit for bit (tolerance 0:
integer bit streams).

Against jpegtpu: one module-scoped fixture runs jpegtpu's five functions
once each (``mcu_merge`` at two capacities) under ``jax.jit`` in interpret
mode, on one shape set: g = 6, 2 segments of 4 MCUs, w_cap = 2048. The
port's merges take jpegtpu's block streams (so a block-pack fault cannot
hide a merge fault) and, once more, the port's own.

Against a sequential numpy oracle in this file (no JAX compile): every
stream is a string of bits, joined and 1-padded in order, at other g,
sizes and layouts, with garbage past each row's length (which the port
ignores) and an output row too short for its segment.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu.kernels import entropy_oracles, entropy_pack
from jpegtpu_torch.entropy import scan as t_scan
from jpegtpu_torch.kernels import entropy_oracles as t_eo
from jpegtpu_torch.kernels import entropy_pack as t_ep
from test_torch_pack_merge import _k3_model

G, N_SEG, MPS, W_CAP, BUDGET = 6, 2, 4, 2048, 384
BPS = MPS * G

_mcu_merge = jax.jit(entropy_oracles.mcu_merge, static_argnums=(2, 3))
_seg_merge = jax.jit(entropy_oracles.seg_merge, static_argnums=(2, 3, 4))
_seg_merge_v2 = jax.jit(entropy_oracles.seg_merge_v2,
                        static_argnums=(2, 3, 4, 5))
_seg_merge_v3 = jax.jit(entropy_pack.seg_merge_v3,
                        static_argnums=(2, 3, 4, 5, 6))


def _n_luma(g):
    return {6: 4, 4: 2}.get(g, 1)


def _blocks(n_mcu, g, seed, kind="mixed"):
    """(coeffs [n_mcu*g, 64], cls [n], dcdiff [n]) int32. 'mixed': sparse
    blocks (zero runs of 16 and more: ZRL; trailing zeros: EOB) with the
    first two MCUs dense at 10-bit magnitudes (longer than a 384-bit budget
    holds); 'dense' all dense; 'zeros' all AC zero."""
    rng = np.random.default_rng(seed)
    n = n_mcu * g
    c = np.zeros((n, 64), np.int64)
    if kind != "zeros":
        mask = rng.random((n, 64)) < 0.2
        c[mask] = rng.integers(-255, 256, int(mask.sum()))
        c[3::5, 1:40] = 0                 # runs of 39 zeros before a value
        c[3::5, 40] = -9
        c[::7, 63] = 5                    # last slot nonzero: no EOB
        dense = n if kind == "dense" else 2 * g
        c[:dense] = rng.integers(-1023, 1024, (dense, 64))
    c[:, 0] = 0
    cls = (np.arange(n) % g >= _n_luma(g)).astype(np.int32)
    dcd = rng.integers(-2047, 2048, n).astype(np.int32)
    return c.astype(np.int32), cls, dcd


def _t(a):
    """numpy int32 or uint32 -> torch int32 with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return np.asarray(t).view(np.uint32)


@pytest.fixture(scope="module")
def ref():
    c, cls, dcd = _blocks(N_SEG * MPS, G, 1)
    w, l = entropy_pack.block_pack(jnp.asarray(c), jnp.asarray(cls),
                                   jnp.asarray(dcd))
    cap = entropy_pack.mcu_capacity(G, BUDGET)[0]
    r = dict(c=c, cls=cls, dcd=dcd, w=np.array(w), l=np.array(l), cap=cap)
    for key, chunks in (("default", None), ("budget", cap)):
        mw, ml = _mcu_merge(w, l, G, chunks)
        r["mcu", key] = np.array(mw), np.array(ml)
    r["v1"] = tuple(map(np.array, _seg_merge(w, l, N_SEG, BPS, W_CAP)))
    r["v2"] = tuple(map(np.array, _seg_merge_v2(w, l, N_SEG, BPS, W_CAP,
                                                 G)))
    sw, sb, most = _seg_merge_v3(w, l, N_SEG, BPS, W_CAP, G, None)
    r["v3"] = np.array(sw), np.array(sb)
    r["max_mcu_bits"] = int(most)
    return r


def _rung(rung, words, lens, n_seg, bps, w_cap, g):
    """The port's v1, v2 or v3 merge -> (segment words, seg_bits, the width
    jpegtpu's signature gives; v3's is the port's own)."""
    if rung == "v1":
        sw, sb = t_ep.seg_merge(words, lens, n_seg, bps, w_cap)
        return sw, sb, -(-w_cap // 128) * 128
    if rung == "v2":
        sw, sb = t_ep.seg_merge_v2(words, lens, n_seg, bps, w_cap, g)
        return sw, sb, (-(-w_cap // 1024) + 1) * 1024
    sw, sb, _ = t_ep.seg_merge_v3(words, lens, n_seg, bps, w_cap, g)
    return sw, sb, sw.shape[1]


def _assert_padded_words_equal(got, want, bits, what):
    """Each row's words up to ceil(bits/32): the stream and its 1-padded
    last byte (zero after it in both)."""
    for i, b in enumerate(np.asarray(bits, np.int64)):
        n = -(-int(b) // 32)
        np.testing.assert_array_equal(got[i, :n], want[i, :n],
                                      err_msg=f"{what} segment {i}")


# --- against jpegtpu -------------------------------------------------------

def test_block_pack_matches_jpegtpu(ref):
    words, lens = t_ep.block_pack(_t(ref["c"]), _t(ref["cls"]),
                                  _t(ref["dcd"]))
    assert words.shape == (N_SEG * BPS, t_ep.BLOCK_WORDS)
    assert words.dtype == lens.dtype == torch.int32
    np.testing.assert_array_equal(lens.numpy(), ref["l"])
    np.testing.assert_array_equal(_u32(words), ref["w"])


@pytest.mark.parametrize("key", ["default", "budget"])
def test_mcu_merge_matches_jpegtpu(ref, key):
    want_w, want_l = ref["mcu", key]
    chunks = None if key == "default" else ref["cap"]
    mw, ml = t_ep.mcu_merge(_t(ref["w"]), _t(ref["l"]), G, chunks)
    assert mw.shape == want_w.shape
    np.testing.assert_array_equal(ml.numpy(), want_l)
    np.testing.assert_array_equal(_u32(mw), want_w)
    if key == "budget":
        assert (want_l > 32 * want_w.shape[1]).any(), \
            "pick inputs with an MCU that the budget truncates"


@pytest.mark.parametrize("source", ["jpegtpu_blocks", "port_blocks"])
@pytest.mark.parametrize("rung", ["v1", "v2", "v3"])
def test_segments_match_jpegtpu(ref, rung, source):
    if source == "jpegtpu_blocks":
        words, lens = _t(ref["w"]), _t(ref["l"])
    else:
        words, lens = t_ep.block_pack(_t(ref["c"]), _t(ref["cls"]),
                                      _t(ref["dcd"]))
    want_w, want_b = ref[rung]
    sw, sb, width = _rung(rung, words, lens, N_SEG, BPS, W_CAP, G)
    assert sw.shape[1] == width
    if rung != "v3":
        assert sw.shape == want_w.shape
    np.testing.assert_array_equal(sb.numpy(), want_b)
    _assert_padded_words_equal(_u32(sw), want_w, want_b, rung)


def test_max_mcu_bits_matches_jpegtpu(ref):
    got = t_ep.seg_merge_v3(_t(ref["w"]), _t(ref["l"]), N_SEG, BPS, W_CAP,
                            G)[2]
    assert got.dim() == 0 and int(got) == ref["max_mcu_bits"]


def test_seg_merge_v3_refuses_a_truncated_mcu(ref):
    """jpegtpu leaves an MCU over a budget-sized row to its caller; the
    port raises instead of merging a truncated stream."""
    with pytest.raises(ValueError, match="exceeds"):
        t_ep.seg_merge_v3(_t(ref["w"]), _t(ref["l"]), N_SEG, BPS, W_CAP, G,
                          ref["cap"])


@pytest.mark.parametrize("name", ["mcu_merge", "seg_merge", "seg_merge_v2"])
def test_entropy_pack_reexports_the_oracles(name):
    assert getattr(t_ep, name) is getattr(t_eo, name)
    assert getattr(entropy_pack, name) is getattr(entropy_oracles, name)


def test_entropy_pack_unknown_attribute_raises():
    with pytest.raises(AttributeError, match="no_such_merge"):
        t_ep.no_such_merge  # noqa: B018


@pytest.mark.parametrize("budget", [1, 48, 250, 330, 384, 1660])
def test_mcu_capacity_matches_jpegtpu(budget):
    assert t_ep.BLOCK_WORDS == entropy_pack.BLOCK_WORDS
    for g in (1, 2, 3, 4, 6, 8, 12, 16, 24, 48):
        assert t_ep.mcu_capacity(g, budget) == \
            entropy_pack.mcu_capacity(g, budget), g


# --- against the sequential numpy oracle ------------------------------------

def _bits_of(row, n):
    """The first n bits of a row of u32 words, as a '0'/'1' string."""
    return "".join(f"{int(w):032b}" for w in row[:-(-n // 32)])[:n]


def _words_of(bits, width):
    """A '0'/'1' string -> u32 [width]: its first 32*width bits, zero after."""
    bits = bits[:32 * width]
    bits += "0" * (-len(bits) % 32)
    out = np.zeros(width, np.uint32)
    out[:len(bits) // 32] = [int(bits[k:k + 32], 2)
                             for k in range(0, len(bits), 32)]
    return out


def _oracle_join(words, lens, n_out, width, pad):
    """Join each n/n_out consecutive rows' streams in order into a row of
    `width` words (1-padding the last byte when pad; bits past the row
    dropped) -> (u32 [n_out, width], bit counts [n_out])."""
    words = np.asarray(words).view(np.uint32)
    per = len(lens) // n_out
    out = np.zeros((n_out, width), np.uint32)
    nbits = np.zeros(n_out, np.int64)
    for s in range(n_out):
        bits = "".join(_bits_of(words[i], int(lens[i]))
                       for i in range(s * per, (s + 1) * per))
        nbits[s] = len(bits)
        if pad:
            bits += "1" * (-len(bits) % 8)
        out[s] = _words_of(bits, width)
    return out, nbits


def _streams(n, row_words, seed):
    """n stream rows of row_words random words with random lengths in
    [0, 32*row_words] (some 0, some whole words, some full) and random bits
    past each length."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (n, row_words), dtype=np.uint64)
    lens = rng.integers(0, 32 * row_words + 1, n)
    lens[::11] = 0
    lens[1::13] = 32 * rng.integers(0, row_words + 1, len(lens[1::13]))
    lens[2::17] = 32 * row_words
    return _t(words.astype(np.uint32)), torch.from_numpy(lens.astype(np.int32))


@pytest.mark.parametrize("kind", ["mixed", "dense", "zeros"])
def test_block_pack_matches_sequential_pack(kind):
    """Each row is the block's symbols appended in order from bit 0."""
    c, cls, dcd = _blocks(50, 6, 5, kind)
    words, lens = t_ep.block_pack(_t(c), _t(cls), _t(dcd))
    sl, sb = t_scan.block_symbols(_t(c), _t(cls), _t(dcd),
                                  *t_ep.standard_luts(torch.device("cpu")))
    for i in range(len(c)):
        bits = "".join(f"{int(b):0{int(n)}b}" for n, b in zip(sl[i], sb[i])
                       if n)
        assert int(lens[i]) == len(bits)
        np.testing.assert_array_equal(_u32(words[i]),
                                      _words_of(bits, t_ep.BLOCK_WORDS),
                                      err_msg=f"block {i}")


@pytest.mark.parametrize("n_mcu", [5, 300])
@pytest.mark.parametrize("g", [1, 3, 4, 6])
def test_mcu_merge_matches_oracle(g, n_mcu):
    words, lens = _streams(n_mcu * g, t_ep.BLOCK_WORDS, g * 1000 + n_mcu)
    mw, ml = t_ep.mcu_merge(words, lens, g)
    width = 128 * -(-(g * 52 + 2) // 128)
    assert mw.shape == (n_mcu, width)
    want_w, want_l = _oracle_join(words.numpy(), lens.numpy(), n_mcu, width,
                                  False)
    np.testing.assert_array_equal(ml.numpy(), want_l)
    np.testing.assert_array_equal(_u32(mw), want_w)


@pytest.mark.parametrize("g", [3, 4, 6])
def test_mcu_merge_truncates_at_a_budget(g):
    """A budget-sized row keeps its first chunks*128 words; the length
    stays the full sum."""
    words, lens = _streams(40 * g, t_ep.BLOCK_WORDS, g)
    chunks = t_ep.mcu_capacity(g, 384)[0]
    mw, ml = t_ep.mcu_merge(words, lens, g, chunks)
    want_w, want_l = _oracle_join(words.numpy(), lens.numpy(), 40,
                                  chunks * 128, False)
    assert (want_l > 32 * chunks * 128).any(), "pick truncating inputs"
    np.testing.assert_array_equal(ml.numpy(), want_l)
    np.testing.assert_array_equal(_u32(mw), want_w)


# (n_seg, MCUs per segment): restart every 60 MCUs, one restart-0 segment
# of all 300, one MCU per segment.
LAYOUTS = {"rows": (5, 60), "single": (1, 300), "one_mcu": (12, 1)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("g", [1, 3, 4, 6])
@pytest.mark.parametrize("rung", ["v1", "v2", "v3"])
def test_segment_merges_match_oracle(rung, g, layout):
    n_seg, mps = LAYOUTS[layout]
    words, lens = _streams(n_seg * mps * g, t_ep.BLOCK_WORDS, g + mps)
    w_cap = mps * g * t_ep.BLOCK_WORDS + 2   # every segment fits
    sw, sb, width = _rung(rung, words, lens, n_seg, mps * g, w_cap, g)
    assert sw.shape == (n_seg, width)
    want_w, want_b = _oracle_join(words.numpy(), lens.numpy(), n_seg, width,
                                  True)
    np.testing.assert_array_equal(sb.numpy(), want_b)
    np.testing.assert_array_equal(_u32(sw), want_w)


@pytest.mark.parametrize("g", [1, 3, 4, 6])
def test_block_pack_mcu_equals_mcu_merge_of_block_pack(g):
    """K2's MCU streams are K8 applied to K7's block streams (jpegtpu's
    test_block_pack_mcu_matches_composition)."""
    n_mcu = 40
    c, cls, dcd = _blocks(n_mcu, g, g + 20)
    luts = t_ep.standard_luts(torch.device("cpu"))
    mw2, ml2 = t_ep.block_pack_mcu_pairs(_t(c).reshape(n_mcu, g * 64),
                                         _t(cls), _t(dcd), *luts)
    mw8, ml8 = t_ep.mcu_merge(*t_ep.block_pack(_t(c), _t(cls), _t(dcd)), g)
    assert torch.equal(ml2, ml8)
    k = mw2.shape[1]
    assert torch.equal(mw2, mw8[:, :k]) and not mw8[:, k:].any()


@pytest.mark.parametrize("layout", ["rows", "single"])
@pytest.mark.parametrize("rung", ["v1", "v2"])
def test_overflowing_w_cap_keeps_true_bits(rung, layout):
    """A segment longer than its row: the true seg_bits, the row's shape
    unchanged, and its words those of the stream cut at the row's end (no
    1-pad past it); nothing lands in the next segment."""
    n_seg, mps = LAYOUTS[layout]
    words, lens = _streams(n_seg * mps * 6, t_ep.BLOCK_WORDS, 77)
    w_cap = 100 if rung == "v1" else 1000
    sw, sb, width = _rung(rung, words, lens, n_seg, mps * 6, w_cap, 6)
    assert sw.shape == (n_seg, width)
    want_w, want_b = _oracle_join(words.numpy(), lens.numpy(), n_seg, width,
                                  True)
    assert (want_b > 32 * width).all(), "pick overflowing segments"
    np.testing.assert_array_equal(sb.numpy(), want_b)
    np.testing.assert_array_equal(_u32(sw), want_w)


def test_oracle_wrappers_reject_bad_shapes():
    words, lens = _streams(12, t_ep.BLOCK_WORDS, 3)
    with pytest.raises(ValueError, match="whole MCUs"):
        t_ep.mcu_merge(words, lens, 5)
    with pytest.raises(ValueError, match="segments"):
        t_ep.seg_merge(words, lens, 5, 2, 1024)
    with pytest.raises(ValueError, match="whole MCUs"):
        t_ep.seg_merge_v2(words, lens, 2, 6, 1024, 4)
    with pytest.raises(ValueError, match="whole MCUs"):
        t_ep.seg_merge_v3(words, lens, 2, 6, 1024, 4)


def test_merge_wrappers_refuse_widths():
    """K8 and K10 refuse, on either device, stream rows as wide as
    SEG_MERGE_MAX_ROW words (a tile could pass 2^31 bits) and output rows
    of 2^31 words; no twin runs."""
    wide = torch.zeros((6, t_ep.SEG_MERGE_MAX_ROW), dtype=torch.int32)
    lens = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be under"):
        t_eo.mcu_merge(wide, lens, 6)
    with pytest.raises(ValueError, match="must be under"):
        t_eo.seg_merge(wide, lens, 2, 3, 128)
    words, lens = _streams(12, t_ep.BLOCK_WORDS, 3)
    with pytest.raises(ValueError, match="must be under"):
        t_eo.mcu_merge(words, lens, 6, 1 << 24)
    with pytest.raises(ValueError, match="must be under"):
        t_eo.seg_merge(words, lens, 2, 6, 1 << 31)


def test_seg_merge_window_refuses_rows_of_partial_quads():
    """K9 writes whole output rows in 16-byte stores: a row width that is
    not a multiple of 4 words is refused on either device (jpegtpu's v2
    rows are frames * 1024 words)."""
    words, lens = _streams(12, t_ep.BLOCK_WORDS, 3)
    with pytest.raises(ValueError, match="multiple of 4"):
        t_eo.seg_merge_window(words, lens, 2, 6, 1026)
    sw, sb = t_eo.seg_merge_window(words, lens, 2, 6, 1028)
    assert sw.shape == (2, 1028) and sb.shape == (2,)


# --- K8, K9 and K10 as instances of csrc/seg_merge.cu's body --------------

def _brute_plan(n_seg, per, seg_w, zero_tail, tile=None):
    """(data tiles, tail tiles, scratch words) of one launch, counted by
    naming the tile of every row and every output word: a whole-segment
    tile holds max(1, TARGET // per) consecutive segments (max(1, WHOLE //
    per) with the zero tail); a segment of more than WHOLE rows (with the
    zero tail also one of a row wider than TAIL words) is cut into split
    tiles of `tile` (by default TILE, with the zero tail ZERO_TILE)
    consecutive rows, all its rows where it has no more than WHOLE; a tail
    tile TAIL consecutive words of one split segment's row."""
    split = per > t_ep.SEG_MERGE_WHOLE or (zero_tail and
                                           seg_w > t_ep.SEG_MERGE_TAIL)
    s, i = np.divmod(np.arange(n_seg * per), per)
    if split:
        if tile is None:
            tile = (t_ep.SEG_MERGE_ZERO_TILE if zero_tail
                    else t_ep.SEG_MERGE_TILE)
        if per <= t_ep.SEG_MERGE_WHOLE:
            tile = per
        data = len(np.unique(s * n_seg * per + i // tile))
    else:
        rows = t_ep.SEG_MERGE_WHOLE if zero_tail else t_ep.SEG_MERGE_TARGET
        data = len(np.unique(s // max(1, rows // per)))
    tails = 0
    if split and zero_tail:
        q = np.arange(seg_w) // t_ep.SEG_MERGE_TAIL
        tails = n_seg * len(np.unique(q))
    scratch = t_ep.SEG_MERGE_SCRATCH_HEAD + data if split else 0
    return data, tails, scratch


# (segments, rows a segment, output words, zero tail): K8 at g 1, 6 and
# 600 (split), K10 on 40-, 600- and 1,500-block segments, K3 (no tail) on
# split segments.
PLANS = [(50, 1, 128, True), (1100, 1, 128, True), (1000, 6, 384, True),
         (1000, 6, 384, False), (2, 600, 31232, True), (7, 40, 2304, True),
         (4, 600, 33664, True), (2, 1500, 84096, True),
         (3, 1500, 84096, False)]


@pytest.mark.parametrize("n_seg,per,seg_w,zero_tail", PLANS)
def test_merge_plan_matches_brute_force(n_seg, per, seg_w, zero_tail):
    got = (*t_ep.seg_merge_tiles(n_seg, per, seg_w, zero_tail),
           t_ep.seg_merge_scratch_words(n_seg, per, zero_tail))
    assert got == _brute_plan(n_seg, per, seg_w, zero_tail)


@pytest.mark.parametrize("n_seg,per,seg_w,want", [
    (32400, 6, 384, (382, 0, 0)),           # K8, 4K 4:2:0 rows
    (129600, 3, 256, (763, 0, 0)),          # K8, 4K 4:4:4 rows
    (135, 1440, 75008, (405, 675, 421)),    # K10, 4K 4:2:0 rows
    (1, 194400, 10108928, (380, 617, 396)),  # K10, 4K 4:2:0 restart 0
])
def test_merge_plan_at_4k(n_seg, per, seg_w, want):
    """The 4K ladder's K8 and K10 launches: whole-segment tiles of up to
    512 blocks for K8; for K10 split tiles of 512 blocks, tail tiles of
    16,384 words, and a status word a data tile."""
    assert (*t_ep.seg_merge_tiles(n_seg, per, seg_w, True),
            t_ep.seg_merge_scratch_words(n_seg, per, True)) == want


def _k9_width(n_seg, mps, g):
    """K9's output row in the ladder's v2: frames * 1024 words, frames =
    ceil(w_cap / 1024) + 1, w_cap the port's segment_words of K2's MCU
    rows (g * 52 + 2 words)."""
    w_cap = t_ep.segment_words(n_seg, mps, t_ep.mcu_words(g))
    return (-(-w_cap // 1024) + 1) * 1024


# (segments, MCUs a segment, g): K9 over K8's MCU rows at g = 6 and 3: one
# MCU a segment and segments of 7 (rows of up to 16,384 words: whole
# tiles), segments of 100, 240 and 480 (rows wider: split, a data tile
# each), 600 and 1,300 (past 512 MCUs: tiles of 256), and the 4K ladder's
# 4:2:0 rows, 4:4:4 rows and restart 0.
K9_PLANS = [(40, 1, 6), (30, 7, 6), (9, 100, 6), (5, 240, 6), (3, 480, 3),
            (3, 600, 6), (2, 1300, 3), (135, 240, 6), (270, 480, 3),
            (1, 32400, 6)]


@pytest.mark.parametrize("n_seg,mps,g", K9_PLANS)
def test_k9_plan_matches_brute_force(n_seg, mps, g):
    """K9's launch plan (split tiles of SEG_MERGE_TILE MCUs) against the
    brute-force count."""
    seg_w = _k9_width(n_seg, mps, g)
    tile = t_ep.SEG_MERGE_TILE
    got = (*t_ep.seg_merge_tiles(n_seg, mps, seg_w, True, tile),
           t_ep.seg_merge_scratch_words(n_seg, mps, True, seg_w, tile))
    assert got == _brute_plan(n_seg, mps, seg_w, True, tile)


@pytest.mark.parametrize("n_seg,mps,g,want", [
    (135, 240, 6, (76800, 135, 675, 151)),      # 4:2:0 rows
    (270, 480, 3, (76800, 270, 1350, 286)),     # 4:4:4 rows
    (1, 32400, 6, (10109952, 127, 618, 143)),   # 4:2:0 restart 0
])
def test_k9_plan_at_4k(n_seg, mps, g, want):
    """The 4K ladder's K9 launches: its 76,800-word rows are wider than a
    tail tile, so every segment is split: a data tile a 240- or 480-MCU
    segment (127 tiles of 256 MCUs the restart-0 segment), a status word
    each, and tail tiles of 16,384 words that zero the rows past the
    data."""
    seg_w = _k9_width(n_seg, mps, g)
    tile = t_ep.SEG_MERGE_TILE
    assert (seg_w, *t_ep.seg_merge_tiles(n_seg, mps, seg_w, True, tile),
            t_ep.seg_merge_scratch_words(n_seg, mps, True, seg_w,
                                         tile)) == want


# (segments, rows a segment, output words, whole, target, split, tail,
# pad): K8 (no pad) on whole tiles of 2 MCUs, rows that truncate, and g
# past `whole` (split tiles and 3 tail tiles an MCU); K10 (pad) on whole
# tiles, split segments with tail tiles, and split rows too short.
ZERO_TAIL_CASES = {
    "K8_whole": (7, 2, 8, 4, 7, 3, 5, False),
    "K8_truncating": (7, 2, 2, 4, 7, 3, 5, False),
    "K8_split": (3, 10, 8, 4, 7, 3, 3, False),
    "K10_whole": (5, 2, 6, 4, 7, 3, 4, True),
    "K10_split": (3, 10, 20, 4, 7, 3, 6, True),
    "K10_split_short": (3, 10, 3, 4, 7, 3, 2, True),
}


@pytest.mark.parametrize("name", sorted(ZERO_TAIL_CASES))
def test_zero_tail_instances_write_each_word_once(name):
    """The kernel model with the zero tail: every word of every output row
    written exactly once (data, pad or zero), equal to the twin's whole
    rows (K8: ``mcu_merge_plain``, K10: ``seg_merge_plain``), the true bit
    counts, and the tile counts of ``seg_merge_tiles``' rule."""
    n_seg, per, seg_w, whole, target, split, tail, pad = \
        ZERO_TAIL_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    words = rng.integers(0, 1 << 32, (n_seg * per, 5),
                         dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, 161, n_seg * per).astype(np.int32)
    lens[::4] = 0
    lens[1::5] = 160
    out, writes, bits, tiles = _k3_model(words, lens, n_seg, per, seg_w,
                                         whole, target, split, pad, tail)
    tw, tl = torch.from_numpy(words.view(np.int32)), torch.from_numpy(lens)
    want_w, want_b = (t_eo.seg_merge_plain(tw, tl, n_seg, seg_w) if pad else
                      t_eo.mcu_merge_plain(tw, tl, per, seg_w))
    assert [bits[s] for s in range(n_seg)] == want_b.tolist()
    assert set(writes) == {(s, q) for s in range(n_seg)
                           for q in range(seg_w)}
    assert set(writes.values()) == {1}
    want = _u32(want_w)
    assert all(out[s, q] == want[s, q] for (s, q) in out), name
    if name.endswith(("truncating", "short")):
        assert (want_b.numpy() > 32 * seg_w).any(), "pick truncating rows"
    n_split = -(-per // split) if per > whole else 0
    assert tiles == ((n_seg * n_split, n_seg * -(-seg_w // tail))
                     if n_split else (-(-n_seg // max(1, whole // per)), 0))


# (segments, MCUs a segment, output words, whole, split, tail, wide): K9's
# instance in the model, its rows (output words) against `wide` (the
# kernel's kTailWords): one-MCU segments and whole segments in rows no
# wider (whole tiles), rows too short for their segments, and segments
# that fit a tile in rows wider than `wide` (split: a data tile a segment,
# and tail tiles), and segments longer than `whole` (split tiles).
K9_CASES = {
    "one_mcu": (9, 1, 8, 4, 3, 5, 8),
    "whole": (5, 3, 16, 4, 3, 4, 16),
    "whole_short": (5, 3, 2, 4, 3, 4, 16),
    "wide_rows": (5, 3, 24, 4, 3, 8, 16),
    "wide_rows_at_whole": (3, 4, 40, 4, 3, 8, 16),
    "long_segments": (2, 11, 24, 4, 3, 8, 16),
    "wide_rows_short": (3, 8, 18, 8, 3, 8, 16),
}


@pytest.mark.parametrize("name", sorted(K9_CASES))
def test_k9_instance_writes_each_word_once(name):
    """The kernel model as K9 runs it (pad, zero tail, rows wider than
    `wide` split): every word of every output row written exactly once,
    equal to ``seg_merge_window_plain``'s whole rows and its bit counts."""
    n_seg, per, seg_w, whole, split, tail, wide = K9_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    words = rng.integers(0, 1 << 32, (n_seg * per, 5),
                         dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, 161, n_seg * per).astype(np.int32)
    lens[::4] = 0
    lens[1::5] = 160
    out, writes, bits, tiles = _k3_model(words, lens, n_seg, per, seg_w,
                                         whole, whole, split, True, tail,
                                         wide)
    tw, tl = torch.from_numpy(words.view(np.int32)), torch.from_numpy(lens)
    want_w, want_b = t_eo.seg_merge_window_plain(tw, tl, n_seg, seg_w)
    assert [bits[s] for s in range(n_seg)] == want_b.tolist()
    assert set(writes) == {(s, q) for s in range(n_seg)
                           for q in range(seg_w)}
    assert set(writes.values()) == {1}
    want = _u32(want_w)
    assert all(out[s, q] == want[s, q] for (s, q) in out), name
    if name.endswith("short"):
        assert (want_b.numpy() > 32 * seg_w).any(), "pick truncating rows"
    n_split = -(-per // split) if per > whole else int(seg_w > wide)
    assert tiles == ((n_seg * n_split, n_seg * -(-seg_w // tail))
                     if n_split else (-(-n_seg // max(1, whole // per)), 0))
