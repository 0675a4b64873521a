"""The entropy middle on the CPU: the encoder's block-pack launcher
(``entropy_pack.block_pack_mcu_segments``, which derives each block's class
and DC difference) and the segment merge (``seg_merge_mcu``, which takes a
ragged last segment as it is), bit for bit (tolerance 0: integer bit
streams).

Against jpegtpu: its ``block_pack_mcu_pairs`` fed its own DC differences
and classes, in 4:2:0, 4:2:2, 4:4:4 and gray at restart rows / 0 / 7 / 1,
from the coefficients and from a DC plane, and on a two-image batch (one
interpret compile a mode, in a module fixture); its ``seg_merge_mcu`` on
a ragged input padded as its encoder pads it.

Against numpy models of the CUDA kernels' own arithmetic, which no CPU run
reaches otherwise: K2's pair layout (lane l holds slots 2l and 2l+1; the
previous nonzero slot from two ballots) and its 64-bit runs split over
three words; K3's tiles, with tiles small enough to split a segment
several times, each output word written once by the tile that holds its
first bit; K7's groups of blocks, each at bit 0 of its own row, whole rows
written once. And the consumers of K3's output (the stuffing and
compaction twins) read nothing past a segment's bytes.
"""

import re
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu.entropy import huffman_tables as ht
from jpegtpu.entropy import scan
from jpegtpu.kernels import entropy_pack
from jpegtpu_torch.entropy import scan as t_scan
from jpegtpu_torch.kernels import _build, compact
from jpegtpu_torch.kernels import entropy_pack as t_ep

LUTS = tuple(torch.from_numpy(a.astype(np.int32)) for a in ht.packed_luts())
# (blocks an MCU, luma blocks an MCU) of each mode.
MODES = {"420": (6, 4), "422": (4, 2), "444": (3, 1), "gray": (1, 1)}
# One MCU grid for every case: 6 rows of 5 MCUs (restart "rows" is 5, 7 is
# ragged), or two images of 3 rows for the batch; 30 MCUs either way, so
# jpegtpu's block pack compiles once a mode.
MY, MX, N_MCU = 6, 5, 30
RESTARTS = {"rows": MX, "0": 0, "7": 7, "1": 1}

_dc_diffs = jax.jit(scan.dc_diffs_from_dc, static_argnums=(1, 2))
_block_pack = jax.jit(entropy_pack.block_pack_mcu_pairs,
                      static_argnums=(3, 4), static_argnames=("n_luma",))
_seg_merge = jax.jit(entropy_pack.seg_merge_mcu, static_argnums=(2, 3, 4))


def _u32(t):
    return t.numpy().view(np.uint32)


def _first_bits_equal(got, want, nbits):
    """Rows of u32 words agree on their first nbits[i] bits."""
    for i, n in enumerate(np.asarray(nbits, np.int64)):
        full, tail = divmod(int(n), 32)
        np.testing.assert_array_equal(got[i, :full], want[i, :full],
                                      err_msg=f"row {i}")
        if tail:
            mask = np.uint32((0xFFFFFFFF << (32 - tail)) & 0xFFFFFFFF)
            assert got[i, full] & mask == want[i, full] & mask, f"row {i}"


def _coeffs(g, seed):
    """[N_MCU, g*64] int32 zigzag coefficients: sparse AC values with runs
    of 16 and more zeros (ZRL) and trailing zeros (EOB), some dense blocks,
    a few blocks whose slot 63 is nonzero (no EOB), DC values whose
    differences need every size category up to 11."""
    rng = np.random.default_rng(seed)
    n = N_MCU * g
    c = np.zeros((n, 64), np.int64)
    mask = rng.random((n, 64)) < 0.15
    c[mask] = rng.integers(-200, 201, int(mask.sum()))
    c[2::9, 1:30] = 0
    c[2::9, 30] = -3
    c[::11, 63] = 7
    c[5] = rng.integers(-60, 61, 64)
    c[:, 0] = rng.integers(-1000, 1001, n)
    return c.reshape(N_MCU, g * 64).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(MODES))
def mode_ref(request):
    """One mode's coefficients and jpegtpu's MCU streams of them at every
    restart interval and for the batch (two images of 15 MCUs at restart
    "rows"), each from jpegtpu's own DC differences and classes."""
    mode = request.param
    g, n_luma = MODES[mode]
    c = _coeffs(g, {"420": 1, "422": 2, "444": 3, "gray": 4}[mode])
    cls = (np.arange(N_MCU * g) % g >= n_luma).astype(np.int32)
    chunks, cap_bits = entropy_pack.mcu_capacity(g, 384)
    dc = jnp.asarray(c[:, ::64])
    dcds = {r: np.asarray(_dc_diffs(dc, n_luma, restart))
            for r, restart in RESTARTS.items()}
    half = N_MCU // 2
    dcds["batch"] = np.concatenate(
        [np.asarray(_dc_diffs(dc[:half], n_luma, MX)),
         np.asarray(_dc_diffs(dc[half:], n_luma, MX))])
    want = {}
    for r, dcd in dcds.items():
        mw, ml = _block_pack(jnp.asarray(c), jnp.asarray(cls),
                             jnp.asarray(dcd.reshape(-1)), g, chunks,
                             n_luma=n_luma)
        assert int(np.max(np.asarray(ml))) <= cap_bits, "no truncation"
        want[r] = (np.asarray(mw), np.asarray(ml))
    return mode, c, want


@pytest.mark.parametrize("source", ["coefficients", "dc_plane"])
@pytest.mark.parametrize("restart", sorted(RESTARTS) + ["batch"])
def test_segments_launcher_matches_jpegtpu(mode_ref, restart, source):
    """The encoder's launcher (its twin here) derives jpegtpu's classes
    and DC differences: the same MCU lengths and stream bits as jpegtpu's
    block pack fed them. From a DC plane of 8 lanes, the coefficients' slot
    0 holds garbage, which the pack must not read; in the batch, the
    second image's first MCU (MCU 15, a segment start) resets every
    predictor."""
    mode, c, want = mode_ref
    g, n_luma = MODES[mode]
    c = torch.from_numpy(c.copy())
    interval = MX if restart == "batch" else RESTARTS[restart]
    dc = None
    if source == "dc_plane":
        rng = np.random.default_rng(5)
        plane = rng.integers(-5000, 5000, (N_MCU, 8)).astype(np.int32)
        plane[:, :g] = c[:, ::64].numpy()
        dc = torch.from_numpy(plane)
        c[:, ::64] = torch.from_numpy(
            rng.integers(-5000, 5000, (N_MCU, g)).astype(np.int32))
    mw, ml = t_ep.block_pack_mcu_segments(c, n_luma, interval, LUTS, dc)
    want_w, want_l = want[restart]
    np.testing.assert_array_equal(ml.numpy(), want_l)
    _first_bits_equal(_u32(mw), want_w, want_l)


@pytest.fixture(scope="module")
def ragged_ref():
    """25 MCU streams of a 4:2:0 image in segments of 8 (the last one holds
    a single MCU), packed by the port's twin, and jpegtpu's seg_merge_mcu
    of them with 7 zero-length pad MCUs appended, as its encoder pads them
    (``jpegtpu/encoder.py:266-275``), in interpret mode."""
    n_mcu, n_seg, mps = 25, 4, 8
    c = torch.from_numpy(_coeffs(6, 7)[:n_mcu])
    mw, ml = t_ep.block_pack_mcu_segments(c, 4, mps, LUTS)
    words = _u32(mw)[:, :128]
    assert int(ml.max()) <= 32 * 128, "one 128-word chunk an MCU"
    padded = np.zeros((n_seg * mps, 128), np.uint32)
    padded[:n_mcu] = words
    lens = np.zeros(n_seg * mps, np.int32)
    lens[:n_mcu] = ml.numpy()
    w_cap = -(-mps * 6 * 384 // 32)
    sw, sb, _ = _seg_merge(jnp.asarray(padded), jnp.asarray(lens), n_seg,
                           mps, w_cap)
    return dict(words=words, lens=ml.numpy(), n_seg=n_seg, mps=mps,
                sw=np.asarray(sw), sb=np.asarray(sb))


def test_ragged_merge_matches_jpegtpu_padded(ragged_ref):
    """The merge takes the 25 MCUs as they are (no pad MCUs): jpegtpu's
    seg_bits, and its bytes through each segment's 1-padded last one."""
    r = ragged_ref
    sw, sb = t_ep.seg_merge_mcu(torch.from_numpy(r["words"].view(np.int32)),
                                torch.from_numpy(r["lens"]), r["n_seg"],
                                r["mps"])
    np.testing.assert_array_equal(sb.numpy(), r["sb"])
    assert int(r["sb"][-1]) % 8, "the last segment must end inside a byte"
    _first_bits_equal(_u32(sw), r["sw"], (r["sb"].astype(np.int64) + 7)
                      // 8 * 8)


@pytest.mark.parametrize("nm,n_seg,mps", [(16, 3, 8), (25, 3, 8),
                                          (0, 1, 3), (7, 1, 3)])
def test_merge_refuses_counts_that_are_not_a_ragged_last_segment(
        nm, n_seg, mps):
    """Fewer MCUs than n_seg - 1 whole segments, or more than n_seg of
    them, raise ValueError: only a last segment may fall short."""
    words = torch.zeros((nm, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fill"):
        t_ep.seg_merge_mcu(words, torch.zeros(nm, dtype=torch.int32), n_seg,
                           mps)


# --- K2's pair layout, in numpy.

def _pair_model(c, dcd, cls):
    """csrc/block_pack.cu's symbols in numpy, as its warp computes them:
    lane l holds slots 2l and 2l+1; E and O are the ballots of nonzero even
    and odd slots (E's bit 0 set: the DC sentinel); each slot's symbol by
    slot_symbol's one formula from the packed LUTs. -> (lens, bits)
    [N, 64]."""
    dc_codes, dc_lens, ac_codes, ac_lens = (a.astype(np.int64)
                                            for a in ht.packed_luts())
    dc_lut = (dc_codes << 8) | dc_lens
    ac_lut = (ac_codes << 8) | ac_lens
    n = c.shape[0]
    lens = np.zeros((n, 64), np.int64)
    bits = np.zeros((n, 64), np.int64)

    def top(mask):                      # 31 - clz, or -1 for an empty mask
        return mask.bit_length() - 1

    for i in range(n):
        a, b = c[i, 0::2], c[i, 1::2]
        E = sum(1 << l for l in range(32) if a[l] != 0) | 1
        O = sum(1 << l for l in range(32) if b[l] != 0)
        last_nz = max(2 * top(E), 2 * top(O) + 1 if O else -1)
        zrl, eob = ac_lut[cls[i], 0xF0], ac_lut[cls[i], 0]
        for lane in range(32):
            below = (1 << lane) - 1
            pe, po = top(E & below), top(O & below)
            prev0 = max(2 * pe if pe >= 0 else -1,
                        2 * po + 1 if po >= 0 else -1)
            prev1 = 2 * lane if (a[lane] != 0 or lane == 0) else prev0
            for k, v, prev in ((2 * lane, dcd[i] if lane == 0 else a[lane],
                                prev0), (2 * lane + 1, b[lane], prev1)):
                v = int(v)
                s = abs(v).bit_length()
                if k == 0:
                    ent = dc_lut[cls[i], s]
                elif v != 0:
                    ent = ac_lut[cls[i], (((k - prev - 1) & 15) << 4) | s]
                elif k < last_nz and (k - prev) % 16 == 0:
                    ent = zrl
                elif k == last_nz + 1:
                    ent = eob
                else:
                    ent = 0
                mag = v + ((1 << s) - 1 if v < 0 else 0)
                lens[i, k] = (ent & 255) + s
                bits[i, k] = ((ent >> 8) << s) | mag
    return lens, bits


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_layout_gives_the_symbols_of_the_twin(seed):
    """The kernel's pair-layout symbolizer (numpy model) against
    ``scan.block_symbols``: every slot's length and bits, on sparse, dense,
    all-zero and last-slot-nonzero blocks of both classes."""
    c = _coeffs(6, 10 + seed)[:8].reshape(-1, 64).copy()
    c[3] = 0                                      # DC only: EOB at slot 1
    c[4, 1:] = 0
    c[4, 63] = 1                                  # 3 ZRLs, no EOB
    c[6, 1:] = np.where(c[6, 1:] == 0, 9, c[6, 1:])   # every slot nonzero
    dcd = np.random.default_rng(seed).integers(-2047, 2048, c.shape[0])
    dcd[0] = 0
    cls = (np.arange(c.shape[0]) % 6 >= 4).astype(np.int32)
    lens, bits = _pair_model(c, dcd, cls)
    want_l, want_b = t_scan.block_symbols(torch.from_numpy(c),
                                          torch.from_numpy(cls),
                                          torch.from_numpy(dcd), *LUTS)
    np.testing.assert_array_equal(lens, want_l.numpy())
    np.testing.assert_array_equal(bits, want_b.numpy())


def test_put_run_splits_a_run_over_three_words():
    """put_run's three parts (u64 arithmetic in Python ints) OR a run of
    1-52 bits into the right bits of three words at every shift."""
    rng = np.random.default_rng(3)
    for length in range(1, 53):
        run = int(rng.integers(0, 1 << length, dtype=np.uint64))
        for r in range(32):
            t = (run << (64 - length)) & (2 ** 64 - 1)
            w0 = (t >> (32 + r)) & 0xFFFFFFFF
            w1 = (t >> r) & 0xFFFFFFFF
            w2 = (t << (32 - r)) & 0xFFFFFFFF
            got = (w0 << 64) | (w1 << 32) | w2
            assert got == run << (96 - r - length), (length, r)


# --- K7's groups of blocks, in numpy.

def _k7_model(c, cls, dcd, per):
    """csrc/block_pack.cu's K7 in numpy: a warp takes `per` consecutive
    blocks (fewer in the last group), each block's lane runs (slot 2l's
    symbol then slot 2l+1's, ``_pair_model``) placed by an exclusive scan
    at bit 0 of its own 56-word shared row by put_run's three words, then
    the group's rows go out as 16-byte quads, a quad from the row where it
    holds valid words (and zeroed there) and zeros else. -> (rows u32
    [N, 56], lengths [N], writes per (block, word)); asserts that the
    shared rows are zero again after every group."""
    n = c.shape[0]
    slot_l, slot_b = _pair_model(c, dcd, cls)
    out = np.full((n, t_ep.BLOCK_WORDS), 0xDEADBEEF, np.uint64)
    lens = np.full(n, -1, np.int64)
    writes = Counter()
    shared = np.zeros((per, t_ep.BLOCK_WORDS), np.uint64)
    mask32 = 0xFFFFFFFF
    for b0 in range(0, n, per):
        nb = min(per, n - b0)
        total = []
        for u in range(nb):
            ln = slot_l[b0 + u, 0::2] + slot_l[b0 + u, 1::2]
            ex = np.concatenate([[0], np.cumsum(ln)[:-1]])
            for lane in range(32):
                length = int(ln[lane])
                if not length:
                    continue
                run = ((int(slot_b[b0 + u, 2 * lane]) <<
                        int(slot_l[b0 + u, 2 * lane + 1])) |
                       int(slot_b[b0 + u, 2 * lane + 1]))
                t = (run << (64 - length)) & (2 ** 64 - 1)
                w, r = divmod(int(ex[lane]), 32)
                for d, part in enumerate((t >> (32 + r), t >> r,
                                          t << (32 - r))):
                    if part & mask32:
                        shared[u, w + d] |= part & mask32
            total.append(int(ln.sum()))
        for q in range(nb * t_ep.BLOCK_WORDS // 4):
            r, j = divmod(q, t_ep.BLOCK_WORDS // 4)
            valid = 4 * j < -(-total[r] // 32)
            for k in range(4 * j, 4 * j + 4):
                out[b0 + r, k] = shared[r, k] if valid else 0
                writes[b0 + r, k] += 1
                if valid:
                    shared[r, k] = 0
        lens[b0:b0 + nb] = total
        assert not shared.any(), "a shared row left dirty"
    return out.astype(np.uint32), lens, writes


def _k7_blocks(kind, n, seed):
    """(coeffs [n, 64], cls [n], dcd [n]) int32 of one kind: 'dense' every
    slot at 10 bits and DC steps of 11 in luma blocks (the longest stream,
    1,658 bits),
    'zeros' all-zero blocks (DC difference 0: EOB alone), 'eob' a DC step
    and then EOB, 'zrl' runs of 16 and more zeros before a value (ZRL) and
    values in the last slot (no EOB)."""
    rng = np.random.default_rng(seed)
    c = np.zeros((n, 64), np.int64)
    dcd = rng.integers(-2047, 2048, n)
    if kind == "dense":
        c = rng.choice([-1023, 1023], (n, 64))
        dcd = rng.choice([-2047, 2047], n)
    elif kind == "zeros":
        dcd[:] = 0
    elif kind == "zrl":
        c[:, 17] = rng.integers(1, 40, n)
        c[:, 50] = -rng.integers(1, 40, n)
        c[1::2, 63] = 3
    c[:, 0] = 0
    cls = rng.integers(0, 2, n) if kind != "dense" else np.zeros(n)
    return c.astype(np.int32), cls.astype(np.int32), dcd.astype(np.int32)


def _k7_per():
    """csrc/block_pack.cu's kPackPer: the blocks a K7 warp takes."""
    src = (_build.CSRC / "block_pack.cu").read_text()
    return int(re.search(r"kPackPer = (\d+)", src).group(1))


@pytest.mark.parametrize("n", [1, "per-1", "per", "3per+1"])
@pytest.mark.parametrize("kind", ["dense", "zeros", "eob", "zrl"])
def test_k7_groups_write_whole_rows_once(kind, n):
    """The K7 model against ``block_pack_plain``: every word of every row
    written once (zeros past the data), the same rows and lengths, at
    block counts that leave the last group short."""
    per = _k7_per()
    n = max(1, {"per-1": per - 1, "per": per,
                "3per+1": 3 * per + 1}.get(n, n))
    c, cls, dcd = _k7_blocks(kind, n, sum(map(ord, kind)) + n)
    words, lens, writes = _k7_model(c, cls, dcd, per)
    want_w, want_l = t_ep.block_pack_plain(
        torch.from_numpy(c), torch.from_numpy(cls), torch.from_numpy(dcd),
        *LUTS)
    np.testing.assert_array_equal(lens, want_l.numpy())
    np.testing.assert_array_equal(words, _u32(want_w))
    assert set(writes) == {(i, k) for i in range(n)
                           for k in range(t_ep.BLOCK_WORDS)}
    assert set(writes.values()) == {1}
    if kind == "dense":
        assert lens.min() == 1658, "pick blocks of the longest stream"


# --- K3's tiles, in numpy.

def _k3_model(words, lens, n_seg, mps, seg_w, whole, target, split_mcus,
              pad=True, tail=None, wide=None):
    """csrc/seg_merge.cu in numpy with its tile constants as arguments:
    (segment words {(s, q): word}, writes per (s, q), seg_bits, (data
    tiles, tail tiles)). A segment of more than `whole` MCUs is cut into
    tiles of split_mcus, each taking its carry from the tiles before it in
    its segment; else a tile is max(1, target // mps) whole segments
    (max(1, whole // mps) with the zero tail). With `wide` (K9: the
    kernel's kTailWords) a segment whose row is wider than wide words is
    split too, one tile where it has no more than `whole` MCUs. Each
    tile owns the words whose first bit it holds and builds each from the
    MCU holding that bit and the ones after it, by the kernel's funnel
    shift, reading only words that hold data (asserted), 1-padding the
    segment's last byte when pad. With tail (K8, K10: the zero tail) a
    whole-segment tile also zeroes its segments' words past their data, and
    after every data tile each split segment gets ceil(seg_w / tail) tail
    tiles, each zeroing its share of [ceil(seg_bits / 32), seg_w)."""
    nm = len(lens)

    def length(m):
        return int(lens[m]) if m < nm else 0

    def piece(m, b, take):
        row = words[m]
        hi = int(row[b >> 5])
        sh = b & 31
        lo = 0
        if sh + take > 32:
            assert (b >> 5) + 1 < -(-length(m) // 32), "read past the data"
            lo = int(row[(b >> 5) + 1])
        assert (b >> 5) < -(-length(m) // 32), "read past the data"
        x = (((hi << 32) | lo) << sh >> 32) & 0xFFFFFFFF
        return x >> (32 - take)

    split = mps > whole or (wide is not None and seg_w > wide)
    tps = -(-mps // split_mcus) if mps > whole else 1
    if split and tps == 1:
        split_mcus = mps
    spt = max(1, (whole if tail else target) // mps)
    n_tiles = n_seg * tps if split else -(-n_seg // spt)
    out, writes, seg_bits = {}, Counter(), {}
    for t in range(n_tiles):
        if split:
            s0, c = divmod(t, tps)
            first = s0 * mps + c * split_mcus
            n, np_ = min(split_mcus, mps - c * split_mcus), 1
            carry = sum(length(m) for m in range(s0 * mps, first))
        else:
            s0, c, carry = t * spt, 0, 0
            np_ = min(spt, n_seg - s0)
            first, n = s0 * mps, np_ * mps
        tl = [length(first + i) for i in range(n)]
        off = np.concatenate([[0], np.cumsum(tl)]).astype(np.int64)
        per = min(mps, whole)
        for p in range(np_):
            if split:
                q_lo = -(-carry // 32)
                end = carry + int(off[n])
                nw = max(min(-(-end // 32), seg_w) - q_lo, 0)
                origin, lo, hi = 32 * q_lo - carry, 0, n - 1
                if c == tps - 1:
                    seg_bits[s0] = end
            else:
                lo, hi = p * per, p * per + per - 1
                bits = int(off[hi + 1] - off[lo])
                q_lo, nw, origin = 0, min(-(-bits // 32), seg_w), int(off[lo])
                seg_bits[s0 + p] = bits
            seg = s0 + p
            for qi in range(nw):
                pos = 32 * qi + origin
                i = max(j for j in range(lo, hi + 1) if off[j] <= pos)
                o, m, mlen = int(off[i]), first + i, tl[i]
                acc = filled = 0
                while True:
                    if o + mlen - pos > 0:
                        take = min(o + mlen - pos, 32 - filled)
                        acc |= piece(m, pos - o, take) << (32 - filled - take)
                        filled += take
                        pos += take
                        if filled == 32:
                            break
                    o += mlen
                    m += 1
                    if m >= (seg + 1) * mps:
                        break
                    mlen = tl[m - first] if m - first < n else length(m)
                if pad and filled < 32:
                    padb = (8 - filled % 8) % 8
                    acc |= ((1 << padb) - 1) << (32 - filled - padb)
                out[seg, q_lo + qi] = acc
                writes[seg, q_lo + qi] += 1
            if tail and not split:
                for q in range(nw, seg_w):
                    out[seg, q] = 0
                    writes[seg, q] += 1
    tails = -(-seg_w // tail) if tail and split else 0
    for u in range(n_seg * tails):
        s, j = divmod(u, tails)
        for q in range(max(-(-seg_bits[s] // 32), j * tail),
                       min((j + 1) * tail, seg_w)):
            out[s, q] = 0
            writes[s, q] += 1
    return out, writes, seg_bits, (n_tiles, n_seg * tails)


def _streams(n, row_words, seed):
    """n rows of random u32 words with random lengths (some 0, whole
    words, full rows) and random bits past each length."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (n, row_words), dtype=np.uint64)
    lens = rng.integers(0, 32 * row_words + 1, n)
    lens[::5] = 0
    lens[1::7] = 32 * rng.integers(1, row_words + 1, len(lens[1::7]))
    lens[2::11] = 32 * row_words
    return words.astype(np.uint32), lens.astype(np.int32)


# (nm, n_seg, mps, seg_w, whole, target, split): segments cut into 4 tiles
# (the last ragged), a ragged segment of one MCU, whole-segment tiles of 2
# segments and of 4 one-MCU segments, one MCU alone, and rows too short for
# their segments (words past a row dropped, seg_bits whole).
K3_CASES = {
    "split_4_tiles_ragged": (28, 3, 10, None, 4, 7, 3),
    "split_last_segment_one_mcu": (21, 3, 10, None, 4, 7, 3),
    "whole_2_segments_a_tile": (14, 5, 3, None, 4, 7, 3),
    "whole_one_mcu_segments": (9, 9, 1, None, 4, 4, 3),
    "one_mcu": (1, 1, 1, None, 4, 4, 3),
    "rows_too_short_split": (20, 2, 10, 3, 4, 7, 3),
    "rows_too_short_whole": (12, 4, 3, 2, 4, 7, 3),
}


@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_k3_tiles_write_each_word_once(name):
    """The model's words equal the merge twin's, each word 0 ..
    min(ceil(seg_bits / 32), row) - 1 of a segment written exactly once
    and no other; the same seg_bits."""
    nm, n_seg, mps, seg_w, whole, target, split = K3_CASES[name]
    words, lens = _streams(nm, 5, sum(map(ord, name)))
    width = seg_w or t_ep.segment_words(n_seg, mps, 5)
    out, writes, bits, _ = _k3_model(words, lens, n_seg, mps, width, whole,
                                     target, split)
    tw, tl = t_ep.pad_segments(torch.from_numpy(words.view(np.int32)),
                               torch.from_numpy(lens), n_seg, mps)
    want_w, want_b = t_ep.merge_segments_plain(tw, tl, n_seg, width)
    assert [bits[s] for s in range(n_seg)] == want_b.tolist()
    owned = {(s, q) for s in range(n_seg)
             for q in range(min(-(-int(want_b[s]) // 32), width))}
    assert set(writes) == owned and set(writes.values()) <= {1}
    want = _u32(want_w)
    for (s, q), word in out.items():
        assert word == want[s, q], (s, q)


def test_kernel_constants_match_the_wrappers():
    """csrc/seg_merge.cu's tile sizes, scratch head and tail share, and
    csrc/block_pack.cu's largest MCU, are the wrappers'."""
    src = (_build.CSRC / "seg_merge.cu").read_text()
    for name, value in (("kMaxTile", t_ep.SEG_MERGE_WHOLE),
                        ("kTargetMcus", t_ep.SEG_MERGE_TARGET),
                        ("kSplitMcus", t_ep.SEG_MERGE_TILE),
                        ("kZeroSplit", t_ep.SEG_MERGE_ZERO_TILE),
                        ("kScratchHead", t_ep.SEG_MERGE_SCRATCH_HEAD),
                        ("kTailWords", t_ep.SEG_MERGE_TAIL)):
        assert int(re.search(name + r" = (\d+)", src).group(1)) == value
    bp = (_build.CSRC / "block_pack.cu").read_text()
    assert int(re.search(r"kMaxG = (\d+)", bp).group(1)) == \
        t_ep.BLOCK_PACK_MAX_G


@pytest.mark.parametrize("n_seg,mps,want", [
    (135, 240, 0), (270, 480, 0), (32400, 1, 0), (1, 512, 0),
    (1, 513, 16 + 3), (1, 32400, 16 + 127), (3, 600, 16 + 9)])
def test_seg_merge_scratch(n_seg, mps, want):
    """Scratch only where a segment is cut into tiles: none at the 4K
    paths' rows (240 MCUs at 4:2:0, 480 at 4:4:4) or one-MCU segments; the
    counter's head and a status word a tile at restart 0."""
    assert t_ep.seg_merge_scratch_words(n_seg, mps) == want


# --- The consumers of K3's output read nothing past a segment's bytes.

def _segments_with_garbage(seed):
    """(segment words [n_seg, W] as the twin writes them, the same with
    every byte past each segment's ceil(seg_bits / 8) set to 0xFF, bits):
    segments of 0 bytes, of whole words, ending inside a word and spanning
    more than one 4 KB chunk."""
    words, lens = _streams(24, 700, seed)
    lens[3] = 32 * 700
    sw, sb = t_ep.merge_segments_plain(torch.from_numpy(words.view(np.int32)),
                                       torch.from_numpy(lens), 3, 1500)
    by = sw.numpy().view(np.uint8).reshape(3, -1).copy()
    pos = compact._stream_pos(1500, torch.device("cpu")).numpy()
    nbytes = (sb.numpy().astype(np.int64) + 7) // 8
    assert nbytes.max() > 4096, "a segment of more than one chunk"
    by[pos[None, :] >= nbytes[:, None]] = 0xFF
    dirty = torch.from_numpy(by.view(np.int32).reshape(3, 1500))
    return sw, dirty, sb


@pytest.mark.parametrize("consumer", [
    "compact_segments_stuffed_plain", "compact_segments_stuffed_grouped_plain",
    "compact_segments_plain", "stuff_precompute", "stuff_precompute_chunks"])
def test_consumers_ignore_bytes_past_the_data(consumer):
    """The stuffing and compaction twins and the stuffing tables give the
    same bytes (and tables) when every byte past a segment's data holds
    0xFF, as on the card, where K3 never writes the words past it."""
    clean, dirty, sb = _segments_with_garbage(1)
    fn = getattr(compact, consumer)
    if consumer.startswith("stuff_precompute"):
        mnum = compact.marker_table(3, 1)
        got, want = fn(dirty, sb, mnum), fn(clean, sb, mnum)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
        return
    args = () if consumer == "compact_segments_plain" else (1,)
    got, want = fn(dirty, sb, *args), fn(clean, sb, *args)
    total = int(want[1].sum()) if consumer == "compact_segments_plain" \
        else int(want[1])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][:total], want[0][:total])
