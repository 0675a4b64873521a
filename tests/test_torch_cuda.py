"""The port's CUDA kernels on the card, at small and edge-case shapes: each
kernel against its plain twin on the same CUDA tensors, and the whole
encode on the GPU against the port's CPU path. Every test here needs a
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
           compact.STUFF)


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


@pytest.mark.parametrize("q", [1, 50, 90, 100])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_encode_on_gpu_equals_cpu_path(dev, name, q):
    img = IMAGES[name]()
    for k in KERNELS:
        k.launches = 0
    got = jpegtpu_torch.encode(img, quality=q, subsampling="420", device=dev)
    assert [k.launches for k in KERNELS] == [1, 1, 1, 1]
    want = jpegtpu_torch.encode(img, quality=q, subsampling="420",
                                device="cpu")
    assert got == want


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
    luts = EncoderTables.for_quality(90, dev).luts()
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
        buf, total = compact.compact_segments_stuffed(sw, sb, restart)
        buf_p, total_p = compact.compact_segments_stuffed_plain(sw, sb,
                                                                restart)
        assert int(total) == int(total_p)
        assert torch.equal(buf[:int(total)], buf_p[:int(total)])


def test_stuffing_kernel_all_ff_segments(dev):
    """Every byte 0xFF (each one stuffed) across several 1 KB tiles, with
    byte counts that end inside a word."""
    n_seg, w = 3, 700
    words = torch.full((n_seg, w), -1, dtype=torch.int32, device=dev)
    bits = torch.tensor([w * 32, 8 * 1029 - 3, 8 * 5], device=dev)
    buf, total = compact.compact_segments_stuffed(words, bits, 1)
    buf_p, total_p = compact.compact_segments_stuffed_plain(words, bits, 1)
    want = 2 * (w * 4 + 1029 + 5) + 2 * (n_seg - 1)
    assert int(total) == int(total_p) == want
    assert torch.equal(buf[:want], buf_p[:want])


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_pixel_kernel_matches_twin(dev, name):
    img = torch.from_numpy(IMAGES[name]()).to(dev)
    t = EncoderTables.for_quality(100, dev)
    got = fused_dctq.encode_blocks_pairs(img, t.m, t.bias)
    want = fused_dctq.encode_blocks_pairs_plain(img, t.m, t.bias)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_wrappers_raise_on_cpu_operands(dev):
    """A CUDA input with CPU tables raises: nothing falls back to a twin."""
    img = torch.zeros((16, 16, 3), dtype=torch.uint8, device=dev)
    t = EncoderTables.for_quality(90, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        fused_dctq.encode_blocks_pairs(img, t.m, t.bias)
    c = torch.zeros((1, 384), dtype=torch.int32, device=dev)
    cls = torch.zeros(6, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        entropy_pack.block_pack_mcu_pairs(c, cls, cls, *t.luts())
