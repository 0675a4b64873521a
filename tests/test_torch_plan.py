"""The default route's cached plan (``jpegtpu_torch/kernels/chain.py``), on
the CPU: which calls of ``encoder.device_encode`` and
``device_encode_batch`` take it and which take the per-kernel path, the
images it copies or pads and the operands it refuses, as the wrappers
refuse them, its key and its reuse, the rebuild after a write to the
tables, the sizes and places of its buffers against the per-kernel
wrappers' own, and the C interface of ``csrc/chain.cu`` against its ctypes
mirror. The chain runs only on the card (``tests/test_torch_cuda.py``);
here the tensors are on the meta device (or the CPU), ``_build.DEVICE_TYPE``
names that device, and the native call is replaced by a recorder, which
reports the launchers that ``jt_encode_chain`` calls for the plan it is
given. Imports no JAX."""

import copy
import ctypes
import pickle
import re

import pytest
import torch

from jpegtpu_torch import encoder
from jpegtpu_torch.core import ops
from jpegtpu_torch.encoder import EncoderTables
from jpegtpu_torch.kernels import (_build, chain, compact, entropy_pack,
                                   fused_dctq)
from test_torch_build import _ctype, _launchers

SEGMENTS = encoder._segments            # the per-kernel path's first stage


class _PerKernel(Exception):
    """Raised in place of the per-kernel path's first stage."""


def _report(plan_address: int, launched_address: int) -> None:
    """What ``jt_encode_chain`` reports in launched[] for the plan at
    plan_address when every launcher returns 0 (``csrc/chain.cu``): K1 or
    K12, K2, K3, then K4 or K5, in the order of ``chain.CHAINED``."""
    a = chain.ChainArgs.from_address(plan_address)
    launched = (ctypes.c_longlong * len(chain.CHAINED)).from_address(
        launched_address)
    for i in (1 if a.with_dc else 0, 2, 3, 5 if a.chunks else 4):
        launched[i] = 1


def _record(recorded):
    def launch(dev, *args):
        recorded.append((dev, args))
        _report(args[0], args[-1])
    return launch


@pytest.fixture
def calls(monkeypatch):
    """The chain's native calls, recorded in place of the card; plans for
    the meta device; the per-kernel path stopped at its first stage; the
    counters at 0."""
    recorded = []
    monkeypatch.setattr(chain.CHAIN, "launch", _record(recorded))
    monkeypatch.setattr(_build, "DEVICE_TYPE", "meta")

    def per_kernel(*args, **kwargs):
        raise _PerKernel

    monkeypatch.setattr(encoder, "_segments", per_kernel)
    chain.PLANS.built = chain.PLANS.hits = chain.PLANS.fallbacks = 0
    return recorded


def _tables(mode: str, device: str = "meta") -> EncoderTables:
    return EncoderTables.for_quality(90, mode, "cpu").to(device)


def _image(shape, device: str = "meta") -> torch.Tensor:
    return torch.empty(shape, dtype=torch.uint8, device=device)


def _call(imgs, tables, mode, restart, batch=False, **kw):
    """device_encode (batch: device_encode_batch); None where the call took
    the per-kernel path."""
    fn = encoder.device_encode_batch if batch else encoder.device_encode
    try:
        return fn(imgs, tables, mode, restart, **kw)
    except _PerKernel:
        return None


def _counts():
    return chain.PLANS.built, chain.PLANS.hits, chain.PLANS.fallbacks


# (case, shape, mode, restart, batch, keywords): calls the chain takes.
PLANNED = [
    ("420_rows_4k", (2160, 3840, 3), "420", 240, False, {}),
    ("422_rows_4k", (2160, 3840, 3), "422", 240, False, {}),
    ("444_rows_4k", (2160, 3840, 3), "444", 480, False, {}),
    ("420_restart_0", (2160, 3840, 3), "420", 0, False, {}),
    ("420_restart_1", (2160, 3840, 3), "420", 1, False, {}),
    ("420_1080_rows_fold", (1080, 1920, 3), "420", 120, False, {}),
    ("444_17_rows_fold", (17, 208, 3), "444", 26, False, {}),
    ("batch_8x1080", (8, 1080, 1920, 3), "420", 120, True, {}),
    ("batch_of_one", (1, 64, 64, 3), "422", 8, True, {}),
]


def _misaligned(shape, device="meta"):
    n = 1
    for s in shape:
        n *= s
    return _image((n + 1,), device)[1:].view(shape)


def _transposed(shape, device="meta"):
    h, w, c = shape
    return _image((w, h, c), device).transpose(0, 1)


# (case, image, mode, restart, batch, keywords): calls that take the
# per-kernel path: every route but the default, every device but the
# card, the modes the chain does not take, and on the default route the
# one shape the chain leaves to it.
PER_KERNEL = [
    ("cpu_tensor", lambda: _image((64, 64, 3), "cpu"), "420", 4, False, {}),
    ("gray", lambda: _image((64, 64)), "gray", 8, False, {}),
    ("444s", lambda: _image((64, 64, 3)), "444s", 8, False, {}),
    ("dma", lambda: _image((64, 64, 3)), "420", 4, False,
     {"pixel_path": "dma"}),
    ("xla", lambda: _image((64, 64, 3)), "420", 4, False,
     {"pixel_path": "xla"}),
    ("fuse_bp", lambda: _image((64, 64, 3)), "420", 4, False,
     {"fuse_bp": True}),
    ("host_stuffing", lambda: _image((64, 64, 3)), "420", 4, False,
     {"device_stuff": False}),
    # mps * 32 * 314 words >= 2^31: the merge's guard needs a sync.
    ("segment_may_reach_2_31_bits", lambda: _image((16, 16 * 213_800, 3)),
     "420", 0, False, {}),
]


@pytest.mark.parametrize("case,shape,mode,restart,batch,kw", PLANNED,
                         ids=[c[0] for c in PLANNED])
def test_default_route_takes_the_plan(calls, case, shape, mode, restart,
                                      batch, kw):
    out = _call(_image(shape), _tables(mode), mode, restart, batch, **kw)
    assert out is not None and len(calls) == 1
    assert _counts() == (1, 0, 0)


@pytest.mark.parametrize("case,make,mode,restart,batch,kw", PER_KERNEL,
                         ids=[c[0] for c in PER_KERNEL])
def test_other_calls_take_the_per_kernel_path(calls, case, make, mode,
                                              restart, batch, kw):
    out = _call(make(), _tables(mode), mode, restart, batch, **kw)
    assert out is None and calls == []
    assert _counts() == (0, 0, 1)


def _random(shape):
    gen = torch.Generator().manual_seed(sum(shape))
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen)


# (case, image, what the chain reads, restart, padded): default-route
# images the chain cannot read where they lie, on the CPU standing in for
# the card: padded to whole MCUs (a width that is not whole MCUs, a row
# pad as long as the image), or copied (misaligned, not contiguous).
READABLE = [
    ("width_not_whole_mcus", lambda: _random((64, 200, 3)),
     lambda x: ops.pad_to_multiple(x, (16, 16)), 13, True),
    ("pad_as_long_as_the_image", lambda: _random((8, 16, 3)),
     lambda x: ops.pad_to_multiple(x, (16, 16)), 1, True),
    ("misaligned", lambda: _misaligned((64, 64, 3), "cpu").copy_(
        _random((64, 64, 3))), lambda x: x, 4, False),
    ("not_contiguous", lambda: _transposed((64, 64, 3), "cpu").copy_(
        _random((64, 64, 3))), lambda x: x, 4, False),
]


@pytest.mark.parametrize("case,make,reads,restart,padded", READABLE,
                         ids=[c[0] for c in READABLE])
def test_an_image_the_chain_cannot_read_is_made_readable(
        calls, monkeypatch, case, make, reads, restart, padded):
    """The call takes the plan, built for the shape the chain reads; the
    chain reads, at a 16-byte aligned address, the bytes the per-kernel
    path's kernel reads: the image padded by ``pad_mcus`` (a gather,
    counted), or a contiguous copy of it. A second call is a hit."""
    monkeypatch.setattr(_build, "DEVICE_TYPE", "cpu")
    img, t = make(), _tables("420", "cpu")
    want = reads(img).contiguous().reshape(-1)
    seen = []

    def launch(dev, *args):
        seen.append((args[1], bytes((ctypes.c_uint8 * want.numel())
                                    .from_address(args[1]))))
        _report(args[0], args[-1])
    monkeypatch.setattr(chain.CHAIN, "launch", launch)
    fused_dctq.PADS.folds = fused_dctq.PADS.gathers = 0
    for _ in range(2):
        assert _call(img, t, "420", restart) is not None
    assert _counts() == (1, 1, 0)
    assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (
        0, 2 * padded)
    for ptr, got in seen:
        assert ptr % 16 == 0 and ptr != img.data_ptr()
        assert got == want.numpy().tobytes()
    (plan,) = t.plans.values()
    h, w = reads(img).shape[:2]
    assert (plan.args.h, plan.args.row_bytes, plan.args.n_mcu) == (
        h, 3 * w, (h // 16) * (w // 16))


# (case, image, tables' mode, mode, restart, batch, exception, message):
# default-route calls whose operands the wrappers refuse; ``chain.plan``
# refuses them with the same check.
REFUSED = [
    ("not_u8", lambda d: torch.empty((64, 64, 3), dtype=torch.int16,
                                     device=d), "420", "420", 4, False,
     ValueError, "uint8"),
    ("tables_of_another_mode", lambda d: _image((64, 64, 3), d), "420",
     "422", 8, False, ValueError, "422 operator must be"),
    ("444_tables_factored_as_444s", lambda d: _image((64, 64, 3), d),
     "444s", "444", 8, False, ValueError, "444s"),
    ("batch_restart_not_dividing", lambda d: _image((2, 32, 48, 3), d),
     "420", "420", 4, True, encoder.BatchGeometryError, "dividing"),
    ("batch_restart_0", lambda d: _image((2, 32, 48, 3), d), "420", "420",
     0, True, encoder.BatchGeometryError, "dividing"),
]


@pytest.mark.parametrize("case,make,tables_mode,mode,restart,batch,exc,msg",
                         REFUSED, ids=[c[0] for c in REFUSED])
def test_operands_the_wrappers_refuse_raise_on_the_default_route(
        calls, monkeypatch, case, make, tables_mode, mode, restart, batch,
        exc, msg):
    """``chain.plan`` raises the exception the per-kernel path raises
    on the same operands (its wrappers run on the CPU), and builds,
    launches and counts nothing."""
    with pytest.raises(exc, match=msg):
        _call(make("meta"), _tables(tables_mode), mode, restart, batch)
    assert calls == [] and _counts() == (0, 0, 0)
    if case != "444_tables_factored_as_444s":   # the CPU reads no factors
        monkeypatch.setattr(encoder, "_segments", SEGMENTS)
        with pytest.raises(exc, match=msg):
            _call(make("cpu"), _tables(tables_mode, "cpu"), mode, restart,
                  batch)


def test_tables_on_another_device_raise(calls):
    """A card image with tables elsewhere: ``chain.plan``'s device check, the
    wrappers' (``_build.check_cuda``), raises."""
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        _call(_image((64, 64, 3)), _tables("420", "cpu"), "420", 4)
    assert calls == [] and _counts() == (0, 0, 0)


def test_a_kept_plan_refuses_an_image_of_another_dtype(calls):
    """A call of a kept plan's shape with an image that is not u8 is
    another key: its build raises, and the kept plan stays."""
    t = _tables("420")
    _call(_image((64, 64, 3)), t, "420", 4)
    with pytest.raises(ValueError, match="uint8"):
        _call(torch.empty((64, 64, 3), dtype=torch.int16, device="meta"), t,
              "420", 4)
    assert len(calls) == 1 and len(t.plans) == 1
    assert _counts() == (1, 0, 0)


def test_a_second_identical_call_reuses_the_plan(calls):
    """One plan, keyed (batch, shape, dtype, device, mode, restart,
    device_stuff, pixel_path, fuse_bp, PIXEL_DC), and the same plan and
    image on every native call (each with its own buffers and report);
    each call after the first a hit."""
    t, img = _tables("420"), _image((2160, 3840, 3))
    for _ in range(3):
        _call(img, t, "420", 240)
    assert _counts() == (1, 2, 0)
    (key, plan), = t.plans.items()
    assert key == (False, torch.Size((2160, 3840, 3)), torch.uint8,
                   torch.device("meta"), "420", 240, True, "nat", False,
                   fused_dctq.PIXEL_DC)
    assert [args[:2] for _, args in calls] == [
        (plan.address, img.data_ptr())] * 3


@pytest.mark.parametrize("change", ["restart", "shape", "batch",
                                    "pixel_dc"])
def test_a_call_that_differs_in_its_key_builds_its_own_plan(
        calls, monkeypatch, change):
    t = _tables("420")
    _call(_image((64, 64, 3)), t, "420", 4)
    img, mode, restart, batch = _image((64, 64, 3)), "420", 4, False
    if change == "restart":
        restart = 8
    elif change == "shape":
        img = _image((64, 128, 3))
    elif change == "batch":
        img, batch = _image((1, 64, 64, 3)), True
    else:
        monkeypatch.setattr(fused_dctq, "PIXEL_DC", not fused_dctq.PIXEL_DC)
    assert _call(img, t, mode, restart, batch) is not None
    assert _counts() == (2, 0, 0)


@pytest.mark.parametrize("pixel_dc", [False, True])
@pytest.mark.parametrize("shape,mode,restart,batch,stuff,folds", [
    ((64, 64, 3), "420", 4, False, compact.STUFF, False),
    ((64, 64, 3), "420", 0, False, compact.STUFF_CHUNKS, False),
    ((1, 64, 64, 3), "420", 16, True, compact.STUFF, False),
    ((1080, 1920, 3), "420", 120, False, compact.STUFF, True),
    ((3, 1080, 1920, 3), "420", 120, True, compact.STUFF, True),
])
def test_a_planned_call_counts_each_kernel_once(calls, monkeypatch, pixel_dc,
                                               shape, mode, restart, batch,
                                               stuff, folds):
    """Every existing launch count holds: one launch of each kernel the
    chain runs (the DC-plane pixel kernel with PIXEL_DC; the chunk
    stuffing for one segment of a single image), and a fold where K1
    folds."""
    monkeypatch.setattr(fused_dctq, "PIXEL_DC", pixel_dc)
    pixel = fused_dctq.PIXEL_DC_PLANE if pixel_dc else fused_dctq.PIXEL
    kernels = (fused_dctq.PIXEL, fused_dctq.PIXEL_DC_PLANE,
               entropy_pack.BLOCK_PACK_SEGMENTS, entropy_pack.SEG_MERGE,
               compact.STUFF, compact.STUFF_CHUNKS)
    for k in kernels:
        k.launches = 0
    fused_dctq.PADS.folds = fused_dctq.PADS.gathers = 0
    t, img = _tables(mode), _image(shape)
    for _ in range(2):
        _call(img, t, mode, restart, batch)
    want = {pixel, entropy_pack.BLOCK_PACK_SEGMENTS, entropy_pack.SEG_MERGE,
            stuff}
    assert [k.launches for k in kernels] == [2 * (k in want) for k in kernels]
    assert (fused_dctq.PADS.folds, fused_dctq.PADS.gathers) == (2 * folds, 0)
    assert _counts() == (1, 1, 0)
    plan, = t.plans.values()
    assert plan.args.with_dc == pixel_dc
    assert (plan.args.dc_stride, plan.args.dc_step) == (
        (fused_dctq.DC_LANES, 1) if pixel_dc else (384, 64))


@pytest.mark.parametrize("write", ["bias", "dc_codes", "dc_lens",
                                   "ac_codes", "ac_lens", "lum", "chroma",
                                   "replace_lum", "replace_bias", "to"])
def test_a_write_to_the_tables_rebuilds_the_plan(calls, monkeypatch, write):
    """An in-place write to any tensor the plan read, a buffer replaced, or
    the module moved (``EncoderTables._apply``): the next call builds the
    plan again."""
    monkeypatch.setattr(_build, "DEVICE_TYPE", "cpu")
    t, img = _tables("420", "cpu"), _image((32, 32, 3), "cpu")
    _call(img, t, "420", 2)
    if write.startswith("replace_"):
        name = write[len("replace_"):]
        setattr(t, name, getattr(t, name).clone())
    elif write == "to":
        t.to("cpu")
        assert t.plans == {}
    else:
        getattr(t, write).add_(0)
    _call(img, t, "420", 2)
    assert _counts() == (2, 0, 0)
    _call(img, t, "420", 2)
    assert _counts() == (2, 1, 0)


@pytest.mark.parametrize("write", ["m", "replace_m"])
def test_a_write_to_m_keeps_the_plan(calls, monkeypatch, write):
    """The chain reads the tables' factors, made when the tables were, and
    not the dense operator m: a write to m, in place or by a new tensor,
    leaves the plan as it is."""
    monkeypatch.setattr(_build, "DEVICE_TYPE", "cpu")
    t, img = _tables("420", "cpu"), _image((32, 32, 3), "cpu")
    _call(img, t, "420", 2)
    if write == "m":
        t.m.add_(0)
    else:
        t.m = t.m.clone()
    _call(img, t, "420", 2)
    assert _counts() == (1, 1, 0)


def test_a_copy_of_the_tables_builds_its_own_plan(calls, monkeypatch):
    """A plan holds the device pointers of the tensors it read, so a copy of
    the tables (deepcopy, pickle) carries none and builds its own."""
    monkeypatch.setattr(_build, "DEVICE_TYPE", "cpu")
    t, img = _tables("420", "cpu"), _image((32, 32, 3), "cpu")
    _call(img, t, "420", 2)
    for c in (copy.deepcopy(t), pickle.loads(pickle.dumps(t))):
        assert c.plans == {} and len(t.plans) == 1
        _call(img, c, "420", 2)
        assert c.plans[next(iter(t.plans))].args.bias == c.bias.data_ptr()
    assert _counts() == (3, 0, 0)


def test_a_stale_plan_with_an_image_it_cannot_read_is_rebuilt_and_copies(
        calls, monkeypatch):
    """A write to the tables, then a misaligned image of the plan's shape:
    the call builds the plan again and hands the chain an aligned copy."""
    monkeypatch.setattr(_build, "DEVICE_TYPE", "cpu")
    t = _tables("420", "cpu")
    _call(_image((64, 64, 3), "cpu"), t, "420", 4)
    t.bias.add_(0)
    bad = _misaligned((64, 64, 3), "cpu")
    assert _call(bad, t, "420", 4) is not None
    assert _counts() == (2, 0, 0)
    image = calls[-1][1][1]
    assert image % 16 == 0 and image != bad.data_ptr()


@pytest.mark.parametrize("shape,mode,restart,batch", [
    ((2160, 3840, 3), "420", 240, False),     # uhd_420_q90
    ((8, 1080, 1920, 3), "420", 120, True),   # fhd_420_q90_x8
    ((2160, 3840, 3), "444", 480, False),     # uhd_444_q90
    ((2160, 3840, 3), "422", 240, False),
    ((2160, 3840, 3), "420", 1, False),
    ((2160, 3840, 3), "420", 0, False),
    ((1080, 1920, 3), "420", 120, False),
])
def test_buffers_match_the_per_kernel_wrappers(calls, shape, mode, restart,
                                               batch):
    """The plan's sizes are the wrappers' (``segment_words``,
    ``scan_capacity``, ``stuff_scratch_words``,
    ``seg_merge_scratch_words``); no two intermediates that a kernel uses
    at once overlap; and a call holds no more than the per-kernel path's
    largest moment (coefficients, MCU streams and segments at once, or
    segments and the scan)."""
    t = _tables(mode)
    _call(_image(shape), t, mode, restart, batch)
    plan, = t.plans.values()
    a = plan.args
    n_img, h, w = (shape[0] if batch else 1), shape[-3], shape[-2]
    mh, mw, _, n_out = fused_dctq.fused_geometry(mode)
    my, mx = encoder.ops.mcu_grid(h, w, mode)
    n_mcu = n_img * my * mx
    if batch:
        spi = encoder.batch_segments(my * mx, restart)
        n_seg, mps = n_img * spi, restart
    else:
        n_seg, mps = encoder.geometry(my * mx, restart)
        spi = n_seg
    mcu_w = entropy_pack.mcu_words(n_out // 64)
    seg_w = entropy_pack.segment_words(n_seg, mps, mcu_w)
    assert (a.n_mcu, a.nrx, a.row_bytes, a.h, a.my, a.mh, a.mw) == (
        n_mcu, mx, 3 * w, h, my, mh, mw)
    assert a.groups == fused_dctq.chroma_groups(mode)[0]
    assert (a.g, a.n_luma, a.restart, a.mcu_words) == (
        n_out // 64, encoder.EncoderConfig(subsampling=mode).n_luma,
        restart, mcu_w)
    assert (a.n_seg, a.mps, a.seg_words, a.spi) == (n_seg, mps, seg_w, spi)
    assert a.chunks == (n_seg == 1 and not batch)
    assert plan.n_bounds == n_img + 1
    assert plan.out_bytes == compact.scan_capacity(n_seg, seg_w)
    merge = entropy_pack.seg_merge_scratch_words(n_seg, mps)
    stuff = compact.stuff_scratch_words(n_seg, seg_w)
    offsets = [a.dc_at, a.seg_bits_at, a.stuff_scratch_at, a.mlens_at]
    if merge:
        offsets.append(a.merge_scratch_at)
        assert (a.seg_bits_at + 4 * n_seg <= a.merge_scratch_at and
                a.merge_scratch_at + 8 * merge <= a.stuff_scratch_at)
    else:
        assert a.merge_scratch_at == -1
    assert all(o % chain.ALIGN == 0 for o in offsets)
    # work: coefficients before the DC plane; segments, seg_bits, the
    # scratches in turn. out: MCU streams, then their lengths.
    assert 4 * n_mcu * n_out <= a.dc_at <= plan.work_bytes
    assert 4 * n_seg * seg_w <= a.seg_bits_at
    assert a.seg_bits_at + 4 * n_seg <= a.stuff_scratch_at
    assert a.stuff_scratch_at + 8 * stuff <= plan.work_bytes
    assert 4 * n_mcu * mcu_w <= a.mlens_at
    assert a.mlens_at + 4 * n_mcu <= plan.out_bytes
    segments = 4 * n_seg * seg_w + 4 * n_seg + 8 * merge
    per_kernel = max(
        4 * n_mcu * n_out + 4 * n_mcu * (mcu_w + 1) + segments,
        segments + plan.out_bytes + 8 * plan.n_bounds + 8 * stuff)
    assert plan.work_bytes + plan.out_bytes <= per_kernel + 4 * chain.ALIGN


@pytest.mark.parametrize("batch", [False, True])
def test_a_planned_call_returns_what_the_per_kernel_path_returns(
        monkeypatch, batch):
    """The same tuple: the scan buffer (u8, the same size), the total
    (int64 scalar), and for a batch each image's first byte ([n] int64)."""
    monkeypatch.setattr(chain.CHAIN, "launch", lambda dev, *args: None)
    t = _tables("420", "cpu")
    img = _image((2, 32, 32, 3) if batch else (32, 32, 3), "cpu").zero_()
    fn = encoder.device_encode_batch if batch else encoder.device_encode
    want = fn(img, t, "420", 2)                 # the CPU's per-kernel path
    monkeypatch.setattr(_build, "DEVICE_TYPE", "cpu")
    chain.PLANS.built = 0
    got = fn(img, t, "420", 2)
    assert chain.PLANS.built == 1
    assert [(x.dtype, x.shape) for x in got] == [(x.dtype, x.shape)
                                                 for x in want]


def test_the_cpu_path_counts_a_fallback():
    chain.PLANS.fallbacks = 0
    t = _tables("420", "cpu")
    encoder.device_encode(_image((16, 16, 3), "cpu").zero_(), t, "420", 1)
    encoder.device_encode_batch(_image((2, 16, 16, 3), "cpu").zero_(), t,
                                "420", 1)
    assert chain.PLANS.fallbacks == 2 and t.plans == {}


def _plan_fields():
    """(name, is_pointer) of each field of chain.cu's ChainPlan, in
    order."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / "chain.cu").read_text())
    body = re.search(r"struct ChainPlan\s*\{([^}]*)\}", text).group(1)
    return [(d.split()[-1].lstrip("*"), "*" in d)
            for d in (" ".join(s.split()) for s in body.split(";")) if d]


def test_chain_plan_matches_its_ctypes_mirror():
    """ctypes lays ChainArgs out as the compiler lays ChainPlan out only if
    they have the same fields, in the same order, of the same widths."""
    fields = _plan_fields()
    assert [n for n, _ in fields] == [n for n, _ in chain.ChainArgs._fields_]
    for (name, pointer), (_, ctype) in zip(fields, chain.ChainArgs._fields_):
        assert ctype is (ctypes.c_void_p if pointer else ctypes.c_longlong), \
            name
    assert ctypes.sizeof(chain.ChainArgs) == 8 * len(fields)


def test_chain_launcher_matches_its_declaration():
    """jt_encode_chain takes the plan, the image, the two buffers and the
    bounds as pointers, the stream last, as chain.CHAIN declares; and it
    calls the launcher of every kernel a plan may run."""
    source, params = _launchers()[chain.CHAIN.symbol]
    assert source == "chain.cu"
    assert params[-1].split()[0] == "cudaStream_t"
    assert [_ctype(p) for p in params] == chain.CHAIN.argtypes
    text = (_build.CSRC / "chain.cu").read_text()
    body = text[text.index("extern \"C\" int jt_encode_chain"):]
    for k in (fused_dctq.PIXEL, fused_dctq.PIXEL_DC_PLANE,
              entropy_pack.BLOCK_PACK_SEGMENTS, entropy_pack.SEG_MERGE,
              compact.STUFF, compact.STUFF_CHUNKS):
        assert re.search(rf"\b{k.symbol}\(", body), k.symbol


def test_chain_reports_each_launcher_in_its_entry():
    """jt_encode_chain sets launched[i] after the call of CHAINED[i]'s
    launcher, and of no other, so that the counts the plan raises are
    those of the launchers that ran."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / "chain.cu").read_text())
    body = text[text.index("{", text.index("int jt_encode_chain")):]
    pairs = re.findall(r"\b(jt_\w+)\(.*?launched\[(\d+)\]", body, re.S)
    assert sorted((int(i), sym) for sym, i in pairs) == [
        (i, k.symbol) for i, k in enumerate(chain.CHAINED)]


@pytest.mark.parametrize("reported", [(), (0,), (1,), (0, 2, 3), (2, 3, 4),
                                      (0, 1, 2, 3, 4, 5)])
def test_a_planned_call_counts_what_the_chain_reports(monkeypatch, reported):
    """Each kernel's launches, and the folds of K1 and K12, rise by what
    the native call reports it launched, and by nothing else."""
    def launch(dev, *args):
        launched = (ctypes.c_longlong * len(chain.CHAINED)).from_address(
            args[-1])
        for i in reported:
            launched[i] = 1
    monkeypatch.setattr(chain.CHAIN, "launch", launch)
    monkeypatch.setattr(_build, "DEVICE_TYPE", "meta")
    for k in chain.CHAINED:
        k.launches = 0
    fused_dctq.PADS.folds = 0
    encoder.device_encode(_image((1080, 1920, 3)), _tables("420"), "420",
                          120)
    assert [k.launches for k in chain.CHAINED] == [
        int(i in reported) for i in range(len(chain.CHAINED))]
    assert fused_dctq.PADS.folds == (0 in reported) + (1 in reported)


def test_the_tables_keep_the_plans_of_the_shapes_used_last(calls):
    """At most chain.KEPT plans, the shapes used last: a new shape past
    that drops the one used longest ago, and a call that hits a plan keeps
    it."""
    t = _tables("420")
    widths = [16 * (i + 1) for i in range(chain.KEPT + 2)]
    for wd in widths[:chain.KEPT]:
        _call(_image((16, wd, 3)), t, "420", 1)
    _call(_image((16, widths[0], 3)), t, "420", 1)        # a hit: kept
    _call(_image((16, widths[chain.KEPT], 3)), t, "420", 1)
    assert len(t.plans) == chain.KEPT
    kept = [key[1][1] for key in t.plans]
    assert kept == widths[2:chain.KEPT] + [widths[0], widths[chain.KEPT]]
    _call(_image((16, widths[1], 3)), t, "420", 1)         # built again
    assert _counts() == (chain.KEPT + 2, 1, 0)


@pytest.mark.parametrize("n_seg,grouped,kernel", [
    (1, False, compact.STUFF_CHUNKS), (2, False, compact.STUFF),
    (1, True, compact.STUFF), (135, True, compact.STUFF)])
def test_stuff_launcher_is_the_one_the_wrappers_launch(monkeypatch, n_seg,
                                                       grouped, kernel):
    """compact.stuff_launcher names the kernel that the per-kernel path's
    stuffing launches for the same scan, which the plan launches too."""
    assert compact.stuff_launcher(n_seg, grouped) is kernel
    seen = []
    monkeypatch.setattr(compact, "_stuff",
                        lambda k, *args: seen.append(k) or (
                            torch.empty(0), torch.zeros(2)))
    seg = torch.empty((n_seg, 4), dtype=torch.int32, device="meta")
    bits = torch.empty((n_seg,), dtype=torch.int32, device="meta")
    if grouped:
        compact.compact_segments_stuffed_grouped(seg, bits, 4, 1)
    elif n_seg > 1:
        compact.compact_segments_stuffed_grouped(seg, bits, 4)
    else:
        compact.compact_segments_stuffed(seg, bits, 4)
    assert seen == [kernel]


@pytest.mark.parametrize("mps,mw,overflows", [
    (1, 314, False), (213_722, 314, False), (213_723, 314, True),
    (2 ** 26, 1, True), (2 ** 26 - 1, 1, False)])
def test_seg_merge_sizes_flag_segments_that_may_reach_2_31_bits(
        mps, mw, overflows):
    seg_w, scratch, may = entropy_pack.seg_merge_sizes(3, mps, mw)
    assert (seg_w, scratch) == (
        entropy_pack.segment_words(3, mps, mw),
        entropy_pack.seg_merge_scratch_words(3, mps))
    assert may is overflows
